"""The port on a CUDA device: the hand-written kernel against its plain
PyTorch version, and the engine's main path through the kernel.

Every test here needs a card (marker ``gpu``) and skips without one. The
file imports neither jax nor abcsmc_tpu, so it also runs on a machine
without JAX; there, skip tests/conftest.py (which sets up JAX's CPU mesh):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Tolerance: 2e-4 nats between the FP32 kernel and the FP32 plain version,
the bound of tests/test_pallas_kernels.py (both sum exp terms in f32, in
different orders; the plain version uses the matmul expansion of the
squared distance, the kernel the direct difference)."""

import io
import math
from contextlib import redirect_stderr

import numpy as np
import pytest
import torch

from abcsmc_tpu_torch import AbcSmc
from abcsmc_tpu_torch.config import parse_config
from abcsmc_tpu_torch.models.parameters import ParameterSet
from abcsmc_tpu_torch.models.simulators import make_linear_gaussian_simulator
from abcsmc_tpu_torch.models.transforms import ParameterTransform
from abcsmc_tpu_torch.ops import kernels, weights
from abcsmc_tpu_torch.parallel.generation import Generation

pytestmark = pytest.mark.gpu
TOL = 2e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


def _scaled(n, m, p, seed, dev):
    rng = np.random.default_rng(seed)
    f32 = dict(dtype=torch.float32, device=dev)
    a, b, _ = weights._prep_scaled(
        torch.as_tensor(rng.uniform(0, 1, (n, p)), **f32),
        torch.as_tensor(rng.uniform(0.2, 0.8, (m, p)), **f32),
        torch.as_tensor(rng.uniform(0.01, 0.1, p), **f32),
    )
    w = rng.uniform(0.5, 1.5, m)
    lw = torch.as_tensor(np.log(w / w.sum()), **f32)
    return a.contiguous(), b.contiguous(), lw


@pytest.mark.parametrize("n,m,p", [(2048, 2048, 16), (5000, 3000, 6),
                                   (129, 70, 1), (300, 500, 64),
                                   (1, 100_000, 8)])
def test_kernel_matches_plain(cuda, n, m, p):
    a, b, lw = _scaled(n, m, p, 11, cuda)
    before = kernels.mixture_logsumexp.launches
    for mode in ("static", "online", "auto"):
        got = kernels.mixture_logsumexp(a, b, lw, mode=mode)
        torch.cuda.synchronize()
        ref = kernels.mixture_logsumexp_reference(a, b, lw, mode=mode)
        assert bool(torch.isfinite(got).all()), mode
        assert float((got - ref).abs().max()) <= TOL, mode
    assert kernels.mixture_logsumexp.launches == before + 3


def test_kernel_underflow_auto_reruns_online(cuda):
    b = torch.zeros((16, 2), device=cuda)
    lw = torch.full((16,), math.log(1.0 / 16), device=cuda)
    a = torch.cat([torch.zeros((3, 2), device=cuda),
                   torch.full((1, 2), 1e4, device=cuda)])
    static = kernels.mixture_logsumexp(a, b, lw, mode="static")
    assert bool(torch.isneginf(static[3]))
    before = kernels.mixture_logsumexp.launches
    auto = kernels.mixture_logsumexp(a, b, lw, mode="auto")
    assert kernels.mixture_logsumexp.launches == before + 2
    online = kernels.mixture_logsumexp(a, b, lw, mode="online")
    assert torch.equal(auto, online)
    np.testing.assert_allclose(float(auto[3]), -1e8 + math.log(1.0 / 16),
                               rtol=1e-6)


def test_kernel_true_neg_inf_weights(cuda):
    a, b, lw = _scaled(700, 900, 5, 3, cuda)
    lw = lw.clone()
    lw[450:] = -math.inf
    for mode in ("static", "online", "auto"):
        got = kernels.mixture_logsumexp(a, b, lw, mode=mode)
        sub = kernels.mixture_logsumexp(a, b[:450].contiguous(),
                                        lw[:450].contiguous(), mode=mode)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got).all()), mode
        assert float((got - sub).abs().max()) <= TOL, mode


def test_kernel_rejects_what_it_does_not_take(cuda):
    a = torch.zeros((8, 65), device=cuda)
    with pytest.raises(ValueError, match="p <= 64"):
        kernels.mixture_logsumexp(a, a, torch.zeros(8, device=cuda))
    a = torch.zeros((8, 4), device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError):
        kernels.mixture_logsumexp(a, a, torch.zeros(8, device=cuda))


def test_generation_step_cuda_matches_cpu(cuda):
    """The f32 step on the card (kernel weights) and on the CPU (plain
    weights), same data and draws: same survivors, close weights."""
    npar, nmet, n, keep = 6, 13, 20_000, 1_000
    raw = {"smc_iterations": 2, "num_samples": n,
           "predictive_prior_size": keep,
           "parameters": [{"name": f"p{i}", "dist_type": "UNIFORM",
                           "num_type": "FLOAT", "par1": 0.0, "par2": 1.0}
                          for i in range(npar)],
           "metrics": [{"name": f"m{j}", "num_type": "FLOAT", "value": 0.5}
                       for j in range(nmet)]}
    cfg = parse_config(raw)
    sim = make_linear_gaussian_simulator(npar, nmet)
    rng = np.random.default_rng(0)
    params = rng.uniform(0, 1, (n, npar))
    seeds = rng.integers(0, 2**31 - 1, n)
    state = (rng.uniform(0.2, 0.8, (keep, npar)), np.full(keep, 1.0 / keep),
             np.full(npar, 0.02))
    ps = ParameterSet.from_specs(cfg.parameters)
    tr = ParameterTransform(cfg.parameters)
    draws = Generation(ps, tr, sim, np.full(nmet, 0.5),
                       device="cpu").draw_step(
        torch.Generator().manual_seed(1), n)
    out = {}
    for dev in (torch.device("cpu"), cuda):
        gen = Generation(ps, tr, sim, np.full(nmet, 0.5), device=dev)
        f32 = dict(dtype=torch.float32, device=dev)
        out[dev.type] = gen.step(
            torch.as_tensor(params, **f32),
            torch.as_tensor(seeds, device=dev), keep, n,
            type(draws)(*(x.to(dev) for x in (
                draws.vdv_seed, draws.pick, draws.noise_u,
                draws.next_seeds))),
            tuple(torch.as_tensor(x, **f32) for x in state),
        )
    cpu, gpu = out["cpu"], out["cuda"]
    assert int(cpu.ncomp_used) == int(gpu.ncomp_used) > 1
    # near-equal distances may swap rank order between devices: align the
    # per-survivor weights by particle index, not by rank
    ci, gi = cpu.survivor_idx.numpy(), gpu.survivor_idx.cpu().numpy()
    assert set(ci.tolist()) == set(gi.tolist())
    np.testing.assert_allclose(gpu.weights.cpu().numpy()[np.argsort(gi)],
                               cpu.weights.numpy()[np.argsort(ci)],
                               rtol=1e-3)


def test_run_device_on_cuda_launches_the_kernel(cuda):
    npar, nmet = 6, 13
    obs = np.full(nmet, 0.5)
    raw = {"smc_iterations": 3, "num_samples": 4096,
           "predictive_prior_fraction": 0.1,
           "parameters": [{"name": f"p{i}", "dist_type": "UNIFORM",
                           "num_type": "FLOAT", "par1": 0.0, "par2": 1.0}
                          for i in range(npar)],
           "metrics": [{"name": f"m{j}", "num_type": "FLOAT",
                        "value": float(obs[j])} for j in range(nmet)]}
    a = AbcSmc(raw, device="cuda",
               simulator=make_linear_gaussian_simulator(npar, nmet))
    kernels.mixture_logsumexp.launches = 0
    with redirect_stderr(io.StringIO()):
        a.run_device(seed=0)
    assert kernels.mixture_logsumexp.launches >= 2
    pars, w = a.posterior()
    assert np.isfinite(pars).all() and np.isfinite(w).all()
    gens = [e for e in a.timings if e["op"] == "device_generation"]
    assert len(gens) == 3 and all(e["device_ms"] > 0 for e in gens)
