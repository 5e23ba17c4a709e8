"""The weight kernel's dot schemes (``precision`` / the config key
``weight_precision``): the plain version of each, held against a numpy
emulation, the float64 oracle and the JAX package's Pallas kernel in
interpret mode; the scheme each caller passes on; the launch plan of each.

The CUDA programs themselves are held against these plain versions in
tests/test_torch_gpu.py. Tolerances: 1e-9 for the same float64 arithmetic
in another order; 2e-4 nats, the f32 kernel contract of
tests/test_pallas_kernels.py, against JAX."""

import inspect
import json
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from abcsmc_tpu.ops.pallas_kernels import mixture_logsumexp as j_mls
from abcsmc_tpu_torch import AbcSmc, bench_kernel
from abcsmc_tpu_torch.ops import kernels, weights
from abcsmc_tpu_torch.parallel import particle_mesh

REPO = Path(__file__).resolve().parents[1]
NEG_INF = -1e30


def _ops_like(n, m, p, seed):
    """Scaled (a, b, log_w) as tests/test_torch_ops.py makes them: queries
    uniform on [0, 1]^p, centers on [0.2, 0.8]^p, kernel variances 0.01-0.1."""
    rng = np.random.default_rng(seed)
    params = rng.uniform(0, 1, (n, p))
    prev = rng.uniform(0.2, 0.8, (m, p))
    w = rng.uniform(0.5, 1.5, m)
    dv = rng.uniform(0.01, 0.1, p)
    a = (params - prev.mean(0)) / np.sqrt(dv)
    b = (prev - prev.mean(0)) / np.sqrt(dv)
    return a, b, np.log(w / w.sum())


def _smc_like(k, p, seed):
    """An SMC state of k survivors: centers uniform on [0.3, 0.7]^p with
    Dirichlet(5) weights, queries resampled by weight and perturbed by the
    kernel sd (doubled variance), scaled to unit kernel sd."""
    rng = np.random.default_rng(seed)
    prev = rng.uniform(0.3, 0.7, (k, p))
    dv = 2.0 * prev.var(axis=0, ddof=1)
    w = rng.gamma(5.0, size=k)
    w /= w.sum()
    q = prev[rng.choice(k, k, p=w)] + np.sqrt(dv) * rng.normal(size=(k, p))
    a = (q - prev.mean(0)) / np.sqrt(dv)
    b = (prev - prev.mean(0)) / np.sqrt(dv)
    return a, b, np.log(w)


def _emulate_default(a, b, lw):
    """The TPU wrapper's "default" scheme in numpy (float64): its augmented
    operands (pallas_kernels.py:221-236), each rounded to bfloat16 from
    float32, one dot, a logsumexp, max_lw added back."""
    lw = np.maximum(lw, NEG_INF)
    live = lw > NEG_INF / 2
    max_lw = lw[live].max() if live.any() else 0.0
    n, m = a.shape[0], b.shape[0]
    a_aug = np.concatenate([a, (-0.5 * (a * a).sum(1) - max_lw)[:, None],
                            np.ones((n, 1))], 1)
    b_aug = np.concatenate([b, np.ones((m, 1)),
                            (lw - 0.5 * (b * b).sum(1))[:, None]], 1)

    def bf16(x):
        return x.astype(np.float32).astype(ml_dtypes.bfloat16).astype(
            np.float64)

    logits = bf16(a_aug) @ bf16(b_aug).T
    mx = logits.max(1)
    return mx + np.log(np.exp(logits - mx[:, None]).sum(1)) + max_lw


def _t(x, dtype=torch.float64):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


@pytest.mark.parametrize("p", [1, 6, 16])
def test_default_plain_version_is_the_bf16_emulation(p):
    a, b, lw = _ops_like(130, 140, p, seed=p)
    if p == 6:
        lw[[3, 77]] = -np.inf         # zero weights: clamped, then dead
    got = kernels.mixture_logsumexp_reference(_t(a), _t(b), _t(lw),
                                              precision="default")
    np.testing.assert_allclose(got.numpy(), _emulate_default(a, b, lw),
                               rtol=0, atol=1e-9)


@pytest.mark.parametrize("data,p", [
    ("ops", 1), ("ops", 6), ("ops", 16), ("smc", 1), ("smc", 6), ("smc", 16),
])
def test_default_error_against_float64(data, p):
    """"default" really rounds: its float32 plain version sits at least 10x
    farther from the float64 oracle than "high"'s does, and within 0.2 nats
    (the row constant -|a|^2/2 - max_lw, rounded to bf16, carries most)."""
    a, b, lw = (_ops_like(130, 140, p, seed=10 + p) if data == "ops"
                else _smc_like(2000, p, seed=20 + p))
    f32 = [_t(x, torch.float32) for x in (a, b, lw)]
    oracle = kernels.mixture_logsumexp_reference(*(x.double() for x in f32))
    err = {prec: float((kernels.mixture_logsumexp_reference(
        *f32, precision=prec).double() - oracle).abs().max())
        for prec in ("high", "default")}
    assert err["default"] >= 10 * err["high"], err
    assert err["default"] <= 0.2, err


def test_schemes_against_pallas_interpret():
    """On the CPU each scheme of the port's wrapper gives its plain version
    at its own precision, bit-equal across the three, within 2e-4 nats of
    JAX's Pallas kernel in interpret mode at the same precision; the plain
    versions of "high" and "highest" too. JAX's CPU ignores a dot's
    precision, so interpret mode does not round "default" to bfloat16:
    that scheme is held to the emulation above, not to JAX's output."""
    a, b, lw = _ops_like(130, 140, 6, seed=3)
    a32, b32, lw32 = (x.astype(np.float32) for x in (a, b, lw))
    t32 = [_t(x, torch.float32) for x in (a32, b32, lw32)]
    cpu = {}
    for prec in kernels.PRECISIONS:
        want = np.asarray(j_mls(jnp.asarray(a32), jnp.asarray(b32),
                                jnp.asarray(lw32), block_i=128, block_j=256,
                                interpret=True, precision=prec))
        cpu[prec] = kernels.mixture_logsumexp(*t32, precision=prec).numpy()
        np.testing.assert_allclose(cpu[prec], want, rtol=0, atol=2e-4)
        if prec != "default":
            plain = kernels.mixture_logsumexp_reference(*t32, precision=prec)
            np.testing.assert_allclose(plain.numpy(), want, rtol=0,
                                       atol=2e-4)
    for prec in ("high", "default"):
        np.testing.assert_array_equal(cpu[prec], cpu["highest"])


def test_bad_precision_raises():
    a = torch.zeros((4, 2))
    with pytest.raises(ValueError, match="precision"):
        kernels.mixture_logsumexp(a, a, torch.zeros(4), precision="low")
    with pytest.raises(ValueError, match="precision"):
        kernels.mixture_logsumexp_reference(a, a, torch.zeros(4),
                                            precision="fp8")
    with pytest.raises(ValueError, match="precision"):
        kernels.launch_plan(4, 4, 2, 132, False, precision="medium")


@pytest.fixture
def recorded(monkeypatch):
    """The precision each call of ``kernels.mixture_logsumexp`` receives
    (its default filled in), in call order."""
    seen = []
    orig = kernels.mixture_logsumexp
    sig = inspect.signature(orig)

    def record(*args, **kw):
        bound = sig.bind(*args, **kw)
        bound.apply_defaults()
        seen.append(bound.arguments["precision"])
        return orig(*args, **kw)

    monkeypatch.setattr(kernels, "mixture_logsumexp", record)
    return seen


def _dice(sets=2, n=200, **extra):
    raw = json.loads((REPO / "examples" / "dice.json").read_text())
    raw.update(smc_iterations=sets, num_samples=n, database_filename="",
               **extra)
    return raw


@pytest.mark.parametrize("prec", ["default", "high"])
def test_step_passes_the_config_precision_on_every_shard(recorded, prec):
    """run_device on a 2-shard mesh: each shard's weight call of the one
    weighted set carries the config's weight_precision."""
    AbcSmc(_dice(weight_precision=prec), device="cpu").run_device(
        seed=1, mesh=particle_mesh(["cpu"] * 2))
    assert recorded == [prec, prec]


def test_host_brain_and_density_default_run_highest(recorded):
    """The host engine's brain weighs with weight_predictive_prior, which
    passes nothing: "highest", JAX's default there, whatever the config
    says; so does log_kernel_mixture_density's own default."""
    AbcSmc(_dice(weight_precision="default"), device="cpu").run(seed=1)
    assert recorded and set(recorded) == {"highest"}
    del recorded[:]
    a, b, lw = _ops_like(20, 30, 2, seed=1)
    weights.log_kernel_mixture_density(_t(a), _t(b), _t(lw),
                                       torch.ones(2, dtype=torch.float64))
    assert recorded == ["highest"]


@pytest.mark.parametrize("prec,k_step,nbytes,width", [
    ("high", 8, 8, 2), ("default", 16, 2, 2), ("highest", 1, 4, 1),
])
def test_launch_plan_per_scheme(prec, k_step, nbytes, width):
    """The k-step and the b_aug stage of each scheme: K = p+2 (b, a column
    of ones and cb) padded to 8 (3xTF32, a TF32 hi and lo per column) or
    16 (BF16, one bfloat16), or p+1 rows unpadded (FFMA, one float: b and
    cb, its accumulators start at ca + cb); a stage is whole float4s (the
    C entry takes its size in float4s); the first workspace segment holds
    every stage, and the other segments follow it as for "high"."""
    for n, m, p in ((2048, 2048, 16), (50_000, 50_000, 6), (37, 1000, 1),
                    (4096, 4096, 80), (410, 410, 3)):
        plan = kernels.launch_plan(n, m, p, 132, True, precision=prec)
        ks = -(-(p + width) // k_step)
        assert (plan.k_step, plan.ks, plan.precision) == (k_step, ks, prec)
        assert plan.k_pad == k_step * ks >= p + width
        assert 4 * plan.stage_floats == 64 * plan.k_pad * nbytes
        assert plan.stage_floats % 4 == 0
        assert plan.offsets[1] >= plan.n_stages * plan.stage_floats
        assert plan.offsets[1] - plan.n_stages * plan.stage_floats < 4
        high = kernels.launch_plan(n, m, p, 132, True)
        assert plan[1:6] == high[1:6]
        assert (plan.ws_floats - plan.offsets[1]
                == high.ws_floats - high.offsets[1])


@pytest.mark.parametrize("prec,fmas,issued", [
    ("high", lambda k: 3 * k, lambda k: 3 * 8 * -(-k // 8)),
    ("default", lambda k: k, lambda k: 16 * -(-k // 16)),
    ("highest", lambda k: k, lambda k: k),
])
def test_bound_counts_the_dot_over_unpadded_k(prec, fmas, issued):
    """The kernel bound's dot term counts the FMAs the function needs over
    K = p + 2 (3K TF32 for "high", K BF16 for "default", K FFMA for
    "highest"); the count as issued over K padded to the mma's k-step is
    returned beside it and is never smaller."""
    for p in (1, 6, 13, 16, 80):
        k = p + 2
        _, need, got, _ = bench_kernel.dot_fmas(p, prec)
        assert (need, got) == (fmas(k), issued(k))
        assert got >= need
    with pytest.raises(ValueError):
        bench_kernel.dot_fmas(6, "fast")
