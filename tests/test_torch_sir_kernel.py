"""The ``sir`` simulator's two paths on the CPU: which calls keep the
PyTorch chain (all of them here: the hand kernel of
``csrc/sir_loop.cu`` runs only on a CUDA device), the counters, and what
the kernel's wrapper refuses before it would build or launch anything.
The kernel's bits against the chain are held on the card
(``tests/test_torch_gpu.py``, ``-k sir_kernel``)."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from abcsmc_tpu_torch import kernel_sass
from abcsmc_tpu_torch.models import simulators
from abcsmc_tpu_torch.models.simulators import CounterNoise, make_sir_simulator
from abcsmc_tpu_torch.ops import _build, sim_kernels

ROOT = Path(__file__).resolve().parent.parent
POP, STEPS, I0, N = 1_000, 24, 5, 96


def _rows(dtype, n=N, seed=0):
    rng = np.random.default_rng(seed)
    params = np.stack([rng.uniform(-0.5, 2.0, n), rng.uniform(-0.3, 1.2, n)],
                      1)
    return (torch.as_tensor(params, dtype=dtype),
            torch.as_tensor(rng.integers(0, 2**31 - 1, n)))


class _HalfNoise:
    """A noise source a test supplies: every normal is 0.5."""

    def normals(self, ncols):
        return torch.full((N, ncols), 0.5, dtype=torch.float64)


@pytest.mark.parametrize("route", ["cpu_float32", "cpu_float64",
                                   "metrics_from_noise"])
def test_calls_off_the_card_run_the_chain(route):
    """On the CPU in either dtype ``batch_fn`` and ``run_batch`` give the
    chain's bits (``metrics_from_noise`` on the seeds' counter noise), and
    a supplied noise source goes through the chain: ``row_steps`` counts
    every step, and the kernel launches nothing."""
    sim = make_sir_simulator(POP, STEPS, I0)
    launches = sim_kernels.sir_loop.launches
    assert sim.row_steps == 0
    if route == "metrics_from_noise":
        got = sim.metrics_from_noise(_rows(torch.float64)[0], _HalfNoise())
        assert got.shape == (N, 6) and bool(torch.isfinite(got).all())
        calls = 1
    else:
        dtype = torch.float32 if route == "cpu_float32" else torch.float64
        params, seeds = _rows(dtype)
        got = sim.batch_fn(params, seeds)
        want = sim.metrics_from_noise(params, CounterNoise(seeds, dtype))
        assert got.dtype == dtype
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        host = sim.run_batch(params.double().numpy(), seeds.numpy(),
                             np.arange(N), device="cpu", dtype=dtype)
        np.testing.assert_array_equal(host, got.double().numpy())
        calls = 3
    assert sim.row_steps == calls * STEPS * N
    assert sim_kernels.sir_loop.launches == launches
    assert "sir_loop" not in _build._loaded


def _bad_inputs():
    params, seeds = _rows(torch.float32, n=8)
    wide = torch.zeros((8, 4), dtype=torch.float32)
    return {
        "cpu": ((params, seeds), ValueError, "CUDA device"),
        "float16": ((params.half(), seeds), TypeError, "float32 or float64"),
        "int32_seeds": ((params, seeds.int()), TypeError, "int64"),
        "non_contiguous": ((wide[:, ::2], seeds), ValueError, "contiguous"),
        "three_columns": ((wide[:, :3].contiguous(), seeds), ValueError,
                          r"\[n, 2\]"),
        "ragged": ((params, seeds[:7]), ValueError, r"\[n, 2\]"),
        "negative_steps": ((params, seeds), ValueError, "t_steps", -1),
        "too_many_steps": ((params, seeds), ValueError, "t_steps", 1 << 30),
    }


@pytest.mark.parametrize("case", sorted(_bad_inputs()))
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    """Each refusal raises a clear error before the library is built or
    loaded, and counts no launch: a CPU tensor, a dtype other than
    float32 and float64, a non-contiguous input, a wrong shape, a loop
    length whose hash words would not fit 32 bits."""
    (params, seeds), err, match, *steps = _bad_inputs()[case]
    launches = sim_kernels.sir_loop.launches
    with pytest.raises(err, match=match):
        sim_kernels.sir_loop(params, seeds, POP, *(steps or [STEPS]), I0)
    assert "sir_loop" not in _build._loaded
    assert sim_kernels.sir_loop.launches == launches


def test_the_kernel_source_keeps_the_chain_constants():
    """The kernel's hash salt is the normals', and its two C entries are
    the wrapper's, one a dtype; the longest loop the wrapper takes keeps
    the last hash word of a day, 4 t + 3, within 32 bits (the C entry's
    own check)."""
    text = _build.source_bytes(_build.CSRC / "sir_loop.cu").decode()
    assert f"kSeedSalt = 0x{simulators._SEED_SALT:X}u;" in text
    for name, *_ in sim_kernels._ENTRIES.values():
        assert f'extern "C" int {name}(' in text
    assert "t_steps >= (1 << 30)" in text
    assert 4 * sim_kernels.MAX_STEPS + 3 < 2**32 <= 4 * (
        sim_kernels.MAX_STEPS + 1) + 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_chain_scalars_round_as_the_card_divides(dtype):
    """S0 and I0 are the fill values rounded to the dtype; the population's
    reciprocal is taken in float64 and then rounded, as PyTorch's CUDA
    division by a Python scalar takes it. Past 2^24 that is not the
    reciprocal of the population rounded to float32."""
    fp = np.float32 if dtype == torch.float32 else np.float64
    pop, i0 = 2**25 + 7, 3
    s0, i, inv = sim_kernels.chain_scalars(dtype, pop, i0)
    assert (s0, i) == (float(fp(pop - i0)), 3.0)
    assert inv == float(fp(1.0 / pop))
    if dtype == torch.float32:
        assert inv != float(fp(1) / fp(pop))
    assert sim_kernels.chain_scalars(dtype, 10_000, 10) == (
        9_990.0, 10.0, float(fp(1) / fp(10_000)))


def test_importing_builds_nothing(tmp_path):
    """Importing the simulators and the wrapper loads no library and runs
    no nvcc (a fresh interpreter, with no nvcc to be found)."""
    code = ("from abcsmc_tpu_torch.models import simulators\n"
            "from abcsmc_tpu_torch.ops import _build, sim_kernels\n"
            "simulators.make_sir_simulator()\n"
            "assert not _build._loaded and not _build.build_seconds\n"
            "print('ok')\n")
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path),
               PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_kernel_sass_reads_every_source_by_default(monkeypatch):
    """With no ``--source``, ``kernel_sass`` analyses every ``csrc/*.cu``:
    the weight kernel and the sir and ricker loops."""
    seen = []
    monkeypatch.setattr(_build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(kernel_sass, "analyze",
                        lambda src, match, sass_dir: seen.append(src) or [])
    assert kernel_sass.main([]) == 0
    assert [p.name for p in seen] == ["mixture_logsumexp.cu",
                                      "ricker_loop.cu", "sir_loop.cu"]
    seen.clear()
    assert kernel_sass.main(["--source", "x.cu"]) == 0
    assert seen == [Path("x.cu")]
