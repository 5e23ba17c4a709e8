"""The ``ricker`` simulator's two paths on the CPU: which calls keep the
PyTorch chain (all of them here: the hand kernel of
``csrc/ricker_loop.cu`` runs only on a CUDA device), the counters, and
what the kernel's wrapper refuses before it would build or launch
anything. The kernel's bits against the chain are held on the card
(``tests/test_torch_gpu.py``, ``-k ricker_kernel``)."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from abcsmc_tpu_torch.models import simulators
from abcsmc_tpu_torch.models.simulators import (
    CounterNoise, make_ricker_simulator,
)
from abcsmc_tpu_torch.ops import _build, sim_kernels

ROOT = Path(__file__).resolve().parent.parent
STEPS, BURN_IN, N0, N = 12, 5, 1.0, 96


def _rows(dtype, n=N, seed=0):
    rng = np.random.default_rng(seed)
    params = rng.uniform([2.0, 0.05, 2.0], [5.0, 1.0, 30.0], (n, 3))
    return (torch.as_tensor(params, dtype=dtype),
            torch.as_tensor(rng.integers(0, 2**31 - 1, n)))


class _ConstantNoise:
    """A noise source a test supplies: every normal 0.5, every uniform
    0.25."""

    def normals(self, ncols):
        return torch.full((N, ncols), 0.5, dtype=torch.float64)

    def uniforms(self, ncols):
        return torch.full((N, ncols), 0.25, dtype=torch.float64)


@pytest.mark.parametrize("route", ["cpu_float32", "cpu_float64",
                                   "metrics_from_noise"])
def test_calls_off_the_card_run_the_chain(route):
    """On the CPU in either dtype ``batch_fn`` and ``run_batch`` give the
    chain's bits (``metrics_from_noise`` on the seeds' counter noise), and
    a supplied noise source goes through the chain: ``row_steps`` counts
    every step, burn-in included, the grid and clamped counts add up once
    a call, and the kernel launches nothing."""
    sim = make_ricker_simulator(STEPS, N0, BURN_IN)
    launches = sim_kernels.ricker_loop.launches
    counts = sim.device_counts("cpu")
    if route == "metrics_from_noise":
        got = sim.metrics_from_noise(_rows(torch.float64)[0],
                                     _ConstantNoise())
        assert got.shape == (N, 6) and bool(torch.isfinite(got).all())
        calls = 1
    else:
        dtype = torch.float32 if route == "cpu_float32" else torch.float64
        params, seeds = _rows(dtype)
        got = sim.batch_fn(params, seeds)
        once = counts.clone()
        want = sim.metrics_from_noise(params, CounterNoise(seeds, dtype))
        assert got.dtype == dtype
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        host = sim.run_batch(params.double().numpy(), seeds.numpy(),
                             np.arange(N), device="cpu", dtype=dtype)
        np.testing.assert_array_equal(host, got.double().numpy())
        calls = 3
        assert torch.equal(counts, 3 * once)
        assert 0 <= once[1] <= once[0] <= STEPS * N
    assert sim.row_steps == calls * (STEPS + BURN_IN) * N
    assert sim_kernels.ricker_loop.launches == launches
    assert "ricker_loop" not in _build._loaded


def _bad_inputs():
    params, seeds = _rows(torch.float32, n=8)
    wide = torch.zeros((8, 6), dtype=torch.float32)
    return {
        "cpu": ((params, seeds), ValueError, "CUDA device"),
        "float16": ((params.half(), seeds), TypeError, "float32 or float64"),
        "int32_seeds": ((params, seeds.int()), TypeError, "int64"),
        "non_contiguous": ((wide[:, ::2], seeds), ValueError, "contiguous"),
        "two_columns": ((wide[:, :2].contiguous(), seeds), ValueError,
                        r"\[n, 3\]"),
        "ragged": ((params, seeds[:7]), ValueError, r"\[n, 3\]"),
        "negative_steps": ((params, seeds), ValueError, "t_steps", -1,
                           BURN_IN),
        "negative_burn_in": ((params, seeds), ValueError, "burn_in", STEPS,
                             -1),
        "too_many_steps": ((params, seeds), ValueError, "t_steps",
                           (1 << 30) - 50, 50),
    }


@pytest.mark.parametrize("case", sorted(_bad_inputs()))
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    """Each refusal raises a clear error before the library is built or
    loaded, and counts no launch: a CPU tensor, a dtype other than
    float32 and float64, a non-contiguous input, a wrong shape, a negative
    loop part, a loop whose last hash words would not fit 32 bits."""
    (params, seeds), err, match, *steps = _bad_inputs()[case]
    launches = sim_kernels.ricker_loop.launches
    with pytest.raises(err, match=match):
        sim_kernels.ricker_loop(params, seeds,
                                *(steps or [STEPS, BURN_IN]), N0)
    assert "ricker_loop" not in _build._loaded
    assert sim_kernels.ricker_loop.launches == launches


def test_the_kernel_source_keeps_the_chain_constants():
    """The kernel's hash salts are the normals' and the uniforms', its
    grid is the wrapper's, and its two C entries are the wrapper's, one a
    dtype; the longest loop the wrapper takes keeps the last hash word of
    a step, 4 t + 3, within 32 bits (the C entry's own check)."""
    text = _build.source_bytes(_build.CSRC / "ricker_loop.cu").decode()
    assert f"kSeedSalt = 0x{simulators._SEED_SALT:X}u;" in text
    assert f"kUniformSalt = 0x{simulators._UNIFORM_SALT:X}u;" in text
    assert f"kGrid = {sim_kernels.RICKER_GRID};" in text
    for name, *_ in sim_kernels._RICKER_ENTRIES.values():
        assert f'extern "C" int {name}(' in text
    assert "static_cast<long long>(burn_in) >= (1 << 30)" in text



def test_a_library_is_named_by_its_source_and_its_includes(tmp_path):
    """``_build.source_bytes``, what a library's name is hashed from, holds
    the source and each file it includes by a quoted name, each once,
    found beside the file that includes it; a system include does not
    enter. Both loop kernels take the shared header, so an edit of the
    header renames (rebuilds) both."""
    (tmp_path / "sub").mkdir()
    (tmp_path / "a.cu").write_text(
        '#include <math.h>\n#include "h.cuh"\n  # include "sub/g.cuh"\n')
    (tmp_path / "h.cuh").write_text('#pragma once\n#include "sub/g.cuh"\n')
    (tmp_path / "sub" / "g.cuh").write_text('#include "k.cuh"\n')
    (tmp_path / "sub" / "k.cuh").write_text("int k;\n")
    got = _build.source_bytes(tmp_path / "a.cu")
    assert got == b"".join(
        (tmp_path / f).read_bytes()
        for f in ("a.cu", "h.cuh", "sub/g.cuh", "sub/k.cuh"))
    header = (_build.CSRC / "counter_hash.cuh").read_bytes()
    for name in ("sir_loop.cu", "ricker_loop.cu"):
        src = _build.CSRC / name
        assert _build.source_bytes(src) == src.read_bytes() + header
    lone = _build.CSRC / "mixture_logsumexp.cu"
    assert _build.source_bytes(lone) == lone.read_bytes()

def test_importing_builds_nothing(tmp_path):
    """Importing the simulators and the wrapper, and making the simulator,
    loads no library and runs no nvcc (a fresh interpreter, with no nvcc
    to be found)."""
    code = ("from abcsmc_tpu_torch.models import simulators\n"
            "from abcsmc_tpu_torch.ops import _build, sim_kernels\n"
            "simulators.make_ricker_simulator()\n"
            "assert not _build._loaded and not _build.build_seconds\n"
            "print('ok')\n")
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path),
               PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
