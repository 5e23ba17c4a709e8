"""The hand-written CUDA kernel of a simulator's time loop.

:func:`sir_loop` launches ``csrc/sir_loop.cu`` (built by nvcc for sm_90a at
first use, see :mod:`abcsmc_tpu_torch.ops._build`): the builtin ``sir``
simulator's whole time loop, one thread a particle, in one launch where
the PyTorch chain of ``models/simulators.py::make_sir_simulator`` makes
some 40 a day. It gives the chain's bits on the card, in float32 and in
float64 (the source's header says how); the chain stays the plain version
and runs the CPU and a test's own noise source. Nothing is built when
this module is imported.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

#: the loop lengths the kernel takes: day t reads hash words 4t .. 4t + 3,
#: which have to fit 32 bits
MAX_STEPS = (1 << 30) - 1
_ENTRIES = {torch.float32: ("sir_loop_f32", ctypes.c_float, np.float32),
            torch.float64: ("sir_loop_f64", ctypes.c_double, np.float64)}


@functools.lru_cache(maxsize=None)
def _library(dtype):
    from abcsmc_tpu_torch.ops._build import load_library

    name, scalar, _ = _ENTRIES[dtype]
    fn = getattr(load_library("sir_loop"), name)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.restype = ci
    fn.argtypes = [vp, vp, vp, ci, ci, scalar, scalar, scalar, vp]
    return fn


def _check_inputs(params, seeds, t_steps):
    """Types, contiguity, shapes and the loop's length first (so a CPU test
    can reach each refusal), the device last."""
    if params.dtype not in _ENTRIES:
        raise TypeError(
            f"params must be float32 or float64, got {params.dtype}")
    if seeds.dtype != torch.int64:
        raise TypeError(f"seeds must be int64, got {seeds.dtype}")
    if not (params.is_contiguous() and seeds.is_contiguous()):
        raise ValueError("params and seeds must be contiguous")
    if (params.dim() != 2 or params.shape[1] != 2 or seeds.dim() != 1
            or seeds.shape[0] != params.shape[0]):
        raise ValueError(
            f"shapes params{tuple(params.shape)} seeds{tuple(seeds.shape)}: "
            "expected [n, 2] and [n]")
    if params.shape[0] >= 2**31:
        raise ValueError(f"unsupported row count {params.shape[0]}")
    if not 0 <= t_steps <= MAX_STEPS:
        raise ValueError(
            f"sir_loop takes 0 <= t_steps <= {MAX_STEPS}, got {t_steps}")
    if not (params.is_cuda and seeds.device == params.device):
        raise ValueError(
            f"sir_loop runs on one CUDA device: params on {params.device}, "
            f"seeds on {seeds.device} (the CPU runs the simulator's chain)")


def chain_scalars(dtype, population, i0) -> tuple[float, float, float]:
    """The chain's constants in ``dtype`` on the card: ``torch.full``'s
    fill values S = population - i0 and I = i0, and the reciprocal of the
    population that PyTorch's CUDA division by a Python scalar multiplies
    by, taken in float64 and then rounded to the dtype (past 2^24 it is
    not the reciprocal of the population rounded to float32)."""
    fp = _ENTRIES[dtype][2]
    return (float(fp(float(population - i0))), float(fp(float(i0))),
            float(fp(1.0 / population)))


def sir_loop(params, seeds, population, t_steps: int, i0):
    """Metrics [n, 6] of the ``sir`` simulator (final size, peak
    prevalence, peak day, days infected, mean infection day, half-time)
    for params [n, 2] (beta, gamma) float32 or float64 and seeds [n]
    int64, both contiguous on one CUDA device, in one kernel launch on the
    current stream, in the params' dtype. Nothing syncs the host, so a
    CUDA graph can record the call. Raises on inputs it does not take and
    on a failed launch."""
    t_steps = int(t_steps)
    _check_inputs(params, seeds, t_steps)
    n = params.shape[0]
    out = torch.empty((n, 6), dtype=params.dtype, device=params.device)
    if n == 0:
        return out
    index = params.device.index
    with torch.cuda.device(index):
        err = _library(params.dtype)(
            params.data_ptr(), seeds.data_ptr(), out.data_ptr(), n, t_steps,
            *chain_scalars(params.dtype, population, i0),
            torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(
            f"sir_loop kernel launch failed: cudaError {err} (n={n}, "
            f"t_steps={t_steps})")
    sir_loop.launches += 1
    return out


#: kernel launches :func:`sir_loop` issued, one a call (a plain integer;
#: callers reset it to 0 to count a main-path pass). A launch recorded
#: into a CUDA graph counts once per replay of the graph instead
#: (``kernels.graph_capture_counts``, ``kernels.count_replay``)
sir_loop.launches = 0
