"""The hand-written CUDA kernels of the simulators' time loops.

:func:`sir_loop` launches ``csrc/sir_loop.cu`` and :func:`ricker_loop`
``csrc/ricker_loop.cu`` (each built by nvcc for sm_90a at first use, see
:mod:`abcsmc_tpu_torch.ops._build`): the builtin ``sir`` and ``ricker``
simulators' whole time loops, one thread a particle, each in one launch
where the PyTorch chains of ``models/simulators.py`` (``make_sir_simulator``,
``make_ricker_simulator``) make some 40 a day and some 120 a step. Each
gives its chain's bits on the card, in float32 and in float64 (the sources'
headers say how); the chains stay the plain versions and run the CPU and a
test's own noise source. Nothing is built when this module is imported.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

#: the loop lengths the kernels take: step t reads hash words 4t .. 4t + 3,
#: which have to fit 32 bits
MAX_STEPS = (1 << 30) - 1
#: points of the ``ricker`` Poisson draw's inverse-CDF grid
RICKER_GRID = 24
_ENTRIES = {torch.float32: ("sir_loop_f32", ctypes.c_float, np.float32),
            torch.float64: ("sir_loop_f64", ctypes.c_double, np.float64)}
_RICKER_ENTRIES = {
    torch.float32: ("ricker_loop_f32", ctypes.c_float, np.float32),
    torch.float64: ("ricker_loop_f64", ctypes.c_double, np.float64)}


def _bind(library: str, entries: dict, dtype, pointers: int, ints: int,
          scalars: int):
    """The C entry of ``library`` for ``dtype``: ``pointers`` pointers,
    ``ints`` ints and ``scalars`` scalars of the dtype, then the stream."""
    from abcsmc_tpu_torch.ops._build import load_library

    name, scalar, _ = entries[dtype]
    fn = getattr(load_library(library), name)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.restype = ci
    fn.argtypes = [vp] * pointers + [ci] * ints + [scalar] * scalars + [vp]
    return fn


@functools.lru_cache(maxsize=None)
def _library(dtype):
    return _bind("sir_loop", _ENTRIES, dtype, 3, 2, 3)


@functools.lru_cache(maxsize=None)
def _ricker_library(dtype):
    return _bind("ricker_loop", _RICKER_ENTRIES, dtype, 5, 3, 1)


def _check_inputs(kernel: str, params, seeds, width: int, steps: dict):
    """Types, contiguity, shapes and the loop's length first (so a CPU test
    can reach each refusal), the device last. ``steps`` names the loop's
    parts, each at least 0, together at most :data:`MAX_STEPS`."""
    if params.dtype not in _ENTRIES:
        raise TypeError(
            f"params must be float32 or float64, got {params.dtype}")
    if seeds.dtype != torch.int64:
        raise TypeError(f"seeds must be int64, got {seeds.dtype}")
    if not (params.is_contiguous() and seeds.is_contiguous()):
        raise ValueError("params and seeds must be contiguous")
    if (params.dim() != 2 or params.shape[1] != width or seeds.dim() != 1
            or seeds.shape[0] != params.shape[0]):
        raise ValueError(
            f"shapes params{tuple(params.shape)} seeds{tuple(seeds.shape)}: "
            f"expected [n, {width}] and [n]")
    if params.shape[0] >= 2**31:
        raise ValueError(f"unsupported row count {params.shape[0]}")
    if min(steps.values()) < 0 or sum(steps.values()) > MAX_STEPS:
        raise ValueError(
            f"{kernel} takes {' + '.join(steps)} from 0 to {MAX_STEPS}, "
            f"got {steps}")
    if not (params.is_cuda and seeds.device == params.device):
        raise ValueError(
            f"{kernel} runs on one CUDA device: params on {params.device}, "
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
    _check_inputs("sir_loop", params, seeds, 2, {"t_steps": t_steps})
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


def ricker_loop(params, seeds, t_steps: int, burn_in: int, n0):
    """The ``ricker`` simulator's loop for params [n, 3] (log r, sigma,
    phi) float32 or float64 and seeds [n] int64, both contiguous on one
    CUDA device: the observed series ys [n, t_steps] in the params' dtype
    (the ``t_steps`` steps after ``burn_in``, from a population of ``n0``)
    and the counts [2, n] int32 of each row's observed steps drawn from
    the normal and of its grid draws past the grid. One kernel launch on
    the current stream, after the grid's log-factorials (``torch.lgamma``,
    as the chain takes them); nothing syncs the host, so a CUDA graph can
    record the call. Raises on inputs it does not take and on a failed
    launch."""
    t_steps, burn_in = int(t_steps), int(burn_in)
    _check_inputs("ricker_loop", params, seeds, 3,
                  {"t_steps": t_steps, "burn_in": burn_in})
    n, dev, dtype = params.shape[0], params.device, params.dtype
    ys = torch.empty((n, t_steps), dtype=dtype, device=dev)
    counts = torch.empty((2, n), dtype=torch.int32, device=dev)
    if n == 0:
        return ys, counts
    log_fact = torch.lgamma(
        torch.arange(RICKER_GRID, dtype=dtype, device=dev) + 1.0)
    with torch.cuda.device(dev.index):
        err = _ricker_library(dtype)(
            params.data_ptr(), seeds.data_ptr(), log_fact.data_ptr(),
            ys.data_ptr(), counts.data_ptr(), n, t_steps, burn_in,
            float(_RICKER_ENTRIES[dtype][2](n0)),
            torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError(
            f"ricker_loop kernel launch failed: cudaError {err} (n={n}, "
            f"t_steps={t_steps}, burn_in={burn_in})")
    ricker_loop.launches += 1
    return ys, counts


#: kernel launches :func:`ricker_loop` issued, counted as
#: :attr:`sir_loop.launches` is
ricker_loop.launches = 0

#: the loop kernels whose ``launches`` a CUDA graph's capture holds and
#: each replay adds back, keyed by ``__name__``
LOOP_KERNELS = (sir_loop, ricker_loop)
