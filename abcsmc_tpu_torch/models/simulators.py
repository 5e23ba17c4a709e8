"""Simulator adapters (port of :mod:`abcsmc_tpu.models.simulators`).

Four kinds, each mapping (model-space params, per-particle seeds, serials)
to a metrics matrix through ``run_batch``:

- :class:`DeviceSimulator` wraps a batched ``fn(params[N, P], seeds[N]) ->
  metrics[N, M]`` on tensors. Per-particle noise is a counter hash of
  (seed, column), so a particle replays from its stored seed alone, on any
  device and in any batch. The hash differs from JAX's threefry keys: a
  particle's metrics agree with the JAX package's in law, not draw for
  draw. ``run_batch`` runs ``fn`` on the device and dtype the caller names.
  :class:`HostBridgeSimulator` is a device simulator whose batched ``fn``
  is host numpy code: the step copies its rows to the host and back.
- :class:`PySimulator`, :class:`ExecSimulator` and
  :class:`SharedLibSimulator` are host code, one particle at a time (a
  Python callable, an external executable, a shared object with the C ABI
  or the reference ABI through :mod:`abcsmc_tpu_torch.models.ref_shim`).

All ten builtins of the JAX package are here: ``dice``, ``gaussian``,
``linear_gaussian``, ``sir``, ``seir_campaign``, ``lotka_volterra``,
``ricker``, ``gk``, ``mg1`` and ``ma2``. The seven model families are
written as ``metrics_from_noise(params, noise)``: ``noise`` serves standard
normals, unit uniforms and Exp(1) draws a block of columns at a time
(:class:`CounterNoise` in production; a test can serve the JAX function's
own draws instead), so a time loop draws one step's columns at a time and
never holds a [N, steps] noise block. Each family documents its column
layout: the layout is what makes a particle replay from its stored seed.
"""

from __future__ import annotations

import ctypes
import math
import os
import shlex
import subprocess
from pathlib import Path
from typing import Callable, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from abcsmc_tpu_torch.errors import SimulatorError
from abcsmc_tpu_torch.ops import sim_kernels
from abcsmc_tpu_torch.ops.pls import _fmix32

_MIX_FILE = Path(__file__).with_name("linear_gaussian_mix.npz")
_SEED_SALT = 0x9E3779B9
_UNIFORM_SALT = 0x85EBCA6B
_EXPONENTIAL_SALT = 0xC2B2AE35


class Simulator:
    """Base adapter: ``run_batch(params [n, P], seeds [n], serials [n])``
    returns float64 metrics [n, M] as a numpy array. ``device`` and
    ``dtype`` name where a device simulator computes; host simulators
    ignore them."""

    #: True when ``batch_fn`` computes on tensors inside a generation step
    is_device = False

    def run_batch(self, params, seeds, serials, *, device=None, dtype=None):
        raise NotImplementedError


class DeviceSimulator(Simulator):
    """Vectorized simulator on tensors: ``fn(params[N, P], seeds[N] int64)
    -> metrics[N, M]`` in params' dtype and on params' device."""

    is_device = True
    #: True when ``batch_fn`` can be recorded into a CUDA graph (no host
    #: round trip); ``Generation.capturable`` reads it
    capturable = True
    #: time steps its loop has run, summed over rows and calls (each step
    #: of a call adds the call's rows); None for a simulator with no time
    #: loop. ``Generation`` reads it around each set's simulate stage
    row_steps: int | None = None
    #: names of the counts the simulator keeps on the device, which its
    #: calls add to with no host sync (:meth:`device_counts`); empty for a
    #: simulator that keeps none
    count_names: tuple[str, ...] = ()
    #: CUDA event pairs around the row statistics of each call on the card
    #: outside a graph capture, since the caller last cleared it; None for
    #: a simulator that times no such stage
    stats_events: list | None = None

    def __init__(self, fn: Callable, nmet: int | None = None):
        self.fn = fn
        self.nmet = nmet

    def device_counts(self, device) -> torch.Tensor:
        """The counts of ``count_names`` on ``device``, int64 [len], zero
        where first asked for. The first call on a device must come outside
        a CUDA graph capture: a vector made inside one would be the graph's,
        and every replay would zero it."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        held = self.__dict__.setdefault("_device_counts", {})
        counts = held.get(device)
        if counts is None:
            counts = held[device] = torch.zeros(
                len(self.count_names), dtype=torch.int64, device=device)
        return counts

    def batch_fn(self, params, seeds):
        return self.fn(params, seeds)

    def run_batch(self, params, seeds, serials, *, device, dtype):
        """``fn`` on ``device`` in ``dtype`` (both explicit: the engine
        passes its own; ``device="cpu", dtype=torch.float64`` is the host
        convenience), from numpy or tensor inputs; float64 numpy out. The
        seeds go in as int64, as in the generation step, so a particle gives
        the same metrics on either path at the same dtype."""
        p = torch.as_tensor(np.asarray(params, np.float64)).to(device, dtype)
        s = torch.as_tensor(np.asarray(seeds).astype(np.int64)).to(device)
        return self.fn(p, s).to("cpu", torch.float64).numpy()


class HostBridgeSimulator(DeviceSimulator):
    """A batched host simulator inside the device step (port of
    :class:`abcsmc_tpu.models.simulators.HostBridgeSimulator`):
    ``fn(params[n, P] ndarray, seeds[n] ndarray) -> metrics[n, M]``, for
    legacy numpy or Python simulators that anything exposing params ->
    metrics can wrap. It is a :class:`DeviceSimulator`, so ``run_device``
    runs the whole step on the device (ranking, weights through the
    kernel, proposal) and only the simulate stage makes a round trip to
    the host: :meth:`batch_fn` copies a shard's rows (or a ``row_block``
    block's) to the host, calls ``fn`` and returns its metrics on the
    rows' device in their dtype.

    ``fn`` sees what the JAX package's ``io_callback`` hands it: params in
    the step's float dtype and seeds as ``uint32`` (the step's seeds are
    int64 in [0, 2^31 - 1), so the cast is lossless). :meth:`run_batch`
    (the host engine: ``run()``, the CLI's ``--simulate``) calls it in
    float64, with the seeds as given, as the JAX ``run_batch`` does.

    A step whose simulator makes a host round trip is never captured into
    a CUDA graph (``capturable`` is False): a device-to-host copy inside
    stream capture is an error, so bridged sets run eagerly on every
    route. The JAX package's ``backend_supports_callbacks`` probe and its
    fallback to the host engine have no counterpart: a CUDA device (and
    the CPU) can always make the round trip.

    On a particle mesh each process calls ``fn`` for its own shards only,
    and the metrics are gathered in shard order, so a side-effecting
    ``fn`` runs exactly once per row fleet-wide. ``fn`` must be available
    and deterministic per (params, seed) on every process. Rows are padded
    up to a multiple of the shard count with copies of the last row (as in
    the JAX package), and those copies reach ``fn`` too: "once per
    particle" holds where the rows divide by the shards."""

    capturable = False

    def __init__(self, fn: Callable, nmet: int):
        self.host_fn = fn
        self.nmet = nmet

    def batch_fn(self, params, seeds):
        n, dev = params.shape[0], params.device
        if dev.type == "cuda":
            # pinned staging: the cached host allocator hands each call its
            # own block, so an array ``fn`` keeps stays valid
            p_host = torch.empty(params.shape, dtype=params.dtype,
                                 pin_memory=True)
            s_host = torch.empty((n,), dtype=torch.int32, pin_memory=True)
            p_host.copy_(params)
            s_host.copy_(seeds.to(torch.int32))
        else:
            p_host = params.detach().clone()
            s_host = seeds.to(torch.int32)
        p_np = p_host.numpy()
        mets = np.asarray(self.host_fn(p_np, s_host.numpy().view(np.uint32)))
        if mets.shape != (n, self.nmet):
            raise SimulatorError(
                f"host simulator returned metrics of shape {mets.shape}, "
                f"expected ({n}, {self.nmet})"
            )
        out = torch.from_numpy(np.ascontiguousarray(mets, p_np.dtype))
        if dev.type == "cuda":
            out = out.pin_memory().to(dev, non_blocking=True)
        return out

    def run_batch(self, params, seeds, serials, *, device=None, dtype=None):
        return np.asarray(
            self.host_fn(np.asarray(params, np.float64), np.asarray(seeds)),
            np.float64,
        )


class PySimulator(Simulator):
    """Host python callable, one particle at a time:
    ``f(params: list[float], seed: int, serial: int) -> list[float]``."""

    def __init__(self, fn: Callable):
        self.fn = fn

    def run_batch(self, params, seeds, serials, *, device=None, dtype=None):
        rows = []
        for row, seed, serial in zip(params, seeds, serials):
            met = self.fn([float(v) for v in row], int(seed), int(serial))
            rows.append(np.asarray(met, np.float64))
        return _stack_checked(rows)


class ExecSimulator(Simulator):
    """External executable: ``cmd p1 p2 ... pP`` per particle; metrics are
    whitespace-separated doubles on stdout (AbcSim.h:120-157). The seed and
    serial are exported as ABC_RNG_SEED / ABC_SERIAL for children that
    want to replay deterministically."""

    def __init__(self, command: str):
        self.command = command

    def run_one(self, row: Sequence[float], seed: int, serial: int):
        args = shlex.split(self.command) + [repr(float(v)) for v in row]
        env = dict(os.environ)
        env["ABC_RNG_SEED"] = str(int(seed))
        env["ABC_SERIAL"] = str(int(serial))
        try:
            out = subprocess.run(
                args, capture_output=True, text=True, env=env, check=True
            ).stdout
        except (subprocess.CalledProcessError, OSError) as e:
            raise SimulatorError(f"executable simulator failed: {e}",
                                 code=-211)
        try:
            return np.array([float(tok) for tok in out.split()], np.float64)
        except ValueError:
            raise SimulatorError(
                f"could not parse metrics from simulator stdout: {out!r}",
                code=-211,
            )

    def run_batch(self, params, seeds, serials, *, device=None, dtype=None):
        return _stack_checked([
            self.run_one(row, seed, serial)
            for row, seed, serial in zip(params, seeds, serials)
        ])


class SharedLibSimulator(Simulator):
    """Shared-object simulator loaded with ctypes. Two ABIs: the portable C
    ABI

        int abc_simulator(const double* pars, size_t npar,
                          unsigned long seed, unsigned long serial,
                          double* mets, size_t nmet);   // 0 on success

    and the reference ABI (an unmangled C++ ``simulator`` symbol,
    AbcSim.h:55-114), called through a small adapter compiled on demand
    (:mod:`abcsmc_tpu_torch.models.ref_shim`). ``nmet`` is the config's
    metric count."""

    def __init__(self, soname: str, nmet: int):
        self.nmet = nmet
        self._shim = None
        self.lib = ctypes.CDLL(soname)
        try:
            self._fn = self.lib.abc_simulator
        except AttributeError:
            from abcsmc_tpu_torch.models.ref_shim import (
                ReferenceShim, has_reference_abi,
            )

            if not has_reference_abi(soname):
                raise SimulatorError(
                    f"{soname} exports neither C symbol 'abc_simulator' nor "
                    "the reference-ABI 'simulator'", code=-211
                )
            self._shim = ReferenceShim(soname)
            self._fn = None
            return
        self._fn.restype = ctypes.c_int
        self._fn.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_size_t,
            ctypes.c_ulong, ctypes.c_ulong,
            ctypes.POINTER(ctypes.c_double), ctypes.c_size_t,
        ]

    def run_batch(self, params, seeds, serials, *, device=None, dtype=None):
        rows = []
        for row, seed, serial in zip(params, seeds, serials):
            if self._shim is not None:
                rows.append(np.asarray(
                    self._shim(row, int(seed), int(serial), self.nmet),
                    np.float64,
                ))
                continue
            pars = (ctypes.c_double * len(row))(*[float(v) for v in row])
            mets = (ctypes.c_double * self.nmet)()
            rc = self._fn(pars, len(row), int(seed), int(serial), mets,
                          self.nmet)
            if rc != 0:
                raise SimulatorError(
                    f"shared-lib simulator returned {rc} for serial {serial}",
                    code=-211,
                )
            rows.append(np.array(list(mets), np.float64))
        return _stack_checked(rows)


def _stack_checked(rows: list[np.ndarray]) -> np.ndarray:
    if not rows:
        return np.zeros((0, 0))
    width = len(rows[0])
    for r in rows:
        if len(r) != width:
            raise SimulatorError(
                "simulator returned inconsistent metric counts", code=-211
            )
    return np.stack(rows)


# --------------------------------------------------------------------------- #
# Counter-hash noise and the builtin device simulators
# --------------------------------------------------------------------------- #

def _seed_base(seeds, salt: int):
    """The per-particle half of the counter hash: murmur3-mixed
    (seed ^ salt), uint32 values held in int64 [N]."""
    s = torch.as_tensor(seeds).to(torch.int64) & 0xFFFFFFFF
    return _fmix32(s ^ salt)


def _bits_from_base(base, ncols: int, stride: int, offset: int,
                    first_col: int = 0):
    """murmur3-mixed 32-bit words [N, ncols] of (seed, stride * col +
    offset) for col = first_col .. first_col + ncols - 1."""
    col = torch.arange(first_col, first_col + ncols, dtype=torch.int64,
                       device=base.device)
    return _fmix32(base[:, None] ^ (stride * col + offset)[None, :])


def _normals_from_base(base, ncols: int, dtype, first_col: int = 0):
    return _box_muller(_bits_from_base(base, ncols, 2, 0, first_col),
                       _bits_from_base(base, ncols, 2, 1, first_col), dtype)


def _box_muller(h1, h2, dtype):
    """Standard normals from two arrays of 32-bit words, in float64, cast
    to ``dtype``."""
    u1 = (h1.to(torch.float64) + 1.0) / 2.0**32       # (0, 1]
    u2 = h2.to(torch.float64) / 2.0**32               # [0, 1)
    z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2)
    return z.to(dtype)


def _uniforms_from_base(base, ncols: int, first_col: int = 0):
    return _bits_from_base(base, ncols, 1, 0, first_col).to(
        torch.float64) / 2.0**32


def counter_normals(seeds, ncols: int, dtype, first_col: int = 0):
    """Standard normals [N, ncols], a pure function of (seed, column): two
    murmur3-mixed 32-bit words per cell feed a Box-Muller transform in
    float64, cast to ``dtype``. Columns ``first_col .. first_col + ncols -
    1``: a time loop asks for one step's columns at a time."""
    return _normals_from_base(_seed_base(seeds, _SEED_SALT), ncols, dtype,
                              first_col)


def counter_uniforms(seeds, ncols: int, first_col: int = 0):
    """Unit uniforms in [0, 1) [N, ncols], float64, a pure function of
    (seed, column) (a salt of their own, apart from the normals')."""
    return _uniforms_from_base(_seed_base(seeds, _UNIFORM_SALT), ncols,
                               first_col)


def counter_exponentials(seeds, ncols: int, first_col: int = 0):
    """Exp(1) draws [N, ncols], float64, a pure function of (seed, column):
    ``-log1p(-u)`` of unit uniforms with a salt of their own."""
    return -torch.log1p(-_uniforms_from_base(
        _seed_base(seeds, _EXPONENTIAL_SALT), ncols, first_col))


class CounterNoise:
    """The noise source of the model families: per-particle draws from the
    counter hash of (seed, column), served a block of columns at a time.
    Each kind (normals, uniforms, exponentials) has its own salt and its
    own column cursor, so a family's column layout is the order in which it
    asks. Every block is [N, ncols] in ``dtype`` on the seeds' device."""

    def __init__(self, seeds, dtype):
        self.dtype = dtype
        self._normal = _seed_base(seeds, _SEED_SALT)
        self._uniform = _seed_base(seeds, _UNIFORM_SALT)
        self._exponential = _seed_base(seeds, _EXPONENTIAL_SALT)
        self._next = [0, 0, 0]

    def _advance(self, kind: int, ncols: int) -> int:
        first = self._next[kind]
        self._next[kind] = first + ncols
        return first

    def normals(self, ncols: int):
        return _normals_from_base(self._normal, ncols, self.dtype,
                                  self._advance(0, ncols))

    def uniforms(self, ncols: int):
        """In [0, 1): a float64 draw that a narrower ``dtype`` would round
        up to 1 becomes the largest value below 1."""
        u = _uniforms_from_base(self._uniform, ncols,
                                self._advance(1, ncols)).to(self.dtype)
        return torch.clamp_max(u, 1.0 - torch.finfo(self.dtype).eps / 2)

    def exponentials(self, ncols: int):
        u = _uniforms_from_base(self._exponential, ncols,
                                self._advance(2, ncols))
        return (-torch.log1p(-u)).to(self.dtype)


def shipped_mix(npar: int, nmet: int) -> np.ndarray:
    """The JAX package's linear-Gaussian mixing matrix
    ``jax.random.normal(PRNGKey(7), (npar, nmet))`` (float32), shipped for
    the shapes the repo's configs and tools use: (16, 100), (6, 13) and
    (2, 2)."""
    with np.load(_MIX_FILE) as data:
        key = f"mix_{npar}x{nmet}"
        if key not in data:
            raise SimulatorError(
                f"no shipped linear_gaussian mixing matrix for shape "
                f"({npar}, {nmet}); shipped: {sorted(data.files)}. Pass "
                "mix= (e.g. the JAX package's matrix as a numpy array)"
            )
        return np.array(data[key])


def make_dice_simulator(max_dice: int = 1000) -> DeviceSimulator:
    """The dice game (examples/include/dice.h:14-45): roll ``ndice`` dice
    with ``nsides`` faces; metrics are the sum and the per-roll sample sd
    (ddof=1, 0 for one die). ``ndice`` is clipped to [1, max_dice] and
    ``nsides`` to >= 1, as in the JAX builtin; roll i of a particle is
    ``floor(u_i * nsides) + 1`` for its counter uniform u_i."""

    def fn(params, seeds):
        dt = params.dtype
        n = torch.clamp(params[:, 0], 1, max_dice).to(torch.int64)
        faces = torch.clamp_min(params[:, 1], 1).to(torch.int64)
        u = counter_uniforms(seeds, max_dice)
        rolls = torch.floor(u * faces[:, None].to(torch.float64)) + 1.0
        mask = torch.arange(max_dice, device=params.device)[None, :] < n[:, None]
        rolls = torch.where(mask, rolls, torch.zeros_like(rolls))
        total = rolls.sum(dim=1)
        nf = n.to(torch.float64)
        mean = total / nf
        ss = torch.where(mask, (rolls - mean[:, None]) ** 2,
                         torch.zeros_like(rolls)).sum(dim=1)
        sd = torch.where(n > 1, torch.sqrt(ss / torch.clamp_min(nf - 1, 1)),
                         torch.zeros_like(ss))
        return torch.stack([total, sd], dim=1).to(dt)

    return DeviceSimulator(fn, nmet=2)


def make_linear_gaussian_simulator(
    npar: int, nmet: int, noise_sd: float = 0.3, mix=None,
) -> DeviceSimulator:
    """metrics = params @ mix + noise_sd * N(0, 1): the linear-Gaussian
    surrogate of :func:`abcsmc_tpu.models.simulators.
    make_linear_gaussian_simulator`. ``mix`` [npar, nmet] defaults to the
    shipped copy of the JAX matrix."""
    mix = shipped_mix(npar, nmet) if mix is None else np.array(mix)
    if mix.shape != (npar, nmet):
        raise SimulatorError(
            f"mix has shape {mix.shape}, expected ({npar}, {nmet})"
        )
    cache: dict = {}

    def fn(params, seeds):
        k = (params.device, params.dtype)
        a = cache.get(k)
        if a is None:
            a = cache[k] = torch.as_tensor(mix).to(params)
        eps = noise_sd * counter_normals(seeds, nmet, params.dtype)
        return params @ a + eps

    return DeviceSimulator(fn, nmet=nmet)


def make_gaussian_simulator(n_obs: int = 100) -> DeviceSimulator:
    """Conjugate-Gaussian toy: params = (mu, sigma); ``n_obs`` iid
    N(mu, |sigma|) samples; metrics = (sample mean, sample sd)."""

    def fn(params, seeds):
        mu, sigma = params[:, :1], params[:, 1:2].abs()
        x = mu + sigma * counter_normals(seeds, n_obs, params.dtype)
        m = x.mean(dim=1, keepdim=True)
        sd = torch.sqrt(((x - m) ** 2).sum(dim=1, keepdim=True) / (n_obs - 1))
        return torch.cat([m, sd], dim=1)

    return DeviceSimulator(fn, nmet=2)


# --------------------------------------------------------------------------- #
# The model families (ports of abcsmc_tpu.models.simulators, same formulas)
# --------------------------------------------------------------------------- #

def _family(core: Callable, nmet: int,
            time_loop: bool = False) -> DeviceSimulator:
    """A device simulator from ``core(params, noise) -> metrics``: in
    production ``noise`` is the :class:`CounterNoise` of the particles'
    seeds. ``core`` stays reachable as ``metrics_from_noise`` so that a test
    can feed it another source of the same draws. A ``time_loop`` family's
    ``core`` adds its rows to the simulator's ``row_steps`` once a step."""
    sim = DeviceSimulator(
        lambda params, seeds: core(params, CounterNoise(seeds, params.dtype)),
        nmet=nmet,
    )
    sim.metrics_from_noise = core
    if time_loop:
        sim.row_steps = 0
    return sim


def _binomial_normal(n, p, z):
    """Gaussian approximation to Binomial(n, p) from a standard normal
    ``z``: round(mean + sd z) clipped to [0, n] (half to even, as
    jnp.round)."""
    mean = n * p
    sd = torch.sqrt(torch.clamp_min(n * p * (1 - p), 0.0))
    return torch.minimum(torch.clamp_min(torch.round(mean + sd * z), 0.0), n)


def _first_reaching_half(series, total):
    """Index of the first step whose running sum of ``series`` [T, N]
    reaches ``total / 2``. The running sum of non-negative increments
    ascends and ends at ``total``, so that index is the count of steps
    still below the half (no argmax over ties involved)."""
    return (torch.cumsum(series, dim=0) < (total / 2)[None, :]).sum(dim=0)


def _tree_sum(x):
    """Sum over the last axis by a fixed binary tree of elementwise adds
    (zero-padded to a power of two, then halved until one column is left).
    An elementwise add rounds each cell by itself, so a row's sum does not
    depend on how many other rows share the batch: a particle replayed
    from its stored seed in another batch gives the same bits. A library
    row reduction picks its order from the whole shape."""
    n = x.shape[-1]
    width = 1 << max(n - 1, 0).bit_length()
    if width != n:
        x = torch.nn.functional.pad(x, (0, width - n))
    while width > 1:
        width //= 2
        x = x[..., :width] + x[..., width:]
    return x[..., 0]


def _tree_cumsum(x):
    """Running sum over the last axis by log2(n) shifted elementwise adds
    (Hillis-Steele): like :func:`_tree_sum`, the same bits for a row
    whatever the batch around it."""
    n = x.shape[-1]
    shift = 1
    while shift < n:
        x = x + torch.nn.functional.pad(x[..., :-shift], (shift, 0))
        shift *= 2
    return x


def _row_quantiles(x, qs: Sequence[float]):
    """Quantiles [N, len(qs)] of each row of ``x`` [N, n]: position
    (n - 1) q with linear interpolation, as ``jnp.quantile`` (one sort of
    the rows, then two gathers)."""
    srt = torch.sort(x, dim=1).values
    n = x.shape[1]
    cols = []
    for q in qs:
        pos = q * (n - 1)
        lo, hi = math.floor(pos), math.ceil(pos)
        w = pos - lo
        cols.append(srt[:, lo] * (1.0 - w) + srt[:, hi] * w)
    return torch.stack(cols, dim=1)


_OCTILES = tuple(i / 8.0 for i in range(1, 8))


def make_sir_simulator(population: int = 10_000, t_steps: int = 160,
                       i0: int = 10) -> DeviceSimulator:
    """Stochastic discrete-time SIR (chain binomial, Gaussian approximation
    to each binomial). params = (beta, gamma) per-step rates; metrics =
    (final size, peak prevalence, peak time, epidemic duration, mean
    infection time, half-time of the incidence).

    Column layout: step t reads normals 2t (new infections) and 2t + 1 (new
    recoveries). Peak, duration and the incidence moments are running
    values; the incidence series [t_steps, N] is kept for the half-time.

    Two paths, the same bits. A call of the simulator on a CUDA device
    runs the whole loop as one hand-written kernel
    (:func:`abcsmc_tpu_torch.ops.sim_kernels.sir_loop`, float32 or
    float64; it raises on what it does not take). A call on the CPU, and
    ``metrics_from_noise`` always, runs the chain of PyTorch ops below."""

    def core(params, noise):
        dt, dev, n = params.dtype, params.device, params.shape[0]
        beta = params[:, 0].abs()
        gamma = torch.clamp(params[:, 1].abs(), 1e-6, 1.0)
        p_rec = 1.0 - torch.exp(-gamma)
        s = torch.full((n,), float(population - i0), dtype=dt, device=dev)
        i = torch.full((n,), float(i0), dtype=dt, device=dev)
        r = torch.zeros((n,), dtype=dt, device=dev)
        peak = torch.full((n,), -math.inf, dtype=dt, device=dev)
        peak_time = torch.zeros((n,), dtype=dt, device=dev)
        duration = torch.zeros((n,), dtype=dt, device=dev)
        total_inc = torch.zeros((n,), dtype=dt, device=dev)
        time_inc = torch.zeros((n,), dtype=dt, device=dev)
        incidence = torch.empty((t_steps, n), dtype=dt, device=dev)
        for t in range(t_steps):
            z = noise.normals(2)
            p_inf = 1.0 - torch.exp(-beta * i / population)
            new_inf = _binomial_normal(s, p_inf, z[:, 0])
            new_rec = _binomial_normal(i, p_rec, z[:, 1])
            s = s - new_inf
            i = i + new_inf - new_rec
            r = r + new_rec
            higher = i > peak               # strict: the first maximum wins
            peak = torch.where(higher, i, peak)
            peak_time = torch.where(higher, torch.full_like(peak_time, t),
                                    peak_time)
            duration = duration + (i > 0).to(dt)
            total_inc = total_inc + new_inf
            time_inc = time_inc + t * new_inf
            incidence[t] = new_inf
            sim.row_steps += n
        mean_time = time_inc / torch.clamp_min(total_inc, 1.0)
        half = _first_reaching_half(incidence, total_inc).to(dt)
        return torch.stack([r + i, peak, peak_time, duration, mean_time,
                            half], dim=1)

    def batch(params, seeds):
        if not params.is_cuda:
            return core(params, CounterNoise(seeds, params.dtype))
        out = sim_kernels.sir_loop(
            params[:, :2].contiguous(),
            seeds.to(params.device, torch.int64).contiguous(), population,
            t_steps, i0)
        sim.row_steps += t_steps * params.shape[0]
        return out

    sim = _family(core, nmet=6, time_loop=True)
    sim.fn = batch
    return sim


def make_seir_campaign_simulator(population: int = 100_000,
                                 t_steps: int = 365,
                                 e0: int = 20) -> DeviceSimulator:
    """SEIR epidemic with a vaccination campaign. params = (beta,
    incubation rate, gamma, campaign start as a fraction of the horizon,
    daily vaccination rate); metrics = (final size, peak prevalence, peak
    time, cases before and after the campaign starts, attack rate among the
    unvaccinated, duration, half-time).

    Column layout: step t reads normals 4t .. 4t + 3 (exposures, onsets,
    recoveries, vaccinations). The onset series [t_steps, N] is kept for
    the half-time; everything else is a running value."""

    def core(params, noise):
        dt, dev, n = params.dtype, params.device, params.shape[0]
        beta = params[:, 0].abs()
        inc = torch.clamp(params[:, 1].abs(), 1e-3, 1.0)
        gamma = torch.clamp(params[:, 2].abs(), 1e-3, 1.0)
        vax_day = torch.clamp(params[:, 3], 0.0, 1.0) * t_steps
        vax_rate = torch.clamp(params[:, 4].abs(), 0.0, 0.05)
        p_onset = 1.0 - torch.exp(-inc)
        p_rec = 1.0 - torch.exp(-gamma)

        def zeros():
            return torch.zeros((n,), dtype=dt, device=dev)

        s = torch.full((n,), float(population - e0), dtype=dt, device=dev)
        e = torch.full((n,), float(e0), dtype=dt, device=dev)
        i, r, v = zeros(), zeros(), zeros()
        peak = torch.full((n,), -math.inf, dtype=dt, device=dev)
        peak_time, duration, total, before = zeros(), zeros(), zeros(), zeros()
        onsets = torch.empty((t_steps, n), dtype=dt, device=dev)
        for t in range(t_steps):
            z = noise.normals(4)
            p_inf = 1.0 - torch.exp(-beta * i / population)
            new_e = _binomial_normal(s, p_inf, z[:, 0])
            new_i = _binomial_normal(e, p_onset, z[:, 1])
            new_r = _binomial_normal(i, p_rec, z[:, 2])
            campaign = (t >= vax_day).to(dt)
            new_v = _binomial_normal(s - new_e, campaign * vax_rate, z[:, 3])
            s = s - new_e - new_v
            e = e + new_e - new_i
            i = i + new_i - new_r
            r = r + new_r
            v = v + new_v
            higher = i > peak
            peak = torch.where(higher, i, peak)
            peak_time = torch.where(higher, torch.full_like(peak_time, t),
                                    peak_time)
            duration = duration + (i > 0).to(dt)
            total = total + new_i
            before = before + torch.where(t < vax_day, new_i,
                                          torch.zeros_like(new_i))
            onsets[t] = new_i
            sim.row_steps += n
        half = _first_reaching_half(onsets, total).to(dt)
        attack_unvax = total / torch.clamp_min(population - v, 1.0)
        return torch.stack([r + i + e, peak, peak_time, before,
                            total - before, attack_unvax, duration, half],
                           dim=1)

    sim = _family(core, nmet=8, time_loop=True)
    return sim


def make_lotka_volterra_simulator(t_steps: int = 320, dt: float = 0.1,
                                  x0: float = 10.0, y0: float = 5.0,
                                  n_obs: int = 8,
                                  noise_sd: float = 0.5) -> DeviceSimulator:
    """Stochastic Lotka-Volterra predator-prey dynamics (Toni et al. 2009),
    Euler-Maruyama:

        dx = (a x - x y) dt + sigma sqrt(dt) x dW1   (prey)
        dy = (b x y - y) dt + sigma sqrt(dt) y dW2   (predator)

    params = (a, b); metrics = prey then predator abundances at ``n_obs``
    evenly spaced times, with observation noise.

    Column layout: step t reads normals 2t (prey) and 2t + 1 (predator);
    the observation noise is normals 2 t_steps .. 2 t_steps + 2 n_obs - 1.
    Only the observed states are stored."""

    obs_every = t_steps // n_obs
    obs_steps = {k * obs_every - 1 for k in range(1, n_obs + 1)}

    def core(params, noise):
        dtype, dev, n = params.dtype, params.device, params.shape[0]
        a, b = params[:, 0], params[:, 1]
        # 0.05 * sqrt(dt) rounded as two operations in the working dtype
        diffusion = float(torch.tensor(0.05, dtype=dtype)
                          * torch.sqrt(torch.tensor(dt, dtype=dtype)))
        x = torch.full((n,), x0, dtype=dtype, device=dev)
        y = torch.full((n,), y0, dtype=dtype, device=dev)
        xs, ys = [], []
        for t in range(t_steps):
            e = noise.normals(2)
            dx = (a * x - x * y) * dt + diffusion * x * e[:, 0]
            dy = (b * x * y - y) * dt + diffusion * y * e[:, 1]
            x = torch.clamp(x + dx, 1e-3, 1e4)
            y = torch.clamp(y + dy, 1e-3, 1e4)
            if t in obs_steps:
                xs.append(x)
                ys.append(y)
            sim.row_steps += n
        obs = torch.stack(xs + ys, dim=1)
        return obs + noise_sd * noise.normals(2 * n_obs)

    sim = _family(core, nmet=2 * n_obs, time_loop=True)
    return sim


def make_ricker_simulator(t_steps: int = 100, n0: float = 1.0,
                          burn_in: int = 50) -> DeviceSimulator:
    """Ricker population map with Poisson observations (Wood 2010):

        N_{t+1} = r N_t exp(-N_t + sigma e_t),  y_t ~ Poisson(phi N_t)

    params = (log_r, sigma, phi); metrics = (mean, sd, autocorrelations at
    lags 1 and 2, number of zeros, maximum) of the observed series after
    the burn-in. The Poisson draw is the inverse CDF on a 24-point grid
    below a mean of 10 (draws past the grid clamp to 23) and the rounded
    normal approximation above.

    Column layout: step t reads normals 2t (process noise) and 2t + 1 (the
    normal of the Poisson approximation) and uniform t (the Poisson inverse
    CDF). Only the ``t_steps`` observed counts are stored.

    Two paths for the loop, the same bits. A call of the simulator on a
    CUDA device runs it as one hand-written kernel
    (:func:`abcsmc_tpu_torch.ops.sim_kernels.ricker_loop`, float32 or
    float64; it raises on what it does not take). A call on the CPU, and
    ``metrics_from_noise`` always, runs the chain of PyTorch ops below. The
    row statistics after the loop are PyTorch ops on both.

    Counts on the device (``count_names``, :meth:`DeviceSimulator.
    device_counts`): ``sim_grid_steps``, the observed row-steps whose draw
    came from the grid (a mean of at most 10), and ``sim_clamped_draws``,
    the grid draws that clamped at 23. A call on the card outside a graph
    capture records CUDA events around the row statistics after the loop
    (range ``abcsmc.sim.stats``) into ``stats_events``. Neither changes a
    bit of the metrics."""

    def core(params, noise):
        dt, dev, n = params.dtype, params.device, params.shape[0]
        r = torch.exp(torch.clamp(params[:, 0], 0.0, 6.0))
        sigma = torch.clamp(params[:, 1].abs(), 1e-3, 2.0)
        phi = torch.clamp(params[:, 2].abs(), 1e-2, 50.0)
        grid = torch.arange(24, dtype=dt, device=dev)
        log_fact = torch.lgamma(grid + 1.0)
        grid_idx = torch.arange(24, device=dev)
        # per row: observed steps on the normal branch, clamped grid draws
        counts = torch.zeros((2, n), dtype=torch.int32, device=dev)
        on_normal, clamped = counts

        def poisson(lam, u, g):
            lam_s = torch.clamp_max(lam, 20.0)
            logpmf = (grid[None, :]
                      * torch.log(torch.clamp_min(lam_s, 1e-9))[:, None]
                      - lam_s[:, None] - log_fact[None, :])
            cdf = torch.cumsum(torch.exp(logpmf), dim=1)
            # first grid point whose CDF reaches u; 24 when none does, and
            # then u lies past the grid: the largest draws clamp to 23
            idx = torch.where(cdf >= u[:, None], grid_idx[None, :],
                              24).amin(dim=1).to(dt)
            past = u > cdf[:, -1]
            small = torch.where(past, torch.full_like(idx, 23.0), idx)
            large = torch.clamp_min(
                torch.round(lam + torch.sqrt(lam) * g), 0.0)
            big = lam > 10.0
            on_normal.add_(big)
            clamped.add_(past & ~big)
            return torch.where(big, large, small)

        pop = torch.full((n,), n0, dtype=dt, device=dev)
        ys = torch.empty((n, t_steps), dtype=dt, device=dev)
        for t in range(t_steps + burn_in):
            z = noise.normals(2)
            u = noise.uniforms(1)[:, 0]
            pop = torch.clamp(r * pop * torch.exp(-pop + sigma * z[:, 0]),
                              1e-9, 1e6)
            if t >= burn_in:
                ys[:, t - burn_in] = poisson(phi * pop, u, z[:, 1])
            sim.row_steps += n
        return statistics(ys, counts)

    def statistics(ys, counts):
        """The metrics of the observed series ys [n, t_steps]
        (particle-major; each statistic is a fixed tree of elementwise adds
        over a row, _tree_sum, the same bits whatever the batch), and the
        loop's counts [2, n] added to the device counts."""
        dt, n = ys.dtype, ys.shape[0]
        timed = (ys.is_cuda and sim.stats_events is not None
                 and not torch.cuda.is_current_stream_capturing())
        with record_function("abcsmc.sim.stats"):
            if timed:
                events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                events[0].record()
            m = _tree_sum(ys) / t_steps
            yc = ys - m[:, None]
            ss = _tree_sum(yc * yc)
            sd = torch.sqrt(torch.clamp_min(ss / (t_steps - 1), 0.0))
            denom = torch.clamp_min(ss, 1e-9)
            ac1 = _tree_sum(yc[:, 1:] * yc[:, :-1]) / denom
            ac2 = _tree_sum(yc[:, 2:] * yc[:, :-2]) / denom
            zeros = _tree_sum((ys == 0).to(dt))
            out = torch.stack([m, sd, ac1, ac2, zeros, ys.amax(dim=1)],
                              dim=1)
            if timed:
                events[1].record()
                sim.stats_events.append(events)
        sim.device_counts(ys.device).add_(torch.stack([
            t_steps * n - counts[0].sum(), counts[1].sum()]))
        return out

    def batch(params, seeds):
        if not params.is_cuda:
            return core(params, CounterNoise(seeds, params.dtype))
        ys, counts = sim_kernels.ricker_loop(
            params[:, :3].contiguous(),
            seeds.to(params.device, torch.int64).contiguous(), t_steps,
            burn_in, n0)
        sim.row_steps += (t_steps + burn_in) * params.shape[0]
        return statistics(ys, counts)

    sim = _family(core, nmet=6, time_loop=True)
    sim.fn = batch
    sim.count_names = ("sim_grid_steps", "sim_clamped_draws")
    sim.stats_events = []
    return sim


def make_gk_simulator(n_obs: int = 500) -> DeviceSimulator:
    """g-and-k quantile distribution (Rayner & MacGillivray 2002):

        Q(z) = A + B (1 + 0.8 tanh(g z / 2)) (1 + z^2)^k z

    params = (A, B, g, k); metrics = octiles 1..7 of ``n_obs`` draws plus
    the spread between octiles 6 and 2.

    Column layout: draw j is normal j."""

    def core(params, noise):
        A = params[:, :1]
        B = torch.clamp_min(params[:, 1:2], 1e-3)
        g = params[:, 2:3]
        k = torch.clamp_min(params[:, 3:4], -0.4)
        z = noise.normals(n_obs)
        x = A + B * (1.0 + 0.8 * torch.tanh(g * z / 2.0)) * torch.pow(
            1.0 + z * z, k) * z
        qs = _row_quantiles(x, _OCTILES)
        return torch.cat([qs, qs[:, 5:6] - qs[:, 1:2]], dim=1)

    return _family(core, nmet=8)


def mg1_departure_times(a, s):
    """Scan-free M/G/1 departure times along the last axis from arrival
    times ``a`` and service times ``s``: ``d_i = S_i + cummax_{j<=i}(a_j -
    S_{j-1})`` with ``S_i = s_1 + .. + s_i``, algebraically the sequential
    recursion ``d_i = s_i + max(a_i, d_{i-1})``. The running sums are
    :func:`_tree_cumsum` (batch-invariant bits); a running max rounds
    nothing."""
    S = _tree_cumsum(s)
    return S + torch.cummax(a - (S - s), dim=-1).values


def make_mg1_simulator(n_customers: int = 50) -> DeviceSimulator:
    """M/G/1 queue (Fearnhead & Prangle 2012): Exp(theta3) inter-arrival
    times, U(theta1, theta2) service, only the inter-departure times are
    observed. params = (theta1, theta2, theta3); metrics = octiles 1..7 of
    the inter-departure times plus their mean.

    Column layout: customer j reads exponential j (inter-arrival time) and
    uniform j (service time)."""

    def core(params, noise):
        lo = torch.minimum(params[:, 0], params[:, 1])[:, None]
        hi = torch.maximum(params[:, 0], params[:, 1])[:, None] + 1e-6
        rate = torch.clamp(params[:, 2].abs(), 1e-4, 1e3)[:, None]
        a = _tree_cumsum(noise.exponentials(n_customers) / rate)
        s = lo + (hi - lo) * noise.uniforms(n_customers)
        d = mg1_departure_times(a, s)
        y = torch.diff(d, dim=1, prepend=torch.zeros_like(d[:, :1]))
        return torch.cat([_row_quantiles(y, _OCTILES),
                          (_tree_sum(y) / n_customers)[:, None]], dim=1)

    return _family(core, nmet=8)


def make_ma2_simulator(n_obs: int = 200) -> DeviceSimulator:
    """MA(2) process (Marin et al. 2012): ``y_t = e_t + theta1 e_{t-1} +
    theta2 e_{t-2}``. params = (theta1, theta2); metrics = autocovariances
    at lags 0..2 (divisor ``n_obs``).

    Column layout: innovation e_j is normal j, j = 0 .. n_obs + 1."""

    def core(params, noise):
        t1, t2 = params[:, :1], params[:, 1:2]
        e = noise.normals(n_obs + 2)
        y = e[:, 2:] + t1 * e[:, 1:-1] + t2 * e[:, :-2]
        g0 = _tree_sum(y * y) / n_obs
        g1 = _tree_sum(y[:, 1:] * y[:, :-1]) / n_obs
        g2 = _tree_sum(y[:, 2:] * y[:, :-2]) / n_obs
        return torch.stack([g0, g1, g2], dim=1)

    return _family(core, nmet=3)


#: the builtin simulators (config "simulator" key); factories get
#: (npar, nmet) from the parsed config
BUILTIN_SIMULATORS: dict[str, Callable[[int, int], DeviceSimulator]] = {
    "dice": lambda npar, nmet: make_dice_simulator(),
    "gaussian": lambda npar, nmet: make_gaussian_simulator(),
    "sir": lambda npar, nmet: make_sir_simulator(),
    "linear_gaussian": make_linear_gaussian_simulator,
    "lotka_volterra": lambda npar, nmet: make_lotka_volterra_simulator(),
    "seir_campaign": lambda npar, nmet: make_seir_campaign_simulator(),
    "ricker": lambda npar, nmet: make_ricker_simulator(),
    "gk": lambda npar, nmet: make_gk_simulator(),
    "mg1": lambda npar, nmet: make_mg1_simulator(),
    "ma2": lambda npar, nmet: make_ma2_simulator(),
}


def resolve_simulator(config, explicit: Simulator | None = None):
    """Binding order: explicit > config 'simulator' (builtin) > 'shared' >
    'executable' (src/AbcSmc.cpp:402-406). An unknown builtin name raises
    ``SimulatorError``."""
    if explicit is not None:
        return explicit
    if config.simulator_name:
        if config.simulator_name not in BUILTIN_SIMULATORS:
            raise SimulatorError(
                f"unknown builtin simulator {config.simulator_name!r}"
            )
        return BUILTIN_SIMULATORS[config.simulator_name](
            config.npar, config.nmet
        )
    if config.shared:
        return SharedLibSimulator(config.shared, config.nmet)
    if config.executable:
        return ExecSimulator(config.executable)
    return None
