"""Simulator adapters (port of :mod:`abcsmc_tpu.models.simulators`).

Four kinds, each mapping (model-space params, per-particle seeds, serials)
to a metrics matrix through ``run_batch``:

- :class:`DeviceSimulator` wraps a batched ``fn(params[N, P], seeds[N]) ->
  metrics[N, M]`` on tensors. Per-particle noise is a counter hash of
  (seed, column), so a particle replays from its stored seed alone, on any
  device and in any batch. The hash differs from JAX's threefry keys: a
  particle's metrics agree with the JAX package's in law, not draw for
  draw. ``run_batch`` runs ``fn`` on the device and dtype the caller names.
- :class:`PySimulator`, :class:`ExecSimulator` and
  :class:`SharedLibSimulator` are host code, one particle at a time (a
  Python callable, an external executable, a shared object with the C ABI
  or the reference ABI through :mod:`abcsmc_tpu_torch.models.ref_shim`).

Ported builtins: ``dice``, ``gaussian`` and ``linear_gaussian``. The other
builtins are not yet ported and raise from :func:`resolve_simulator`.
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

from abcsmc_tpu_torch.errors import SimulatorError
from abcsmc_tpu_torch.ops.pls import _fmix32

_MIX_FILE = Path(__file__).with_name("linear_gaussian_mix.npz")
_SEED_SALT = 0x9E3779B9
_UNIFORM_SALT = 0x85EBCA6B


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

    def __init__(self, fn: Callable, nmet: int | None = None):
        self.fn = fn
        self.nmet = nmet

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

def _counter_bits(seeds, ncols: int, salt: int, stride: int, offset: int):
    """murmur3-mixed 32-bit words [N, ncols] of (seed, stride * col +
    offset), as int64 tensors holding uint32 values."""
    s = torch.as_tensor(seeds).to(torch.int64) & 0xFFFFFFFF
    col = torch.arange(ncols, dtype=torch.int64, device=s.device)
    base = _fmix32(s[:, None] ^ salt)
    return _fmix32(base ^ (stride * col + offset)[None, :])


def counter_normals(seeds, ncols: int, dtype):
    """Standard normals [N, ncols], a pure function of (seed, column): two
    murmur3-mixed 32-bit words per cell feed a Box-Muller transform in
    float64, cast to ``dtype``."""
    h1 = _counter_bits(seeds, ncols, _SEED_SALT, 2, 0)
    h2 = _counter_bits(seeds, ncols, _SEED_SALT, 2, 1)
    u1 = (h1.to(torch.float64) + 1.0) / 2.0**32       # (0, 1]
    u2 = h2.to(torch.float64) / 2.0**32               # [0, 1)
    z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2)
    return z.to(dtype)


def counter_uniforms(seeds, ncols: int):
    """Unit uniforms in [0, 1) [N, ncols], float64, a pure function of
    (seed, column) (a salt of their own, apart from the normals')."""
    return _counter_bits(seeds, ncols, _UNIFORM_SALT, 1, 0).to(
        torch.float64) / 2.0**32


def shipped_mix(npar: int, nmet: int) -> np.ndarray:
    """The JAX package's linear-Gaussian mixing matrix
    ``jax.random.normal(PRNGKey(7), (npar, nmet))`` (float32), shipped for
    the shapes the repo's configs use: (16, 100) and (6, 13)."""
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


#: builtin simulators ported so far (config "simulator" key); factories get
#: (npar, nmet) from the parsed config
BUILTIN_SIMULATORS: dict[str, Callable[[int, int], DeviceSimulator]] = {
    "dice": lambda npar, nmet: make_dice_simulator(),
    "gaussian": lambda npar, nmet: make_gaussian_simulator(),
    "linear_gaussian": make_linear_gaussian_simulator,
}
#: the JAX package's other builtins
NOT_YET_PORTED = ("gk", "lotka_volterra", "ma2", "mg1", "ricker",
                  "seir_campaign", "sir")


def resolve_simulator(config, explicit: Simulator | None = None):
    """Binding order: explicit > config 'simulator' (builtin) > 'shared' >
    'executable' (src/AbcSmc.cpp:402-406). A builtin that is not yet ported
    raises ``NotImplementedError``, an unknown name ``SimulatorError``."""
    if explicit is not None:
        return explicit
    if config.simulator_name:
        factory = BUILTIN_SIMULATORS.get(config.simulator_name)
        if factory is None and config.simulator_name not in NOT_YET_PORTED:
            raise SimulatorError(
                f"unknown builtin simulator {config.simulator_name!r}"
            )
        if factory is None:
            raise NotImplementedError(
                f"builtin simulator {config.simulator_name!r} is not yet "
                "ported to abcsmc_tpu_torch (ported: "
                f"{sorted(BUILTIN_SIMULATORS)})"
            )
        return factory(config.npar, config.nmet)
    if config.shared:
        return SharedLibSimulator(config.shared, config.nmet)
    if config.executable:
        return ExecSimulator(config.executable)
    return None
