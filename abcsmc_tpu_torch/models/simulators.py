"""Device simulators on tensors (port of the device part of
:mod:`abcsmc_tpu.models.simulators`).

A :class:`DeviceSimulator` wraps a batched ``fn(params[N, P], seeds[N]) ->
metrics[N, M]``. Per-particle noise is a counter hash of (seed, column), so
a particle replays from its stored seed alone, on any device and in any
batch. The hash differs from JAX's threefry keys: a particle's metrics
agree with the JAX package's in law, not draw for draw.

Ported: ``linear_gaussian`` and ``gaussian``. The other builtins, and the
host-bound executable / shared-library / Python simulators, are not yet
ported and raise from :func:`resolve_simulator`.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from abcsmc_tpu_torch.errors import SimulatorError
from abcsmc_tpu_torch.ops.pls import _fmix32

_MIX_FILE = Path(__file__).with_name("linear_gaussian_mix.npz")
_SEED_SALT = 0x9E3779B9


class DeviceSimulator:
    """Vectorized on-device simulator: ``fn(params[N, P], seeds[N] int64)
    -> metrics[N, M]`` in params' dtype and on params' device."""

    is_device = True

    def __init__(self, fn: Callable, nmet: int | None = None):
        self.fn = fn
        self.nmet = nmet

    def batch_fn(self, params, seeds):
        return self.fn(params, seeds)

    def run_batch(self, params, seeds):
        """Host convenience: numpy in, float64 numpy out (CPU, float64)."""
        p = torch.as_tensor(np.asarray(params, np.float64))
        s = torch.as_tensor(np.asarray(seeds, np.int64))
        return self.fn(p, s).numpy()


def counter_normals(seeds, ncols: int, dtype):
    """Standard normals [N, ncols], a pure function of (seed, column): two
    murmur3-mixed 32-bit words per cell feed a Box-Muller transform in
    float64, cast to ``dtype``."""
    s = torch.as_tensor(seeds).to(torch.int64) & 0xFFFFFFFF
    col = torch.arange(ncols, dtype=torch.int64, device=s.device)
    base = _fmix32(s[:, None] ^ _SEED_SALT)
    h1 = _fmix32(base ^ (2 * col)[None, :])
    h2 = _fmix32(base ^ (2 * col + 1)[None, :])
    u1 = (h1.to(torch.float64) + 1.0) / 2.0**32       # (0, 1]
    u2 = h2.to(torch.float64) / 2.0**32               # [0, 1)
    z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2)
    return z.to(dtype)


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
    "gaussian": lambda npar, nmet: make_gaussian_simulator(),
    "linear_gaussian": make_linear_gaussian_simulator,
}


def resolve_simulator(config, explicit: DeviceSimulator | None = None):
    """Binding order: explicit > config 'simulator' (ported builtins).
    Everything else is not yet ported and raises."""
    if explicit is not None:
        return explicit
    if config.simulator_name:
        factory = BUILTIN_SIMULATORS.get(config.simulator_name)
        if factory is None:
            raise NotImplementedError(
                f"builtin simulator {config.simulator_name!r} is not yet "
                "ported to abcsmc_tpu_torch (ported: "
                f"{sorted(BUILTIN_SIMULATORS)})"
            )
        return factory(config.npar, config.nmet)
    if config.shared or config.executable:
        raise NotImplementedError(
            "host simulators (shared library / executable) and the host "
            "engine loop are not yet ported to abcsmc_tpu_torch"
        )
    return None
