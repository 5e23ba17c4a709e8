"""Vectorized parameter distributions on tensors (port of
:mod:`abcsmc_tpu.models.parameters`; the reference semantics are documented
there).

Random draws are tensor inputs: :meth:`ParameterSet.noise_independent`
takes unit uniforms ``u`` and maps them exactly as
``jax.random.truncated_normal`` maps its own uniforms, so feeding it
``jax.random.uniform(k_noise, shape)`` reproduces the JAX perturbation.
The rejection loops (``noise_independent(method="rejection")`` and
:meth:`ParameterSet.noise_multivariate`) take their first round's normals
as an input and draw later rounds from a generator. The thin wrappers
(:meth:`Parameter.sample`, :meth:`ParameterSet.sample_priors`,
:meth:`ParameterSet.perturb_independent`,
:meth:`ParameterSet.perturb_multivariate`) draw from an explicit
``torch.Generator``.

PSEUDO and POSTERIOR (projection) parameters are enumerated on the host
(:meth:`ParameterSet.indexed_grid_values`, numpy) in the reference's
odometer order; asking them for a density, a recast or noise raises.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from abcsmc_tpu_torch.config import DistType, NumType, ParameterSpec
from abcsmc_tpu_torch.errors import ConfigError

_LOG_2PI = math.log(2.0 * math.pi)


@functools.lru_cache(maxsize=256)
def _const(values: tuple, dtype, device):
    """A small constant tensor, copied to ``device`` once: a step that is
    captured into a CUDA graph must not copy host values to the device."""
    return torch.tensor(values, dtype=dtype, device=device)


class Parameter:
    """Base prior. Concrete types implement vectorized sample/log_pdf/recast."""

    is_posterior: bool = False
    state_size: int = 0  # 0 == not an indexed (PSEUDO/POSTERIOR) parameter

    def __init__(self, name: str, short_name: str | None = None):
        self.name = name
        self.short_name = short_name if short_name else name

    def sample(self, generator: torch.Generator, n: int, dtype):
        raise NotImplementedError

    def log_pdf(self, x):
        raise NotImplementedError

    def recast(self, x):
        return x

    def valid(self, x):
        return torch.isfinite(self.log_pdf(x))

    def get_mean(self) -> float:
        return math.nan

    def get_sd(self) -> float:
        return math.nan

    def noise_support(self) -> tuple[float, float]:
        """The x-interval on which ``recast(x)`` is valid: the acceptance
        region of the reference's rejection loop (Priors.h:19-33)."""
        raise NotImplementedError

    def value_bounds(self) -> tuple[float, float]:
        """Closed interval of valid post-recast values."""
        return self.noise_support()


class GaussianPrior(Parameter):
    """Priors.h:46-60."""

    def __init__(self, name, mean, sd, short_name=None):
        super().__init__(name, short_name)
        self.mean = float(mean)
        self.sd = float(sd)

    def sample(self, generator, n, dtype):
        z = torch.randn(n, generator=generator, device=generator.device,
                        dtype=dtype)
        return self.mean + self.sd * z

    def log_pdf(self, x):
        z = (x - self.mean) / self.sd
        return -0.5 * z * z - math.log(self.sd) - 0.5 * _LOG_2PI

    def get_mean(self):
        return self.mean

    def get_sd(self):
        return self.sd

    def noise_support(self):
        return (-math.inf, math.inf)


class ContinuousUniformPrior(Parameter):
    """Priors.h:85-110."""

    def __init__(self, name, min_val, max_val, short_name=None):
        super().__init__(name, short_name)
        if not min_val < max_val:
            raise ConfigError(
                f"UNIFORM parameter '{name}': par1 ({min_val}) must be < "
                f"par2 ({max_val}).",
                code=1,
            )
        self.min_val = float(min_val)
        self.max_val = float(max_val)

    def sample(self, generator, n, dtype):
        u = torch.rand(n, generator=generator, device=generator.device,
                       dtype=dtype)
        return self.min_val + (self.max_val - self.min_val) * u

    def log_pdf(self, x):
        in_range = (self.min_val <= x) & (x <= self.max_val)
        return torch.where(
            in_range,
            torch.full_like(x, -math.log(self.max_val - self.min_val)),
            torch.full_like(x, -math.inf),
        )

    def get_mean(self):
        return (self.max_val + self.min_val) / 2.0

    def get_sd(self):
        return (self.max_val - self.min_val) / math.sqrt(12.0)

    def noise_support(self):
        return (self.min_val, self.max_val)


class DiscreteUniformPrior(Parameter):
    """Priors.h:62-83. Integer uniform on [min, max] inclusive; sd uses the
    continuous-uniform formula (a reference parity quirk)."""

    def __init__(self, name, min_val, max_val, short_name=None):
        super().__init__(name, short_name)
        if not min_val < max_val:
            raise ConfigError(
                f"UNIFORM INT parameter '{name}': par1 ({min_val}) must be "
                f"< par2 ({max_val}).",
                code=1,
            )
        self.min_val = int(min_val)
        self.max_val = int(max_val)

    def sample(self, generator, n, dtype):
        draws = torch.randint(
            self.min_val, self.max_val + 1, (n,), generator=generator,
            device=generator.device,
        )
        return draws.to(dtype)

    def recast(self, x):
        return torch.round(x)

    def log_pdf(self, x):
        is_integral = x == torch.round(x)
        in_range = (self.min_val <= x) & (x <= self.max_val)
        return torch.where(
            is_integral & in_range,
            torch.full_like(x, -math.log(self.max_val - self.min_val + 1)),
            torch.full_like(x, -math.inf),
        )

    def get_mean(self):
        return (self.max_val + self.min_val) / 2.0

    def get_sd(self):
        return (self.max_val - self.min_val) / math.sqrt(12.0)

    def noise_support(self):
        # rounding maps (min-0.5, max+0.5) onto the valid integers
        return (self.min_val - 0.5, self.max_val + 0.5)

    def value_bounds(self):
        return (float(self.min_val), float(self.max_val))


class _IndexedParameter(Parameter):
    """A parameter swept over an index, never drawn: sampling, likelihood
    and recast are errors (IndexedPars.h:20-28)."""

    def sample(self, generator, n, dtype):
        raise ConfigError(
            f"it is an error to randomly sample an indexed parameter: {self.name}"
        )

    def log_pdf(self, x):
        raise ConfigError(
            f"it is an error to ask for likelihood from an IndexedPar; "
            f"attempted on {self.name}",
            code=-1,
        )

    def recast(self, x):
        raise ConfigError(
            f"it is an error to attempt to recast an IndexedPar; "
            f"attempted on {self.name}",
            code=-1,
        )


class PseudoParameter(_IndexedParameter):
    """Enumerated grid parameter (IndexedPars.h:32-43)."""

    def __init__(self, name, values: Sequence[float], short_name=None):
        super().__init__(name, short_name)
        assert len(values) > 0
        self.values = tuple(float(v) for v in values)
        self.state_size = len(self.values)


class PosteriorParameter(_IndexedParameter):
    """Rank-indexed parameter whose values come from a previous run's
    posterior (IndexedPars.h:45-55): the sweep enumerates the rank, the
    sampler fills the value from the posterior matrix
    (src/AbcUtil.cpp:510-523)."""

    is_posterior = True

    def __init__(self, name, size: int, short_name=None):
        super().__init__(name, short_name)
        assert size > 0
        self.state_size = int(size)


def parameter_from_spec(spec: ParameterSpec) -> Parameter:
    if spec.dist_type == DistType.UNIFORM:
        if spec.num_type == NumType.INT:
            return DiscreteUniformPrior(
                spec.name, spec.par1, spec.par2, spec.short_name
            )
        return ContinuousUniformPrior(
            spec.name, spec.par1, spec.par2, spec.short_name
        )
    if spec.dist_type == DistType.NORMAL:
        return GaussianPrior(spec.name, spec.par1, spec.par2, spec.short_name)
    if spec.dist_type == DistType.PSEUDO:
        return PseudoParameter(spec.name, spec.values, spec.short_name)
    if spec.dist_type == DistType.POSTERIOR:
        return PosteriorParameter(spec.name, spec.posterior_size,
                                  spec.short_name)
    raise ConfigError(f"unknown dist_type {spec.dist_type}", code=-205)


@dataclass(eq=False)
class ParameterSet:
    """Operations over the full parameter vector, vectorized on the particle
    axis (rows = particles, columns in config order, fitting space)."""

    params: list[Parameter]

    def __post_init__(self):
        self.npar = len(self.params)
        self.prior_idx = [
            i for i, p in enumerate(self.params) if p.state_size == 0
        ]
        self.pseudo_idx = [
            i for i, p in enumerate(self.params)
            if p.state_size > 0 and not p.is_posterior
        ]
        self.posterior_idx = [
            i for i, p in enumerate(self.params) if p.is_posterior
        ]
        self.posterior_size = (
            self.params[self.posterior_idx[0]].state_size
            if self.posterior_idx else 0
        )
        self._int_cols = np.array(
            [isinstance(p, DiscreteUniformPrior) for p in self.params],
            dtype=bool,
        )

    @classmethod
    def from_specs(cls, specs: Sequence[ParameterSpec]) -> "ParameterSet":
        return cls([parameter_from_spec(s) for s in specs])

    def means(self) -> np.ndarray:
        return np.array([p.get_mean() for p in self.params])

    def sds(self) -> np.ndarray:
        return np.array([p.get_sd() for p in self.params])

    def names(self) -> list[str]:
        return [p.name for p in self.params]

    def short_names(self) -> list[str]:
        return [p.short_name for p in self.params]

    def indexed_grid_values(self, n: int) -> tuple[np.ndarray, np.ndarray]:
        """PSEUDO grid values and POSTERIOR rank indices of samples 0..n-1,
        as host numpy: (pseudo_vals [n, n_pseudo], post_ranks [n] or empty).

        The reference's odometer (ParRNG.h:17-36) as mixed-radix index
        arithmetic: the first PSEUDO parameter in config order is the
        fastest digit, later ones roll over after it, and the posterior
        rank advances only when every PSEUDO grid has rolled over."""
        i = np.arange(n, dtype=np.int64)
        pseudo_vals = np.zeros((n, len(self.pseudo_idx)))
        radix = 1
        for col, pidx in enumerate(self.pseudo_idx):
            par = self.params[pidx]
            digits = (i // radix) % par.state_size
            pseudo_vals[:, col] = np.asarray(par.values)[digits]
            radix *= par.state_size
        if self.posterior_idx:
            post_ranks = (i // radix) % self.posterior_size
        else:
            post_ranks = np.zeros((0,), dtype=np.int64)
        return pseudo_vals, post_ranks

    def sample_priors(self, generator: torch.Generator, n: int, dtype,
                      posterior_matrix: np.ndarray | None = None):
        """Generation-0 or projection samples [n, npar] on
        ``generator.device``, one column per parameter in config order
        (src/AbcUtil.cpp:490-526): random draws for the priors, the
        enumeration of :meth:`indexed_grid_values` for PSEUDO parameters
        and the rows of ``posterior_matrix`` [rows, n_posterior] at the
        enumerated ranks for POSTERIOR ones. The ranks are
        ``indexed_grid_values(n)[1]``."""
        cols = [None] * self.npar
        for idx in self.prior_idx:
            cols[idx] = self.params[idx].sample(generator, n, dtype)
        if self.pseudo_idx or self.posterior_idx:
            pseudo_vals, post_ranks = self.indexed_grid_values(n)
            dev = generator.device
            for col, idx in enumerate(self.pseudo_idx):
                cols[idx] = torch.as_tensor(pseudo_vals[:, col]).to(dev, dtype)
            if self.posterior_idx:
                if posterior_matrix is None:
                    raise ConfigError(
                        "POSTERIOR parameters require a posterior matrix "
                        "(posterior_database_filename)",
                        code=-204,
                    )
                pm = np.asarray(posterior_matrix, np.float64)
                assert pm.shape[1] == len(self.posterior_idx)
                for col, idx in enumerate(self.posterior_idx):
                    cols[idx] = torch.as_tensor(
                        pm[post_ranks, col]).to(dev, dtype)
        return torch.stack(cols, dim=1)

    def _require_all_priors(self, what: str):
        if self.pseudo_idx or self.posterior_idx:
            bad = self.params[(self.pseudo_idx + self.posterior_idx)[0]]
            raise ConfigError(
                f"it is an error to ask for {what} with indexed "
                f"(PSEUDO/POSTERIOR) parameters present; attempted on "
                f"{bad.name}",
                code=-1,
            )

    def prior_log_pdf(self, theta):
        """Summed prior log density per row: the SMC weight numerator
        (src/AbcUtil.cpp:556-561)."""
        self._require_all_priors("likelihood")
        lps = [self.params[i].log_pdf(theta[:, i]) for i in range(self.npar)]
        return torch.stack(lps, dim=1).sum(dim=1)

    def recast(self, theta):
        """Round INT columns to integers (half to even, as jnp.round)."""
        if not self._int_cols.any():
            return theta
        mask = _const(tuple(self._int_cols.tolist()), torch.bool,
                      theta.device)
        return torch.where(mask[None, :], torch.round(theta), theta)

    def valid_mask(self, theta):
        self._require_all_priors("validity")
        cols = [self.params[i].valid(theta[:, i]) for i in range(self.npar)]
        return torch.stack(cols, dim=1)

    def noise_independent(self, mu, doubled_variance, u,
                          method: str = "inverse_cdf",
                          max_retries: int = 1000,
                          generator: torch.Generator | None = None):
        """Truncated-normal perturbation ``x ~ N(mu, sqrt(dv))`` restricted
        to each parameter's acceptance region.

        ``method="inverse_cdf"``: ``u`` are unit uniforms (same shape as
        ``mu``), mapped exactly as ``jax.random.truncated_normal`` maps its
        uniforms: ``z = sqrt2 * erfinv(lerp(erf(a/sqrt2), erf(b/sqrt2), u))``
        clamped to the open interval (a, b), then the post-recast values are
        clipped to the support (abcsmc_tpu/models/parameters.py:470-489).
        Converged columns (dv == 0) keep ``mu``.

        ``method="rejection"``: the reference's loop (src/AbcUtil.cpp:145-158)
        per cell: ``u`` are the first round's standard normals; each later
        round draws its normals from ``generator``, up to ``max_retries``
        rounds in all; cells never accepted fall back to the prior mean."""
        self._require_all_priors("noise")
        dtype, device = mu.dtype, mu.device
        sigma = torch.sqrt(torch.as_tensor(doubled_variance, dtype=dtype,
                                           device=device))
        if method == "rejection":
            prior_means = torch.as_tensor(self.means(), dtype=dtype,
                                          device=device)
            return self._reject(
                lambda eps: self.recast(mu + eps * sigma[None, :]),
                self.valid_mask, u.to(dtype), max_retries, generator,
                torch.broadcast_to(prior_means[None, :], mu.shape),
            )[0]
        if method != "inverse_cdf":
            raise ValueError(f"unknown noise method {method!r}")
        bounds = [p.noise_support() + p.value_bounds() for p in self.params]
        lo, hi, vlo, vhi = (
            _const(col, dtype, device) for col in zip(*bounds)
        )
        live = sigma > 0
        safe_sigma = torch.where(live, sigma, torch.ones_like(sigma))
        a = (lo[None, :] - mu) / safe_sigma[None, :]
        b = (hi[None, :] - mu) / safe_sigma[None, :]
        z = truncated_normal_from_uniform(u.to(dtype), a, b)
        x = self.recast(mu + z * safe_sigma[None, :])
        x = torch.minimum(torch.maximum(x, vlo[None, :]), vhi[None, :])
        return torch.where(live[None, :], x, mu)

    def perturb_independent(self, generator: torch.Generator, mu,
                            doubled_variance):
        """:meth:`noise_independent` with its uniforms drawn from
        ``generator``."""
        u = torch.rand(mu.shape, generator=generator, device=mu.device,
                       dtype=mu.dtype)
        return self.noise_independent(mu, doubled_variance, u)

    def noise_multivariate(self, mu, chol_lower, eps, max_retries: int = 1000,
                           generator: torch.Generator | None = None):
        """Truncated multivariate-normal perturbation
        (src/AbcUtil.cpp:122-143): ``x = recast(mu + eps @ L^T)``, a row
        accepted only when every column is valid. ``eps`` are the first
        round's standard normals [n, P]; each later round draws from
        ``generator``, up to ``max_retries`` rounds in all (the reference
        loops forever); rows never accepted fall back to ``mu``. One host
        read of the "all accepted" flag per round. Returns (x, rounds
        drawn)."""
        self._require_all_priors("noise")
        L = torch.as_tensor(chol_lower).to(mu)
        return self._reject(
            lambda e: self.recast(mu + e @ L.T),
            lambda x: self.valid_mask(x).all(dim=1, keepdim=True),
            eps.to(mu.dtype), max_retries, generator, mu,
        )

    def perturb_multivariate(self, generator: torch.Generator, mu,
                             chol_lower, max_retries: int = 1000):
        """:meth:`noise_multivariate` with every round's normals drawn from
        ``generator``."""
        eps = torch.randn(mu.shape, generator=generator, device=mu.device,
                          dtype=mu.dtype)
        return self.noise_multivariate(mu, chol_lower, eps, max_retries,
                                       generator)[0]

    @staticmethod
    def _reject(propose, accept, eps, max_retries, generator, fallback):
        """The bounded rejection loop shared by both noise kinds: keep the
        first accepted proposal per cell (or row, where ``accept`` returns
        [n, 1]); ``fallback`` where none was accepted. Returns (values,
        rounds drawn)."""
        vals = propose(eps)
        accepted = accept(vals)
        attempts = 1
        while attempts < max_retries and not bool(accepted.all()):
            if generator is None:
                raise ValueError(
                    "rejection noise needs a generator for its retry rounds"
                )
            eps = torch.randn(eps.shape, generator=generator,
                              device=eps.device, dtype=eps.dtype)
            prop = propose(eps)
            ok = accept(prop)
            vals = torch.where(~accepted & ok, prop, vals)
            accepted = accepted | ok
            attempts += 1
        return torch.where(accepted, vals, fallback), attempts


def truncated_normal_from_uniform(u, a, b):
    """Standard normal truncated to (a, b) by inverse CDF, from unit
    uniforms ``u``: the transcription of ``jax.random.truncated_normal``
    (uniform on [erf(a/sqrt2), erf(b/sqrt2)), erfinv, clamp to
    [nextafter(a, +inf), nextafter(b, -inf)])."""
    dtype = u.dtype
    sqrt2 = math.sqrt(2.0)
    a = a.to(dtype)
    b = b.to(dtype)
    lo = torch.erf(a / sqrt2)
    hi = torch.erf(b / sqrt2)
    v = torch.maximum(lo, u * (hi - lo) + lo)
    out = sqrt2 * torch.erfinv(v)
    inf = torch.full_like(a, math.inf)
    return torch.minimum(
        torch.maximum(out, torch.nextafter(a, inf)),
        torch.nextafter(b, -inf),
    )
