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

Fitting mode only: PSEUDO/POSTERIOR (projection) parameters are not yet
ported and raise at construction.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from abcsmc_tpu_torch.config import DistType, NumType, ParameterSpec
from abcsmc_tpu_torch.errors import ConfigError

_LOG_2PI = math.log(2.0 * math.pi)


class Parameter:
    """Base prior. Concrete types implement vectorized sample/log_pdf/recast."""

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
    if spec.dist_type in (DistType.PSEUDO, DistType.POSTERIOR):
        raise NotImplementedError(
            f"parameter '{spec.name}': {spec.dist_type.name} parameters "
            "(projection mode) are not yet ported to abcsmc_tpu_torch; "
            "run projections with abcsmc_tpu"
        )
    raise ConfigError(f"unknown dist_type {spec.dist_type}", code=-205)


@dataclass(eq=False)
class ParameterSet:
    """Operations over the full parameter vector, vectorized on the particle
    axis (rows = particles, columns in config order, fitting space)."""

    params: list[Parameter]

    def __post_init__(self):
        self.npar = len(self.params)
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

    def sample_priors(self, generator: torch.Generator, n: int, dtype):
        """Generation-0 draws [n, npar] on ``generator.device``, one column
        per prior in config order."""
        cols = [p.sample(generator, n, dtype) for p in self.params]
        return torch.stack(cols, dim=1)

    def prior_log_pdf(self, theta):
        """Summed prior log density per row: the SMC weight numerator
        (src/AbcUtil.cpp:556-561)."""
        lps = [self.params[i].log_pdf(theta[:, i]) for i in range(self.npar)]
        return torch.stack(lps, dim=1).sum(dim=1)

    def recast(self, theta):
        """Round INT columns to integers (half to even, as jnp.round)."""
        if not self._int_cols.any():
            return theta
        mask = torch.as_tensor(self._int_cols, device=theta.device)
        return torch.where(mask[None, :], torch.round(theta), theta)

    def valid_mask(self, theta):
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
            )
        if method != "inverse_cdf":
            raise ValueError(f"unknown noise method {method!r}")
        bounds = [p.noise_support() + p.value_bounds() for p in self.params]
        lo, hi, vlo, vhi = (
            torch.tensor(col, dtype=dtype, device=device)
            for col in zip(*bounds)
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
        read of the "all accepted" flag per round."""
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
                                       generator)

    @staticmethod
    def _reject(propose, accept, eps, max_retries, generator, fallback):
        """The bounded rejection loop shared by both noise kinds: keep the
        first accepted proposal per cell (or row, where ``accept`` returns
        [n, 1]); ``fallback`` where none was accepted."""
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
        return torch.where(accepted, vals, fallback)


def truncated_normal_from_uniform(u, a, b):
    """Standard normal truncated to (a, b) by inverse CDF, from unit
    uniforms ``u``: the transcription of ``jax.random.truncated_normal``
    (uniform on [erf(a/sqrt2), erf(b/sqrt2)), erfinv, clamp to
    [nextafter(a, +inf), nextafter(b, -inf)])."""
    dtype = u.dtype
    sqrt2 = torch.tensor(math.sqrt(2.0), dtype=dtype, device=u.device)
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
