"""Vectorized parameter distributions on tensors (port of
:mod:`abcsmc_tpu.models.parameters`; the reference semantics are documented
there).

Random draws are tensor inputs: :meth:`ParameterSet.noise_independent`
takes unit uniforms ``u`` and maps them exactly as
``jax.random.truncated_normal`` maps its own uniforms, so feeding it
``jax.random.uniform(k_noise, shape)`` reproduces the JAX perturbation.
The rejection loops (``noise_independent(method="rejection")`` and
:meth:`ParameterSet.noise_multivariate`) take their first round's normals
as an input; every later round's normals are a counter hash of (retry
seed, round, row, column) (:class:`RetryNormals`), so a round's draws do
not depend on how many rounds ran before it. The loop runs in blocks of
rounds with no host read inside a block (:class:`RejectionLoop`). The thin
wrappers (:meth:`Parameter.sample`, :meth:`ParameterSet.sample_priors`,
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
from abcsmc_tpu_torch.models.simulators import _box_muller, _seed_base
from abcsmc_tpu_torch.ops.pls import _fmix32

_LOG_2PI = math.log(2.0 * math.pi)
#: rounds of a rejection loop between two host reads of its count: the
#: shipped MULTIVARIATE fits need 7-18 rounds early in a fit and 1-8 later
#: (PERF.md section 5), so most steps end inside the first block
REJECTION_BLOCK = 16
_RETRY_SALT = 0x27D4EB2F


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

    def pdf(self, x):
        return torch.exp(self.log_pdf(x))

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

    def recast_valid_mask(self, theta):
        """:meth:`valid_mask` of values already recast (INT columns
        integral): finite and inside each parameter's closed
        :meth:`Parameter.value_bounds`, in four elementwise ops for all
        columns (a rejection round runs it on every proposal)."""
        self._require_all_priors("validity")
        vlo, vhi = (_const(col, theta.dtype, theta.device) for col in
                    zip(*(p.value_bounds() for p in self.params)))
        return torch.isfinite(theta) & (theta >= vlo) & (theta <= vhi)

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
        per cell: ``u`` are the first round's standard normals; the later
        rounds' are :class:`RetryNormals` of a seed drawn from
        ``generator``, up to ``max_retries`` rounds in all; cells never
        accepted fall back to the prior mean."""
        self._require_all_priors("noise")
        dtype, device = mu.dtype, mu.device
        sigma = torch.sqrt(torch.as_tensor(doubled_variance, dtype=dtype,
                                           device=device))
        if method == "rejection":
            if generator is None:
                raise ValueError(
                    "rejection noise needs a generator for its retry seed")
            prior_means = torch.as_tensor(self.means(), dtype=dtype,
                                          device=device)
            loop = RejectionLoop(
                lambda eps: self.recast(mu + eps * sigma[None, :]),
                self.recast_valid_mask, u.to(dtype), max_retries,
                draw_retry_seed(generator),
                torch.broadcast_to(prior_means[None, :], mu.shape),
            )
            return loop.finish()[1]
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
                           retry_seed=None):
        """Truncated multivariate-normal perturbation
        (src/AbcUtil.cpp:122-143): ``x = recast(mu + eps @ L^T)``, a row
        accepted only when every column is valid. ``eps`` are the first
        round's standard normals [n, P]; round r >= 1 takes
        :class:`RetryNormals` of ``retry_seed`` (a uint32 value), up to
        ``max_retries`` rounds in all (the reference loops forever); rows
        never accepted fall back to ``mu``. One host read per block of
        :data:`REJECTION_BLOCK` rounds (:meth:`multivariate_rejection` runs
        a block with none).
        Returns (x, the JAX loop's counter: the first round after which
        every row is accepted, capped at ``max_retries``)."""
        loop = self.multivariate_rejection(mu, chol_lower, eps, max_retries,
                                           retry_seed)
        rounds, x = loop.finish()
        return x, rounds

    def multivariate_rejection(self, mu, chol_lower, eps,
                               max_retries: int = 1000, retry_seed=None,
                               block: int = REJECTION_BLOCK, row0: int = 0):
        """The first block of :meth:`noise_multivariate`'s rounds, with no
        host read: a :class:`RejectionLoop` on the device. A factor that
        holds a NaN (a collapsed column, :func:`setup_mvn_sampler`) accepts
        no proposal, so its count reads ``max_retries`` at once. ``row0``
        is the global index of ``mu``'s first row (a mesh shard's offset):
        the retry rounds' normals are hashed from global rows."""
        self._require_all_priors("noise")
        L = torch.as_tensor(chol_lower).to(mu)
        return RejectionLoop(
            lambda e: self.recast(mu + e @ L.T),
            lambda x: self.recast_valid_mask(x).all(dim=1, keepdim=True),
            eps.to(mu.dtype), max_retries, retry_seed, mu, block,
            hopeless=torch.isnan(L).any(), row0=row0,
        )

    def perturb_multivariate(self, generator: torch.Generator, mu,
                             chol_lower, max_retries: int = 1000):
        """:meth:`noise_multivariate` with the first round's normals and the
        retry seed drawn from ``generator``."""
        eps = torch.randn(mu.shape, generator=generator, device=mu.device,
                          dtype=mu.dtype)
        return self.noise_multivariate(mu, chol_lower, eps, max_retries,
                                       draw_retry_seed(generator))[0]


def draw_retry_seed(generator: torch.Generator):
    """A 0-d int64 uint32 value on ``generator.device``: the retry seed of
    one rejection loop."""
    return torch.randint(0, 2**32, (), generator=generator,
                         device=generator.device)


class RetryNormals:
    """The standard normals [n, P] of a rejection loop's retry rounds r >= 1:
    a counter hash of (seed, round, row, column), so round r's draws are
    the same however many rounds ran before it, in one block or several.
    A bijective murmur3 mix of (seed, row) per row (distinct rows get
    distinct words) and a mixed key per (seed, round, column) are mixed
    once more per cell, two words a cell, into the simulators' Box-Muller
    transform in float64. ``seed`` is a uint32 value (an int or a 0-d
    integer tensor); the normals are on ``device``. The integer hash gives
    the same bits on every device. The rows are the global rows ``row0 ..
    row0 + n - 1``, so the shards of a mesh draw what one device would."""

    def __init__(self, seed, n: int, ncols: int, dtype, device,
                 row0: int = 0):
        self.key = _seed_base(torch.as_tensor(seed, device=device),
                              _RETRY_SALT)
        self.rows = _fmix32(torch.arange(row0, row0 + n, dtype=torch.int64,
                                         device=self.key.device) ^ self.key)
        self.cols = torch.arange(2 * ncols, dtype=torch.int64,
                                 device=self.key.device)
        self.ncols, self.dtype = ncols, dtype

    def round_keys(self, start: int, stop: int):
        """[stop - start, 2P] words of rounds start .. stop - 1."""
        r = torch.arange(start, stop, dtype=torch.int64,
                         device=self.key.device)
        return _fmix32(_fmix32(self.key ^ r)[:, None] ^ self.cols[None, :])

    def normals(self, keys):
        """The normals of the round whose :meth:`round_keys` row is
        ``keys`` [2P]."""
        h = _fmix32(self.rows[:, None] ^ keys[None, :])             # [n, 2P]
        return _box_muller(h[:, :self.ncols], h[:, self.ncols:], self.dtype)


class RejectionLoop:
    """The bounded rejection loop shared by both noise kinds, run in blocks
    of rounds with no host read inside a block.

    ``propose(eps)`` maps a round's normals to proposals, ``accept`` gives
    the cells (or, as [n, 1], the rows) they validate. Each cell keeps its
    first accepted proposal; ``fallback`` stands where none was accepted
    after ``max_retries`` rounds. Round 0 takes ``eps``, round r >= 1
    :class:`RetryNormals` of ``seed``. Construction runs the first block,
    rounds 0 .. min(``block``, ``max_retries``) - 1, and leaves on the
    device the 0-d int64 :attr:`count`: the JAX loop's counter (the first
    round after which every cell is accepted, capped at ``max_retries``;
    ``max_retries`` at once where the 0-d bool ``hopeless`` is set), or -1
    where a cell is still rejected and rounds remain. :meth:`finish` reads
    it and runs further blocks where it is -1. Since a round's normals do
    not depend on the rounds before it, any block size gives the same
    values and count."""

    def __init__(self, propose, accept, eps, max_retries: int, seed,
                 fallback, block: int = REJECTION_BLOCK, hopeless=None,
                 row0: int = 0):
        self.propose, self.accept = propose, accept
        self.max_retries = max(int(max_retries), 1)
        self.fallback = fallback
        self.block, self.hopeless = max(int(block), 1), hopeless
        self.stream = (None if seed is None or self.max_retries == 1 else
                       RetryNormals(seed, eps.shape[0], eps.shape[1],
                                    eps.dtype, eps.device, row0))
        self.vals = propose(eps)
        self.accepted = accept(self.vals)
        self.first = torch.zeros(self.accepted.shape, dtype=torch.int64,
                                 device=eps.device)
        self.rounds = 1
        self._run_rounds(min(self.block, self.max_retries))

    def _run_rounds(self, stop: int):
        """Rounds ``self.rounds`` .. ``stop`` - 1, then the count."""
        start = self.rounds
        if start < stop and self.stream is None:
            raise ValueError("a rejection loop needs a retry seed for its "
                             "later rounds")
        keys = self.stream.round_keys(start, stop) if start < stop else None
        for r in range(start, stop):
            prop = self.propose(self.stream.normals(keys[r - start]))
            ok = self.accept(prop)
            new = ok & ~self.accepted
            self.vals = torch.where(new, prop, self.vals)
            self.first = self.first.masked_fill(new, r)
            self.accepted = self.accepted | ok
        self.rounds = max(stop, start)
        if self.rounds >= self.max_retries:
            out = torch.full((), self.max_retries, dtype=torch.int64,
                             device=self.first.device)
        elif self.hopeless is not None:
            # max_retries where hopeless, else -1
            out = self.hopeless.to(torch.int64) * (self.max_retries + 1) - 1
        else:
            out = torch.full((), -1, dtype=torch.int64,
                             device=self.first.device)
        self.count = torch.where(self.accepted.all(), self.first.max() + 1,
                                 out)

    def values(self):
        """The cells' values after the rounds run so far."""
        return torch.where(self.accepted, self.vals, self.fallback)

    def finish(self):
        """Read the count (one host read per block) and run further blocks
        while it is -1. Returns (count, values); this object then holds
        the finished state."""
        count = int(self.count)
        while count < 0:
            self._run_rounds(min(self.rounds + self.block, self.max_retries))
            count = int(self.count)
        return count, self.values()


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
