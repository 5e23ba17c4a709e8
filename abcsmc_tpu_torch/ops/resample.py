"""Weighted resampling of predictive-prior particles (port of
:mod:`abcsmc_tpu.ops.resample`; the semantics are documented there).

The index functions take their uniforms as inputs, so feeding them JAX's
draws reproduces the JAX indices; :func:`sample_predictive_priors` and
:func:`sample_mvn_predictive_priors` are the thin wrappers that draw from an
explicit ``torch.Generator``.
"""

from __future__ import annotations

import torch

_STRATUM_BLOCK = 4096


def categorical_indices(weights, u):
    """iid indices with P(j) proportional to weights[j], by inverse CDF:
    ``u`` [N] unit uniforms, scaled by the total weight, searched (left) in
    the cumulative weights."""
    w = torch.as_tensor(weights)
    cdf = torch.cumsum(w, dim=0)
    idx = torch.searchsorted(cdf, u.to(w.dtype) * cdf[-1])
    return torch.clamp_max(idx, w.shape[0] - 1)


def systematic_indices(weights, num_samples: int, u):
    """Systematic resampling: the inverse CDF at ``(i + u) / N`` for one
    shared unit uniform ``u`` (0-d)."""
    w = torch.as_tensor(weights)
    cdf = torch.cumsum(w, dim=0)
    pts = _stratum_points(torch.arange(num_samples, device=w.device),
                          u.to(w.dtype), cdf[-1] / num_samples, w.dtype)
    return torch.clamp_max(torch.searchsorted(cdf, pts), w.shape[0] - 1)


def _stratum_points(i, u, scale, dtype):
    """(i + u) * scale without adding the fractional offset to a large index
    in low precision: i = hi*B + lo keeps each product small before the adds
    (at i >= 2^22 a plain f32 i + u quantizes u away)."""
    hi = (i // _STRATUM_BLOCK).to(dtype)
    lo = (i % _STRATUM_BLOCK).to(dtype)
    return hi * (_STRATUM_BLOCK * scale) + (lo + u) * scale


def resample_indices(weights, num_samples: int, u,
                     method: str = "multinomial"):
    """``multinomial`` (iid, ``u`` [N]) or ``systematic`` (``u`` 0-d)."""
    if method == "systematic":
        return systematic_indices(weights, num_samples, u)
    if method != "multinomial":
        raise ValueError(f"unknown resample method {method!r}")
    return categorical_indices(weights, u)


def draw_pick_uniforms(generator: torch.Generator, num_samples: int,
                       method: str, dtype):
    """The uniforms :func:`resample_indices` takes, from ``generator``."""
    shape = () if method == "systematic" else (num_samples,)
    return torch.rand(shape, generator=generator, device=generator.device,
                      dtype=dtype)


def sample_predictive_priors(generator: torch.Generator, num_samples: int,
                             weights, prev_params, parameter_set,
                             doubled_variance, max_retries: int = 1000,
                             method: str = "multinomial"):
    """INDEPENDENT-noise proposal (src/AbcUtil.cpp:377-389): weighted
    resample of the survivors, then the inverse-CDF truncated normal with
    the doubled variance (``max_retries`` is unused there, as in JAX)."""
    prev_params = torch.as_tensor(prev_params)
    u = draw_pick_uniforms(generator, num_samples, method, prev_params.dtype)
    mu = prev_params[resample_indices(weights, num_samples, u, method)]
    return parameter_set.perturb_independent(generator, mu, doubled_variance)


def sample_mvn_predictive_priors(generator: torch.Generator,
                                 num_samples: int, weights, prev_params,
                                 parameter_set, chol_lower,
                                 max_retries: int = 1000,
                                 method: str = "multinomial"):
    """MULTIVARIATE-noise proposal (src/AbcUtil.cpp:391-404): weighted
    resample, then the bounded-retry truncated MVN with the Cholesky factor
    of :func:`setup_mvn_sampler`."""
    prev_params = torch.as_tensor(prev_params)
    u = draw_pick_uniforms(generator, num_samples, method, prev_params.dtype)
    mu = prev_params[resample_indices(weights, num_samples, u, method)]
    return parameter_set.perturb_multivariate(generator, mu, chol_lower,
                                              max_retries)


def setup_mvn_sampler(params):
    """Cholesky factor of the survivors' covariance (n-1 divisor) with the
    diagonal alone doubled (src/AbcUtil.cpp:462-488). The products run in
    full FP32/FP64 (TF32 is off package-wide). A covariance that is not
    positive definite (a collapsed column) gives a factor with NaN on and
    below the diagonal, as ``jnp.linalg.cholesky`` does, without a host
    sync."""
    params = torch.as_tensor(params)
    n = params.shape[0]
    centered = params - params.mean(dim=0)[None, :]
    sigma = (centered.T @ centered) / max(n - 1, 1)
    sigma = sigma + torch.diag(torch.diagonal(sigma))
    L, info = torch.linalg.cholesky_ex(sigma)
    return torch.where(info == 0, L,
                       torch.tril(torch.full_like(L, float("nan"))))
