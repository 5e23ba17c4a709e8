"""SMC importance weights over the Gaussian perturbation-kernel mixture
(port of :mod:`abcsmc_tpu.ops.weights`; the math and the reference parity
quirks are documented there):

    w_i = prior(theta_i) / sum_j w'_j prod_p N(theta_ip - theta'_jp; sqrt(dv_p))

The denominator goes through :func:`abcsmc_tpu_torch.ops.kernels.
mixture_logsumexp`: a CUDA tensor launches the hand-written kernel, a CPU
tensor runs its plain version.
"""

from __future__ import annotations

import math

import torch

from abcsmc_tpu_torch.ops import kernels


def uniform_weights(n: int, *, device, dtype):
    """Generation-0 predictive prior weights, 1/n each."""
    return torch.full((n,), 1.0 / n, dtype=dtype, device=device)


def _prep_scaled(params, prev_params, prev_doubled_variance):
    """Center both populations on the previous mean, scale live columns to
    unit kernel sd and drop converged (dv == 0) columns. Returns
    (a [n, p], b [m, p], log_norm 0-d)."""
    prev_params = prev_params.to(params.dtype)
    dv = torch.as_tensor(prev_doubled_variance).to(params)
    live = dv > 0
    one = torch.ones_like(dv)
    inv_sd = torch.where(live, 1.0 / torch.sqrt(torch.where(live, dv, one)),
                         torch.zeros_like(dv))
    center = prev_params.mean(dim=0)
    a = (params - center[None, :]) * inv_sd[None, :]
    b = (prev_params - center[None, :]) * inv_sd[None, :]
    log_norm = -0.5 * torch.where(
        live, torch.log(2.0 * math.pi * torch.where(live, dv, one)),
        torch.zeros_like(dv),
    ).sum()
    return a, b, log_norm


def log_kernel_mixture_density(params, prev_params, prev_log_weights,
                               prev_doubled_variance,
                               precision: str = "highest"):
    """log den_i = logsumexp_j [log w'_j - 0.5 sum_p d_ijp^2 / dv_p] + C.

    ``precision`` is the kernel's dot scheme on a CUDA tensor (JAX's
    default, "highest", as the host brain runs it); a CPU tensor ignores
    it, as JAX's XLA path does."""
    a, b, log_norm = _prep_scaled(params, prev_params, prev_doubled_variance)
    lw = torch.as_tensor(prev_log_weights).to(a)
    return kernels.mixture_logsumexp(
        a.contiguous(), b.contiguous(), lw.contiguous(), precision=precision
    ) + log_norm


def weight_predictive_prior(params, prev_params, prev_weights,
                            prev_doubled_variance, prior_log_pdf_fn):
    """Generation t>0 importance weights (src/AbcUtil.cpp:547-586),
    L2-normalized (unit norm, not sum 1: a reference parity quirk)."""
    log_num = prior_log_pdf_fn(params)
    log_den = log_kernel_mixture_density(
        params, prev_params, torch.log(prev_weights.to(params)),
        prev_doubled_variance,
    )
    log_w = log_num - log_den
    log_w = log_w - log_w.max()
    w = torch.exp(log_w)
    return w / torch.sqrt((w * w).sum())
