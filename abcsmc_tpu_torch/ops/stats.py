"""Statistical primitives on tensors (port of :mod:`abcsmc_tpu.ops.stats`).

Only the functions the generation step and :mod:`abcsmc_tpu_torch.reports`
use are ported here; each keeps the reference semantics documented in the
JAX module (ddof=1 standard deviations, ranker-style linear quantiles, the
NRMSE of src/AbcUtil.cpp:326-345).
"""

from __future__ import annotations

import torch


def _t(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def colwise_mean(x):
    return _t(x).mean(dim=0)


def colwise_stdev(x, means=None, ddof: int = 1):
    """Column standard deviations with ddof=1."""
    x = _t(x)
    if means is None:
        means = x.mean(dim=0)
    n = x.shape[0]
    ss = ((x - means[None, :]) ** 2).sum(dim=0)
    return torch.sqrt(ss / (n - ddof))


def median(x):
    """Average-of-middle-two median (torch.median returns the lower one)."""
    return torch.quantile(_t(x).reshape(-1), 0.5, interpolation="linear")


def quantile(x, q: float):
    """ranker.h quantile: position (n-1)q, linear interpolation."""
    return torch.quantile(_t(x).reshape(-1), q, interpolation="linear")


def doubled_variance(params):
    """Per-column 2 * sample variance (ddof=1) of the predictive prior."""
    params = _t(params)
    means = params.mean(dim=0)
    n = params.shape[0]
    var = ((params - means[None, :]) ** 2).sum(dim=0) / max(n - 1, 1)
    return 2.0 * var


def nrmse(posterior_mets, observed):
    """Normalized RMSE of posterior metric means vs observed: expected =
    (|obs| + |sim|)/2, forced to 1 where sim == obs."""
    posterior_mets = _t(posterior_mets)
    observed = _t(observed).to(posterior_mets)
    sim = posterior_mets.mean(dim=0)
    expected = (observed.abs() + sim.abs()) / 2.0
    expected = torch.where(sim == observed, torch.ones_like(expected), expected)
    res = (((sim - observed) / expected) ** 2).mean()
    return torch.sqrt(res)
