"""Statistical primitives on tensors (port of :mod:`abcsmc_tpu.ops.stats`).

Each function keeps the reference semantics documented in the JAX module
(ddof=1 standard deviations, ranker-style linear quantiles, the NRMSE of
src/AbcUtil.cpp:326-345, the Box-Cox grid search of src/AbcUtil.cpp:89-109).
:class:`RunningStat` is host-only and a copy of the JAX package's.
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


def z_scores(row, means, stdevs):
    """Z-score a single row against given means/sds (src/AbcUtil.cpp:414)."""
    row = _t(row)
    return (row - _t(means).to(row)) / _t(stdevs).to(row)


def colwise_z_scores(x, means=None, stdevs=None):
    """Column-wise z-scores (1- and 3-arg forms, src/AbcUtil.cpp:412-435)."""
    x = _t(x)
    if means is None:
        means = x.mean(dim=0)
    if stdevs is None:
        stdevs = colwise_stdev(x, means)
    return (x - means[None, :]) / stdevs[None, :]


def euclidean(sims, ref):
    """Row-wise euclidean distance to a reference row
    (src/AbcUtil.cpp:320-324)."""
    d = _t(sims) - _t(ref)[None, :]
    return torch.sqrt((d * d).sum(dim=1))


def median(x):
    """Average-of-middle-two median (torch.median returns the lower one)."""
    return torch.quantile(_t(x).reshape(-1), 0.5, interpolation="linear")


def quantile(x, q: float):
    """ranker.h quantile: position (n-1)q, linear interpolation."""
    return torch.quantile(_t(x).reshape(-1), q, interpolation="linear")


def variance(x, mean=None, ddof: int = 1):
    x = _t(x)
    if x.numel() < 2:
        return torch.zeros((), dtype=x.dtype, device=x.device)
    if mean is None:
        mean = x.mean()
    return ((x - mean) ** 2).sum() / (x.numel() - ddof)


def skewness(x, dim: int | None = None):
    """Third central moment / n over variance(ddof=1)^1.5; 0 where the
    variance is 0 (src/AbcUtil.cpp:82-87). ``dim`` reduces one axis of a
    batch (the JAX version takes one vector)."""
    x = _t(x)
    if dim is None:
        x, dim = x.reshape(-1), 0
    n = x.shape[dim]
    m = x.mean(dim=dim, keepdim=True)
    c = x - m
    v = (c * c).sum(dim=dim) / (n - 1)
    third = (c * c * c).sum(dim=dim) / n
    return torch.where(v == 0, torch.zeros_like(v),
                       third / torch.pow(v, 1.5))


def box_cox_lambda_grid(lambda_min=-5.0, lambda_max=5.0, step=0.1):
    """The lambda grid, with grid points EXACT multiples of ``step`` (so
    lambda == 0.0 exactly selects the log branch); a numpy array."""
    import numpy as _np

    n_steps = int(round((lambda_max - lambda_min) / step))
    base = round(lambda_min / step)
    if abs(base * step - lambda_min) < 1e-9:
        return _np.asarray((_np.arange(n_steps + 1) + base) * step)
    return _np.asarray(lambda_min + step * _np.arange(n_steps + 1))


def box_cox(x, lam):
    """(x^lam - 1) / lam, or log(x) where lam == 0; broadcasts."""
    lam = _t(lam).to(x)
    safe = torch.where(lam == 0, torch.ones_like(lam), lam)
    return torch.where(lam == 0, torch.log(x), (torch.pow(x, lam) - 1.0) / safe)


def optimize_box_cox(x, lambda_min=-5.0, lambda_max=5.0, step=0.1):
    """The grid lambda minimizing |skewness| of the transformed vector
    (src/AbcUtil.cpp:89-109): the first minimum, non-finite skews
    disqualified. A 0-d tensor."""
    x = _t(x).reshape(-1)
    lambdas = torch.as_tensor(
        box_cox_lambda_grid(lambda_min, lambda_max, step)
    ).to(x)
    skews = skewness(box_cox(x[None, :], lambdas[:, None]), dim=1)
    askew = torch.where(torch.isfinite(skews), skews.abs(),
                        torch.full_like(skews, float("inf")))
    return lambdas[torch.argmin(askew)]


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


def ordered(values):
    """Ascending sort-order indices, stable (ties keep index order, as the
    JAX version's stable argsort)."""
    return torch.argsort(_t(values), stable=True)


def logit(p):
    """log(p / (1-p)) (AbcUtil.h:45)."""
    p = _t(p)
    return torch.log(p / (1.0 - p))


def logistic(x):
    """1 / (1 + exp(-x)) (AbcUtil.h:46)."""
    return 1.0 / (1.0 + torch.exp(-_t(x)))


def ranks(values):
    """ranks[i] = position of values[i] in the stable ascending order."""
    return torch.argsort(ordered(values), stable=True)


def mle_covariance(params, ddof: int = 1):
    """Variance-covariance matrix of the rows with the n - ddof divisor
    (src/AbcUtil.cpp:462-488; the JAX module documents the divisor)."""
    params = _t(params)
    n = params.shape[0]
    centered = params - params.mean(dim=0)[None, :]
    return (centered.T @ centered) / max(n - ddof, 1)


class RunningStat:
    """Welford online mean/variance (include/AbcSmc/RunningStat.h:16-50),
    kept for API parity; vectorized code should use doubled_variance()."""

    def __init__(self):
        self._n = 0
        self._mean = 0.0
        self._s = 0.0

    def clear(self):
        self.__init__()

    def push(self, x):
        import numpy as _np
        for v in _np.atleast_1d(_np.asarray(x, _np.float64)).ravel():
            self._n += 1
            if self._n == 1:
                self._mean, self._s = float(v), 0.0
            else:
                old = self._mean
                self._mean = old + (v - old) / self._n
                self._s = self._s + (v - old) * (v - self._mean)

    def num_data_values(self) -> int:
        return self._n

    def mean(self) -> float:
        return self._mean if self._n > 0 else 0.0

    def variance(self) -> float:
        return self._s / (self._n - 1) if self._n > 1 else 0.0

    def standard_deviation(self) -> float:
        import math
        return math.sqrt(self.variance())
