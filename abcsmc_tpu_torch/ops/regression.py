"""Regression helpers from the reference's AbcUtil (component inventory #2):

- :func:`lin_reg`   - simple linear regression with r^2
  (src/AbcUtil.cpp:160-193, struct LinearFit at AbcUtil.h)
- :func:`logistic_reg` - binomial logistic regression beta0 + beta1*t fit by
  maximizing the log-likelihood with a Nelder-Mead simplex, matching the
  reference's GSL nmsimplex2 setup (src/AbcUtil.cpp:195-306: initial betas
  (0,0), step 0.01, size tolerance 1e-4, max 10000 iterations, garbage
  likelihoods clamped to INT_MIN)

These are user-facing utilities for summarizing simulator output (e.g.
deriving logistic-trend metrics), not part of the SMC loop.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class LinearFit:
    m: float
    b: float
    rsq: float


@dataclass
class LogisticFit:
    beta0: float
    beta1: float
    simplex_size: float
    status: int          # 0 = converged (GSL_SUCCESS parity)
    iterations: int


def lin_reg(x, y) -> LinearFit:
    """Least-squares line fit with the reference's closed-form sums
    (src/AbcUtil.cpp:160-193), including the singular-matrix zero fallback."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    assert x.shape == y.shape
    n = x.size
    sumx = x.sum()
    sumx2 = (x**2).sum()
    sumxy = (x * y).sum()
    sumy = y.sum()
    sumy2 = (y**2).sum()
    denom = n * sumx2 - sumx**2
    if denom == 0:
        return LinearFit(0.0, 0.0, 0.0)
    m = (n * sumxy - sumx * sumy) / denom
    b = (sumy * sumx2 - sumx * sumxy) / denom
    rsq = (
        (sumxy - sumx * sumy / n)
        / np.sqrt((sumx2 - sumx**2 / n) * (sumy2 - sumy**2 / n))
    ) ** 2
    return LinearFit(float(m), float(b), float(rsq))


def _lnchoose(n, k):
    # log C(n, k) via lgamma (gsl_sf_lnchoose parity)
    from math import lgamma
    return lgamma(n + 1) - lgamma(k + 1) - lgamma(n - k + 1)


def _neg_loglik(betas, data):
    b0, b1 = betas
    total = 0.0
    for t, s, a in data:
        z = b0 + b1 * t
        p = 1.0 / (1.0 + np.exp(-z))
        if p <= 0.0 or p >= 1.0:
            total = -np.inf
            break
        total += _lnchoose(a, s) + s * np.log(p) + (a - s) * np.log(1.0 - p)
    if not np.isfinite(total):
        total = np.iinfo(np.int32).min  # INT_MIN bandaid (AbcUtil.cpp:223-225)
    return -total


def _nelder_mead_2d(f, x0, step=0.01, size_tol=1e-4, max_iter=10000):
    """Minimal 2-D Nelder-Mead (nmsimplex2-style) for the logistic fit."""
    pts = [np.array(x0, np.float64)]
    for i in range(2):
        p = np.array(x0, np.float64)
        p[i] += step
        pts.append(p)
    vals = [f(p) for p in pts]
    it = 0
    size = np.inf
    for it in range(max_iter):
        order = np.argsort(vals)
        pts = [pts[i] for i in order]
        vals = [vals[i] for i in order]
        centroid = (pts[0] + pts[1]) / 2
        # simplex size ~ average distance to centroid (gsl definition)
        size = float(np.mean([np.linalg.norm(p - centroid) for p in pts]))
        if size < size_tol:
            return pts[0], vals[0], size, it, 0
        # reflect
        xr = centroid + (centroid - pts[2])
        fr = f(xr)
        if fr < vals[0]:
            xe = centroid + 2.0 * (centroid - pts[2])
            fe = f(xe)
            if fe < fr:
                pts[2], vals[2] = xe, fe
            else:
                pts[2], vals[2] = xr, fr
        elif fr < vals[1]:
            pts[2], vals[2] = xr, fr
        else:
            xc = centroid + 0.5 * (pts[2] - centroid)
            fc = f(xc)
            if fc < vals[2]:
                pts[2], vals[2] = xc, fc
            else:  # shrink
                pts[1] = pts[0] + 0.5 * (pts[1] - pts[0])
                pts[2] = pts[0] + 0.5 * (pts[2] - pts[0])
                vals[1], vals[2] = f(pts[1]), f(pts[2])
    return pts[0], vals[0], size, it, 1  # did not converge


def logistic_reg(x, successes, attempts) -> LogisticFit:
    """Binomial logistic regression of successes/attempts on x
    (src/AbcUtil.cpp:230-306)."""
    data = list(zip(np.asarray(x, np.float64),
                    np.asarray(successes, np.int64),
                    np.asarray(attempts, np.int64)))
    best, _, size, iters, status = _nelder_mead_2d(
        lambda b: _neg_loglik(b, data), (0.0, 0.0)
    )
    if status != 0:
        import sys
        sys.stderr.write(
            "WARNING: Logistic regression was unsuccessful (did not "
            "converge)\n"
        )
    return LogisticFit(
        beta0=float(best[0]), beta1=float(best[1]),
        simplex_size=size, status=status, iterations=iters,
    )
