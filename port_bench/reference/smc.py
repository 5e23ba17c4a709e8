"""Plain reference of an ABC-SMC-PLS fit with the linear-Gaussian simulator.

Float64 PyTorch (or NumPy for the counter hash), on whatever device the
caller names, in blocks of rows where a stage is quadratic. It imports
nothing of the program under test: every formula below is written out from
the method's description.

- Simulator: ``metrics = params @ mix + noise_sd * z``, where ``z[i, j]`` is
  a standard normal that depends on the particle's seed and the column only:
  two murmur3-finalised 32-bit words of ``(fmix32(seed ^ 0x9E3779B9) ^ (2j +
  0|1))`` feed a Box-Muller transform. ``mix`` is the frozen matrix in
  ``linear_gaussian_mix.npz`` beside this file.
- Ranking: metrics and parameters z-scored over the set (sd with n - 1),
  partial least squares of the parameters on the metrics fitted on the first
  ``round(n * training_fraction)`` rows (kernel PLS on the Gram matrices;
  each weight vector is the dominant eigenvector of ``(X'Y)'(X'Y)``, found
  by 8 normalised squarings and 8 power steps from the all-ones start), and
  each row's distance the Euclidean norm of its score row minus the observed
  row's scores over the first ``ncomp`` components. Survivors: the ``keep``
  least distances.
- Component count (van der Voet): PRESS of each count on the held-out rows,
  and each count's sign-flip statistic against the least-PRESS count, taken
  in its normal limit (:func:`vdv_statistics`); the rule keeps, per
  parameter, the fewest counts whose p-value is above the level, and the
  most over parameters.
- Weights: prior density over the previous survivors' Gaussian kernel
  mixture, ``w_i ~ prior(x_i) / sum_j w'_j prod_p N(x_ip; x'_jp, dv_p)``,
  normalised to sum 1; ``dv`` twice the survivors' variance (n - 1).
- Proposal: resample the survivors by weight and perturb each column by a
  normal of variance ``dv`` truncated to the prior's support. It is random,
  so it is judged in law: the Kolmogorov-Smirnov distance of each column of
  the proposed rows from that mixture's exact CDF.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

_MIX = Path(__file__).with_name("linear_gaussian_mix.npz")
_M32 = np.uint64(0xFFFFFFFF)
_SEED_SALT = 0x9E3779B9
#: rows x centers of one block of the quadratic stages (doubles)
_BLOCK = 1 << 25


def mix_matrix(npar: int, nmet: int) -> np.ndarray:
    with np.load(_MIX) as data:
        return np.asarray(data[f"mix_{npar}x{nmet}"], np.float64)


# ------------------------------------------------------------- simulator
def _fmix32(x: np.ndarray) -> np.ndarray:
    """murmur3's 32-bit finaliser on uint64 arrays holding 32-bit values
    (products wrap mod 2^64, so their low 32 bits are exact)."""
    x = x ^ (x >> np.uint64(16))
    x = (x * np.uint64(0x7FEB352D)) & _M32
    x = x ^ (x >> np.uint64(15))
    x = (x * np.uint64(0x846CA68B)) & _M32
    return x ^ (x >> np.uint64(16))


def counter_normals(seeds, ncols: int) -> np.ndarray:
    """Standard normals [n, ncols] in float64, a function of (seed, column)."""
    s = np.asarray(seeds).astype(np.uint64) & _M32
    base = _fmix32(s ^ np.uint64(_SEED_SALT))[:, None]
    col = np.arange(ncols, dtype=np.uint64)[None, :]
    h1 = _fmix32(base ^ (np.uint64(2) * col))
    h2 = _fmix32(base ^ (np.uint64(2) * col + np.uint64(1)))
    u1 = (h1.astype(np.float64) + 1.0) / 2.0**32
    u2 = h2.astype(np.float64) / 2.0**32
    return np.sqrt(-2.0 * np.log(u1)) * np.cos(2.0 * math.pi * u2)


def simulate(params, seeds, mix, noise_sd: float, device="cpu"):
    """Metrics [n, M] float64 of ``params`` [n, P] and their seeds."""
    p = torch.as_tensor(np.asarray(params, np.float64), device=device)
    a = torch.as_tensor(np.asarray(mix, np.float64), device=device)
    z = torch.as_tensor(counter_normals(seeds, a.shape[1]), device=device)
    return p @ a + noise_sd * z


# --------------------------------------------------------------- ranking
def _zscore(x):
    mean = x.mean(0)
    sd = x.std(0, unbiased=True)
    sd = torch.where(sd > 1e-30, sd, torch.ones_like(sd))
    return (x - mean) / sd, mean, sd


def _unit(v):
    s = torch.sqrt((v * v).sum())
    return v / s if s > 0 else v


def pls_fit(xtx, xty, ncomp: int):
    """Kernel PLS on the Grams X'X [m, m] and X'Y [m, p]: the rotations R
    [m, ncomp] that map z-scored metrics to scores, and the y-loadings Q
    [p, ncomp] (``q_a = Y't_a / t_a't_a``)."""
    m, p = xty.shape
    R = torch.zeros((m, ncomp), dtype=xtx.dtype, device=xtx.device)
    P = torch.zeros_like(R)
    Q = torch.zeros((p, ncomp), dtype=xtx.dtype, device=xtx.device)
    xty_c = xty.clone()
    for a in range(ncomp):
        if p == 1:
            w = xty_c[:, 0]
        else:
            c = xty_c.T @ xty_c
            ck = _unit(c)
            for _ in range(8):
                ck = _unit(ck @ ck)
            vec = _unit(ck @ torch.full((p,), 1.0 / math.sqrt(p),
                                        dtype=c.dtype, device=c.device))
            for _ in range(8):
                vec = _unit(c @ vec)
            w = xty_c @ vec
        w = _unit(w)
        r = w - R @ (P.T @ w)
        xtx_r = xtx @ r
        tt = r @ xtx_r
        if not tt > 0:
            break
        p_a = xtx_r / tt
        q_a = (xty_c.T @ r) / tt
        xty_c = xty_c - tt * torch.outer(p_a, q_a)
        R[:, a] = r
        P[:, a] = p_a
        Q[:, a] = q_a
    return R, Q


def pls_rotations(xtx, xty, ncomp: int):
    """The rotations R of :func:`pls_fit`."""
    return pls_fit(xtx, xty, ncomp)[0]


def training_rows(n: int, fraction: float) -> int:
    return min(max(int(n * fraction + 0.5), 1), n - 1)


def distances(params, metrics, obs, fraction: float, ncomp: int):
    """Each row's PLS score distance from the observed row [n]."""
    n = params.shape[0]
    n_train = training_rows(n, fraction)
    zm, mean, sd = _zscore(metrics)
    obs_z = (torch.as_tensor(obs, dtype=metrics.dtype,
                             device=metrics.device) - mean) / sd
    zp, _, _ = _zscore(params)
    xt = zm[:n_train]
    R = pls_rotations(xt.T @ xt, xt.T @ zp[:n_train], max(int(ncomp), 1))
    diff = zm @ R - (obs_z @ R)[None, :]
    return torch.sqrt((diff * diff).sum(1))


def vdv_statistics(params, metrics, fraction: float, window_rows: int):
    """The van der Voet statistic z [A, p] of every component count a
    (rows: a = 1 .. A) against each parameter's least-PRESS count.

    PLS is fitted on the training rows with the most components allowed
    (``A = min(training rows - 1, metrics)``); each held-out row's residual
    of each z-scored parameter under the first a components gives PRESS
    [A, p]. The test compares count a with the least-PRESS count b by the
    rows ``d_n = e_n(a)^2 - e_n(b)^2`` of the window (the last
    ``window_rows`` rows of the set, held-out ones only): under random
    signs ``sum w_n d_n`` has mean 0 and variance ``sum d_n^2``, so ``z =
    sum d_n / sqrt(sum d_n^2)`` and the two-sided p-value is ``2 (1 -
    Phi(|z|))`` (the normal limit of the sign-flip test, with no draws)."""
    n, m = metrics.shape
    n_train = training_rows(n, fraction)
    max_comp = max(min(n_train - 1, m), 1)
    zm, _, _ = _zscore(metrics)
    zp, _, _ = _zscore(params)
    xt = zm[:n_train]
    R, Q = pls_fit(xt.T @ xt, xt.T @ zp[:n_train], max_comp)
    T = zm[n_train:] @ R                                    # [nt, A]
    resid = zp[n_train:, None, :] - torch.cumsum(
        T[:, :, None] * Q.T[None, :, :], dim=1)             # [nt, A, p]
    e2 = resid * resid
    del resid
    best = torch.argmin(e2.sum(0), dim=0)                   # [p]
    start = max(n - int(window_rows), n_train) - n_train
    e2 = e2[start:]
    d = e2 - torch.gather(e2, 1, best[None, None, :].expand(
        e2.shape[0], 1, e2.shape[2]))
    s1, s2 = d.sum(0), (d * d).sum(0)
    return torch.where(s2 > 0, s1 / torch.sqrt(torch.where(
        s2 > 0, s2, torch.ones_like(s2))), torch.zeros_like(s1))


def _z_crit(alpha: float) -> float:
    """|z| below which the two-sided p-value is above ``alpha``."""
    return float(torch.special.ndtri(torch.tensor(1.0 - alpha / 2.0,
                                                  dtype=torch.float64)))


def vdv_components(z, alpha: float) -> int:
    """The count the van der Voet rule chooses: per parameter the fewest
    components whose p-value is above ``alpha``, the most over
    parameters."""
    ok = z.abs() < _z_crit(alpha)
    return int((torch.argmax(ok.to(torch.int32), dim=0) + 1).max())


def vdv_miss(z, ncomp: int, alpha: float) -> float:
    """How far, in units of z, the count ``ncomp`` lies from every count
    the rule could choose: 0 where it is one, else the larger of

    - too few: some parameter has no count up to ``ncomp`` with |z| under
      the critical value, by the least excess among them;
    - too many: every parameter has a count below ``ncomp`` with |z|
      under the critical value, by the least of their margins."""
    a_max = z.shape[0]
    if not 1 <= ncomp <= a_max:
        return math.inf
    zc = _z_crit(alpha)
    absz = z.abs()
    few = float((absz[:ncomp] - zc).min(0).values.max())
    many = (float((zc - absz[:ncomp - 1]).max(0).values.min())
            if ncomp > 1 else -math.inf)
    return max(0.0, few, many)


# --------------------------------------------------------------- weights
def doubled_variance(surv):
    return 2.0 * surv.var(0, unbiased=True)


def log_prior(x, lo, hi):
    inside = ((x >= lo) & (x <= hi)).all(1)
    val = -torch.log(hi - lo).sum()
    return torch.where(inside, val, torch.full_like(val, -math.inf))


def weights(surv, prev_surv, prev_w, prev_dv, lo, hi):
    """Normalised importance weights [K] of ``surv`` against the previous
    survivors' kernel mixture."""
    live = prev_dv > 0
    inv_sd = torch.where(live, 1.0 / torch.sqrt(torch.where(
        live, prev_dv, torch.ones_like(prev_dv))), torch.zeros_like(prev_dv))
    center = prev_surv.mean(0)
    a = (surv - center) * inv_sd
    b = (prev_surv - center) * inv_sd
    bb = (b * b).sum(1)
    lw = torch.log(prev_w)
    rows = max(1, _BLOCK // max(b.shape[0], 1))
    log_den = []
    for s in range(0, a.shape[0], rows):
        ab = a[s:s + rows]
        q = (ab * ab).sum(1)[:, None] + bb[None, :] - 2.0 * ab @ b.T
        log_den.append(torch.logsumexp(lw[None, :] - 0.5 * q, dim=1))
    log_w = log_prior(surv, lo, hi) - torch.cat(log_den)
    w = torch.exp(log_w - log_w.max())
    return w / w.sum()


# -------------------------------------------------------------- proposal
def mixture_cdf(x, centers, w, sd, lo: float, hi: float):
    """CDF at ``x`` [n] of the mixture of normals N(centers_k, sd) [K]
    truncated to [lo, hi], weights ``w`` [K] summing to 1."""
    ndtr = torch.special.ndtr
    alpha = ndtr((lo - centers) / sd)
    mass = ndtr((hi - centers) / sd) - alpha
    rows = max(1, _BLOCK // max(centers.shape[0], 1))
    out = []
    for s in range(0, x.shape[0], rows):
        z = (x[s:s + rows, None] - centers[None, :]) / sd
        out.append(((ndtr(z) - alpha[None, :]) / mass[None, :]
                    * w[None, :]).sum(1))
    return torch.clamp(torch.cat(out), 0.0, 1.0)


def ks_distance(sample, cdf_fn):
    """Kolmogorov-Smirnov distance of a 1-D sample from a CDF."""
    x, _ = torch.sort(sample)
    n = x.shape[0]
    f = cdf_fn(x)
    i = torch.arange(1, n + 1, dtype=f.dtype, device=f.device)
    return float(torch.maximum(i / n - f, f - (i - 1) / n).max())
