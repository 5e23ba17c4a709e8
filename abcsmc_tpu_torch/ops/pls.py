"""Partial Least Squares on Gram matrices (port of :mod:`abcsmc_tpu.ops.pls`).

Dayal & MacGregor improved kernel PLS #1: the fit works on X'X (m x m) and
X'Y (m x p) only, so the O(n) work is two matmuls and the per-component
iteration runs on tiny matrices. The component loop keeps the JAX package's
8 normalized squarings and 8 power steps, so the components match it.

The van der Voet sign stream is counter-hashed (murmur3 finalizer) and
bit-equal to the JAX one. CPU torch has no ``>>`` on uint32, so the hash
runs on int64 tensors holding uint32 values, with every product masked back
to 32 bits. Its seed is an input (a uint32 value), where the JAX functions
take a PRNG key and derive it with ``vdv_seed``. Likewise the random
test masks of :func:`cv_lso` are an input; :func:`cv_lso_random` draws them
from a ``torch.Generator``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

_M32 = 0xFFFFFFFF


def _fit_gram(xtx, xty, ncomp: int):
    """Kernel PLS on Grams: returns (R [m, A], P [m, A], Q [p, A]).
    Matmuls run at full FP32/FP64 (TF32 is off package-wide)."""
    m = xtx.shape[0]
    p = xty.shape[1]
    dtype, device = xtx.dtype, xtx.device
    R = torch.zeros((m, ncomp), dtype=dtype, device=device)
    P = torch.zeros((m, ncomp), dtype=dtype, device=device)
    Q = torch.zeros((p, ncomp), dtype=dtype, device=device)
    one = torch.ones((), dtype=dtype, device=device)

    def _nrm(x):
        s = torch.sqrt((x * x).sum())
        return x / torch.where(s > 0, s, one)

    xty_c = xty
    for a in range(ncomp):
        if p == 1:
            w = xty_c[:, 0]
        else:
            # dominant eigenvector of (X'Y)'(X'Y) by normalized squaring
            # (ck ~ c^256) then power steps
            c = xty_c.T @ xty_c
            ck = _nrm(c)
            for _ in range(8):
                ck = _nrm(ck @ ck)
            # sqrt(p) rounded in the working dtype on the host: no scalar
            # copy to the device inside the step
            root_p = float(torch.sqrt(torch.tensor(float(p), dtype=dtype)))
            v0 = torch.full((p,), 1.0, dtype=dtype, device=device) / root_p
            vec = _nrm(ck @ v0)
            for _ in range(8):
                v2 = c @ vec
                norm = torch.sqrt((v2 * v2).sum())
                vec = v2 / torch.where(norm > 0, norm, one)
            w = xty_c @ vec
        wnorm = torch.sqrt((w * w).sum())
        w = w / torch.where(wnorm > 0, wnorm, one)
        # orthogonalize against previous loadings: r = w - R (P' w)
        r = w - R @ (P.T @ w)
        xtx_r = xtx @ r
        tt = r @ xtx_r
        tt_safe = torch.where(tt > 0, tt, one)
        p_a = xtx_r / tt_safe
        q_a = (xty_c.T @ r) / tt_safe
        xty_c = xty_c - tt * torch.outer(p_a, q_a)
        keep = tt > 0
        R[:, a] = torch.where(keep, r, 0.0)
        P[:, a] = torch.where(keep, p_a, 0.0)
        Q[:, a] = torch.where(keep, q_a, 0.0)
    return R, P, Q


def _mul32(x, c: int):
    """(x * c) mod 2^32 for int64 tensors holding uint32 values, without
    overflowing int64: c is split into 16-bit halves."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fmix32(x):
    """murmur3 finalizer on uint32 values held in int64 (bit-equal to
    ``abcsmc_tpu.ops.pls._fmix32``)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def vdv_signs(seed, n_perm: int, gidx, dtype):
    """+-1 sign matrix [n_perm, len(gidx)] for the van der Voet
    randomization test, a pure function of (seed, permutation, GLOBAL row
    index). ``seed`` is a uint32 value (Python int or 0-d integer tensor,
    e.g. ``abcsmc_tpu.ops.pls.vdv_seed(key)`` in tests or a generator draw
    in the engine); ``gidx`` an integer tensor of global row indices."""
    g = torch.as_tensor(gidx).to(torch.int64) & _M32
    k = torch.arange(n_perm, dtype=torch.int64, device=g.device)
    s = torch.as_tensor(seed, dtype=torch.int64).to(g.device) & _M32
    h = _fmix32(g[None, :] ^ _fmix32(k[:, None] ^ s))
    one = torch.ones((), dtype=dtype, device=g.device)
    return torch.where((h & 1) == 1, one, -one)


@dataclass(frozen=True)
class PLSModel:
    """Fitted PLS model: ``rotations`` R (m x A) maps X to scores,
    ``x_loadings`` P (m x A), ``y_loadings`` Q (p x A); the coefficients for
    A components are R[:, :A] @ Q[:, :A].T."""

    rotations: torch.Tensor
    x_loadings: torch.Tensor
    y_loadings: torch.Tensor
    ncomp: int

    def scores(self, x, num_components: int | None = None):
        """T = X @ R[:, :A]."""
        a = self.ncomp if num_components is None else int(num_components)
        return torch.as_tensor(x).to(self.rotations) @ self.rotations[:, :a]

    def coefficients(self, num_components: int | None = None):
        a = self.ncomp if num_components is None else int(num_components)
        return self.rotations[:, :a] @ self.y_loadings[:, :a].T

    def predict(self, x, num_components: int | None = None):
        return (torch.as_tensor(x).to(self.rotations)
                @ self.coefficients(num_components))

    def cv_new_data(self, x_val, y_val):
        """NEW_DATA validation error matrix [A, p]: entry [a, j] is the SSE
        of response j with a+1 components on the held-out rows."""
        return _sse_per_component(self.rotations, self.y_loadings,
                                  torch.as_tensor(x_val).to(self.rotations),
                                  _as_2d(y_val).to(self.rotations))


def _as_2d(y):
    y = torch.as_tensor(y)
    return y[:, None] if y.dim() == 1 else y


def _fit_arrays(x, y, ncomp: int):
    """(R, P, Q) of PLS of ``y`` [n, p] on ``x`` [n, m] with ``ncomp``
    components: the Grams, then :func:`_fit_gram`."""
    return _fit_gram(x.T @ x, x.T @ y, ncomp)


def fit(x, y, ncomp: int | None = None) -> PLSModel:
    """PLS of Y on X (both already z-scored by the caller); ``ncomp``
    defaults to min(n-1, m), NIPALS' maximum meaningful rank."""
    x = torch.as_tensor(x)
    y = _as_2d(y).to(x)
    max_rank = min(x.shape[0] - 1, x.shape[1])
    a = max_rank if ncomp is None else min(int(ncomp), max_rank)
    a = max(a, 1)
    R, P, Q = _fit_arrays(x, y, a)
    return PLSModel(rotations=R, x_loadings=P, y_loadings=Q, ncomp=a)


def fit_from_gram(xtx, xty, ncomp: int) -> PLSModel:
    """Fit directly from the Gram matrices X'X and X'Y."""
    R, P, Q = _fit_gram(torch.as_tensor(xtx), torch.as_tensor(xty),
                        int(ncomp))
    return PLSModel(rotations=R, x_loadings=P, y_loadings=Q, ncomp=int(ncomp))


def _per_row_sq_errors(R, Q, x_val, y_val):
    """[nv, A, p] squared errors of the cumulative-component predictions,
    per held-out row."""
    t_val = x_val @ R
    preds = torch.cumsum(t_val[:, :, None] * Q.T[None, :, :], dim=1)
    resid = y_val[:, None, :] - preds
    return resid * resid


def _sse_per_component(R, Q, x_val, y_val):
    """[A, p] SSE of the cumulative-component predictions on held-out rows."""
    return _per_row_sq_errors(R, Q, x_val, y_val).sum(dim=0)


def cv_loo(x, y, ncomp: int):
    """Leave-one-out validation error matrix [A, p] (upstream PLS 'LOO').

    Each held-out fit is a rank-1 downdate of the full Gram matrices
    (X'X - x_i x_i', X'Y - x_i y_i'), fitted by the Gram PLS: one pass over
    the data, then n fits of m x m matrices."""
    x = torch.as_tensor(x)
    y = _as_2d(y).to(x)
    xtx = x.T @ x
    xty = x.T @ y
    err = torch.zeros((int(ncomp), y.shape[1]), dtype=x.dtype,
                      device=x.device)
    for xi, yi in zip(x, y):
        R, _, Q = _fit_gram(xtx - torch.outer(xi, xi),
                            xty - torch.outer(xi, yi), int(ncomp))
        err += _sse_per_component(R, Q, xi[None, :], yi[None, :])
    return err


def cv_lso(x, y, ncomp: int, test_masks):
    """Leave-some-out validation error matrix [A, p] (upstream PLS 'LSO'):
    one train/test partition per row of ``test_masks`` [num_splits, n]
    (True = held out), each fitted by a masked Gram downdate and scored on
    its held-out rows. JAX draws the masks as ``bernoulli(k, test_fraction,
    (n,))`` for ``k in split(key, num_splits)``."""
    x = torch.as_tensor(x)
    y = _as_2d(y).to(x)
    xtx = x.T @ x
    xty = x.T @ y
    err = torch.zeros((int(ncomp), y.shape[1]), dtype=x.dtype,
                      device=x.device)
    for test in torch.as_tensor(test_masks, device=x.device):
        tmask = test.to(x.dtype)[:, None]
        xt = x * tmask
        yt = y * tmask
        R, _, Q = _fit_gram(xtx - xt.T @ xt, xty - xt.T @ yt, int(ncomp))
        err += _sse_per_component(R, Q, xt, yt)
    return err


def cv_lso_random(generator: torch.Generator, x, y, ncomp: int,
                  num_splits: int = 10, test_fraction: float = 0.3):
    """:func:`cv_lso` with ``num_splits`` Bernoulli(``test_fraction``) test
    masks drawn from ``generator``."""
    n = torch.as_tensor(x).shape[0]
    masks = torch.rand((num_splits, n), generator=generator,
                       device=generator.device) < test_fraction
    return cv_lso(x, y, ncomp, masks)


def _vdv_pvalues(sq_err, seed, n_perm: int, gidx=None):
    """Van der Voet (1994) sign-randomization p-values [A, p]: H0 "A
    components do as well as the PRESS-minimal count", with the signs of the
    per-row error differences randomized by :func:`vdv_signs`. ``seed`` is
    the uint32 sign-stream seed; ``gidx`` the global row indices of the
    validation rows (default 0..nv-1). The observed statistic is the
    all-ones row of the same product as the sign rows, so a sign row of
    all ones (or all minus ones) ties it exactly and counts, as the
    statistic's definition and the JAX package's count have it."""
    nv, _, p = sq_err.shape
    press = sq_err.sum(dim=0)                                # [A, p]
    best = torch.argmin(press, dim=0)                        # [p]
    best_err = torch.gather(sq_err, 1,
                            best[None, None, :].expand(nv, 1, p))
    d = sq_err - best_err                                    # [nv, A, p]
    if gidx is None:
        gidx = torch.arange(nv, device=sq_err.device)
    signs = vdv_signs(seed, n_perm, gidx, sq_err.dtype)      # [K, nv]
    rows = torch.cat([torch.ones_like(signs[:1]), signs])    # [1 + K, nv]
    t = (rows @ d.reshape(nv, -1)).reshape(n_perm + 1, *d.shape[1:]) / nv
    del d
    return (t[1:].abs() >= t[0].abs()[None]).to(sq_err.dtype).mean(dim=0)


def optimal_num_components_vdv(model: PLSModel, x_val, y_val, seed,
                               n_perm: int = 199, alpha: float = 0.25,
                               gidx=None):
    """Per-response optimal component counts (1-based) by van der Voet's
    test: the fewest components whose held-out errors are not significantly
    worse (p > alpha) than the PRESS-minimal count's."""
    R = model.rotations
    sq_err = _per_row_sq_errors(R, model.y_loadings,
                                torch.as_tensor(x_val).to(R),
                                _as_2d(y_val).to(R))
    ok = _vdv_pvalues(sq_err, seed, n_perm, gidx) > alpha
    return torch.argmax(ok.to(torch.int32), dim=0) + 1


def optimal_num_components(error_matrix, rel_tol: float = 0.1):
    """Per-response optimal component counts (1-based) from a validation
    error matrix [A, p]: the fewest components whose PRESS is within
    ``rel_tol`` of the minimum."""
    em = torch.as_tensor(error_matrix)
    ok = em <= (1.0 + rel_tol) * em.min(dim=0).values[None, :]
    return torch.argmax(ok.to(torch.int32), dim=0) + 1
