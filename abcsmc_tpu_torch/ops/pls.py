"""Partial Least Squares on Gram matrices (port of :mod:`abcsmc_tpu.ops.pls`).

Dayal & MacGregor improved kernel PLS #1: the fit works on X'X (m x m) and
X'Y (m x p) only, so the O(n) work is two matmuls and the per-component
iteration runs on tiny matrices. The component loop keeps the JAX package's
8 normalized squarings and 8 power steps, so the components match it.

The van der Voet sign stream is counter-hashed (murmur3 finalizer) and
bit-equal to the JAX one. CPU torch has no ``>>`` on uint32, so the hash
runs on int64 tensors holding uint32 values, with every product masked back
to 32 bits.
"""

from __future__ import annotations

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
            v0 = torch.full((p,), 1.0, dtype=dtype, device=device) / torch.sqrt(
                torch.tensor(float(p), dtype=dtype, device=device)
            )
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
