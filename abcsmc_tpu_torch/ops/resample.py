"""Resampling helpers (port of :mod:`abcsmc_tpu.ops.resample`)."""

from __future__ import annotations

_STRATUM_BLOCK = 4096


def _stratum_points(i, u, scale, dtype):
    """(i + u) * scale without adding the fractional offset to a large index
    in low precision: i = hi*B + lo keeps each product small before the adds
    (at i >= 2^22 a plain f32 i + u quantizes u away)."""
    hi = (i // _STRATUM_BLOCK).to(dtype)
    lo = (i % _STRATUM_BLOCK).to(dtype)
    return hi * (_STRATUM_BLOCK * scale) + (lo + u) * scale
