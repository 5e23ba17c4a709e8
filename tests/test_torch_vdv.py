"""The van der Voet sign-randomization p-values of both packages held
against the exact p-value, which enumerates every one of the 2^n sign
vectors of n held-out rows.

Both packages estimate it from 199 counter-hashed sign rows, so each count
is a draw that the test holds inside the two-sided 1e-6 band of
Binomial(199, p_exact); the hash is fixed, so the test is deterministic.
The two packages share the hash and must give equal counts."""

import itertools

import jax
import numpy as np
import pytest
import torch
from scipy import stats

from abcsmc_tpu.ops import pls as jpls
from abcsmc_tpu_torch.ops import pls

N_PERM = 199


def _sq_err(n, A, p, seed):
    """[n, A, p] squared held-out errors: each component count a response
    whose residual sd falls with the count, so the p-values spread over
    (0, 1]."""
    rng = np.random.default_rng(seed)
    sd = np.linspace(1.6, 0.9, A)[None, :, None]
    shared = rng.normal(size=(n, 1, p))
    resid = 0.7 * shared + 0.7 * rng.normal(size=(n, A, p))
    return (sd * resid) ** 2


def _exact_pvalues(sq_err):
    """P(|mean(s * d)| >= |mean(d)|) over all 2^n sign vectors s, with d the
    per-row error differences from the PRESS-minimal count (float64; the
    same statistic and comparison as the packages)."""
    nv, A, p = sq_err.shape
    best = sq_err.sum(0).argmin(0)
    d = sq_err - np.take_along_axis(sq_err, best[None, None, :], axis=1)
    t_obs = np.abs(d.mean(0))
    signs = np.array(list(itertools.product((-1.0, 1.0), repeat=nv)))
    t_all = np.abs(np.einsum("kn,nap->kap", signs, d) / nv)
    return (t_all >= t_obs[None]).mean(0)


@pytest.mark.parametrize("n,A,p,seed", [
    (8, 4, 2, 0), (10, 5, 1, 1), (11, 3, 3, 2), (12, 4, 2, 3),
])
def test_vdv_pvalues_within_binomial_band_of_exact(n, A, p, seed):
    sq_err = _sq_err(n, A, p, seed)
    exact = _exact_pvalues(sq_err)
    key = jax.random.PRNGKey(seed)
    j_p = np.asarray(jpls._vdv_pvalues(jax.numpy.asarray(sq_err), key,
                                       N_PERM))
    t_p = pls._vdv_pvalues(torch.as_tensor(sq_err),
                           int(jpls.vdv_seed(key)), N_PERM).numpy()
    j_count = np.rint(j_p * N_PERM)
    t_count = np.rint(t_p * N_PERM)
    np.testing.assert_array_equal(t_count, j_count)
    lo = stats.binom.ppf(5e-7, N_PERM, exact)
    hi = stats.binom.ppf(1 - 5e-7, N_PERM, exact)
    assert ((lo <= t_count) & (t_count <= hi)).all(), (exact, t_p)
    # the spread the band tests: p-values in (0, 1), and the count at the
    # PRESS-minimal component exactly 199 (every statistic ties at 0)
    assert ((exact > 0.02) & (exact < 0.98)).any()
    best = sq_err.sum(0).argmin(0)
    assert (t_count[best, np.arange(p)] == N_PERM).all()
