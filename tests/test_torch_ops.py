"""The port's tensor ops (abcsmc_tpu_torch.ops) held against the JAX package
on identical numpy inputs.

Tolerances: float64 comparisons of the same formula evaluated in a different
order (stats 1e-12; the PLS component loop 1e-9, where 100+ chained tiny
matmuls accumulate rounding; the mixture log-density 1e-10); the f32 kernel
contract of tests/test_pallas_kernels.py (2e-4 nats) for the plain version
of the weight kernel against the Pallas kernel in interpret mode. The
CUDA kernel itself is tested against this plain version in
tests/test_torch_gpu.py."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from abcsmc_tpu.ops import pls as jpls
from abcsmc_tpu.ops import stats as jstats
from abcsmc_tpu.ops.pallas_kernels import mixture_logsumexp as j_mls
from abcsmc_tpu.ops.weights import (
    _log_kernel_mixture_density_xla,
    _prep_scaled as j_prep_scaled,
)
from abcsmc_tpu_torch.ops import kernels, pls, stats, weights

F64 = torch.float64


def t64(x):
    return torch.as_tensor(np.asarray(x, np.float64))


# ------------------------------------------------------------------ stats
@pytest.mark.parametrize("fn", ["colwise_mean", "colwise_stdev",
                                "doubled_variance"])
def test_stats_columnwise_match_jax(fn):
    x = np.random.default_rng(0).normal(3.0, 2.0, (257, 5))
    got = getattr(stats, fn)(t64(x)).numpy()
    want = np.asarray(getattr(jstats, fn)(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_stats_nrmse_median_quantile_match_jax():
    rng = np.random.default_rng(1)
    mets = rng.normal(1.0, 0.5, (300, 4))
    obs = np.array([1.0, 0.0, -2.0, 1.2])
    np.testing.assert_allclose(
        float(stats.nrmse(t64(mets), t64(obs))),
        float(jstats.nrmse(jnp.asarray(mets), jnp.asarray(obs))), rtol=1e-12,
    )
    for n in (300, 301):        # even n: mean of the middle two
        x = rng.normal(size=n)
        np.testing.assert_allclose(float(stats.median(t64(x))),
                                   float(jstats.median(jnp.asarray(x))),
                                   rtol=1e-12)
        for q in (0.0, 0.1, 0.5, 0.975, 1.0):
            np.testing.assert_allclose(
                float(stats.quantile(t64(x), q)),
                float(jstats.quantile(jnp.asarray(x), q)), rtol=1e-12,
            )


# -------------------------------------------------------------------- PLS
@pytest.mark.parametrize("m,p,ncomp", [(7, 3, 5), (12, 1, 4), (13, 6, 13)])
def test_fit_gram_matches_jax(m, p, ncomp):
    rng = np.random.default_rng(m + p)
    x = rng.normal(size=(300, m))
    y = x[:, :p] @ rng.normal(size=(p, p)) + 0.3 * rng.normal(size=(300, p))
    xtx, xty = x.T @ x, x.T @ y
    R, P, Q = pls._fit_gram(t64(xtx), t64(xty), ncomp)
    jR, jP, jQ = jpls._fit_gram(jnp.asarray(xtx), jnp.asarray(xty), ncomp)
    for got, want in ((R, jR), (P, jP), (Q, jQ)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("key_seed", [0, 1, 12345])
def test_vdv_signs_bit_equal(key_seed):
    key = jax.random.PRNGKey(key_seed)
    seed = int(jpls.vdv_seed(key))
    gidx = np.concatenate([np.arange(0, 300),
                           np.arange(2**31 - 50, 2**31 + 50)])
    want = np.asarray(jpls.vdv_signs(seed, 199, jnp.asarray(gidx),
                                     jnp.float64))
    got = pls.vdv_signs(seed, 199, torch.as_tensor(gidx), F64).numpy()
    np.testing.assert_array_equal(got, want)
    # a 0-d tensor seed (as the engine draws it) gives the same stream
    got_t = pls.vdv_signs(torch.tensor(seed), 199, torch.as_tensor(gidx), F64)
    np.testing.assert_array_equal(got_t.numpy(), want)


def test_fmix32_bit_equal():
    x = np.random.default_rng(3).integers(0, 2**32, 10_000, dtype=np.uint64)
    want = np.asarray(jpls._fmix32(jnp.asarray(x.astype(np.uint32))))
    got = pls._fmix32(torch.as_tensor(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), want)


# ---------------------------------------------------------------- weights
def _weight_inputs(n, m, p, seed, dead_col=False):
    rng = np.random.default_rng(seed)
    params = rng.uniform(0, 1, (n, p))
    prev = rng.uniform(0.2, 0.8, (m, p))
    w = rng.uniform(0.5, 1.5, m)
    w /= w.sum()
    dv = rng.uniform(0.01, 0.1, p)
    if dead_col:
        dv[0] = 0.0
        params[:, 0] = prev[0, 0]
        prev[:, 0] = prev[0, 0]
    return params, prev, w, dv


@pytest.mark.parametrize("dead_col", [False, True])
def test_prep_scaled_matches_jax(dead_col):
    params, prev, _, dv = _weight_inputs(50, 40, 4, 5, dead_col)
    a, b, ln = weights._prep_scaled(t64(params), t64(prev), t64(dv))
    ja, jb, jln = j_prep_scaled(jnp.asarray(params), jnp.asarray(prev),
                                jnp.asarray(dv))
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=1e-12)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=1e-12)
    np.testing.assert_allclose(float(ln), float(jln), rtol=1e-12)


@pytest.mark.parametrize("n,m,p,dead_col", [
    (100, 70, 3, False), (600, 2500, 6, False), (33, 9, 1, False),
    (80, 90, 4, True),
])
def test_log_kernel_mixture_density_matches_jax_xla(n, m, p, dead_col):
    params, prev, w, dv = _weight_inputs(n, m, p, n + m, dead_col)
    got = weights.log_kernel_mixture_density(
        t64(params), t64(prev), t64(np.log(w)), t64(dv)
    ).numpy()
    want = np.asarray(_log_kernel_mixture_density_xla(
        jnp.asarray(params), jnp.asarray(prev), jnp.log(jnp.asarray(w)),
        jnp.asarray(dv), block=256,
    ))
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_weight_predictive_prior_l2_normalized():
    from abcsmc_tpu.ops.weights import weight_predictive_prior as j_wpp

    params, prev, w, dv = _weight_inputs(60, 50, 3, 9)

    def j_prior(theta):
        return jnp.zeros(theta.shape[0], theta.dtype)

    got = weights.weight_predictive_prior(
        t64(params), t64(prev), t64(w), t64(dv),
        lambda th: torch.zeros(th.shape[0], dtype=th.dtype),
    )
    want = np.asarray(j_wpp(jnp.asarray(params), jnp.asarray(prev),
                            jnp.asarray(w), jnp.asarray(dv), j_prior))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10)
    assert float(torch.linalg.norm(got)) == pytest.approx(1.0, abs=1e-12)


# ------------------------------------- the kernel's plain version vs Pallas
def _scaled32(params, prev, dv):
    a, b, log_norm = j_prep_scaled(
        jnp.asarray(params, jnp.float32), jnp.asarray(prev, jnp.float32),
        jnp.asarray(dv, jnp.float32),
    )
    return a, b, float(log_norm)


def _plain(a, b, lw, **kw):
    return kernels.mixture_logsumexp(
        torch.as_tensor(np.array(a)), torch.as_tensor(np.array(b)),
        torch.as_tensor(np.asarray(lw, np.float32)), **kw,
    ).numpy()


@pytest.mark.parametrize("n,m,p", [(100, 70, 3), (600, 1100, 6), (33, 9, 1)])
def test_plain_kernel_matches_pallas(n, m, p):
    params, prev, w, dv = _weight_inputs(n, m, p, 0)
    a, b, _ = _scaled32(params, prev, dv)
    lw = np.log(w).astype(np.float32)
    want = np.asarray(j_mls(a, b, jnp.asarray(lw), block_i=128, block_j=256,
                            interpret=True))
    np.testing.assert_allclose(_plain(a, b, lw), want, rtol=2e-4, atol=2e-4)


def _f64_oracle(params, prev, w, dv):
    a = (params - prev.mean(0)) / np.sqrt(dv)
    b = (prev - prev.mean(0)) / np.sqrt(dv)
    D = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    L = np.log(w)[None, :] - 0.5 * D
    mx = L.max(1, keepdims=True)
    return mx[:, 0] + np.log(np.exp(L - mx).sum(1))


@pytest.mark.parametrize("p", [3, 6, 19, 25])
def test_plain_kernel_f32_accuracy_vs_pallas_high(p):
    """The Pallas 'high' scheme (packed split-bf16 for p <= 19, 3-pass
    beyond) and the port's FP32 plain version both sit within the f32
    contract of an f64 oracle."""
    rng = np.random.default_rng(7 + p)
    n, m = 130, 140
    params = rng.uniform(0, 1, (n, p))
    prev = rng.uniform(0.2, 0.8, (m, p))
    w = rng.dirichlet(np.ones(m))
    dv = rng.uniform(0.01, 0.1, p)
    a, b, _ = _scaled32(params, prev, dv)
    lw = np.log(w).astype(np.float32)
    oracle = _f64_oracle(params, prev, w, dv)
    want = np.asarray(j_mls(a, b, jnp.asarray(lw), block_i=128, block_j=128,
                            interpret=True, precision="high"))
    got = _plain(a, b, lw)
    np.testing.assert_allclose(got, oracle, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_plain_kernel_modes_agree():
    rng = np.random.default_rng(2)
    n, m, p = 200, 300, 6
    a = rng.normal(size=(n, p)).astype(np.float32)
    b = rng.normal(size=(m, p)).astype(np.float32)
    lw = np.log(rng.uniform(0.5, 1.5, m) / m).astype(np.float32)
    outs = {mode: _plain(a, b, lw, mode=mode)
            for mode in ("auto", "static", "online")}
    np.testing.assert_array_equal(outs["auto"], outs["static"])
    np.testing.assert_allclose(outs["static"], outs["online"],
                               rtol=1e-5, atol=1e-5)
    want = np.asarray(j_mls(jnp.asarray(a), jnp.asarray(b), jnp.asarray(lw),
                            block_i=128, block_j=128, interpret=True,
                            mode="online"))
    np.testing.assert_allclose(outs["online"], want, rtol=2e-4, atol=2e-4)


def test_plain_kernel_underflow_fallback():
    b = np.zeros((16, 2), np.float32)
    lw = np.full(16, np.log(1.0 / 16), np.float32)
    a = np.concatenate([np.zeros((3, 2), np.float32),
                        np.full((1, 2), 1e4, np.float32)])
    static = _plain(a, b, lw, mode="static")
    assert np.isneginf(static[3])
    out = _plain(a, b, lw, mode="auto")
    assert np.all(np.isfinite(out))
    np.testing.assert_allclose(out[3], -0.5 * 2 * 1e8 + np.log(1.0 / 16),
                               rtol=1e-6)
    np.testing.assert_array_equal(out, _plain(a, b, lw, mode="online"))
    want = np.asarray(j_mls(jnp.asarray(a), jnp.asarray(b), jnp.asarray(lw),
                            block_i=128, block_j=128, interpret=True))
    np.testing.assert_allclose(out, want, rtol=1e-6)


def test_plain_kernel_extreme_weights():
    rng = np.random.default_rng(1)
    n, m, p = 64, 40, 2
    a = rng.normal(size=(n, p)).astype(np.float32)
    b = rng.normal(size=(m, p)).astype(np.float32)
    lw = np.full(m, np.log(1.0 / 20), np.float32)
    lw[20:] = -1e30
    got = _plain(a, b, lw)
    np.testing.assert_allclose(got, _plain(a, b[:20], lw[:20]),
                               rtol=1e-5, atol=1e-5)
    want = np.asarray(j_mls(jnp.asarray(a), jnp.asarray(b), jnp.asarray(lw),
                            block_i=128, block_j=128, interpret=True))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_plain_kernel_true_neg_inf_weights():
    rng = np.random.default_rng(2)
    n, m, p = 32, 24, 3
    a = rng.normal(size=(n, p)).astype(np.float32)
    b = rng.normal(size=(m, p)).astype(np.float32)
    lw = np.full(m, np.log(1.0 / 12), np.float32)
    lw[12:] = -np.inf
    for mode in ("auto", "static", "online"):
        got = _plain(a, b, lw, mode=mode)
        assert np.all(np.isfinite(got)), mode
        np.testing.assert_allclose(got, _plain(a, b[:12], lw[:12], mode=mode),
                                   rtol=1e-5, atol=1e-5)
    want = np.asarray(j_mls(jnp.asarray(a), jnp.asarray(b), jnp.asarray(lw),
                            block_i=128, block_j=128, interpret=True))
    np.testing.assert_allclose(_plain(a, b, lw), want, rtol=2e-4, atol=2e-4)


# ----------------------------------------------- the wrapper's input checks
def test_cpu_tensor_runs_plain_version_without_launch():
    a = torch.zeros((4, 3))
    before = kernels.mixture_logsumexp.launches
    out = kernels.mixture_logsumexp(a, a, torch.zeros(4))
    assert kernels.mixture_logsumexp.launches == before
    np.testing.assert_allclose(out.numpy(), np.log(4.0), rtol=1e-6)


@pytest.mark.parametrize("case,err", [
    ("dtype", TypeError), ("contig", ValueError), ("p", ValueError),
    ("shape", ValueError),
])
def test_cuda_input_checks_reject(case, err):
    a = torch.zeros((8, 4))
    b = torch.zeros((6, 4))
    lw = torch.zeros(6)
    if case == "dtype":
        a = a.double()
    elif case == "contig":
        b = torch.zeros((4, 6)).T
    elif case == "p":
        a, b = torch.zeros((8, 65)), torch.zeros((6, 65))
    else:
        lw = torch.zeros(5)
    with pytest.raises(err):
        kernels._check_cuda_inputs(a, b, lw)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_stratum_points_match_jax(dtype):
    """Systematic-resampling strata (i + u) * scale, split-index form, up to
    indices beyond 2^23 where a plain f32 i + u loses u. Same formula in
    both packages; rtol is 2 ulp of the dtype (fused multiply-adds may
    round once less)."""
    from abcsmc_tpu.ops.resample import _stratum_points as j_strata

    from abcsmc_tpu_torch.ops.resample import _stratum_points

    i = np.concatenate([np.arange(0, 5000), np.arange(2**23 - 3, 2**23 + 3),
                        np.arange(2**24, 2**24 + 100)])
    u, scale = 0.37, 1.0 / (2**24 + 100)
    jd = jnp.float32 if dtype == np.float32 else jnp.float64
    td = torch.float32 if dtype == np.float32 else torch.float64
    want = np.asarray(j_strata(jnp.asarray(i), jnp.asarray(u, jd),
                               jnp.asarray(scale, jd), jd))
    got = _stratum_points(torch.as_tensor(i), torch.tensor(u, dtype=td),
                          torch.tensor(scale, dtype=td), td).numpy()
    np.testing.assert_allclose(got, want, rtol=2 * np.finfo(dtype).eps)
    assert np.all(np.diff(got.astype(np.float64)) > 0)
