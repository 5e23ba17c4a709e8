"""The host engine's library modules in the port (stats, PLS fit and
component selection, ranking, resampling, rejection and multivariate noise,
the host simulators) held against the JAX package on the same numpy inputs.

Tolerances: float64, rtol 1e-10 where the same formula runs on the same
inputs (only the operation order differs); identical integers (indices,
orders, component counts) on tie-free data; bit equality for the
counter-hashed sign seed and for the host simulators, which run the same
external code. Stochastic wrappers are compared in law by the two-sample
KS distance of ``abcsmc_tpu/compare.py:35``: below 0.05 at 4,000 vs 4,000
draws, above the alpha = 0.001 critical value 1.95 * sqrt(2 / 4000) =
0.044 (the bound of tests/test_torch_models.py)."""

import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from abcsmc_tpu.compare import ks_distance
from abcsmc_tpu.config import parse_config as j_parse
from abcsmc_tpu.models import simulators as jsim
from abcsmc_tpu.models.parameters import ParameterSet as JParameterSet
from abcsmc_tpu.ops import pls as jpls
from abcsmc_tpu.ops import ranking as jrank
from abcsmc_tpu.ops import resample as jres
from abcsmc_tpu.ops import stats as jstats
from abcsmc_tpu_torch.config import parse_config
from abcsmc_tpu_torch.errors import SimulatorError
from abcsmc_tpu_torch.models import simulators as sim
from abcsmc_tpu_torch.models.parameters import ParameterSet
from abcsmc_tpu_torch.ops import pls, ranking, resample, stats

REPO = Path(__file__).resolve().parents[1]
RTOL = 1e-10
F64 = torch.float64


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float64))


def _np(x):
    return np.asarray(x)


def _pls_data(n, m, p, seed, noise=0.3):
    """Metrics X [n, m] linear in parameters Y [n, p] plus noise: rank
    structure, continuous (tie-free) values."""
    rng = np.random.default_rng(seed)
    y = rng.uniform(0, 1, (n, p))
    x = y @ rng.normal(size=(p, m)) + noise * rng.normal(size=(n, m))
    obs = rng.uniform(0.3, 0.7, p) @ rng.normal(size=(p, m))
    return x, y, obs


def _z(a):
    return (a - a.mean(0)) / a.std(0, ddof=1)


# ------------------------------------------------------------------ stats
def test_host_vdv_seed_is_the_jax_key_zero_seed():
    """The host ranking's sign seed is vdv_seed(PRNGKey(0)) of the JAX
    ranking (abcsmc_tpu/ops/ranking.py:105)."""
    assert ranking.HOST_VDV_SEED == int(jpls.vdv_seed(jax.random.PRNGKey(0)))


@pytest.mark.parametrize("fn", ["z_scores", "colwise_z_scores", "euclidean",
                                "variance", "skewness", "mle_covariance",
                                "ordered", "ranks"])
def test_stats_host_functions_match_jax(fn):
    rng = np.random.default_rng(3)
    x = rng.gamma(2.0, 1.5, (57, 4))
    row = rng.normal(size=4)
    cases = {
        "z_scores": lambda m: m.z_scores(row, x.mean(0), x.std(0)),
        "colwise_z_scores": lambda m: m.colwise_z_scores(x),
        "euclidean": lambda m: m.euclidean(x, row),
        "variance": lambda m: m.variance(x[:, 1]),
        "skewness": lambda m: m.skewness(x[:, 2]),
        "mle_covariance": lambda m: m.mle_covariance(x),
        "ordered": lambda m: m.ordered(np.round(x[:, 0], 1)),   # ties
        "ranks": lambda m: m.ranks(np.round(x[:, 3], 1)),
    }
    want = _np(cases[fn](jstats))
    got = cases[fn](stats).numpy()
    if fn in ("ordered", "ranks"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-14)


@pytest.mark.parametrize("shape,scale", [(2.0, 1.0), (0.5, 3.0), (9.0, 0.2)])
def test_box_cox_lambda_matches_jax(shape, scale):
    x = np.random.default_rng(int(shape * 10)).gamma(shape, scale, 300) + 0.01
    np.testing.assert_array_equal(stats.box_cox_lambda_grid(),
                                  jstats.box_cox_lambda_grid())
    assert float(stats.optimize_box_cox(x)) == float(jstats.optimize_box_cox(x))


def test_running_stat_matches_jax():
    vals = np.random.default_rng(1).normal(3.0, 2.0, 40)
    a, b = stats.RunningStat(), jstats.RunningStat()
    a.push(vals)
    b.push(vals)
    assert (a.num_data_values(), a.mean(), a.variance()) == (
        b.num_data_values(), b.mean(), b.variance())


# -------------------------------------------------------------------- pls
@pytest.mark.parametrize("n,m,p", [(120, 6, 3), (80, 9, 1), (200, 13, 6)])
def test_pls_fit_and_selection_match_jax(n, m, p):
    x, y, _ = _pls_data(n, m, p, seed=n + m)
    zx, zy = _z(x), _z(y)
    ntr = n // 2
    jm = jpls.fit(zx[:ntr], zy[:ntr])
    tm = pls.fit(_t(zx[:ntr]), _t(zy[:ntr]))
    assert tm.ncomp == jm.ncomp == min(ntr - 1, m)
    for a, b in ((tm.rotations, jm.rotations), (tm.x_loadings, jm.x_loadings),
                 (tm.y_loadings, jm.y_loadings)):
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(tm.predict(_t(zx), 2).numpy(),
                               _np(jm.predict(zx, 2)), rtol=1e-9, atol=1e-12)
    em_t = tm.cv_new_data(_t(zx[ntr:]), _t(zy[ntr:]))
    em_j = jm.cv_new_data(zx[ntr:], zy[ntr:])
    np.testing.assert_allclose(em_t.numpy(), _np(em_j), rtol=RTOL)
    np.testing.assert_array_equal(pls.optimal_num_components(em_t).numpy(),
                                  _np(jpls.optimal_num_components(em_j)))
    key = jax.random.PRNGKey(n)
    seed = int(jpls.vdv_seed(key))
    sq_t = pls._per_row_sq_errors(tm.rotations, tm.y_loadings, _t(zx[ntr:]),
                                  _t(zy[ntr:]))
    sq_j = jpls._per_row_sq_errors(jm.rotations, jm.y_loadings,
                                   jnp.asarray(zx[ntr:]), jnp.asarray(zy[ntr:]))
    gidx = np.arange(ntr, n)
    pv_t = pls._vdv_pvalues(sq_t, seed, 199, torch.as_tensor(gidx))
    pv_j = jpls._vdv_pvalues(sq_j, key, 199, jnp.asarray(gidx))
    # a p-value is k / 199; JAX's mean over booleans is float32 even under
    # x64, so the counts k are compared, exactly
    assert pv_j.dtype == jnp.float32 and pv_t.dtype == F64
    np.testing.assert_array_equal(np.rint(pv_t.numpy() * 199),
                                  np.rint(_np(pv_j).astype(np.float64) * 199))
    np.testing.assert_allclose(pv_t.numpy(), _np(pv_j), rtol=1e-7)
    np.testing.assert_array_equal(
        pls.optimal_num_components_vdv(tm, _t(zx[ntr:]), _t(zy[ntr:]), seed,
                                       gidx=torch.as_tensor(gidx)).numpy(),
        _np(jpls.optimal_num_components_vdv(jm, zx[ntr:], zy[ntr:], key,
                                            gidx=jnp.asarray(gidx))))
    fg = pls.fit_from_gram(_t(zx.T @ zx), _t(zx.T @ zy), 3)
    jg = jpls.fit_from_gram(zx.T @ zx, zx.T @ zy, 3)
    np.testing.assert_allclose(fg.coefficients().numpy(),
                               _np(jg.coefficients()), rtol=1e-9, atol=1e-12)


# ---------------------------------------------------------------- ranking
def test_ranking_simple_matches_jax():
    x, _, obs = _pls_data(300, 5, 2, seed=8)
    x[:, 3] = 1.25                                  # a constant column
    order_t, d_t = ranking.ranking_simple(_t(x), _t(obs))
    order_j, d_j = jrank.ranking_simple(x, obs)
    np.testing.assert_allclose(d_t.numpy(), _np(d_j), rtol=RTOL)
    np.testing.assert_array_equal(order_t.numpy(), _np(order_j))
    np.testing.assert_array_equal(
        ranking.top_k_from_distances(d_t, 25).numpy(),
        _np(jrank.top_k_from_distances(d_j, 25)))


@pytest.mark.parametrize("method", ["vdv", "tolerance"])
@pytest.mark.parametrize("box_cox", [False, True])
def test_ranking_pls_matches_jax(method, box_cox):
    x, y, obs = _pls_data(400, 8, 3, seed=21)
    if box_cox:
        x = np.exp(0.5 * x)                         # skewed, positive
        obs = np.exp(0.5 * obs)
    order_t, d_t, ncomp_t = ranking.ranking_pls(
        _t(x), _t(y), _t(obs), 0.5, box_cox=box_cox, optimal_method=method)
    order_j, d_j = jrank.ranking_pls(x, y, obs, 0.5, box_cox=box_cox,
                                     optimal_method=method)
    xb, ob = (jrank.apply_box_cox(x, obs) if box_cox else (x, obs))
    _, _, ncomp_j = jrank.pls_scores_for_ranking(xb, y, ob, 0.5,
                                                 optimal_method=method)
    assert ncomp_t == ncomp_j > 1
    np.testing.assert_allclose(d_t.numpy(), _np(d_j), rtol=1e-8)
    np.testing.assert_array_equal(order_t.numpy(), _np(order_j))
    if box_cox:
        xt, ot = ranking.apply_box_cox(_t(x), _t(obs))
        np.testing.assert_allclose(xt.numpy(), _np(xb), rtol=RTOL)
        np.testing.assert_allclose(ot.numpy(), _np(ob), rtol=RTOL)


def test_rank_precision_float32_on_the_cpu(monkeypatch):
    """The precision report on the GPU test's data, with its runs moved to
    the CPU: float64 picks JAX's component count, float32 picks the same,
    and keeps float64's survivors at every cut whose float64 gap is wider
    than twice float32's distance error."""
    from abcsmc_tpu_torch import rank_precision as rp

    monkeypatch.setattr(rp, "RUNS", (("cpu", torch.float64),
                                     ("cpu", torch.float32)))
    x, y, obs, frac, cuts = rp.gpu_test_rows()
    ref, f32 = rp.compare("gpu_test", (x, y, obs, frac, cuts))
    _, _, ncomp_j = jrank.pls_scores_for_ranking(x, y, obs, frac)
    assert ref["ncomp"] == ncomp_j > 1
    assert ref["max_rel_dist_err"] == 0.0
    assert f32["ncomp"] == ref["ncomp"]
    assert 0.0 < f32["max_rel_dist_err"] < 1e-3
    wide = [k for k, c in f32["cuts"].items()
            if c["ref_rel_gap"] > 2 * f32["max_rel_dist_err"]]
    assert wide
    for k in wide:
        assert f32["cuts"][k]["not_shared"] == 0, k


@pytest.mark.parametrize("n", [3, 7])
def test_pls_ranking_training_split_edges(n):
    """n_train = round(n * tf) clipped to [1, n-1]: tiny populations rank
    alike."""
    x, y, obs = _pls_data(n, 3, 2, seed=n)
    for tf in (0.1, 0.99):
        st, ot, kt = ranking.pls_scores_for_ranking(_t(x), _t(y), _t(obs), tf)
        sj, oj, kj = jrank.pls_scores_for_ranking(x, y, obs, tf)
        assert kt == kj
        np.testing.assert_allclose(st.numpy(), _np(sj), rtol=1e-8, atol=1e-12)


# --------------------------------------------------------------- resample
def test_setup_mvn_sampler_matches_jax():
    rng = np.random.default_rng(2)
    pars = rng.multivariate_normal([0, 1, 2], [[1, .5, .2], [.5, 2, .3],
                                               [.2, .3, .5]], 60)
    np.testing.assert_allclose(resample.setup_mvn_sampler(_t(pars)).numpy(),
                               _np(jres.setup_mvn_sampler(pars)), rtol=RTOL)
    pars[:, 1] = 4.0                 # collapsed column: a NaN factor
    want = _np(jres.setup_mvn_sampler(pars))
    assert np.isnan(want).any()
    np.testing.assert_array_equal(
        resample.setup_mvn_sampler(_t(pars)).numpy(), want)


@pytest.mark.parametrize("method", ["multinomial", "systematic"])
def test_resample_indices_match_jax_with_injected_uniforms(method):
    w = np.random.default_rng(4).uniform(0.1, 2.0, 37)
    key = jax.random.PRNGKey(9)
    shape = () if method == "systematic" else (500,)
    u = _np(jax.random.uniform(key, shape, jnp.float64))
    got = resample.resample_indices(_t(w), 500, _t(u), method)
    want = jres.resample_indices(key, w, 500, method)
    np.testing.assert_array_equal(got.numpy(), _np(want))
    direct = (resample.systematic_indices(_t(w), 500, _t(u))
              if method == "systematic"
              else resample.categorical_indices(_t(w), _t(u)))
    np.testing.assert_array_equal(direct.numpy(), _np(want))


# ------------------------------------------------------------------ noise
PARAMS = [
    {"name": "u", "dist_type": "UNIFORM", "num_type": "FLOAT",
     "par1": 0.0, "par2": 1.0},
    {"name": "k", "dist_type": "UNIFORM", "num_type": "INT",
     "par1": 1, "par2": 20},
    {"name": "g", "dist_type": "NORMAL", "num_type": "FLOAT",
     "par1": 1.5, "par2": 0.7},
]


def _sets():
    raw = {"smc_iterations": 2, "num_samples": 10,
           "predictive_prior_fraction": 0.5, "parameters": PARAMS,
           "metrics": [{"name": "m", "num_type": "FLOAT", "value": 1.0}]}
    return (ParameterSet.from_specs(parse_config(raw).parameters),
            JParameterSet.from_specs(j_parse(raw).parameters))


def _mu(n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(0, 1, n), rng.integers(1, 21, n),
                     rng.normal(1.5, 0.7, n)], axis=1).astype(np.float64)


def test_noise_multivariate_first_round_matches_jax():
    ps, jps = _sets()
    mu = _mu(300, 1)
    L = _np(jres.setup_mvn_sampler(mu)) * 0.6
    key = jax.random.PRNGKey(3)
    eps0 = _np(jax.random.normal(jax.random.split(key)[1], mu.shape,
                                 jnp.float64))
    want = _np(jps.noise_multivariate(key, jnp.asarray(mu), jnp.asarray(L), 50))
    got = ps.noise_multivariate(_t(mu), _t(L), _t(eps0), 50,
                                torch.tensor(0))[0].numpy()
    first = _np(jps.recast(jnp.asarray(mu + eps0 @ L.T)))
    ok1 = _np(jps.valid_mask(first)).all(axis=1)
    assert 0 < ok1.sum() < len(mu)             # the retry path is exercised
    np.testing.assert_allclose(got[ok1], want[ok1], rtol=RTOL)
    rest_ok = _np(jps.valid_mask(got[~ok1])).all(axis=1)
    assert (rest_ok | (got[~ok1] == mu[~ok1]).all(axis=1)).all()


def test_noise_independent_rejection_first_round_matches_jax():
    ps, jps = _sets()
    mu = _mu(300, 2)
    dv = np.array([0.09, 16.0, 0.5])
    key = jax.random.PRNGKey(4)
    eps0 = _np(jax.random.normal(jax.random.split(key)[1], mu.shape,
                                 jnp.float64))
    want = _np(jps.noise_independent(key, jnp.asarray(mu), jnp.asarray(dv),
                                     50, "rejection"))
    gen = torch.Generator().manual_seed(1)
    got = ps.noise_independent(_t(mu), _t(dv), _t(eps0), "rejection", 50,
                               gen).numpy()
    first = _np(jps.recast(jnp.asarray(mu + eps0 * np.sqrt(dv))))
    ok1 = _np(jps.valid_mask(first))
    assert 0 < ok1.sum() < ok1.size
    np.testing.assert_allclose(got[ok1], want[ok1], rtol=RTOL)
    assert _np(jps.valid_mask(got)).all()
    with pytest.raises(ValueError, match="generator"):
        ps.noise_independent(_t(mu), _t(dv), _t(eps0), "rejection", 50)


@pytest.mark.parametrize("kind", ["multivariate", "rejection"])
def test_retry_noise_in_law(kind):
    """Near a bound most draws are rejected at least once: the retry rounds'
    law matters and must agree with JAX's."""
    ps, jps = _sets()
    n = 4000
    mu = np.tile([[0.05, 2.0, 1.5]], (n, 1))
    if kind == "multivariate":
        L = np.array([[0.2, 0, 0], [0.5, 3.0, 0], [0.1, 0.2, 0.5]])
        want = _np(jps.noise_multivariate(jax.random.PRNGKey(5),
                                          jnp.asarray(mu), jnp.asarray(L)))
        got = ps.perturb_multivariate(torch.Generator().manual_seed(5),
                                      _t(mu), _t(L)).numpy()
    else:
        dv = np.array([0.04, 9.0, 0.25])
        want = _np(jps.noise_independent(jax.random.PRNGKey(5),
                                         jnp.asarray(mu), jnp.asarray(dv),
                                         1000, "rejection"))
        gen = torch.Generator().manual_seed(5)
        eps = torch.randn(mu.shape, generator=gen, dtype=F64)
        got = ps.noise_independent(_t(mu), _t(dv), eps, "rejection", 1000,
                                   gen).numpy()
    for j in range(3):
        assert ks_distance(got[:, j], want[:, j]) < 0.05, j


def test_sample_predictive_priors_in_law():
    ps, jps = _sets()
    prev = _mu(50, 7)
    w = np.random.default_rng(7).uniform(0.2, 1.0, 50)
    dv = np.array([0.02, 4.0, 0.3])
    n = 4000
    L = _np(jres.setup_mvn_sampler(prev))
    j_ind = _np(jres.sample_predictive_priors(jax.random.PRNGKey(1), n, w,
                                              prev, jps, dv))
    j_mvn = _np(jres.sample_mvn_predictive_priors(jax.random.PRNGKey(1), n, w,
                                                  prev, jps, L))
    gen = torch.Generator().manual_seed(1)
    t_ind = resample.sample_predictive_priors(gen, n, _t(w), _t(prev), ps,
                                              _t(dv)).numpy()
    t_mvn = resample.sample_mvn_predictive_priors(
        gen, n, _t(w), _t(prev), ps, _t(L), method="systematic").numpy()
    for j in range(3):
        assert ks_distance(t_ind[:, j], j_ind[:, j]) < 0.05, j
        assert ks_distance(t_mvn[:, j], j_mvn[:, j]) < 0.05, j


# ------------------------------------------------------------- simulators
def test_dice_simulator_in_law():
    n = 4000
    p = np.tile([[13.0, 8.0]], (n, 1))
    seeds = np.arange(n, dtype=np.uint64) * 31 + 5
    a = jsim.make_dice_simulator().run_batch(p, seeds, np.arange(n))
    b = sim.make_dice_simulator().run_batch(p, seeds, np.arange(n),
                                            device="cpu", dtype=F64)
    assert b[:, 0].min() >= 13 and b[:, 0].max() <= 104
    for j in range(2):
        assert ks_distance(a[:, j], b[:, j]) < 0.05, j
    edge = np.array([[1.0, 6.0], [0.0, 0.0], [5000.0, 2.0]])
    out = sim.make_dice_simulator().run_batch(edge, np.array([1, 2, 3]),
                                              np.arange(3), device="cpu",
                                              dtype=F64)
    assert out[0, 1] == 0.0 and out[1].tolist() == [1.0, 0.0]
    assert 1000 <= out[2, 0] <= 2000            # clipped to 1,000 dice


def test_py_and_exec_simulators_match_jax():
    def f(pars, seed, serial):
        return [pars[0] * 2 + seed, pars[1] - serial]

    p = np.array([[3.0, 8.0], [20.0, 2.0], [1.0, 1.0]])
    seeds, serials = np.array([11, 12, 13]), np.array([0, 1, 2])
    np.testing.assert_array_equal(
        sim.PySimulator(f).run_batch(p, seeds, serials),
        jsim.PySimulator(f).run_batch(p, seeds, serials))
    cmd = f"{sys.executable} {REPO / 'examples' / 'dice_exec.py'}"
    got = sim.ExecSimulator(cmd).run_batch(p, seeds, serials)
    np.testing.assert_array_equal(
        got, jsim.ExecSimulator(cmd).run_batch(p, seeds, serials))
    assert got.shape == (3, 2)
    with pytest.raises(SimulatorError):
        sim.ExecSimulator("/nonexistent-simulator").run_batch(p, seeds,
                                                               serials)


@pytest.fixture(scope="module")
def libdice(tmp_path_factory):
    if shutil.which("gcc") is None:
        pytest.skip("needs gcc to build examples/dice_sim.c")
    out = tmp_path_factory.mktemp("solib") / "libdice.so"
    subprocess.run(["gcc", "-O2", "-shared", "-fPIC", "-o", str(out),
                    str(REPO / "examples" / "dice_sim.c"), "-lm"], check=True)
    return str(out)


REF_ABI_SRC = r"""
#include <vector>
extern "C" std::vector<double> simulator(std::vector<double> pars,
                                         const unsigned long seed,
                                         const unsigned long serial) {
    return { pars[0] * 2.0 + (double)(seed % 7), pars[1] - (double)serial };
}
"""


def test_shared_lib_simulators_match_jax(libdice, tmp_path, monkeypatch):
    p = np.array([[10.0, 6.0], [1.0, 6.0], [100.0, 2.0]])
    seeds, serials = np.array([1, 2, 3]), np.array([0, 1, 2])
    got = sim.SharedLibSimulator(libdice, 2).run_batch(p, seeds, serials)
    np.testing.assert_array_equal(
        got, jsim.SharedLibSimulator(libdice, 2).run_batch(p, seeds, serials))
    assert got[1, 1] == 0.0
    if shutil.which("g++") is None:
        return
    src = tmp_path / "ref.cpp"
    src.write_text(REF_ABI_SRC)
    lib = tmp_path / "libref.so"
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o", str(lib),
                    str(src)], check=True)
    monkeypatch.setenv("ABCSMC_SHIM_CACHE", str(tmp_path / "shim"))
    ref = sim.SharedLibSimulator(str(lib), 2)
    assert ref._shim is not None
    np.testing.assert_array_equal(ref.run_batch(p, seeds, serials),
                                  [[21.0, 6.0], [4.0, 5.0], [203.0, 0.0]])


def test_resolve_simulator_binding_order(libdice):
    base = {"smc_iterations": 2, "num_samples": 10,
            "predictive_prior_fraction": 0.5, "parameters": PARAMS[:2],
            "metrics": [{"name": "a", "num_type": "FLOAT", "value": 1.0},
                        {"name": "b", "num_type": "FLOAT", "value": 1.0}]}
    both = {**base, "shared": libdice, "executable": "x"}
    assert isinstance(sim.resolve_simulator(parse_config(both)),
                      sim.SharedLibSimulator)
    assert isinstance(sim.resolve_simulator(parse_config(
        {**base, "executable": "x"})), sim.ExecSimulator)
    assert isinstance(sim.resolve_simulator(parse_config(
        {**both, "simulator": "dice"})), sim.DeviceSimulator)
    explicit = sim.PySimulator(lambda *a: [0.0, 0.0])
    assert sim.resolve_simulator(parse_config(both), explicit) is explicit
    with pytest.raises(SimulatorError, match="unknown builtin"):
        sim.resolve_simulator(parse_config({**base, "simulator": "nope"}))


def test_device_simulator_run_batch_names_its_device_and_dtype():
    s = sim.make_gaussian_simulator()
    p, seeds = np.array([[1.0, 0.5]] * 3), np.array([4, 5, 6])
    with pytest.raises(TypeError):
        s.run_batch(p, seeds, np.arange(3))         # device/dtype required
    f64 = s.run_batch(p, seeds, np.arange(3), device="cpu", dtype=F64)
    f32 = s.run_batch(p, seeds, np.arange(3), device="cpu",
                      dtype=torch.float32)
    assert f64.dtype == f32.dtype == np.float64
    np.testing.assert_allclose(f32, f64, rtol=1e-5)
    np.testing.assert_array_equal(
        f64, s.batch_fn(_t(p), torch.as_tensor(seeds)).numpy())
