"""The port's models (priors, perturbation, transforms, device simulators)
held against the JAX package.

Tolerances: float64, rtol 1e-10 where the same formula runs on the same
injected uniforms (the only differences are operation order and fused
multiply-adds); bit equality for the shipped mixing matrices; a two-sample
Kolmogorov-Smirnov bound for the simulators, whose per-particle noise comes
from a different generator (threefry vs a counter hash) and so agrees only
in law. The KS bound 0.05 at 4,000 vs 4,000 draws is above the
alpha = 0.001 critical value 1.95 * sqrt(2 / 4000) = 0.044."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from abcsmc_tpu.compare import ks_distance
from abcsmc_tpu.config import parse_config as j_parse
from abcsmc_tpu.models import simulators as jsim
from abcsmc_tpu.models.parameters import ParameterSet as JParameterSet
from abcsmc_tpu.models.transforms import ParameterTransform as JTransform
from abcsmc_tpu_torch.config import parse_config
from abcsmc_tpu_torch.errors import SimulatorError
from abcsmc_tpu_torch.models import simulators as sim
from abcsmc_tpu_torch.models.parameters import ParameterSet
from abcsmc_tpu_torch.models.transforms import ParameterTransform

PARAMS = [
    {"name": "u", "dist_type": "UNIFORM", "num_type": "FLOAT",
     "par1": 0.0, "par2": 2.0},
    {"name": "k", "dist_type": "UNIFORM", "num_type": "INT",
     "par1": 1, "par2": 20},
    {"name": "g", "dist_type": "NORMAL", "num_type": "FLOAT",
     "par1": 1.5, "par2": 0.7},
]
METRICS = [{"name": "m", "num_type": "FLOAT", "value": 1.0}]


def _sets(params=PARAMS):
    raw = {"smc_iterations": 2, "num_samples": 10,
           "predictive_prior_fraction": 0.5, "parameters": params,
           "metrics": METRICS}
    return (ParameterSet.from_specs(parse_config(raw).parameters),
            JParameterSet.from_specs(j_parse(raw).parameters))


def test_prior_log_pdf_and_recast_match_jax():
    ps, jps = _sets()
    rng = np.random.default_rng(0)
    theta = np.stack([
        rng.uniform(-0.5, 2.5, 500),               # in and out of support
        np.round(rng.uniform(-2, 23, 500)) + np.where(
            rng.uniform(size=500) < 0.2, 0.3, 0.0),  # some non-integral
        rng.normal(1.5, 2.0, 500),
    ], axis=1)
    got = ps.prior_log_pdf(torch.as_tensor(theta)).numpy()
    want = np.asarray(jps.prior_log_pdf(jnp.asarray(theta)))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-10)
    half = theta.copy()
    half[:, 1] = np.arange(500) * 0.5               # exact .5: half-to-even
    np.testing.assert_array_equal(
        ps.recast(torch.as_tensor(half)).numpy(),
        np.asarray(jps.recast(jnp.asarray(half))),
    )
    np.testing.assert_array_equal(
        ps.valid_mask(torch.as_tensor(theta)).numpy(),
        np.asarray(jps.valid_mask(jnp.asarray(theta))),
    )
    np.testing.assert_array_equal(ps.means(), jps.means())
    np.testing.assert_array_equal(ps.sds(), jps.sds())


@pytest.mark.parametrize("dead_col", [False, True])
def test_noise_independent_matches_jax_with_injected_uniforms(dead_col):
    """jax.random.truncated_normal draws its uniforms as uniform(key);
    injecting those into the port reproduces the JAX perturbation."""
    ps, jps = _sets()
    rng = np.random.default_rng(1)
    n = 2000
    mu = np.stack([rng.uniform(0, 2, n), np.round(rng.uniform(1, 20, n)),
                   rng.normal(1.5, 0.7, n)], axis=1)
    mu[:5, 0] = [0.0, 2.0, 1e-9, 2.0 - 1e-9, 1.0]   # hugging the bounds
    dv = np.array([0.3, 9.0, 0.5])
    if dead_col:
        dv[1] = 0.0
    key = jax.random.PRNGKey(7)
    want = np.asarray(jps.noise_independent(key, jnp.asarray(mu),
                                            jnp.asarray(dv)))
    u = np.array(jax.random.uniform(key, mu.shape, jnp.float64))
    got = ps.noise_independent(torch.as_tensor(mu), torch.as_tensor(dv),
                               torch.as_tensor(u)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
    assert got[:, 0].min() >= 0.0 and got[:, 0].max() <= 2.0
    assert np.all(got[:, 1] == np.round(got[:, 1]))
    if dead_col:
        np.testing.assert_array_equal(got[:, 1], mu[:, 1])


def test_perturb_independent_draws_from_generator():
    ps, _ = _sets()
    g = torch.Generator().manual_seed(3)
    mu = torch.tensor([[1.0, 10.0, 1.5]], dtype=torch.float64).repeat(4000, 1)
    x = ps.perturb_independent(g, mu, torch.tensor([0.1, 4.0, 0.2],
                                                   dtype=torch.float64))
    assert x.shape == mu.shape
    assert float(x[:, 0].min()) >= 0.0 and float(x[:, 0].max()) <= 2.0
    # 4 standard errors of each column's mean (sd 0.32, 2.0, 0.45)
    err = np.abs(x.mean(0).numpy() - [1.0, 10.0, 1.5])
    assert np.all(err < 4 * np.array([0.32, 2.0, 0.45]) / np.sqrt(4000)), err


def test_sample_priors_in_support():
    ps, _ = _sets()
    g = torch.Generator().manual_seed(0)
    x = ps.sample_priors(g, 5000, torch.float64)
    assert x.shape == (5000, 3)
    assert bool(torch.isfinite(ps.prior_log_pdf(x)).all())
    np.testing.assert_allclose(x.mean(0).numpy(), ps.means(), rtol=0.05)


def test_transform_matches_jax():
    params = [dict(p) for p in PARAMS]
    params[0]["untransform"] = "POW_10"
    params[2]["untransform"] = {"type": "LOGISTIC", "min": 0.1, "max": 0.9,
                                "transformed_addend": ["u"]}
    raw = {"smc_iterations": 2, "num_samples": 10,
           "predictive_prior_fraction": 0.5, "parameters": params,
           "metrics": METRICS}
    tr = ParameterTransform(parse_config(raw).parameters)
    jtr = JTransform(j_parse(raw).parameters)
    assert tr.has_any and jtr.has_any
    theta = np.random.default_rng(2).uniform(0, 2, (100, 3))
    np.testing.assert_allclose(
        tr.to_model_space(torch.as_tensor(theta)).numpy(),
        np.asarray(jtr.to_model_space(jnp.asarray(theta))), rtol=1e-12,
    )


def test_projection_parameters_not_yet_ported():
    """PSEUDO parameters are ported (the test keeps its earlier name): they
    build, enumerate as in JAX, and raise where the reference aborts."""
    from abcsmc_tpu_torch.errors import ConfigError

    params = [{"name": "ps", "dist_type": "PSEUDO", "num_type": "INT",
               "par1": 1, "par2": 3, "step": 1}]
    raw = {"smc_iterations": 1, "num_samples": 3, "parameters": params,
           "metrics": METRICS}
    ps = ParameterSet.from_specs(parse_config(raw).parameters)
    jps = JParameterSet.from_specs(j_parse(raw).parameters)
    assert ps.pseudo_idx == jps.pseudo_idx == [0]
    assert ps.params[0].values == jps.params[0].values == (1.0, 2.0, 3.0)
    np.testing.assert_array_equal(ps.indexed_grid_values(5)[0],
                                  jps.indexed_grid_values(5)[0])
    with pytest.raises(ConfigError, match="likelihood"):
        ps.prior_log_pdf(torch.zeros((2, 1)))


# -------------------------------------------------------------- simulators
def _run(s, params, seeds):
    """A device simulator's run_batch on the CPU in float64."""
    return s.run_batch(params, seeds, np.arange(len(seeds)), device="cpu",
                       dtype=torch.float64)


@pytest.mark.parametrize("shape", [(16, 100), (6, 13), (2, 2)])
def test_shipped_mix_bit_equal_to_jax(shape):
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(7), shape,
                                        dtype=jnp.float32))
    got = sim.shipped_mix(*shape)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_unknown_mix_shape_raises_and_mix_argument_wins():
    with pytest.raises(SimulatorError, match="mix="):
        sim.make_linear_gaussian_simulator(3, 5)
    mix = np.arange(15, dtype=np.float64).reshape(3, 5)
    s = sim.make_linear_gaussian_simulator(3, 5, noise_sd=0.0, mix=mix)
    p = np.array([[1.0, 2.0, 3.0]])
    np.testing.assert_array_equal(_run(s, p, np.array([5])), p @ mix)
    with pytest.raises(SimulatorError):
        sim.make_linear_gaussian_simulator(5, 3, mix=mix)


def test_counter_noise_replays_from_seed():
    """A particle's metrics depend only on its own seed, not its batch."""
    s = sim.make_linear_gaussian_simulator(6, 13)
    rng = np.random.default_rng(4)
    p = rng.uniform(0, 1, (50, 6))
    seeds = rng.integers(0, 2**31 - 1, 50)
    full = _run(s, p, seeds)
    perm = rng.permutation(50)
    np.testing.assert_array_equal(_run(s, p[perm], seeds[perm]), full[perm])
    np.testing.assert_array_equal(_run(s, p[7:8], seeds[7:8]), full[7:8])
    assert not np.array_equal(full[0], _run(s, p[:1], seeds[1:2])[0])


def test_linear_gaussian_simulator_in_law():
    npar, nmet, n = 4, 6, 4000
    mix = np.asarray(jax.random.normal(jax.random.PRNGKey(7), (npar, nmet)))
    jax_sim = jsim.make_linear_gaussian_simulator(npar, nmet)
    port = sim.make_linear_gaussian_simulator(npar, nmet, mix=mix)
    truth = np.array([[0.2, 0.7, 0.4, 0.9]])
    p = np.repeat(truth, n, axis=0)
    seeds = np.arange(n, dtype=np.uint64) * 7919 + 11
    a = jax_sim.run_batch(p, seeds, np.arange(n))
    b = _run(port, p, seeds)
    np.testing.assert_allclose(b.mean(0), (truth @ mix)[0], atol=0.03)
    for j in range(nmet):
        assert ks_distance(a[:, j], b[:, j]) < 0.05, j


def test_gaussian_simulator_in_law():
    n = 4000
    jax_sim = jsim.make_gaussian_simulator()
    port = sim.make_gaussian_simulator()
    p = np.repeat(np.array([[1.3, 0.6]]), n, axis=0)
    seeds = np.arange(n, dtype=np.uint64) + 100
    a = jax_sim.run_batch(p, seeds, np.arange(n))
    b = _run(port, p, seeds)
    for j in range(2):
        assert ks_distance(a[:, j], b[:, j]) < 0.05, j


def test_resolve_simulator_ported_and_not_ported():
    base = {"smc_iterations": 2, "num_samples": 10,
            "predictive_prior_fraction": 0.5, "parameters": PARAMS[:2],
            "metrics": METRICS * 2}
    cfg = parse_config({**base, "simulator": "gaussian"})
    assert isinstance(sim.resolve_simulator(cfg), sim.DeviceSimulator)
    # every builtin of the JAX package resolves; an unknown name raises as
    # it does there
    assert set(sim.BUILTIN_SIMULATORS) == set(jsim.BUILTIN_SIMULATORS)
    sir = sim.resolve_simulator(parse_config({**base, "simulator": "sir"}))
    assert isinstance(sir, sim.DeviceSimulator) and sir.nmet == 6
    with pytest.raises(SimulatorError, match="unknown builtin"):
        sim.resolve_simulator(parse_config({**base, "simulator": "nope"}))
    assert isinstance(sim.resolve_simulator(parse_config(
        {**base, "executable": "x"})), sim.ExecSimulator)
    assert sim.resolve_simulator(parse_config(base)) is None
