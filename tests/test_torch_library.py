"""The port's library-only API, called by no engine path, held against the
JAX package's functions at float64 on the CPU: cross-validation of the PLS
fit (``cv_loo``, ``cv_lso`` fed JAX's own test masks), ``logit`` /
``logistic``, ``Parameter.pdf``, the regression helpers (a verbatim copy:
equal results) and the two packages' export lists.

Tolerance: rtol 1e-8 where the arithmetic is ported (sums in another
order), exact where the code is a copy."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import abcsmc_tpu
import abcsmc_tpu.models
import abcsmc_tpu_torch
import abcsmc_tpu_torch.models
from abcsmc_tpu.config import parse_config as j_parse
from abcsmc_tpu.models.parameters import ParameterSet as JParameterSet
from abcsmc_tpu.ops import pls as jpls
from abcsmc_tpu.ops import regression as jreg
from abcsmc_tpu.ops import stats as jstats
from abcsmc_tpu_torch.config import parse_config
from abcsmc_tpu_torch.models.parameters import ParameterSet
from abcsmc_tpu_torch.ops import pls, regression, stats

RTOL = 1e-8


def _xy(n=60, m=6, p=2, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, m))
    y = x[:, :3] @ rng.normal(size=(3, p)) + 0.3 * rng.normal(size=(n, p))
    return x, y


@pytest.mark.parametrize("p", [1, 2])
def test_cv_loo_matches_jax(p):
    x, y = _xy(p=p)
    if p == 1:
        y = y[:, 0]
    want = np.asarray(jpls.cv_loo(jnp.asarray(x), jnp.asarray(y), 4))
    got = pls.cv_loo(torch.as_tensor(x), torch.as_tensor(y), 4).numpy()
    assert got.shape == (4, p)
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_cv_lso_matches_jax_with_its_masks():
    x, y = _xy(n=80)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jpls.cv_lso(jnp.asarray(x), jnp.asarray(y), 5, key,
                                  num_splits=6, test_fraction=0.3))
    masks = np.stack([np.asarray(jax.random.bernoulli(k, 0.3, (80,)))
                      for k in jax.random.split(key, 6)])
    got = pls.cv_lso(torch.as_tensor(x), torch.as_tensor(y), 5,
                     torch.as_tensor(masks)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL)
    # the wrapper draws its masks from a generator: cv_lso on those masks
    g = torch.Generator().manual_seed(3)
    drawn = torch.rand((6, 80), generator=torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(
        pls.cv_lso_random(g, torch.as_tensor(x), torch.as_tensor(y), 5,
                          num_splits=6).numpy(),
        pls.cv_lso(torch.as_tensor(x), torch.as_tensor(y), 5,
                   drawn < 0.3).numpy())


def test_logit_and_logistic_match_jax():
    p = np.linspace(0.001, 0.999, 101)
    z = np.linspace(-30.0, 30.0, 101)
    np.testing.assert_allclose(stats.logit(torch.as_tensor(p)).numpy(),
                               np.asarray(jstats.logit(jnp.asarray(p))),
                               rtol=RTOL)
    np.testing.assert_allclose(stats.logistic(torch.as_tensor(z)).numpy(),
                               np.asarray(jstats.logistic(jnp.asarray(z))),
                               rtol=RTOL)
    np.testing.assert_allclose(
        stats.logistic(stats.logit(torch.as_tensor(p))).numpy(), p,
        rtol=1e-12)


def test_parameter_pdf_matches_jax():
    raw = {"parameters": [
        {"name": "u", "dist_type": "UNIFORM", "num_type": "FLOAT",
         "par1": -1.0, "par2": 3.0},
        {"name": "k", "dist_type": "UNIFORM", "num_type": "INT",
         "par1": 1, "par2": 9},
        {"name": "g", "dist_type": "NORMAL", "num_type": "FLOAT",
         "par1": 0.5, "par2": 2.0}],
        "metrics": [{"name": "m", "num_type": "FLOAT", "value": 0.0}],
        "smc_iterations": 1, "num_samples": 10, "predictive_prior_size": 5}
    ps = ParameterSet.from_specs(parse_config(raw).parameters)
    jps = JParameterSet.from_specs(j_parse(raw).parameters)
    x = np.array([-2.0, -1.0, 0.0, 0.5, 1.0, 2.5, 3.0, 4.0, 7.0, 9.0, 9.5])
    for par, jpar in zip(ps.params, jps.params):
        got = par.pdf(torch.as_tensor(x)).numpy()
        want = np.asarray(jpar.pdf(jnp.asarray(x)))
        np.testing.assert_allclose(got, want, rtol=RTOL)
        assert (got > 0).any() and (got == 0).any() == (par.name != "g")


def test_recast_valid_mask_equals_valid_mask():
    """The rejection rounds' four-op check of recast proposals marks the
    cells valid_mask marks: bounds, INT columns rounded half to even,
    NaN and +-inf."""
    raw = {"parameters": [
        {"name": "u", "dist_type": "UNIFORM", "num_type": "FLOAT",
         "par1": -1.0, "par2": 3.0},
        {"name": "k", "dist_type": "UNIFORM", "num_type": "INT",
         "par1": 1, "par2": 9},
        {"name": "g", "dist_type": "NORMAL", "num_type": "FLOAT",
         "par1": 0.5, "par2": 2.0}],
        "metrics": [{"name": "m", "num_type": "FLOAT", "value": 0.0}],
        "smc_iterations": 1, "num_samples": 10, "predictive_prior_size": 5}
    ps = ParameterSet.from_specs(parse_config(raw).parameters)
    x = 6.0 * torch.as_tensor(np.random.default_rng(4).normal(size=(5000, 3)))
    x[:10] = torch.tensor([math.nan, math.inf, -math.inf, 0.5, 9.5, -1.0,
                           3.0, 1.0, 9.0, 0.49])[:, None]
    x = ps.recast(x)
    assert torch.equal(ps.recast_valid_mask(x), ps.valid_mask(x))
    assert 0.2 < float(ps.valid_mask(x).double().mean()) < 0.8


def test_regression_helpers_equal_jax():
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 10, 40)
    y = 1.5 * x - 2.0 + rng.normal(size=40)
    for xs, ys in ((x, y), (np.ones(5), y[:5])):   # the second is singular
        assert dataclasses.asdict(regression.lin_reg(xs, ys)) == (
            dataclasses.asdict(jreg.lin_reg(xs, ys)))
    t = np.arange(12.0)
    attempts = np.full(12, 50)
    succ = rng.binomial(50, 1.0 / (1.0 + np.exp(-(0.4 * t - 2.0))))
    got = regression.logistic_reg(t, succ, attempts)
    assert dataclasses.asdict(got) == dataclasses.asdict(
        jreg.logistic_reg(t, succ, attempts))
    assert got.status == 0 and 0.2 < got.beta1 < 0.6


# the names the port exports in place of the JAX package's: Generation is
# ShardedGeneration (without a mesh on one device, or over particle_mesh);
# resolve_device picks the torch device (no JAX counterpart)
RENAMED = {"ShardedGeneration": "Generation"}
NOT_YET = set()
PORT_ONLY = {"resolve_device"}


def test_package_exports_pinned_to_jax():
    want = {RENAMED.get(n, n) for n in abcsmc_tpu.__all__} - NOT_YET
    assert set(abcsmc_tpu_torch.__all__) - PORT_ONLY == want
    assert abcsmc_tpu_torch.models.__all__ == abcsmc_tpu.models.__all__
    for mod in (abcsmc_tpu_torch, abcsmc_tpu_torch.models):
        for name in mod.__all__:
            assert getattr(mod, name) is not None, name
