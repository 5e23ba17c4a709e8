"""The port's generation step (abcsmc_tpu_torch.parallel.generation) held
against the JAX step (ShardedGeneration.step_precomputed on a 1-device mesh)
on identical inputs and identical draws: the van der Voet seed and the
proposal's uniforms / exponentials / seeds are taken from JAX's own keys
(fold_in(key, 0) then split(..., 3), abcsmc_tpu/parallel/generation.py
:431-432) and injected as StepDraws.

Tolerances (float64): survivor indices and next seeds identical, ncomp_used
equal; distances, weights and doubled variance rtol 1e-8 (Gram, PLS and
logsumexp reductions run in another order); next_params rtol 1e-10 (the
same picks, then elementwise truncated-normal maps). The f32 hostile
moment fixtures of tests/test_sharded.py keep their rtol 1e-3 against the
f64 host rule."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from abcsmc_tpu.config import FilterType as JFilterType, parse_config as j_parse
from abcsmc_tpu.models.parameters import ParameterSet as JParameterSet
from abcsmc_tpu.models.simulators import make_dice_simulator
from abcsmc_tpu.models.transforms import ParameterTransform as JTransform
from abcsmc_tpu.ops import pls as jpls
from abcsmc_tpu.ops import ranking
from abcsmc_tpu.parallel import ShardedGeneration, particle_mesh
from abcsmc_tpu_torch.config import FilterType, parse_config
from abcsmc_tpu_torch.models.parameters import ParameterSet
from abcsmc_tpu_torch.models.transforms import ParameterTransform
from abcsmc_tpu_torch.parallel.generation import Generation, StepDraws

N, KEEP, NPAR, NMET = 400, 40, 3, 5


def _raw(params, nmet):
    return {"smc_iterations": 3, "num_samples": N,
            "predictive_prior_size": KEEP, "parameters": params,
            "metrics": [{"name": f"m{j}", "num_type": "FLOAT", "value": 0.0}
                        for j in range(nmet)]}


PARAMS = [
    {"name": "a", "dist_type": "UNIFORM", "num_type": "FLOAT",
     "par1": 0.0, "par2": 1.0},
    {"name": "b", "dist_type": "UNIFORM", "num_type": "FLOAT",
     "par1": 0.0, "par2": 1.0},
    {"name": "k", "dist_type": "UNIFORM", "num_type": "INT",
     "par1": 1, "par2": 20},
]


def _pair(obs, dtype_np, *, params=PARAMS, filter_type=None, **kw):
    raw = _raw(params, len(obs))
    jcfg, cfg = j_parse(raw), parse_config(raw)
    jkw, tkw = dict(kw), dict(kw)
    if filter_type is not None:
        jkw["filter_type"] = getattr(JFilterType, filter_type)
        tkw["filter_type"] = getattr(FilterType, filter_type)
    jgen = ShardedGeneration(
        JParameterSet.from_specs(jcfg.parameters),
        JTransform(jcfg.parameters), make_dice_simulator(max_dice=4), obs,
        mesh=particle_mesh(jax.devices()[:1]),
        dtype=jnp.float64 if dtype_np == np.float64 else jnp.float32, **jkw,
    )
    gen = Generation(
        ParameterSet.from_specs(cfg.parameters),
        ParameterTransform(cfg.parameters), None, obs, device="cpu",
        dtype=torch.float64 if dtype_np == np.float64 else torch.float32,
        **tkw,
    )
    return jgen, gen


def jax_draws(jgen, key, n_next) -> StepDraws:
    """The draws the JAX step makes from `key`, as tensors."""
    dt = jgen.dtype
    k_pick, k_noise, k_seed = jax.random.split(jax.random.fold_in(key, 0), 3)
    if jgen.resample_method == "systematic":
        pick = jax.random.uniform(
            jax.random.fold_in(jax.random.fold_in(key, 131071), 0), (), dt)
    elif n_next >= jgen.sorted_pick_min:
        pick = jax.random.exponential(k_pick, (n_next + 1,), dt)
    else:
        pick = jax.random.uniform(k_pick, (n_next,), dt)
    noise_u = jax.random.uniform(k_noise, (n_next, jgen.par_set.npar), dt)
    seeds = jax.random.randint(k_seed, (n_next,), 0, np.iinfo(np.int32).max)
    return StepDraws(
        vdv_seed=torch.tensor(int(jpls.vdv_seed(key)), dtype=torch.int64),
        pick=torch.as_tensor(np.array(pick)),
        noise_u=torch.as_tensor(np.array(noise_u)),
        next_seeds=torch.as_tensor(np.array(seeds, np.int64)),
    )


def _data(seed=11):
    rng = np.random.default_rng(seed)
    params = np.stack([rng.uniform(0, 1, N), rng.uniform(0, 1, N),
                       rng.integers(1, 21, N).astype(np.float64)], axis=1)
    mix = rng.normal(size=(NPAR, NMET)) * np.array([[1.0], [1.0], [0.1]])
    mets = params @ mix + 0.4 * rng.normal(size=(N, NMET))
    obs = np.array([0.3, 0.6, 8.0]) @ mix
    prev = (
        np.stack([rng.uniform(0.1, 0.9, KEEP), rng.uniform(0.1, 0.9, KEEP),
                  rng.integers(2, 19, KEEP).astype(np.float64)], axis=1),
        rng.uniform(0.5, 1.5, KEEP),
        np.array([0.05, 0.08, 6.0]),
    )
    prev = (prev[0], prev[1] / np.linalg.norm(prev[1]), prev[2])
    return params, mets, obs, prev


@pytest.mark.parametrize("method,first,sorted_pick,optimal", [
    ("multinomial", False, False, "vdv"),
    ("systematic", False, False, "vdv"),
    ("multinomial", False, True, "vdv"),
    ("systematic", False, True, "vdv"),
    ("multinomial", True, False, "vdv"),
    ("multinomial", False, False, "tolerance"),
])
def test_step_matches_jax_step(method, first, sorted_pick, optimal):
    params, mets, obs, prev = _data()
    jgen, gen = _pair(obs, np.float64, resample_method=method,
                      pls_optimal_method=optimal)
    if sorted_pick:      # force the big-N pick paths at a small size
        jgen.sorted_pick_min = gen.sorted_pick_min = 16
    key = jax.random.PRNGKey(5)
    n_next = 300
    jres = jgen.step_precomputed(
        key, jnp.asarray(params), jnp.asarray(mets), KEEP, n_next,
        None if first else tuple(jnp.asarray(x) for x in prev),
    )
    res = gen.step_precomputed(
        torch.as_tensor(params), torch.as_tensor(mets), KEEP, n_next,
        jax_draws(jgen, key, n_next),
        None if first else tuple(torch.as_tensor(x) for x in prev),
    )
    np.testing.assert_array_equal(res.survivor_idx.numpy(),
                                  np.asarray(jres.survivor_idx))
    assert int(res.ncomp_used) == int(jres.ncomp_used) > 0
    np.testing.assert_allclose(res.distances.numpy(),
                               np.asarray(jres.distances), rtol=1e-8)
    np.testing.assert_allclose(res.weights.numpy(), np.asarray(jres.weights),
                               rtol=1e-8)
    np.testing.assert_allclose(res.doubled_variance.numpy(),
                               np.asarray(jres.doubled_variance), rtol=1e-8)
    np.testing.assert_array_equal(res.survivor_params.numpy(),
                                  np.asarray(jres.survivor_params))
    np.testing.assert_allclose(res.next_params.numpy(),
                               np.asarray(jres.next_params), rtol=1e-10)
    np.testing.assert_array_equal(res.next_seeds.numpy(),
                                  np.asarray(jres.next_seeds, np.int64))


def test_final_set_proposes_nothing():
    params, mets, obs, prev = _data()
    jgen, gen = _pair(obs, np.float64)
    key = jax.random.PRNGKey(1)
    draws = jax_draws(jgen, key, 0)
    res = gen.step_precomputed(torch.as_tensor(params), torch.as_tensor(mets),
                               KEEP, 0, draws,
                               tuple(torch.as_tensor(x) for x in prev))
    jres = jgen.step_precomputed(key, jnp.asarray(params), jnp.asarray(mets),
                                 KEEP, 0, tuple(jnp.asarray(x) for x in prev))
    assert res.next_params.shape == (0, NPAR)
    assert res.next_seeds.shape == (0,)
    np.testing.assert_array_equal(res.survivor_idx.numpy(),
                                  np.asarray(jres.survivor_idx))
    np.testing.assert_allclose(res.weights.numpy(), np.asarray(jres.weights),
                               rtol=1e-8)


def test_padding_rows_are_masked():
    """Rows >= n_valid carry data but never reach moments, Grams or top-K:
    a padded buffer gives the unpadded result, with +inf distances on the
    padding."""
    params, mets, obs, prev = _data()
    _, gen = _pair(obs, np.float64)
    draws = StepDraws(torch.tensor(123), torch.rand(50, dtype=torch.float64),
                      torch.rand(50, NPAR, dtype=torch.float64),
                      torch.arange(50))
    state = tuple(torch.as_tensor(x) for x in prev)
    ref = gen.step_precomputed(torch.as_tensor(params), torch.as_tensor(mets),
                               KEEP, 50, draws, state)
    pp = np.concatenate([params, params[:7] * 3.0])
    pm = np.concatenate([mets, mets[:7] + 100.0])
    got = gen.step_precomputed(torch.as_tensor(pp), torch.as_tensor(pm),
                               KEEP, 50, draws, state, n_valid=N)
    np.testing.assert_array_equal(got.survivor_idx.numpy(),
                                  ref.survivor_idx.numpy())
    np.testing.assert_allclose(got.weights.numpy(), ref.weights.numpy(),
                               rtol=1e-10)
    np.testing.assert_allclose(got.next_params.numpy(),
                               ref.next_params.numpy(), rtol=1e-10)
    assert torch.isinf(got.distances[N:]).all()


DICE = [{"name": n, "dist_type": "UNIFORM", "num_type": "INT",
         "par1": 1, "par2": 50} for n in ("ndice", "sides")]


@pytest.mark.parametrize("fixture", ["large_mean", "far_obs"])
def test_hostile_dual_moment_fixtures_f32(fixture):
    """tests/test_sharded.py's f32 fixtures (|mean| >> sd, and data far
    from obs): the port's dual-frame moments keep f32 distances within 1e-3
    of the f64 two-pass host rule, with the same survivors as JAX's step."""
    rng = np.random.default_rng(11 if fixture == "large_mean" else 5)
    n, keep = 64, 16
    params = rng.uniform(1, 50, (n, 2))
    if fixture == "large_mean":
        first = 1e5 + 30.0 * rng.normal(size=n)
        obs = np.array([1e5, 0.0])
    else:
        first = 0.01 * rng.normal(size=n)
        obs = np.array([1e4, 0.0])
    mets32 = np.stack([first, 100.0 * rng.normal(size=n)],
                      axis=1).astype(np.float32)
    jgen, gen = _pair(obs, np.float32, params=DICE, filter_type="SIMPLE")
    key = jax.random.PRNGKey(0)
    jres = jgen.step_precomputed(key, jnp.asarray(params, jnp.float32),
                                 jnp.asarray(mets32), keep, 0, None)
    draws = StepDraws(torch.tensor(0), torch.zeros(0), torch.zeros(0, 2),
                      torch.zeros(0, dtype=torch.int64))
    res = gen.step_precomputed(torch.as_tensor(params, dtype=torch.float32),
                               torch.as_tensor(mets32), keep, 0, draws)
    order, host_d = ranking.ranking_simple(
        jnp.asarray(mets32, jnp.float64), jnp.asarray(obs, jnp.float64)
    )
    np.testing.assert_allclose(res.distances.numpy(), np.asarray(host_d),
                               rtol=1e-3)
    assert set(res.survivor_idx.tolist()) == set(
        np.asarray(order)[:keep].tolist())
    assert set(res.survivor_idx.tolist()) == set(
        np.asarray(jres.survivor_idx).tolist())
    assert int(res.ncomp_used) == 0
