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
f64 host rule.

MULTIVARIATE noise: the first round's normals are JAX's
(``normal(split(k_noise)[1])``); with ``max_retries=1`` both steps stop after
that round and every row agrees to rtol 1e-8 (a rejected row falls back to
its resampled survivor in both); with retries on, the rows the first round
accepted agree and the others are valid draws. Box-Cox: same survivors,
distances, weights and doubled variance to rtol 1e-8, and the chosen
lambdas equal the JAX host rule's (``stats.optimize_box_cox`` per shifted
column) exactly."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from abcsmc_tpu.compare import ks_distance
from abcsmc_tpu.config import (
    FilterType as JFilterType, NoiseType as JNoiseType, parse_config as j_parse,
)
from abcsmc_tpu.models.parameters import ParameterSet as JParameterSet
from abcsmc_tpu.models.simulators import make_dice_simulator
from abcsmc_tpu.models.transforms import ParameterTransform as JTransform
from abcsmc_tpu.ops import pls as jpls
from abcsmc_tpu.ops import ranking
from abcsmc_tpu.ops import stats as jstats
from abcsmc_tpu.parallel import ShardedGeneration, particle_mesh
from abcsmc_tpu_torch.config import FilterType, NoiseType, parse_config
from abcsmc_tpu_torch.models.parameters import ParameterSet, RetryNormals
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
    if "noise_type" in kw:
        jkw["noise_type"] = getattr(JNoiseType, kw["noise_type"])
        tkw["noise_type"] = getattr(NoiseType, kw["noise_type"])
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
    # the first round of the MULTIVARIATE rejection loop
    noise_eps = jax.random.normal(jax.random.split(k_noise)[1],
                                  (n_next, jgen.par_set.npar), dt)
    return StepDraws(
        vdv_seed=torch.tensor(int(jpls.vdv_seed(key)), dtype=torch.int64),
        pick=torch.as_tensor(np.array(pick)),
        noise_u=torch.as_tensor(np.array(noise_u)),
        next_seeds=torch.as_tensor(np.array(seeds, np.int64)),
        noise_eps=torch.as_tensor(np.array(noise_eps)),
        retry_seed=torch.tensor(99),
    )


def _data(seed=11, truth=(0.3, 0.6, 8.0)):
    rng = np.random.default_rng(seed)
    params = np.stack([rng.uniform(0, 1, N), rng.uniform(0, 1, N),
                       rng.integers(1, 21, N).astype(np.float64)], axis=1)
    mix = rng.normal(size=(NPAR, NMET)) * np.array([[1.0], [1.0], [0.1]])
    mets = params @ mix + 0.4 * rng.normal(size=(N, NMET))
    obs = np.array(truth) @ mix
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


def _assert_rank_and_weights_equal(res, jres):
    np.testing.assert_array_equal(res.survivor_idx.numpy(),
                                  np.asarray(jres.survivor_idx))
    assert int(res.ncomp_used) == int(jres.ncomp_used) > 0
    np.testing.assert_allclose(res.distances.numpy(),
                               np.asarray(jres.distances), rtol=1e-8)
    np.testing.assert_allclose(res.weights.numpy(), np.asarray(jres.weights),
                               rtol=1e-8)
    np.testing.assert_allclose(res.doubled_variance.numpy(),
                               np.asarray(jres.doubled_variance), rtol=1e-8)


@pytest.mark.parametrize("method", ["multinomial", "systematic"])
def test_step_multivariate_matches_jax_step(method):
    # a truth in a corner of the prior box: many proposals leave the support
    params, mets, obs, prev = _data(truth=(0.02, 0.97, 19.0))
    key = jax.random.PRNGKey(8)
    n_next = 300
    state = tuple(jnp.asarray(x) for x in prev)
    tstate = tuple(torch.as_tensor(x) for x in prev)

    def both(max_retries):
        jgen, gen = _pair(obs, np.float64, resample_method=method,
                          noise_type="MULTIVARIATE", max_retries=max_retries)
        jres = jgen.step_precomputed(key, jnp.asarray(params),
                                     jnp.asarray(mets), KEEP, n_next, state)
        res = gen.step_precomputed(torch.as_tensor(params),
                                   torch.as_tensor(mets), KEEP, n_next,
                                   jax_draws(jgen, key, n_next), tstate)
        return gen, res, jres

    # one round only: a rejected row falls back to its survivor in both
    gen, one, jone = both(1)
    _assert_rank_and_weights_equal(one, jone)
    assert one.mvn_rounds == 1
    np.testing.assert_allclose(one.next_params.numpy(),
                               np.asarray(jone.next_params), rtol=1e-8)
    np.testing.assert_array_equal(one.next_seeds.numpy(),
                                  np.asarray(jone.next_seeds, np.int64))
    # a row the first round rejected is its unperturbed survivor
    surv = {tuple(r) for r in one.survivor_params.numpy()}
    valid_first = np.array([tuple(r) not in surv
                            for r in one.next_params.numpy()])
    assert 0 < (~valid_first).sum() < n_next     # some rows need a retry

    # retries on: the first round's rows stand, the rest are redrawn valid
    gen, res, jres = both(1000)
    assert 1 < res.mvn_rounds < 1000
    got, want = res.next_params.numpy(), np.asarray(jres.next_params)
    np.testing.assert_allclose(got[valid_first], want[valid_first], rtol=1e-8)
    np.testing.assert_array_equal(got[valid_first],
                                  one.next_params.numpy()[valid_first])
    assert bool(gen.par_set.valid_mask(res.next_params).all())
    assert bool(gen.par_set.valid_mask(torch.as_tensor(want)).all())


def test_step_multivariate_collapsed_column_falls_back_like_jax():
    """A survivor column with zero variance makes the covariance singular:
    ``jnp.linalg.cholesky`` gives NaN, no proposal is ever valid, and after
    ``max_retries`` rounds every row is its resampled survivor. The port's
    ``cholesky_ex`` route ends the same way instead of raising."""
    params, mets, obs, prev = _data()
    params = params.copy()
    params[:, 2] = 7.0                      # the INT column, collapsed
    key = jax.random.PRNGKey(2)
    jgen, gen = _pair(obs, np.float64, noise_type="MULTIVARIATE",
                      max_retries=3)
    jres = jgen.step_precomputed(key, jnp.asarray(params), jnp.asarray(mets),
                                 KEEP, 120, None)
    res = gen.step_precomputed(torch.as_tensor(params), torch.as_tensor(mets),
                               KEEP, 120, jax_draws(jgen, key, 120), None)
    np.testing.assert_array_equal(res.survivor_idx.numpy(),
                                  np.asarray(jres.survivor_idx))
    assert res.mvn_rounds == 3
    assert np.isfinite(res.next_params.numpy()).all()
    np.testing.assert_array_equal(res.next_params.numpy(),
                                  np.asarray(jres.next_params))
    surv = {tuple(r) for r in res.survivor_params.numpy()}
    assert all(tuple(r) in surv for r in res.next_params.numpy())


def _mvn_step(gen, jgen, key, first=False, n_next=300, data=None):
    params, mets, obs, prev = data or _data(truth=(0.02, 0.97, 19.0))
    return gen.step_precomputed(
        torch.as_tensor(params), torch.as_tensor(mets), KEEP, n_next,
        jax_draws(jgen, key, n_next),
        None if first else tuple(torch.as_tensor(x) for x in prev))


def test_mvn_rejection_block_changes_no_bit():
    """The retry rounds' normals are a counter hash of (seed, round, row,
    column): blocks of 1 or 2 rounds between host reads (each later block
    run eagerly) and one block of max_retries rounds give the same rows bit
    for bit and the same count."""
    obs = _data(truth=(0.02, 0.97, 19.0))[2]
    key = jax.random.PRNGKey(8)
    out = []
    for block in (1, 2, 1000):
        jgen, gen = _pair(obs, np.float64, noise_type="MULTIVARIATE")
        gen.rejection_block = block
        res = _mvn_step(gen, jgen, key)
        out.append((res, gen.mvn_eager_finishes))
    *small, (whole, fin) = out
    assert whole.mvn_rounds > 2 and fin == 0
    assert not whole.mvn_finished_eagerly
    for res, fin in small:
        assert res.mvn_rounds == whole.mvn_rounds
        assert fin == 1 and res.mvn_finished_eagerly
        np.testing.assert_array_equal(res.next_params.numpy(),
                                      whole.next_params.numpy())


def test_mvn_count_is_the_first_all_accepted_round():
    """The count is the JAX loop's counter: the first round after which
    every row holds an accepted proposal; each row keeps its first accepted
    one (rebuilt here round by round from the same normals)."""
    ps = _pair(_data()[2], np.float64)[1].par_set
    rng = np.random.default_rng(3)
    mu = torch.as_tensor(np.stack([rng.uniform(0.02, 0.1, 200),
                                   rng.uniform(0.9, 0.98, 200),
                                   rng.integers(1, 21, 200).astype(float)],
                                  axis=1))
    L = torch.as_tensor(np.diag([0.2, 0.2, 3.0]))
    eps = torch.as_tensor(rng.normal(size=(200, 3)))
    seed = torch.tensor(1234)
    x, count = ps.noise_multivariate(mu, L, eps, 1000, seed)
    stream = RetryNormals(seed, 200, 3, torch.float64, "cpu")
    keys = stream.round_keys(1, 200)
    want = torch.full_like(mu, math.nan)
    done = torch.zeros(200, dtype=torch.bool)
    r = 0
    while not bool(done.all()):
        e = eps if r == 0 else stream.normals(keys[r - 1])
        prop = ps.recast(mu + e @ L.T)
        ok = ps.valid_mask(prop).all(dim=1) & ~done
        want[ok] = prop[ok]
        done |= ok
        r += 1
    assert count == r > 3
    assert torch.equal(x, want)
    # a round's normals: standard normal, the same whichever block asks
    z = stream.normals(keys[5])
    assert torch.equal(z, stream.normals(stream.round_keys(6, 7)[0]))
    assert ks_distance(z.numpy().ravel(),
                       np.random.default_rng(0).normal(size=600)) < 0.1


def test_mvn_deferred_count_equals_the_eager_step():
    """What a replay does on the card, on the CPU: a step built as under
    capture leaves its rejection loop on the device after one block; the
    finish read after it gives the eager step's count and rows, and leaves
    the loop as the step made it (the next replay runs it again)."""
    obs = _data(truth=(0.02, 0.97, 19.0))[2]
    key = jax.random.PRNGKey(8)
    jgen, gen = _pair(obs, np.float64, noise_type="MULTIVARIATE")
    eager = _mvn_step(gen, jgen, key)
    gen._capturing = True
    deferred = _mvn_step(gen, jgen, key)
    gen._capturing = False
    loop = deferred.mvn_loop
    assert deferred.mvn_rounds == 0 and int(loop.count) == -1
    block_rows = deferred.next_params.clone()
    for _ in range(2):
        got = block_rows.clone()
        rounds, more = gen._finish_rejection(loop, got)
        assert (rounds, more) == (eager.mvn_rounds, True)
        np.testing.assert_array_equal(got.numpy(), eager.next_params.numpy())
        assert loop.rounds == gen.rejection_block and int(loop.count) == -1


def test_mvn_collapsed_column_reads_max_retries_after_one_block():
    """A NaN factor accepts nothing: the count reads max_retries after the
    first block (the later rounds are skipped) and every row is its
    survivor, as JAX's 1,000-round loop leaves it."""
    params, mets, obs, prev = _data()
    params = params.copy()
    params[:, 2] = 7.0
    key = jax.random.PRNGKey(2)
    jgen, gen = _pair(obs, np.float64, noise_type="MULTIVARIATE")
    jres = jgen.step_precomputed(key, jnp.asarray(params), jnp.asarray(mets),
                                 KEEP, 120, None)
    res = _mvn_step(gen, jgen, key, first=True, n_next=120,
                    data=(params, mets, obs, prev))
    assert res.mvn_rounds == 1000 and not res.mvn_finished_eagerly
    np.testing.assert_array_equal(res.next_params.numpy(),
                                  np.asarray(jres.next_params))


def _skewed_data(seed=4):
    """Positive, right-skewed metrics (exp of a normal) whose log is linear
    in the parameters, plus one column with a non-positive minimum."""
    params, mets, obs, prev = _data(seed)
    mets = np.exp(0.6 * mets)
    obs = np.exp(0.6 * obs)
    mets[:, 3] = mets[:, 3] - 2.5
    obs[3] = obs[3] - 2.5
    assert mets[:, 3].min() < 0 < mets[:, :3].min()
    return params, mets, obs, prev


@pytest.mark.parametrize("first", [False, True])
def test_step_box_cox_matches_jax_step(first):
    params, mets, obs, prev = _skewed_data()
    jgen, gen = _pair(obs, np.float64, box_cox=True)
    key = jax.random.PRNGKey(6)
    n_next = 200
    jres = jgen.step_precomputed(
        key, jnp.asarray(params), jnp.asarray(mets), KEEP, n_next,
        None if first else tuple(jnp.asarray(x) for x in prev))
    res = gen.step_precomputed(
        torch.as_tensor(params), torch.as_tensor(mets), KEEP, n_next,
        jax_draws(jgen, key, n_next),
        None if first else tuple(torch.as_tensor(x) for x in prev))
    _assert_rank_and_weights_equal(res, jres)
    np.testing.assert_allclose(res.next_params.numpy(),
                               np.asarray(jres.next_params), rtol=1e-10)
    # stored and survivor metrics stay raw
    np.testing.assert_array_equal(res.metrics.numpy(), mets)
    np.testing.assert_array_equal(res.survivor_metrics.numpy(),
                                  mets[res.survivor_idx.numpy()])
    # the lambdas of the host rule, column by column
    want = []
    for j in range(NMET):
        mn = min(mets[:, j].min(), obs[j])
        shift = 1e-6 - mn if mn <= 0 else 0.0
        want.append(float(jstats.optimize_box_cox(
            jnp.asarray(mets[:, j] + shift))))
    np.testing.assert_array_equal(res.box_cox_lambdas.numpy(),
                                  np.array(want))
    assert np.abs(np.array(want) - 1.0).min() > 0.2   # away from identity
    # and it changes the ranking: not the plain step's survivors
    _, plain = _pair(obs, np.float64)
    pres = plain.step_precomputed(
        torch.as_tensor(params), torch.as_tensor(mets), KEEP, 0,
        jax_draws(jgen, key, 0),
        None if first else tuple(torch.as_tensor(x) for x in prev))
    assert pres.box_cox_lambdas is None
    assert set(pres.survivor_idx.tolist()) != set(res.survivor_idx.tolist())


def test_step_box_cox_masks_padding_and_skips_simple_filter():
    """Padding rows (even non-positive ones) reach neither the shift nor
    the moments; with the SIMPLE filter Box-Cox is off, as in JAX."""
    params, mets, obs, prev = _skewed_data()
    _, gen = _pair(obs, np.float64, box_cox=True)
    draws = StepDraws(torch.tensor(3), torch.rand(0, dtype=torch.float64),
                      torch.rand(0, NPAR, dtype=torch.float64),
                      torch.zeros(0, dtype=torch.int64))
    state = tuple(torch.as_tensor(x) for x in prev)
    ref = gen.step_precomputed(torch.as_tensor(params), torch.as_tensor(mets),
                               KEEP, 0, draws, state)
    pp = np.concatenate([params, params[:5]])
    pm = np.concatenate([mets, -50.0 - mets[:5]])
    got = gen.step_precomputed(torch.as_tensor(pp), torch.as_tensor(pm),
                               KEEP, 0, draws, state, n_valid=N)
    np.testing.assert_array_equal(got.box_cox_lambdas.numpy(),
                                  ref.box_cox_lambdas.numpy())
    np.testing.assert_array_equal(got.survivor_idx.numpy(),
                                  ref.survivor_idx.numpy())
    np.testing.assert_allclose(got.distances[:N].numpy(),
                               ref.distances.numpy(), rtol=1e-10)
    jgen, simple = _pair(obs, np.float64, box_cox=True, filter_type="SIMPLE")
    sres = simple.step_precomputed(torch.as_tensor(params),
                                   torch.as_tensor(mets), KEEP, 0, draws,
                                   state)
    jres = jgen.step_precomputed(jax.random.PRNGKey(0), jnp.asarray(params),
                                 jnp.asarray(mets), KEEP, 0,
                                 tuple(jnp.asarray(x) for x in prev))
    assert sres.box_cox_lambdas is None
    np.testing.assert_array_equal(sres.survivor_idx.numpy(),
                                  np.asarray(jres.survivor_idx))


def test_generation_takes_the_config_keys_and_refuses_projection():
    """noise_type, max_retries, box_cox and weight_precision are
    constructor arguments, as in the JAX step; PSEUDO parameters raise
    ValueError there too."""
    params, mets, obs, prev = _data()
    _, gen = _pair(obs, np.float64, noise_type="MULTIVARIATE", max_retries=7,
                   box_cox=True, weight_precision="highest")
    assert gen.noise_type == NoiseType.MULTIVARIATE
    assert (gen.max_retries, gen.box_cox) == (7, True)
    assert gen.weight_precision == "highest"
    d = gen.draw_step(torch.Generator().manual_seed(0), 10)
    assert d.noise_u is None and d.noise_eps.shape == (10, NPAR)
    assert d.retry_seed.shape == () and d.retry_seed.dtype == torch.int64
    pseudo = [{"name": "g", "dist_type": "PSEUDO", "num_type": "INT",
               "par1": 0, "par2": 3}]
    raw = {"parameters": pseudo,
           "metrics": [{"name": "m", "num_type": "FLOAT", "value": 0.0}]}
    jcfg, cfg = j_parse(raw), parse_config(raw)
    with pytest.raises(ValueError, match="fitting mode"):
        ShardedGeneration(
            JParameterSet.from_specs(jcfg.parameters),
            JTransform(jcfg.parameters), make_dice_simulator(), [0.0],
            mesh=particle_mesh(jax.devices()[:1]))
    with pytest.raises(ValueError, match="fitting mode"):
        Generation(ParameterSet.from_specs(cfg.parameters),
                   ParameterTransform(cfg.parameters), None, [0.0],
                   device="cpu")


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


@pytest.mark.parametrize("cap", [{"max_pls_components": 2},
                                 {"vdv_max_rows": 64},
                                 {"vdv_permutations": 31}])
def test_capped_step_matches_jax_step(cap):
    """The three ShardedGeneration arguments that are no config key: the
    component cap binds (2 of 5), the van der Voet test on the last 64
    rows or with 31 sign rows; the same survivors and ncomp_used as the
    JAX step with the same value."""
    params, mets, obs, prev = _data()
    jgen, gen = _pair(obs, np.float64, **cap)
    key = jax.random.PRNGKey(5)
    jres = jgen.step_precomputed(key, jnp.asarray(params), jnp.asarray(mets),
                                 KEEP, 0, tuple(jnp.asarray(x) for x in prev))
    res = gen.step_precomputed(torch.as_tensor(params), torch.as_tensor(mets),
                               KEEP, 0, jax_draws(jgen, key, 0),
                               tuple(torch.as_tensor(x) for x in prev))
    _assert_rank_and_weights_equal(res, jres)
    if "max_pls_components" in cap:
        assert int(res.ncomp_used) == 2


def test_overflowed_shifted_frame_is_not_chosen_f32():
    """float32 data near 0 (|x| <= 3e18) with the observed value at 1.5e19:
    the shifted sums overflow (ratio inf / inf), the raw ones do not. The
    port takes the raw frame: finite distances within 1e-5 of the float64
    run's, and its survivors. JAX keeps the overflowed frame; on the CPU
    its distances are finite but far from float64's (the deviation the
    port's ``_dual_moment_stats`` documents)."""
    rng = np.random.default_rng(3)
    n, keep = 64, 16
    params = rng.uniform(1, 50, (n, 2))
    mets = np.stack([rng.uniform(-3e18, 3e18, n), 100.0 * rng.normal(size=n)],
                    axis=1)
    obs = np.array([1.5e19, 0.0])
    jgen, gen = _pair(obs, np.float32, params=DICE, filter_type="SIMPLE")
    _, gen64 = _pair(obs, np.float64, params=DICE, filter_type="SIMPLE")
    draws = StepDraws(torch.tensor(0), torch.zeros(0), torch.zeros(0, 2),
                      torch.zeros(0, dtype=torch.int64))
    got = gen.step_precomputed(torch.as_tensor(params, dtype=torch.float32),
                               torch.as_tensor(mets, dtype=torch.float32),
                               keep, 0, draws)
    want = gen64.step_precomputed(torch.as_tensor(params),
                                  torch.as_tensor(mets), keep, 0, draws)
    assert np.isfinite(got.distances.numpy()).all()
    np.testing.assert_allclose(got.distances.numpy(),
                               want.distances.numpy(), rtol=1e-5)
    assert set(got.survivor_idx.tolist()) == set(want.survivor_idx.tolist())
    jres = jgen.step_precomputed(jax.random.PRNGKey(0),
                                 jnp.asarray(params, jnp.float32),
                                 jnp.asarray(mets, jnp.float32), keep, 0,
                                 None)
    assert not np.allclose(np.asarray(jres.distances),
                           want.distances.numpy(), rtol=1e-3)
