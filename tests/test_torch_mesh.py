"""The port's sharded generation step (``Generation(mesh=...)`` on a virtual
mesh of CPU shards) held against the JAX step (``ShardedGeneration`` on
``particle_mesh(jax.devices()[:k])``, the conftest's 8 CPU devices) for k in
{1, 2, 8}, on one numpy-seeded population and the same per-shard draws: each
shard's pick, noise and seeds come from JAX's own ``fold_in(key, shard)``
keys, the systematic offset from the shared key (abcsmc_tpu/parallel/
generation.py:431-449).

N = 403 and keep = 41 divide by neither 2 nor 8, so every k > 1 case pads
(edge rows, masked out of every statistic) and edge-pads the weight
kernel's query slices. Float64; survivor indices, next seeds and
``ncomp_used`` identical; distances, weights, doubled variance and the next
population at rtol 1e-10. MULTIVARIATE noise: with ``max_retries=1`` every
row agrees; with retries on (a forced second round) the rows the first
round accepted agree and the others are valid draws of the port's own
retry stream.

Port-only checks: a k-shard step has the survivors of the one-shard step;
the two-stage top-K gives the single stage's bits; split propose gives the
fused proposal; the van der Voet window is the global one at any k;
``fetch_rows_global`` / ``assemble_rows_chunked`` and ``sharded_simulate``
equal their one-array versions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from abcsmc_tpu.config import (
    FilterType as JFilterType, NoiseType as JNoiseType, parse_config as j_parse,
)
from abcsmc_tpu.models.parameters import ParameterSet as JParameterSet
from abcsmc_tpu.models.simulators import make_dice_simulator
from abcsmc_tpu.models.transforms import ParameterTransform as JTransform
from abcsmc_tpu.ops import pls as jpls
from abcsmc_tpu.parallel import ShardedGeneration
from abcsmc_tpu.parallel import particle_mesh as j_particle_mesh
from abcsmc_tpu_torch.config import FilterType, NoiseType, parse_config
from abcsmc_tpu_torch.models.parameters import ParameterSet
from abcsmc_tpu_torch.models.simulators import (
    make_dice_simulator as t_make_dice,
)
from abcsmc_tpu_torch.models.transforms import ParameterTransform
from abcsmc_tpu_torch.parallel import particle_mesh
from abcsmc_tpu_torch.parallel.generation import (
    Generation, StepDraws, _blocked_cumsum, sharded_simulate,
)
from abcsmc_tpu_torch.parallel.mesh import (
    assemble_rows_chunked, fetch_rows_global,
)

N, KEEP, N_NEXT, NPAR, NMET = 403, 41, 301, 3, 5
RTOL = 1e-10
PARAMS = [
    {"name": "a", "dist_type": "UNIFORM", "num_type": "FLOAT",
     "par1": 0.0, "par2": 1.0},
    {"name": "b", "dist_type": "UNIFORM", "num_type": "FLOAT",
     "par1": 0.0, "par2": 1.0},
    {"name": "k", "dist_type": "UNIFORM", "num_type": "INT",
     "par1": 1, "par2": 20},
]

# the case matrix of __graft_entry__.py::dryrun_multichip: noise, ranking
# rule, filter, resampling, chunked row passes, Box-Cox, first set, and the
# big-N pick paths (forced at a small size)
CASES = {
    "vdv_multinomial": dict(),
    "tolerance_systematic_chunked": dict(
        pls_optimal_method="tolerance", resample_method="systematic",
        row_block=20),
    "simple_first_sorted": dict(filter_type="SIMPLE", first=True,
                                sorted_pick=True),
    "box_cox_systematic_sorted": dict(box_cox=True,
                                      resample_method="systematic",
                                      sorted_pick=True),
    "box_cox_chunked": dict(box_cox=True, row_block=24),
    "multivariate_one_round": dict(noise_type="MULTIVARIATE", max_retries=1,
                                   truth=(0.02, 0.97, 19.0)),
}
KS = (1, 2, 8)


def _data(truth=(0.3, 0.6, 8.0), seed=11):
    rng = np.random.default_rng(seed)
    params = np.stack([rng.uniform(0, 1, N), rng.uniform(0, 1, N),
                       rng.integers(1, 21, N).astype(np.float64)], axis=1)
    mix = rng.normal(size=(NPAR, NMET)) * np.array([[1.0], [1.0], [0.1]])
    # positive, skewed metrics give Box-Cox a real choice
    mets = np.exp(0.3 * (params @ mix + 0.4 * rng.normal(size=(N, NMET))))
    obs = np.exp(0.3 * (np.array(truth) @ mix))
    prev = (
        np.stack([rng.uniform(0.1, 0.9, KEEP), rng.uniform(0.1, 0.9, KEEP),
                  rng.integers(2, 19, KEEP).astype(np.float64)], axis=1),
        rng.uniform(0.5, 1.5, KEEP),
        np.array([0.05, 0.08, 6.0]),
    )
    prev = (prev[0], prev[1] / np.linalg.norm(prev[1]), prev[2])
    return params, mets, obs, prev


def _kwargs(case):
    kw = {k: v for k, v in case.items()
          if k not in ("first", "sorted_pick", "truth")}
    jkw, tkw = dict(kw), dict(kw)
    if "filter_type" in kw:
        jkw["filter_type"] = getattr(JFilterType, kw["filter_type"])
        tkw["filter_type"] = getattr(FilterType, kw["filter_type"])
    if "noise_type" in kw:
        jkw["noise_type"] = getattr(JNoiseType, kw["noise_type"])
        tkw["noise_type"] = getattr(NoiseType, kw["noise_type"])
    return jkw, tkw


def _raw(obs):
    return {"smc_iterations": 3, "num_samples": N,
            "predictive_prior_size": KEEP, "parameters": PARAMS,
            "metrics": [{"name": f"m{j}", "num_type": "FLOAT", "value": 0.0}
                        for j in range(len(obs))]}


def _port(obs, k, **tkw):
    cfg = parse_config(_raw(obs))
    return Generation(
        ParameterSet.from_specs(cfg.parameters),
        ParameterTransform(cfg.parameters), None, obs,
        mesh=particle_mesh(["cpu"] * k), dtype=torch.float64, **tkw)


def _jax(obs, k, **jkw):
    jcfg = j_parse(_raw(obs))
    return ShardedGeneration(
        JParameterSet.from_specs(jcfg.parameters),
        JTransform(jcfg.parameters), make_dice_simulator(max_dice=4), obs,
        mesh=j_particle_mesh(jax.devices()[:k]), dtype=jnp.float64, **jkw)


def jax_mesh_draws(jgen, key, n_next, k) -> StepDraws:
    """Each shard's draws of the JAX step from ``key`` (per-shard keys
    ``fold_in(key, shard)``; the systematic offset from the shared key)."""
    dt = jgen.dtype
    local_next = -(-n_next // k)
    npar = jgen.par_set.npar
    picks, noise_u, noise_eps, seeds = [], [], [], []
    for s in range(k):
        k_pick, k_noise, k_seed = jax.random.split(jax.random.fold_in(key, s),
                                                   3)
        if local_next >= jgen.sorted_pick_min:
            picks.append(jax.random.exponential(k_pick, (local_next + 1,), dt))
        else:
            picks.append(jax.random.uniform(k_pick, (local_next,), dt))
        noise_u.append(jax.random.uniform(k_noise, (local_next, npar), dt))
        noise_eps.append(jax.random.normal(jax.random.split(k_noise)[1],
                                           (local_next, npar), dt))
        seeds.append(jax.random.randint(k_seed, (local_next,), 0,
                                        np.iinfo(np.int32).max))

    def t(xs, dtype=None):
        return [torch.as_tensor(np.array(x, dtype)) for x in xs]

    pick = t(picks)
    if jgen.resample_method == "systematic":
        pick = torch.as_tensor(np.array(jax.random.uniform(
            jax.random.fold_in(jax.random.fold_in(key, 131071), 0), (), dt)))
    return StepDraws(
        vdv_seed=torch.tensor(int(jpls.vdv_seed(key)), dtype=torch.int64),
        pick=pick, noise_u=t(noise_u), next_seeds=t(seeds, np.int64),
        noise_eps=t(noise_eps), retry_seed=torch.tensor(99),
    )


def _cat(x):
    return torch.cat(x).numpy() if isinstance(x, list) else x.numpy()


def _run_pair(name, k):
    case = CASES[name]
    params, mets, obs, prev = _data(**({"truth": case["truth"]}
                                       if "truth" in case else {}))
    jkw, tkw = _kwargs(case)
    jgen, gen = _jax(obs, k, **jkw), _port(obs, k, **tkw)
    if case.get("sorted_pick"):
        jgen.sorted_pick_min = gen.sorted_pick_min = 16
    state = None if case.get("first") else prev
    key = jax.random.PRNGKey(5)
    jres = jgen.step_precomputed(
        key, jnp.asarray(params), jnp.asarray(mets), KEEP, N_NEXT,
        None if state is None else tuple(jnp.asarray(x) for x in state),
        n_valid=N)
    res = gen.step_precomputed(
        gen.shard_rows(params, N), gen.shard_rows(mets, N), KEEP, N_NEXT,
        jax_mesh_draws(jgen, key, N_NEXT, k),
        None if state is None else tuple(torch.as_tensor(x) for x in state),
        n_valid=N)
    return gen, jgen, res, jres


_CACHE = {}


@pytest.fixture(scope="module")
def pair():
    def get(name, k):
        if (name, k) not in _CACHE:
            _CACHE[(name, k)] = _run_pair(name, k)
        return _CACHE[(name, k)]
    yield get
    _CACHE.clear()


def _assert_rank_and_weights(res, jres):
    np.testing.assert_array_equal(res.survivor_idx.numpy(),
                                  np.asarray(jres.survivor_idx))
    assert int(res.ncomp_used) == int(jres.ncomp_used)
    np.testing.assert_allclose(_cat(res.distances),
                               np.asarray(jres.distances), rtol=RTOL)
    np.testing.assert_array_equal(res.survivor_params.numpy(),
                                  np.asarray(jres.survivor_params))
    np.testing.assert_array_equal(res.survivor_metrics.numpy(),
                                  np.asarray(jres.survivor_metrics))
    np.testing.assert_allclose(res.weights.numpy(), np.asarray(jres.weights),
                               rtol=RTOL)
    np.testing.assert_allclose(res.doubled_variance.numpy(),
                               np.asarray(jres.doubled_variance), rtol=RTOL)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("name", list(CASES))
def test_mesh_step_matches_jax_mesh_step(pair, name, k):
    gen, _, res, jres = pair(name, k)
    _assert_rank_and_weights(res, jres)
    if CASES[name].get("filter_type") != "SIMPLE":
        assert int(res.ncomp_used) > 0
    n_pad = -(-N // k) * k
    assert sum(d.shape[0] for d in res.distances) == n_pad
    assert np.isinf(_cat(res.distances)[N:]).all()
    assert sum(x.shape[0] for x in res.next_params) == -(-N_NEXT // k) * k
    np.testing.assert_allclose(_cat(res.next_params),
                               np.asarray(jres.next_params), rtol=RTOL)
    np.testing.assert_array_equal(_cat(res.next_seeds),
                                  np.asarray(jres.next_seeds, np.int64))
    if gen.noise_type == NoiseType.MULTIVARIATE:
        assert res.mvn_rounds == 1


@pytest.mark.parametrize("k", KS)
def test_mesh_multivariate_second_round(pair, k):
    """Retries on: the rows the first round accepted are JAX's one-round
    rows; the others are redrawn inside the support, and the round count is
    the largest over the shards."""
    gen1, _, one, _ = pair("multivariate_one_round", k)
    params, mets, obs, prev = _data(truth=(0.02, 0.97, 19.0))
    gen = _port(obs, k, noise_type=NoiseType.MULTIVARIATE, max_retries=1000)
    jgen = _jax(obs, k)
    key = jax.random.PRNGKey(5)
    res = gen.step_precomputed(
        gen.shard_rows(params, N), gen.shard_rows(mets, N), KEEP, N_NEXT,
        jax_mesh_draws(jgen, key, N_NEXT, k),
        tuple(torch.as_tensor(x) for x in prev), n_valid=N)
    surv = {tuple(r) for r in one.survivor_params.numpy()}
    first = _cat(one.next_params)
    valid_first = np.array([tuple(r) not in surv for r in first])
    assert 0 < (~valid_first).sum()            # a second round was needed
    got = _cat(res.next_params)
    np.testing.assert_array_equal(got[valid_first], first[valid_first])
    assert bool(gen.par_set.valid_mask(torch.as_tensor(got)).all())
    assert 1 < res.mvn_rounds < 1000


@pytest.mark.parametrize("k", (2, 8))
def test_mesh_step_survivors_equal_one_shard(pair, k):
    """Only the order of the sums differs between a k-shard and a one-shard
    step: the same survivors and components, the weights to rounding."""
    for name in ("vdv_multinomial", "box_cox_chunked"):
        one, many = pair(name, 1)[2], pair(name, k)[2]
        np.testing.assert_array_equal(one.survivor_idx.numpy(),
                                      many.survivor_idx.numpy())
        assert int(one.ncomp_used) == int(many.ncomp_used)
        np.testing.assert_allclose(one.weights.numpy(), many.weights.numpy(),
                                   rtol=1e-12)
        np.testing.assert_allclose(_cat(one.distances)[:N],
                                   _cat(many.distances)[:N], rtol=1e-12)


def _port_step(gen, k, params, mets, prev, draws_gen=0, n_next=N_NEXT,
               **kw):
    g = torch.Generator().manual_seed(draws_gen)
    draws = gen.draw_step(g, n_next)
    return gen.step_precomputed(gen.shard_rows(params, N),
                                gen.shard_rows(mets, N), KEEP, n_next, draws,
                                tuple(torch.as_tensor(x) for x in prev),
                                n_valid=N, **kw)


@pytest.mark.parametrize("k", (1, 3, 8))
def test_two_stage_topk_bit_equals_single_stage(k):
    params, mets, obs, prev = _data()
    one = _port_step(_port(obs, k, topk_two_stage=False), k, params, mets,
                     prev)
    two = _port_step(_port(obs, k, topk_two_stage=True), k, params, mets,
                     prev)
    for f in ("survivor_idx", "survivor_params", "survivor_metrics",
              "weights", "doubled_variance"):
        assert torch.equal(getattr(one, f), getattr(two, f)), f
    assert torch.equal(torch.cat(one.next_params), torch.cat(two.next_params))
    gen = _port(obs, 8)
    assert not gen._topk_two_stage_active(KEEP, 51)   # payload far below
    gen._TOPK_TWO_STAGE_BYTES = 1
    assert gen._topk_two_stage_active(KEEP, 51)


@pytest.mark.parametrize("noise,method", [
    ("INDEPENDENT", "multinomial"), ("INDEPENDENT", "systematic"),
    ("MULTIVARIATE", "multinomial")])
def test_mesh_split_propose_equals_fused_step(noise, method):
    params, mets, obs, prev = _data(truth=(0.05, 0.9, 18.0))
    kw = dict(noise_type=getattr(NoiseType, noise), resample_method=method)
    whole, split = _port(obs, 8, **kw), _port(obs, 8, propose_split=True,
                                              **kw)
    assert split.split_propose_active(N, N_NEXT)
    res = _port_step(whole, 8, params, mets, prev, draws_gen=3)
    g = torch.Generator().manual_seed(3)
    draws = split.draw_vdv_seed(g)
    ranked = split.step_precomputed(
        split.shard_rows(params, N), split.shard_rows(mets, N), KEEP, 0,
        draws, tuple(torch.as_tensor(x) for x in prev), n_valid=N)
    draws = split.draw_proposal(g, N_NEXT, draws)
    nxt, seeds, rounds = split.propose(ranked.survivor_params, ranked.weights,
                                       ranked.doubled_variance, N_NEXT, draws)
    assert torch.equal(torch.cat(nxt), torch.cat(res.next_params))
    assert torch.equal(torch.cat(seeds), torch.cat(res.next_seeds))
    assert rounds == res.mvn_rounds


def test_vdv_window_is_global_at_any_shard_count():
    """With the window cap binding, the held-out window is the last
    ``vdv_max_rows`` valid rows of the whole population on every mesh, so
    the component count does not depend on the shard count."""
    params, mets, obs, prev = _data()
    got = []
    for k in (1, 2, 8):
        gen = _port(obs, k, vdv_max_rows=90)
        res = _port_step(gen, k, params, mets, prev)
        got.append((res.survivor_idx.numpy(), int(res.ncomp_used)))
    for idx, nc in got[1:]:
        np.testing.assert_array_equal(idx, got[0][0])
        assert nc == got[0][1]
    gen = _port(obs, 8, vdv_max_rows=90)
    rows = gen._vdv_rows(gen.mesh.padded(N), N, gen.mesh.padded(N) // 8)
    assert sum(b - a for a, b, _ in rows) == 90
    assert [g0 for a, b, g0 in rows if b > a][0] == N - 90


def test_mesh_draws_independent_of_process_layout():
    """Shard s's draws depend on the step's seed and s alone; the shared
    draws (van der Voet seed, systematic offset) are one per step."""
    obs = _data()[2]
    gen = _port(obs, 4, resample_method="systematic")
    a = gen.draw_step(torch.Generator().manual_seed(1), 50)
    b = gen.draw_step(torch.Generator().manual_seed(1), 50)
    assert all(torch.equal(x, y) for x, y in zip(a.noise_u, b.noise_u))
    assert a.pick.dim() == 0 and len(a.noise_u) == 4
    assert a.noise_u[0].shape == (13, NPAR)
    assert not torch.equal(a.noise_u[0], a.noise_u[1])
    params, seeds = gen.init_population(torch.Generator().manual_seed(2), 50)
    assert [p.shape[0] for p in params] == [13] * 4
    assert bool(gen.par_set.valid_mask(torch.cat(params)).all())


@pytest.mark.parametrize("chunk", [7, 16, 1 << 22])
@pytest.mark.parametrize("axis", [0, 1])
def test_fetch_rows_global_is_the_concatenation(chunk, axis):
    mesh = particle_mesh(["cpu"] * 4)
    rng = np.random.default_rng(0)
    full = rng.normal(size=(3, 20, 2) if axis else (20, 2))
    parts = [torch.as_tensor(x) for x in np.split(full, 4, axis=axis)]
    np.testing.assert_array_equal(fetch_rows_global(parts, mesh, chunk, axis),
                                  full)
    # the windows, partial final one included
    np.testing.assert_array_equal(
        assemble_rows_chunked(parts, mesh, chunk, axis), full)


@pytest.mark.parametrize("n,row", [(1, 8), (8, 8), (9, 8), (8 * 8 * 8 + 3, 8),
                                   (100_003, 1024)])
def test_blocked_cumsum_is_the_cumsum(n, row):
    """The fixed-order scan the pick runs on the card (rows, then the row
    totals, recursively; the last row zero-padded) equals the serial
    cumsum in float64 to rounding, and is nondecreasing on nonnegative
    input."""
    x = torch.as_tensor(np.random.default_rng(n).exponential(1.0, n))
    got = _blocked_cumsum(x, row)
    np.testing.assert_allclose(got.numpy(), np.cumsum(x.numpy()), rtol=1e-13)
    assert got.shape == (n,) and bool((got[1:] >= got[:-1]).all())


def test_sharded_simulate_equals_whole_batch():
    sim = t_make_dice_simulator()
    rng = np.random.default_rng(1)
    upars = torch.as_tensor(np.stack([rng.integers(1, 10, 37),
                                      rng.integers(2, 9, 37)], 1)
                            .astype(np.float64))
    seeds = torch.as_tensor(rng.integers(0, 2**31 - 1, 37))
    want = sim.batch_fn(upars, seeds).numpy()
    for k in (1, 3, 8):
        got = sharded_simulate(sim, particle_mesh(["cpu"] * k), upars, seeds,
                               37)
        np.testing.assert_array_equal(got, want)


def t_make_dice_simulator():
    return t_make_dice(max_dice=16)


# ---------------------------------------------------- run_device on a mesh
def _dice_cfg(db, **extra):
    return {"smc_iterations": 3, "num_samples": 203,
            "predictive_prior_size": 21, "noise": "INDEPENDENT",
            "simulator": "dice", "database_filename": db,
            "parameters": [
                {"name": "ndice", "dist_type": "UNIFORM", "num_type": "INT",
                 "par1": 1, "par2": 60},
                {"name": "sides", "dist_type": "UNIFORM", "num_type": "INT",
                 "par1": 1, "par2": 30}],
            "metrics": [{"name": "sum", "num_type": "INT", "value": 44},
                        {"name": "sd", "num_type": "FLOAT",
                         "value": 2.39925}],
            **extra}


def _rows(db):
    import sqlite3
    from contextlib import closing

    with closing(sqlite3.connect(db)) as con:
        return (con.execute("select serial, smcSet, particleIdx, status, "
                            "posterior from job order by serial").fetchall(),
                con.execute("select * from par order by serial").fetchall(),
                con.execute("select * from met order by serial").fetchall())


def _run_device(cfg, mesh=None, seed=4, **kw):
    from abcsmc_tpu_torch import AbcSmc

    a = AbcSmc(cfg, device="cpu", dtype=torch.float64, **kw)
    a.run_device(seed=seed, mesh=mesh)
    a.storage.close()
    return a


def test_run_device_one_shard_mesh_is_the_meshless_run(tmp_path):
    """A one-shard mesh draws from the run's generator in the meshless
    order: the same store, bit for bit."""
    a = str(tmp_path / "plain.sqlite")
    b = str(tmp_path / "mesh1.sqlite")
    _run_device(_dice_cfg(a))
    _run_device(_dice_cfg(b), particle_mesh(["cpu"]))
    assert _rows(a) == _rows(b)


@pytest.mark.parametrize("dispatch", ["sequential", "fused"])
def test_run_device_on_three_shards(tmp_path, dispatch):
    """A 3-shard mesh (203 rows: padded to 204): the fused route stores the
    sequential route's rows, every set is complete, and the posterior moves
    toward the observed roll (13 dice of 8 sides)."""
    db = str(tmp_path / f"{dispatch}.sqlite")
    a = _run_device(_dice_cfg(db, device_dispatch=dispatch),
                    particle_mesh(["cpu"] * 3))
    jobs = _rows(db)[0]
    assert len(jobs) == 3 * 203 and all(r[3] == "D" for r in jobs)
    assert sum(r[4] >= 0 for r in jobs) == 3 * 21
    phases = [t for t in a.timings if t["op"] == "run_device_phases"][-1]
    assert phases["shards"] == 3
    if dispatch == "fused":
        seq = str(tmp_path / "sequential_ref.sqlite")
        _run_device(_dice_cfg(seq, device_dispatch="sequential"),
                    particle_mesh(["cpu"] * 3))
        assert _rows(db) == _rows(seq)


def test_run_device_resumes_mid_set_on_a_mesh(tmp_path):
    """A half-simulated store resumed on a 3-shard mesh: its 'D' rows keep
    their metrics, the others are simulated over the mesh from their
    stored seeds, and a one-shard mesh resumes it as the meshless engine
    does."""
    from abcsmc_tpu_torch import AbcSmc

    stores = {}
    for name, mesh in (("plain", None), ("one", ["cpu"]),
                       ("three", ["cpu"] * 3)):
        db = str(tmp_path / f"{name}.sqlite")
        a = AbcSmc(_dice_cfg(db), device="cpu", dtype=torch.float64)
        a.build_database(seed=9)
        a.simulate_next_particles(n=100)
        done = _rows(db)[2][:100]
        a.storage.close()
        _run_device(_dice_cfg(db), None if mesh is None
                    else particle_mesh(mesh), seed=21)
        stores[name] = _rows(db)
        assert stores[name][2][:100] == done
        assert all(r[3] == "D" for r in stores[name][0])
    assert stores["plain"] == stores["one"]
    assert len(stores["three"][0]) == 3 * 203


def test_projection_on_a_mesh_equals_the_meshless_sweep(tmp_path):
    """pseudo.json through run_device: the sweep simulated over 3 shards
    (sharded_simulate) stores what the one-call sweep stores."""
    import json
    from pathlib import Path

    cfg = json.loads((Path(__file__).resolve().parents[1] / "examples"
                      / "pseudo.json").read_text())
    got = {}
    for name, mesh in (("plain", None), ("mesh", ["cpu"] * 3)):
        cfg["database_filename"] = str(tmp_path / f"{name}.sqlite")
        _run_device(dict(cfg), None if mesh is None else particle_mesh(mesh))
        got[name] = _rows(cfg["database_filename"])
    assert got["plain"][1:] == got["mesh"][1:]
    assert [r[:4] for r in got["plain"][0]] == [r[:4] for r in got["mesh"][0]]
