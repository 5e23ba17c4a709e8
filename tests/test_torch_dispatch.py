"""Fused dispatch of the port: ``Generation.run_scan`` / ``run_chain`` against
the sequential loop, and ``AbcSmc.run_device``'s routing (``device_dispatch``,
``row_block``, ``propose_split``, ``topk_two_stage``, ``mirror_store``, the
post-hoc NRMSE cut) against the default run.

On the CPU a bucket runs eagerly, so these tests hold the draw order, the
bucketing, the history layout and the engine's fetch and cut; the CUDA-graph
replays are held to the same equalities in tests/test_torch_gpu.py. Equal
means bit for bit (float64, one thread order: every route runs the same
operations on the same operands). The JAX package's ``run_chain`` is run on
one schedule to pin that both packages cut it into the same buckets."""

import io
import sqlite3
from contextlib import closing, redirect_stderr

import jax
import numpy as np
import pytest
import torch

from abcsmc_tpu.config import parse_config as j_parse
from abcsmc_tpu.models.parameters import ParameterSet as JParameterSet
from abcsmc_tpu.models.simulators import make_dice_simulator as j_dice
from abcsmc_tpu.models.transforms import ParameterTransform as JTransform
from abcsmc_tpu.parallel import ShardedGeneration, particle_mesh
from abcsmc_tpu_torch import AbcSmc
from abcsmc_tpu_torch.config import NoiseType, parse_config
from abcsmc_tpu_torch.models.parameters import ParameterSet
from abcsmc_tpu_torch.models.simulators import (
    make_dice_simulator, make_linear_gaussian_simulator,
)
from abcsmc_tpu_torch.models.transforms import ParameterTransform
from abcsmc_tpu_torch.parallel.generation import Generation
from abcsmc_tpu_torch.storage import MemoryStorage, SQLiteStorage

NPAR, NMET = 3, 5
MIX = np.random.default_rng(7).normal(size=(NPAR, NMET))
OBS = np.array([0.3, 0.7, 0.5]) @ MIX


def _raw(**extra):
    return {
        "smc_iterations": 4, "num_samples": 400,
        "predictive_prior_fraction": 0.1,
        "parameters": [
            {"name": f"p{i}", "dist_type": "UNIFORM", "num_type": "FLOAT",
             "par1": 0.0, "par2": 1.0} for i in range(NPAR)],
        "metrics": [
            {"name": f"m{j}", "num_type": "FLOAT", "value": float(OBS[j])}
            for j in range(NMET)],
        **extra,
    }


def _gen(**kw):
    cfg = parse_config(_raw())
    return Generation(
        ParameterSet.from_specs(cfg.parameters),
        ParameterTransform(cfg.parameters),
        make_linear_gaussian_simulator(NPAR, NMET, mix=MIX), OBS,
        device="cpu", dtype=torch.float64, **kw)


def _g(seed=3):
    return torch.Generator().manual_seed(seed)


def _sequential(gen, sizes, keeps, seed=3):
    """The engine's loop, written out: init, then draw_step and step per
    set from the one generator; the final set proposes nothing."""
    g = _g(seed)
    params, seeds = gen.init_population(g, sizes[0])
    state, out = None, []
    for t, (n, keep) in enumerate(zip(sizes, keeps)):
        n_next = sizes[t + 1] if t + 1 < len(sizes) else 0
        res = gen.step(params, seeds, keep, n_next, gen.draw_step(g, n_next),
                       state, n_valid=n)
        out.append((res.survivor_idx, res.survivor_params,
                    res.survivor_metrics, res.weights, res.doubled_variance,
                    res.ncomp_used, params, seeds, res.metrics))
        state = (res.survivor_params, res.weights, res.doubled_variance)
        params, seeds = res.next_params, res.next_seeds
    return out


def _assert_set_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("gens", [1, 2, 5])
@pytest.mark.parametrize("kw", [{}, {"row_block": 96},
                                {"resample_method": "systematic"},
                                {"noise_type": NoiseType.MULTIVARIATE}],
                         ids=["resident", "chunked", "systematic", "mvn"])
def test_run_scan_equals_sequential_loop(gens, kw):
    n, keep = 300, 30
    want = _sequential(_gen(**kw), [n] * gens, [keep] * gens)
    gen = _gen(**kw)
    last, hist = gen.run_scan(_g(), n, keep, gens, full_history=True)
    assert len(hist) == 9
    assert [tuple(h.shape) for h in hist] == [
        (gens, keep), (gens, keep, NPAR), (gens, keep, NMET), (gens, keep),
        (gens, NPAR), (gens,), (gens, n, NPAR), (gens, n), (gens, n, NMET)]
    for t in range(gens):
        _assert_set_equal([h[t] for h in hist], want[t])
    assert torch.equal(last.survivor_idx, want[-1][0])
    # every set proposes n rows; the last proposal is the unused one
    assert last.next_params.shape == (n, NPAR)
    # one init and one step per set, eagerly on the CPU
    assert gen.dispatches == gens + 1
    assert (gen.graph_captures, gen.graph_replays) == (0, 0)
    assert [i["route"] for i in gen.set_info] == ["eager"] * gens
    # the K-sized default history
    _, small = _gen(**kw).run_scan(_g(), n, keep, gens)
    assert len(small) == 6
    _assert_set_equal(small, hist[:6])
    res, states = _gen(**kw).run(_g(), [n] * gens, [keep] * gens)
    assert torch.equal(res.weights, last.weights)
    assert len(states) == gens


def _plan(history):
    return [(e[0], 1 if e[0] == "set" else e[1]) for e in history]


@pytest.mark.parametrize("sizes,keeps,plan", [
    # the quick-start's shape: four transitions, the peeled first set of the
    # bucket (its incoming state has 75 survivors, the bucket's 100), then
    # the bucket with the final set
    ([300, 500, 500, 750, 1000, 1000, 1000, 1000],
     [30, 50, 50, 75, 100, 100, 100, 100],
     [("set", 1)] * 5 + [("bucket", 3)]),
    # one keep throughout: nothing to peel after the first transition
    ([200, 300, 300, 300, 300], [20, 20, 20, 20, 20],
     [("set", 1), ("bucket", 4)]),
    # a bucket in the middle ends where the successor's size changes
    ([300, 300, 300, 300, 500, 500], [30, 30, 30, 30, 30, 30],
     [("set", 1), ("bucket", 2), ("set", 1), ("bucket", 2)]),
    ([150], [15], [("set", 1)]),
])
def test_run_chain_buckets_and_equals_sequential_loop(sizes, keeps, plan):
    want = _sequential(_gen(), sizes, keeps)
    gen = _gen()
    state, hist = gen.run_chain(_g(), sizes, keeps, full_history=True,
                                bucketed_history=True)
    assert _plan(hist) == plan
    flat = []
    for e in hist:
        if e[0] == "set":
            flat.append(e[1])
        else:
            flat.extend(tuple(y[i] for y in e[2]) for i in range(e[1]))
    assert len(flat) == len(sizes)
    for got, ref in zip(flat, want):
        _assert_set_equal(got, ref)
    _assert_set_equal(state, (want[-1][1], want[-1][3], want[-1][4]))
    assert gen.dispatches == len(sizes) + 1
    # the sliced form: one tuple per set
    _, sliced = _gen().run_chain(_g(), sizes, keeps)
    assert len(sliced) == len(sizes) and len(sliced[0]) == 6
    for got, ref in zip(sliced, want):
        _assert_set_equal(got, ref[:6])


def test_run_chain_buckets_as_the_jax_package_does():
    sizes = [48, 80, 80, 120, 160, 160, 160, 160]
    keeps = [12, 20, 20, 30, 40, 40, 40, 40]
    raw = {"smc_iterations": len(sizes), "num_samples": sizes,
           "predictive_prior_fraction": 0.25,
           "parameters": [{"name": n, "dist_type": "UNIFORM",
                           "num_type": "INT", "par1": 1, "par2": 50}
                          for n in ("ndice", "sides")],
           "metrics": [{"name": "sum", "num_type": "INT", "value": 44},
                       {"name": "sd", "num_type": "FLOAT", "value": 2.4}]}
    jcfg, cfg = j_parse(raw), parse_config(raw)
    jgen = ShardedGeneration(
        JParameterSet.from_specs(jcfg.parameters),
        JTransform(jcfg.parameters), j_dice(max_dice=50), [44.0, 2.4],
        mesh=particle_mesh(jax.devices()[:1]))
    _, jhist = jgen.run_chain(jax.random.PRNGKey(0), sizes, keeps,
                              bucketed_history=True)
    gen = Generation(ParameterSet.from_specs(cfg.parameters),
                     ParameterTransform(cfg.parameters),
                     make_dice_simulator(max_dice=50), [44.0, 2.4],
                     device="cpu", dtype=torch.float64)
    _, hist = gen.run_chain(_g(), sizes, keeps, bucketed_history=True)
    assert _plan(hist) == _plan(jhist) == [("set", 1)] * 5 + [("bucket", 3)]
    for e, je in zip(hist, jhist):
        ys, jys = (e[1], je[1]) if e[0] == "set" else (e[2], je[2])
        assert [tuple(y.shape) for y in ys] == [tuple(y.shape) for y in jys]


def test_bucket_plan_and_planned_replays(monkeypatch):
    quick = [300, 500, 500, 750] + [1000] * 26
    keeps = [round(0.25 * n) for n in quick]
    assert Generation.bucket_plan(quick, keeps) == [
        (0, 1), (1, 1), (2, 1), (3, 1), (4, 1), (5, 25)]
    assert Generation.bucket_plan([400] * 6, [40] * 6) == [(0, 1), (1, 5)]
    gen = _gen()
    assert gen.planned_replays(quick, keeps) == 0        # not capturable
    monkeypatch.setattr(Generation, "capturable", property(lambda s: True))
    assert gen.planned_replays(quick, keeps) == 24
    assert gen.planned_replays([400] * 6, [40] * 6) == 4
    # a bucket of two sets would replay one: below min_replays, none
    assert gen.planned_replays([400] * 3, [40] * 3) == 0


def test_fused_methods_refuse_bad_arguments():
    gen = _gen()
    with pytest.raises(ValueError):
        gen.run_scan(_g(), 100, 10, 0)
    with pytest.raises(ValueError):
        gen.run_chain(_g(), [100, 100], [10])
    with pytest.raises(ValueError):
        gen.run_chain(_g(), [], [])


# ------------------------------------------------------------- the engine
def _engine(cfg, **kw):
    return AbcSmc(cfg, device="cpu", dtype=torch.float64,
                  simulator=make_linear_gaussian_simulator(NPAR, NMET,
                                                           mix=MIX), **kw)


def _run(cfg, seed=5, **kw):
    a = _engine(cfg)
    with redirect_stderr(io.StringIO()) as err:
        a.run_device(seed=seed, **kw)
    a.said = err.getvalue()
    return a


def _phases(a):
    return [e for e in a.timings if e["op"] == "run_device_phases"][-1]


def _assert_runs_equal(a, b):
    assert len(a.particle_parameters) == len(b.particle_parameters) > 0
    for name in ("_particle_parameters", "_particle_metrics",
                 "_predictive_prior", "_weights", "_doubled_variance"):
        for x, y in zip(getattr(a, name), getattr(b, name)):
            np.testing.assert_array_equal(x, y)
    ga, gb = a.storage.read_generations(), b.storage.read_generations()
    assert len(ga) == len(gb)
    for x, y in zip(ga, gb):
        np.testing.assert_array_equal(x.params, y.params)
        np.testing.assert_array_equal(x.seeds, y.seeds)
        np.testing.assert_array_equal(x.metrics, y.metrics)
        np.testing.assert_array_equal(x.posterior_ranks, y.posterior_ranks)


@pytest.mark.parametrize("extra,route", [
    ({"device_dispatch": "sequential"}, "sequential"),
    ({"device_dispatch": "fused"}, "scan"),
    ({"device_dispatch": "auto"}, "sequential"),   # no CUDA step to capture
    ({"row_block": 96}, "sequential"),
    ({"row_block": 96, "device_dispatch": "fused"}, "scan"),
    ({"propose_split": True}, "sequential"),
    ({"propose_split": True, "device_dispatch": "fused"}, "sequential"),
    ({"propose_split": True, "row_block": 128}, "sequential"),
    ({"topk_two_stage": True}, "sequential"),
    ({"noise": "MULTIVARIATE", "device_dispatch": "fused"}, "scan"),
], ids=lambda x: "-".join(f"{k}={v}" for k, v in x.items())
   if isinstance(x, dict) else x)
def test_every_config_key_gives_the_default_store(extra, route):
    base = {k: v for k, v in extra.items() if k == "noise"}
    want = _run(_raw(**base))
    got = _run(_raw(**extra))
    assert _phases(got)["route"] == route
    _assert_runs_equal(got, want)
    sets = 4
    split = bool(extra.get("propose_split"))
    # init, one step per set, and a proposal per set but the last when split
    assert _phases(got)["programs"] == 1 + sets + (sets - 1) * split
    gens = [e for e in got.timings if e["op"] == "device_generation"]
    assert [e["route"] for e in gens] == ["eager"] * sets
    if extra.get("noise") == "MULTIVARIATE":
        assert any(e["mvn_rounds"] >= 1 for e in gens)


def test_varying_sizes_take_the_chain_and_give_the_sequential_store(tmp_path):
    sizes = [300, 500, 500, 750, 1000, 1000, 1000, 1000]
    dbs = {}
    for dispatch in ("sequential", "fused"):
        db = str(tmp_path / f"{dispatch}.sqlite")
        cfg = _raw(num_samples=sizes, smc_iterations=len(sizes),
                   device_dispatch=dispatch, database_filename=db)
        a = _run(cfg)
        a.storage.close()
        dbs[dispatch] = a
        with closing(sqlite3.connect(db)) as con:
            a.rows = con.execute(
                "select smcSet, count(*), sum(status = 'D'), "
                "sum(posterior > -1) from job group by smcSet").fetchall()
    seq, fused = dbs["sequential"], dbs["fused"]
    assert _phases(fused)["route"] == "chain"
    assert fused.rows == seq.rows == [
        (t, n, n, round(n * 0.1)) for t, n in enumerate(sizes)]
    for name in ("_particle_parameters", "_particle_metrics", "_weights"):
        for x, y in zip(getattr(seq, name), getattr(fused, name)):
            np.testing.assert_array_equal(x, y)
    gs = SQLiteStorage(seq.config.database_filename).read_generations()
    gf = SQLiteStorage(fused.config.database_filename).read_generations()
    for x, y in zip(gs, gf):
        np.testing.assert_array_equal(x.params, y.params)
        np.testing.assert_array_equal(x.posterior_ranks, y.posterior_ranks)


def _first_record(cfg, lo, hi):
    """(seed, set, tolerance): a seed whose run has a set in [lo, hi) with
    an NRMSE below every earlier set's, that set, and a tolerance between
    the two, so that a run with it stops exactly after that set (the
    trajectory is noisy: not every seed sets a record there)."""
    from abcsmc_tpu_torch.ops import stats

    for seed in range(5, 15):
        free = _run(dict(cfg, device_dispatch="sequential"), seed=seed)
        obs = torch.as_tensor(free.obs)
        vals = [float(stats.nrmse(torch.as_tensor(m[s]), obs)) for m, s in
                zip(free.particle_metrics, free._predictive_prior)]
        for t in range(lo, hi):
            if vals[t] < min(vals[:t]):
                return seed, t, (vals[t] + min(vals[:t])) / 2
    raise AssertionError("no seed sets an NRMSE record in the range")


def test_tolerance_run_stays_fused_and_matches_sequential():
    cfg = _raw(smc_iterations=10, num_samples=300,
               predictive_prior_fraction=0.5)
    seed, t_cut, tol = _first_record(cfg, 2, 9)
    cfg["nrmse_tolerance"] = tol
    seq = _run(dict(cfg, device_dispatch="sequential"), seed=seed)
    fused = _run(dict(cfg, device_dispatch="fused"), seed=seed)
    assert len(seq._weights) == t_cut + 1 < 10
    assert _phases(fused)["route"] == "scan"
    # the fused route computes every set and cuts afterwards
    assert _phases(fused)["programs"] == 11 > _phases(seq)["programs"]
    assert _phases(fused)["sets"] == t_cut + 1
    _assert_runs_equal(fused, seq)
    assert fused.said.count("Converged: NRMSE") == 1


def test_tolerance_store_truncated_like_sequential(tmp_path):
    cfg = _raw(smc_iterations=10, num_samples=300,
               predictive_prior_fraction=0.5)
    seed, t_cut, tol = _first_record(cfg, 2, 9)
    stores = {}
    for dispatch in ("sequential", "fused"):
        db = str(tmp_path / f"{dispatch}.sqlite")
        a = _run(dict(cfg, nrmse_tolerance=tol, device_dispatch=dispatch,
                      database_filename=db), seed=seed)
        a.storage.close()
        stores[dispatch] = SQLiteStorage(db).read_generations()
    gs, gf = stores["sequential"], stores["fused"]
    assert len(gs) == len(gf) == t_cut + 1
    for x, y in zip(gs, gf):
        assert x.complete and y.complete
        np.testing.assert_array_equal(x.params, y.params)
        np.testing.assert_array_equal(x.metrics, y.metrics)
        np.testing.assert_array_equal(x.posterior_ranks, y.posterior_ranks)
        np.testing.assert_array_equal(x.seeds, y.seeds)


def test_tolerance_cut_mid_bucket_matches_sequential():
    sizes = [200, 300] + [400] * 10
    cfg = _raw(num_samples=sizes, smc_iterations=len(sizes),
               predictive_prior_size=150)
    cfg.pop("predictive_prior_fraction")
    # one keep: sets 2-11 are one bucket; cut strictly inside it
    seed, t_cut, tol = _first_record(cfg, 4, 11)
    cfg["nrmse_tolerance"] = tol
    seq = _run(dict(cfg, device_dispatch="sequential"), seed=seed)
    fused = _run(dict(cfg, device_dispatch="fused"), seed=seed)
    assert 3 < len(seq._weights) == t_cut + 1 < 12
    assert _phases(fused)["route"] == "chain"
    _assert_runs_equal(fused, seq)


def test_programs_count_what_the_host_submitted():
    """One init and one step per set on every route (a graph replay on the
    card stands for a step too): unlike the JAX package's scan programs,
    the count follows the sets, not the size transitions; a tolerance too
    tight to trigger changes nothing."""
    sizes = [200, 300, 300, 400] + [500] * 8
    cfg = _raw(num_samples=sizes, smc_iterations=len(sizes),
               predictive_prior_size=30, nrmse_tolerance=1e-12,
               device_dispatch="fused")
    cfg.pop("predictive_prior_fraction")
    a = _run(cfg)
    assert len(a._weights) == len(sizes)
    ph = _phases(a)
    assert ph["route"] == "chain" and ph["programs"] == len(sizes) + 1
    assert (ph["graph_captures"], ph["graph_replays"]) == (0, 0)
    assert "running the eager chain" not in a.said      # not verbose
    b = _engine(cfg)
    with redirect_stderr(io.StringIO()) as err:
        b.run_device(seed=5, verbose=True)
    assert ("fused dispatch (chain): the step is not capturable (no CUDA "
            "device), running the eager chain") in err.getvalue()


@pytest.mark.parametrize("extra", [{}, {"device_dispatch": "fused"},
                                   {"propose_split": True}],
                         ids=["sequential", "fused", "split"])
def test_mirror_store_false_writes_nothing(tmp_path, extra):
    db = tmp_path / "never.sqlite"
    want = _run(_raw())
    cfg = _raw(database_filename=str(db), **extra)
    a = _run(cfg, mirror_store=False)
    assert not db.exists() or db.stat().st_size == 0
    assert not a.storage.exists()
    for x, y in zip(a.particle_parameters, want.particle_parameters):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a.posterior()[1], want.posterior()[1])
    assert a.said.count("Normalized RMSE for metric means") == 4
    mem = _engine(_raw(), storage=MemoryStorage())
    with redirect_stderr(io.StringIO()):
        mem.run_device(seed=5, mirror_store=False)
    assert mem.storage.read_generations() == []


def test_mirror_notice_from_2_24_rows(monkeypatch):
    import abcsmc_tpu_torch.engine as engine

    monkeypatch.setattr(engine, "_MIRROR_NOTICE_ROWS", 400)
    a = _run(_raw(smc_iterations=2))
    assert a.said.count("mirroring set") == 2
    assert "mirroring set 0: 400 rows into the durable store" in a.said
    assert "mirroring set" not in _run(_raw(smc_iterations=2),
                                       mirror_store=False).said


def test_resume_with_propose_split_gives_the_unsplit_store(tmp_path):
    """A half-simulated store resumed with and without split propose ends
    as the same database (the resumed set ranks from its stored metrics,
    then the engine proposes apart)."""
    dbs = {}
    for split in (False, True):
        db = str(tmp_path / f"resume_{split}.sqlite")
        cfg = _raw(database_filename=db)
        a = _engine(cfg)
        a.build_database(seed=9)
        a.simulate_next_particles(n=150)
        a.storage.close()
        if split:
            cfg["propose_split"] = True
        b = _run(cfg, seed=21)
        assert _phases(b)["route"] == "sequential"
        b.storage.close()
        with closing(sqlite3.connect(db)) as con:
            dbs[split] = (
                con.execute("select smcSet, count(*), sum(status='D'), "
                            "sum(posterior > -1) from job group by smcSet"
                            ).fetchall(),
                con.execute("select * from par order by serial").fetchall(),
                con.execute("select serial, posterior from job order by "
                            "serial").fetchall(),
            )
    assert dbs[False] == dbs[True]
    assert dbs[True][0] == [(t, 400, 400, 40) for t in range(4)]
