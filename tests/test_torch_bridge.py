"""The port's ``HostBridgeSimulator``: a batched black-box host function
inside ``run_device``'s generation step, case by case the counterpart of
tests/test_host_bridge.py, and held against the JAX package's bridge.

- JAX's ``batch_fn`` (an ``io_callback`` under ``jax.jit`` on the CPU) and
  the port's give the same metrics from the same numpy params and seeds,
  and the host function sees the same dtypes (the step's float, uint32
  seeds);
- ``run_device`` runs the device step with the bridge (never the host
  engine), and ``run()`` runs the host engine with it;
- a bridged step equals, bit for bit in float64, the step of a torch
  ``DeviceSimulator`` computing the same function on the same draws:
  resident, chunked (``row_block``: one host call per block) and on a
  4-shard mesh (one host call per shard, every row once);
- the fused route stores the sequential rows with no capture; the bridge's
  capture flag keeps ``capturable`` and ``planned_replays`` at no;
- a projection through the bridge equals the device-simulator projection;
- a mid-set resume sends only the rows not yet done through the bridge.
"""

import io
from contextlib import redirect_stderr

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from abcsmc_tpu.models.simulators import DeviceSimulator as JDeviceSimulator
from abcsmc_tpu.models.simulators import HostBridgeSimulator as JBridge
from abcsmc_tpu_torch import AbcSmc
from abcsmc_tpu_torch.bench import results_bit_equal
from abcsmc_tpu_torch.config import parse_config
from abcsmc_tpu_torch.engine import _AUTO_MIN_REPLAYS
from abcsmc_tpu_torch.models.parameters import ParameterSet
from abcsmc_tpu_torch.models.simulators import (
    DeviceSimulator, HostBridgeSimulator,
)
from abcsmc_tpu_torch.models.transforms import ParameterTransform
from abcsmc_tpu_torch.parallel import particle_mesh
from abcsmc_tpu_torch.parallel.generation import Generation
from abcsmc_tpu_torch.storage import MemoryStorage, SQLiteStorage

F64 = torch.float64
NPAR, NMET = 3, 5
OBS = np.array([0.95, 0.12, -0.2, 0.56, 0.61])


def _quiet(fn, *args, **kwargs):
    with redirect_stderr(io.StringIO()) as err:
        out = fn(*args, **kwargs)
    return out, err.getvalue()


def host_dice(params, seeds):
    """Numpy dice simulator (batched, host-side), as in
    tests/test_host_bridge.py."""
    out = np.zeros((len(params), 2))
    for i, (row, seed) in enumerate(zip(params, seeds)):
        rng = np.random.default_rng(int(seed))
        n = max(int(row[0]), 1)
        m = max(int(row[1]), 1)
        rolls = rng.integers(1, m + 1, n)
        out[i] = [rolls.sum(), rolls.std(ddof=1) if n > 1 else 0.0]
    return out


def dice_cfg(n=64, **extra):
    return {
        "smc_iterations": 3,
        "num_samples": n,
        "predictive_prior_fraction": 0.25,
        "parameters": [
            {"name": "ndice", "dist_type": "UNIFORM", "num_type": "INT",
             "par1": 1, "par2": 50},
            {"name": "sides", "dist_type": "UNIFORM", "num_type": "INT",
             "par1": 1, "par2": 50},
        ],
        "metrics": [
            {"name": "sum", "num_type": "INT", "value": 44},
            {"name": "sd", "num_type": "FLOAT", "value": 2.39925},
        ],
        **extra,
    }


# The same function twice: numpy for the bridge, torch for a device
# simulator. Elementwise IEEE operations and an integer seed term only, so
# the two agree bit for bit.
def np_fn(params, seeds):
    s = (np.asarray(seeds).astype(np.int64) % 997).astype(params.dtype) / 997
    p0, p1, p2 = params[:, 0], params[:, 1], params[:, 2]
    return np.stack([p0 + 0.5 * p1 + 0.1 * s, p1 * p2 - 0.05 * s,
                     p0 - p2 + 0.2 * s, p0 * p0 + p1, p2 + 0.3 * s * p0], 1)


def torch_fn(params, seeds):
    s = (seeds.to(torch.int64) % 997).to(params.dtype) / 997
    p0, p1, p2 = params[:, 0], params[:, 1], params[:, 2]
    return torch.stack([p0 + 0.5 * p1 + 0.1 * s, p1 * p2 - 0.05 * s,
                        p0 - p2 + 0.2 * s, p0 * p0 + p1, p2 + 0.3 * s * p0],
                       1)


class Recorder:
    """A host function that records each call's dtypes and rows."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, params, seeds):
        self.calls.append((params.dtype, seeds.dtype, np.array(params),
                           np.array(seeds)))
        return self.fn(params, seeds)


def lin_raw(**extra):
    return {
        "smc_iterations": 3, "num_samples": 300,
        "predictive_prior_fraction": 0.1,
        "parameters": [
            {"name": f"p{i}", "dist_type": "UNIFORM", "num_type": "FLOAT",
             "par1": 0.0, "par2": 1.0} for i in range(NPAR)],
        "metrics": [
            {"name": f"m{j}", "num_type": "FLOAT", "value": float(OBS[j])}
            for j in range(NMET)],
        **extra,
    }


def _gen(simulator, **kw):
    cfg = parse_config(lin_raw())
    where = kw.pop("mesh", None)
    return Generation(
        ParameterSet.from_specs(cfg.parameters),
        ParameterTransform(cfg.parameters), simulator, OBS,
        **({"mesh": where} if where else {"device": "cpu"}),
        dtype=F64, **kw)


def _two_sets(gen, n=300, keep=30, seed=3):
    """Two sets of the engine's loop: init, then draw_step and step per
    set from one generator."""
    g = torch.Generator().manual_seed(seed)
    params, seeds = gen.init_population(g, n)
    state, out = None, []
    for _ in range(2):
        res = gen.step(params, seeds, keep, n, gen.draw_step(g, n), state,
                       n_valid=n)
        out.append(res)
        state = (res.survivor_params, res.weights, res.doubled_variance)
        params, seeds = res.next_params, res.next_seeds
    return out


# ------------------------------------------------------- against JAX's
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_batch_fn_matches_jax_bridge(dtype):
    rng = np.random.default_rng(0)
    params = rng.uniform(0, 1, (40, NPAR)).astype(dtype)
    seeds = rng.integers(0, 2**31 - 1, 40)
    jrec, rec = Recorder(np_fn), Recorder(np_fn)
    jsim = JBridge(jrec, nmet=NMET)
    want = np.asarray(jax.jit(jsim.batch_fn)(
        jnp.asarray(params), jnp.asarray(seeds, jnp.uint32)))
    got = HostBridgeSimulator(rec, NMET).batch_fn(
        torch.from_numpy(params), torch.from_numpy(seeds))
    assert got.dtype == getattr(torch, dtype) and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    (jp, js, jpv, jsv), = jrec.calls
    (p, s, pv, sv), = rec.calls
    assert (p, s) == (jp, js) == (np.dtype(dtype), np.dtype(np.uint32))
    np.testing.assert_array_equal(pv, jpv)
    np.testing.assert_array_equal(sv, jsv)


def test_run_batch_is_float64_as_in_jax():
    rng = np.random.default_rng(1)
    params = rng.uniform(0, 1, (7, NPAR)).astype(np.float32)
    seeds = rng.integers(0, 2**31 - 1, 7)
    want = JBridge(np_fn, nmet=NMET).run_batch(params, seeds, np.arange(7))
    got = HostBridgeSimulator(np_fn, NMET).run_batch(
        params, seeds, np.arange(7), device="cpu", dtype=torch.float32)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)


def test_bridge_is_outside_the_package_exports_as_in_jax():
    import abcsmc_tpu
    import abcsmc_tpu.models
    import abcsmc_tpu_torch
    import abcsmc_tpu_torch.models

    for mod in (abcsmc_tpu, abcsmc_tpu.models, abcsmc_tpu_torch,
                abcsmc_tpu_torch.models):
        assert "HostBridgeSimulator" not in mod.__all__, mod.__name__
    # both are device simulators: that routes them to the device step
    assert issubclass(HostBridgeSimulator, DeviceSimulator)
    assert issubclass(JBridge, JDeviceSimulator)


def test_batch_fn_refuses_a_wrong_metric_shape():
    from abcsmc_tpu_torch.errors import SimulatorError

    sim = HostBridgeSimulator(lambda p, s: np.zeros((len(p), 2)), nmet=3)
    with pytest.raises(SimulatorError, match="shape"):
        sim.batch_fn(torch.zeros((4, 2)), torch.arange(4))


# ------------------------------------------- tests/test_host_bridge.py
def test_host_bridge_in_device_loop(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the bridge must not run the host engine")

    monkeypatch.setattr(AbcSmc, "run", refuse)
    rec = Recorder(host_dice)
    sim = HostBridgeSimulator(rec, nmet=2)
    abc = AbcSmc(dice_cfg(), simulator=sim, storage=MemoryStorage(),
                 device="cpu")
    _quiet(abc.run_device, seed=4)
    pars, w = abc.posterior()
    assert pars.shape == (16, 2)
    assert np.all(np.isfinite(w))
    assert np.all(np.isfinite(abc._particle_metrics[0]))
    gen0_pars = abc._particle_parameters[0]
    assert np.all(gen0_pars == np.round(gen0_pars))
    # the step's dtype (float32 by default) and uint32 seeds, one call a set
    assert [(c[0], c[1]) for c in rec.calls] == \
        [(np.dtype(np.float32), np.dtype(np.uint32))] * 3
    phases = [e for e in abc.timings if e["op"] == "run_device_phases"][-1]
    assert (phases["route"], phases["graph_captures"]) == ("sequential", 0)


def test_host_bridge_host_path_too():
    sim = HostBridgeSimulator(host_dice, nmet=2)
    abc = AbcSmc(dice_cfg(n=30), simulator=sim, storage=MemoryStorage(),
                 device="cpu")
    _quiet(abc.run, seed=5)
    pars, _ = abc.posterior()
    assert pars.shape[0] == 8  # round(0.25 * 30)


# ------------------------------------------------------- the step
def test_bridged_step_equals_device_simulator_step():
    rec = Recorder(np_fn)
    got = _two_sets(_gen(HostBridgeSimulator(rec, NMET)))
    want = _two_sets(_gen(DeviceSimulator(torch_fn, NMET)))
    for a, b in zip(got, want):
        assert results_bit_equal(a, b) == []
    assert int(want[-1].ncomp_used) >= 1
    assert [len(c[2]) for c in rec.calls] == [300, 300]


def test_chunked_bridge_is_one_call_per_block():
    rec = Recorder(np_fn)
    chunked = _two_sets(_gen(HostBridgeSimulator(rec, NMET), row_block=96))
    dev = _two_sets(_gen(DeviceSimulator(torch_fn, NMET), row_block=96))
    resident = _two_sets(_gen(HostBridgeSimulator(np_fn, NMET)))
    for a, b, r in zip(chunked, dev, resident):
        assert results_bit_equal(a, b) == []
        # a row's metrics are its own: the blocks change none of them;
        # the rest agrees with the resident step up to the order of sums
        assert torch.equal(a.metrics, r.metrics)
        assert torch.equal(a.survivor_idx, r.survivor_idx)
        assert int(a.ncomp_used) == int(r.ncomp_used)
        torch.testing.assert_close(a.weights, r.weights, rtol=1e-9,
                                   atol=0)
    assert [len(c[2]) for c in rec.calls] == [96, 96, 96, 12] * 2


def test_mesh_bridge_runs_each_row_once_per_shard():
    rec = Recorder(np_fn)
    mesh = particle_mesh(["cpu"] * 4)
    got = _two_sets(_gen(HostBridgeSimulator(rec, NMET), mesh=mesh),
                    n=96, keep=12)
    want = _two_sets(_gen(DeviceSimulator(torch_fn, NMET), mesh=mesh),
                     n=96, keep=12)
    for a, b in zip(got, want):
        assert results_bit_equal(a, b) == []
    # one call per shard and set, in shard order: every row once
    assert [len(c[2]) for c in rec.calls] == [24] * 8
    for t, res in enumerate(got):
        calls = rec.calls[4 * t:4 * t + 4]
        np.testing.assert_array_equal(
            np.concatenate([np_fn(c[2], c[3]) for c in calls]),
            torch.cat(res.metrics).numpy())


def test_capture_flag_keeps_bridged_steps_eager(monkeypatch):
    sizes, keeps = [300] * 6, [30] * 6
    bridged = _gen(HostBridgeSimulator(np_fn, NMET))
    device = _gen(DeviceSimulator(torch_fn, NMET))
    assert not HostBridgeSimulator.capturable and DeviceSimulator.capturable
    assert bridged.capture_blocker() == device.capture_blocker() \
        == "no CUDA device"
    # as on a card: only the simulator's round trip blocks the capture,
    # and a step without the simulator (capture_precomputed) still may
    for gen in (bridged, device):
        monkeypatch.setattr(gen, "device", torch.device("cuda"))
    assert bridged.capture_blocker() == \
        "the simulator makes a host round trip"
    assert bridged.capture_blocker(with_simulator=False) is None
    assert not bridged.capturable and device.capturable
    assert bridged.planned_replays(sizes, keeps) == 0
    assert device.planned_replays(sizes, keeps) == 4 >= _AUTO_MIN_REPLAYS


# ------------------------------------------------------- the engine
def _lin_run(simulator, seed=5, **extra):
    a = AbcSmc(lin_raw(**extra), device="cpu", dtype=F64,
               simulator=simulator)
    _, a.said = _quiet(a.run_device, seed=seed, verbose=True)
    return a


def _assert_runs_equal(a, b):
    for name in ("_particle_parameters", "_particle_metrics",
                 "_predictive_prior", "_weights", "_doubled_variance"):
        for x, y in zip(getattr(a, name), getattr(b, name)):
            np.testing.assert_array_equal(x, y)
    ga, gb = a.storage.read_generations(), b.storage.read_generations()
    assert len(ga) == len(gb) == 3
    for x, y in zip(ga, gb):
        for f in ("params", "seeds", "metrics", "posterior_ranks"):
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f))


def test_fused_dispatch_stores_the_sequential_rows():
    seq = _lin_run(HostBridgeSimulator(np_fn, NMET),
                   device_dispatch="sequential")
    fused = _lin_run(HostBridgeSimulator(np_fn, NMET),
                     device_dispatch="fused")
    dev = _lin_run(DeviceSimulator(torch_fn, NMET),
                   device_dispatch="sequential")
    _assert_runs_equal(fused, seq)
    _assert_runs_equal(seq, dev)
    ph = [e for e in fused.timings if e["op"] == "run_device_phases"][-1]
    assert ph["route"] == "scan"
    assert (ph["graph_captures"], ph["graph_replays"]) == (0, 0)
    assert "the step is not capturable (no CUDA device)" in fused.said


def test_projection_through_the_bridge_equals_device_projection(tmp_path):
    grid = [
        {"name": "a", "dist_type": "PSEUDO", "num_type": "INT",
         "par1": 1, "par2": 3},
        {"name": "b", "dist_type": "PSEUDO", "num_type": "FLOAT",
         "vals": [0.5, 1.5]},
    ]
    mets = [{"name": "m1", "num_type": "FLOAT", "value": 0},
            {"name": "m2", "num_type": "FLOAT", "value": 0}]
    stores = {}
    for name, sim in (
            ("bridge", HostBridgeSimulator(lambda p, s: p[:, :2] * 2.0, 2)),
            ("device", DeviceSimulator(lambda p, s: p[:, :2] * 2.0, 2))):
        db = str(tmp_path / f"{name}.sqlite")
        abc = AbcSmc({"database_filename": db, "parameters": grid,
                      "metrics": mets}, device="cpu", dtype=F64,
                     simulator=sim)
        _quiet(abc.run_device, seed=0)
        abc.storage.close()
        stores[name] = SQLiteStorage(db).read_generations()
    (b,), (d,) = stores["bridge"], stores["device"]
    assert b.size == 6 and np.all(b.statuses == "D")
    np.testing.assert_array_equal(b.params, d.params)
    np.testing.assert_array_equal(b.metrics, d.metrics)
    np.testing.assert_array_equal(b.metrics, 2.0 * b.params)


@pytest.mark.parametrize("done", [0, 150])
def test_mid_set_resume_simulates_only_the_rows_not_done(tmp_path, done):
    db = str(tmp_path / "resume.sqlite")
    cfg = lin_raw(database_filename=db)
    first = AbcSmc(cfg, device="cpu", dtype=F64,
                   simulator=HostBridgeSimulator(np_fn, NMET))
    first.build_database(seed=1)
    if done:
        first.simulate_next_particles(done)      # run_batch, float64
    before = first.storage.read_generations()[0]
    first.storage.close()
    rec = Recorder(np_fn)
    r = AbcSmc(cfg, device="cpu", dtype=F64,
               simulator=HostBridgeSimulator(rec, NMET))
    _quiet(r.run_device, seed=2)
    r.storage.close()
    after = SQLiteStorage(db).read_generations()
    assert [(g.size, bool(np.all(g.statuses == "D"))) for g in after] == \
        [(300, True)] * 3
    was_done = before.statuses == "D"
    assert int(was_done.sum()) == done
    np.testing.assert_array_equal(after[0].metrics[was_done],
                                  before.metrics[was_done])
    # the first host call is the resumed set's rows not yet done, no more
    np.testing.assert_array_equal(rec.calls[0][3],
                                  before.seeds[~was_done].astype(np.uint32))
    assert [len(c[2]) for c in rec.calls] == [300 - done, 300, 300]
    replay = np_fn(after[0].params, after[0].seeds)
    np.testing.assert_array_equal(after[0].metrics, replay)
