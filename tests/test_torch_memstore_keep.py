"""The port's MemoryStorage keeps the columns that
``insert_generation_complete`` is given, instead of copying them: the
block's params, upars, seeds, metrics and ranks are the caller's arrays,
read-only but for the ranks; a column that cannot be kept is copied and
counted in ``copied_bytes``; the metrics still pass through
``write_results``. On the CPU, ``run_device`` hands the store its posterior
state whole: ``store_copied_bytes`` reads 0 on both routes, the store reads
back the engine's arrays bit for bit, and a snapshot gives the rows of a
store that copies."""

import io
import sqlite3
from contextlib import closing, redirect_stderr

import numpy as np
import pytest
import torch

from abcsmc_tpu_torch import AbcSmc
from abcsmc_tpu_torch.models.simulators import make_linear_gaussian_simulator
from abcsmc_tpu_torch.storage import MemoryStorage, SQLiteStorage
from abcsmc_tpu_torch.storage.base import Storage

PARS, METS = ["p1", "p2", "p3"], ["m1", "m2"]
N = 6


def _columns(t=0):
    """A set's columns as the engine's mirror hands them over."""
    rng = np.random.default_rng(40 + t)
    params = rng.random((N, len(PARS)))
    ranks = np.full(N, -1, np.int64)
    ranks[[4, 1]] = [0, 1]
    return {"params": params, "upars": np.exp(params),
            "seeds": np.arange(N, dtype=np.uint64) + np.uint64(100 * t),
            "metrics": rng.random((N, len(METS))), "ranks": ranks}


def _insert(st, c, set_num=0):
    return st.insert_generation_complete(set_num, c["params"], c["seeds"],
                                         c["metrics"], c["upars"],
                                         c["ranks"])


def _store():
    st = MemoryStorage()
    st.create(PARS, METS, True)
    return st


def test_the_block_is_the_callers_columns():
    st, c = _store(), _columns()
    _insert(st, c)
    b = st._blocks[0]
    for name, kept in (("params", b.params), ("upars", b.upars),
                       ("seeds", b.seeds), ("metrics", b.metrics),
                       ("ranks", b.posterior)):
        assert kept is c[name], name
        assert np.shares_memory(kept, c[name]), name
    assert st.copied_bytes == 0
    assert (st.read_generations()[0].statuses == "D").all()


@pytest.mark.parametrize("name", ["params", "upars", "seeds", "metrics"])
def test_kept_columns_are_read_only(name):
    st, c = _store(), _columns()
    _insert(st, c)
    assert not c[name].flags.writeable
    with pytest.raises(ValueError, match="read-only"):
        c[name][0] = 1


def test_kept_ranks_stay_writable_for_write_posterior_ranks():
    st, c = _store(), _columns()
    _insert(st, c)
    assert c["ranks"].flags.writeable
    st.write_posterior_ranks([0, 1], [3, 2])
    np.testing.assert_array_equal(st.read_generations()[0].posterior_ranks,
                                  [3, 2, -1, -1, 0, -1])
    assert st._blocks[0].posterior is c["ranks"]
    assert st.copied_bytes == 0


UNKEPT = {
    # column: (what the caller hands over instead, bytes the store copies)
    "params": (lambda x: x.astype(np.float32), N * len(PARS) * 8),
    "upars": (lambda x: np.asfortranarray(x), N * len(PARS) * 8),
    "seeds": (lambda x: x.astype(np.int64), N * 8),
    "metrics": (lambda x: np.repeat(x, 2, axis=1)[:, ::2], N * len(METS) * 8),
    "ranks": (lambda x: x.tolist(), N * 8),
    "read_only_ranks": (lambda x: x.copy(), N * 8),
}


def test_adoptable_columns_copy_nothing():
    st = _store()
    for t in range(3):
        _insert(st, _columns(t), t)
    assert st.copied_bytes == 0


@pytest.mark.parametrize("case", UNKEPT)
def test_a_column_that_cannot_be_kept_is_copied_and_counted(case):
    st, c = _store(), _columns()
    name = "ranks" if case == "read_only_ranks" else case
    given, nbytes = UNKEPT[case]
    c[name] = given(c[name])
    if case == "read_only_ranks":
        c[name].setflags(write=False)
    _insert(st, c)
    assert st.copied_bytes == nbytes
    b = st._blocks[0]
    kept = {"params": b.params, "upars": b.upars, "seeds": b.seeds,
            "metrics": b.metrics, "ranks": b.posterior}[name]
    assert kept is not c[name]
    # a copy is the store's own: no caller holds it
    assert kept.flags.c_contiguous and kept.flags.writeable
    np.testing.assert_array_equal(kept, np.asarray(c[name], kept.dtype))


def test_insert_generation_copies_and_counts_every_column():
    st, c = _store(), _columns()
    st.insert_generation(0, c["params"], c["seeds"], c["upars"], c["ranks"])
    assert st.copied_bytes == sum(c[k].nbytes for k in
                                  ("params", "upars", "seeds", "ranks"))
    assert c["params"].flags.writeable
    st.write_results(np.arange(N), c["metrics"], np.zeros(N), np.zeros(N))
    # a whole new block's first write keeps its metrics
    assert st._blocks[0].metrics is c["metrics"]


def test_a_write_into_a_kept_metrics_column_copies_it_first():
    st, c = _store(), _columns()
    given = c["metrics"].copy()
    _insert(st, c)
    st.claim_jobs(serial_req=2)
    assert st.write_results([2], [[7.0, 8.0]], [1], [0.5]) == 1
    np.testing.assert_array_equal(c["metrics"], given)
    got = st.read_generations()[0].metrics
    given[2] = [7.0, 8.0]
    np.testing.assert_array_equal(got, given)
    assert st.copied_bytes == given.nbytes


@pytest.mark.parametrize("short", ["seeds", "metrics", "upars", "ranks"])
def test_a_short_column_raises_before_anything_is_written(short):
    st, c = _store(), _columns()
    c[short] = c[short][:-1]
    with pytest.raises(IndexError, match=short):
        _insert(st, c)
    assert st.is_empty() and st.read_generations() == []
    assert all(x.flags.writeable for x in c.values())


def test_a_patched_write_results_sees_the_metrics(monkeypatch):
    """The shape of the benchmark's planted store fault: a replaced
    ``write_results`` that alters the metrics it is handed."""
    seen = []
    orig = MemoryStorage.write_results

    def patched(self, serials, metrics, *args, **kwargs):
        metrics = np.array(metrics, np.float64)
        metrics[0, 0] += 1.0
        seen.append(np.asarray(serials).copy())
        return orig(self, serials, metrics, *args, **kwargs)

    monkeypatch.setattr(MemoryStorage, "write_results", patched)
    st, c = _store(), _columns()
    _insert(st, c)
    _insert(st, _columns(1), 1)
    assert [s.tolist() for s in seen] == [list(range(N)),
                                          list(range(N, 2 * N))]
    got = st.read_generations()[0].metrics
    assert got[0, 0] == c["metrics"][0, 0] + 1.0
    np.testing.assert_array_equal(got[1:], c["metrics"][1:])


# ------------------------------------------------------------ the engine
NPAR, NMET = 3, 5
MIX = np.random.default_rng(7).normal(size=(NPAR, NMET))
OBS = np.array([0.3, 0.7, 0.5]) @ MIX


def _raw(**extra):
    return {
        "smc_iterations": 3, "num_samples": 400,
        "predictive_prior_fraction": 0.1,
        "parameters": [
            {"name": f"p{i}", "dist_type": "UNIFORM", "num_type": "FLOAT",
             "par1": 0.0, "par2": 1.0} for i in range(NPAR)],
        "metrics": [
            {"name": f"m{j}", "num_type": "FLOAT", "value": float(OBS[j])}
            for j in range(NMET)],
        **extra,
    }


def _run(cfg, storage=None):
    a = AbcSmc(cfg, device="cpu", dtype=torch.float64, storage=storage,
               simulator=make_linear_gaussian_simulator(NPAR, NMET, mix=MIX))
    with redirect_stderr(io.StringIO()):
        a.run_device(seed=5)
    return a


def _phases(a):
    return [e for e in a.timings if e["op"] == "run_device_phases"][-1]


class _CopyingStore(MemoryStorage):
    """The memory store as the interface's default insert drives it: an
    ``insert_generation`` that copies, then ``write_results``."""

    insert_generation_complete = Storage.insert_generation_complete


@pytest.mark.parametrize("dispatch,route", [("sequential", "sequential"),
                                            ("fused", "scan")])
def test_run_device_hands_the_store_its_posterior_state(dispatch, route):
    a = _run(_raw(device_dispatch=dispatch))
    assert _phases(a)["route"] == route
    assert _phases(a)["store_copied_bytes"] == 0
    gens = a.storage.read_generations()
    assert len(gens) == len(a.particle_parameters) == 3
    for t, g in enumerate(gens):
        pars, mets = a.particle_parameters[t], a.particle_metrics[t]
        np.testing.assert_array_equal(g.params, pars)
        np.testing.assert_array_equal(g.metrics, mets)
        np.testing.assert_array_equal(g.predictive_prior_indices(),
                                      a._predictive_prior[t])
        assert (g.statuses == "D").all()
        assert not pars.flags.writeable and not mets.flags.writeable
        assert a.storage._blocks[t].params is pars
        assert a.storage._blocks[t].metrics is mets


@pytest.mark.parametrize("dispatch", ["sequential", "fused"])
def test_snapshot_gives_the_rows_of_a_store_that_copies(tmp_path, dispatch):
    cfg = _raw(device_dispatch=dispatch)
    kept, copied = _run(cfg), _run(cfg, _CopyingStore())
    assert _phases(kept)["store_copied_bytes"] == 0
    # params, seeds and ranks a set, 400 rows each
    assert _phases(copied)["store_copied_bytes"] == 3 * 400 * (NPAR + 2) * 8
    rows = []
    for a, name in ((kept, "kept"), (copied, "copied")):
        path = str(tmp_path / f"{name}.sqlite")
        a.storage.snapshot_to(SQLiteStorage(path)).close()
        with closing(sqlite3.connect(path)) as con:
            rows.append({
                table: con.execute(f"select * from {table} order by serial"
                                   ).fetchall()
                for table in ("par", "met")})
            cur = con.execute("select * from job order by serial")
            names = [d[0] for d in cur.description]
            rows[-1]["job"] = [
                tuple(v for n, v in zip(names, row) if n != "startTime")
                for row in cur.fetchall()]
    assert len(rows[0]["job"]) == 3 * 400
    assert rows[0] == rows[1]
