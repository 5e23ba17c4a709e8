"""The port's host engine (build / process / simulate over the run store,
the --all loop, resume) and its CLI, held against the JAX engine on the CPU.

Tolerances: at float64 the port's brain reproduces the JAX brain's survivor
indices exactly (tie-free continuous metrics) and its weights and doubled
variances at rtol 1e-8 (the kernel-mixture logsumexp sums in another
order). Runs that draw from the generators agree in law only; they are held
to the truth of the conjugate-Gaussian model instead (posterior mean within
0.5 of (2.0, 1.5), the bound of tests/test_engine_e2e.py)."""

import io
import json
import shutil
import sqlite3
import subprocess
import sys
from contextlib import closing, redirect_stderr
from pathlib import Path

import numpy as np
import pytest
import torch

from abcsmc_tpu import AbcSmc as JAbcSmc
from abcsmc_tpu.cli import main as jmain
from abcsmc_tpu_torch import AbcSmc
from abcsmc_tpu_torch.cli import main
from abcsmc_tpu_torch.errors import SimulatorError, StorageError
from abcsmc_tpu_torch.models.simulators import PySimulator
from abcsmc_tpu_torch.storage import MemoryStorage, SQLiteStorage

REPO = Path(__file__).resolve().parents[1]
F64 = torch.float64


def _cfg(db="", sets=3, n=400, **extra):
    return {
        "smc_iterations": sets, "num_samples": n,
        "predictive_prior_fraction": 0.1, "simulator": "gaussian",
        "database_filename": db,
        "parameters": [
            {"name": "mu", "dist_type": "UNIFORM", "num_type": "FLOAT",
             "par1": 0.0, "par2": 5.0},
            {"name": "sigma", "dist_type": "UNIFORM", "num_type": "FLOAT",
             "par1": 0.1, "par2": 5.0},
        ],
        "metrics": [
            {"name": "mean", "num_type": "FLOAT", "value": 2.0},
            {"name": "sd", "num_type": "FLOAT", "value": 1.5},
        ],
        **extra,
    }


def _port(cfg, **kw):
    return AbcSmc(cfg, device="cpu", dtype=F64, **kw)


def _rows(db):
    with closing(sqlite3.connect(db)) as con:
        return con.execute(
            "select smcSet, count(*), sum(status = 'D'), sum(posterior > -1)"
            " from job group by smcSet order by smcSet").fetchall()


def _schema(db):
    with closing(sqlite3.connect(db)) as con:
        return con.execute(
            "select name, sql from sqlite_master where type in "
            "('table', 'index', 'view') order by name").fetchall()


def _quiet(fn, *args, **kwargs):
    with redirect_stderr(io.StringIO()) as err:
        out = fn(*args, **kwargs)
    return out, err.getvalue()


def _near_truth(abc):
    pars, w = abc.posterior()
    assert np.isfinite(pars).all() and np.isfinite(w).all()
    assert float(np.linalg.norm(w)) == pytest.approx(1.0, abs=1e-9)
    w = w / w.sum()
    assert abs(float(pars[:, 0] @ w) - 2.0) < 0.5
    assert abs(float(pars[:, 1] @ w) - 1.5) < 0.5


# -------------------------------------------------------------- host loop
@pytest.mark.parametrize("store", ["memory", "sqlite"])
def test_host_loop_end_to_end(store, tmp_path):
    db = str(tmp_path / "port.sqlite") if store == "sqlite" else ""
    a, text = _quiet(_port(_cfg(db)).run, seed=3)
    _near_truth(a)
    gens = a.storage.read_generations()
    assert [(g.size, int(g.complete), len(g.predictive_prior_indices()))
            for g in gens] == [(400, 1, 40)] * 3
    assert text.count("Normalized RMSE for metric means") == 3
    assert "Database already contains 3 complete sets." in text
    ops = [e["op"] for e in a.timings]
    assert ops.count("process") == 3 and ops.count("simulate") == 3
    assert [e["ncomp_used"] for e in a.timings if e["op"] == "rank"] == \
        [2, 2, 2]
    if store == "memory":
        assert isinstance(a.storage, MemoryStorage)
        return
    jdb = str(tmp_path / "jax.sqlite")
    j, _ = _quiet(JAbcSmc(_cfg(jdb)).run, seed=3)
    _near_truth(j)
    assert _schema(db) == _schema(jdb)
    assert _rows(db) == _rows(jdb) == [(t, 400, 400, 40) for t in range(3)]


def test_host_loop_nrmse_stop_and_multivariate_noise(tmp_path):
    a, text = _quiet(_port(_cfg(sets=4, nrmse_tolerance=10.0)).run, seed=1)
    assert len(a.storage.read_generations()) == 1
    assert "stopping early" in text
    b, text = _quiet(_port(_cfg(noise="MULTIVARIATE")).run, seed=2,
                     verbose=True)
    assert "MULTIVARIATE noising" in text
    _near_truth(b)


def test_process_database_reads_a_jax_written_store(tmp_path):
    """A store the JAX engine wrote: the port's brain reproduces the JAX
    brain's survivors and weights, then run_device finishes the run."""
    base = tmp_path / "jax.sqlite"
    cfg = _cfg(str(base), sets=4)
    j = JAbcSmc(cfg)
    with redirect_stderr(io.StringIO()):
        j.process_database(seed=1)           # set 0 queued
        j.simulate_next_particles(-1)
        j.process_database(seed=2)           # set 0 ranked, set 1 queued
        j.simulate_next_particles(-1)        # set 1 complete, unranked
    j.storage.close()
    a, b = tmp_path / "a.sqlite", tmp_path / "b.sqlite"
    shutil.copy(base, a)
    shutil.copy(base, b)

    # the port ranks set 1 itself, as the JAX brain does on its own copy
    ja = JAbcSmc(_cfg(str(a), sets=4))
    _quiet(ja.process_database, seed=3)      # set 1 ranked, set 2 queued
    tb = _port(_cfg(str(b), sets=4))
    _quiet(tb.process_database, seed=3)
    for t in range(2):
        np.testing.assert_array_equal(tb._predictive_prior[t],
                                      ja._predictive_prior[t])
        np.testing.assert_allclose(tb._weights[t], ja._weights[t], rtol=1e-8)
        np.testing.assert_allclose(tb._doubled_variance[t],
                                   ja._doubled_variance[t], rtol=1e-8)
    ja.storage.close()

    # the JAX store with two complete sets and one queued: the port reads
    # the stored ranks, computes the same weights, and finishes the run
    ta = _port(_cfg(str(a), sets=4))
    done, text = _quiet(ta.process_database, seed=5)
    assert done is False and "not all particles are complete in set 2" in text
    for t in range(2):
        np.testing.assert_array_equal(ta._predictive_prior[t],
                                      ja._predictive_prior[t])
        np.testing.assert_allclose(ta._weights[t], ja._weights[t], rtol=1e-8)
    _quiet(_port(_cfg(str(a), sets=4)).run_device, seed=6)
    assert _rows(str(a)) == [(t, 400, 400, 40) for t in range(4)]


@pytest.mark.parametrize("done", [0, 150, 400])
def test_run_device_resumes_a_store(done, tmp_path):
    """Mid-set (some or none of set 0 simulated) and at a set boundary (all
    of set 0, unranked): the rows already 'D' keep their metrics, the others
    replay from their stored seeds exactly as the host path computes them."""
    db = str(tmp_path / "resume.sqlite")
    cfg = _cfg(db, sets=3)
    p = _port(cfg)
    p.build_database(seed=1)
    if done:
        p.simulate_next_particles(done)
    before = p.storage.read_generations()[0]
    p.storage.close()
    r, _ = _quiet(_port(cfg).run_device, seed=2)
    assert _rows(db) == [(t, 400, 400, 40) for t in range(3)]
    after = SQLiteStorage(db).read_generations()[0]
    was_done = before.statuses == "D"
    assert was_done.sum() == done
    np.testing.assert_array_equal(after.metrics[was_done],
                                  before.metrics[was_done])
    replay = r.simulator.run_batch(after.params, after.seeds, after.serials,
                                   device="cpu", dtype=F64)
    np.testing.assert_array_equal(after.metrics, replay)
    phases = [e for e in r.timings if e["op"] == "run_device_phases"]
    assert phases[-1]["first_set"] == (1 if done == 400 else 0)
    _near_truth(r)


def test_run_device_hands_a_host_simulator_to_run(tmp_path):
    def gauss(pars, seed, serial):
        x = np.random.default_rng(seed).normal(pars[0], abs(pars[1]), 100)
        return [x.mean(), x.std(ddof=1)]

    a = _port(_cfg(str(tmp_path / "py.sqlite")), simulator=PySimulator(gauss))
    _, text = _quiet(a.run_device, seed=4, verbose=True)
    assert "falling back to host engine" in text
    assert _rows(str(tmp_path / "py.sqlite")) == \
        [(t, 400, 400, 40) for t in range(3)]
    _near_truth(a)


# ------------------------------------------------------- queue semantics
def test_at_least_once_reclaim_and_by_serial(tmp_path):
    db = str(tmp_path / "claims.sqlite")
    a = _port(_cfg(db, sets=1, n=10))
    assert a.build_database(seed=0) is True
    store = a.storage
    dead = store.claim_jobs(4)                 # a worker claims and dies
    assert list(dead.serials) == [0, 1, 2, 3]
    a.simulate_next_particles(-1)              # re-claims the 'R' rows
    with closing(sqlite3.connect(db)) as con:
        att = dict(con.execute("select serial, attempts from job"))
        assert con.execute("select count(*) from job where status = 'D'"
                           ).fetchone()[0] == 10
    assert [att[s] for s in range(10)] == [2] * 4 + [1] * 6
    before = store.read_generations()[0].metrics
    a.simulate_particle_by_serial(3)           # first write wins
    np.testing.assert_array_equal(store.read_generations()[0].metrics, before)
    with closing(sqlite3.connect(db)) as con:
        assert con.execute("select attempts from job where serial = 3"
                           ).fetchone()[0] == 3


def test_simulate_guards_metric_count_and_non_finite(tmp_path):
    a = _port(_cfg(sets=1, n=6), simulator=PySimulator(lambda p, s, i: [1.0]))
    a.build_database()
    with pytest.raises(SimulatorError, match="wrong number of metrics") as e:
        a.simulate_next_particles(-1)
    assert e.value.code == -211
    b = _port(_cfg(sets=1, n=6), simulator=PySimulator(
        lambda p, s, i: [float("nan") if i % 2 else 1.0, 2.0]))
    b.build_database()
    _, text = _quiet(b.simulate_next_particles, -1)
    assert "3 particle(s) returned non-finite" in text
    mets = b.storage.read_generations()[0].metrics
    assert (mets[1::2, 0] == np.finfo(np.float64).tiny).all()


def test_build_database_repairs_an_empty_store(tmp_path):
    db = str(tmp_path / "empty.sqlite")
    SQLiteStorage(db).create(["mu", "sigma"], ["mean", "sd"], False)
    a = _port(_cfg(db, sets=2, n=50))
    assert a.build_database(seed=0) is True
    gens = a.storage.read_generations()
    assert len(gens) == 1 and gens[0].size == 50
    assert (gens[0].statuses == "Q").all()
    assert a.build_database(seed=0) is False   # rows now: nothing to do
    _quiet(a.run, seed=1)
    assert _rows(db) == [(0, 50, 50, 5), (1, 50, 50, 5)]
    other = str(tmp_path / "other.sqlite")
    SQLiteStorage(other).create(["a", "b"], ["mean", "sd"], False)
    with pytest.raises(StorageError, match="does not match") as e:
        _port(_cfg(other)).build_database()
    assert e.value.code == 1


# ------------------------------------------------------------------- CLI
def _write(tmp_path, name, cfg):
    path = tmp_path / name
    path.write_text(json.dumps(cfg))
    return str(path)


@pytest.mark.parametrize("case", ["missing", "both_sizes", "bad_metric_type",
                                  "wrong_metric_count", "incomplete_set",
                                  "partial_simulate"])
def test_cli_exit_codes_match_jax(case, tmp_path):
    """The port's CLI and the JAX one on the same arguments, each on its own
    store: the same exit code and the same store state."""
    out = []
    for tag, entry, extra in (("jax", jmain, []),
                              ("port", main, ["--torch-device", "cpu"])):
        d = tmp_path / tag
        d.mkdir()
        cfg = _cfg(str(d / "run.sqlite"), sets=2, n=20)
        args = ["--process", "--seed", "1"]
        if case == "missing":
            path = str(d / "nope.json")
        elif case == "both_sizes":
            path = _write(d, "c.json", {**cfg, "predictive_prior_size": 5})
        elif case == "bad_metric_type":
            cfg["metrics"][0]["num_type"] = "BOGUS"
            path = _write(d, "c.json", cfg)
        elif case == "wrong_metric_count":
            del cfg["simulator"]
            cfg["executable"] = f"{sys.executable} -c print(1.0)"
            path = _write(d, "c.json", cfg)
            args += ["--simulate", "-n", "3"]
        else:
            path = _write(d, "c.json", cfg)
            if case == "partial_simulate":
                args += ["--simulate", "-n", "7"]
        with redirect_stderr(io.StringIO()) as err:
            rc = entry([path] + args + extra)
            if case == "incomplete_set":
                rc2 = entry([path] + args + extra)   # set 0 not simulated
                assert rc2 == 0
        db = d / "run.sqlite"
        out.append((rc, _rows(str(db)) if db.exists() else None,
                    err.getvalue()))
    (jrc, jrows, jerr), (trc, trows, terr) = out
    assert trc == jrc
    assert trows == jrows
    expected = {"missing": 1, "both_sizes": 1, "bad_metric_type": 209,
                "wrong_metric_count": 211, "incomplete_set": 0,
                "partial_simulate": 0}
    assert trc == expected[case]
    if case == "missing":
        assert "File does not exist" in terr
    if case == "incomplete_set":
        assert "not all particles are complete in set 0" in terr
    if case == "partial_simulate":
        assert trows == [(0, 20, 7, 0)]


def test_cli_dice_example_runs_every_set_on_cpu(tmp_path):
    """examples/dice.json (MULTIVARIATE noise, the builtin dice simulator)
    through ``python -m abcsmc_tpu_torch --process --simulate --all``."""
    cfg = json.loads((REPO / "examples" / "dice.json").read_text())
    db = tmp_path / "dice.sqlite"
    cfg["database_filename"] = str(db)
    path = _write(tmp_path, "dice.json", cfg)
    run = subprocess.run(
        [sys.executable, "-m", "abcsmc_tpu_torch", path, "--process",
         "--simulate", "--all", "--seed", "1", "--torch-device", "cpu",
         "--verbose", "--profile-dir", str(tmp_path / "prof")],
        cwd=REPO, capture_output=True, text=True, timeout=600,
    )
    assert run.returncode == 0, run.stderr[-2000:]
    assert _rows(str(db)) == [(0, 512, 512, 128)] + [
        (t, 1024, 1024, 256) for t in range(1, 10)]
    with closing(sqlite3.connect(db)) as con:
        assert [r[1] for r in con.execute("pragma table_info(job)")] == [
            "serial", "smcSet", "particleIdx", "startTime", "duration",
            "status", "posterior", "attempts"]
        assert [r[1] for r in con.execute("pragma table_info(par)")] == [
            "serial", "seed", "ndice", "sides"]
    assert "Database already contains 10 complete sets." in run.stderr
    assert "MULTIVARIATE noising" in run.stderr
    assert "[kernel] mixture_logsumexp.launches 0" in run.stderr  # CPU
    assert list((tmp_path / "prof").glob("trace_*.json"))
    sides = SQLiteStorage(str(db)).read_generations()[-1]
    post = sides.params[sides.predictive_prior_indices(), 1]
    assert abs(post.mean() - 8.0) < 2.0        # 13 dice of 8 sides observed


def test_cli_native_workers_and_vis(tmp_path, monkeypatch):
    """--workers runs an executable simulator through the native worker
    pool (native/abcq.cpp); --vis writes the two posterior plots. The pool
    is built from a private copy of native/, so no other test process that
    builds it at the same time can race this one."""
    from abcsmc_tpu_torch import native

    private = tmp_path / "native"
    shutil.copytree(REPO / "native", private,
                    ignore=shutil.ignore_patterns("*.so"))
    monkeypatch.setattr(native, "_NATIVE_DIR", str(private))
    monkeypatch.setattr(native, "_SO_PATH", str(private / "libabcq.so"))
    monkeypatch.setattr(native, "_lib", None)
    cfg = {
        "smc_iterations": 2, "num_samples": 24, "predictive_prior_size": 6,
        "executable": f"{sys.executable} {REPO / 'examples' / 'dice_exec.py'}",
        "database_filename": str(tmp_path / "exec.sqlite"),
        "parameters": [
            {"name": "ndice", "dist_type": "UNIFORM", "num_type": "INT",
             "par1": 1, "par2": 20},
            {"name": "sides", "dist_type": "UNIFORM", "num_type": "INT",
             "par1": 1, "par2": 20}],
        "metrics": [{"name": "sum", "num_type": "INT", "value": 44},
                    {"name": "sd", "num_type": "FLOAT", "value": 2.39925}],
    }
    path = _write(tmp_path, "exec.json", cfg)
    prefix = str(tmp_path / "plots")
    rc, _ = _quiet(main, [path, "--process", "--simulate", "--all",
                          "--workers", "2", "--seed", "2", "--vis", prefix,
                          "--torch-device", "cpu"])
    assert rc == 0
    assert _rows(cfg["database_filename"]) == [(0, 24, 24, 6), (1, 24, 24, 6)]
    assert Path(prefix + "_posteriors.png").stat().st_size > 0
    assert Path(prefix + "_pairs.png").stat().st_size > 0
    assert (private / "libabcq.so").exists()
