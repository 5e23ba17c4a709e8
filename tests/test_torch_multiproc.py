"""The port's particle mesh across processes: ``torch.distributed`` with the
gloo backend and CPU shards, workers spawned from this file with
``torch.multiprocessing`` (the torch analog of tests/test_multihost.py).

- 2 processes x 4 shards against 1 process x 8 shards: the replicated
  outputs of a three-set MULTIVARIATE, systematic, Box-Cox run of
  ``Generation.run`` and the gathered rows of its last set are bit-equal,
  and ``run_device`` against one shared SQLite store leaves the same store
  row for row (timestamps excluded); the window-by-window fetch of the
  rows, several shards a process, is their concatenation;
- an error raised on the store writer alone makes it re-raise and its peer
  raise a coded ``AbcError``, instead of waiting in the next collective;
- the host fallback (a host-only simulator) on a shared store raises on
  every process;
- a ``HostBridgeSimulator`` on 2 processes x 4 shards runs its host
  function exactly once per row fleet-wide: the processes' journals
  together hold the store's rows, each process a share, and the store
  equals the 1 x 8-shard run's row for row.

Every process group has a 60 s timeout and every spawn a time limit, so a
hang fails here instead of stalling the suite."""

import json
import os
import socket
import sqlite3
import subprocess
import sys
import time
from contextlib import closing
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

N, KEEP, SETS = 203, 21, 3
# fetch windows: inside a shard (26 rows each), one shard, across the
# processes' boundary (104 rows each); the last window of each is partial
WINDOWS = (7, 26, 100)
GROUP_TIMEOUT_S = 60
SPAWN_LIMIT_S = 150


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _config(db, noise="INDEPENDENT", **extra):
    return {
        "smc_iterations": SETS, "num_samples": N,
        "predictive_prior_size": KEEP, "noise": noise, "simulator": "dice",
        "database_filename": db,
        "parameters": [
            {"name": "ndice", "dist_type": "UNIFORM", "num_type": "INT",
             "par1": 1, "par2": 60},
            {"name": "sides", "dist_type": "UNIFORM", "num_type": "INT",
             "par1": 1, "par2": 30}],
        "metrics": [{"name": "sum", "num_type": "INT", "value": 44},
                    {"name": "sd", "num_type": "FLOAT", "value": 2.39925}],
        **extra,
    }


def _setup(rank, world, port, shards):
    from abcsmc_tpu_torch.parallel import initialize_distributed, particle_mesh

    torch.set_num_threads(1)
    if world > 1:
        initialize_distributed(f"localhost:{port}", world, rank,
                               device="cpu", timeout_s=GROUP_TIMEOUT_S)
    return particle_mesh(["cpu"] * shards)


def _teardown(world):
    import torch.distributed as dist

    if world > 1 and dist.is_initialized():
        dist.destroy_process_group()


def _run_worker(rank, world, port, shards, outdir):
    """A three-set step chain and a run_device fit on a shared store."""
    from abcsmc_tpu_torch import AbcSmc
    from abcsmc_tpu_torch.config import NoiseType
    from abcsmc_tpu_torch.parallel import Generation, fetch_rows_global

    mesh = _setup(rank, world, port, shards)
    smc = AbcSmc(_config(""), device="cpu", dtype=torch.float64)
    gen = Generation(smc.par_set, smc.transform, smc.simulator, smc.obs,
                     mesh=mesh, dtype=torch.float64,
                     noise_type=NoiseType.MULTIVARIATE,
                     resample_method="systematic", box_cox=True)
    gen.sorted_pick_min = 32       # the sorted pick paths too
    res, hist = gen.run(torch.Generator().manual_seed(7), [N] * SETS,
                        [KEEP] * SETS)
    out = {f"{name}{t}": x.numpy() for t, st in enumerate(hist)
           for name, x in zip(("spar", "w", "dv"), st)}
    out["surv"] = res.survivor_idx.numpy()
    out["ncomp"] = res.ncomp_used.numpy()
    out["metrics"] = fetch_rows_global(res.metrics, mesh)
    out["distances"] = fetch_rows_global(res.distances, mesh)
    for chunk in WINDOWS:
        out[f"metrics_win{chunk}"] = fetch_rows_global(res.metrics, mesh,
                                                       chunk)
        out[f"stacked_win{chunk}"] = fetch_rows_global(
            [torch.stack([m, -m]) for m in res.metrics], mesh, chunk, axis=1)
    np.savez(f"{outdir}/step_{world}_{rank}.npz", **out)

    db = f"{outdir}/run_{world}.sqlite"
    AbcSmc(_config(db), device="cpu", dtype=torch.float64).run_device(
        seed=3, mesh=mesh)
    _teardown(world)


def _error_worker(rank, world, port, shards, outdir):
    from abcsmc_tpu_torch import AbcSmc
    from abcsmc_tpu_torch.models.simulators import PySimulator

    mesh = _setup(rank, world, port, shards)
    seen = {}
    host = AbcSmc(_config(f"{outdir}/fallback.sqlite"), device="cpu",
                  simulator=PySimulator(lambda p, s, r: [0.0, 0.0]))
    try:
        host.run_device(seed=0, mesh=mesh)
        seen["fallback"] = None
    except Exception as e:  # noqa: BLE001 - the type is the result
        seen["fallback"] = type(e).__name__
    smc = AbcSmc(_config(f"{outdir}/inject.sqlite"), device="cpu")
    if rank == 0:
        def fail(*args, **kwargs):
            raise RuntimeError("injected store failure")

        smc.storage.insert_generation_complete = fail
    try:
        smc.run_device(seed=0, mesh=mesh)
        seen["inject"] = None
    except Exception as e:  # noqa: BLE001 - the type is the result
        seen["inject"] = type(e).__name__
    # the group still works after both: no process is left in a collective
    mesh.barrier()
    with open(f"{outdir}/errors_{rank}.json", "w") as f:
        json.dump(seen, f)
    _teardown(world)


BRIDGE_N = 96           # rows a set: no padding on 8 shards


def _bridge_worker(rank, world, port, shards, outdir):
    """run_device with a bridged numpy dice game that journals every row
    it simulates (its parameters and seed) into this process's own file
    (the counterpart of tests/multihost_worker.py's ``engine_bridge``)."""
    from abcsmc_tpu_torch import AbcSmc
    from abcsmc_tpu_torch.models.simulators import HostBridgeSimulator

    mesh = _setup(rank, world, port, shards)
    journal = f"{outdir}/journal_{world}_{rank}"

    def dice_host(params, seeds):
        out = np.empty((len(params), 2), params.dtype)
        with open(journal, "a") as fh:
            for i in range(len(params)):
                nd = int(round(float(params[i, 0])))
                sd = int(round(float(params[i, 1])))
                rolls = np.random.default_rng(int(seeds[i])).integers(
                    1, sd + 1, size=nd)
                out[i] = [rolls.sum(), rolls.std(ddof=0) if nd > 1 else 0.0]
                fh.write(f"{nd} {sd} {int(seeds[i])}\n")
        return out

    cfg = _config(f"{outdir}/bridge_{world}.sqlite", num_samples=BRIDGE_N,
                  predictive_prior_size=24)
    AbcSmc(cfg, device="cpu", dtype=torch.float64,
           simulator=HostBridgeSimulator(dice_host, nmet=2)).run_device(
        seed=19, mesh=mesh)
    _teardown(world)


def _spawn(fn, world, shards, outdir):
    ctx = mp.spawn(fn, args=(world, _free_port(), shards, str(outdir)),
                   nprocs=world, join=False)
    deadline = time.monotonic() + SPAWN_LIMIT_S
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{fn.__name__} did not finish in {SPAWN_LIMIT_S} s")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("multiproc")
    _spawn(_run_worker, 2, 4, out)
    _spawn(_run_worker, 1, 8, out)
    return out


def _store(db):
    """Every row table of a store, the timestamp columns left out (the
    provenance table holds the creation time and the store's own path)."""
    conn = sqlite3.connect(db)
    tables = {}
    for (name,) in conn.execute(
            "select name from sqlite_master where type = 'table'"):
        cols = [c[1] for c in conn.execute(f"pragma table_info({name})")
                if c[1] not in ("startTime", "duration")]
        if name.endswith("meta"):
            continue
        tables[name] = conn.execute(
            f"select {', '.join(cols)} from {name} order by 1").fetchall()
    conn.close()
    return tables


def test_two_by_four_step_equals_one_by_eight(runs):
    ref = np.load(runs / "step_1_0.npz")
    for rank in (0, 1):
        got = np.load(runs / f"step_2_{rank}.npz")
        assert sorted(got.files) == sorted(ref.files)
        for name in ref.files:
            np.testing.assert_array_equal(got[name], ref[name], err_msg=name)
    assert int(ref["ncomp"]) > 0
    assert ref["metrics"].shape == (-(-N // 8) * 8, 2)


@pytest.mark.parametrize("chunk", WINDOWS)
def test_windowed_fetch_on_two_processes_is_the_concatenation(runs, chunk):
    """Above ``chunk_rows`` each process copies its four shards' overlap
    with a window and the windows are gathered: the rows in order, on
    every process, on either row axis."""
    ref = np.load(runs / "step_1_0.npz")["metrics"]
    for rank in (0, 1):
        got = np.load(runs / f"step_2_{rank}.npz")
        np.testing.assert_array_equal(got[f"metrics_win{chunk}"], ref)
        np.testing.assert_array_equal(got[f"stacked_win{chunk}"],
                                      np.stack([ref, -ref]))


def test_two_by_four_run_device_store_equals_one_by_eight(runs):
    one, two = _store(runs / "run_1.sqlite"), _store(runs / "run_2.sqlite")
    assert set(one) >= {"job", "par", "met"}
    assert one == two
    assert len(one["job"]) == N * SETS


@pytest.fixture(scope="module")
def errors(tmp_path_factory):
    out = tmp_path_factory.mktemp("multiproc_errors")
    _spawn(_error_worker, 2, 2, out)
    return [json.loads((out / f"errors_{r}.json").read_text())
            for r in (0, 1)]


def test_writer_failure_raises_on_every_process(errors):
    assert [s["inject"] for s in errors] == ["RuntimeError", "AbcError"]


def test_host_fallback_on_shared_store_raises(errors):
    assert [s["fallback"] for s in errors] == ["AbcError", "AbcError"]


def test_two_process_host_bridge_exactly_once(tmp_path):
    """The counterpart of tests/test_multihost.py::
    test_two_process_host_bridge_exactly_once: each process calls the host
    function for its own shards only, so the journals' union equals the
    store's rows as multisets (none twice, none missing), both processes
    carry a share, and the store equals the one-process 8-shard run's."""
    _spawn(_bridge_worker, 2, 4, tmp_path)
    _spawn(_bridge_worker, 1, 8, tmp_path)
    two, one = (_store(tmp_path / f"bridge_{w}.sqlite") for w in (2, 1))
    assert one == two
    assert len(two["job"]) == BRIDGE_N * SETS

    def journal(name):
        text = (tmp_path / name).read_text()
        return [tuple(map(int, ln.split())) for ln in text.splitlines()]

    j0, j1 = journal("journal_2_0"), journal("journal_2_1")
    with closing(sqlite3.connect(tmp_path / "bridge_2.sqlite")) as conn:
        store = conn.execute(
            "select cast(ndice as integer), cast(sides as integer), "
            "cast(seed as integer) from par").fetchall()
    assert len(store) == BRIDGE_N * SETS
    assert sorted(j0 + j1) == sorted(store)
    assert 0 < len(j0) < len(store) and 0 < len(j1) < len(store)
    assert sorted(journal("journal_1_0")) == sorted(store)


def test_multihost_launcher_fills_one_store(tmp_path):
    """``python -m abcsmc_tpu_torch.multihost`` as two processes of two CPU
    shards each: one complete store, written once, and process 0's
    posterior summary."""
    cfg = tmp_path / "cfg.json"
    db = tmp_path / "launch.sqlite"
    cfg.write_text(json.dumps(_config(str(db))))
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parents[1]))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "abcsmc_tpu_torch.multihost", str(cfg),
         "--coordinator", f"localhost:{port}", "--num-processes", "2",
         "--process-id", str(r), "--torch-device", "cpu",
         "--shards-per-device", "2", "--timeout-s", str(GROUP_TIMEOUT_S)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=SPAWN_LIMIT_S))
    finally:
        for p in procs:
            p.kill()
    errs = [e[-2000:] for _, e in outs]
    assert [p.returncode for p in procs] == [0, 0], errs
    assert "ndice: mean=" in outs[0][0] and outs[1][0] == ""
    rows = _store(db)["job"]
    assert len(rows) == N * SETS
    assert all(r[3] == "D" for r in rows)    # (serial, set, idx, status, ...)
