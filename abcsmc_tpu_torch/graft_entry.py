"""Entry points of the port (counterpart of the JAX repo's
``__graft_entry__.py``).

``entry(device)``  -> (fn, example_args): the single-card, first-generation
                      step on the flagship dice model (simulate, PLS
                      filter, weights, resample, perturbation);
                      ``fn(draws, params, seeds, s0, s1, s2)`` returns
                      (survivor_params, weights, next_params).
``dryrun_multichip(n, device)`` -> runs full sharded generations on an
                      n-shard particle mesh across the case matrix (noise,
                      filters, selection rules, resampling, chunked rows,
                      top-K strategies, pad-and-mask), a fused 3-set chain,
                      a projection sweep, a mid-set resume and a
                      two-process engine run; prints one OK line per case
                      and raises on any failure.

The mesh is built from ``n`` cards when ``n`` are visible, else from ``n``
shards of the one card (a virtual mesh); CPU shards only with
``device="cpu"``. Without CUDA, asking for it raises: nothing falls back.

    python -m abcsmc_tpu_torch.graft_entry [--device cpu] [--dryrun N]
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sqlite3
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

import numpy as np
import torch

from abcsmc_tpu_torch.bench import mesh_devices
from abcsmc_tpu_torch.tools._common import needs_cuda, step_generator

#: seconds the two-process variant's two ranks get together
SPAWN_LIMIT_S = 300

# the two-process engine run: the JAX dry-run's worker configuration
_ENGINE_CFG = {
    "smc_iterations": 3,
    "num_samples": 96,
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
}


def _make_gen(mesh=None, device=None):
    """The dice model's generation step (1,024 particles, keep 128 in the
    config; the step takes its sizes per call) on ``mesh`` or, without
    one, on ``device``."""
    from abcsmc_tpu_torch.config import parse_config
    from abcsmc_tpu_torch.models.parameters import ParameterSet
    from abcsmc_tpu_torch.models.simulators import make_dice_simulator
    from abcsmc_tpu_torch.models.transforms import ParameterTransform
    from abcsmc_tpu_torch.parallel.generation import Generation

    cfg = parse_config({
        "smc_iterations": 3,
        "num_samples": 1024,
        "predictive_prior_fraction": 0.125,
        "parameters": [
            {"name": "ndice", "dist_type": "UNIFORM", "num_type": "INT",
             "par1": 1, "par2": 100},
            {"name": "sides", "dist_type": "UNIFORM", "num_type": "INT",
             "par1": 1, "par2": 100},
        ],
        "metrics": [
            {"name": "sum", "num_type": "INT", "value": 44},
            {"name": "sd", "num_type": "FLOAT", "value": 2.39925},
        ],
    })
    return Generation(
        ParameterSet.from_specs(cfg.parameters),
        ParameterTransform(cfg.parameters),
        make_dice_simulator(max_dice=100),
        np.array([44.0, 2.39925]),
        mesh=mesh, device=device,
    )


def entry(device="cuda"):
    """The single-card first-generation step with its simulator at n
    1,024, keep 128, and example args: ``(draws, params, seeds, s0, s1,
    s2)``, the draws a ``StepDraws`` from ``torch.Generator`` seeded 0
    (where the JAX entry holds a key) and (s0, s1, s2) a dummy previous
    state, unused by a first generation."""
    from abcsmc_tpu_torch import resolve_device

    device = resolve_device(device)
    gen = _make_gen(device=device)
    n, keep = 1024, 128
    rng = np.random.default_rng(0)
    params = torch.as_tensor(rng.integers(1, 101, size=(n, 2)),
                             dtype=torch.float32, device=device)
    seeds = torch.as_tensor(
        rng.integers(0, 2**31, size=n, dtype=np.int64).astype(np.uint32)
        .astype(np.int64), device=device)
    p = 2
    dummy_state = (
        torch.zeros((1, p), dtype=torch.float32, device=device),
        torch.ones((1,), dtype=torch.float32, device=device),
        torch.ones((p,), dtype=torch.float32, device=device),
    )
    draws = gen.draw_step(torch.Generator(device=device).manual_seed(0), n)

    def fn(draws, params, seeds, s0, s1, s2):
        res = gen.step(params, seeds, keep, n, draws, None)
        return res.survivor_params, res.weights, res.next_params

    return fn, (draws, params, seeds, *dummy_state)


def _cat(x):
    return torch.cat(x) if isinstance(x, list) else x


def dryrun_cases(n_devices: int):
    """(label, n, keep, Generation attributes) of the case matrix."""
    from abcsmc_tpu_torch.config import FilterType, NoiseType

    k = n_devices
    cases = [
        ("pls-vdv independent, keep%ndev!=0", 4096, 100,
         dict(pls_optimal_method="vdv")),
        ("multivariate noise, reference-shaped n=300 (pad-and-mask)", 300, 30,
         dict(noise_type=NoiseType.MULTIVARIATE)),
        ("simple filter", 16 * k, 2 * k,
         dict(filter_type=FilterType.SIMPLE)),
        ("pls-tolerance selection", 16 * k, 2 * k,
         dict(pls_optimal_method="tolerance")),
        ("systematic resampling (global strata over shards)", 16 * k, 2 * k,
         dict(resample_method="systematic")),
        ("chunked big-N row passes (row_block forced, pad-and-mask)", 300, 30,
         dict(row_block=16)),
        ("two-stage top-K (distance gather + survivor-row psum)", 16 * k,
         2 * k, dict(topk_two_stage=True)),
    ]
    # the "bend": local_n < keep, so every shard offers its whole slice as
    # top-K candidates; a one-shard mesh cannot bend (local_n = n >= keep)
    if k >= 2:
        bend_keep = min(16 * k, max(4 * k, 24))
        assert bend_keep > 16, "bend variant must have keep > local_n"
        cases.append(("top-K bend (local_n < keep, whole-slice candidates)",
                      16 * k, bend_keep, {}))
    return cases


def _dryrun_variant(mesh, n_devices, *, n, keep, label, **gen_kw):
    """Two full sharded generations (generation 0, then a weighted final
    one) under one configuration; checks shapes and finiteness and
    returns one OK line."""
    gen = _make_gen(mesh)
    for k, v in gen_kw.items():
        setattr(gen, k, v)
    g = step_generator(gen, zlib.crc32(label.encode()) & 0x7FFFFFFF)
    params, seeds = gen.init_population(g, n)
    r0 = gen.step(params, seeds, keep, n, gen.draw_step(g, n), None,
                  n_valid=n)
    state = (r0.survivor_params, r0.weights, r0.doubled_variance)
    # final-style step: no proposal (n_next = 0)
    r1 = gen.step(r0.next_params, r0.next_seeds, keep, 0,
                  gen.draw_step(g, 0), state, n_valid=n)

    w = r1.weights.cpu().numpy()
    assert w.shape == (keep,) and np.all(np.isfinite(w)), (label, w)
    surv = r1.survivor_params.cpu().numpy()
    assert surv.shape == (keep, 2) and np.all(np.isfinite(surv)), label
    assert tuple(_cat(r1.next_params).shape) == (0, 2), label
    d = _cat(r1.distances).cpu().numpy()
    assert np.all(np.isfinite(d[:n])) and np.all(np.isinf(d[n:])), label
    return (f"dryrun_multichip({n_devices}): OK - {label}: {n} particles, "
            f"keep {keep}, ncomp={int(r1.ncomp_used)}")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _engine_two_processes(n_devices: int, td: str) -> str:
    """2 processes x 4 CPU shards over gloo (NCCL refuses two ranks on one
    card): ``python -m abcsmc_tpu_torch.multihost`` against ONE shared
    SQLite store, writes gated to process 0. Its store must hold one done
    row per particle, and its posterior summary must equal a one-process
    8-shard run's on the same seed."""
    from abcsmc_tpu_torch import AbcSmc
    from abcsmc_tpu_torch.parallel.mesh import particle_mesh

    db = f"{td}/multiproc.sqlite"
    cfg_path = f"{td}/multiproc.json"
    with open(cfg_path, "w") as fh:
        json.dump(dict(_ENGINE_CFG, simulator="dice",
                       database_filename=db), fh)
    repo = str(Path(__file__).resolve().parents[1])
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [repo] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    env["CUDA_VISIBLE_DEVICES"] = ""        # CPU ranks touch no card
    port = _free_port()
    logs = [(open(f"{td}/rank{i}.out", "w"), open(f"{td}/rank{i}.err", "w"))
            for i in range(2)]
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "abcsmc_tpu_torch.multihost", cfg_path,
             "--coordinator", f"localhost:{port}", "--num-processes", "2",
             "--process-id", str(i), "--torch-device", "cpu",
             "--shards-per-device", "4", "--seed", "11",
             "--timeout-s", str(SPAWN_LIMIT_S)],
            stdout=out, stderr=err, text=True, cwd=repo, env=env)
        for i, (out, err) in enumerate(logs)
    ]
    # one deadline for both ranks; a rank that fails ends the wait, and
    # its peer (waiting in a collective on it) is killed below
    deadline = time.monotonic() + SPAWN_LIMIT_S
    try:
        while (time.monotonic() < deadline
               and any(p.poll() is None for p in procs)
               and all(p.returncode in (None, 0) for p in procs)):
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for fh in (fh for pair in logs for fh in pair):
            fh.close()
    outs = [Path(f"{td}/rank{i}.out").read_text() for i in range(2)]
    for i, p in enumerate(procs):
        assert p.returncode == 0, (
            f"multihost rank {i} failed or passed the {SPAWN_LIMIT_S} s "
            f"limit (exit {p.returncode}):\n{outs[i]}\n"
            f"{Path(f'{td}/rank{i}.err').read_text()}")
    conn = sqlite3.connect(db)
    try:
        rows = conn.execute(
            "select count(*), sum(status = 'D'), count(distinct serial) "
            "from job").fetchone()
    finally:
        conn.close()
    want = 3 * _ENGINE_CFG["num_samples"]
    assert rows == (want, want, want), rows       # one row per particle
    one = AbcSmc(dict(_ENGINE_CFG, simulator="dice", database_filename=""),
                 device="cpu")
    one.run_device(seed=11, mesh=particle_mesh(["cpu"] * 8))
    summary = [f"{name}: mean={s['mean']:.6g} sd={s['sd']:.6g}"
               for name, s in one.posterior_summary().items()]
    got = [line for line in outs[0].splitlines() if "mean=" in line]
    assert got == summary, (got, summary)
    return (f"dryrun_multichip({n_devices}): OK - 2-process x 4-shard gloo "
            f"engine run, one shared store, {rows[0]} rows, posterior equal "
            "to the 1 x 8-shard run")


def dryrun_multichip(n_devices: int, device="cuda") -> list[str]:
    """The FULL sharded step on an ``n_devices``-shard mesh across the
    case matrix (:func:`dryrun_cases`), ``run_scan`` over 3 sets (replayed
    from a CUDA graph on a one-card mesh, eager across cards or on the
    CPU), the projection sweep with an echo simulator, a half-simulated
    store resumed through ``run_device(mesh=...)`` and the two-process
    engine run. Prints the OK lines and returns them; raises on any
    failure."""
    from abcsmc_tpu_torch import AbcSmc, resolve_device
    from abcsmc_tpu_torch.models.simulators import (
        DeviceSimulator, make_dice_simulator,
    )
    from abcsmc_tpu_torch.parallel.mesh import particle_mesh

    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < n_devices:
        mesh = particle_mesh([dev] * n_devices)     # a virtual mesh
    else:
        mesh = particle_mesh(mesh_devices(dev, n_devices))
    ok_lines = [
        _dryrun_variant(mesh, n_devices, n=n, keep=keep, label=label, **kw)
        for label, n, keep, kw in dryrun_cases(n_devices)]

    # a fused 3-set chain; a bucket of 2 sets replays once on one card
    gen_scan = _make_gen(mesh)
    gen_scan.min_replays = 1
    _, hist = gen_scan.run_scan(step_generator(gen_scan, 77),
                                16 * n_devices, 2 * n_devices, 3)
    assert tuple(hist[0].shape) == (3, 2 * n_devices), hist[0].shape
    assert bool(torch.isfinite(hist[3]).all())
    replayed = gen_scan.graph_replays
    assert replayed >= 1 or not gen_scan.capturable, replayed
    ok_lines.append(
        f"dryrun_multichip({n_devices}): OK - run_scan 3-generation fused "
        f"chain ({replayed} CUDA-graph replays)")

    # the sharded projection sweep (PSEUDO grid, echo simulator)
    with tempfile.TemporaryDirectory() as td:
        cfg = {
            "database_filename": f"{td}/proj.sqlite",
            "parameters": [
                {"name": "a", "dist_type": "PSEUDO", "num_type": "INT",
                 "par1": 0, "par2": max(n_devices, 3)},
                {"name": "b", "dist_type": "PSEUDO", "num_type": "FLOAT",
                 "vals": [0.25, 0.75, 1.25]},
            ],
            "metrics": [
                {"name": "m1", "num_type": "FLOAT", "value": 0},
                {"name": "m2", "num_type": "FLOAT", "value": 0},
            ],
        }
        echo = DeviceSimulator(lambda p, seeds: p.clone(), nmet=2)
        abc = AbcSmc(cfg, simulator=echo, device=mesh.lead)
        abc.run_device(seed=0, mesh=mesh)
        gens = abc.storage.read_generations()
        abc.storage.close()
        assert len(gens) == 1 and gens[0].complete
        assert np.allclose(gens[0].metrics, gens[0].params)
        ok_lines.append(
            f"dryrun_multichip({n_devices}): OK - projection sweep: "
            f"{gens[0].size} grid points simulated sharded")

    # device-side resume: half-simulate set 0 through the host queue, then
    # finish the whole run on the mesh
    with tempfile.TemporaryDirectory() as td:
        cfg = dict(_ENGINE_CFG, smc_iterations=2, num_samples=8 * n_devices,
                   database_filename=f"{td}/resume.sqlite")
        sim = make_dice_simulator(max_dice=50)
        abc = AbcSmc(cfg, simulator=sim, device=mesh.lead)
        abc.build_database(seed=1)
        abc.simulate_next_particles(n=4 * n_devices)
        abc.storage.close()
        abc2 = AbcSmc(cfg, simulator=sim, device=mesh.lead)
        abc2.run_device(seed=2, mesh=mesh)
        gens = abc2.storage.read_generations()
        abc2.storage.close()
        assert len(gens) == 2 and all(g.complete for g in gens)
        ok_lines.append(
            f"dryrun_multichip({n_devices}): OK - resumed half-simulated "
            f"store on device ({2 * 8 * n_devices} rows total)")

    with tempfile.TemporaryDirectory() as td:
        ok_lines.append(_engine_two_processes(n_devices, td))

    for line in ok_lines:
        print(line, flush=True)
    print(f"dryrun_multichip({n_devices}): OK - all variants", flush=True)
    return ok_lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m abcsmc_tpu_torch.graft_entry")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no fallback")
    ap.add_argument("--dryrun", type=int, default=0, metavar="N",
                    help="also run dryrun_multichip(N)")
    args = ap.parse_args(argv)
    if needs_cuda(args.device, "abcsmc_tpu_torch.graft_entry"):
        return 2
    fn, example = entry(args.device)
    out = fn(*example)
    print("entry OK:", [tuple(o.shape) for o in out], flush=True)
    if args.dryrun:
        dryrun_multichip(args.dryrun, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
