#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (abcsmc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases (each prints one JSON line; any failure raises and exits nonzero):

1. build   - compile csrc/mixture_logsumexp.cu with nvcc (sm_90a), timed;
2. kernel  - the kernel against its plain PyTorch version on the card, f32,
             at 2,048 x 2,048 x 16 and 50,000 x 50,000 x 6 (the main path's
             shapes, both timed), 4,096^2 x 80, 2,048^2 x 1 and a ragged
             37 x 1,000 x 1, in the static, online and auto modes; a hostile
             20,000^2 x 16 case (coordinates up to 6 kernel sd) against the
             plain version in float64; the underflow case; true -inf
             weights; one auto call under torch.cuda.set_sync_debug_mode
             ("error"); max abs diff <= 2e-4 nats;
3. dengue  - examples/dengue_surrogate.json through
             AbcSmc(cfg, device="cuda").run_device(): 5 complete SQLite sets
             of 2,048 ranked rows, ncomp_used > 1 in each, >= 4 kernel
             launches, posterior mean closer to the stated truth than the
             prior mean;
4. north   - 1,000,000 particles x 6 parameters x 13 metrics, keep 50,000,
             3 sets, in-memory store: >= 2 kernel launches, ncomp_used > 1;
5. host_cli - dengue_surrogate (3 sets) through the host engine's job queue:
             ``python -m abcsmc_tpu_torch cfg --process --simulate --all``
             as a subprocess: 3 complete SQLite sets of 2,048 ranked rows,
             ncomp_used > 1 in every ranking, 2 kernel launches per weight
             call, posterior closer to the truth than the prior; the weights
             of every set after set 0, rebuilt by a brain pass on a copy of
             the store, held against the plain version on the same inputs
             (log-weights within 2 x 2e-4 nats of each other);
6. resume  - dengue_surrogate: ``--process`` then ``--simulate -n 51200``
             (set 0 half done) as subprocesses, then
             AbcSmc(cfg, device="cuda").run_device() finishes 3 sets with 2
             kernel launches per set after set 0; the 51,200 rows simulated
             first keep their metrics.

Each phase prints its wall time; the host phases also print the engine's
timings split (read/rank/weight, propose, enqueue, claim, simulate,
writeback). Then the kernel summary line (launches summed over every
phase's main path) and, last, the device line. There is no CPU
path: without CUDA (or outside a checkout) it exits nonzero and prints no
result.
"""

import ast
import io
import json
import math
import re
import shutil
import sqlite3
import subprocess
import sys
import tempfile
import time
from contextlib import closing, redirect_stderr
from pathlib import Path

REPO = Path(__file__).resolve().parent
TOL = 2e-4          # nats; the bound of tests/test_pallas_kernels.py
KERNEL_SHAPES = ((2048, 2048, 16), (50_000, 50_000, 6))
EXTRA_SHAPES = ((4096, 4096, 80), (2048, 2048, 1), (37, 1000, 1))
# Peak rates of one H100 SXM at its 700 W limit: the special-function unit
# issues 16 ex2 per SM per clock (CUDA C++ Programming Guide, arithmetic
# instruction throughput, compute capability 9.0), TF32 tensor cores 495
# TFLOP/s dense and HBM 3.35 TB/s (NVIDIA H100 data sheet).
SFU_PER_SM_CLOCK = 16
TF32_FLOPS = 495e12
HBM_BYTES = 3.35e12


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cuda_ms(fn, reps):
    """Mean milliseconds per call, CUDA events around `reps` calls after one
    warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def kernel_inputs(n, m, p, seed):
    """Scaled (a, b, log_w) as the weight stage makes them, from numpy."""
    import numpy as np
    import torch

    from abcsmc_tpu_torch.ops.weights import _prep_scaled

    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    params = torch.as_tensor(rng.uniform(0, 1, (n, p)), dtype=torch.float32,
                             device=dev)
    prev = torch.as_tensor(rng.uniform(0.2, 0.8, (m, p)),
                           dtype=torch.float32, device=dev)
    w = rng.uniform(0.5, 1.5, m)
    lw = torch.as_tensor(np.log(w / w.sum()), dtype=torch.float32,
                         device=dev)
    dv = torch.as_tensor(rng.uniform(0.01, 0.1, p), dtype=torch.float32,
                         device=dev)
    a, b, _ = _prep_scaled(params, prev, dv)
    return a.contiguous(), b.contiguous(), lw


def kernel_bound_ms(n, m, p):
    """The least time the card could take for one call at n x m x p: the
    larger of its operations over their peak rate (one ex2 per logit on the
    special-function units at the card's maximum SM clock; the 3xTF32 dot,
    3 x 2 (p+2) flops per logit, on the tensor cores) and its bytes (each
    input read once, the output written once) over the HBM rate."""
    import torch

    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    terms = {
        "ex2": 1e3 * n * m / (sms * SFU_PER_SM_CLOCK * mhz * 1e6),
        "tf32_dot": 1e3 * 3 * 2 * (p + 2) * n * m / TF32_FLOPS,
        "bytes": 1e3 * 4 * (n * p + m * p + m + n) / HBM_BYTES,
    }
    worst = max(terms, key=terms.get)
    return {"bound_ms": terms[worst], "terms_ms": terms,
            "bound_by": "bytes" if worst == "bytes" else "operations",
            "sm_clock_mhz": mhz, "sms": sms}


def phase_kernel():
    import torch

    from abcsmc_tpu_torch.ops.kernels import (
        mixture_logsumexp, mixture_logsumexp_reference,
    )

    errs, times = {}, {}
    for n, m, p in KERNEL_SHAPES:
        a, b, lw = kernel_inputs(n, m, p, seed=n + p)
        for mode in ("static", "online", "auto"):
            got = mixture_logsumexp(a, b, lw, mode=mode)
            torch.cuda.synchronize()
            ref = mixture_logsumexp_reference(a, b, lw, mode=mode)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()), f"finite {mode} {n}x{m}")
            err = float((got - ref).abs().max())
            errs[f"{n}x{m}x{p}/{mode}"] = err
            check(err <= TOL, f"{mode} at {n}x{m}x{p}: max abs err {err}")
        reps = 20 if n < 10_000 else 5
        shape = times[f"{n}x{m}x{p}"] = {}
        for mode in ("auto", "static", "online"):
            sfx = "" if mode == "auto" else f"_{mode}"
            shape["ms" + sfx] = cuda_ms(
                lambda: mixture_logsumexp(a, b, lw, mode=mode), reps)
            shape["plain_ms" + sfx] = cuda_ms(
                lambda: mixture_logsumexp_reference(a, b, lw, mode=mode),
                reps)
        del a, b, lw

    # any p (the templates of the first port stopped at 64), tiny and ragged
    for n, m, p in EXTRA_SHAPES:
        a, b, lw = kernel_inputs(n, m, p, seed=n + m + p)
        for mode in ("static", "online", "auto"):
            got = mixture_logsumexp(a, b, lw, mode=mode)
            torch.cuda.synchronize()
            ref = mixture_logsumexp_reference(a, b, lw, mode=mode)
            err = float((got - ref).abs().max())
            errs[f"{n}x{m}x{p}/{mode}"] = err
            check(err <= TOL, f"{mode} at {n}x{m}x{p}: max abs err {err}")

    # hostile: coordinates up to 6 kernel sd, where the expansion
    # a.b - |a|^2/2 - |b|^2/2 cancels most; each query within ~1 sd of its
    # parent center, as in an SMC state; held to float64
    import numpy as np

    rng = np.random.default_rng(5)
    n = m = 20_000
    p = 16
    bh = rng.uniform(-6, 6, (m, p))
    ah = bh[rng.integers(0, m, n)] + rng.normal(size=(n, p))
    wh = rng.uniform(0.5, 1.5, m)
    h32 = [torch.as_tensor(x, dtype=torch.float32, device="cuda")
           for x in (ah, bh, np.log(wh / wh.sum()))]
    ref64 = mixture_logsumexp_reference(*(x.double() for x in h32),
                                        mode="online")
    for mode in ("static", "online", "auto"):
        got = mixture_logsumexp(*h32, mode=mode)
        err = float((got.double() - ref64).abs().max())
        errs[f"hostile_{n}x{m}x{p}_f64/{mode}"] = err
        check(err <= TOL, f"hostile {mode}: max abs err vs f64 {err}")

    # auto decides its rerun on the device: no host sync in the call
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        mixture_logsumexp(*h32, mode="auto")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    del h32, ref64

    # underflow: the far query's static exp-sum is 0; auto == online
    dev = torch.device("cuda")
    b = torch.zeros((16, 2), device=dev)
    lw = torch.full((16,), math.log(1.0 / 16), device=dev)
    a = torch.cat([torch.zeros((3, 2), device=dev),
                   torch.full((1, 2), 1e4, device=dev)])
    static = mixture_logsumexp(a, b, lw, mode="static")
    auto = mixture_logsumexp(a, b, lw, mode="auto")
    online = mixture_logsumexp(a, b, lw, mode="online")
    ref = mixture_logsumexp_reference(a, b, lw, mode="online")
    torch.cuda.synchronize()
    check(bool(torch.isneginf(static[3])), "underflow really occurs")
    check(bool(torch.equal(auto, online)), "auto equals online on underflow")
    uerr = float(((auto - ref).abs() / ref.abs().clamp_min(1.0)).max())
    check(uerr <= 1e-6, f"underflow value, rel err {uerr}")
    errs["underflow/rel"] = uerr

    # true -inf weights drop out: equal to the finite-weight subset
    a, b, lw = kernel_inputs(2048, 2048, 16, seed=7)
    lw = lw.clone()
    lw[1024:] = -math.inf
    got = mixture_logsumexp(a, b, lw)
    sub = mixture_logsumexp(a, b[:1024].contiguous(), lw[:1024].contiguous())
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), "finite with -inf weights")
    ierr = float((got - sub).abs().max())
    check(ierr <= TOL, f"-inf weights: max abs err {ierr}")
    errs["neg_inf_weights"] = ierr
    emit({"phase": "kernel", "max_abs_err": errs, "times": times})
    return errs, times


def phase_dengue():
    import numpy as np

    from abcsmc_tpu_torch import AbcSmc
    from abcsmc_tpu_torch.ops.kernels import mixture_logsumexp

    path = REPO / "examples" / "dengue_surrogate.json"
    cfg = json.loads(path.read_text())
    truth = np.array(json.loads(
        re.search(r"truth=(\[[^\]]*\])", cfg["comment"]).group(1)))
    n_sets, n, keep = 5, 102_400, 2_048
    with tempfile.TemporaryDirectory() as tmp:
        db = str(Path(tmp) / "dengue_surrogate.sqlite")
        cfg["database_filename"] = db
        mixture_logsumexp.launches = 0
        t0 = time.perf_counter()
        run = AbcSmc(cfg, device="cuda").run_device(seed=0)
        wall = time.perf_counter() - t0
        launches = mixture_logsumexp.launches
        run.storage.close()
        with closing(sqlite3.connect(db)) as con:
            rows = con.execute(
                "select smcSet, count(*), sum(status = 'D'), "
                "sum(posterior > -1) from job group by smcSet order by smcSet"
            ).fetchall()
    check(rows == [(t, n, n, keep) for t in range(n_sets)],
          f"dengue store rows {rows}")
    gens = [e for e in run.timings if e["op"] == "device_generation"]
    ncomp = [e["ncomp_used"] for e in gens]
    check(len(ncomp) == n_sets and min(ncomp) > 1, f"dengue ncomp {ncomp}")
    check(launches >= n_sets - 1, f"dengue kernel launches {launches}")
    pars, w = run.posterior()
    check(np.isfinite(pars).all() and np.isfinite(w).all(), "finite posterior")
    rmse_post = float(np.sqrt(((pars.mean(0) - truth) ** 2).mean()))
    rmse_prior = float(np.sqrt(((0.5 - truth) ** 2).mean()))
    check(rmse_post < rmse_prior, f"posterior rmse {rmse_post} >= prior "
          f"{rmse_prior}")
    emit({"phase": "dengue_surrogate", "store_rows": rows, "ncomp": ncomp,
          "launches": launches, "set_ms": [e["device_ms"] for e in gens],
          "wall_s": wall, "rmse_posterior": rmse_post,
          "rmse_prior": rmse_prior})
    return launches


def phase_north():
    import numpy as np
    import torch

    from abcsmc_tpu_torch import AbcSmc
    from abcsmc_tpu_torch.models.simulators import (
        make_linear_gaussian_simulator,
    )
    from abcsmc_tpu_torch.ops.kernels import mixture_logsumexp

    npar, nmet, n, keep, n_sets = 6, 13, 1_000_000, 50_000, 3
    truth = np.random.default_rng(42).uniform(0.2, 0.8, npar)
    sim = make_linear_gaussian_simulator(npar, nmet, noise_sd=0.1)
    obs = sim.run_batch(truth[None, :], np.array([7]), np.array([0]),
                        device="cpu", dtype=torch.float64)[0]
    cfg = {
        "smc_iterations": n_sets,
        "num_samples": n,
        "predictive_prior_size": keep,
        "parameters": [
            {"name": f"p{i}", "dist_type": "UNIFORM", "num_type": "FLOAT",
             "par1": 0.0, "par2": 1.0} for i in range(npar)
        ],
        "metrics": [
            {"name": f"m{j}", "num_type": "FLOAT", "value": float(obs[j])}
            for j in range(nmet)
        ],
    }
    mixture_logsumexp.launches = 0
    t0 = time.perf_counter()
    run = AbcSmc(cfg, device="cuda", simulator=sim).run_device(seed=0)
    wall = time.perf_counter() - t0
    launches = mixture_logsumexp.launches
    gens_store = run.storage.read_generations()
    check([(g.size, len(g.predictive_prior_indices()))
           for g in gens_store] == [(n, keep)] * n_sets,
          "north-star store sets")
    gens = [e for e in run.timings if e["op"] == "device_generation"]
    ncomp = [e["ncomp_used"] for e in gens]
    check(len(ncomp) == n_sets and min(ncomp) > 1, f"north ncomp {ncomp}")
    check(launches >= n_sets - 1, f"north kernel launches {launches}")
    pars, w = run.posterior()
    check(np.isfinite(pars).all() and np.isfinite(w).all(), "finite posterior")
    rmse_post = float(np.sqrt(((pars.mean(0) - truth) ** 2).mean()))
    rmse_prior = float(np.sqrt(((0.5 - truth) ** 2).mean()))
    check(rmse_post < rmse_prior, f"north posterior rmse {rmse_post}")
    emit({"phase": "north_star_1m", "ncomp": ncomp, "launches": launches,
          "set_ms": [e["device_ms"] for e in gens], "wall_s": wall,
          "rmse_posterior": rmse_post, "rmse_prior": rmse_prior})
    return launches


HOST_SETS = 3       # the host phases cut dengue_surrogate's sets, not widths


def dengue_host_config(tmp):
    """examples/dengue_surrogate.json at its full width with its sets cut
    to HOST_SETS and its store in ``tmp``; returns (config path, cfg, db,
    truth)."""
    import numpy as np

    cfg = json.loads((REPO / "examples" / "dengue_surrogate.json").read_text())
    truth = np.array(json.loads(
        re.search(r"truth=(\[[^\]]*\])", cfg["comment"]).group(1)))
    print(f"host phases: smc_iterations {cfg['smc_iterations']} -> "
          f"{HOST_SETS} (widths unchanged)", flush=True)
    cfg["smc_iterations"] = HOST_SETS
    db = str(Path(tmp) / "dengue_host.sqlite")
    cfg["database_filename"] = db
    path = Path(tmp) / "dengue_host.json"
    path.write_text(json.dumps(cfg))
    return str(path), cfg, db, truth


def cli(*args):
    """``python -m abcsmc_tpu_torch`` as a subprocess on the card; returns
    (wall seconds, the [timing] entries, the kernel launches it counted)."""
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "abcsmc_tpu_torch", *args, "--verbose"],
        cwd=REPO, capture_output=True, text=True, timeout=900,
    )
    wall = time.perf_counter() - t0
    if run.returncode != 0:
        sys.stderr.write(run.stderr[-4000:])
    check(run.returncode == 0, f"cli {args} exited {run.returncode}")
    timings = [ast.literal_eval(line[len("[timing] "):])
               for line in run.stderr.splitlines()
               if line.startswith("[timing] ")]
    launches = int(re.search(r"\[kernel\] mixture_logsumexp\.launches (\d+)",
                             run.stderr).group(1))
    return wall, timings, launches


def store_rows(db):
    with closing(sqlite3.connect(db)) as con:
        return con.execute(
            "select smcSet, count(*), sum(status = 'D'), "
            "sum(posterior > -1) from job group by smcSet order by smcSet"
        ).fetchall()


def timing_split(timings):
    """Seconds per host-engine stage, summed over the run's entries."""
    keys = ("read_rank_weight_s", "rank_s", "weight_s", "propose_s",
            "enqueue_s", "claim_s", "sim_s", "writeback_s")
    return {k: sum(e.get(k, 0.0) for e in timings
                   if e["op"] in ("process", "simulate")) for k in keys}


def posterior_rmse(pars, truth):
    import numpy as np

    check(np.isfinite(pars).all(), "finite posterior")
    rmse_post = float(np.sqrt(((pars.mean(0) - truth) ** 2).mean()))
    rmse_prior = float(np.sqrt(((0.5 - truth) ** 2).mean()))
    check(rmse_post < rmse_prior,
          f"posterior rmse {rmse_post} >= prior {rmse_prior}")
    return rmse_post, rmse_prior


def phase_host_cli():
    import numpy as np
    import torch

    from abcsmc_tpu_torch import AbcSmc
    from abcsmc_tpu_torch.ops import stats
    from abcsmc_tpu_torch.ops.kernels import mixture_logsumexp_reference
    from abcsmc_tpu_torch.ops.weights import _prep_scaled

    n, keep = 102_400, 2_048
    with tempfile.TemporaryDirectory() as tmp:
        path, cfg, db, truth = dengue_host_config(tmp)
        wall, timings, launches = cli(path, "--process", "--simulate",
                                      "--all", "--seed", "1")
        rows = store_rows(db)
        check(rows == [(t, n, n, keep) for t in range(HOST_SETS)],
              f"host_cli store rows {rows}")
        ncomp = [e["ncomp_used"] for e in timings if e["op"] == "rank"]
        check(len(ncomp) == HOST_SETS and min(ncomp) > 1,
              f"host_cli ncomp {ncomp}")
        # every pass weighs each set it reads after set 0 in one auto call
        # (2 launches)
        calls = sum(e["sets"] - 1 for e in timings if e["op"] == "process")
        check(calls > 0 and launches == 2 * calls,
              f"host_cli kernel launches {launches} for {calls} auto calls")

        # the brain's state rebuilt by a brain pass on a copy of the store
        # (every set is ranked and the run is complete: the pass only reads
        # and weighs); these launches are not the main path's
        copy = str(Path(tmp) / "copy.sqlite")
        shutil.copyfile(db, copy)
        cfg["database_filename"] = copy
        eng = AbcSmc(cfg, device="cuda")
        with redirect_stderr(io.StringIO()):
            check(eng.process_database(seed=1), "host_cli: brain pass")
        eng.storage.close()
    post = [eng.posterior(t) for t in range(HOST_SETS)]
    rmse_post, rmse_prior = posterior_rmse(post[-1][0], truth)

    # each set's weights against the plain version on the same inputs, as
    # log-weights up to the normalisation: the kernel's bound of TOL nats on
    # every denominator bounds their spread by 2 * TOL
    spread = []
    for t in range(1, HOST_SETS):
        pars, prev = eng._tensor(post[t][0]), eng._tensor(post[t - 1][0])
        a, b, log_norm = _prep_scaled(pars, prev,
                                      stats.doubled_variance(prev))
        ref = mixture_logsumexp_reference(
            a.contiguous(), b.contiguous(),
            torch.log(eng._tensor(post[t - 1][1])))
        log_w = (eng.par_set.prior_log_pdf(pars) - (ref + log_norm)).double()
        d = np.log(post[t][1]) - log_w.cpu().numpy()
        live = log_w.cpu().numpy() > float(log_w.max()) - 80.0
        spread.append(float(np.ptp(d[live])))
    check(max(spread) <= 2 * TOL,
          f"host-path log-weights vs plain: spread {spread} nats")
    emit({"phase": "host_cli", "store_rows": rows, "ncomp": ncomp,
          "launches": launches, "auto_calls": calls, "wall_s": wall,
          "split_s": timing_split(timings),
          "per_set": [e for e in timings if e["op"] != "rank"],
          "log_weight_spread_nats": spread, "rmse_posterior": rmse_post,
          "rmse_prior": rmse_prior})
    return launches


def phase_resume():
    import numpy as np

    from abcsmc_tpu_torch import AbcSmc
    from abcsmc_tpu_torch.ops.kernels import mixture_logsumexp
    from abcsmc_tpu_torch.storage import SQLiteStorage

    n, keep, half = 102_400, 2_048, 51_200
    with tempfile.TemporaryDirectory() as tmp:
        path, cfg, db, truth = dengue_host_config(tmp)
        wall_p, _, _ = cli(path, "--process", "--seed", "1")
        wall_s, sim_timings, _ = cli(path, "--simulate", "-n", str(half))
        before = SQLiteStorage(db).read_generations()[0]
        done = before.statuses == "D"
        check(int(done.sum()) == half, f"resume: {int(done.sum())} rows done")
        mixture_logsumexp.launches = 0
        t0 = time.perf_counter()
        run = AbcSmc(cfg, device="cuda").run_device(seed=2)
        wall = time.perf_counter() - t0
        launches = mixture_logsumexp.launches
        run.storage.close()
        rows = store_rows(db)
        after = SQLiteStorage(db).read_generations()[0]
    check(rows == [(t, n, n, keep) for t in range(HOST_SETS)],
          f"resume store rows {rows}")
    check(np.array_equal(after.metrics[done], before.metrics[done]),
          "resume changed metrics of rows already done")
    # one auto call (2 launches) for each set after set 0
    check(launches == 2 * (HOST_SETS - 1),
          f"resume kernel launches {launches}")
    gens = [e for e in run.timings if e["op"] == "device_generation"]
    ncomp = [e["ncomp_used"] for e in gens]
    check(min(ncomp) > 1, f"resume ncomp {ncomp}")
    rmse_post, rmse_prior = posterior_rmse(run.posterior()[0], truth)
    emit({"phase": "resume", "store_rows": rows, "ncomp": ncomp,
          "launches": launches, "wall_s": wall,
          "cli_wall_s": {"process": wall_p, "simulate_half": wall_s},
          "simulate_half_split_s": timing_split(sim_timings),
          "set_ms": [e["device_ms"] for e in gens],
          "phases": [e for e in run.timings
                     if e["op"] == "run_device_phases"],
          "rmse_posterior": rmse_post, "rmse_prior": rmse_prior})
    return launches


def main() -> int:
    if not (REPO / "abcsmc_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(abcsmc_tpu_torch/ not found)", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    from abcsmc_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load_library("mixture_logsumexp")
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": _build.build_seconds["mixture_logsumexp"]})

    errs, times = phase_kernel()
    launches = (phase_dengue() + phase_north() + phase_host_cli()
                + phase_resume())
    n, m, p = KERNEL_SHAPES[-1]
    big = f"{n}x{m}x{p}"
    bound = kernel_bound_ms(n, m, p)
    emit({"kernels": [{
        "name": "mixture_logsumexp",
        "route": "cuda",
        "source": "abcsmc_tpu_torch/csrc/mixture_logsumexp.cu",
        "replaces": "abcsmc_tpu/ops/pallas_kernels.py:166",
        "launches": launches,
        "max_abs_err": max(v for k, v in errs.items() if "rel" not in k),
        "ms": times[big]["ms"],
        "plain_ms": times[big]["plain_ms"],
        "bound_ms": bound["bound_ms"],
        "bound_by": bound["bound_by"],
        "bound_share": bound["bound_ms"] / times[big]["ms"],
        "library_ms": None,
        "shape": [n, m, p],
        "ms_static": times[big]["ms_static"],
        "ms_online": times[big]["ms_online"],
        "bound_terms_ms": bound["terms_ms"],
    }]})
    emit({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
