#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (abcsmc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases (each prints one JSON line; any failure raises and exits nonzero):

1. build   - compile csrc/mixture_logsumexp.cu with nvcc (sm_90a), timed;
2. kernel  - the kernel against its plain PyTorch version on the card, f32,
             at 2,048 x 2,048 x 16, 50,000 x 50,000 x 6 and 52,429 x 52,429
             x 2 (the large main paths' shapes, all timed), at every shape
             the shipped examples of phase 7 give it (survivors of set t x
             survivors of set t - 1 x parameters, read from their configs:
             128-410 rows, p = 2-4, none a multiple of a tile), 4,096^2 x
             80, 2,048^2 x 1 and a ragged
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
5. host_cli - dengue_surrogate (2 sets) through the host engine's job queue:
             ``python -m abcsmc_tpu_torch cfg --process --simulate --all``
             as a subprocess: 2 complete SQLite sets of 2,048 ranked rows,
             ncomp_used > 1 in every ranking, 2 kernel launches per weight
             call, posterior closer to the truth than the prior; the weights
             of every set after set 0, rebuilt by a brain pass on a copy of
             the store, held against the plain version on the same inputs
             (log-weights within 2 x 2e-4 nats of each other);
6. resume  - dengue_surrogate: ``--process`` then ``--simulate -n 51200``
             (set 0 half done) as subprocesses, then
             AbcSmc(cfg, device="cuda").run_device() finishes 2 sets with 2
             kernel launches per set after set 0; the 51,200 rows simulated
             first keep their metrics;
7. examples - sir, lv, ricker, gk, mg1, ma2 and dice exactly as shipped
             (sizes, sets, noise; SQLite store under build/smoke/) through
             AbcSmc(cfg).run_device(): complete ranked sets, ncomp_used >= 1,
             2 kernel launches in every set after set 0, each at a shape
             that phase 2 held against plain, and the posterior
             mean closer to the truth of the config's comment than the
             prior mean (SIR beta and gamma, LV rates, g-and-k location and
             scale, MA(2) thetas); per example the wall, the per-set device
             milliseconds with the simulate stage apart, the MULTIVARIATE
             retry rounds, and the replay of stored seeds in another batch
             on the card (bit-equal, but for the Ricker autocorrelations
             and the M/G/1 cumulative sums, held to a stated tolerance);
8. sir_1m  - examples/sir.json with 1,048,576 particles, 3 sets, Box-Cox
             on, in-memory store: MULTIVARIATE proposal of 1M rows, Box-Cox
             over 1M x 6, the 160-step SIR loop over 1M particles, the
             kernel at 52,429^2 x 2; simulate apart from the rest of the
             step, peak device memory, chosen lambdas, launches;
9. projection - examples/pseudo.json as shipped through the CLI; a PSEUDO
             sweep of 320 x 320 = 102,400 dice combinations (one claim, one
             batch_fn call, writeback); a POSTERIOR replay whose source is
             the sir store of phase 7. Row counts, all 'D', odometer order
             of the first and last rows, 0 kernel launches.

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
KERNEL_SHAPES = ((2048, 2048, 16), (50_000, 50_000, 6), (52_429, 52_429, 2))
REPORT_SHAPE = (50_000, 50_000, 6)    # the kernels line's ms / bound_ms
SMOKE_DIR = REPO / "build" / "smoke"  # the example phases' stores
SIR_1M = (1_048_576, 52_429)          # particles, survivors (5 %) of sir_1m
SWEEP_SIDE = 320                      # the PSEUDO sweep is SWEEP_SIDE^2 rows
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


def example_kernel_shapes():
    """Every (n, m, p) the shipped examples of the ``examples`` phase give
    the kernel, read from their configs: set t weighs its survivors against
    those of set t - 1."""
    from abcsmc_tpu_torch.config import parse_config

    shapes = set()
    for name in EXAMPLES:
        cfg = parse_config(
            json.loads((REPO / "examples" / f"{name}.json").read_text()))
        keeps = [cfg.pred_prior_size_at(t) for t in range(cfg.num_smc_sets)]
        shapes |= {(keeps[t], keeps[t - 1], len(cfg.parameters))
                   for t in range(1, len(keeps))}
    return sorted(shapes)


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

    # the shipped examples' shapes (small, no multiple of a tile); any p
    # (the templates of the first port stopped at 64), tiny and ragged
    example_shapes = example_kernel_shapes()
    check(example_shapes, "no example shapes")
    for n, m, p in (*example_shapes, *EXTRA_SHAPES):
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
    emit({"phase": "kernel", "max_abs_err": errs, "times": times,
          "example_shapes": example_shapes})
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


HOST_SETS = 2       # the host phases cut dengue_surrogate's sets, not widths


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


# name -> (truth as the config's comment states it, indices of the
# parameters whose posterior mean must beat the prior mean, the most a
# metric may move, relative to max(1, |metric|), when its stored seed is
# replayed in another batch on the card: 0 wherever an H100 read no
# difference; the Ricker autocorrelations moved by one float32 unit in the
# last place there and the M/G/1 cumulative sums by 5e-5)
EXAMPLES = {
    "sir": ((0.30, 0.10), (0, 1), 0.0),
    "lv": ((1.0, 0.1), (0, 1), 0.0),
    "ricker": ((3.8, 0.3, 10.0), (), 2e-7),
    "gk": ((3.0, 1.0, 2.0, 0.5), (0, 1), 0.0),
    "mg1": ((1.0, 5.0, 0.2), (), 1e-4),
    "ma2": ((0.6, 0.2), (0, 1), 0.0),
    "dice": ((13.0, 8.0), (), 0.0),
}


def fresh_store(name):
    SMOKE_DIR.mkdir(parents=True, exist_ok=True)
    db = SMOKE_DIR / name
    db.unlink(missing_ok=True)
    return str(db)


def replay_diff(run, n, tol):
    """The config's simulator on ``n`` prior draws in one batch, and its
    first 4 rows again in a batch of their own (a small batch is where the
    card reduces a row in another order), as a resumed run replays stored
    seeds: the largest |difference| / max(1, |metric|), checked against
    ``tol`` (0: bit for bit)."""
    import torch

    gen = torch.Generator(device=run.device).manual_seed(1)
    params = run.par_set.sample_priors(gen, n, run.dtype)
    upars = run.transform.to_model_space(params).to(run.dtype)
    seeds = torch.randint(0, 2**31 - 1, (n,), generator=gen,
                          device=run.device)
    k = 4
    whole = run.simulator.batch_fn(upars, seeds)[:k]
    part = run.simulator.batch_fn(upars[:k], seeds[:k])
    diff = float(((part - whole).abs()
                  / whole.abs().clamp_min(1.0)).max())
    check(diff <= tol, f"{run.config.simulator_name}: replay in another batch "
          f"moved a metric by {diff} (allowed {tol})")
    return diff


def fit_report(run, cfg, truth, must_beat):
    """Checks and numbers shared by the fits: ncomp, the posterior against
    the truth and the prior mean, per-set device time and MVN rounds."""
    import numpy as np

    gens = [e for e in run.timings if e["op"] == "device_generation"]
    ncomp = [e["ncomp_used"] for e in gens]
    check(len(gens) == cfg["smc_iterations"] and min(ncomp) >= 1,
          f"{cfg['simulator']} ncomp {ncomp}")
    pars, w = run.posterior()
    check(np.isfinite(pars).all() and np.isfinite(w).all(),
          f"{cfg['simulator']}: finite posterior")
    post = pars.mean(0)
    prior = run.par_set.means()
    truth = np.array(truth)
    for j in must_beat:
        check(abs(post[j] - truth[j]) < abs(prior[j] - truth[j]),
              f"{cfg['simulator']} parameter {j}: posterior mean {post[j]} "
              f"not closer to {truth[j]} than the prior mean {prior[j]}")
    return {
        "ncomp": ncomp, "set_ms": [e["device_ms"] for e in gens],
        "simulate_ms": [e["simulate_ms"] for e in gens],
        "mvn_rounds": [e["mvn_rounds"] for e in gens],
        "posterior_mean": post.tolist(), "truth": truth.tolist(),
        "prior_mean": prior.tolist(),
        "phases": [e for e in run.timings
                   if e["op"] == "run_device_phases"],
    }


def phase_examples():
    from abcsmc_tpu_torch import AbcSmc
    from abcsmc_tpu_torch.ops.kernels import mixture_logsumexp

    total = 0
    held = set(example_kernel_shapes())
    for name, (truth, must_beat, replay_tol) in EXAMPLES.items():
        cfg = json.loads((REPO / "examples" / f"{name}.json").read_text())
        db = cfg["database_filename"] = fresh_store(f"{name}.sqlite")
        n_sets = cfg["smc_iterations"]
        mixture_logsumexp.launches = 0
        t0 = time.perf_counter()
        with redirect_stderr(io.StringIO()):
            run = AbcSmc(cfg).run_device(seed=0)
        wall = time.perf_counter() - t0
        launches = mixture_logsumexp.launches
        total += launches
        run.storage.close()
        rows = store_rows(db)
        sizes = [run.config.smc_size_at(t) for t in range(n_sets)]
        keeps = [run.config.pred_prior_size_at(t) for t in range(n_sets)]
        check(rows == [(t, sizes[t], sizes[t], keeps[t])
                       for t in range(n_sets)], f"{name} store rows {rows}")
        # one auto call (2 launches) for each set after set 0, at a shape
        # that the kernel phase held against the plain version
        check(launches == 2 * (n_sets - 1),
              f"{name} kernel launches {launches}")
        npar = len(cfg["parameters"])
        check({(keeps[t], keeps[t - 1], npar)
               for t in range(1, n_sets)} <= held,
              f"{name}: a kernel shape was not held against plain")
        report = fit_report(run, cfg, truth, must_beat)
        emit({"phase": "examples", "example": name, "noise": cfg["noise"],
              "sizes": sizes[:2], "sets": n_sets, "wall_s": wall,
              "launches": launches,
              "replay_other_batch_max_rel_diff":
                  replay_diff(run, max(sizes), replay_tol),
              **report})
    return total


def phase_sir_1m():
    import torch

    from abcsmc_tpu_torch import AbcSmc
    from abcsmc_tpu_torch.ops.kernels import mixture_logsumexp

    cfg = json.loads((REPO / "examples" / "sir.json").read_text())
    (n, want_keep), n_sets = SIR_1M, 3
    cfg.update(num_samples=n, smc_iterations=n_sets, box_cox=True,
               database_filename="")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mixture_logsumexp.launches = 0
    t0 = time.perf_counter()
    with redirect_stderr(io.StringIO()):
        run = AbcSmc(cfg).run_device(seed=0)
    wall = time.perf_counter() - t0
    launches = mixture_logsumexp.launches
    peak = torch.cuda.max_memory_allocated()
    keep = run.config.pred_prior_size_at(0)
    check(keep == want_keep, f"sir_1m keep {keep}")
    stored = run.storage.read_generations()
    check([(g.size, len(g.predictive_prior_indices())) for g in stored]
          == [(n, keep)] * n_sets, "sir_1m store sets")
    check(launches == 2 * (n_sets - 1), f"sir_1m kernel launches {launches}")
    report = fit_report(run, cfg, *EXAMPLES["sir"][:2])
    gens = [e for e in run.timings if e["op"] == "device_generation"]
    lambdas = [e["box_cox_lambdas"] for e in gens]
    check(all(len(lam) == 6 for lam in lambdas), "sir_1m lambdas")
    emit({"phase": "sir_1m", "n": n, "keep": keep, "sets": n_sets,
          "wall_s": wall, "launches": launches,
          "rest_of_step_ms": [ms - sim for ms, sim in
                              zip(report["set_ms"], report["simulate_ms"])],
          "peak_memory_bytes": peak, "box_cox_lambdas": lambdas, **report})
    return launches


def phase_projection():
    import numpy as np

    from abcsmc_tpu_torch import AbcSmc
    from abcsmc_tpu_torch.ops.kernels import mixture_logsumexp
    from abcsmc_tpu_torch.storage import SQLiteStorage

    def done_rows(db):
        with closing(sqlite3.connect(db)) as con:
            return con.execute(
                "select count(*), sum(status = 'D') from job").fetchone()

    # examples/pseudo.json as shipped, through the CLI
    cfg = json.loads((REPO / "examples" / "pseudo.json").read_text())
    db = cfg["database_filename"] = fresh_store("pseudo.sqlite")
    path = SMOKE_DIR / "pseudo.json"
    path.write_text(json.dumps(cfg))
    wall_cli, timings, launches_cli = cli(str(path), "--process",
                                          "--simulate", "--all",
                                          "--seed", "0")
    check(done_rows(db) == (25, 25), f"pseudo rows {done_rows(db)}")
    gen = SQLiteStorage(db).read_generations()[0]
    check(gen.params[:6].tolist() == [[1, 2], [2, 2], [3, 2], [4, 2],
                                      [5, 2], [1, 4]]
          and gen.params[-1].tolist() == [5, 10], "pseudo odometer order")
    check(launches_cli == 0, f"pseudo kernel launches {launches_cli}")

    # a PSEUDO sweep at a size a study would run: 320 x 320 dice games
    side = SWEEP_SIDE
    sweep = dict(cfg, database_filename=fresh_store("sweep.sqlite"))
    sweep["parameters"] = [
        {"name": "number of dice", "short_name": "ndice",
         "dist_type": "PSEUDO", "num_type": "INT", "par1": 1, "par2": side},
        {"name": "number of sides", "short_name": "sides",
         "dist_type": "PSEUDO", "num_type": "INT", "par1": 1, "par2": side},
    ]
    mixture_logsumexp.launches = 0
    t0 = time.perf_counter()
    with redirect_stderr(io.StringIO()):
        run = AbcSmc(sweep).run_device(seed=0)
    wall_sweep = time.perf_counter() - t0
    run.storage.close()
    sims = [e for e in run.timings if e["op"] == "simulate_device"]
    check([e["n"] for e in sims] == [side * side],
          f"sweep: one claim and one call, got {sims}")
    check(done_rows(sweep["database_filename"]) == (side * side,) * 2,
          "sweep rows")
    pars, mets = run.particle_parameters[0], run.particle_metrics[0]
    check(pars[0].tolist() == [1, 1] and pars[1].tolist() == [2, 1]
          and pars[side].tolist() == [1, 2]
          and pars[-1].tolist() == [side, side], "sweep odometer order")
    check(bool(np.all((mets[:, 0] >= pars[:, 0])
                      & (mets[:, 0] <= pars[:, 0] * pars[:, 1]))),
          "sweep: every sum within [ndice, ndice * sides]")

    # a POSTERIOR replay of the sir fit of the examples phase: 4 replicates
    # of each of the first 410 posterior rows, source ranks retained
    src = str(SMOKE_DIR / "sir.sqlite")
    sir = json.loads((REPO / "examples" / "sir.json").read_text())
    n_post, n_rep = 410, 4
    replay = {
        "simulator": "sir", "metrics": sir["metrics"],
        "database_filename": fresh_store("sir_replay.sqlite"),
        "posterior_database_filename": src, "retain_posterior_rank": True,
        "parameters": [
            {"name": p["name"], "short_name": p["short_name"],
             "dist_type": "POSTERIOR", "num_type": "FLOAT", "par1": 0,
             "par2": n_post - 1} for p in sir["parameters"]
        ] + [{"name": "replicate", "dist_type": "PSEUDO", "num_type": "INT",
              "par1": 0, "par2": n_rep - 1}],
    }
    t0 = time.perf_counter()
    with redirect_stderr(io.StringIO()):
        rep = AbcSmc(replay).run_device(seed=0)
    wall_replay = time.perf_counter() - t0
    rep.storage.close()
    check(done_rows(replay["database_filename"])
          == (n_post * n_rep,) * 2, "replay rows")
    source = SQLiteStorage(src).read_posterior_matrix(["beta", "gamma"])
    rpars = rep.particle_parameters[0]
    # the engine works in float32: the stored values are the source's,
    # rounded once
    check(np.array_equal(
        rpars[:, :2].astype(np.float32),
        np.repeat(source[:n_post], n_rep, 0).astype(np.float32))
          and rpars[:2 * n_rep, 2].tolist() == list(range(n_rep)) * 2,
          "replay: posterior rows in rank order, replicate fastest")
    got = SQLiteStorage(replay["database_filename"]).read_generations()[0]
    check(got.posterior_ranks.tolist()
          == np.repeat(np.arange(n_post), n_rep).tolist(),
          "replay: retained source ranks")
    check(bool(np.isfinite(rep.particle_metrics[0]).all()), "replay metrics")
    check(mixture_logsumexp.launches == 0,
          f"projection kernel launches {mixture_logsumexp.launches}")
    emit({"phase": "projection", "kernel_launches": 0,
          "note": "a projection has no weights: no kernel on this path",
          "pseudo_cli": {"rows": 25, "wall_s": wall_cli,
                         "split": [e for e in timings
                                   if e["op"] in ("simulate",
                                                  "simulate_device")]},
          "sweep": {"rows": side * side, "wall_s": wall_sweep, **sims[0]},
          "replay": {"rows": n_post * n_rep, "wall_s": wall_replay,
                     **[e for e in rep.timings
                        if e["op"] == "simulate_device"][0]}})
    return 0


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
                + phase_resume() + phase_examples() + phase_sir_1m()
                + phase_projection())
    n, m, p = REPORT_SHAPE
    big = f"{n}x{m}x{p}"
    bound = kernel_bound_ms(n, m, p)
    n2, m2, p2 = KERNEL_SHAPES[-1]
    small_p = f"{n2}x{m2}x{p2}"
    bound_p2 = kernel_bound_ms(n2, m2, p2)
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
        "p2": {"shape": [n2, m2, p2], "ms": times[small_p]["ms"],
               "plain_ms": times[small_p]["plain_ms"],
               "ms_static": times[small_p]["ms_static"],
               "ms_online": times[small_p]["ms_online"],
               "bound_ms": bound_p2["bound_ms"],
               "bound_by": bound_p2["bound_by"],
               "bound_share": bound_p2["bound_ms"] / times[small_p]["ms"]},
    }]})
    emit({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
