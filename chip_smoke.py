#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (abcsmc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases (each prints one JSON line; any failure raises and exits nonzero):

1. build   - compile csrc/mixture_logsumexp.cu with nvcc (sm_90a), timed;
2. kernel  - the kernel against its plain PyTorch version on the card, f32,
             at 2,048 x 2,048 x 16 and 50,000 x 50,000 x 6 in the static,
             online and auto modes, plus the underflow case and true -inf
             weights; max abs diff <= 2e-4 nats; both versions timed;
3. dengue  - examples/dengue_surrogate.json through
             AbcSmc(cfg, device="cuda").run_device(): 5 complete SQLite sets
             of 2,048 ranked rows, ncomp_used > 1 in each, >= 4 kernel
             launches, posterior mean closer to the stated truth than the
             prior mean;
4. north   - 1,000,000 particles x 6 parameters x 13 metrics, keep 50,000,
             3 sets, in-memory store: >= 2 kernel launches, ncomp_used > 1.

Then the kernel summary line and, last, the device line. There is no CPU
path: without CUDA (or outside a checkout) it exits nonzero and prints no
result.
"""

import json
import math
import re
import sqlite3
import subprocess
import sys
import tempfile
import time
from contextlib import closing
from pathlib import Path

REPO = Path(__file__).resolve().parent
TOL = 2e-4          # nats; the bound of tests/test_pallas_kernels.py
KERNEL_SHAPES = ((2048, 2048, 16), (50_000, 50_000, 6))


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

    from abcsmc_tpu_torch import AbcSmc
    from abcsmc_tpu_torch.models.simulators import (
        make_linear_gaussian_simulator,
    )
    from abcsmc_tpu_torch.ops.kernels import mixture_logsumexp

    npar, nmet, n, keep, n_sets = 6, 13, 1_000_000, 50_000, 3
    truth = np.random.default_rng(42).uniform(0.2, 0.8, npar)
    sim = make_linear_gaussian_simulator(npar, nmet, noise_sd=0.1)
    obs = sim.run_batch(truth[None, :], np.array([7]))[0]
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
    launches = phase_dengue() + phase_north()
    big = "x".join(str(v) for v in KERNEL_SHAPES[-1])
    emit({"kernels": [{
        "name": "mixture_logsumexp",
        "route": "cuda",
        "source": "abcsmc_tpu_torch/csrc/mixture_logsumexp.cu",
        "replaces": "abcsmc_tpu/ops/pallas_kernels.py:166",
        "launches": launches,
        "max_abs_err": max(v for k, v in errs.items() if "rel" not in k),
        "ms": times[big]["ms"],
        "plain_ms": times[big]["plain_ms"],
    }]})
    emit({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
