#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (abcsmc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases (each prints one JSON line; any failure raises and exits nonzero):

1. build   - compile csrc/mixture_logsumexp.cu with nvcc (sm_90a), timed;
2. kernel  - the kernel (its 3xTF32 scheme, "high", the config default)
             against its plain PyTorch version on the card, f32,
             at 2,048 x 2,048 x 16, 10,000^2 x 6, 50,000 x 50,000 x 6 and
             52,429 x 52,429 x 2 (the large main paths' shapes, all timed),
             at every shape phases 15 and 16 give it, at every shape
             the shipped examples of phase 7 give it (survivors of set t x
             survivors of set t - 1 x parameters, read from their configs:
             128-410 rows, p = 2-4, none a multiple of a tile), at every
             per-shard shape of phase 13's mesh fits, 4,096^2 x
             80, 2,048^2 x 1 and a ragged
             37 x 1,000 x 1, in the static, online and auto modes (the
             BF16 "default" and FP32 FMA "highest" schemes there too, auto,
             each against its own plain version); a hostile 20,000^2 x 16
             case (coordinates up to 6 kernel sd) against the plain version
             in float64 ("high" and "highest"); the underflow case; true
             -inf weights (every scheme); one auto call of each scheme
             under torch.cuda.set_sync_debug_mode("error"); then every
             scheme at those four large shapes, 200,000 x 50,000 x 13 and
             the shipped survivor keeps (every example's keep_t x
             keep_{t-1} x p, 2,048^2 x 16, 10,000 x 5,000 x 6 and
             10,000^2 x 6, all in short splits: the prologue and one
             launch a pass) in every mode against its own plain version, auto
             timed three ways (``ms`` host-paced, ``device_ms`` from a
             replayed CUDA graph of the calls, ``host_us`` to enqueue one)
             beside its plain version, its bound and the issue-slot floor
             (``issue_model_ms``, a model term: not part of the bound,
             not measured, and left out of the kernels line), its
             kernels one call launched in each mode, the prologue
             counted, as the C entry counts them (checked equal to the
             plan's count; tests/test_torch_gpu.py also holds them to a
             torch.profiler trace), its error against float64 on 4,096 rows ("default"
             at least 10x "high"'s at 50,000^2);
             max abs diff <= 2e-4 nats; then the sir loop's kernel
             (csrc/sir_loop.cu) at sir_1m's 1,048,576 rows x 160 days
             against its plain PyTorch chain on the same rows, bit for
             bit, both timed beside the loop's least time; and the ricker
             loop's kernel (csrc/ricker_loop.cu) at ricker_1m's 1,048,576
             rows x 150 steps the same way;
3. dengue  - examples/dengue_surrogate.json through
             AbcSmc(cfg, device="cuda").run_device(), cut to 3 sets: complete
             SQLite sets of 2,048 ranked rows, ncomp_used > 1 in each, 2
             kernel launches per set after set 0, posterior mean closer to
             the stated truth than the prior mean (all 5 sets run in phase
             11);
4. north   - 1,000,000 particles x 6 parameters x 13 metrics, keep 50,000,
             3 sets, in-memory store: >= 2 kernel launches, ncomp_used > 1;
5. host_cli - dengue_surrogate (2 sets) through the host engine's job queue:
             ``python -m abcsmc_tpu_torch cfg --process --simulate --all``
             as a subprocess: 2 complete SQLite sets of 2,048 ranked rows,
             ncomp_used > 1 in every ranking, 2 kernel launches per weight
             call, posterior closer to the truth than the prior; the weights
             of every set after set 0, rebuilt by a brain pass on a copy of
             the store, held against the plain version on the same inputs
             (log-weights within 2 x 2e-4 nats of each other); the brain's
             launches all of the "highest" scheme (JAX's default there);
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
             on the card (bit for bit, every example);
8. sir_1m  - examples/sir.json with 1,048,576 particles, 3 sets, Box-Cox
             on, in-memory store: MULTIVARIATE proposal of 1M rows, Box-Cox
             over 1M x 6, the 160-step SIR loop over 1M particles, the
             kernel at 52,429^2 x 2; simulate apart from the rest of the
             step, peak device memory, chosen lambdas, launches (each
             simulator loop kernel's, read right after every run here and
             in phases 7, 11 and 13: once a set and shard for the kernel of
             the run's simulator, sir's or ricker's, none for the other);
9. projection - examples/pseudo.json as shipped through the CLI; a PSEUDO
             sweep of 320 x 320 = 102,400 dice combinations (one claim, one
             batch_fn call, writeback); a POSTERIOR replay whose source is
             the sir store of phase 7. Row counts, all 'D', odometer order
             of the first and last rows, 0 kernel launches;
10. hbm_scale - the generation step alone at 6 parameters x 13 metrics,
             keep 5 %, data made on the card, at 2^24, 2^25 and 2^26 rows:
             resident row passes against row_block = 2^21, each with the
             proposal inside the step and apart from it (rank, free the
             population, propose): ms, peak bytes, bytes per row,
             ncomp_used (> 1 and equal), survivor overlap (>= 99.9 %),
             doubled variance (rtol 1e-3); the kernel at each step's shape
             against plain on 4,096 sampled query rows; the auto rule's two
             limits, and one chunked + split step at the largest power of
             two under the limit (keep capped at 2^22 there: the weight
             kernel is quadratic in keep); then run_device(mirror_store=
             False) at 2^24 x 6 x 13, 2 sets, row_block and propose_split
             set in the config;
11. fused   - dengue_surrogate, ricker, gk and mg1 as shipped under
             device_dispatch "sequential" (twice) and "fused", one seed:
             the fused run's stored rows, ranks and weights equal the
             sequential run's as far as two sequential runs agree (bit for
             bit where they do); per-set ms by route, capture seconds,
             programs, launches; a 30-set schedule of 300, 500, 500, 750,
             then 1,000 rows (dice, INDEPENDENT noise) through run_chain
             with an nrmse_tolerance that cuts inside the 1,000-row bucket;
             sir and dice (MULTIVARIATE noise) as shipped under
             "sequential" and "fused": the MVN step captured once and
             replayed, stored rows, ranks and weights bit-equal; dice
             sequential with a rejection block of 1 round (a host read per
             round) against the default block: the eager price of the
             block, the same rows; dice fused with a block of 2 rounds
             (every replayed set finishes its rounds eagerly after the
             replay), bit-equal too, with the kernel inside each replayed
             MVN graph held against plain; per example the eager and the
             replayed set ms, the rejection rounds per set and the sets
             finished eagerly; the kernel inside a replayed graph against
             plain;
12. surfaces - on the dengue store of phase 3: checkpoint to a new path,
             crc32.verify_checkpoint, compare() of the store with its
             checkpoint (KS 0), ess in (1, keep], posterior_summary medians
             inside the prior bounds, posterior_predictive(1000) on the
             card.

13. mesh    - the particle mesh on the one card: the north-star step
             (1,000,000 x 6 x 13, keep 50,000, float32, data made on the
             card) on one shard and on 4 shards of cuda:0 (same survivors
             and ncomp_used > 1, weights and doubled variance within 1e-3
             and 1e-4 of the one-shard step, the gaps printed), with the
             two-stage top-K (bit-equal to the single stage) and through a
             one-rank NCCL group (bit-equal to the one-shard step); every
             per-shard kernel call (12,500 x 50,000 x 6) against plain and
             beside its bound; step ms; dengue_surrogate as shipped on 3
             shards (102,400 rows pad to 102,402), 3 sets, SQLite, beating
             the prior; sir and dice (systematic resampling) as shipped on
             2 shards with their MULTIVARIATE rounds per set; each of these
             fits' per-shard kernel shapes (ceil(keep_t / shards) x
             keep_{t-1} x p) held in phase 2 before it runs; a mesh over
             several cards where the machine has them, its per-shard
             kernel against plain (one line says why it did not run
             otherwise); the pick's cdf scan repeated 30 times at 50,000,
             2^22 and 2^26 entries (no repeat may differ) beside
             torch.cumsum's.
14. study   - the ten study harnesses of abcsmc_tpu_torch.tools, each
             through its main() in this process (STUDY_RUNS): the weight
             kernel at 50,000^2, 200,000^2 and 500,000^2 x 6 (auto and
             online) and apart at 838,860^2 and 1,677,721^2 x 6 (the
             keeps of hbm_scale's 2^24 and 2^25 steps), each within 2e-4
             nats of the float64 plain version on 4,096 sampled rows, the
             truncation study and a 10M x 6 x 13 generation with 500,000
             survivors; the center-split sweep at 200,000^2 x 6 (every
             split within the launch plan's cap held to 2e-4 nats); one
             50M-row generation with keep 500,000; run_device with the
             SQLite mirror at 1M rows; the reference-shape fit twice; the
             30-set quick-start; the 1M-particle run; truth recovery at
             the JAX tool's sizes in float32 (its own bounds); SBC with 10
             replicates of each configuration at n = 1,024; the native
             pool with 500 jobs. A harness's failed check ends the run.
15. bench   - the JAX repo's last entry points as ported, in process:
             ``abcsmc_tpu_torch.bench`` at 1,000,000 x 6 x 13, keep 50,000,
             on one card, both routes (one JSON line each, ncomp_used > 1;
             the replay held bit-equal to eager first); ``bench_extra``
             at the JAX sizes (PLS fit, the kernel at 10,000^2, 50,000^2
             and 200,000^2 x 6, the 1M resample, the step at 100,000 and 1M
             with and without the simulator); ``graft_entry.entry()``'s fn;
             ``dryrun_multichip(4)`` on a 4-shard mesh of the card (its
             3-set chain replayed from a CUDA graph, the two-process gloo
             engine run included); ``tools.scaling_analysis`` at 1,048,576
             rows on 1, 2, 4 and 8 shards and 4,194,304 on 8 (reduction
             payloads equal within a top-K strategy, and across all rows
             with the single-stage top-K forced). Every kernel launch of
             the phase is at a shape phase 2 held (checked at launch).
16. bridge  - a black-box host simulator inside run_device's step:
             dengue_surrogate at its shipped widths (102,400 x 16 x 100,
             keep 2,048), 3 sets, SQLite, its simulator a numpy
             linear-Gaussian (the shipped mixing matrix, 0.3-sd normals
             from a numpy counter hash of (seed, column)) behind
             HostBridgeSimulator: every set eager, no graph captured,
             ncomp_used > 1, posterior closer to the truth than the
             prior, per set ms and the host round trip (simulate_ms), the
             run wall beside host_cli's where this call ran it, the kernel
             at each set's shape against plain; the same run under
             device_dispatch "fused" (0 captures, stored rows bit-equal);
             the dice game bridged on a 4-shard mesh of the card, 96 rows
             x 3 sets, its host function's journal equal to the stored
             rows as multisets, one call per shard and set;
             ``tools.validate`` in process at the JAX tool's sizes (the
             kernel at four shapes against plain, the 1M step, chunked
             against resident; its launches, mostly comparisons and
             timings, are printed apart and not counted).

17. precision - examples/dengue_surrogate.json at its widths, 3 sets, in
             memory, under each weight_precision ("highest", "high",
             "default"): each run launches its own scheme only, 4 launches,
             ncomp_used > 1, posterior closer to the truth than the prior,
             per-set ms, each set's kernel call against its scheme's plain
             version; on one set's inputs the weight stage's log-densities
             of each scheme as the max abs difference from "highest".

``python3 chip_smoke.py --only fused,surfaces`` runs the build, the named
phases (dengue too where surfaces is named) and the closing lines alone;
``--only host_cli,bridge`` puts the bridged wall beside the host engine's
of the same call; ``--only precision`` runs the build, the kernel phase
and the schemes' fits.

Each phase prints its wall time (the ``walls`` line gathers them and the
script's); the host phases also print the engine's timings split
(read/rank/weight, propose, enqueue, claim, simulate, writeback). Then the
kernel summary line: one entry per dot scheme ("high" 3xTF32, "default"
BF16, "highest" FP32 FMA), each with its launches summed over every
phase's main path, and the sir loop's kernel, and, last, the device line. There is no CPU path:
without CUDA (or outside a checkout) it exits nonzero and prints no
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
from contextlib import closing, redirect_stderr, redirect_stdout
from pathlib import Path

REPO = Path(__file__).resolve().parent
TOL = 2e-4          # nats; the bound of tests/test_pallas_kernels.py
KERNEL_SHAPES = ((2048, 2048, 16), (10_000, 10_000, 6), (50_000, 50_000, 6),
                 (52_429, 52_429, 2))
REPORT_SHAPE = (50_000, 50_000, 6)    # the kernels line's ms / bound_ms
SMOKE_DIR = REPO / "build" / "smoke"  # the example phases' stores
SIR_1M = (1_048_576, 52_429)          # particles, survivors (5 %) of sir_1m
SWEEP_SIDE = 320                      # the PSEUDO sweep is SWEEP_SIDE^2 rows
EXTRA_SHAPES = ((4096, 4096, 80), (2048, 2048, 1), (37, 1000, 1))
# every dot scheme is held and timed at these, beside its own plain version
SCHEME_SHAPES = KERNEL_SHAPES + ((200_000, 50_000, 13),)
PRECISIONS = ("high", "default", "highest")
# the kernels line's entry of each scheme
KERNEL_NAMES = {"high": "mixture_logsumexp",
                "default": "mixture_logsumexp_bf16",
                "highest": "mixture_logsumexp_f32"}
PRECISION_SETS = 3  # the precision phase cuts dengue_surrogate's sets
# the mesh phase's fits: example -> (shards, sets; None = as shipped)
MESH_RUNS = {"dengue_surrogate": (3, 3), "sir": (2, None), "dice": (2, None)}
HELD = set()        # every (n, m, p, precision) held against plain


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def drop_issue_floor(rows):
    """kernel_schemes rows by shape without the issue-slot floor, a model
    term that the kernels line does not carry."""
    return {key: {k: v for k, v in row.items() if k != "issue_model_ms"}
            for key, row in rows.items()}


def cuda_ms(fn, reps):
    """Mean milliseconds per call (``bench_kernel.cuda_ms``: CUDA events
    around ``reps`` calls after one warm-up call)."""
    from abcsmc_tpu_torch.bench_kernel import cuda_ms as timer

    return timer(fn, reps)


def graph_ms(fn, reps):
    """Device milliseconds per call (``bench_kernel.graph_ms``: ``reps``
    calls captured into one CUDA graph, events around its replays)."""
    from abcsmc_tpu_torch.bench_kernel import graph_ms as timer

    return timer(fn, reps)


def host_us(fn, reps):
    """Host microseconds to enqueue one call (``bench_kernel.host_us``)."""
    from abcsmc_tpu_torch.bench_kernel import host_us as timer

    return timer(fn, reps)


def keep_shapes():
    """The survivor keeps the main paths give the kernel most: every
    shipped example's keep_t x keep_{t-1} x p (``example_kernel_shapes``),
    dengue_surrogate's 2,048^2 x 16, and ``tools.validate``'s and
    ``bench_extra``'s 10,000 x 5,000 x 6 and 10,000^2 x 6."""
    return sorted(set(example_kernel_shapes())
                  | {(2048, 2048, 16), (10_000, 5_000, 6),
                     (10_000, 10_000, 6)})


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


def kernel_bound_ms(n, m, p, precision="high"):
    """``bench_kernel.kernel_bound_ms``: the least time the card could
    take for one call at n x m x p in the scheme ``precision``, and what
    bounds it."""
    from abcsmc_tpu_torch.bench_kernel import kernel_bound_ms as bound

    return bound(n, m, p, precision)


def with_high(shapes):
    """(n, m, p) shapes as HELD keys of the config default's scheme."""
    return {(*s, "high") for s in shapes}


def example_kernel_shapes():
    """Every (n, m, p) the shipped examples of the ``examples`` phase and
    the ``fused`` phase's 30-set schedule give the kernel, read from their
    configs: set t weighs its survivors against those of set t - 1."""
    from abcsmc_tpu_torch.config import parse_config

    shapes = set()
    raws = [json.loads((REPO / "examples" / f"{name}.json").read_text())
            for name in EXAMPLES] + [chain_config()]
    for raw in raws:
        cfg = parse_config(raw)
        keeps = [cfg.pred_prior_size_at(t) for t in range(cfg.num_smc_sets)]
        shapes |= {(keeps[t], keeps[t - 1], len(cfg.parameters))
                   for t in range(1, len(keeps))}
    return sorted(shapes)


def mesh_kernel_shapes(name):
    """Every per-shard (n, m, p) a ``MESH_RUNS`` fit gives the kernel, read
    from its config: set t's ``ceil(keep_t / shards)`` edge-padded
    survivors against the ``keep_{t-1}`` survivors of set t - 1."""
    from abcsmc_tpu_torch.config import parse_config

    k, sets = MESH_RUNS[name]
    raw = json.loads((REPO / "examples" / f"{name}.json").read_text())
    if sets is not None:
        raw["smc_iterations"] = sets
    cfg = parse_config(raw)
    keeps = [cfg.pred_prior_size_at(t) for t in range(cfg.num_smc_sets)]
    return {(-(-keeps[t] // k), keeps[t - 1], len(cfg.parameters))
            for t in range(1, len(keeps))}


def phase_kernel():
    import torch

    from abcsmc_tpu_torch.ops.kernels import (
        mixture_logsumexp, mixture_logsumexp_reference,
    )

    # the config default's scheme (3xTF32) in every mode at every shape a
    # main path gives the kernel
    hi = dict(precision="high")
    errs, times = {}, {}
    for n, m, p in KERNEL_SHAPES:
        a, b, lw = kernel_inputs(n, m, p, seed=n + p)
        HELD.add((n, m, p, "high"))
        for mode in ("static", "online", "auto"):
            got = mixture_logsumexp(a, b, lw, mode=mode, **hi)
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
                lambda: mixture_logsumexp(a, b, lw, mode=mode, **hi), reps)
            shape["device_ms" + sfx] = graph_ms(
                lambda: mixture_logsumexp(a, b, lw, mode=mode, **hi), reps)
            shape["plain_ms" + sfx] = cuda_ms(
                lambda: mixture_logsumexp_reference(a, b, lw, mode=mode),
                reps)
        del a, b, lw

    # the shipped examples' shapes (small, no multiple of a tile); any p
    # (the templates of the first port stopped at 64), tiny and ragged;
    # the other two schemes in auto at each too (a brain pass that
    # rebuilds a resumed run's weights runs "highest" at such shapes)
    example_shapes = example_kernel_shapes()
    check(example_shapes, "no example shapes")
    mesh_shapes = sorted(set().union(*map(mesh_kernel_shapes, MESH_RUNS)))
    bench_shapes = bench_kernel_shapes()
    for n, m, p in (*example_shapes, *mesh_shapes, *bench_shapes,
                    *bridge_kernel_shapes(), *EXTRA_SHAPES):
        a, b, lw = kernel_inputs(n, m, p, seed=n + m + p)
        for prec in PRECISIONS:
            for mode in ("static", "online", "auto"):
                if prec != "high" and mode != "auto":
                    continue
                got = mixture_logsumexp(a, b, lw, mode=mode, precision=prec)
                torch.cuda.synchronize()
                ref = mixture_logsumexp_reference(a, b, lw, mode=mode,
                                                  precision=prec)
                err = float((got - ref).abs().max())
                key = f"{n}x{m}x{p}/{mode}"
                errs[key if prec == "high" else f"{key}/{prec}"] = err
                check(err <= TOL, f"{mode}/{prec} at {n}x{m}x{p}: max abs "
                      f"err {err}")
            HELD.add((n, m, p, prec))

    # hostile: coordinates up to 6 kernel sd, where the expansion
    # a.b - |a|^2/2 - |b|^2/2 cancels most; each query within ~1 sd of its
    # parent center, as in an SMC state; held to float64 (both
    # full-precision schemes)
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
    for prec in ("high", "highest"):
        for mode in ("static", "online", "auto"):
            got = mixture_logsumexp(*h32, mode=mode, precision=prec)
            err = float((got.double() - ref64).abs().max())
            sfx = "" if prec == "high" else f"/{prec}"
            errs[f"hostile_{n}x{m}x{p}_f64/{mode}{sfx}"] = err
            check(err <= TOL, f"hostile {mode}/{prec}: max abs err vs f64 "
                  f"{err}")

    # auto decides its rerun on the device: no host sync in the call, in
    # any scheme
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for prec in PRECISIONS:
            mixture_logsumexp(*h32, mode="auto", precision=prec)
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
    static = mixture_logsumexp(a, b, lw, mode="static", **hi)
    auto = mixture_logsumexp(a, b, lw, mode="auto", **hi)
    online = mixture_logsumexp(a, b, lw, mode="online", **hi)
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
    for prec in PRECISIONS:
        got = mixture_logsumexp(a, b, lw, precision=prec)
        sub = mixture_logsumexp(a, b[:1024].contiguous(),
                                lw[:1024].contiguous(), precision=prec)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), "finite with -inf weights")
        ierr = float((got - sub).abs().max())
        check(ierr <= TOL, f"-inf weights/{prec}: max abs err {ierr}")
        errs["neg_inf_weights" + ("" if prec == "high"
                                  else f"/{prec}")] = ierr
    schemes = phase_kernel_schemes(errs)
    emit({"phase": "kernel", "max_abs_err": errs, "times": times,
          "example_shapes": example_shapes, "mesh_shapes": mesh_shapes,
          "bench_shapes": bench_shapes,
          "bridge_shapes": bridge_kernel_shapes()})
    return errs, times, schemes


def phase_sir_kernel():
    """The sir loop's kernel (``sim_kernels.sir_loop``) against its plain
    version, the simulator's PyTorch chain (``metrics_from_noise`` on the
    seeds' counter noise), on the same rows at sir_1m's 1,048,576 rows x
    160 days: bit for bit on all six metrics. Rows over sir_1m's prior box
    and past it (negative rates, beta near 0, gamma over 1 and under the
    1e-6 clamp), seeds over the whole int64 range. Both timed (CUDA
    events) beside the loop's least time (``port_bench/kernels/
    sir_loop.py``)."""
    import numpy as np
    import torch

    from abcsmc_tpu_torch.models.simulators import (
        CounterNoise, make_sir_simulator,
    )
    from abcsmc_tpu_torch.ops.sim_kernels import sir_loop
    from port_bench.kernels import sir_loop as roofline

    n, (pop, days, i0) = SIR_1M[0], (10_000, 160, 10)
    rng = np.random.default_rng(17)
    beta = np.where(rng.random(n) < 0.75, rng.uniform(0.05, 1.0, n),
                    rng.uniform(-1.5, 3.0, n))
    gamma = np.where(rng.random(n) < 0.75, rng.uniform(0.02, 0.5, n),
                     rng.uniform(-1.0, 1.5, n))
    beta[:n // 16] = rng.uniform(-1e-6, 1e-6, n // 16)
    gamma[n // 16:n // 8] = rng.uniform(-2e-6, 2e-6, n // 16)
    params = torch.as_tensor(np.stack([beta, gamma], 1), dtype=torch.float32,
                             device="cuda")
    seeds = torch.as_tensor(rng.integers(-2**63, 2**63 - 1, n,
                                         dtype=np.int64), device="cuda")
    sim = make_sir_simulator(pop, days, i0)

    def kernel():
        return sir_loop(params, seeds, pop, days, i0)

    def plain():
        return sim.metrics_from_noise(
            params, CounterNoise(seeds, torch.float32))

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    same = torch.equal(got.view(torch.int32), want.view(torch.int32))
    err = float(torch.nan_to_num((got - want).abs(), nan=math.inf).max())
    check(same, f"sir loop kernel at {n} x {days}: not the chain's bits, "
          f"max abs err {err}")
    check(float((got[:, 0] > 10 * i0).float().mean()) > 0.25,
          "sir loop kernel: too few rows take off")
    out = {"shape": [n, days], "max_abs_err": err,
           "ms": cuda_ms(kernel, 20), "plain_ms": cuda_ms(plain, 3),
           "bound_ms": roofline.least_ms(days, n),
           "bound_terms_ms": roofline.terms_ms(days, n)}
    out["bound_by"] = max(out["bound_terms_ms"],
                          key=out["bound_terms_ms"].get)
    emit({"phase": "sir_kernel", **out})
    return out


def phase_ricker_kernel():
    """The ricker loop's kernel (``sim_kernels.ricker_loop``) against its
    plain version, the simulator's PyTorch chain (``metrics_from_noise`` on
    the seeds' counter noise), on the same rows at ricker_1m's 1,048,576
    rows x 150 steps: all six metrics bit for bit, and the grid and
    clamped counts equal. Rows over ricker_1m's prior box, a sixteenth at
    Wood's truth. The kernel alone, the simulator's call (the kernel and
    the row statistics) and the chain timed (CUDA events) beside the
    loop's least time (``port_bench/kernels/ricker_loop.py``, at the grid
    steps this batch counted)."""
    import numpy as np
    import torch

    from abcsmc_tpu_torch.models.simulators import (
        CounterNoise, make_ricker_simulator,
    )
    from abcsmc_tpu_torch.ops.sim_kernels import ricker_loop
    from port_bench.kernels import ricker_loop as roofline

    n, observed, burn_in = SIR_1M[0], 100, 50
    rng = np.random.default_rng(23)
    p = rng.uniform([2.0, 0.05, 2.0], [5.0, 1.0, 30.0], (n, 3))
    p[::16] = (3.8, 0.3, 10.0)
    params = torch.as_tensor(p, dtype=torch.float32, device="cuda")
    seeds = torch.as_tensor(rng.integers(0, 2**31 - 1, n), device="cuda")
    sim, chain = make_ricker_simulator(), make_ricker_simulator()

    def plain():
        return chain.metrics_from_noise(
            params, CounterNoise(seeds, torch.float32))

    got, want = sim.batch_fn(params, seeds), plain()
    counts = sim.device_counts("cuda").clone()
    torch.cuda.synchronize()
    same = torch.equal(got.view(torch.int32), want.view(torch.int32))
    err = float(torch.nan_to_num((got - want).abs(), nan=math.inf).max())
    check(same, f"ricker loop kernel at {n} x {observed + burn_in}: not "
          f"the chain's bits, max abs err {err}")
    check(torch.equal(counts, chain.device_counts("cuda")),
          f"ricker loop kernel: counts {counts.tolist()}, chain's "
          f"{chain.device_counts('cuda').tolist()}")
    grid = float(counts[0]) / n
    out = {"shape": [n, observed + burn_in], "max_abs_err": err,
           "grid_steps_a_row": grid, "clamped_draws": int(counts[1]),
           "ms": cuda_ms(lambda: ricker_loop(params, seeds, observed,
                                             burn_in, 1.0), 20),
           "simulate_ms": cuda_ms(lambda: sim.batch_fn(params, seeds), 10),
           "plain_ms": cuda_ms(plain, 2),
           "bound_ms": roofline.least_ms(observed + burn_in, observed, grid,
                                         n),
           "bound_terms_ms": roofline.terms_ms(observed + burn_in, observed,
                                               grid, n)}
    out["bound_by"] = max(out["bound_terms_ms"],
                          key=out["bound_terms_ms"].get)
    emit({"phase": "ricker_kernel", **out})
    return out


def phase_kernel_schemes(errs):
    """Every dot scheme at SCHEME_SHAPES and at the shipped keeps
    (``keep_shapes``; short splits) in each mode against its
    own plain version (float32; "default" rounds its operands to bfloat16
    as the kernel does), auto timed three ways (``ms`` host-paced,
    ``device_ms`` from a replayed graph, ``host_us`` to enqueue) beside its
    plain version and its bound, the kernels one call launched in each
    mode, the prologue counted, as the C entry counts them
    (``kernel_launches`` around the call; ``launches_per_call``, checked
    equal to the plan's count), and held to float64 on
    4,096 sampled query rows: "default" at least 10x farther from float64
    than "high" at 50,000^2 x 6 (it rounds), the other two within 2e-4
    nats. Returns {precision: {shape: numbers}}."""
    import torch

    from abcsmc_tpu_torch.bench_kernel import sampled_error_f64
    from abcsmc_tpu_torch.ops.kernels import (
        kernel_launches, launches_per_call, mixture_logsumexp,
        mixture_logsumexp_reference,
    )

    out = {prec: {} for prec in PRECISIONS}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    shapes = list(SCHEME_SHAPES) + [s for s in keep_shapes()
                                    if s not in SCHEME_SHAPES]
    for n, m, p in shapes:
        a, b, lw = kernel_inputs(n, m, p, seed=n + p)
        key = f"{n}x{m}x{p}"
        for prec in PRECISIONS:
            row = out[prec][key] = {}
            for mode in ("static", "online", "auto"):
                got = mixture_logsumexp(a, b, lw, mode=mode, precision=prec)
                torch.cuda.synchronize()
                ref = mixture_logsumexp_reference(a, b, lw, mode=mode,
                                                  precision=prec)
                check(bool(torch.isfinite(got).all()),
                      f"finite {mode}/{prec} {key}")
                err = float((got - ref).abs().max())
                errs[f"{key}/{mode}/{prec}"] = err
                row[f"max_abs_err_own_{mode}"] = err
                check(err <= TOL, f"{mode}/{prec} at {key}: max abs err "
                      f"{err}")
            del got, ref
            HELD.add((n, m, p, prec))
            row["max_abs_err_f64_sampled"] = sampled_error_f64(
                a, b, lw, mixture_logsumexp(a, b, lw, precision=prec), 4096)
            reps = 20 if n < 10_000 else 5
            row["ms"] = cuda_ms(
                lambda: mixture_logsumexp(a, b, lw, precision=prec), reps)
            row["device_ms"] = graph_ms(
                lambda: mixture_logsumexp(a, b, lw, precision=prec), reps)
            row["host_us"] = host_us(
                lambda: mixture_logsumexp(a, b, lw, precision=prec), reps)
            row["launches_per_call"] = {}
            for mode in ("static", "online", "auto"):
                before = kernel_launches()
                mixture_logsumexp(a, b, lw, mode=mode, precision=prec)
                got = row["launches_per_call"][mode] = (
                    kernel_launches() - before)
                plan = launches_per_call(n, m, p, mode, precision=prec,
                                         sms=sms)
                check(got == plan, f"{mode}/{prec} at {key}: {got} kernels "
                      f"launched a call, the plan says {plan}")
            row["plain_ms"] = cuda_ms(
                lambda: mixture_logsumexp_reference(a, b, lw,
                                                    precision=prec), reps)
            bound = kernel_bound_ms(n, m, p, prec)
            row.update(bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
                       bound_share=bound["bound_ms"] / row["ms"],
                       issue_model_ms=bound["issue_model_ms"],
                       bound_terms_ms=bound["terms_ms"])
        del a, b, lw
        torch.cuda.empty_cache()
    rep = f"{REPORT_SHAPE[0]}x{REPORT_SHAPE[1]}x{REPORT_SHAPE[2]}"
    f64 = {prec: out[prec][rep]["max_abs_err_f64_sampled"]
           for prec in PRECISIONS}
    check(f64["high"] <= TOL and f64["highest"] <= TOL,
          f"full-precision schemes vs float64 at {rep}: {f64}")
    check(f64["default"] >= 10 * f64["high"],
          f"default does not round at {rep}: {f64}")
    emit({"phase": "kernel_schemes", "by_precision": out,
          "f64_err_at_report_shape": f64})
    return out


def phase_dengue():
    import numpy as np

    from abcsmc_tpu_torch import AbcSmc

    path = REPO / "examples" / "dengue_surrogate.json"
    cfg = json.loads(path.read_text())
    truth = np.array(json.loads(
        re.search(r"truth=(\[[^\]]*\])", cfg["comment"]).group(1)))
    # 3 of the shipped 5 sets (widths unchanged): the surfaces phase reads
    # this store back twice; the fused phase runs all 5 sets
    n_sets, n, keep = 3, 102_400, 2_048
    cfg["smc_iterations"] = n_sets
    db = cfg["database_filename"] = fresh_store("dengue_surrogate.sqlite")
    reset_launches()
    t0 = time.perf_counter()
    run = AbcSmc(cfg, device="cuda").run_device(seed=0)
    wall = time.perf_counter() - t0
    by = read_launches()
    launches = sum(by.values())
    run.storage.close()
    rows = store_rows(db)
    check(rows == [(t, n, n, keep) for t in range(n_sets)],
          f"dengue store rows {rows}")
    gens = [e for e in run.timings if e["op"] == "device_generation"]
    ncomp = [e["ncomp_used"] for e in gens]
    check(len(ncomp) == n_sets and min(ncomp) > 1, f"dengue ncomp {ncomp}")
    check(launches == 2 * (n_sets - 1), f"dengue kernel launches {launches}")
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
    return by, run


def phase_north():
    import numpy as np
    import torch

    from abcsmc_tpu_torch import AbcSmc
    from abcsmc_tpu_torch.models.simulators import (
        make_linear_gaussian_simulator,
    )

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
    reset_launches()
    t0 = time.perf_counter()
    run = AbcSmc(cfg, device="cuda", simulator=sim).run_device(seed=0)
    wall = time.perf_counter() - t0
    by = read_launches()
    launches = sum(by.values())
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
    return by


def phase_precision():
    """dengue_surrogate as shipped (102,400 x 16 x 100, keep 2,048), its
    sets cut to PRECISION_SETS, in memory, under each weight_precision:
    each run launches its own scheme only (2 per weighted set),
    ncomp_used > 1, posterior closer to the truth than the prior; per-set
    ms; each set's kernel call against its plain version at its own
    inputs; and on the "highest" run's set-1 inputs the weight stage's
    log-densities of every scheme, as the max abs difference from
    "highest". Returns ({precision: launches}, errors)."""
    import numpy as np
    import torch

    from abcsmc_tpu_torch import AbcSmc
    from abcsmc_tpu_torch.ops import weights

    t_phase = time.perf_counter()
    raw = json.loads((REPO / "examples" / "dengue_surrogate.json")
                     .read_text())
    truth = np.array(json.loads(
        re.search(r"truth=(\[[^\]]*\])", raw["comment"]).group(1)))
    counts, errs, out, runs = {}, {}, {}, {}
    for prec in ("highest", "high", "default"):
        cfg = dict(raw, smc_iterations=PRECISION_SETS, database_filename="",
                   weight_precision=prec)
        reset_launches()
        t0 = time.perf_counter()
        with redirect_stderr(io.StringIO()):
            run = AbcSmc(cfg, device="cuda").run_device(seed=0)
        wall = time.perf_counter() - t0
        by = read_launches()
        want = 2 * (PRECISION_SETS - 1)
        check(by == {k: want if k == prec else 0 for k in PRECISIONS},
              f"precision {prec}: launches {by}")
        counts = add_launches(counts, by)
        gens = [e for e in run.timings if e["op"] == "device_generation"]
        ncomp = [e["ncomp_used"] for e in gens]
        check(len(ncomp) == PRECISION_SETS and min(ncomp) > 1,
              f"precision {prec}: ncomp {ncomp}")
        rmse_post, rmse_prior = posterior_rmse(run.posterior()[0], truth)
        kerr = {}
        for t in range(1, PRECISION_SETS):
            surv, state = set_inputs(run, t)
            shape, err = kernel_vs_plain_sampled(surv, state,
                                                 precision=prec)
            kerr[f"set {t} {shape}"] = errs[
                f"precision {prec} set {t} {shape}"] = err
        out[prec] = {"ncomp": ncomp, "launches": by, "wall_s": wall,
                     "set_ms": [e["device_ms"] for e in gens],
                     "route": [e.get("route") for e in gens],
                     "rmse_posterior": rmse_post, "rmse_prior": rmse_prior,
                     "kernel_vs_plain": kerr}
        runs[prec] = run

    # one weight stage on the same inputs (the "highest" run's set 1)
    surv, (prev, prev_w, prev_dv) = set_inputs(runs["highest"], 1)
    dens = {prec: weights.log_kernel_mixture_density(
        surv, prev, torch.log(prev_w), prev_dv, precision=prec)
        for prec in PRECISIONS}
    diff = {prec: float((dens[prec] - dens["highest"]).abs().max())
            for prec in PRECISIONS}
    check(diff["high"] <= 2 * TOL, f"high vs highest log-weights {diff}")
    check(diff["default"] <= 0.2, f"default vs highest log-weights {diff}")
    emit({"phase": "precision", "sets": PRECISION_SETS, "runs": out,
          "weight_stage_max_abs_diff_from_highest": diff,
          "wall_s": time.perf_counter() - t_phase})
    return counts, errs


def set_inputs(run, t):
    """Set t's weight-kernel inputs from a run's host copies: (its
    survivors, (set t - 1's survivors, weights, doubled variance)), on the
    run's device in its dtype."""
    import torch

    def dev(x):
        return torch.as_tensor(x).to(run.device, run.dtype)

    prev = run._particle_parameters[t - 1][run._predictive_prior[t - 1]]
    surv = run._particle_parameters[t][run._predictive_prior[t]]
    return dev(surv), (dev(prev), dev(run._weights[t - 1]),
                       dev(run._doubled_variance[t - 1]))


def reset_launches():
    """Every launch count to 0 (the weight kernel's total and each
    scheme's, and each simulator loop kernel's)."""
    from abcsmc_tpu_torch.ops.kernels import mixture_logsumexp
    from abcsmc_tpu_torch.ops.sim_kernels import LOOP_KERNELS

    mixture_logsumexp.launches = 0
    for k in PRECISIONS:
        mixture_logsumexp.launches_by_precision[k] = 0
    for k in LOOP_KERNELS:
        k.launches = 0


#: each simulator loop kernel's launches over every phase's main path
LOOP_LAUNCHES = {}


def check_loop_launches(what, simulator, calls):
    """Each simulator loop kernel's launches since the last
    :func:`reset_launches`: ``calls`` for the kernel of ``simulator`` (the
    builtin ``<simulator>`` runs ``<simulator>_loop``; one a set and
    shard: a set simulates each shard's rows in one call at these sizes,
    and a replayed set counts the launch its graph holds), 0 for every
    other. Read right after a main-path run, before anything else
    simulates, and added to the main path's counts; returns them by
    kernel."""
    from abcsmc_tpu_torch.ops.sim_kernels import LOOP_KERNELS

    got = {}
    for k in LOOP_KERNELS:
        want = calls if k.__name__ == f"{simulator}_loop" else 0
        got[k.__name__] = k.launches
        check(k.launches == want, f"{what}: {k.__name__} kernel launches "
              f"{k.launches}, want {want}")
        LOOP_LAUNCHES[k.__name__] = (LOOP_LAUNCHES.get(k.__name__, 0)
                                     + k.launches)
    return got


def read_launches():
    """The launches by scheme since the last :func:`reset_launches`. Every
    phase resets the counts just before each of its main-path runs and
    reads them just after, and returns the sum of what it read."""
    from abcsmc_tpu_torch.ops.kernels import mixture_logsumexp

    return dict(mixture_logsumexp.launches_by_precision)


def add_launches(*counts):
    """Launch counts by scheme, summed."""
    return {k: sum(c.get(k, 0) for c in counts) for k in PRECISIONS}


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
    (wall seconds, the [timing] entries, the kernel launches it counted,
    and those by dot scheme)."""
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
    by_prec = json.loads(re.search(
        r"\[kernel\] mixture_logsumexp\.launches_by_precision (\{.*\})",
        run.stderr).group(1))
    return wall, timings, launches, by_prec


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
        wall, timings, launches, by_prec = cli(path, "--process",
                                               "--simulate", "--all",
                                               "--seed", "1")
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
        # the brain weighs at JAX's default for it, "highest" (FP32 FMAs)
        check(by_prec == {k: launches if k == "highest" else 0
                          for k in PRECISIONS},
              f"host_cli launches by scheme {by_prec}")

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
            torch.log(eng._tensor(post[t - 1][1])), precision="highest")
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
    return by_prec, wall


def phase_resume():
    import numpy as np

    from abcsmc_tpu_torch import AbcSmc
    from abcsmc_tpu_torch.storage import SQLiteStorage

    n, keep, half = 102_400, 2_048, 51_200
    with tempfile.TemporaryDirectory() as tmp:
        path, cfg, db, truth = dengue_host_config(tmp)
        wall_p, _, _, _ = cli(path, "--process", "--seed", "1")
        wall_s, sim_timings, _, _ = cli(path, "--simulate", "-n", str(half))
        before = SQLiteStorage(db).read_generations()[0]
        done = before.statuses == "D"
        check(int(done.sum()) == half, f"resume: {int(done.sum())} rows done")
        reset_launches()
        t0 = time.perf_counter()
        run = AbcSmc(cfg, device="cuda").run_device(seed=2)
        wall = time.perf_counter() - t0
        by = read_launches()
        launches = sum(by.values())
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
    return by


# name -> (truth as the config's comment states it, indices of the
# parameters whose posterior mean must beat the prior mean, the most a
# metric may move when its stored seed is replayed in another batch on the
# card: 0 for every example, since every row reduction of a simulator is a
# fixed tree of elementwise adds)
EXAMPLES = {
    "sir": ((0.30, 0.10), (0, 1), 0.0),
    "lv": ((1.0, 0.1), (0, 1), 0.0),
    "ricker": ((3.8, 0.3, 10.0), (), 0.0),
    "gk": ((3.0, 1.0, 2.0, 0.5), (0, 1), 0.0),
    "mg1": ((1.0, 5.0, 0.2), (), 0.0),
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
        "routes": [e["route"] for e in gens],
        "simulate_ms": [e["simulate_ms"] for e in gens],
        "mvn_rounds": [e["mvn_rounds"] for e in gens],
        "mvn_finished_eagerly": [e["mvn_finished_eagerly"] for e in gens],
        "posterior_mean": post.tolist(), "truth": truth.tolist(),
        "prior_mean": prior.tolist(),
        "phases": [e for e in run.timings
                   if e["op"] == "run_device_phases"],
    }


def reduction_price():
    """What the batch-invariant row reductions of the simulators cost
    against the library calls they replaced, at the shipped shapes (4,096
    particles; M/G/1: 50 customers, Ricker: 100 counts): milliseconds by
    CUDA events, and operations that launch a kernel, counted as they are
    dispatched (views launch nothing)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from abcsmc_tpu_torch.models.simulators import _tree_cumsum, _tree_sum

    views = ("slice", "select", "alias", "view", "expand", "unsqueeze",
             "squeeze", "detach", "t.", "transpose")

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not str(func).startswith(tuple(f"aten.{v}" for v in views)):
                Count.n += 1
            return func(*args, **(kwargs or {}))

    def price(fn):
        Count.n = 0
        with Count():
            fn()
        return {"launches": Count.n, "ms": cuda_ms(fn, 50)}

    out = {}
    for name, cols in (("mg1", 50), ("ricker", 100)):
        x = torch.rand((4096, cols), device="cuda")
        out[name] = {
            "tree_sum": price(lambda: _tree_sum(x)),
            "library_sum": price(lambda: x.sum(dim=1)),
            "tree_cumsum": price(lambda: _tree_cumsum(x)),
            "library_cumsum": price(lambda: torch.cumsum(x, dim=1)),
        }
    # per simulate call: M/G/1 two running sums and one sum; Ricker five sums
    out["per_call"] = {
        "mg1": {f"{r}_{k}": 2 * out["mg1"][f"{r}_cumsum"][k]
                + out["mg1"][f"{r}_sum"][k]
                for r in ("tree", "library") for k in ("launches", "ms")},
        "ricker": {f"{r}_{k}": 5 * out["ricker"][f"{r}_sum"][k]
                   for r in ("tree", "library") for k in ("launches", "ms")},
    }
    return out


def phase_examples():
    from abcsmc_tpu_torch import AbcSmc

    total = {}
    held = set(example_kernel_shapes())
    for name, (truth, must_beat, replay_tol) in EXAMPLES.items():
        cfg = json.loads((REPO / "examples" / f"{name}.json").read_text())
        db = cfg["database_filename"] = fresh_store(f"{name}.sqlite")
        n_sets = cfg["smc_iterations"]
        reset_launches()
        t0 = time.perf_counter()
        with redirect_stderr(io.StringIO()):
            run = AbcSmc(cfg).run_device(seed=0)
        wall = time.perf_counter() - t0
        by = read_launches()
        launches = sum(by.values())
        total = add_launches(total, by)
        loop_launches = check_loop_launches(name, cfg.get("simulator"),
                                            n_sets)
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
              "launches": launches, "loop_launches": loop_launches,
              "replay_other_batch_max_rel_diff":
                  replay_diff(run, max(sizes), replay_tol),
              **report})
    emit({"phase": "examples", "reduction_price": reduction_price()})
    return total


def phase_sir_1m():
    import torch

    from abcsmc_tpu_torch import AbcSmc

    cfg = json.loads((REPO / "examples" / "sir.json").read_text())
    (n, want_keep), n_sets = SIR_1M, 3
    cfg.update(num_samples=n, smc_iterations=n_sets, box_cox=True,
               database_filename="")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    with redirect_stderr(io.StringIO()):
        run = AbcSmc(cfg).run_device(seed=0)
    wall = time.perf_counter() - t0
    by = read_launches()
    launches = sum(by.values())
    peak = torch.cuda.max_memory_allocated()
    keep = run.config.pred_prior_size_at(0)
    check(keep == want_keep, f"sir_1m keep {keep}")
    stored = run.storage.read_generations()
    check([(g.size, len(g.predictive_prior_indices())) for g in stored]
          == [(n, keep)] * n_sets, "sir_1m store sets")
    check(launches == 2 * (n_sets - 1), f"sir_1m kernel launches {launches}")
    loop_launches = check_loop_launches("sir_1m", "sir", n_sets)
    report = fit_report(run, cfg, *EXAMPLES["sir"][:2])
    gens = [e for e in run.timings if e["op"] == "device_generation"]
    lambdas = [e["box_cox_lambdas"] for e in gens]
    check(all(len(lam) == 6 for lam in lambdas), "sir_1m lambdas")
    emit({"phase": "sir_1m", "n": n, "keep": keep, "sets": n_sets,
          "wall_s": wall, "launches": launches,
          "loop_launches": loop_launches,
          "rest_of_step_ms": [ms - sim for ms, sim in
                              zip(report["set_ms"], report["simulate_ms"])],
          "peak_memory_bytes": peak, "box_cox_lambdas": lambdas, **report})
    return by


def phase_projection():
    import numpy as np

    from abcsmc_tpu_torch import AbcSmc
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
    wall_cli, timings, launches_cli, _ = cli(str(path), "--process",
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
    reset_launches()
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
    by = read_launches()
    check(sum(by.values()) == 0, f"projection kernel launches {by}")
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
    return by


# --------------------------------------------------------------------------- #
# hbm_scale: chunked row passes and split propose at sizes near the card's
# memory
# --------------------------------------------------------------------------- #

SCALE_SIZES = (1 << 24, 1 << 25, 1 << 26)
SCALE_BLOCK = 1 << 21
SCALE_KEEP_CAP = 1 << 22     # beyond SCALE_SIZES: the kernel is O(keep^2)
SCALE_NPAR, SCALE_NMET = 6, 13


def scale_config(n, keep, sets=2, **extra):
    import numpy as np

    truth = np.random.default_rng(42).uniform(0.3, 0.7, SCALE_NPAR)
    obs = truth @ scale_mix()
    return {
        "smc_iterations": sets, "num_samples": n,
        "predictive_prior_size": keep,
        "parameters": [
            {"name": f"p{i}", "dist_type": "UNIFORM", "num_type": "FLOAT",
             "par1": 0.0, "par2": 1.0} for i in range(SCALE_NPAR)],
        "metrics": [
            {"name": f"m{j}", "num_type": "FLOAT", "value": float(obs[j])}
            for j in range(SCALE_NMET)],
        **extra,
    }, truth


def scale_mix():
    import numpy as np

    return np.random.default_rng(0).normal(size=(SCALE_NPAR, SCALE_NMET))


def scale_generation(n, keep, row_block, split):
    import numpy as np

    from abcsmc_tpu_torch.config import parse_config
    from abcsmc_tpu_torch.models.parameters import ParameterSet
    from abcsmc_tpu_torch.models.transforms import ParameterTransform
    from abcsmc_tpu_torch.parallel.generation import Generation

    raw, _ = scale_config(n, keep)
    cfg = parse_config(raw)
    return Generation(
        ParameterSet.from_specs(cfg.parameters),
        ParameterTransform(cfg.parameters), None,
        np.array([m.value for m in cfg.metrics]), device="cuda",
        row_block=row_block, propose_split=split)


def scale_data(n, keep):
    """A population made on the card, block by block: uniform parameters,
    metrics = params @ mix + 0.3 N(0, 1); and a previous state of ``keep``
    survivors around the middle of the prior box."""
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    mix = torch.as_tensor(scale_mix(), dtype=torch.float32, device=dev)
    params = torch.rand((n, SCALE_NPAR), generator=g, device=dev)
    mets = torch.empty((n, SCALE_NMET), device=dev)
    for start in range(0, n, SCALE_BLOCK):
        rows = slice(start, min(start + SCALE_BLOCK, n))
        mets[rows] = params[rows] @ mix
        mets[rows] += 0.3 * torch.randn(mets[rows].shape, generator=g,
                                        device=dev)
    state = (0.3 + 0.4 * torch.rand((keep, SCALE_NPAR), generator=g,
                                    device=dev),
             torch.full((keep,), keep ** -0.5, device=dev),
             torch.full((SCALE_NPAR,), 0.02, device=dev))
    return [params, mets], state


def scale_step(n, keep, row_block, split):
    """One later-set generation at n rows with an n-row proposal: inside
    the step, or (``split``) apart from it after the population is dropped,
    as the engine orders it (the engine also fetches the set in between).
    Returns the numbers and the small leaves to compare."""
    import torch

    gen = scale_generation(n, keep, row_block, split)
    pop, state = scale_data(n, keep)
    g = torch.Generator(device="cuda").manual_seed(5)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    if split is None:
        split = gen.split_propose_active(n, n)
    if split:
        draws = gen.draw_vdv_seed(g)
        res = gen.step_precomputed(pop[0], pop[1], keep, 0, draws, state)
        leaves = (res.survivor_idx, res.survivor_params, res.weights,
                  res.doubled_variance, res.ncomp_used)
        del res
        pop.clear()                      # rank -> free -> propose
        ev[1].record()
        draws = gen.draw_proposal(g, n, draws)
        nxt, _, _ = gen.propose(leaves[1], leaves[2], leaves[3], n, draws)
    else:
        draws = gen.draw_step(g, n)
        res = gen.step_precomputed(pop[0], pop[1], keep, n, draws, state)
        ev[1].record()
        leaves = (res.survivor_idx, res.survivor_params, res.weights,
                  res.doubled_variance, res.ncomp_used)
        nxt = res.next_params
        del res
    ev[2].record()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    check(nxt.shape == (n, SCALE_NPAR) and bool(torch.isfinite(nxt[-1]).all()),
          "proposal shape")
    out = {"rows": n, "keep": keep, "row_block": row_block, "split": split,
           "ms": ev[0].elapsed_time(ev[2]),
           "rank_ms": ev[0].elapsed_time(ev[1]),
           "peak_bytes": peak, "bytes_per_row": peak / n,
           "ncomp_used": int(leaves[4])}
    del nxt, draws, pop
    return out, leaves, state


def kernel_vs_plain_sampled(surv_par, state, rows=4096, precision="high"):
    """The kernel at a step's own shape (survivors x previous survivors x
    parameters) against plain on ``rows`` evenly spaced query rows (plain
    is a function of each query row by itself, and costs 50 times the
    kernel), in the step's scheme (the config default's unless named)."""
    import torch

    from abcsmc_tpu_torch.ops.kernels import (
        mixture_logsumexp, mixture_logsumexp_reference,
    )
    from abcsmc_tpu_torch.ops.weights import _prep_scaled

    a, b, _ = _prep_scaled(surv_par, state[0], state[2])
    a, b = a.contiguous(), b.contiguous()
    lw = torch.log(state[1]).contiguous()
    got = mixture_logsumexp(a, b, lw, precision=precision)
    pick = torch.linspace(0, a.shape[0] - 1, min(rows, a.shape[0]),
                          device=a.device).long()
    ref = mixture_logsumexp_reference(a[pick].contiguous(), b, lw,
                                      precision=precision)
    err = float((got[pick] - ref).abs().max())
    shape = f"{a.shape[0]}x{b.shape[0]}x{a.shape[1]}"
    check(err <= TOL, f"kernel at {shape}: max abs err {err}")
    return shape, err


def phase_hbm_scale():
    import numpy as np
    import torch

    from abcsmc_tpu_torch import AbcSmc
    from abcsmc_tpu_torch.models.simulators import (
        make_linear_gaussian_simulator,
    )

    t_phase = time.perf_counter()
    launches = {}
    errs = {}
    scale_step(1 << 20, 1 << 15, 0, False)      # first-use work, untimed
    for n in SCALE_SIZES:
        keep = n // 20
        ref = None
        for row_block in (0, SCALE_BLOCK):
            for split in (False, True):
                reset_launches()
                out, leaves, state = scale_step(n, keep, row_block, split)
                by = read_launches()
                check(sum(by.values()) == 2, f"hbm_scale step launches {by}")
                launches = add_launches(launches, by)
                check(out["ncomp_used"] > 1, f"hbm_scale ncomp {out}")
                if ref is None:
                    ref = leaves
                    shape, err = kernel_vs_plain_sampled(leaves[1], state)
                    errs[shape] = err
                else:
                    both = torch.isin(leaves[0], ref[0]).float().mean()
                    out["survivor_overlap"] = float(both)
                    out["dv_max_rel_diff"] = float(
                        ((leaves[3] - ref[3]).abs() / ref[3].abs()).max())
                    check(out["survivor_overlap"] >= 0.999
                          and out["dv_max_rel_diff"] <= 1e-3
                          and out["ncomp_used"] == int(ref[4]),
                          f"hbm_scale chunked/split vs resident: {out}")
                emit({"phase": "hbm_scale", "step": out})
                del leaves, state
        del ref
        torch.cuda.empty_cache()

    # the auto rule, and one step beyond the resident limit
    gen = scale_generation(1 << 24, (1 << 24) // 20, None, None)
    budget = 0.8 * gen.memory_bytes
    fits = int(budget // max(gen.chunked_row_bytes(), gen.propose_row_bytes()))
    n_big = 1 << (fits.bit_length() - 1)
    rule = {"memory_bytes": gen.memory_bytes,
            "resident_row_bytes": gen.resident_row_bytes(),
            "chunked_row_bytes": gen.chunked_row_bytes(),
            "propose_row_bytes": gen.propose_row_bytes(),
            "row_chunk_threshold": gen.row_chunk_threshold,
            "split_threshold": gen.split_threshold,
            "largest_chunked_split_rows": n_big}
    check(gen.row_block_for(n_big) == SCALE_BLOCK
          and gen.split_propose_active(n_big, n_big)
          and n_big > gen.row_chunk_threshold,
          f"the auto rule refuses the resident route at {n_big}: {rule}")
    check(gen.row_block_for(SCALE_SIZES[0]) == 0
          and not gen.split_propose_active(SCALE_SIZES[0], SCALE_SIZES[0]),
          "the auto rule keeps 2^24 resident and unsplit")
    del gen
    torch.cuda.empty_cache()
    keep_big = min(n_big // 20, SCALE_KEEP_CAP)
    reset_launches()
    big, leaves, state = scale_step(n_big, keep_big, None, None)
    by = read_launches()
    check(sum(by.values()) == 2, f"largest step launches {by}")
    launches = add_launches(launches, by)
    check(big["ncomp_used"] > 1 and big["peak_bytes"] <= budget,
          f"largest step: {big} against a budget of {budget}")
    shape, err = kernel_vs_plain_sampled(leaves[1], state)
    errs[shape] = err
    del leaves, state
    torch.cuda.empty_cache()
    emit({"phase": "hbm_scale", "auto_rule": rule, "largest_step": big})

    # the engine at 2^24 rows with both keys in the config, no store
    n, sets = SCALE_SIZES[0], 2
    keep = n // 20
    raw, truth = scale_config(n, keep, sets, row_block=SCALE_BLOCK,
                              propose_split=True, database_filename="")
    sim = make_linear_gaussian_simulator(SCALE_NPAR, SCALE_NMET,
                                         noise_sd=0.3, mix=scale_mix())
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    with redirect_stderr(io.StringIO()):
        run = AbcSmc(raw, simulator=sim).run_device(seed=0,
                                                    mirror_store=False)
    wall = time.perf_counter() - t0
    by = read_launches()
    run_launches = sum(by.values())
    launches = add_launches(launches, by)
    check(run_launches == 2 * (sets - 1), f"hbm run launches {run_launches}")
    check(not run.storage.exists(), "mirror_store=False wrote a store")
    gens = [e for e in run.timings if e["op"] == "device_generation"]
    ncomp = [e["ncomp_used"] for e in gens]
    check(len(gens) == sets and min(ncomp) > 1, f"hbm run ncomp {ncomp}")
    pars, w = run.posterior()
    check(pars.shape == (keep, SCALE_NPAR) and np.isfinite(w).all(),
          "hbm run posterior")
    rmse_post = float(np.sqrt(((pars.mean(0) - truth) ** 2).mean()))
    rmse_prior = float(np.sqrt(((0.5 - truth) ** 2).mean()))
    check(rmse_post < rmse_prior, f"hbm run rmse {rmse_post} {rmse_prior}")
    emit({"phase": "hbm_scale", "run_device": {
        "rows": n, "keep": keep, "sets": sets, "row_block": SCALE_BLOCK,
        "propose_split": True, "mirror_store": False, "wall_s": wall,
        "set_ms": [e["device_ms"] for e in gens], "ncomp": ncomp,
        "launches": run_launches,
        "peak_bytes": torch.cuda.max_memory_allocated(),
        "phases": [e for e in run.timings if e["op"] == "run_device_phases"],
        "rmse_posterior": rmse_post, "rmse_prior": rmse_prior},
        "kernel_max_abs_err": errs,
        "phase_wall_s": time.perf_counter() - t_phase})
    return launches, errs


# --------------------------------------------------------------------------- #
# fused: run_scan / run_chain as CUDA-graph replays against the sequential loop
# --------------------------------------------------------------------------- #

FUSED_EXAMPLES = ("dengue_surrogate", "ricker", "gk", "mg1")
MVN_FUSED = ("sir", "dice")        # MULTIVARIATE noise as shipped
CHAIN_SIZES = [300, 500, 500, 750, 1000]
CHAIN_SETS = 30


def chain_config(**extra):
    """The reference quick-start's varying-size schedule, 30 sets, on the
    dice game with INDEPENDENT noise (a capturable step)."""
    cfg = json.loads((REPO / "examples" / "dice.json").read_text())
    cfg.update(num_samples=CHAIN_SIZES, smc_iterations=CHAIN_SETS,
               noise="INDEPENDENT", database_filename="", **extra)
    return cfg


def routed_run(cfg, dispatch, seed=0, rejection_block=None):
    """``run_device`` of ``cfg`` (in-memory store) under one
    ``device_dispatch``, with the MULTIVARIATE rejection block of
    ``Generation`` set to ``rejection_block`` rounds where given; returns
    (engine, wall s, kernel launches by scheme, stderr)."""
    from abcsmc_tpu_torch import AbcSmc, Generation

    cfg = dict(cfg, device_dispatch=dispatch, database_filename="")
    block = Generation.rejection_block
    if rejection_block is not None:
        Generation.rejection_block = rejection_block
    err = io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    try:
        with redirect_stderr(err):
            run = AbcSmc(cfg).run_device(seed=seed, verbose=True)
    finally:
        Generation.rejection_block = block
    return run, time.perf_counter() - t0, read_launches(), err.getvalue()


def stored_diff(a, b):
    """The largest |difference| between what two runs stored (parameters,
    seeds, metrics, posterior ranks) and their weights; inf when the sets
    or the survivors differ."""
    import numpy as np

    ga, gb = a.storage.read_generations(), b.storage.read_generations()
    if len(ga) != len(gb):
        return math.inf
    worst = 0.0
    for x, y in zip(ga, gb):
        if (x.size != y.size or not np.array_equal(x.seeds, y.seeds)
                or not np.array_equal(x.posterior_ranks, y.posterior_ranks)):
            return math.inf
        worst = max(worst, float(np.abs(x.params - y.params).max()),
                    float(np.abs(x.metrics - y.metrics).max()))
    for x, y in zip(a._weights, b._weights):
        worst = max(worst, float(np.abs(x - y).max()))
    return worst


def route_report(run):
    gens = [e for e in run.timings if e["op"] == "device_generation"]
    ph = [e for e in run.timings if e["op"] == "run_device_phases"][-1]
    return {"set_ms": [e["device_ms"] for e in gens],
            "routes": [e["route"] for e in gens],
            "ncomp": [e["ncomp_used"] for e in gens],
            "mvn_rounds": [e["mvn_rounds"] for e in gens],
            "mvn_finished_eagerly": [e["mvn_finished_eagerly"]
                                     for e in gens],
            **{k: ph[k] for k in ("route", "dispatch_s", "mirror_s",
                                  "programs", "graph_captures",
                                  "graph_replays", "capture_s",
                                  "mvn_eager_finishes")}}


def set_ms_by_route(rep):
    """The set milliseconds of a route report, eager sets and replayed sets
    apart (set 0 aside: it simulates a first population)."""
    out = {"eager": [], "replay": []}
    for t, (ms, route) in enumerate(zip(rep["set_ms"], rep["routes"])):
        if t > 0:
            out[route].append(ms)
    return out


class ReplayedKernelCheck:
    """Holds the kernel inside every replayed graph against its plain
    version: the weight stage's inputs and output as the capture recorded
    them are the graph's own tensors, so after each replay they hold that
    set's values; the plain version runs on those inputs and is compared
    with the output (synchronising once per set: a checked run is not a
    timed one)."""

    def __enter__(self):
        from abcsmc_tpu_torch.ops import weights
        from abcsmc_tpu_torch.ops.kernels import mixture_logsumexp_reference
        from abcsmc_tpu_torch.parallel.generation import Generation

        self.errs = []
        self._saved = (weights.log_kernel_mixture_density,
                       Generation._capture, Generation._replay)
        density, capture, replay = self._saved
        recorded = []

        def recording_density(*args, **kw):
            out = density(*args, **kw)
            recorded.append((args, kw.get("precision"), out))
            return out

        def recording_capture(gen, *args, **kw):
            cap = capture(gen, *args, **kw)
            cap.kernel_record = recorded[-1]
            return cap

        def checked_replay(gen, cap, *args, **kw):
            res = replay(gen, cap, *args, **kw)
            (surv, prev, prev_lw, prev_dv), prec, out = cap.kernel_record
            a, b, log_norm = weights._prep_scaled(surv, prev, prev_dv)
            ref = mixture_logsumexp_reference(
                a, b, prev_lw.to(a), precision=prec) + log_norm
            self.errs.append(float((out - ref).abs().max()))
            return res

        weights.log_kernel_mixture_density = recording_density
        Generation._capture = recording_capture
        Generation._replay = checked_replay
        return self

    def __exit__(self, *exc):
        from abcsmc_tpu_torch.ops import weights
        from abcsmc_tpu_torch.parallel.generation import Generation

        (weights.log_kernel_mixture_density, Generation._capture,
         Generation._replay) = self._saved


def replayed_kernel_vs_plain():
    """The kernel inside a captured graph: capture one auto call on static
    inputs, then replay it on other inputs copied into them, against plain."""
    import torch

    from abcsmc_tpu_torch.ops.kernels import (
        mixture_logsumexp, mixture_logsumexp_reference,
    )

    errs = {}
    for n, m, p in ((2048, 2048, 16), (410, 410, 3)):
        static = [x.clone() for x in kernel_inputs(n, m, p, seed=1)]
        mixture_logsumexp(*static, precision="high")     # warm-up
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = mixture_logsumexp(*static, precision="high")
        for seed in (2, 3):
            fresh = kernel_inputs(n, m, p, seed=seed)
            for dst, src in zip(static, fresh):
                dst.copy_(src)
            graph.replay()
            torch.cuda.synchronize()
            ref = mixture_logsumexp_reference(*fresh)
            err = float((out - ref).abs().max())
            check(err <= TOL, f"replayed kernel at {n}x{m}x{p}: {err}")
            errs[f"replay_{n}x{m}x{p}/seed{seed}"] = err
    return errs


def phase_fused():
    import numpy as np
    import torch

    from abcsmc_tpu_torch.ops import stats

    t_phase = time.perf_counter()
    total = {}
    kernel_errs = replayed_kernel_vs_plain()
    for name in FUSED_EXAMPLES:
        cfg = json.loads((REPO / "examples" / f"{name}.json").read_text())
        n_sets, sim = cfg["smc_iterations"], cfg.get("simulator")
        seq, wall_seq, by_seq, _ = routed_run(cfg, "sequential")
        loops = [check_loop_launches(f"{name} sequential", sim, n_sets)]
        seq2, wall_seq2, _, _ = routed_run(cfg, "sequential")
        loops.append(check_loop_launches(f"{name} sequential", sim, n_sets))
        fused, wall_fused, by_fused, said = routed_run(cfg, "fused")
        loops.append(check_loop_launches(f"{name} fused", sim, n_sets))
        total = add_launches(total, by_seq, by_fused)
        l_seq, l_fused = sum(by_seq.values()), sum(by_fused.values())
        agree = stored_diff(seq, seq2)
        diff = stored_diff(seq, fused)
        check(diff <= agree, f"{name}: fused differs from sequential by "
              f"{diff}, two sequential runs by {agree}")
        check(l_fused == l_seq == 2 * (n_sets - 1),
              f"{name}: launches sequential {l_seq}, fused {l_fused}")
        rep = route_report(fused)
        check(rep["routes"] == ["eager", "eager"] + ["replay"] * (n_sets - 2)
              and rep["graph_replays"] == n_sets - 2
              and rep["graph_captures"] == 1
              and rep["programs"] == n_sets + 1,
              f"{name}: fused route {rep}")
        check("replay one CUDA graph" in said, f"{name}: route not said")
        emit({"phase": "fused", "example": name, "sets": n_sets,
              "sequential_runs_max_abs_diff": agree,
              "fused_vs_sequential_max_abs_diff": diff,
              "wall_s": {"sequential": [wall_seq, wall_seq2],
                         "fused": wall_fused},
              "launches": {"sequential": l_seq, "fused": l_fused},
              "loop_launches": dict(zip(("sequential", "sequential_again",
                                         "fused"), loops)),
              "sequential": route_report(seq2), "fused": rep})
        del seq, seq2, fused

    # a varying-size schedule whose nrmse_tolerance cuts inside the bucket
    # (the NRMSE trajectory is noisy: take the first seed with a set in the
    # replayed part of the bucket whose NRMSE is below every earlier set's)
    for chain_seed in range(8):
        free, wall_free, _, _ = routed_run(chain_config(), "sequential",
                                           seed=chain_seed)
        obs = torch.as_tensor(free.obs)
        nrmse = [float(stats.nrmse(torch.as_tensor(m[s]), obs)) for m, s in
                 zip(free.particle_metrics, free._predictive_prior)]
        records = [t for t in range(7, CHAIN_SETS - 1)
                   if nrmse[t] < min(nrmse[:t])]
        if records:
            break
    check(records, f"no set of the bucket sets an NRMSE record: {nrmse}")
    t_cut = records[0]
    tol = (nrmse[t_cut] + min(nrmse[:t_cut])) / 2
    cfg = chain_config(nrmse_tolerance=tol)
    seq, wall_seq, by_seq, _ = routed_run(cfg, "sequential", seed=chain_seed)
    fused, wall_fused, by_fused, _ = routed_run(cfg, "fused",
                                                seed=chain_seed)
    total = add_launches(total, by_seq, by_fused)
    l_seq, l_fused = sum(by_seq.values()), sum(by_fused.values())
    check(len(seq.particle_parameters) == t_cut + 1,
          f"chain: sequential stopped after {len(seq.particle_parameters)} "
          f"sets, expected {t_cut + 1}")
    diff = stored_diff(seq, fused)
    check(diff == 0.0, f"chain: fused differs from sequential by {diff}")
    rep = route_report(fused)
    # sets 0-4 run singly (size transitions, then the peeled first set of
    # the bucket), set 5 is the bucket's warm-up, 6-29 replay
    check(rep["graph_replays"] == CHAIN_SETS - 6 and rep["route"] == "chain"
          and l_fused == 2 * (CHAIN_SETS - 1) and l_seq == 2 * t_cut,
          f"chain: {rep}, launches {l_seq}, {l_fused}")
    emit({"phase": "fused", "example": "chain", "sizes": CHAIN_SIZES,
          "sets": CHAIN_SETS, "seed": chain_seed, "nrmse_tolerance": tol,
          "cut_after_set": t_cut,
          "fused_vs_sequential_max_abs_diff": diff,
          "wall_s": {"sequential_30_sets": wall_free,
                     "sequential_cut": wall_seq, "fused_30_sets": wall_fused},
          "launches": {"sequential": l_seq, "fused": l_fused},
          "sequential_30_sets": route_report(free), "fused": rep})

    total = add_launches(total, fused_mvn(kernel_errs))
    emit({"phase": "fused", "kernel_replayed_max_abs_err": kernel_errs,
          "phase_wall_s": time.perf_counter() - t_phase})
    return total, kernel_errs


def fused_mvn(kernel_errs):
    """The fused phase's MULTIVARIATE part; returns its kernel launches by
    scheme and adds the error of the kernel inside the replayed MVN graphs
    to ``kernel_errs``."""
    total = {}
    # the rejection loop runs a fixed block of rounds inside the graph and
    # its count is read once per set
    for name in MVN_FUSED:
        cfg = json.loads((REPO / "examples" / f"{name}.json").read_text())
        n_sets = cfg["smc_iterations"]
        sim = cfg["simulator"]
        seq, wall_seq, by_seq, _ = routed_run(cfg, "sequential")
        loops = [check_loop_launches(f"{name} sequential", sim, n_sets)]
        fused, wall_fused, by_fused, said = routed_run(cfg, "fused")
        loops.append(check_loop_launches(f"{name} fused", sim, n_sets))
        total = add_launches(total, by_seq, by_fused)
        l_seq, l_fused = sum(by_seq.values()), sum(by_fused.values())
        diff = stored_diff(seq, fused)
        rep, rep_seq = route_report(fused), route_report(seq)
        planned = sum(r == "replay" for r in rep["routes"])
        check(diff == 0.0 and rep["graph_captures"] == 1
              and rep["graph_replays"] == planned >= n_sets - 3
              and "replay one CUDA graph" in said
              # the fused route's last set makes an unused proposal
              and rep["mvn_rounds"][:-1] == rep_seq["mvn_rounds"][:-1]
              and l_fused == l_seq == 2 * (n_sets - 1),
              f"{name} under fused: diff {diff}, {rep}, launches {l_seq}, "
              f"{l_fused}, said {said[:200]!r}")
        emit({"phase": "fused", "example": name, "noise": "MULTIVARIATE",
              "sets": n_sets, "fused_vs_sequential_max_abs_diff": diff,
              "wall_s": {"sequential": wall_seq, "fused": wall_fused},
              "launches": {"sequential": l_seq, "fused": l_fused},
              "loop_launches": dict(zip(("sequential", "fused"), loops)),
              "set_ms": {"sequential": set_ms_by_route(rep_seq)["eager"],
                         "fused": set_ms_by_route(rep)},
              "mvn_rounds": rep["mvn_rounds"],
              "sets_finished_eagerly": rep["mvn_eager_finishes"],
              "sequential": rep_seq, "fused": rep})

    # what the block costs an eager set: dice sequential with one round per
    # block (a host read per round, as before the block existed) against
    # the default block; the same rows
    from abcsmc_tpu_torch import Generation

    cfg = json.loads((REPO / "examples" / "dice.json").read_text())
    blocks = (1, Generation.rejection_block) * 2
    runs = [routed_run(cfg, "sequential", rejection_block=b) for b in blocks]
    total = add_launches(total, *(r[2] for r in runs))
    for run, *_ in runs[1:]:
        check(stored_diff(runs[0][0], run) == 0.0,
              f"dice: rejection blocks {blocks} give other rows")
    price = {f"block_{b}": [] for b in blocks}
    for b, (run, *_) in zip(blocks, runs):
        price[f"block_{b}"].append(set_ms_by_route(route_report(run))["eager"])
    emit({"phase": "fused", "example": "dice", "eager_block_price": price})

    # the eager finish forced: a rejection block of 2 rounds, where dice's
    # replayed sets need 6-8; the same rows as the sequential run's default
    # block, and the kernel inside each replayed MVN graph against plain
    cfg = json.loads((REPO / "examples" / "dice.json").read_text())
    n_sets = cfg["smc_iterations"]
    seq, _, by_seq, _ = routed_run(cfg, "sequential")
    with ReplayedKernelCheck() as kcheck:
        forced, wall_forced, by_forced, _ = routed_run(cfg, "fused",
                                                       rejection_block=2)
    total = add_launches(total, by_seq, by_forced)
    l_seq, l_forced = sum(by_seq.values()), sum(by_forced.values())
    diff = stored_diff(seq, forced)
    rep = route_report(forced)
    finished = [f for f, r in zip(rep["mvn_finished_eagerly"],
                                  rep["routes"]) if r == "replay"]
    check(diff == 0.0 and rep["graph_replays"] >= n_sets - 3
          and any(finished)
          and rep["mvn_eager_finishes"] == sum(rep["mvn_finished_eagerly"])
          and l_forced == l_seq
          and len(kcheck.errs) == rep["graph_replays"]
          and max(kcheck.errs) <= TOL,
          f"dice, block 2: diff {diff}, {rep}, kernel {kcheck.errs}")
    kernel_errs["replayed_mvn_graph/dice"] = max(kcheck.errs, default=math.inf)
    emit({"phase": "fused", "example": "dice", "rejection_block": 2,
          "fused_vs_sequential_max_abs_diff": diff,
          "replayed_sets_finished_eagerly": sum(finished),
          "replayed_sets": len(finished), "wall_s": wall_forced,
          "set_ms": set_ms_by_route(rep), "mvn_rounds": rep["mvn_rounds"],
          "kernel_in_replayed_mvn_graph_max_abs_err": kcheck.errs})
    return total


def phase_surfaces(run):
    import numpy as np

    from abcsmc_tpu_torch import compare, crc32

    t0 = time.perf_counter()
    db = run.storage.path
    ckpt = fresh_store("dengue_checkpoint.sqlite")
    stamp = run.checkpoint(ckpt)
    t_ckpt = time.perf_counter() - t0
    check(crc32.verify_checkpoint(ckpt), "checkpoint CRC")
    check(stamp["crc32"] == crc32.database_crc(ckpt)["crc32"], "stamp")
    cmp = compare.compare(db, ckpt)
    check(max(v["ks"] for v in cmp.values()) == 0.0
          and store_rows(ckpt) == store_rows(db), "checkpoint differs")
    keep = run.config.pred_prior_size_at(run.config.num_smc_sets - 1)
    ess = run.ess()
    check(1.0 < ess <= keep, f"ess {ess}")
    summary = run.posterior_summary()
    for spec, (name, row) in zip(run.config.parameters, summary.items()):
        check(spec.par1 <= row["quantiles"][0.5] <= spec.par2,
              f"median of {name} outside the prior: {row}")
    t1 = time.perf_counter()
    pred = run.posterior_predictive(1000, seed=3)
    t_pred = time.perf_counter() - t1
    check(run.device.type == "cuda" and pred.shape == (1000, run.nmet)
          and bool(np.isfinite(pred).all()), "posterior_predictive")
    # model criticism as a user would read it: the observed metrics lie
    # inside the predictive draws' range in most columns
    inside = float(((pred.min(0) <= run.obs) & (run.obs <= pred.max(0))).mean())
    check(inside >= 0.9, f"observed inside the predictive range: {inside}")
    emit({"phase": "surfaces", "checkpoint_s": t_ckpt, "stamp": stamp,
          "compare_max_ks": 0.0, "ess": ess, "keep": keep,
          "first_parameter": next(iter(summary.items())),
          "posterior_predictive": {"rows": 1000, "seconds": t_pred,
                                   "observed_inside_range": inside},
          "wall_s": time.perf_counter() - t0})


MESH_SHARDS = 4              # the virtual mesh of the north-star step
MESH_KEEP = 50_000
MESH_N = 1_000_000


def mesh_generation(n, keep, mesh, **kw):
    """The 6 x 13 north-star step on ``mesh`` (float32)."""
    import numpy as np

    from abcsmc_tpu_torch.config import parse_config
    from abcsmc_tpu_torch.models.parameters import ParameterSet
    from abcsmc_tpu_torch.models.transforms import ParameterTransform
    from abcsmc_tpu_torch.parallel.generation import Generation

    raw, _ = scale_config(n, keep)
    cfg = parse_config(raw)
    return Generation(
        ParameterSet.from_specs(cfg.parameters),
        ParameterTransform(cfg.parameters), None,
        np.array([m.value for m in cfg.metrics]), mesh=mesh, **kw)


MESH_STEP_REPS = 2            # timed calls after the checked one and a warm-up


def mesh_steps(n, keep, data, state, shards_list, nccl_group=None):
    """One later-set step of the same population on each mesh: the same
    van der Voet seed everywhere (the one-shard step's first draw), each
    mesh's own proposal draws; then its time over ``MESH_STEP_REPS``
    calls. Returns {name: (gen, result, ms)}."""
    import dataclasses

    import torch

    from abcsmc_tpu_torch.parallel.mesh import particle_mesh

    out = {}
    vdv = None
    for name, devices, kw in shards_list:
        group = nccl_group if name == "nccl_1rank" else None
        mesh = particle_mesh(devices, group=group)
        gen = mesh_generation(n, keep, mesh, **kw)
        g = torch.Generator(device="cuda" if mesh.size == 1 else "cpu")
        draws = gen.draw_step(g.manual_seed(5), n)
        if vdv is None:
            vdv = draws.vdv_seed
        draws = dataclasses.replace(draws, vdv_seed=vdv)
        params = gen.mesh.shard_rows(data[0], n)
        mets = gen.mesh.shard_rows(data[1], n)

        def step():
            return gen.step_precomputed(params, mets, keep, n, draws, state,
                                        n_valid=n)

        res = step()
        torch.cuda.synchronize()
        out[name] = (gen, res, cuda_ms(step, MESH_STEP_REPS))
    return out


def mesh_kernel_vs_plain(res, state, shards):
    """Each shard's weight-kernel call of the step, rebuilt on the same
    inputs: its ``ceil(keep / shards)`` survivors (edge-padded) against
    every previous center, kernel against plain. Returns (max abs err,
    per-shard kernel ms, plain ms, the shape)."""
    import torch

    from abcsmc_tpu_torch.ops import weights
    from abcsmc_tpu_torch.ops.kernels import (
        mixture_logsumexp, mixture_logsumexp_reference,
    )

    surv = res.survivor_params
    keep = surv.shape[0]
    k_per = -(-keep // shards)
    pad = torch.cat([surv, surv[-1:].expand(k_per * shards - keep, -1)])
    prev_par, prev_w, prev_dv = state
    err, ms, plain_ms = 0.0, [], []
    for s in range(shards):
        a, b, _ = weights._prep_scaled(pad[s * k_per:(s + 1) * k_per],
                                       prev_par, prev_dv)
        a, b = a.contiguous(), b.contiguous()
        lw = torch.log(prev_w).contiguous()
        got = mixture_logsumexp(a, b, lw, precision="high")
        ref = mixture_logsumexp_reference(a, b, lw)
        torch.cuda.synchronize()
        err = max(err, float((got - ref).abs().max()))
        ms.append(cuda_ms(lambda: mixture_logsumexp(a, b, lw,
                                                    precision="high"), 5))
        plain_ms.append(cuda_ms(
            lambda: mixture_logsumexp_reference(a, b, lw), 5))
    return err, ms, plain_ms, (k_per, prev_par.shape[0], surv.shape[1])


def mesh_north_star():
    """The north-star step on one shard and on a 4-shard mesh of cuda:0,
    the 4-shard step with the two-stage top-K, and the one-shard step
    through a one-rank NCCL group. Returns (launches, errs, report)."""
    import socket

    import numpy as np
    import torch
    import torch.distributed as dist


    n, keep, k = MESH_N, MESH_KEEP, MESH_SHARDS
    data, state = scale_data(n, keep)
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        reset_launches()
        steps = mesh_steps(n, keep, data, state, [
            ("one", ["cuda:0"], {}),
            ("mesh4", ["cuda:0"] * k, {"topk_two_stage": False}),
            ("mesh4_two_stage", ["cuda:0"] * k, {"topk_two_stage": True}),
            ("nccl_1rank", ["cuda:0"], {}),
        ], nccl_group=dist.group.WORLD)
        by = read_launches()
        launches = sum(by.values())
    finally:
        dist.destroy_process_group()
    one, four = steps["one"][1], steps["mesh4"][1]
    two, nccl = steps["mesh4_two_stage"][1], steps["nccl_1rank"][1]
    check(int(one.ncomp_used) > 1, f"mesh: one-shard ncomp {one.ncomp_used}")
    check(int(four.ncomp_used) == int(one.ncomp_used),
          f"mesh: ncomp {four.ncomp_used} on {k} shards vs {one.ncomp_used}")
    a_set = set(one.survivor_idx.tolist())
    b_set = set(four.survivor_idx.tolist())
    same_set = a_set == b_set
    check(same_set, f"mesh: {len(a_set ^ b_set)} survivors differ between "
          f"1 and {k} shards")
    # the weights of the same survivors, matched by global row
    order = torch.argsort(one.survivor_idx)
    order4 = torch.argsort(four.survivor_idx)
    w_gap = float(((one.weights[order] - four.weights[order4]).abs()
                   / one.weights.abs().max()).max())
    dv_gap = float(((one.doubled_variance - four.doubled_variance).abs()
                    / one.doubled_variance.abs()).max())
    check(w_gap <= 1e-3, f"mesh: weight gap {w_gap} (of the largest)")
    check(dv_gap <= 1e-4, f"mesh: doubled-variance gap {dv_gap}")
    for f in ("survivor_idx", "survivor_params", "survivor_metrics",
              "weights", "doubled_variance"):
        check(torch.equal(getattr(two, f), getattr(four, f)),
              f"mesh: two-stage top-K {f} differs from the single stage")
    check(torch.equal(torch.cat(two.next_params),
                      torch.cat(four.next_params)), "mesh: two-stage next")
    for f in ("survivor_idx", "weights", "doubled_variance", "ncomp_used",
              "next_params", "next_seeds"):
        x, y = getattr(nccl, f), getattr(one, f)
        x = torch.cat(x) if isinstance(x, list) else x
        y = torch.cat(y) if isinstance(y, list) else y
        check(torch.equal(x, y), f"mesh: the one-rank NCCL step's {f} is not "
              "the one-shard step's")
    # 2 launches per weight call, one call per shard, every step run
    # 2 + MESH_STEP_REPS times (checked, warm-up, timed)
    check(launches == 2 * (2 + MESH_STEP_REPS) * (1 + k + k + 1),
          f"mesh: north-star launches {launches}")
    err, ms, plain_ms, shape = mesh_kernel_vs_plain(four, state, k)
    check(err <= TOL, f"mesh: per-shard kernel err {err}")
    bound = kernel_bound_ms(*shape)
    report = {
        "n": n, "keep": keep, "shards": k,
        "ncomp": [int(one.ncomp_used), int(four.ncomp_used)],
        "same_survivor_set": same_set, "weight_gap": w_gap,
        "doubled_variance_gap": dv_gap,
        "step_ms": {name: v[2] for name, v in steps.items()},
        "shard_kernel_shape": list(shape), "shard_kernel_ms": ms,
        "shard_plain_ms": plain_ms, "shard_kernel_max_abs_err": err,
        "shard_bound_ms": bound["bound_ms"],
        "shard_bound_share": [bound["bound_ms"] / t for t in ms],
        "launches": launches,
    }
    return by, {"mesh_shard_12500x50000x6": err}, report


def mesh_dengue():
    """dengue_surrogate as shipped (102,400 x 16 x 100) on a 3-shard mesh
    of cuda:0 (102,400 rows pad to 102,402), 3 sets, SQLite."""
    import numpy as np

    from abcsmc_tpu_torch import AbcSmc
    from abcsmc_tpu_torch.parallel.mesh import particle_mesh

    path = REPO / "examples" / "dengue_surrogate.json"
    cfg = json.loads(path.read_text())
    truth = np.array(json.loads(
        re.search(r"truth=(\[[^\]]*\])", cfg["comment"]).group(1)))
    n, keep = 102_400, 2_048
    k, n_sets = MESH_RUNS["dengue_surrogate"]
    cfg["smc_iterations"] = n_sets
    shapes = mesh_kernel_shapes("dengue_surrogate")
    check(with_high(shapes) <= HELD, f"dengue mesh: kernel shapes "
          f"{with_high(shapes) - HELD} "
          "were not held against plain")
    db = cfg["database_filename"] = fresh_store("dengue_mesh3.sqlite")
    reset_launches()
    t0 = time.perf_counter()
    run = AbcSmc(cfg, device="cuda").run_device(
        seed=0, mesh=particle_mesh(["cuda:0"] * k))
    wall = time.perf_counter() - t0
    by = read_launches()
    launches = sum(by.values())
    run.storage.close()
    rows = store_rows(db)
    check(rows == [(t, n, n, keep) for t in range(n_sets)],
          f"dengue mesh store rows {rows}")
    check(launches == 2 * k * (n_sets - 1),
          f"dengue mesh launches {launches}")
    rep = fit_report(run, cfg, truth, ())
    check(min(rep["ncomp"]) > 1, f"dengue mesh ncomp {rep['ncomp']}")
    pars, _ = run.posterior()
    rmse_post = float(np.sqrt(((pars.mean(0) - truth) ** 2).mean()))
    rmse_prior = float(np.sqrt(((0.5 - truth) ** 2).mean()))
    check(rmse_post < rmse_prior, f"dengue mesh posterior rmse {rmse_post} "
          f">= prior {rmse_prior}")
    return by, {"store_rows": rows, "wall_s": wall,
                      "kernel_shapes": sorted(shapes),
                      "rmse_posterior": rmse_post, "rmse_prior": rmse_prior,
                      "routes": rep["routes"], "set_ms": rep["set_ms"],
                      "ncomp": rep["ncomp"], "launches": launches,
                      "phases": rep["phases"]}


def mesh_fits():
    """sir (MULTIVARIATE) and dice (MULTIVARIATE, systematic resampling) as
    shipped on a 2-shard mesh of cuda:0, SQLite stores."""
    from abcsmc_tpu_torch import AbcSmc
    from abcsmc_tpu_torch.parallel.mesh import particle_mesh

    out, launches = {}, {}
    for name, extra in (("sir", {}), ("dice", {"resample_method":
                                               "systematic"})):
        k = MESH_RUNS[name][0]
        shapes = mesh_kernel_shapes(name)
        check(with_high(shapes) <= HELD, f"{name} mesh: kernel shapes "
              f"{with_high(shapes) - HELD} "
              "were not held against plain")
        cfg = json.loads((REPO / "examples" / f"{name}.json").read_text())
        cfg.update(extra)
        cfg["database_filename"] = fresh_store(f"{name}_mesh2.sqlite")
        reset_launches()
        t0 = time.perf_counter()
        run = AbcSmc(cfg, device="cuda").run_device(
            seed=0, mesh=particle_mesh(["cuda:0"] * k))
        wall = time.perf_counter() - t0
        by = read_launches()
        n_launch = sum(by.values())
        run.storage.close()
        sets = cfg["smc_iterations"]
        check(n_launch == 2 * k * (sets - 1),
              f"{name} mesh launches {n_launch}")
        loop_launches = check_loop_launches(f"{name} mesh",
                                            cfg["simulator"], k * sets)
        rep = fit_report(run, cfg, *EXAMPLES[name][:2])
        check(max(rep["mvn_rounds"][:-1]) >= 1, f"{name} mesh mvn rounds")
        out[name] = {"wall_s": wall, "launches": n_launch,
                     "loop_launches": loop_launches,
                     "kernel_shapes": sorted(shapes),
                     "mvn_rounds": rep["mvn_rounds"], "ncomp": rep["ncomp"],
                     "routes": rep["routes"], "set_ms": rep["set_ms"],
                     "posterior_mean": rep["posterior_mean"]}
        launches = add_launches(launches, by)
    return launches, out


def mesh_multi_device():
    """A real mesh over every card of the machine, where there is more
    than one: its step against the one-shard step."""
    import torch

    count = torch.cuda.device_count()
    if count < 2:
        print(f"mesh: the multi-device mesh did not run: this machine has "
              f"{count} CUDA device (a mesh over several cards needs two "
              "or more)", flush=True)
        return {}, None
    n, keep = MESH_N, MESH_KEEP
    data, state = scale_data(n, keep)
    reset_launches()
    steps = mesh_steps(n, keep, data, state, [
        ("one", ["cuda:0"], {}),
        ("devices", [f"cuda:{i}" for i in range(count)], {})])
    launches = read_launches()
    one, many = steps["one"][1], steps["devices"][1]
    check(int(one.ncomp_used) == int(many.ncomp_used),
          "multi-device ncomp")
    check(set(one.survivor_idx.tolist()) == set(many.survivor_idx.tolist()),
          "multi-device survivors")
    err, ms, _, shape = mesh_kernel_vs_plain(many, state, count)
    check(err <= TOL, f"multi-device per-shard kernel err {err}")
    return launches, {"devices": count,
                      "step_ms": {k: v[2] for k, v in steps.items()},
                      "shard_kernel_shape": list(shape),
                      "shard_kernel_max_abs_err": err, "shard_kernel_ms": ms}


def pick_cdf_determinism(reps=30):
    """The resample pick's cdf on the card: ``torch.cumsum`` of a 1-D
    tensor (a look-back scan whose float order depends on timing) against
    the step's ``_cumsum`` (a scan of 1,024-entry rows, then of their
    totals): how many of ``reps`` repeats differ from the first, and ms a
    call, at the north-star keep, 2^22 and 2^26 entries."""
    import torch

    from abcsmc_tpu_torch.parallel.generation import _cumsum

    out = {}
    for k in (MESH_KEEP, 1 << 22, 1 << 26):
        w = torch.rand(k, generator=torch.Generator(device="cuda")
                       .manual_seed(k), device="cuda")
        row = {}
        for name, fn in (("torch_cumsum", lambda: torch.cumsum(w, 0)),
                         ("step_cumsum", lambda: _cumsum(w))):
            first = fn()
            row[name + "_runs_differing"] = sum(
                not torch.equal(first, fn()) for _ in range(reps - 1))
            row[name + "_ms"] = cuda_ms(fn, 10)
        check(row["step_cumsum_runs_differing"] == 0,
              f"the step's cdf scan differs between runs at {k}")
        out[str(k)] = row
    return out


def phase_mesh():
    """The particle mesh: the north-star step on 1 and 4 shards of cuda:0
    (two-stage top-K, a one-rank NCCL group), dengue_surrogate on 3 shards,
    sir and dice on 2, and a mesh over several cards where there are."""
    t0 = time.perf_counter()
    l_north, errs, north = mesh_north_star()
    l_dengue, dengue = mesh_dengue()
    l_fits, fits = mesh_fits()
    l_multi, multi = mesh_multi_device()
    launches = add_launches(l_north, l_dengue, l_fits, l_multi)
    if multi is not None:
        errs["mesh_multi_device_shard"] = multi["shard_kernel_max_abs_err"]
    emit({"phase": "mesh", "north_star": north, "dengue_mesh3": dengue,
          "fits_mesh2": fits, "multi_device": multi,
          "pick_cdf": pick_cdf_determinism(),
          "wall_s": time.perf_counter() - t0})
    return launches, errs


# --------------------------------------------------------------------------- #
# study: the harnesses of abcsmc_tpu_torch.tools, in process
# --------------------------------------------------------------------------- #

# (tool, argv): the JAX tools' own sizes unless cut here
STUDY_RUNS = (
    ("bench_weight_kernel", []),
    # the kernel apart at the keeps of hbm_scale's 2^24 and 2^25 steps
    ("bench_weight_kernel", ["--k", "838860", "1677721", "--reps", "1",
                             "--skip-10m"]),
    ("sweep_weight_kernel", []),
    ("bench_scale", ["--n", "50000000", "--keep", "500000", "--sim"]),
    ("mirror_scale", ["--n", "1000000"]),     # the JAX table's 1M row
    ("bench_reference_shape", []),
    ("quickstart_chip", []),
    ("million_run", []),
    ("stat_validate", []),
    ("calibration_study", ["--reps", "10", "--n", "1024"]),
    ("bench_native", ["--jobs", "500"]),
)


def study_kernel_errs(tool, lines):
    """The kernel errors a harness held to 2e-4 nats: against float64, or
    for the "default" scheme against its own plain version (a swept split
    beyond the plan's cap is reported, not held)."""
    errs = {}
    for row in lines:
        own = row.get("precision") == "default"
        err = row.get("max_abs_err_own_sampled" if own
                      else "max_abs_err_f64_sampled")
        if err is None or row.get("within_cap") is False:
            continue
        errs[f"study {tool} {row['metric']}"] = err
    return errs


def phase_study():
    import importlib

    import torch


    out_dir = SMOKE_DIR / "study"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    t_phase = time.perf_counter()
    reset_launches()
    errs, seconds = {}, {}
    for i, (tool, argv) in enumerate(STUDY_RUNS):
        out = out_dir / f"{i:02d}_{tool}.jsonl"
        main_fn = importlib.import_module(
            f"abcsmc_tpu_torch.tools.{tool}").main
        t0 = time.perf_counter()
        with redirect_stdout(io.StringIO()):      # the lines go to `out`
            rc = main_fn([*argv, "--out", str(out)])
        check(rc == 0, f"study {tool} {argv}: exit {rc}")
        lines = [json.loads(x) for x in out.read_text().splitlines()]
        seconds[f"{i:02d}_{tool}"] = time.perf_counter() - t0
        errs.update(study_kernel_errs(tool, lines))
        emit({"phase": "study", "tool": tool, "argv": argv,
              "seconds": seconds[f"{i:02d}_{tool}"], "lines": lines[1:]})
        torch.cuda.empty_cache()
    by_prec = read_launches()
    launches = sum(by_prec.values())
    check(launches > 0, "study phase launched no kernel")
    check(max(errs.values()) <= TOL, f"study kernel errors {errs}")
    # every launch of the phase counts: its split by scheme
    emit({"phase": "study", "launches": launches,
          "launches_by_precision": by_prec, "seconds": seconds,
          "kernel_max_abs_err_held": max(errs.values()),
          "wall_s": time.perf_counter() - t_phase})
    return by_prec, errs


# --------------------------------------------------------------------------- #
# bench: the JAX repo's last entry points, ported
# --------------------------------------------------------------------------- #

BENCH_EXTRA_K = (10_000, 50_000, 200_000)     # bench_extra's kernel lines
BENCH_EXTRA_GEN = (100_000, 1_000_000)        # its generations, keep n / 20
DRYRUN_SHARDS = 4
SCALING_ARGV = ["--n", "1048576", "--shards", "1,2,4,8",
                "--n-sweep", "4194304"]
SCALING_SHARDS = (1, 2, 4, 8)
SCALING_KEEP = 50_000


def bench_kernel_shapes():
    """Every (n, m, p) the ``bench`` phase gives the kernel: the north-star
    step's keep^2 x 6; bench_extra's kernel lines and its generations'
    (n / 20)^2 x 6; each dry-run case's weighted generation, ceil(keep /
    shards) x keep x 2 (the fused chain and the resume: 2 x 8 x 2); the
    scaling tool's per-shard ceil(50,000 / shards) x 50,000 x 6."""
    from abcsmc_tpu_torch import bench
    from abcsmc_tpu_torch.graft_entry import dryrun_cases

    k = DRYRUN_SHARDS
    shapes = {(bench.KEEP, bench.KEEP, bench.NPAR)}
    shapes |= {(x, x, 6) for x in BENCH_EXTRA_K}
    shapes |= {(x // 20, x // 20, 6) for x in BENCH_EXTRA_GEN}
    shapes |= {(-(-keep // k), keep, 2) for _, _, keep, _ in dryrun_cases(k)}
    shapes.add((2, 8, 2))
    shapes |= {(-(-SCALING_KEEP // s), SCALING_KEEP, 6)
               for s in SCALING_SHARDS}
    return sorted(shapes)


class held_shapes_only:
    """Within it every kernel launch must be at a shape the kernel phase
    held against plain (else the launch raises, before it runs); records
    the shapes launched."""

    def __enter__(self):
        from abcsmc_tpu_torch.ops import kernels

        self.kernels, self.orig, self.seen = kernels, kernels._launch, set()

        def launch(a, b, log_w, mode, **kw):
            shape = (a.shape[0], b.shape[0], a.shape[1], kw["precision"])
            check(shape in HELD, f"bench: kernel shape {shape} was not "
                  "held against plain in the kernel phase")
            self.seen.add(shape)
            return self.orig(a, b, log_w, mode, **kw)

        kernels._launch = launch
        return self

    def __exit__(self, *exc):
        self.kernels._launch = self.orig
        return False


def run_main(main_fn, argv):
    """``main_fn(argv)`` in process: (its JSON lines, the other stdout
    lines); exit 0 required."""
    buf = io.StringIO()
    with redirect_stdout(buf), redirect_stderr(io.StringIO()):
        rc = main_fn(argv)
    check(rc == 0, f"{main_fn.__module__} {argv}: exit {rc}")
    lines = buf.getvalue().splitlines()
    return ([json.loads(x) for x in lines if x.startswith("{")],
            [x for x in lines if not x.startswith("{")])


def scaling_checks(rows, label):
    """The scaling contract on the tool's rows: reduction payloads equal
    across shard counts and N among rows of one top-K strategy, the
    gather payload fixed in N, FLOPs over all shards within 2 %."""
    def red(r):
        return sum(r["collectives"].get(k, {"bytes": 0})["bytes"]
                   for k in ("psum", "pmin"))

    for two in (False, True):
        same = {red(r) for r in rows if r["topk_two_stage"] == two}
        check(len(same) <= 1, f"{label}: reduction payloads {same}")
    by = {(r["shards"], r["n"]): r for r in rows}
    big = max(r["n"] for r in rows)
    g8 = by[(8, 1 << 20)]["collectives"]["all_gather"]["bytes"]
    check(g8 == by[(8, big)]["collectives"]["all_gather"]["bytes"],
          f"{label}: the gather payload grew with N")
    f1, f8 = by[(1, 1 << 20)]["flops_total"], by[(8, 1 << 20)]["flops_total"]
    check(abs(f8 - f1) / f1 < 0.02, f"{label}: flops {f1} vs {f8}")


def phase_bench():
    """The north-star bench on both routes at 1M, bench_extra at the JAX
    sizes, entry()'s fn, dryrun_multichip(4) on the card's virtual mesh
    and the scaling counts, in process."""
    import torch

    from abcsmc_tpu_torch import bench, bench_extra, graft_entry
    from abcsmc_tpu_torch.tools import scaling_analysis

    t_phase = time.perf_counter()
    reset_launches()
    seconds, out = {}, {}
    with held_shapes_only() as held:
        for route in ("eager", "replay"):
            t0 = time.perf_counter()
            rows, _ = run_main(bench.main, ["--route", route, "--shards",
                                            "1"])
            seconds[f"bench_{route}"] = time.perf_counter() - t0
            check(len(rows) == 1, f"bench {route}: {len(rows)} lines")
            row = out[f"bench_{route}"] = rows[0]
            check(row["route"] == route and row["ncomp_used"] > 1
                  and row["vs_baseline"] is None and row["value"] > 0,
                  f"bench {route}: {row}")
            check(row["device"] not in ("", "cpu"), f"bench device {row}")
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        rows, _ = run_main(bench_extra.main, [])
        seconds["bench_extra"] = time.perf_counter() - t0
        check(len(rows) == 1 + len(BENCH_EXTRA_K) + 1
              + 2 * len(BENCH_EXTRA_GEN), f"bench_extra: {len(rows)} lines")
        check(all(r["value"] > 0 for r in rows), "bench_extra times")
        out["bench_extra"] = rows
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        fn, args = graft_entry.entry("cuda")
        surv, w, nxt = fn(*args)
        torch.cuda.synchronize()
        check(tuple(surv.shape) == (128, 2) and tuple(w.shape) == (128,)
              and tuple(nxt.shape) == (1024, 2)
              and bool(torch.isfinite(nxt).all()), "entry fn outputs")
        buf = io.StringIO()
        with redirect_stdout(buf), redirect_stderr(io.StringIO()):
            lines = graft_entry.dryrun_multichip(DRYRUN_SHARDS)
        check(len(lines) == len(graft_entry.dryrun_cases(DRYRUN_SHARDS)) + 4,
              f"dryrun lines {lines}")
        if torch.cuda.device_count() < DRYRUN_SHARDS:     # one card's mesh
            check(not any("(0 CUDA-graph replays)" in x for x in lines),
                  "dryrun run_scan did not replay on the card")
        out["dryrun"] = buf.getvalue().splitlines()
        seconds["entry_dryrun"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        rows, table = run_main(scaling_analysis.main, SCALING_ARGV)
        scaling_checks(rows, "scaling auto")
        single, _ = run_main(scaling_analysis.main,
                             SCALING_ARGV + ["--topk", "single"])
        scaling_checks(single, "scaling single")
        check(len({r["collectives"]["psum"]["bytes"] for r in single}) == 1,
              "single-stage reduction payloads differ")
        out["scaling"] = rows
        out["scaling_table"] = [x for x in table if x.startswith("|")]
        out["scaling_single_stage"] = single
        seconds["scaling"] = time.perf_counter() - t0
    by = read_launches()
    launches = sum(by.values())
    check(launches > 0, "bench phase launched no kernel")
    emit({"phase": "bench", **out, "launches": launches,
          "kernel_shapes": sorted(held.seen), "seconds": seconds,
          "wall_s": time.perf_counter() - t_phase})
    return by, {}


# --------------------------------------------------------------------------- #
# bridge: a black-box numpy simulator inside run_device's step
# --------------------------------------------------------------------------- #

BRIDGE_SETS = 3          # dengue_surrogate's sets cut, its widths as shipped
BRIDGE_NOISE_SD = 0.3    # the linear_gaussian builtin's noise
BRIDGE_MESH = (4, 96, 3)  # the dice fit: shards of the card, rows, sets
BRIDGE_DICE_KEEP = 24


def bridge_kernel_shapes():
    """Every (n, m, p) the bridged fits give the kernel: dengue's keep^2 x
    16, and the mesh dice fit's per-shard ceil(keep / shards) x keep x 2."""
    k = BRIDGE_MESH[0]
    return sorted({(2048, 2048, 16),
                   (-(-BRIDGE_DICE_KEEP // k), BRIDGE_DICE_KEEP, 2)})


_MIX64 = (0xBF58476D1CE4E5B9, 0x94D049BB133111EB)


def numpy_counter_normals(seeds, ncols):
    """float32 standard normals [n, ncols], a function of (seed, column)
    alone: splitmix64's finaliser of seed << 32 | column gives two 24-bit
    uniforms, then Box-Muller. Vectorised numpy, no loop over rows."""
    import numpy as np

    h = np.asarray(seeds).astype(np.uint64)[:, None] << np.uint64(32)
    h = h | np.arange(ncols, dtype=np.uint64)[None, :]
    h ^= h >> np.uint64(30)
    h *= np.uint64(_MIX64[0])
    h ^= h >> np.uint64(27)
    h *= np.uint64(_MIX64[1])
    h ^= h >> np.uint64(31)
    scale = np.float32(2.0 ** -24)
    u1 = ((h >> np.uint64(40)).astype(np.float32) + np.float32(0.5)) * scale
    u2 = (h & np.uint64(0xFFFFFF)).astype(np.float32) * scale
    return (np.sqrt(np.float32(-2.0) * np.log(u1))
            * np.cos(np.float32(2.0 * math.pi) * u2))


def numpy_linear_gaussian(mix):
    """The black box of the bridged dengue fit: params @ mix +
    BRIDGE_NOISE_SD N(0, 1) in numpy, the noise deterministic per (seed,
    column)."""
    def fn(params, seeds):
        eps = numpy_counter_normals(seeds, mix.shape[1])
        return (params @ mix.astype(params.dtype)
                + (BRIDGE_NOISE_SD * eps).astype(params.dtype))

    return fn


def bridged_dengue(dispatch, db, seed=0):
    """examples/dengue_surrogate.json at its widths, BRIDGE_SETS sets,
    SQLite, through run_device with the numpy linear-Gaussian behind a
    HostBridgeSimulator; returns (engine, wall s, kernel launches by
    scheme, stderr)."""
    from abcsmc_tpu_torch import AbcSmc
    from abcsmc_tpu_torch.models.simulators import (
        HostBridgeSimulator, shipped_mix,
    )

    cfg = json.loads((REPO / "examples" / "dengue_surrogate.json").read_text())
    cfg.update(smc_iterations=BRIDGE_SETS, database_filename=db,
               device_dispatch=dispatch)
    sim = HostBridgeSimulator(numpy_linear_gaussian(shipped_mix(16, 100)),
                              nmet=100)
    err = io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    with redirect_stderr(err):
        run = AbcSmc(cfg, device="cuda", simulator=sim).run_device(
            seed=seed, verbose=True)
    wall = time.perf_counter() - t0
    by = read_launches()
    run.storage.close()
    return run, wall, by, err.getvalue()


def run_kernel_shapes(run):
    """The kernel against plain at each set's own inputs (set t's
    survivors against set t - 1's state), from the run's host copies of
    the float32 values the step computed with."""
    errs = {}
    for t in range(1, len(run._predictive_prior)):
        shape, err = kernel_vs_plain_sampled(*set_inputs(run, t))
        errs[f"bridge set {t} {shape}"] = err
    return errs


def bridge_mesh_dice():
    """The dice game behind a HostBridgeSimulator on a 4-shard mesh of the
    card, 96 rows a set, 3 sets: the host function journals every row it
    simulates; the journal's union equals the stored rows as multisets and
    every shard made its calls (one a set, in shard order, a quarter of
    the rows each). Returns (the phase's numbers, kernel launches by
    scheme)."""
    from collections import Counter

    import numpy as np

    from abcsmc_tpu_torch import AbcSmc
    from abcsmc_tpu_torch.models.simulators import HostBridgeSimulator
    from abcsmc_tpu_torch.parallel import particle_mesh

    shards, n, sets = BRIDGE_MESH
    journal = []

    def dice_host(params, seeds):
        out = np.empty((len(params), 2), params.dtype)
        rows = []
        for i in range(len(params)):
            nd, sd = int(round(float(params[i, 0]))), int(
                round(float(params[i, 1])))
            rolls = np.random.default_rng(int(seeds[i])).integers(
                1, sd + 1, size=nd)
            out[i] = [rolls.sum(), rolls.std(ddof=0) if nd > 1 else 0.0]
            rows.append((nd, sd, int(seeds[i])))
        journal.append(rows)
        return out

    cfg = {
        "smc_iterations": sets, "num_samples": n,
        "predictive_prior_size": BRIDGE_DICE_KEEP, "database_filename": "",
        "parameters": [
            {"name": "ndice", "dist_type": "UNIFORM", "num_type": "INT",
             "par1": 1, "par2": 60},
            {"name": "sides", "dist_type": "UNIFORM", "num_type": "INT",
             "par1": 1, "par2": 30}],
        "metrics": [{"name": "sum", "num_type": "INT", "value": 44},
                    {"name": "sd", "num_type": "FLOAT", "value": 2.39925}],
    }
    mesh = particle_mesh(["cuda:0"] * shards)
    reset_launches()
    t0 = time.perf_counter()
    with redirect_stderr(io.StringIO()):
        run = AbcSmc(cfg, device="cuda", simulator=HostBridgeSimulator(
            dice_host, nmet=2)).run_device(seed=19, mesh=mesh)
    wall = time.perf_counter() - t0
    by = read_launches()
    launches = sum(by.values())
    gens = run.storage.read_generations()
    stored = [(int(round(p[0])), int(round(p[1])), int(s))
              for g in gens for p, s in zip(g.params, g.seeds)]
    check(len(gens) == sets and len(stored) == n * sets,
          f"bridge mesh: {len(gens)} sets, {len(stored)} rows")
    check(Counter(r for call in journal for r in call) == Counter(stored),
          "bridge mesh: the journal's rows are not the store's")
    sizes = [len(call) for call in journal]
    check(sizes == [n // shards] * (shards * sets),
          f"bridge mesh: host calls of {sizes} rows")
    # one auto call (2 launches) per shard in every set after set 0
    check(launches == 2 * shards * (sets - 1),
          f"bridge mesh: kernel launches {launches}")
    return {"shards": shards, "rows_per_set": n, "sets": sets,
            "host_calls": len(journal), "rows_per_call": sizes[0],
            "journal_rows": sum(sizes), "store_rows": len(stored),
            "wall_s": wall}, by


def phase_bridge(host_cli_wall=None):
    """The host bridge: dengue_surrogate at full width with a numpy
    simulator behind HostBridgeSimulator, sequential and fused; the dice
    game bridged on a 4-shard mesh; tools.validate in process.
    ``host_cli_wall`` is the host_cli phase's wall for HOST_SETS sets in
    this run (None when it did not run), printed beside the bridged wall.
    The phase returns the launches of the three bridged runs only:
    validate's are mostly the kernel held against plain and timed at its
    four shapes, so they are printed apart (``validate_launches``) and not
    counted."""
    import numpy as np
    import torch

    from abcsmc_tpu_torch.tools import validate

    t_phase = time.perf_counter()
    cfg = json.loads((REPO / "examples" / "dengue_surrogate.json").read_text())
    truth = np.array(json.loads(
        re.search(r"truth=(\[[^\]]*\])", cfg["comment"]).group(1)))
    seq, wall, by_seq, said = bridged_dengue(
        "sequential", fresh_store("bridge_dengue.sqlite"))
    launches = sum(by_seq.values())
    check("falling back" not in said, "bridge: the host engine ran")
    n, keep = cfg["num_samples"], seq.config.pred_prior_size_at(0)
    rows = store_rows(seq.storage.path)
    check(rows == [(t, n, n, keep) for t in range(BRIDGE_SETS)],
          f"bridge store rows {rows}")
    rep = route_report(seq)
    check(rep["routes"] == ["eager"] * BRIDGE_SETS
          and rep["graph_captures"] == 0 and min(rep["ncomp"]) > 1,
          f"bridge sequential: {rep}")
    check(launches == 2 * (BRIDGE_SETS - 1),
          f"bridge kernel launches {launches}")
    gens = [e for e in seq.timings if e["op"] == "device_generation"]
    sim_ms = [e["simulate_ms"] for e in gens]
    check(all(ms is not None and ms > 0 for ms in sim_ms),
          f"bridge simulate ms {sim_ms}")
    rmse_post, rmse_prior = posterior_rmse(seq.posterior()[0], truth)
    errs = run_kernel_shapes(seq)

    fused, wall_fused, by_fused, said_fused = bridged_dengue(
        "fused", fresh_store("bridge_dengue_fused.sqlite"))
    l_fused = sum(by_fused.values())
    frep = route_report(fused)
    check(frep["route"] == "scan" and frep["graph_captures"] == 0
          and frep["graph_replays"] == 0
          and frep["routes"] == ["eager"] * BRIDGE_SETS,
          f"bridge fused: {frep}")
    check("the simulator makes a host round trip" in said_fused,
          "bridge fused: the reason it runs eagerly was not said")
    diff = stored_diff(seq, fused)
    check(diff == 0.0, f"bridge: fused differs from sequential by {diff}")
    check(l_fused == launches, f"bridge fused launches {l_fused}")
    mesh_out, by_mesh = bridge_mesh_dice()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    reset_launches()
    lines, _ = run_main(validate.main, [])
    validate_s = time.perf_counter() - t0
    validate_launches = read_launches()
    kern = [r for r in lines if r.get("metric", "").startswith("mixture")]
    check(len(kern) == len(validate.SHAPES)
          and max(r["max_abs_err"] for r in kern) <= TOL,
          f"validate kernel lines {kern}")
    check(lines[-2]["ncomp_used"] > 1
          and lines[-1]["survivor_overlap"] > 0.999,
          f"validate step lines {lines[-2:]}")
    errs.update({f"validate {r['metric']}": r["max_abs_err"] for r in kern})
    emit({"phase": "bridge", "example": "dengue_surrogate",
          "sets": BRIDGE_SETS, "store_rows": rows, "ncomp": rep["ncomp"],
          "routes": rep["routes"], "set_ms": rep["set_ms"],
          "simulate_ms": sim_ms, "wall_s": wall,
          "wall_s_per_set": wall / BRIDGE_SETS,
          "host_cli_wall_s": host_cli_wall,
          "host_cli_sets": HOST_SETS if host_cli_wall else None,
          "host_cli_wall_s_per_set": (host_cli_wall / HOST_SETS
                                      if host_cli_wall else None),
          "dispatch_s": rep["dispatch_s"], "mirror_s": rep["mirror_s"],
          "launches": launches, "kernel_max_abs_err": errs,
          "rmse_posterior": rmse_post, "rmse_prior": rmse_prior,
          "fused": {"wall_s": wall_fused, "set_ms": frep["set_ms"],
                    "route": frep["route"],
                    "graph_captures": frep["graph_captures"],
                    "stored_max_abs_diff": diff, "launches": l_fused},
          "mesh_dice": mesh_out, "mesh_launches": by_mesh})
    emit({"phase": "bridge", "tool": "validate", "seconds": validate_s,
          "validate_launches": validate_launches, "lines": lines[1:]})
    emit({"phase": "bridge", "wall_s": time.perf_counter() - t_phase})
    return add_launches(by_seq, by_fused, by_mesh), errs


T_START = time.perf_counter()


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

    only = set()
    if "--only" in sys.argv[1:]:
        only = set(sys.argv[sys.argv.index("--only") + 1].split(","))

    def wanted(name):
        return not only or name in only

    errs, times, schemes = phase_kernel()
    sir_kernel = phase_sir_kernel()
    ricker_kernel = phase_ricker_kernel()
    main_path = dict.fromkeys(PRECISIONS, 0)
    walls = {}

    def run(name, phase):
        """Runs a phase; adds its main-path launches by scheme (each read
        just after a main-path run, the counts reset just before it) to
        main_path."""
        t0 = time.perf_counter()
        more, *rest = phase()
        walls[name] = time.perf_counter() - t0
        for k, v in more.items():
            main_path[k] += v
        return rest

    dengue_run = None
    if wanted("dengue") or wanted("surfaces"):
        (dengue_run,) = run("dengue", phase_dengue)
    if wanted("north"):
        run("north", lambda: (phase_north(),))
    host_cli_wall = None
    if wanted("host_cli"):
        (host_cli_wall,) = run("host_cli", phase_host_cli)
    for name, phase in (("resume", phase_resume),
                        ("examples", phase_examples),
                        ("sir_1m", phase_sir_1m),
                        ("projection", phase_projection)):
        if wanted(name):
            run(name, lambda: (phase(),))
    for name, phase in (("hbm_scale", phase_hbm_scale),
                        ("fused", phase_fused), ("mesh", phase_mesh),
                        ("study", phase_study), ("bench", phase_bench),
                        ("bridge", lambda: phase_bridge(host_cli_wall)),
                        ("precision", phase_precision)):
        if wanted(name):
            (more_errs,) = run(name, phase)
            errs.update(more_errs)
    if wanted("surfaces"):
        t0 = time.perf_counter()
        phase_surfaces(dengue_run)
        walls["surfaces"] = time.perf_counter() - t0
    walls["script"] = time.perf_counter() - T_START
    emit({"phase": "walls", "seconds": walls,
          "main_path_launches": main_path,
          "loop_main_path_launches": dict(LOOP_LAUNCHES)})
    n, m, p = REPORT_SHAPE
    big = f"{n}x{m}x{p}"
    bound = kernel_bound_ms(n, m, p)
    n2, m2, p2 = KERNEL_SHAPES[-1]
    small_p = f"{n2}x{m2}x{p2}"
    bound_p2 = kernel_bound_ms(n2, m2, p2)
    high_errs = [v for k, v in errs.items() if "rel" not in k
                 and "default" not in k and "highest" not in k]
    entries = [{
        "name": KERNEL_NAMES["high"],
        "route": "cuda",
        "source": "abcsmc_tpu_torch/csrc/mixture_logsumexp.cu",
        "replaces": "abcsmc_tpu/ops/pallas_kernels.py:166",
        "precision": "high",
        "launches": main_path["high"],
        "max_abs_err": max(high_errs),
        "ms": times[big]["ms"],
        "device_ms": times[big]["device_ms"],
        "plain_ms": times[big]["plain_ms"],
        "bound_ms": bound["bound_ms"],
        "bound_by": bound["bound_by"],
        "bound_share": bound["bound_ms"] / times[big]["ms"],
        "library_ms": None,
        "shape": [n, m, p],
        "ms_static": times[big]["ms_static"],
        "ms_online": times[big]["ms_online"],
        "bound_terms_ms": bound["terms_ms"],
        "by_shape": {
            key: {"ms": t["ms"], "device_ms": t["device_ms"],
                  "plain_ms": t["plain_ms"],
                  **{k: v for k, v in kernel_bound_ms(
                      *map(int, key.split("x"))).items()
                     if k in ("bound_ms", "bound_by")}}
            for key, t in times.items()},
        "schemes_by_shape": drop_issue_floor(schemes["high"]),
        "p2": {"shape": [n2, m2, p2], "ms": times[small_p]["ms"],
               "device_ms": times[small_p]["device_ms"],
               "plain_ms": times[small_p]["plain_ms"],
               "ms_static": times[small_p]["ms_static"],
               "ms_online": times[small_p]["ms_online"],
               "bound_ms": bound_p2["bound_ms"],
               "bound_by": bound_p2["bound_by"],
               "bound_share": bound_p2["bound_ms"] / times[small_p]["ms"]},
    }]
    for prec in ("default", "highest"):
        row = schemes[prec][big]
        entries.append({
            "name": KERNEL_NAMES[prec],
            "route": "cuda",
            "source": "abcsmc_tpu_torch/csrc/mixture_logsumexp.cu",
            "replaces": "abcsmc_tpu/ops/pallas_kernels.py:48",
            "precision": prec,
            "launches": main_path[prec],
            "max_abs_err": max(v for k, v in errs.items() if prec in k),
            "ms": row["ms"],
            "device_ms": row["device_ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "bound_share": row["bound_share"],
            "library_ms": None,
            "shape": [n, m, p],
            "bound_terms_ms": row["bound_terms_ms"],
            "max_abs_err_f64_sampled": row["max_abs_err_f64_sampled"],
            "by_shape": drop_issue_floor(schemes[prec]),
        })
    entries.append({
        "name": "sir_loop_kernel",
        "route": "cuda",
        "source": "abcsmc_tpu_torch/csrc/sir_loop.cu",
        "replaces": None,
        "precision": "float32",
        "launches": LOOP_LAUNCHES.get("sir_loop", 0),
        "max_abs_err": sir_kernel["max_abs_err"],
        "ms": sir_kernel["ms"],
        "plain_ms": sir_kernel["plain_ms"],
        "bound_ms": sir_kernel["bound_ms"],
        "bound_by": sir_kernel["bound_by"],
        "bound_share": sir_kernel["bound_ms"] / sir_kernel["ms"],
        "library_ms": None,
        "shape": sir_kernel["shape"],
        "bound_terms_ms": sir_kernel["bound_terms_ms"],
    })
    entries.append({
        "name": "ricker_loop_kernel",
        "route": "cuda",
        "source": "abcsmc_tpu_torch/csrc/ricker_loop.cu",
        "replaces": None,
        "precision": "float32",
        "launches": LOOP_LAUNCHES.get("ricker_loop", 0),
        "max_abs_err": ricker_kernel["max_abs_err"],
        "ms": ricker_kernel["ms"],
        "plain_ms": ricker_kernel["plain_ms"],
        "bound_ms": ricker_kernel["bound_ms"],
        "bound_by": ricker_kernel["bound_by"],
        "bound_share": ricker_kernel["bound_ms"] / ricker_kernel["ms"],
        "library_ms": None,
        "shape": ricker_kernel["shape"],
        "bound_terms_ms": ricker_kernel["bound_terms_ms"],
    })
    for e in entries:
        check(e["launches"] > 0 or only,
              f"{e['name']}: no main-path launch in this run")
    emit({"kernels": entries})
    emit({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
