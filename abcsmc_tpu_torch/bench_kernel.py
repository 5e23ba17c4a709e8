"""Time the weight kernel on the card, beside its plain version, the weight
stage around it and, optionally, an earlier build of the kernel.

    python -m abcsmc_tpu_torch.bench_kernel [--baseline OLD.cu [--turns K]]
        [--shapes 50000x50000x6,...] [--reps N] [--profile]
        [--host-parts] [--out F]

For each shape (by default the shipped survivor keeps 205^2 x 2 (sir,
lv), 410^2 x 3 (ricker), 2,048^2 x 16 (dengue_surrogate), 10,000 x 5,000
x 6 and 10,000^2 x 6 (``tools.validate``, ``bench_extra``); 50,000^2 x 6,
the 1M cell's keep; 52,429^2 x 2, sir_1m's keep; and 200,000 x 50,000 x
13), each dot scheme ("highest", "high", "default") and each mode it
prints one JSON line with three times per call: ``ms``, CUDA events
around ``--reps`` back-to-back eager calls after a warm-up (at small
shapes the host's enqueue pace sets it); ``device_ms``, the same calls
captured once into a CUDA graph and replayed, events around the replays
(the kernels' own time, without the Python wrapper; :func:`graph_ms`);
``host_us``, the host clock around ``--reps`` enqueues with no sync
(:func:`host_us`). Beside them: the max abs difference from the scheme's
plain version, the kernels one call launched as the C entry counts them
(``launches_per_call``; the plan's count as ``plan_launches_per_call``),
the scheme's bound (:func:`kernel_bound_ms`)
with the issue-slot floor beside it (``issue_model_ms``, a model term,
not part of the bound and not a measured time), and the weight stage
(``weights.weight_predictive_prior`` with a flat prior: scaling, kernel at
the host brain's "highest", normalisation). ``--baseline`` takes an
earlier source of ``csrc/mixture_logsumexp.cu``, builds it with the same
nvcc flags and times it in turns with the current kernel (old, new, new,
old, for each of the three times; ``--turns K`` rounds of that, with the
median, least and largest of each time as ``<time>_spread``, and
``<time>_wins``, the adjacent old and new readings in which the new one
is lower) and prints the max abs difference
between its output and the tree's on the same inputs
(``baseline_max_abs_diff``, 0 where both run one plan and one
arithmetic), through the wrapper of the ``kernels.py`` that lies beside it (the
same commit's ``ops/kernels.py``: its launch plan, its C interface, its
auto; :func:`baseline_kernels`), or through the tree's own wrapper where
none does (an edited copy of the current source), every scheme that
wrapper has ("high" alone before the schemes). ``--profile`` adds each
kernel's device microseconds a launch from a torch.profiler trace
(``kernel_us``: prologue, static and online passes). ``--host-parts``
adds, per shape, the host microseconds of each piece of the wrapper's
enqueue path beside the earlier wrapper's (:func:`host_parts_us`). Needs
a CUDA device; exits 2 without one.
"""

from __future__ import annotations

import argparse
import functools
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from abcsmc_tpu_torch.ops import _build, kernels, weights

SHAPES = ((205, 205, 2), (410, 410, 3), (2048, 2048, 16),
          (10_000, 5_000, 6), (10_000, 10_000, 6), (50_000, 50_000, 6),
          (52_429, 52_429, 2), (200_000, 50_000, 13))
MODES = ("auto", "static", "online")
# Dense peaks of one H100 SXM per SM and clock: the special-function unit
# issues 16 ex2 (CUDA C++ Programming Guide, arithmetic instruction
# throughput, compute capability 9.0), the FP32 pipe 128 FFMA, the tensor
# cores 1,024 TF32 and 2,048 BF16 FMAs in mma (NVIDIA H100 data sheet: 495
# and 989 dense TFLOP/s over 132 SMs at 1.83 GHz); HBM 3.35 TB/s. Each of
# the SM's four schedulers issues one warp-instruction a clock: 128
# thread-instructions per SM and clock.
SFU_PER_SM_CLOCK = 16
FFMA_PER_SM_CLOCK = 128
TF32_FMA_PER_SM_CLOCK = 1024
BF16_FMA_PER_SM_CLOCK = 2048
ISSUE_PER_SM_CLOCK = 128
HBM_BYTES = 3.35e12


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call: CUDA events around ``reps`` calls after
    one warm-up call."""
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


def graph_ms(fn, reps: int, replays: int = 5) -> float:
    """Mean device milliseconds per call: ``reps`` calls captured once into
    a CUDA graph (after a warm-up call on the capture's side stream), the
    graph replayed once to warm it, then CUDA events around ``replays``
    replays. Without the Python wrapper's host time between launches, this
    is what the kernels themselves take, launch gaps inside the graph
    included."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(replays):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    del graph
    return t0.elapsed_time(t1) / (replays * reps)


def host_us(fn, reps: int) -> float:
    """Mean host microseconds to enqueue one call: ``time.perf_counter``
    around ``reps`` calls with no sync (after a warm-up call and a sync;
    the card's queue is not full at these counts), then a sync outside
    the clock."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt * 1e6 / reps


def kernel_us(fn, calls: int = 10) -> dict:
    """Device microseconds a launch of each kernel of ``fn``'s call, and
    its launches a call, from a torch.profiler trace of the card around
    ``calls`` calls (after one untimed session that starts the tracer):
    {kernel: [launches a call, us a launch]}, keyed "prologue", "static"
    and "online" (the partial kernel's pass)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):
        fn()
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if "prologue_kernel" in ev.key:
            name = "prologue"
        elif "partial_kernel" in ev.key:
            # the template's ONLINE argument: <SCHEME, KS, ONLINE> for the
            # mma kernel, <KS, ONLINE> for the FFMA kernel
            args = ev.key.split("partial_kernel<")[1].split(">")[0]
            online = args.split(",")[2 if "mixture" in ev.key else 1]
            name = "online" if "true" in online else "static"
        else:
            continue
        total = getattr(ev, "device_time_total", None)
        if total is None:
            total = ev.cuda_time_total
        n_prev, t_prev = out.get(name, (0, 0.0))
        out[name] = (n_prev + ev.count, t_prev + total)
    return {k: [n / calls, t / n] for k, (n, t) in out.items()}


def three_times(fn, reps: int) -> dict:
    """``ms``, ``device_ms`` and ``host_us`` of one call (see the module
    docstring)."""
    return {"ms": cuda_ms(fn, reps), "device_ms": graph_ms(fn, reps),
            "host_us": host_us(fn, reps)}


def spread(xs) -> dict:
    """Median, least and largest of a list of readings."""
    return {"median": float(np.median(xs)), "min": min(xs), "max": max(xs)}


def measured_launches(fn) -> int:
    """Kernels one call of ``fn`` launched, the prologue counted, as the
    C entry counts them (``kernels.kernel_launches`` around the call)."""
    before = kernels.kernel_launches()
    fn()
    return kernels.kernel_launches() - before


def host_parts_us(a, b, lw, old, reps: int = 2000, rounds: int = 5) -> dict:
    """Host microseconds a call of each piece of the wrapper's enqueue
    path in the tree (``new``) and in ``old``'s wrapper (an earlier
    ``kernels.py``, :func:`baseline_kernels`; ``old`` None: the tree's own
    pieces only), at one auto "highest" call's shape, the median of
    ``rounds`` rounds of ``reps`` calls: the input check; the plan and the
    C entry's arguments; the output and workspace allocations; the
    current stream's handle; the current-device test or switch."""
    n, p = a.shape
    m, dev, idx = b.shape[0], a.device, a.device.index
    call = kernels._call_of(n, m, p, idx, "auto", "highest", None)
    sms = kernels._sm_count(idx)

    def old_plan():   # the earlier wrapper's plan and argument lines
        plan = kernels.launch_plan(n, m, p, sms, True, precision="highest")
        offs = tuple(4 * o for o in plan.offsets)
        return offs, (n, m, p, plan.ks, plan.stage_floats // 4,
                      plan.n_stages, plan.stages_per_split, plan.n_split,
                      plan.prologue_blocks, 2, 2)

    def switch():
        with torch.cuda.device(dev):
            pass

    f32 = dict(dtype=torch.float32, device=dev)
    ws = call.floats - n
    pieces = {
        "check": {"new": lambda: kernels._check_cuda_inputs(a, b, lw)},
        "plan_and_ints": {
            "new": lambda: kernels._call_of(n, m, p, idx, "auto", "highest",
                                            None),
            "old": old_plan},
        "alloc": {"new": lambda: torch.empty((call.floats,), **f32),
                  "old": lambda: (torch.empty((max(ws, 1),), **f32),
                                  torch.empty((n,), **f32))},
        "stream": {
            "new": lambda: torch._C._cuda_getCurrentRawStream(idx),
            "old": lambda: torch.cuda.current_stream(dev).cuda_stream},
        "device": {"new": lambda: torch.cuda.current_device() == idx,
                   "private": lambda: torch._C._cuda_getDevice() == idx,
                   "old": switch},
    }
    if old is not None:
        pieces["check"]["old"] = lambda: old._check_cuda_inputs(a, b, lw)
    out = {}
    for name, alts in pieces.items():
        res = {k: [] for k in alts}
        for _ in range(rounds):
            for k, fn in alts.items():
                fn()
                t0 = time.perf_counter()
                for _ in range(reps):
                    fn()
                res[k].append((time.perf_counter() - t0) * 1e6 / reps)
        out[name] = {k: float(np.median(v)) for k, v in res.items()}
    return out


def dot_fmas(p: int, precision: str) -> tuple:
    """(term name, FMAs per logit, FMAs per logit as issued, per-SM
    per-clock rate) of the scheme's dot over K = p + 2: 3K TF32 FMAs for
    "high" (hi.hi, hi.lo and lo.hi), K BF16 FMAs for "default" (one
    pass), K FFMAs for "highest". The count as issued pads K to the mma's
    k-step (8 for m16n8k8, 16 for m16n8k16); the padding is zeros the
    function does not need, so only the unpadded count enters the
    bound."""
    k = p + 2
    if precision == "high":
        return "tf32_mma", 3 * k, 3 * 8 * -(-k // 8), TF32_FMA_PER_SM_CLOCK
    if precision == "default":
        return "bf16_mma", k, 16 * -(-k // 16), BF16_FMA_PER_SM_CLOCK
    if precision == "highest":
        return "ffma", k, k, FFMA_PER_SM_CLOCK
    raise ValueError(f"unknown precision {precision!r}")


def issue_per_logit(p: int, precision: str) -> float:
    """Thread-instructions a logit issues at the least: its ex2, the FADD
    that adds it to its row sum, and the dot: K = p + 2 FP32 operations
    for "highest", or the scheme's mma instructions over padded K, each a
    warp's (32 threads') issue for a 16 x 8 tile of 128 logits: 3 per
    k-step of 8 for "high", 1 per k-step of 16 for "default". For
    "highest" that is (K + 2) / 128 SM-clocks a logit."""
    k = p + 2
    if precision == "highest":
        dot = k
    elif precision == "high":
        dot = 3 * -(-k // 8) * 32 / 128
    elif precision == "default":
        dot = -(-k // 16) * 32 / 128
    else:
        raise ValueError(f"unknown precision {precision!r}")
    return 2 + dot


def kernel_bound_ms(n, m, p, precision="high", *, device=0):
    """The least time the card could take for one call at n x m x p in the
    scheme ``precision``: the largest of its operations over their peak
    rate, each pipe apart (one ex2 per logit on the special-function
    units; the scheme's dot over K = p + 2, :func:`dot_fmas`), and its
    bytes (each input read once, the output written once) over the HBM
    rate. Every operation term is taken at the one clock ``nvidia-smi``
    reports as the card's maximum SM clock, from the per-SM per-clock
    rates above; every term is returned in ``terms_ms``, with the dot as
    the kernel issues it over padded K (``<dot>_padded_k``), which is
    printed beside the bound and not part of it. ``issue_model_ms`` is the
    issue-slot floor (:func:`issue_per_logit` over ``ISSUE_PER_SM_CLOCK``),
    a model term beside the bound: neither part of it nor a measured
    time."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.split()[0])
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    per_ms = sms * mhz * 1e3          # per-SM-clock operations in one ms
    dot, fmas, issued, rate = dot_fmas(p, precision)
    terms = {
        "ex2": n * m / (SFU_PER_SM_CLOCK * per_ms),
        dot: fmas * n * m / (rate * per_ms),
        "bytes": 1e3 * 4 * (n * p + m * p + m + n) / HBM_BYTES,
    }
    worst = max(terms, key=terms.get)
    terms[f"{dot}_padded_k"] = issued * n * m / (rate * per_ms)
    return {"bound_ms": terms[worst], "terms_ms": terms,
            "issue_model_ms": (issue_per_logit(p, precision) * n * m
                               / (ISSUE_PER_SM_CLOCK * per_ms)),
            "bound_by": "bytes" if worst == "bytes" else "operations",
            "precision": precision, "sm_clock_mhz": mhz, "sms": sms}


def sampled_error_f64(a, b, log_w, got, rows: int, mode: str = "auto"):
    """Max abs difference of ``got`` (the kernel's [n] output for a, b,
    log_w) from the float64 plain version on ``rows`` evenly spaced query
    rows (the plain version is a function of each query row by itself)."""
    pick = _pick(a, rows)
    ref = kernels.mixture_logsumexp_reference(
        a[pick].double(), b.double(), log_w.double(), mode=mode)
    return float((got[pick].double() - ref).abs().max())


def sampled_error_own(a, b, log_w, got, rows: int, mode: str = "auto",
                      precision: str = "default"):
    """Max abs difference of ``got`` from the scheme's own plain version
    (``mixture_logsumexp_reference(precision=...)``, float32, as the
    kernel's operands are rounded) on ``rows`` evenly spaced query rows."""
    pick = _pick(a, rows)
    ref = kernels.mixture_logsumexp_reference(
        a[pick].contiguous(), b, log_w, mode=mode, precision=precision)
    return float((got[pick] - ref).abs().max())


def _pick(a, rows):
    return torch.linspace(0, a.shape[0] - 1, min(rows, a.shape[0]),
                          device=a.device).long().unique()


def weight_inputs(n, m, p, seed, dev):
    """Unscaled (params, prev, w, dv) as the weight stage gets them."""
    rng = np.random.default_rng(seed)
    f32 = dict(dtype=torch.float32, device=dev)
    params = torch.as_tensor(rng.uniform(0, 1, (n, p)), **f32)
    prev = torch.as_tensor(rng.uniform(0.2, 0.8, (m, p)), **f32)
    w = rng.uniform(0.5, 1.5, m)
    dv = torch.as_tensor(rng.uniform(0.01, 0.1, p), **f32)
    return params, prev, torch.as_tensor(w / w.sum(), **f32), dv


def baseline_kernels(src):
    """An earlier build of the kernel, to time in turns with the current
    one: the module ``kernels.py`` beside ``src`` (an earlier
    ``csrc/mixture_logsumexp.cu``; both from one commit, ``git show``), or
    the tree's own ``ops/kernels.py`` where there is none, loaded apart
    from the package's, its C entry bound to the library built from
    ``src``. Its wrapper runs as that commit shipped it."""
    src = Path(src)
    path = src.with_name("kernels.py")
    if not path.exists():
        path = Path(kernels.__file__)
    spec = importlib.util.spec_from_file_location("baseline_kernels", path)
    old = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(old)
    bind = old._library   # loads "mixture_logsumexp" through _build

    @functools.lru_cache(maxsize=None)
    def library():
        real = _build.load_library
        _build.load_library = lambda name: real(f"baseline_{name}", src)
        try:
            return bind()
        finally:
            _build.load_library = real

    old._library = library
    return old


def parse_shapes(text: str) -> tuple:
    """"50000x50000x6,2048x2048x16" -> ((50000, 50000, 6), (2048, 2048,
    16))."""
    return tuple(tuple(int(x) for x in part.split("x"))
                 for part in text.split(",") if part)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", help="source of an earlier kernel build")
    ap.add_argument("--shapes", type=parse_shapes, default=SHAPES,
                    help="n x m x p shapes, comma-separated "
                         "(default: %(default)s)")
    ap.add_argument("--out", help="also write the JSON lines to this file")
    ap.add_argument("--reps", type=int, default=0,
                    help="calls per timing (default 100 small, 10 large)")
    ap.add_argument("--profile", action="store_true",
                    help="add each kernel's device us a launch "
                         "(torch.profiler; kernel_us)")
    ap.add_argument("--turns", type=int, default=1,
                    help="with --baseline: rounds of old, new, new, old "
                         "(default 1); medians and spreads beside them")
    ap.add_argument("--host-parts", action="store_true",
                    help="add the host us of each piece of the wrapper's "
                         "enqueue path (auto, highest; host_parts_us)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_kernel: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    lines = [{"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}]
    old = baseline_kernels(args.baseline) if args.baseline else None
    # a wrapper from before the schemes runs "high" and takes no precision
    old_schemes = getattr(old, "PRECISIONS", ("high",)) if old else ()
    for n, m, p in args.shapes:
        params, prev, w, dv = weight_inputs(n, m, p, n + p, dev)
        a, b, _ = weights._prep_scaled(params, prev, dv)
        a, b = a.contiguous(), b.contiguous()
        lw = torch.log(w)
        reps = args.reps or (100 if n < 10_000 else 10)
        for mode, prec in ((x, y) for y in kernels.PRECISIONS
                           for x in MODES):
            row = {"shape": [n, m, p], "mode": mode, "precision": prec}
            ref = kernels.mixture_logsumexp_reference(a, b, lw, mode=mode,
                                                      precision=prec)
            new = lambda: kernels.mixture_logsumexp(  # noqa: E731
                a, b, lw, mode=mode, precision=prec)
            row["max_abs_err"] = float((new() - ref).abs().max())
            row.update(kernel_bound_ms(n, m, p, prec))
            row["launches_per_call"] = measured_launches(new)
            row["plan_launches_per_call"] = kernels.launches_per_call(
                n, m, p, mode, precision=prec)
            if prec in old_schemes:
                kw = {"precision": prec} if hasattr(old, "PRECISIONS") else {}
                prv = lambda: old.mixture_logsumexp(  # noqa: E731
                    a, b, lw, mode=mode, **kw)
                got_old = prv()
                row["baseline_max_abs_err"] = float(
                    (got_old - ref).abs().max())
                row["baseline_max_abs_diff"] = float(
                    (got_old - new()).abs().max())
                t = [three_times(f, reps)
                     for f in (prv, new, new, prv) * args.turns]
                for key in ("ms", "device_ms", "host_us"):
                    row["baseline_" + key] = [x[key] for x in t[0::4]
                                              + t[3::4]]
                    row[key] = [x[key] for x in t[1::4] + t[2::4]]
                    if args.turns > 1:
                        row["baseline_" + key + "_spread"] = spread(
                            row["baseline_" + key])
                        row[key + "_spread"] = spread(row[key])
                        # adjacent (old, new) readings in which new is lower
                        row[key + "_wins"] = sum(
                            x > y for x, y in zip(row["baseline_" + key],
                                                  row[key]))
            else:
                t = three_times(new, reps)
                for key in ("ms", "device_ms", "host_us"):
                    row[key] = [t[key]]
            if args.profile:
                row["kernel_us"] = kernel_us(new)
                if prec in old_schemes:
                    row["baseline_kernel_us"] = kernel_us(prv)
            row["plain_ms"] = cuda_ms(
                lambda: kernels.mixture_logsumexp_reference(
                    a, b, lw, mode=mode, precision=prec), reps)
            lines.append(row)
            print(json.dumps(row), flush=True)
        if args.host_parts:
            parts = {"shape": [n, m, p], "host_parts_us": host_parts_us(
                a, b, lw, old if "highest" in old_schemes else None)}
            lines.append(parts)
            print(json.dumps(parts), flush=True)
        flat = lambda th: torch.zeros(th.shape[0], device=dev)  # noqa: E731
        # the host brain's weight stage: its kernel runs "highest"
        stage = {"shape": [n, m, p], "weight_stage_ms": cuda_ms(
            lambda: weights.weight_predictive_prior(params, prev, w, dv,
                                                    flat), reps)}
        lines.append(stage)
        print(json.dumps(stage), flush=True)
        del params, prev, w, dv, a, b, lw
    print(json.dumps(lines[0]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(x) + "\n" for x in lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
