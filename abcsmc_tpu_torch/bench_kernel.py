"""Time the weight kernel on the card, beside its plain version, the weight
stage around it and, optionally, an earlier build of the kernel.

    python -m abcsmc_tpu_torch.bench_kernel [--baseline OLD.cu]
        [--shapes 50000x50000x6,...] [--out F]

For each shape (by default 2,048^2 x 16, the dengue_surrogate keep;
50,000^2 x 6, the 1M cell's keep; 52,429^2 x 2, sir_1m's keep; and
200,000 x 50,000 x 13), each dot scheme ("highest", "high", "default")
and each mode it prints one JSON line: CUDA-event milliseconds per call
(mean over ``--reps`` calls after a warm-up), the max abs difference from
the scheme's plain version, the scheme's bound (:func:`kernel_bound_ms`)
with the issue-slot floor beside it (``issue_model_ms``, a model term,
not part of the bound and not a measured time), and the weight stage
(``weights.weight_predictive_prior`` with a flat prior: scaling, kernel at
the host brain's "highest", normalisation). ``--baseline`` takes an
earlier source of ``csrc/mixture_logsumexp.cu``, builds it with the same
nvcc flags and times it in turns with the current kernel (old, new, new,
old), through the wrapper of the ``kernels.py`` that lies beside it (the
same commit's ``ops/kernels.py``: its launch plan, its C interface, its
auto; :func:`baseline_kernels`), or through the tree's own wrapper where
none does (an edited copy of the current source), every scheme that
wrapper has ("high" alone before the schemes). Needs a CUDA device; exits
2 without one.
"""

from __future__ import annotations

import argparse
import functools
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from abcsmc_tpu_torch.ops import _build, kernels, weights

SHAPES = ((2048, 2048, 16), (50_000, 50_000, 6), (52_429, 52_429, 2),
          (200_000, 50_000, 13))
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
                    help="calls per timing (default 20 small, 10 large)")
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
        reps = args.reps or (20 if n < 10_000 else 10)
        for mode, prec in ((x, y) for y in kernels.PRECISIONS
                           for x in MODES):
            row = {"shape": [n, m, p], "mode": mode, "precision": prec}
            ref = kernels.mixture_logsumexp_reference(a, b, lw, mode=mode,
                                                      precision=prec)
            new = lambda: kernels.mixture_logsumexp(  # noqa: E731
                a, b, lw, mode=mode, precision=prec)
            row["max_abs_err"] = float((new() - ref).abs().max())
            row.update(kernel_bound_ms(n, m, p, prec))
            if prec in old_schemes:
                kw = {"precision": prec} if hasattr(old, "PRECISIONS") else {}
                prv = lambda: old.mixture_logsumexp(  # noqa: E731
                    a, b, lw, mode=mode, **kw)
                row["baseline_max_abs_err"] = float((prv() - ref).abs().max())
                t = [cuda_ms(f, reps) for f in (prv, new, new, prv)]
                row["baseline_ms"] = [t[0], t[3]]
                row["ms"] = [t[1], t[2]]
            else:
                row["ms"] = [cuda_ms(new, reps)]
            row["plain_ms"] = cuda_ms(
                lambda: kernels.mixture_logsumexp_reference(
                    a, b, lw, mode=mode, precision=prec), reps)
            lines.append(row)
            print(json.dumps(row), flush=True)
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
