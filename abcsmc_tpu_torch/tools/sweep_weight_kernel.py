"""Tuning sweep of the weight kernel: accuracy of each mode and dot scheme
against float64, and the time of each center split the launch plan could
choose (port of tools/sweep_weight_kernel.py).

    python -m abcsmc_tpu_torch.tools.sweep_weight_kernel
        [--k-accuracy 50000] [--k-sweep 200000] [--reps 3]

The TPU tool swept Pallas block sizes (``block_i`` x ``block_j``) and the
three dot precisions. Here the tiles are compile-time constants of
``csrc/mixture_logsumexp.cu``; what a call can still choose is the dot
scheme (``precision``: "highest" FP32 FMAs, "high" 3xTF32, "default" one
BF16 pass, each its own program) and how many splits the center axis is
cut into (``n_split`` of ``ops.kernels.mixture_logsumexp``). So, one JSON
line each, for each scheme:

1. at ``--k-accuracy``^2 x 6, the max abs error of each mode against the
   float64 plain version on every query row (held to 2e-4 nats; "default"
   rounds its operands to bfloat16 and is held instead to 2e-4 of its own
   plain version, ``max_abs_err_own``, its float64 error reported);
2. at ``--k-sweep``^2 x 6, for each mode, CUDA-event ms at the plan's own
   split, at 1, 2, 4, ... splits and at one split per 64-center stage,
   each with its error against float64 (and, for "default", against its
   own plain version) on ``--sample-rows`` rows. A split longer than the
   plan's cap (2,048 stages, 131,072 centers) may leave 2e-4 nats: it is
   reported (``within_cap`` false), not refused; the splits within the
   cap are held to 2e-4.
"""

from __future__ import annotations

import math
import sys

import torch

from abcsmc_tpu_torch.bench_kernel import (
    sampled_error_f64, sampled_error_own,
)
from abcsmc_tpu_torch.ops import kernels
from abcsmc_tpu_torch.ops.weights import _prep_scaled
from abcsmc_tpu_torch.tools import _common

P = 6


def inputs(k: int, st: _common.Study):
    """The JAX tool's inputs at k x k x P (float32): centers uniform on
    [0.3, 0.7]^P as their own queries, equal weights, dv 0.02."""
    dev = st.device
    prev = 0.3 + 0.4 * torch.rand((k, P), generator=st.generator, device=dev)
    a, b, _ = _prep_scaled(prev, prev, torch.full((P,), 0.02, device=dev))
    return a.contiguous(), b.contiguous(), torch.full(
        (k,), -math.log(k), device=dev)


def split_points(m: int) -> list:
    """None (the plan's own), then 1, 2, 4, ... below the stage count,
    then the stage count (one 64-center stage a split)."""
    n_stages = -(-m // kernels._STAGE_CENTERS)
    pts = [None]
    s = 1
    while s < n_stages:
        pts.append(s)
        s *= 2
    return pts + [n_stages]


def errors(a, b, lw, got, rows, mode, prec, on_card):
    """(error against float64, error against the scheme's own plain
    version or None, the one held to 2e-4): "default" on the card is held
    to its own plain version, the rest to float64 (a CPU call runs the
    plain version whatever the scheme)."""
    f64 = sampled_error_f64(a, b, lw, got, rows, mode=mode)
    if prec != "default" or not on_card:
        return f64, None, f64
    own = sampled_error_own(a, b, lw, got, rows, mode=mode, precision=prec)
    return f64, own, own


def main(argv=None) -> int:
    ap = _common.parser(__doc__)
    ap.add_argument("--k-accuracy", type=int, default=50_000)
    ap.add_argument("--k-sweep", type=int, default=200_000)
    ap.add_argument("--modes", nargs="+", default=["static", "online"],
                    choices=kernels.MODES)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--sample-rows", type=int, default=4096)
    args = ap.parse_args(argv)
    st = _common.start("sweep_weight_kernel", args)
    if st is None:
        return 2

    k = args.k_accuracy
    a, b, lw = inputs(k, st)
    for prec in kernels.PRECISIONS:
        for mode in args.modes:
            got = kernels.mixture_logsumexp(a, b, lw, mode=mode,
                                            precision=prec)
            f64, own, held = errors(a, b, lw, got, k, mode, prec,
                                    st.on_card)
            st.emit({"metric": f"{mode}/{prec} max |dlog| vs float64 plain, "
                               f"{_common.label(k)}^2",
                     "value": f64, "unit": "nats", "shape": [k, k, P],
                     "precision": prec, "max_abs_err_own": own})
            _common.check(held <= _common.TOL,
                          f"{mode}/{prec} at {k}^2 x {P}: {held} nats")
    del a, b, lw

    k = args.k_sweep
    a, b, lw = inputs(k, st)
    sms = (torch.cuda.get_device_properties(st.device).multi_processor_count
           if st.on_card else None)
    for prec in kernels.PRECISIONS:
        for mode in args.modes:
            online = mode != "static"
            for ask in split_points(k):
                fn = lambda: kernels.mixture_logsumexp(  # noqa: E731
                    a, b, lw, mode=mode, precision=prec, n_split=ask)
                ms = st.ms(fn, args.reps)
                f64, own, held = errors(a, b, lw, fn(), args.sample_rows,
                                        mode, prec, st.on_card)
                plan = (kernels.launch_plan(k, k, P, sms or 1, online,
                                            n_split=ask, precision=prec)
                        if sms or ask else None)
                within = (plan.stages_per_split <= kernels._MAX_SPLIT_STAGES
                          if plan else None)
                st.emit({
                    "metric": f"{_common.label(k)}^2 {mode}/{prec} "
                              f"n_split={'plan' if ask is None else ask}",
                    "value": ms, "unit": "ms", "shape": [k, k, P],
                    "mode": mode, "precision": prec, "n_split_asked": ask,
                    "n_split": plan.n_split if plan else None,
                    "centers_per_split": (plan.stages_per_split
                                          * kernels._STAGE_CENTERS
                                          if plan else None),
                    "within_cap": within,
                    "max_abs_err_f64_sampled": f64,
                    "max_abs_err_own_sampled": own})
                if within is not False:
                    _common.check(held <= _common.TOL,
                                  f"{mode}/{prec} n_split={ask} at {k}^2 x "
                                  f"{P}: {held} nats")
                if st.on_card:
                    torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
