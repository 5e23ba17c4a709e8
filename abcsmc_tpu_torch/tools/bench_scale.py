"""Scale-decade generation benchmark: one steady SMC generation at any
(N, keep), with the large-N knobs exposed (port of tools/bench_scale.py).

    python -m abcsmc_tpu_torch.tools.bench_scale --n 50000000
        [--keep 500000] [--row-block B] [--max-comp C] [--sim] [--reps 3]
        [--precision high]

The population (6 parameters uniform on [0, 1], 13 metrics = params @ mix
+ 0.3 N(0, 1)) is made on the device, block by block, from the harness's
generator, so that host memory never bounds the shape. ``--row-block 0``
forces the resident row passes, a positive value chunked passes of that
block, and omitting it leaves the step's auto rule (from bytes per row and
the card's memory). ``--max-comp`` caps the PLS components. ``--sim`` adds
a line with the linear-Gaussian simulator inside the step.
``--precision`` is passed as ``weight_precision``: the weight kernel's dot
scheme ("high" 3xTF32, "default" one BF16 pass, "highest" FP32 FMAs).
The JAX tool's ``--phases`` (rank, free, propose) is the step's own
``propose_split`` rule here.

One JSON line per measurement: seconds per step (CUDA events, mean over
``--reps`` steps after a warm-up), particles/s, ``ncomp_used`` and the peak
device bytes of the measurement (``torch.cuda.max_memory_allocated``).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from abcsmc_tpu_torch.tools import _common

NPAR, NMET = 6, 13


def main(argv=None) -> int:
    ap = _common.parser(__doc__, dtype=True)
    ap.add_argument("--n", type=int, required=True)
    ap.add_argument("--keep", type=int, default=500_000)
    ap.add_argument("--row-block", type=int, default=None)
    ap.add_argument("--max-comp", type=int, default=None)
    ap.add_argument("--sim", action="store_true")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--precision", default="high")
    args = ap.parse_args(argv)
    st = _common.start("bench_scale", args)
    if st is None:
        return 2
    from abcsmc_tpu_torch.models.simulators import (
        make_linear_gaussian_simulator,
    )

    n, keep = args.n, args.keep
    mix = np.random.default_rng(args.seed).normal(size=(NPAR, NMET))
    params, mets = _common.population(n, mix, st.generator, st.dtype)
    seeds = (torch.randint(0, 2**31 - 1, (n,), generator=st.generator,
                           device=st.device) if args.sim else None)
    state = _common.previous_state(keep, NPAR, st.generator, st.dtype)
    gen = _common.generation(
        _common.unit_box_config(n, keep, [0.0] * NMET, npar=NPAR),
        make_linear_gaussian_simulator(NPAR, NMET, mix=mix), [st.device],
        st.dtype,
        weight_precision=args.precision, row_block=args.row_block,
        max_pls_components=args.max_comp)
    tag = (f"N={n} keep={keep} precision={args.precision}"
           f" row_block={args.row_block} max_comp={args.max_comp}"
           f" 1 {st.device.type} device(s)")
    g = st.generator
    runs = [("sim excluded", lambda: gen.step_precomputed(
        params, mets, keep, n, gen.draw_step(g, n), state))]
    if args.sim:
        runs.append(("sim included", lambda: gen.step(
            params, seeds, keep, n, gen.draw_step(g, n), state)))
    for what, fn in runs:
        if st.on_card:
            torch.cuda.reset_peak_memory_stats(st.device)
        ncomp = int(fn().ncomp_used)
        ms = st.ms(fn, args.reps)
        st.emit({
            "metric": f"SMC generation steady state ({what}), {tag}",
            "value": None if ms is None else ms / 1e3, "unit": "s",
            "ms": ms, "n": n, "keep": keep,
            "row_block": gen.row_block_for(n),
            "particles_per_sec": None if ms is None else n / (ms * 1e-3),
            "ncomp_used": ncomp,
            "peak_bytes": (torch.cuda.max_memory_allocated(st.device)
                           if st.on_card else None)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
