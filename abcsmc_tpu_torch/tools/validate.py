"""On-card validation of the weight kernel and the generation step (port
of tools/tpu_validate.py).

    python -m abcsmc_tpu_torch.tools.validate [--shapes 10000x5000x6,...]
        [--n 1000000 --keep 50000 --row-block 131072] [--reps 3]

Three parts, at the JAX tool's sizes and on its data (one
``np.random.default_rng(0)`` drawn in its order; the step's data come
from ``bench.make_data`` on that generator, which rounds the metrics to
float32 once where the JAX tool rounds the noise first, so they may be a
float32 ulp apart):

1. ``mixture_logsumexp`` against its plain PyTorch version
   (``mixture_logsumexp_reference``) at (10,000, 5,000, 6), (50,000,
   50,000, 6), (200,000, 50,000, 13) and (1,000,000, 50,000, 6), float32,
   inputs scaled by ``ops/weights.py::_prep_scaled`` as the weight stage
   scales them: max abs error (held to 2e-4 nats) and max error relative
   to max(|value|, 1) (held under 1e-3, the JAX tool's bound), the kernel's
   and the plain version's ms, and the kernel's share of its bound
   (``bench_kernel.kernel_bound_ms``);
2. one generation step at 1,000,000 x 6 x 13, keep 50,000, float32,
   simulator excluded, on rank-6-structured metrics: ms, finite weights
   and ``ncomp_used > 1`` (a degenerate selection raises);
3. the same step with chunked row passes (``row_block`` 2^17) on the same
   draws: the same ``ncomp_used`` and a survivor overlap above 0.999.

One JSON line per measurement; the first names the card. The JAX tool
appends to docs/TPU_VALIDATION.md; this one writes no file but ``--out``.
Without CUDA and without ``--device cpu`` it exits 2; on the CPU the times
are null.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from abcsmc_tpu_torch.tools import _common

SHAPES = ((10_000, 5_000, 6), (50_000, 50_000, 6), (200_000, 50_000, 13),
          (1_000_000, 50_000, 6))
N, KEEP, NPAR, NMET = 1_000_000, 50_000, 6, 13
ROW_BLOCK = 1 << 17
REL_TOL = 1e-3      # tools/tpu_validate.py's pallas-vs-xla bound


def parse_shape(text: str) -> tuple[int, int, int]:
    n, m, p = (int(x) for x in text.lower().split("x"))
    return n, m, p


def kernel_line(st: _common.Study, rng, n: int, m: int, p: int, reps: int):
    """The kernel against plain at n x m x p on the JAX tool's data."""
    from abcsmc_tpu_torch.bench_kernel import kernel_bound_ms
    from abcsmc_tpu_torch.ops.kernels import (
        mixture_logsumexp, mixture_logsumexp_reference,
    )
    from abcsmc_tpu_torch.ops.weights import _prep_scaled

    f32 = dict(dtype=torch.float32, device=st.device)
    params = torch.as_tensor(rng.uniform(0, 1, (n, p)), **f32)
    prev = torch.as_tensor(rng.uniform(0.3, 0.7, (m, p)), **f32)
    w = rng.uniform(0.5, 1.5, m).astype(np.float32)
    w /= w.sum()
    lw = torch.as_tensor(np.log(w), **f32)
    dv = torch.as_tensor(rng.uniform(0.01, 0.05, p), **f32)
    a, b, log_norm = _prep_scaled(params, prev, dv)
    a, b = a.contiguous(), b.contiguous()
    del params, prev
    got = mixture_logsumexp(a, b, lw, precision="high") + log_norm
    want = mixture_logsumexp_reference(a, b, lw) + log_norm
    diff = (got - want).abs()
    abs_err = float(diff.max())
    rel_err = float((diff / want.abs().clamp_min(1.0)).max())
    del got, want, diff
    _common.check(abs_err <= _common.TOL,
                  f"kernel at {n}x{m}x{p}: max abs err {abs_err}")
    _common.check(rel_err < REL_TOL,
                  f"kernel at {n}x{m}x{p}: max rel err {rel_err}")
    ms = st.ms(lambda: mixture_logsumexp(a, b, lw, precision="high"), reps)
    plain_ms = st.ms(lambda: mixture_logsumexp_reference(a, b, lw), reps)
    row = {"metric": f"mixture_logsumexp {n}x{m}x{p}", "shape": [n, m, p],
           "max_abs_err": abs_err, "max_rel_err": rel_err, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": None, "bound_by": None,
           "bound_share": None}
    if st.on_card:
        bound = kernel_bound_ms(n, m, p, "high",
                                device=st.device.index or 0)
        row.update(bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
                   bound_share=bound["bound_ms"] / ms,
                   speedup=plain_ms / ms)
    return st.emit(row)


def step_lines(st: _common.Study, rng, n: int, keep: int, row_block: int,
               reps: int):
    """The step resident, then chunked, on the same data and draws."""
    from abcsmc_tpu_torch.bench import make_data

    # metrics correlated with params (not iid noise): component selection
    # has real structure to find, so ncomp_used > 1 is the expected witness
    params_np, mets_np, state_np = make_data(n, keep, rng)
    params = torch.from_numpy(params_np).to(st.device)
    mets = torch.from_numpy(mets_np).to(st.device)
    state = tuple(torch.from_numpy(x).to(st.device) for x in state_np)
    del params_np, mets_np
    raw = _common.unit_box_config(n, keep, [0.0] * NMET, npar=NPAR)
    out = {}
    for name, block in (("resident", None), ("chunked", row_block)):
        gen = _common.generation(raw, None, [st.device], row_block=block)
        draws = gen.draw_step(_common.step_generator(gen), n)

        def run():
            return gen.step_precomputed(params, mets, keep, n, draws, state)

        ms = st.ms(run, reps)
        res = out[name] = run()
        st.sync()
        out[name + "_ms"] = ms
    res, chk = out["resident"], out["chunked"]
    w = res.weights.cpu().numpy()
    ncomp = int(res.ncomp_used)
    _common.check(np.all(np.isfinite(w)) and w.shape == (keep,),
                  "step weights finite and [keep]")
    # a degenerate selection (or, negative, the U0 self-check) on these
    # rank-6-structured metrics is a wrong result
    _common.check(ncomp > 1, f"step ncomp_used={ncomp}: degenerate "
                  "van der Voet selection")
    st.emit({"metric": f"generation {_common.label(n)} x {NPAR} x {NMET}, "
                       f"keep {_common.label(keep)}, sim excluded, vdv",
             "ms": out["resident_ms"], "ncomp_used": ncomp,
             "weights_finite": True})
    si_res = res.survivor_idx.cpu().numpy()
    si_chk = chk.survivor_idx.cpu().numpy()
    ncomp_chk = int(chk.ncomp_used)
    overlap = len(np.intersect1d(si_res, si_chk)) / keep
    same_order = bool(np.array_equal(si_res, si_chk))
    w_diff = (float(np.max(np.abs(chk.weights.cpu().numpy() - w)))
              if same_order else None)
    _common.check(ncomp_chk == ncomp,
                  f"chunked ncomp_used {ncomp_chk} != resident {ncomp}")
    _common.check(overlap > 0.999, f"chunked survivor overlap {overlap}")
    return st.emit({
        "metric": f"chunked row passes (row_block {row_block}, "
                  f"{-(-n // row_block)} blocks at {_common.label(n)})",
        "ms": out["chunked_ms"], "ncomp_used": ncomp_chk,
        "ncomp_resident": ncomp, "survivor_overlap": overlap,
        "same_order": same_order, "max_abs_dw": w_diff})


def main(argv=None) -> int:
    ap = _common.parser(__doc__)
    ap.add_argument("--shapes", default=",".join(
        "x".join(map(str, s)) for s in SHAPES),
        help="kernel shapes NxMxP, comma-separated")
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--keep", type=int, default=KEEP)
    ap.add_argument("--row-block", type=int, default=ROW_BLOCK)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    st = _common.start("validate", args)
    if st is None:
        return 2
    rng = np.random.default_rng(0)
    for shape in args.shapes.split(","):
        kernel_line(st, rng, *parse_shape(shape), args.reps)
        if st.on_card:
            torch.cuda.empty_cache()
    step_lines(st, rng, args.n, args.keep, args.row_block, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
