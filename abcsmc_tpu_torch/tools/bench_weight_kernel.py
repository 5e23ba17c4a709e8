"""Weight-kernel scaling study: the O(K^2) mixture denominator at large K,
on the card (port of tools/bench_weight_kernel.py).

    python -m abcsmc_tpu_torch.tools.bench_weight_kernel [--k K ...]
        [--modes auto online] [--n 10000000 --keep 500000] [--skip-10m]

One JSON line per measurement:

1. truncation feasibility: in a realistic SMC state of ``--truncation-k``
   survivors (queries resampled from the mixture by weight and perturbed
   with the kernel sd sqrt(doubled variance)), the share of mixture
   components within T = 10 and 30 log-units of each query's best logit,
   and the mean best-minus-worst spread (analytically about P plus the
   log-weight spread, so block-skipping truncation prunes nothing);
2. the hand-written kernel (3xTF32, "high") at K x K x 6 for each ``--k``
   and mode: CUDA-event ms, logits/s, its bound
   (``bench_kernel.kernel_bound_ms``) and the share of it reached, the
   launch plan's split, the plain version's ms
   (auto, K up to :data:`PLAIN_MAX_K`; no single PyTorch call computes
   the function, so ``library_ms`` is null) and the max abs error against
   the float64 plain version on ``--sample-rows`` query rows (held to
   2e-4 nats at every K);
3. one ``--n`` x 6 x 13 generation with ``--keep`` survivors, the simulator
   excluded (``step_precomputed``) and included (``step``), the step's
   draws inside the timed call as in the JAX step, at ``weight_precision``
   "highest" and "high": the weight kernel's FP32 FMA and 3xTF32 programs.

The pick and the normals of the state come from the harness's generator,
not JAX's keys: the fractions agree with the JAX tool's in law, and exactly
given the same state (:func:`truncation_stats`).
"""

from __future__ import annotations

import math
import sys

import torch

from abcsmc_tpu_torch.bench_kernel import kernel_bound_ms, sampled_error_f64
from abcsmc_tpu_torch.ops import kernels
from abcsmc_tpu_torch.ops.weights import _prep_scaled
from abcsmc_tpu_torch.tools import _common

P = 6           # parameters of the kernel shapes and of the generation
NMET = 13
# the plain version is timed (auto mode) up to this K; one plain call at
# 838,860^2 x 6 takes seconds, at 1,677,721^2 tens of seconds
PLAIN_MAX_K = 500_000


def realistic_state(k: int, p: int, st: _common.Study):
    """(prev [k, p], dv [p], w [k], queries [k, p]): survivors uniform on
    [0.3, 0.7]^p, doubled variance 2 var, Dirichlet(5) weights (Gamma(5)
    as a sum of five Exp(1) draws), queries picked by weight and perturbed
    by N(0, dv)."""
    g, dev, dt = st.generator, st.device, st.dtype
    prev = 0.3 + 0.4 * torch.rand((k, p), generator=g, device=dev, dtype=dt)
    dv = 2.0 * prev.var(dim=0, unbiased=True)
    gam = torch.empty((k, 5), device=dev, dtype=dt).exponential_(
        generator=g).sum(dim=1)
    w = gam / gam.sum()
    pick = torch.multinomial(w, k, replacement=True, generator=g)
    queries = prev[pick] + dv.sqrt()[None, :] * torch.randn(
        (k, p), generator=g, device=dev, dtype=dt)
    return prev, dv, w, queries


def truncation_stats(prev, dv, w, queries, ts=(10.0, 30.0)) -> dict:
    """{T: share of (query, component) pairs whose logit lies within T of
    the query's best} and the mean best-worst spread, over the scaled
    logits -|a_i - b_j|^2 / 2 + log w_j (the formula of the JAX tool)."""
    a, b, _ = _prep_scaled(queries, prev, dv)
    d2 = ((a * a).sum(1)[:, None] + (b * b).sum(1)[None, :]
          - 2.0 * a @ b.T)
    logits = -0.5 * d2 + torch.log(w)[None, :]
    best = logits.amax(dim=1, keepdim=True)
    fracs = {t: float((logits >= best - t).to(logits.dtype).mean())
             for t in ts}
    spread = float((best - logits.amin(dim=1, keepdim=True)).mean())
    return {"fractions": fracs, "spread": spread}


def kernel_point(st: _common.Study, k: int, mode: str, reps: int,
                 rows: int) -> dict:
    """The kernel at k x k x P on the JAX tool's inputs: centers uniform on
    [0.3, 0.7]^P as their own queries, equal weights, dv 0.02; the 3xTF32
    scheme ("high", the config default)."""
    g, dev = st.generator, st.device
    prev = 0.3 + 0.4 * torch.rand((k, P), generator=g, device=dev)
    dv = torch.full((P,), 0.02, device=dev)
    a, b, _ = _prep_scaled(prev, prev, dv)
    a, b = a.contiguous(), b.contiguous()
    lw = torch.full((k,), -math.log(k), device=dev)
    before = kernels.mixture_logsumexp.launches
    ms = st.ms(lambda: kernels.mixture_logsumexp(a, b, lw, mode=mode,
                                                 precision="high"), reps)
    launches = kernels.mixture_logsumexp.launches - before
    got = kernels.mixture_logsumexp(a, b, lw, mode=mode, precision="high")
    err = sampled_error_f64(a, b, lw, got, rows, mode=mode)
    del got
    plain_ms = None
    if mode == "auto" and k <= PLAIN_MAX_K:
        plain_ms = st.ms(lambda: kernels.mixture_logsumexp_reference(
            a, b, lw, mode=mode), 1)
    row = {"metric": f"mixture-weight kernel {k}x{k}, mode={mode}",
           "value": ms, "unit": "ms", "shape": [k, k, P], "mode": mode,
           "max_abs_err_f64_sampled": err, "sampled_rows": min(rows, k),
           "launches": launches, "plain_ms": plain_ms, "library_ms": None,
           "n_split": None, "bound_ms": None, "bound_by": None,
           "bound_share": None, "logits_per_sec": None}
    if st.on_card:
        bound = kernel_bound_ms(k, k, P, "high", device=st.device)
        plan = kernels.launch_plan(k, k, P, bound["sms"], mode != "static")
        row.update(n_split=plan.n_split, bound_ms=bound["bound_ms"],
                   bound_by=bound["bound_by"],
                   bound_share=bound["bound_ms"] / ms,
                   logits_per_sec=k * k / (ms * 1e-3))
    _common.check(err <= _common.TOL,
                  f"kernel {k}x{k}x{P} {mode}: {err} nats from float64")
    return row


def generation_points(st: _common.Study, n: int, keep: int, reps: int):
    """The ``n``-particle generation with ``keep`` survivors, sim excluded
    and included, at both weight precisions."""
    from abcsmc_tpu_torch.models.simulators import (
        make_linear_gaussian_simulator, shipped_mix,
    )

    sim = make_linear_gaussian_simulator(P, NMET)
    params, mets = _common.population(n, shipped_mix(P, NMET),
                                      st.generator, st.dtype)
    seeds = torch.randint(0, 2**31 - 1, (n,), generator=st.generator,
                          device=st.device)
    state = _common.previous_state(keep, P, st.generator, st.dtype)
    raw = _common.unit_box_config(n, keep, [0.0] * NMET, npar=P)
    for prec in ("highest", "high"):
        gen = _common.generation(raw, sim, [st.device], st.dtype,
                                 weight_precision=prec)
        g = st.generator
        for what, fn in (
            ("sim excluded", lambda: gen.step_precomputed(
                params, mets, keep, n, gen.draw_step(g, n), state)),
            ("sim included", lambda: gen.step(
                params, seeds, keep, n, gen.draw_step(g, n), state)),
        ):
            res = fn()
            ncomp = int(res.ncomp_used)
            del res
            _common.check(ncomp > 1, f"generation ncomp_used {ncomp}")
            ms = st.ms(fn, reps)
            st.emit({
                "metric": f"SMC generation {_common.label(n)} particles, "
                          f"keep {_common.label(keep)} ({what}, "
                          f"weight_precision={prec}), 1 device(s)",
                "value": ms, "unit": "ms", "n": n, "keep": keep,
                "particles_per_sec": None if ms is None else n / (ms * 1e-3),
                "ncomp_used": ncomp, "weight_precision": prec})


def main(argv=None) -> int:
    ap = _common.parser(__doc__, dtype=True)
    ap.add_argument("--k", type=int, nargs="+",
                    default=[50_000, 200_000, 500_000],
                    help="kernel sizes K (K x K x 6)")
    ap.add_argument("--modes", nargs="+", default=["auto", "online"],
                    choices=kernels.MODES)
    ap.add_argument("--truncation-k", type=int, default=4096)
    ap.add_argument("--n", type=int, default=10_000_000,
                    help="particles of the generation")
    ap.add_argument("--keep", type=int, default=500_000,
                    help="survivors of the generation")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--sample-rows", type=int, default=4096,
                    help="query rows held against float64 at each K")
    ap.add_argument("--skip-10m", action="store_true",
                    help="leave out the generation (part 3)")
    args = ap.parse_args(argv)
    st = _common.start("bench_weight_kernel", args)
    if st is None:
        return 2

    k = args.truncation_k
    stats = truncation_stats(*realistic_state(k, P, st))
    for t, frac in stats["fractions"].items():
        st.emit({"metric": f"fraction of mixture within {t:g} log-units of "
                           f"each query's best logit (K={k}, realistic SMC "
                           "state)", "value": frac, "unit": "fraction"})
    st.emit({"metric": "mean (best - worst) logit spread per query "
                       "(analytic ~P + log-weight spread)",
             "value": stats["spread"], "unit": "log-units"})

    for k in args.k:
        for mode in args.modes:
            st.emit(kernel_point(st, k, mode, args.reps, args.sample_rows))
        if st.on_card:
            torch.cuda.empty_cache()

    if not args.skip_10m:
        generation_points(st, args.n, args.keep, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
