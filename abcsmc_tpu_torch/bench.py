"""The north-star step timed on the card (port of the JAX repo's
``bench.py``): one SMC generation over 1,000,000 particles (PLS filter,
kernel-mixture weights, weighted resample, truncated perturbation;
simulator excluded) at the dengue-class shape, 6 parameters x 13 metrics,
predictive prior 50,000 (fraction 0.05), float32.

    python -m abcsmc_tpu_torch.bench [--route eager|replay] [--shards K]
        [--device cuda|cpu] [--n N --keep K]

Prints ONE JSON line: ``metric`` (the sizes, the route's work and the
devices), ``value`` (seconds, the best of 5 after one warm-up),
``unit`` "s", ``vs_baseline`` null (the JAX bench's 1 s target is a TPU
v5e-8's; no TPU figure carries over), ``ncomp_used``, ``device`` (the
card's name and power limit as nvidia-smi gives them, or "cpu") and
``route``.

The data are the JAX bench's own, bit for bit: one
``np.random.default_rng(0)`` drawn in its order (parameters, mixing
matrix, metrics = parameters @ mix + 0.3 N(0, 1) in numpy, previous
survivors). The draws come from a ``torch.Generator`` seeded 0, one
``Generation.draw_step`` per rep, inside the timed window (the JAX step
draws inside its program). ``--route eager`` times the call as a user makes
it; ``--route replay`` captures the step once into a CUDA graph (the
counterpart of the one program ``jax.jit`` dispatches), holds the replay's
first result bit-equal to the eager step on the same draws, then times
replays on new draws. The card is synchronised around each rep; the
warm-up holds the kernel's nvcc build at first use.

A degenerate PLS selection (``ncomp_used`` <= 1 on this rank-structured
data; negative: the U0 self-check fired) raises before anything is
printed. No CUDA and no ``--device cpu``: exit 2, as for ``--route replay``
on the CPU or on a mesh over several cards. Nothing falls back.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from abcsmc_tpu_torch.tools._common import (
    card_line, generation, needs_cuda, step_generator, sync,
    unit_box_config,
)

N = 1_000_000          # particles per generation
KEEP = 50_000          # predictive prior (fraction 0.05)
NPAR = 6
NMET = 13
REPS = 5


def make_data(n: int = N, keep: int = KEEP, rng=None):
    """(params [n, 6], metrics [n, 13], previous state) as float32 numpy,
    drawn as the JAX bench draws them, from ``rng`` (default
    ``np.random.default_rng(0)``, the bench's)."""
    rng = np.random.default_rng(0) if rng is None else rng
    params = rng.uniform(0, 1, size=(n, NPAR)).astype(np.float32)
    # metrics correlated with params so PLS has structure to find
    mix = rng.normal(size=(NPAR, NMET)).astype(np.float32)
    mets = (params @ mix + 0.3 * rng.normal(size=(n, NMET))).astype(
        np.float32)
    state = (
        rng.uniform(0.3, 0.7, size=(keep, NPAR)).astype(np.float32),
        np.full((keep,), 1.0 / keep, np.float32),
        np.full((NPAR,), 0.02, np.float32),
    )
    return params, mets, state


def mesh_devices(device: torch.device, shards: int | None):
    """``shards`` shard devices (default: one per visible card, one on the
    CPU): the visible cards in turn from ``device``'s, repeated when there
    are more shards than cards (on one card: a virtual mesh); the CPU
    repeated."""
    if device.type == "cpu":
        return [device] * (shards or 1)
    cards = torch.cuda.device_count()
    first = device.index or 0
    return [torch.device("cuda", (first + i) % cards)
            for i in range(shards or cards)]


def devices_label(devices) -> str:
    """"1 cuda device(s)", "4 cpu device(s), 8 shards"."""
    distinct = len(set(devices))
    out = f"{distinct} {devices[0].type} device(s)"
    if len(devices) != distinct:
        out += f", {len(devices)} shards"
    return out


def best_of(run, devices, reps: int = REPS):
    """(best wall seconds, last result) of ``reps`` calls of ``run``, every
    card synchronised before and after each."""
    times, res = [], None
    for _ in range(reps):
        for d in set(devices):
            sync(d)
        t0 = time.perf_counter()
        res = run()
        for d in set(devices):
            sync(d)
        times.append(time.perf_counter() - t0)
    return min(times), res


def results_bit_equal(a, b) -> list[str]:
    """The fields of two GenerationResults whose tensors differ in any
    bit (shard lists compared shard by shard)."""
    bad = []
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor) or (isinstance(x, list) and x
                                           and isinstance(x[0],
                                                          torch.Tensor)):
            xs = x if isinstance(x, list) else [x]
            ys = y if isinstance(y, list) else [y]
            if len(xs) != len(ys) or not all(
                    torch.equal(u, v) for u, v in zip(xs, ys)):
                bad.append(f.name)
    return bad


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m abcsmc_tpu_torch.bench",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default), cuda:N or cpu; no fallback")
    ap.add_argument("--route", choices=("eager", "replay"), default="eager")
    ap.add_argument("--shards", type=int, default=None,
                    help="particle shards (default: one per visible card; "
                         "more shards than cards repeat them)")
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--keep", type=int, default=KEEP)
    return ap


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    prog = "abcsmc_tpu_torch.bench"
    if needs_cuda(args.device, prog):
        return 2
    from abcsmc_tpu_torch import resolve_device

    device = resolve_device(args.device)
    devices = mesh_devices(device, args.shards)
    n, keep = args.n, args.keep
    gen = generation(unit_box_config(n, keep, [0.0] * NMET, npar=NPAR),
                     None, devices)
    if args.route == "replay" and not gen.capturable:
        print(f"{prog}: --route replay needs a CUDA device and every shard "
              f"on one card (here: {devices_label(devices)}); the step "
              "runs eagerly elsewhere", file=sys.stderr)
        return 2

    params_np, mets_np, state_np = make_data(n, keep)
    params = gen.shard_rows(torch.from_numpy(params_np), n)
    mets = gen.shard_rows(torch.from_numpy(mets_np), n)
    state = tuple(torch.from_numpy(x).to(gen.device) for x in state_np)
    del params_np, mets_np
    g = step_generator(gen)

    def eager(draws=None):
        return gen.step_precomputed(
            params, mets, keep, n,
            gen.draw_step(g, n) if draws is None else draws, state)

    if args.route == "eager":
        run = eager
        run()                                     # warm-up, nvcc build
    else:
        draws = gen.draw_step(g, n)
        first_eager = eager(draws)                # warm-up, nvcc build
        cap = gen.capture_precomputed(params, mets, keep, n, draws, state)
        bad = results_bit_equal(gen.replay_precomputed(cap, draws),
                                first_eager)
        if bad:
            raise RuntimeError(
                f"{prog}: the replayed step differs from the eager step on "
                f"the same draws in {bad}")
        del first_eager

        def run():
            return gen.replay_precomputed(cap, gen.draw_step(g, n))

    best, res = best_of(run, devices)
    ncomp_used = int(res.ncomp_used)
    # the data are rank-structured by construction (mets = params @ mix +
    # noise): selection must keep > 1 component, and a NEGATIVE count is
    # the step's U0 self-check. Either is a wrong result: no number prints.
    if ncomp_used <= 1:
        raise RuntimeError(
            f"{prog}: ncomp_used={ncomp_used}: degenerate or corrupted PLS "
            "component selection on rank-structured bench data (negative: "
            "the van der Voet U0 self-check fired)")
    print(json.dumps({
        "metric": (
            f"SMC generation, {n} particles ({NPAR} pars x {NMET} mets, "
            f"keep {keep}): PLS filter + mixture weights + resample, "
            f"sim excluded, {devices_label(devices)}"),
        "value": best,
        "unit": "s",
        "vs_baseline": None,
        "ncomp_used": ncomp_used,
        "device": card_line(device),
        "route": args.route,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
