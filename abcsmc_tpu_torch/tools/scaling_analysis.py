"""The multi-shard scaling structure of the generation step, read by
counting (port of the JAX repo's ``tools/scaling_analysis.py``).

The JAX tool compiles the north-star step for each mesh size and reads its
per-device FLOPs and every collective out of the compiled program. Torch
compiles no program, so this tool runs the step once per mesh size on a
virtual mesh (every shard on ``--device``) and counts:

- the collectives, from :attr:`ParticleMesh.collectives`: per kind
  (``psum``, ``pmin``, ``all_gather``) the calls and the per-shard payload,
  with the JAX tool's definitions (a reduction counts one shard's partial,
  a gather the gathered result). A one-shard mesh makes the same calls,
  each returning its one part: it is counted, and no data moves
  (``moves_data`` false);
- the FLOPs, from ``torch.utils.flop_counter.FlopCounterMode`` around the
  step. The weight kernel is a ctypes launch the counter cannot see, so
  the weight stage is counted from its shape on every device, 2 n m (p + 2)
  multiply-add FLOPs per call (n queries, m centers, p parameters), and
  what its plain version runs on the CPU is left out: the CPU and the card
  give the same count. ``flops_total`` sums every shard; the shards of a
  virtual mesh run in one process, so ``flops_per_shard`` is derived as
  ``flops_total / shards`` (the small replicated math on the lead, the PLS
  fit on the summed Grams and the top-K decision, counts once in the
  total). ``bytes_accessed_per_device`` is null: torch has no counterpart
  of XLA's ``cost_analysis``.

The contract (``tests/test_scaling_structure.py``): the reduction payload
does not depend on the shard count or on N; the gather payload does not
grow with N while every shard holds at least ``keep`` rows, and grows
with the shard count (the gathered top-K candidates); the FLOPs over all
shards stay those of one shard (no O(N) pass is replicated).

    python -m abcsmc_tpu_torch.tools.scaling_analysis [--n 1048576]
        [--keep 50000] [--shards 1,2,4,8] [--n-sweep 4194304]
        [--topk auto|single|two] [--device cuda|cpu]

One JSON line per configuration, then a markdown table. The counts do not
depend on the device. ``sorted_pick_min`` is pinned above every size, so
one pick path runs at every mesh size (its gate counts rows per shard).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import torch

from abcsmc_tpu_torch.tools._common import (
    generation, needs_cuda, population, previous_state, step_generator,
    sync, unit_box_config,
)

NPAR = 6
NMET = 13
TOPK = {"auto": None, "single": False, "two": True}


def build_step(shards: int, n: int, keep: int, topk: str = "auto",
               device="cuda"):
    """The north-star step (the bench's shape) on ``shards`` shards of
    ``device`` (one shard: the step without a mesh, whose one-shard mesh
    counts all the same)."""
    from abcsmc_tpu_torch import resolve_device

    gen = generation(unit_box_config(n, keep, [0.0] * NMET, npar=NPAR),
                     None, [resolve_device(device)] * shards,
                     topk_two_stage=TOPK[topk])
    gen.sorted_pick_min = 1 << 62
    return gen


@contextlib.contextmanager
def weight_stage_by_shape(counter):
    """Count every weight-stage call from its shape (2 n m (p + 2)) and
    tally what the counter saw inside it (the plain version's FLOPs on
    the CPU; nothing on the card) to be left out."""
    from abcsmc_tpu_torch.ops import weights

    orig = weights.log_kernel_mixture_density
    tally = {"shape_flops": 0, "seen_flops": 0}

    def counted(params, prev_params, *rest, **kw):
        before = counter.get_total_flops()
        out = orig(params, prev_params, *rest, **kw)
        tally["seen_flops"] += counter.get_total_flops() - before
        n, p = params.shape
        tally["shape_flops"] += 2 * n * prev_params.shape[0] * (p + 2)
        return out

    weights.log_kernel_mixture_density = counted
    try:
        yield tally
    finally:
        weights.log_kernel_mixture_density = orig


def analyze(shards: int, n: int, keep: int, topk: str = "auto",
            device="cuda", seed: int = 0) -> dict:
    """One later-set step at (n, keep, n_next = n) on ``shards`` shards of
    ``device`` (``"cpu"`` to count on the CPU): its collectives and
    FLOPs. The population is the tools' linear-Gaussian one (the shipped
    6 x 13 mixing matrix) from a generator seeded ``seed``."""
    from torch.utils.flop_counter import FlopCounterMode

    from abcsmc_tpu_torch.models.simulators import shipped_mix

    gen = build_step(shards, n, keep, topk, device)
    g = torch.Generator(device=gen.device).manual_seed(seed)
    params, mets = population(n, shipped_mix(NPAR, NMET), g)
    state = previous_state(keep, NPAR, g)
    params_s = gen.shard_rows(params, n)
    mets_s = gen.shard_rows(mets, n)
    del params, mets
    draws = gen.draw_step(step_generator(gen, seed), n)
    mesh = gen.mesh
    mesh.reset_collectives()
    with FlopCounterMode(display=False) as counter, \
            weight_stage_by_shape(counter) as weight:
        res = gen.step_precomputed(params_s, mets_s, keep, n, draws, state,
                                   n_valid=n)
    sync(gen.device)
    flops = (counter.get_total_flops() - weight["seen_flops"]
             + weight["shape_flops"])
    inv = {k: dict(v) for k, v in mesh.collectives.items() if v["count"]}
    local_n = mesh.padded(n) // shards
    return {
        "shards": shards,
        "n": n,
        "keep": keep,
        "topk_two_stage": shards > 1 and gen._topk_two_stage_active(
            keep, local_n),
        "ncomp_used": int(res.ncomp_used),
        "flops_total": flops,
        "flops_per_shard": flops / shards,
        "weight_stage_flops": weight["shape_flops"],
        "bytes_accessed_per_device": None,
        "collective_count": sum(e["count"] for e in inv.values()),
        "collective_bytes_per_shard": sum(e["bytes"] for e in inv.values()),
        "collectives": inv,
        "moves_data": shards > 1,
    }


def table(rows) -> str:
    """The JAX tool's markdown table, per shard."""
    base = rows[0]
    out = ["| mesh | global N | per-shard GFLOPs | scaling | "
           "collectives (count) | collective payload/shard |",
           "|---|---|---|---|---|---|"]
    for r in rows:
        rel = (base["flops_per_shard"] / r["flops_per_shard"]
               if r["flops_per_shard"] else float("nan"))
        kinds = ", ".join(f"{k} x{v['count']}"
                          for k, v in sorted(r["collectives"].items()))
        if not r["moves_data"]:
            kinds += " (one shard: no data moves)"
        out.append(
            f"| {r['shards']} shard(s) | {r['n']:,} | "
            f"{r['flops_per_shard'] / 1e9:.2f} | {rel:.2f}x | {kinds} | "
            f"{r['collective_bytes_per_shard'] / 1024:.1f} KiB |")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m abcsmc_tpu_torch.tools.scaling_analysis",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--keep", type=int, default=50_000)
    ap.add_argument("--shards", default="1,2,4,8")
    ap.add_argument("--n-sweep", default="",
                    help="extra global N at the largest mesh (the "
                         "collective payload does not grow with N)")
    ap.add_argument("--topk", default="auto", choices=sorted(TOPK),
                    help="global top-K: auto (payload threshold), single "
                         "(candidate-row gather), two (distance gather + "
                         "row psum)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: the virtual mesh's device "
                         "(the counts do not depend on it); no fallback")
    args = ap.parse_args(argv)
    if needs_cuda(args.device, "abcsmc_tpu_torch.tools.scaling_analysis"):
        return 2
    shard_counts = [int(x) for x in args.shards.split(",") if x]
    configs = [(k, args.n) for k in shard_counts]
    configs += [(max(shard_counts), int(x))
                for x in args.n_sweep.split(",") if x and int(x) != args.n]
    rows = []
    for k, n in configs:
        r = analyze(k, n, args.keep, args.topk, args.device)
        rows.append(r)
        print(json.dumps(r), flush=True)
    print()
    print(table(rows), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
