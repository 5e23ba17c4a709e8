"""Time whole sets of shipped examples with the weight kernel's folded call
and with the same tree's unfolded call, in turns.

    python -m abcsmc_tpu_torch.bench_fold [--examples gk,mg1,dice]
        [--turns K] [--out F]

For each example (its config as shipped, an in-memory store) and each
``device_dispatch`` ("sequential": every set an eager step; "fused": sets
2 on replay one CUDA graph) it runs ``run_device`` with the launch plan as
it is (folded at up to ``kernels._FOLD_MAX_CENTERS`` centers: one kernel
a pass) and with the fold turned off (``_FOLD_MAX_CENTERS`` 0: the
prologue and short splits, one more kernel a call), in ``K`` rounds of
folded, unfolded, unfolded, folded. One JSON line per example and
dispatch: for each form, each run's median device milliseconds of a set
over sets 1 on of the dispatch's route (eager sets; fused: the replayed
ones), from the run's ``device_generation`` timings (CUDA events around
the set), the median and spread of those over the runs, and the
kernels the C entry launched a run (``kernels.kernel_launches``). Needs a
CUDA device; exits 2 without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from contextlib import redirect_stderr
from io import StringIO
from pathlib import Path

import numpy as np
import torch

from abcsmc_tpu_torch import AbcSmc
from abcsmc_tpu_torch.bench_kernel import spread
from abcsmc_tpu_torch.ops import kernels

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"


def set_fold(on: bool, edge=kernels._FOLD_MAX_CENTERS):
    """The plan's fold threshold as shipped (on) or 0 (off), every cached
    plan and call forgotten."""
    kernels._FOLD_MAX_CENTERS = edge if on else 0
    kernels.launch_plan.cache_clear()
    kernels._call_of.cache_clear()


def one_run(cfg: dict, dispatch: str) -> dict:
    """``run_device`` of ``cfg`` under ``dispatch``: the median set ms over
    sets 1 on of the dispatch's route (eager; fused: replayed), and the
    kernels launched."""
    cfg = dict(cfg, device_dispatch=dispatch, database_filename="")
    before = kernels.kernel_launches()
    with redirect_stderr(StringIO()):
        run = AbcSmc(cfg).run_device(seed=0)
    torch.cuda.synchronize()
    route = "replay" if dispatch == "fused" else "eager"
    gens = [e for e in run.timings if e["op"] == "device_generation"]
    sets = [e["device_ms"] for e in gens[1:] if e["route"] == route]
    return {"set_ms": float(np.median(sets)),
            "launches": kernels.kernel_launches() - before}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--examples", default="gk,mg1,dice",
                    help="shipped examples, comma-separated "
                         "(default: %(default)s)")
    ap.add_argument("--turns", type=int, default=3,
                    help="rounds of folded, unfolded, unfolded, folded")
    ap.add_argument("--out", help="also write the JSON lines to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_fold: needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    lines = [{"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}]
    try:
        for name in args.examples.split(","):
            cfg = json.loads((EXAMPLES / f"{name}.json").read_text())
            for dispatch in ("sequential", "fused"):
                one_run(cfg, dispatch)   # warm-up: builds, first capture
                runs = {True: [], False: []}
                for on in (True, False, False, True) * args.turns:
                    set_fold(on)
                    runs[on].append(one_run(cfg, dispatch))
                row = {"example": name, "dispatch": dispatch}
                for on, key in ((True, "folded"), (False, "unfolded")):
                    ms = [r["set_ms"] for r in runs[on]]
                    row[key] = {"set_ms": ms, "set_ms_spread": spread(ms),
                                "launches": sorted({r["launches"]
                                                    for r in runs[on]})}
                lines.append(row)
                print(json.dumps(row), flush=True)
    finally:
        set_fold(True)
    print(json.dumps(lines[0]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(x) + "\n" for x in lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
