"""Readings that set the limits of ``correct`` (never run by the benchmark's
own runs): the numbers of the judge of a cell's plain reference
(``references/<config>.py``) over many seeds in one process, from

- ``program``: sound fits of the program, as a benchmark run makes them;
- ``weights_bf16``: the program's own lower-precision path,
  ``weight_precision: "default"`` (one BF16 pass in the weight kernel);
- ``reference_tf32`` / ``reference_bf16``: the plain reference in the
  program's place (its ``control_fit``), each stage's results rounded to
  TF32 (the float32 of a TF32 matmul) or bfloat16 (``reference_float64``:
  not rounded);
- ``reference_<fault>``: the reference in the program's place with one of
  the faults its ``control_fit`` knows planted (``unchanged``: every
  proposal returns the set's own rows; ``ncomp_low``: the ranking takes
  one PLS component, whatever the van der Voet test says);
- ``fault_<name>``: the program with a fault of :mod:`port_bench.faults`
  planted.

    python3 port_bench/control.py --workload <cell> --mode <mode>
        --seeds 11,12,13

One JSON line a seed, then one with each number's least and largest
reading. Program modes run one fit a seed through ``run.run`` (set-up,
a one-fit window, the comparison)."""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(workload: str, mode: str, seed: int, device=None) -> dict:
    from port_bench import faults, registry, run
    from port_bench.traffic import Traffic

    if mode.startswith("reference_"):
        import torch

        bench = registry.benchmark()
        entry = next(w for w in bench["workloads"] if w["name"] == workload)
        cell = registry.workload(workload)
        ref = registry.reference(entry["config"])
        traffic = Traffic(registry.config(entry["config"]), cell["traffic"],
                          seed, ref)
        spec = traffic.spec()
        dev = device or "cuda"
        kind = mode[len("reference_"):]
        rounding = kind if kind in ("tf32", "bf16") else None
        sets = ref.control_fit(
            spec, seed, dev, rounding=rounding,
            fault=None if rounding or kind == "float64" else kind)
        if torch.device(dev).type == "cuda":
            torch.cuda.empty_cache()
        return ref.judge(sets, spec, dev, seed ^ 0x5EED, cell["check"])
    argv = ["--workload", workload, "--seed", str(seed), "--seconds",
            "0.001", "--trace", "0"]
    overrides = {"weight_precision": "default"} \
        if mode == "weights_bf16" else None
    if mode.startswith("fault_"):
        with faults.planted(mode[len("fault_"):]):
            result, code = run.run(argv, device=device)
    elif mode in ("program", "weights_bf16"):
        result, code = run.run(argv, device=device, overrides=overrides)
    else:
        raise SystemExit(f"unknown mode {mode!r}")
    if result is None:
        raise SystemExit(f"run failed with code {code}")
    return {k: c["value"] for k, c in result["checks"].items()}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        got = readings(args.workload, args.mode, seed)
        rows.append(got)
        print(json.dumps({"workload": args.workload, "mode": args.mode,
                          "seed": seed, "s": time.perf_counter() - t, **got}),
              flush=True)
    print(json.dumps({"workload": args.workload, "mode": args.mode,
                      "seeds": len(rows),
                      "least": {k: min(r[k] for r in rows) for k in rows[0]},
                      "largest": {k: max(r[k] for r in rows)
                                  for k in rows[0]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
