"""The host ranking at float32 on the card against float64 on the CPU.

    python -m abcsmc_tpu_torch.rank_precision [--out F]

The host brain ranks in the engine's dtype: float32 on a CUDA engine,
float64 in the CPU tests. This runs ``ranking.ranking_pls`` on the same rows
at float64 on the CPU (the reference), float64 on the card and float32 on
the card, and prints one JSON line per dataset and run: the component count
it picks, its seconds (host clock, synchronized), the largest relative
error of its distances against the reference over the reference's first
``2 * max(cuts)`` ranks, and for each cut k the survivors it does not share
with the reference and the reference's gap between ranks k and k + 1,
relative to the distance there.

Datasets:

- ``gpu_test``: the rows of ``tests/test_torch_gpu.py::
  test_host_ranking_cuda_matches_cpu`` (20,000 x 30 metrics of rank 6 plus
  noise, 6 parameters);
- ``dengue``: ``examples/dengue_surrogate.json``'s set 0, 102,400 prior
  draws through its simulator at float64 (16 parameters x 100 metrics,
  keep 2,048), the set the host engine ranks first.

Needs a CUDA device; exits 2 without one.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from abcsmc_tpu_torch.ops import ranking

REPO = Path(__file__).resolve().parent.parent
#: (device, dtype) of each ranking; the first is the reference
RUNS = (("cpu", torch.float64), ("cuda", torch.float64),
        ("cuda", torch.float32))


def gpu_test_rows():
    """(metrics, params, observed row, training fraction, cuts)."""
    rng = np.random.default_rng(11)
    n, m, p = 20_000, 30, 6
    y = rng.uniform(0, 1, (n, p))
    mix = rng.normal(size=(p, m))
    x = y @ mix + 0.05 * rng.normal(size=(n, m))
    obs = np.full(p, 0.5) @ mix
    return x, y, obs, 0.5, (100, 200, 250, 300, 500, 1000, 2000)


def dengue_rows():
    from abcsmc_tpu_torch import AbcSmc

    cfg = json.loads((REPO / "examples" / "dengue_surrogate.json").read_text())
    cfg["database_filename"] = ""
    eng = AbcSmc(cfg, device="cuda", dtype=torch.float64)
    gen = eng._generator(1)
    n = eng.config.smc_size_at(0)
    pars = eng.par_set.sample_priors(gen, n, torch.float64)
    seeds = eng._draw_seeds(gen, n)
    mets = eng.simulator.run_batch(pars.cpu().numpy(), seeds, np.arange(n),
                                   device=eng.device, dtype=torch.float64)
    keep = eng.config.pred_prior_size_at(0)
    return (mets, pars.cpu().numpy(), eng.obs,
            eng.config.pls_training_fraction, (512, 1024, keep, 2 * keep))


def rank(x, y, obs, frac, device, dtype):
    args = [torch.as_tensor(np.asarray(v)).to(device, dtype)
            for v in (x, y, obs)]
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    order, d, ncomp = ranking.ranking_pls(*args, frac)
    order, d = order.cpu().numpy(), d.to("cpu", torch.float64).numpy()
    return order, d, ncomp, time.perf_counter() - t0


def compare(name, rows):
    x, y, obs, frac, cuts = rows
    ref_order, ref_d = None, None
    for dev, dt in RUNS:
        order, d, ncomp, secs = rank(x, y, obs, frac, torch.device(dev), dt)
        if ref_order is None:
            ref_order, ref_d = order, d
            ref_sorted = ref_d[ref_order]
        top = ref_order[:2 * max(cuts)]
        rel_err = float(np.max(np.abs(d[top] - ref_d[top]) / ref_d[top]))
        per_cut = {
            str(k): {
                "not_shared": len(set(order[:k]) - set(ref_order[:k])),
                "ref_rel_gap": float((ref_sorted[k] - ref_sorted[k - 1])
                                     / ref_sorted[k]),
            } for k in cuts
        }
        yield {"dataset": name, "device": dev, "dtype": str(dt)[6:],
               "rows": list(np.shape(x)), "ncomp": ncomp, "rank_s": secs,
               "max_rel_dist_err": rel_err, "cuts": per_cut}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the JSON lines to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("rank_precision: needs a CUDA device", file=sys.stderr)
        return 2
    lines = []
    for name, rows in (("gpu_test", gpu_test_rows()),
                       ("dengue", dengue_rows())):
        for line in compare(name, rows):
            print(json.dumps(line), flush=True)
            lines.append(line)
    if args.out:
        Path(args.out).write_text("".join(json.dumps(v) + "\n"
                                          for v in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
