"""End-to-end fit at the reference's production workload shape (port of
tools/bench_reference_shape.py).

    python -m abcsmc_tpu_torch.tools.bench_reference_shape [--n 10000]
        [--sets 10]

The reference's dengue-class fits run 10,000 particles a set for about 10
sets over 6 parameters x 13 metrics with predictive-prior fraction 0.01.
This times the whole fit (simulate, rank, PLS, weights, resample, perturb,
the in-memory store) through ``AbcSmc.run_device`` on one device, with a
linear-Gaussian surrogate (noise sd 0.1) standing in for the epidemic
simulator: what a fit costs once the simulator is a device function.

Two JSON lines, the same fit twice in one process: "cold" is the first run
(the kernel's first load and the first graph capture included), "warm"
the second. There is no persistent compile cache on this side, so warm is
not a cache hit: it is the second run of a process. Each line carries the
largest abs error of the posterior mean against the truth.
"""

from __future__ import annotations

import io
import sys
import time
from contextlib import redirect_stderr

import numpy as np

from abcsmc_tpu_torch.tools import _common


def build_cfg(n: int, sets: int, obs) -> dict:
    return {
        "smc_iterations": sets,
        "num_samples": n,
        "predictive_prior_fraction": 0.01,
        "pls_training_fraction": 0.5,
        "noise": "INDEPENDENT",
        "parameters": [
            {"name": f"p{i}", "dist_type": "UNIFORM", "num_type": "FLOAT",
             "par1": 0.0, "par2": 1.0} for i in range(6)],
        "metrics": [
            {"name": f"m{j}", "num_type": "FLOAT", "value": float(obs[j])}
            for j in range(13)],
    }


def main(argv=None) -> int:
    ap = _common.parser(__doc__, dtype=True)
    ap.add_argument("--n", type=int, default=10_000)
    ap.add_argument("--sets", type=int, default=10)
    args = ap.parse_args(argv)
    st = _common.start("bench_reference_shape", args)
    if st is None:
        return 2
    from abcsmc_tpu_torch import AbcSmc
    from abcsmc_tpu_torch.models.simulators import (
        make_linear_gaussian_simulator,
    )
    from abcsmc_tpu_torch.storage import MemoryStorage

    truth = np.random.default_rng(42).uniform(0.2, 0.8, 6)
    sim = make_linear_gaussian_simulator(6, 13, noise_sd=0.1)
    obs = sim.run_batch(truth[None, :], np.array([7]), np.array([0]),
                        device=st.device, dtype=st.dtype)[0]
    cfg = build_cfg(args.n, args.sets, obs)
    for label in ("cold", "warm"):
        abc = AbcSmc(cfg, device=st.device, dtype=st.dtype, simulator=sim,
                     storage=MemoryStorage())
        t0 = time.perf_counter()
        with redirect_stderr(io.StringIO()):      # the per-set reports
            abc.run_device(seed=11)
        wall = time.perf_counter() - t0
        pars, w = abc.posterior()
        w = w / w.sum()
        err = float(np.abs((pars * w[:, None]).sum(0) - truth).max())
        gens = [t for t in abc.timings if t["op"] == "device_generation"]
        phases = [t for t in abc.timings
                  if t["op"] == "run_device_phases"][-1]
        st.emit({
            "metric": f"reference-shape fit, {args.n} particles x "
                      f"{args.sets} generations (6 pars x 13 mets, keep 1%), "
                      f"end-to-end incl. store mirroring, {label}",
            "value": wall, "unit": "s", "label": label,
            "note": "cold: first run in this process (kernel load, graph "
                    "capture); warm: the second run (no compile cache)",
            "per_generation_ms": 1e3 * wall / args.sets,
            "set_ms": [t["device_ms"] for t in gens],
            "route": phases["route"],
            "max_abs_posterior_err": err,
            "ncomp_used": [t["ncomp_used"] for t in gens]})
    return 0


if __name__ == "__main__":
    sys.exit(main())
