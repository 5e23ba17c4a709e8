"""Native worker-pool throughput: jobs/s through the claim / fork-exec /
writeback cycle of ``native/abcq.cpp`` against a SQLite run store (port of
tools/bench_native.py).

    python -m abcsmc_tpu_torch.tools.bench_native [--jobs 2000]
        [--workers 1 4 8 16]

The external simulator is a two-line shell script printing constant
metrics, so the rate is the pool's own overhead (claim transactions,
fork/exec, pipe read, guarded writeback), not a simulator's. The store is
built by the port's engine (``AbcSmc.build_database`` on ``--device``,
which draws the set-0 parameters there); the pool runs on the host through
``abcsmc_tpu_torch.native.run_workers`` (``native/libabcq.so`` is built by
``make`` at first use) and no card time is measured. One JSON line per
worker count.
"""

from __future__ import annotations

import io
import os
import stat
import sys
import tempfile
import time
from contextlib import redirect_stderr

from abcsmc_tpu_torch.tools import _common


def config(n_jobs: int, db: str) -> dict:
    return {
        "smc_iterations": 1, "num_samples": n_jobs,
        "predictive_prior_fraction": 0.25,
        "database_filename": db,
        "parameters": [
            {"name": "a", "dist_type": "UNIFORM", "num_type": "FLOAT",
             "par1": 0.0, "par2": 1.0},
            {"name": "b", "dist_type": "UNIFORM", "num_type": "FLOAT",
             "par1": 0.0, "par2": 1.0},
        ],
        "metrics": [
            {"name": "sum", "num_type": "INT", "value": 44},
            {"name": "sd", "num_type": "FLOAT", "value": 2.39925},
        ],
    }


def main(argv=None) -> int:
    ap = _common.parser(__doc__)
    ap.add_argument("--jobs", type=int, default=2000)
    ap.add_argument("--workers", type=int, nargs="+", default=[1, 4, 8, 16])
    args = ap.parse_args(argv)
    st = _common.start("bench_native", args)
    if st is None:
        return 2
    from abcsmc_tpu_torch import AbcSmc
    from abcsmc_tpu_torch.native import run_workers

    with tempfile.TemporaryDirectory(prefix="bench_native_") as td:
        sim = os.path.join(td, "fast_sim.sh")
        with open(sim, "w") as f:
            # constant metrics; /bin/sh + echo keeps the exec cost minimal
            f.write("#!/bin/sh\necho 44 2.4\n")
        os.chmod(sim, os.stat(sim).st_mode | stat.S_IEXEC)
        for nw in args.workers:
            db = os.path.join(td, f"q{nw}.sqlite")
            abc = AbcSmc(config(args.jobs, db), device=st.device)
            with redirect_stderr(io.StringIO()):
                abc.build_database(seed=0)
            abc.storage.close()
            t0 = time.perf_counter()
            done = run_workers(db, sim, -1, nw)
            dt = time.perf_counter() - t0
            _common.check(done == args.jobs,
                          f"{nw} workers completed {done} of {args.jobs}")
            st.emit({"metric": f"abcq pool: {nw} worker(s), {args.jobs} "
                               "jobs", "workers": nw, "jobs": args.jobs,
                     "seconds": dt, "value": args.jobs / dt,
                     "unit": "jobs/s"})
    return 0


if __name__ == "__main__":
    sys.exit(main())
