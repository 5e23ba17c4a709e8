"""Durable-store scaling probe: one engine-level ``run_device`` at
device-scale N with the SQLite mirror on (port of tools/mirror_scale.py).

    python -m abcsmc_tpu_torch.tools.mirror_scale [--n 10000000]
        [--keep 50000] [--db PATH]

The store is the checkpoint of the reference's design, so the mirror must
take the populations the device path makes. A fresh 1-set run of ``--n``
particles (2 parameters x 2 metrics, the linear-Gaussian device simulator
with the JAX package's (2, 2) mixing matrix) on one device, one shard;
one JSON line: wall seconds (host clock; the run ends with the store
written), the engine's ``dispatch_s`` / ``mirror_s``
(``timings`` "run_device_phases"), the process's peak host RSS
(``resource.getrusage``: the peak since the process started, so an
in-process caller's own peak is inside it), the database's size and the
rows complete and ranked (checked: all ``--n`` done, ``--keep`` ranked).
Without ``--db`` the store goes to a temporary directory, removed after.
"""

from __future__ import annotations

import io
import os
import resource
import sqlite3
import sys
import tempfile
import time
from contextlib import closing, redirect_stderr

from abcsmc_tpu_torch.tools import _common


def config(n: int, keep: int, db: str) -> dict:
    return {
        "smc_iterations": 1,
        "num_samples": n,
        "predictive_prior_size": keep,
        "database_filename": db,
        "parameters": [
            {"name": "a", "dist_type": "UNIFORM", "num_type": "FLOAT",
             "par1": -2.0, "par2": 2.0},
            {"name": "b", "dist_type": "UNIFORM", "num_type": "FLOAT",
             "par1": -2.0, "par2": 2.0},
        ],
        "metrics": [
            {"name": "m1", "num_type": "FLOAT", "value": 0.5},
            {"name": "m2", "num_type": "FLOAT", "value": -0.2},
        ],
    }


def measure(st: _common.Study, n: int, keep: int, db: str) -> dict:
    from abcsmc_tpu_torch import AbcSmc
    from abcsmc_tpu_torch.models.simulators import (
        make_linear_gaussian_simulator,
    )

    abc = AbcSmc(config(n, keep, db), device=st.device, dtype=st.dtype,
                 simulator=make_linear_gaussian_simulator(2, 2))
    t0 = time.perf_counter()
    with redirect_stderr(io.StringIO()):      # the per-set reports
        abc.run_device(seed=42)
    wall = time.perf_counter() - t0
    abc.storage.close()
    phases = [t for t in abc.timings if t["op"] == "run_device_phases"][-1]
    with closing(sqlite3.connect(db)) as conn:
        rows = conn.execute(
            "select count(*), sum(status = 'D'), sum(posterior > -1) "
            "from job").fetchone()
    _common.check(rows == (n, n, keep),
                  f"store rows (all, done, ranked) {rows}, want "
                  f"({n}, {n}, {keep})")
    return {
        "metric": f"run_device with the SQLite mirror, {_common.label(n)} "
                  f"particles x 1 set (2 pars x 2 mets), keep {keep}",
        "n": n, "keep": keep, "wall_s": wall,
        "dispatch_s": phases["dispatch_s"], "mirror_s": phases["mirror_s"],
        "peak_rss_gb": resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 2**20,
        "db_gb": os.path.getsize(db) / 2**30, "rows_ok": True,
    }


def main(argv=None) -> int:
    ap = _common.parser(__doc__, dtype=True)
    ap.add_argument("--n", type=int, default=10_000_000)
    ap.add_argument("--keep", type=int, default=50_000)
    ap.add_argument("--db", default="")
    args = ap.parse_args(argv)
    st = _common.start("mirror_scale", args)
    if st is None:
        return 2
    if args.db:
        st.emit(measure(st, args.n, args.keep, args.db))
        return 0
    with tempfile.TemporaryDirectory(prefix="mirror_scale_") as td:
        st.emit(measure(st, args.n, args.keep,
                        os.path.join(td, "scale.sqlite")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
