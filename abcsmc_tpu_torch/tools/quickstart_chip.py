"""The reference quick-start, end to end on the device through the chain
route (port of tools/quickstart_chip.py).

    python -m abcsmc_tpu_torch.tools.quickstart_chip [--device cuda|cpu]
        [--db PATH]

The reference's quick-start config: 30 SMC sets, sizes [300, 500, 500,
750, 1000] then 1000, predictive-prior fraction 0.5, MULTIVARIATE noise,
the dice game with U(1, 1000) priors, through ``AbcSmc.run_device``
(in-memory store unless ``--db``). One JSON line: the sets, the programs
the host submitted (one per set and size transition on every route), the
wall (host clock) and its ``dispatch_s`` / ``mirror_s`` split, the route,
the graph captures and replays, the ESS and the posterior mean and sd of
each parameter.
"""

from __future__ import annotations

import io
import sys
import time
from contextlib import redirect_stderr

from abcsmc_tpu_torch.tools import _common


def config() -> dict:
    return {
        "smc_iterations": 30,
        "num_samples": [300, 500, 500, 750, 1000],
        "predictive_prior_fraction": 0.5,
        "pls_training_fraction": 0.5,
        "noise": "MULTIVARIATE",
        "parameters": [
            {"name": "ndice", "dist_type": "UNIFORM", "num_type": "INT",
             "par1": 1, "par2": 1000},
            {"name": "sides", "dist_type": "UNIFORM", "num_type": "INT",
             "par1": 1, "par2": 1000},
        ],
        "metrics": [
            {"name": "sum", "num_type": "INT", "value": 44},
            {"name": "sd", "num_type": "FLOAT", "value": 2.39925},
        ],
    }


def main(argv=None) -> int:
    ap = _common.parser(__doc__, dtype=True)
    ap.add_argument("--db", default="")
    ap.add_argument("--sets", type=int, default=30)
    args = ap.parse_args(argv)
    st = _common.start("quickstart_chip", args)
    if st is None:
        return 2
    from abcsmc_tpu_torch import AbcSmc
    from abcsmc_tpu_torch.models.simulators import make_dice_simulator
    from abcsmc_tpu_torch.storage import MemoryStorage

    cfg = config()
    cfg["smc_iterations"] = args.sets
    if args.db:
        cfg["database_filename"] = args.db
    abc = AbcSmc(cfg, device=st.device, dtype=st.dtype,
                 simulator=make_dice_simulator(max_dice=1000),
                 storage=None if args.db else MemoryStorage())
    t0 = time.perf_counter()
    with redirect_stderr(io.StringIO()):          # the per-set reports
        abc.run_device(seed=2026)
    wall = time.perf_counter() - t0
    phases = [t for t in abc.timings if t["op"] == "run_device_phases"][-1]
    summ = abc.posterior_summary()
    st.emit({
        "metric": f"reference quick-start, {args.sets} sets (dice, "
                  "MULTIVARIATE), run_device",
        "device": str(st.device), "sets": phases["sets"],
        "programs": phases["programs"], "route": phases["route"],
        "graph_captures": phases["graph_captures"],
        "graph_replays": phases["graph_replays"],
        "wall_s": wall, "dispatch_s": phases["dispatch_s"],
        "mirror_s": phases["mirror_s"], "ess": abc.ess(),
        "posterior": {p: {"mean": v["mean"], "sd": v["sd"]}
                      for p, v in summ.items()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
