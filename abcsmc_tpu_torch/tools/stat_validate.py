"""Statistical validation on the device: production-scale SMC fits in
float32 through ``AbcSmc.run_device`` recovering known ground truth (port
of tools/tpu_stat_validate.py).

    python -m abcsmc_tpu_torch.tools.stat_validate [--fits gaussian,dice]
        [--n 100000 --keep 10000 --sets 5 --dice-keep 5000 --dice-sets 10]

1. Gaussian toy: metrics are the sample mean and sd of 100 draws of
   N(mu, sigma), observed (2.0, 1.5); the posterior mean of each parameter
   must lie within 0.25 of the truth.
2. The dice game (the reference's canonical example): observed sum 44 and
   roll sd 2.39925 (10 dice of 6 sides). The posterior is a ridge
   n (m + 1) / 2 ~ sum, so its marginal means sit off the analytic point
   (n, m) ~ (9.4, 8.4); the checks are on the ridge: the implied sum within
   4 of the observed, the implied roll sd in (2.7, 4.2), the mean of m in
   (9.0, 14.5).

The bounds are the JAX tool's own; a failing one raises (it is a finding,
never a band to widen). The JAX tool refuses the CPU so that it cannot
write a fake record; this one runs on the CPU only under an explicit
``--device cpu``, says so in every line, and writes no file but ``--out``.
One JSON line per fit.
"""

from __future__ import annotations

import io
import sys
import time
from contextlib import redirect_stderr

import numpy as np

from abcsmc_tpu_torch.tools import _common

N = 100_000        # particles per set (both fits)
KEEP = 10_000
GENS = 5
DICE_GENS = 10     # the sd metric is one noisy observation; m converges slowly
DICE_KEEP = 5_000
GAUSS_TRUTH = (2.0, 1.5)
DICE_SUM = 44.0


def gaussian_config(n: int, keep: int, sets: int) -> dict:
    return {
        "smc_iterations": sets, "num_samples": n,
        "predictive_prior_size": keep, "noise": "INDEPENDENT",
        "parameters": [
            {"name": "mu", "dist_type": "UNIFORM", "num_type": "FLOAT",
             "par1": -10, "par2": 10},
            {"name": "sigma", "dist_type": "UNIFORM", "num_type": "FLOAT",
             "par1": 0.1, "par2": 5},
        ],
        "metrics": [
            {"name": "mean", "num_type": "FLOAT", "value": 2.0},
            {"name": "sd", "num_type": "FLOAT", "value": 1.5},
        ],
    }


def dice_config(n: int, keep: int, sets: int) -> dict:
    return {
        "smc_iterations": sets, "num_samples": n,
        "predictive_prior_size": keep, "noise": "INDEPENDENT",
        "parameters": [
            {"name": "ndice", "dist_type": "UNIFORM", "num_type": "INT",
             "par1": 1, "par2": 100},
            {"name": "sides", "dist_type": "UNIFORM", "num_type": "INT",
             "par1": 1, "par2": 100},
        ],
        "metrics": [
            {"name": "sum", "num_type": "INT", "value": 44},
            {"name": "sd", "num_type": "FLOAT", "value": 2.39925},
        ],
    }


def fit(st: _common.Study, cfg: dict, simulator, seed: int):
    """(normalized weights, posterior particles, wall s) of one run."""
    from abcsmc_tpu_torch import AbcSmc
    from abcsmc_tpu_torch.storage import MemoryStorage

    abc = AbcSmc(cfg, device=st.device, dtype=st.dtype, simulator=simulator,
                 storage=MemoryStorage())
    t0 = time.perf_counter()
    with redirect_stderr(io.StringIO()):          # the per-set reports
        abc.run_device(seed=seed)
    wall = time.perf_counter() - t0
    pars, w = abc.posterior()
    return np.asarray(pars, np.float64), w / w.sum(), wall


def gaussian_fit(st: _common.Study, n: int, keep: int, sets: int):
    """The Gaussian fit's line and its checks (holds, what)."""
    from abcsmc_tpu_torch.models.simulators import make_gaussian_simulator

    pars, w, wall = fit(st, gaussian_config(n, keep, sets),
                        make_gaussian_simulator(n_obs=100), seed=11)
    mu_hat = float((pars[:, 0] * w).sum())
    sd_hat = float((pars[:, 1] * w).sum())
    mu_err, sd_err = abs(mu_hat - GAUSS_TRUTH[0]), abs(sd_hat - GAUSS_TRUTH[1])
    row = {"metric": f"Gaussian {n}x{sets} (keep {keep}) truth recovery",
           "mu": mu_hat, "sigma": sd_hat, "mu_err": mu_err,
           "sigma_err": sd_err, "bound": 0.25, "wall_s": wall}
    return row, [(mu_err < 0.25 and sd_err < 0.25,
                  f"Gaussian posterior (mu, sigma) = ({mu_hat}, {sd_hat}), "
                  f"truth {GAUSS_TRUTH}")]


def dice_fit(st: _common.Study, n: int, keep: int, sets: int):
    """The dice fit's line and its checks (holds, what)."""
    from abcsmc_tpu_torch.models.simulators import make_dice_simulator

    pars, w, wall = fit(st, dice_config(n, keep, sets),
                        make_dice_simulator(max_dice=100), seed=7)
    implied_sum = float(((pars[:, 0] * (pars[:, 1] + 1) / 2) * w).sum())
    implied_sd = float((np.sqrt((pars[:, 1] ** 2 - 1) / 12.0) * w).sum())
    n_hat = float((pars[:, 0] * w).sum())
    m_hat = float((pars[:, 1] * w).sum())
    row = {"metric": f"Dice {n}x{sets} (keep {keep}) truth recovery",
           "implied_sum": implied_sum, "implied_roll_sd": implied_sd,
           "n_mean": n_hat, "m_mean": m_hat,
           "bounds": {"sum_err": 4.0, "roll_sd": [2.7, 4.2],
                      "m_mean": [9.0, 14.5]}, "wall_s": wall}
    return row, [
        (abs(implied_sum - DICE_SUM) < 4.0, f"dice implied sum {implied_sum}"),
        (2.7 < implied_sd < 4.2, f"dice implied roll sd {implied_sd}"),
        (9.0 < m_hat < 14.5, f"dice mean m {m_hat}")]


def main(argv=None) -> int:
    ap = _common.parser(__doc__, dtype=True)
    ap.add_argument("--fits", default="gaussian,dice")
    ap.add_argument("--n", type=int, default=N,
                    help="particles per set (both fits)")
    ap.add_argument("--keep", type=int, default=KEEP)
    ap.add_argument("--sets", type=int, default=GENS)
    ap.add_argument("--dice-keep", type=int, default=DICE_KEEP)
    ap.add_argument("--dice-sets", type=int, default=DICE_GENS)
    args = ap.parse_args(argv)
    st = _common.start("stat_validate", args)
    if st is None:
        return 2
    fits = args.fits.split(",")
    unknown = set(fits) - {"gaussian", "dice"}
    if unknown:
        ap.error(f"unknown fits {sorted(unknown)}")
    runs = {"gaussian": lambda: gaussian_fit(st, args.n, args.keep,
                                             args.sets),
            "dice": lambda: dice_fit(st, args.n, args.dice_keep,
                                     args.dice_sets)}
    for name in fits:
        row, checks = runs[name]()
        ok = all(cond for cond, _ in checks)
        st.emit({**row, "checks_hold": ok, "device": str(st.device),
                 "dtype": args.dtype})
        for cond, what in checks:
            _common.check(cond, what)
    return 0


if __name__ == "__main__":
    sys.exit(main())
