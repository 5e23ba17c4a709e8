"""Write the dengue-class surrogate config (16 parameters x 100 metrics,
102,400 particles a set) to stdout (port of
examples/gen_dengue_surrogate.py): the observed metrics come from the
``linear_gaussian`` builtin at a known truth vector, so the fit has a
verifiable target.

    python -m abcsmc_tpu_torch.tools.gen_dengue_surrogate [--device cpu] \
        > dengue.json

The truth is ``default_rng(42).uniform(0.2, 0.8, 16)`` and the observed
row is the builtin's metrics for it with seed 2024: the shipped copy of
the JAX mixing matrix, plus 0.3 N(0, 1) noise. The port's noise is a
counter hash of (seed, column), not JAX's threefry draw, so the 100
observed values differ from examples/dengue_surrogate.json's by noise
only; every other field is the same.

It computes in float64 on ``--device`` (default ``cuda``; without CUDA
and without ``--device cpu`` it exits 2, nothing falls back), and the
values are rounded to 6 digits, so the config is the same on the card
and on the CPU.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from abcsmc_tpu_torch import resolve_device
from abcsmc_tpu_torch.tools import _common

NPAR, NMET = 16, 100
TRUTH_SEED, OBS_SEED = 42, 2024


def observed(device) -> tuple[np.ndarray, np.ndarray]:
    """(truth [16], the builtin's metrics [100] at it for seed 2024),
    float64, computed on ``device``."""
    from abcsmc_tpu_torch.models.simulators import (
        make_linear_gaussian_simulator,
    )

    truth = np.random.default_rng(TRUTH_SEED).uniform(0.2, 0.8, NPAR)
    sim = make_linear_gaussian_simulator(NPAR, NMET)
    obs = sim.run_batch(truth[None, :], np.array([OBS_SEED]), np.array([0]),
                        device=device, dtype=torch.float64)[0]
    return truth, obs


def config(device) -> dict:
    truth, obs = observed(device)
    return {
        "comment": (
            "Dengue-campaign-style surrogate scale test: 16 params, "
            "100 metrics, 100k particles/gen; observed metrics generated "
            f"from truth={np.round(truth, 3).tolist()} "
            f"(seed {TRUTH_SEED}). "
            "Run with --device."
        ),
        "smc_iterations": 5,
        "num_samples": 102400,
        "predictive_prior_fraction": 0.02,
        "pls_training_fraction": 0.5,
        "noise": "INDEPENDENT",
        "simulator": "linear_gaussian",
        "database_filename": "dengue_surrogate.sqlite",
        "parameters": [
            {"name": f"p{i}", "dist_type": "UNIFORM", "num_type": "FLOAT",
             "par1": 0.0, "par2": 1.0}
            for i in range(NPAR)
        ],
        "metrics": [
            {"name": f"m{j}", "num_type": "FLOAT",
             "value": round(float(obs[j]), 6)}
            for j in range(NMET)
        ],
    }


def main(argv=None) -> int:
    args = _common.device_parser(__doc__).parse_args(argv)
    if _common.needs_cuda(args.device, "gen_dengue_surrogate"):
        return 2
    json.dump(config(resolve_device(args.device)), sys.stdout, indent=1)
    sys.stdout.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
