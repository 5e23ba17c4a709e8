"""The port's engine held against the JAX engine in law, pooled over seeds:
``run_device`` of one linear-Gaussian config (3 parameters, 5 metrics,
3 sets of 5,400, keep 10 %) on both, seeds 0-2, final posteriors pooled
(1,620 draws a side), INDEPENDENT and MULTIVARIATE noise.

Tolerance: per parameter the two-sample KS distance below 0.069 (the
alpha = 0.001 critical value 1.95 * sqrt(2 / 1600)) and the mean gap below
0.1 pooled sd. On a CPU the largest values seen were KS 0.048 and a gap of
0.058 (seeds 0-2 and 3-5, both noises). Three seeds of 540 survivors rather
than eight of 200: each JAX run compiles its step anew (3-5 s on a CPU),
while the draws cost little. The file stands alone so that a parallel run
gives it a worker of its own."""

import io
from contextlib import redirect_stderr

import jax
import numpy as np
import pytest
import torch

from abcsmc_tpu import AbcSmc as JAbcSmc
from abcsmc_tpu.compare import ks_distance
from abcsmc_tpu_torch import AbcSmc
from abcsmc_tpu_torch.models.simulators import make_linear_gaussian_simulator

NPAR, NMET = 3, 5
SEEDS, N = 3, 5400


def _cfg(noise):
    mix = np.asarray(jax.random.normal(jax.random.PRNGKey(7), (NPAR, NMET)))
    obs = np.array([0.3, 0.7, 0.5]) @ mix
    return mix, {
        "smc_iterations": 3, "num_samples": N,
        "predictive_prior_fraction": 0.1, "simulator": "linear_gaussian",
        "database_filename": "", "noise": noise,
        "parameters": [{"name": f"p{i}", "dist_type": "UNIFORM",
                        "num_type": "FLOAT", "par1": 0.0, "par2": 1.0}
                       for i in range(NPAR)],
        "metrics": [{"name": f"m{j}", "num_type": "FLOAT",
                     "value": float(obs[j])} for j in range(NMET)],
    }


@pytest.mark.parametrize("noise", ["INDEPENDENT", "MULTIVARIATE"])
def test_run_device_matches_jax_engine_in_law_pooled(noise):
    """A gate that a bias of a tenth of a posterior sd would fail."""
    mix, cfg = _cfg(noise)
    jp, tp = [], []
    for seed in range(SEEDS):
        port = AbcSmc(cfg, device="cpu", dtype=torch.float64,
                      simulator=make_linear_gaussian_simulator(NPAR, NMET,
                                                               mix=mix))
        with redirect_stderr(io.StringIO()):
            jp.append(JAbcSmc(cfg).run_device(seed=seed).posterior()[0])
            tp.append(port.run_device(seed=seed).posterior()[0])
    jp, tp = np.concatenate(jp), np.concatenate(tp)
    assert jp.shape == tp.shape == (SEEDS * N // 10, NPAR)
    for j in range(NPAR):
        a, b = jp[:, j], tp[:, j]
        assert ks_distance(a, b) < 0.069, j
        pooled = np.sqrt((a.var(ddof=1) + b.var(ddof=1)) / 2)
        assert abs(a.mean() - b.mean()) / pooled < 0.1, j
