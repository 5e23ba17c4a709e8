"""The one generator of the benchmark's traffic: from a configuration file,
its plain reference (``references/<config>.py``), a cell's traffic
parameters and ``--seed`` it makes every fit a run asks for. A fit is what a
user starts: a fresh ``AbcSmc`` from a configuration dict, then
``run_device(seed=...)``, prior to posterior.

Traffic parameters (``traffic`` in ``workloads/<cell>.json``):

- ``store``: "memory" (the in-memory run store) or "sqlite" (a fresh SQLite
  file for each fit, in a directory under ``TMPDIR``);
- ``device_dispatch``: the configuration key of that name.

The observed row is the reference's (its ``observed``), made once from the
run's seed; every fit of a run shares it, and each fit draws its own seed
from the run's.
"""

from __future__ import annotations

import copy

import numpy as np

_M64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def fit_seed(run_seed: int, index: int) -> int:
    """The seed of fit ``index`` of a run (-1: its warm-up fit), below
    2^63."""
    return _splitmix64(_splitmix64(int(run_seed) & _M64) ^ (index & _M64)) \
        >> 1


class Traffic:
    """One run's traffic: the fit configuration, the observed row, the
    sets' sizes and keeps, and the configuration's plain reference
    (``reference``, a module of :func:`port_bench.registry.reference`)."""

    def __init__(self, config: dict, traffic: dict, seed: int, reference):
        self.config, self.traffic, self.reference = config, traffic, reference
        smc_cfg = copy.deepcopy(config["smc"])
        smc_cfg["device_dispatch"] = traffic.get("device_dispatch", "auto")
        self.npar = len(smc_cfg["parameters"])
        self.nmet = len(smc_cfg["metrics"])
        self.obs = np.asarray(reference.observed(config, smc_cfg, seed),
                              np.float64)
        self.smc = smc_cfg
        sets = int(smc_cfg["smc_iterations"])
        n = int(smc_cfg["num_samples"])
        if "predictive_prior_size" in smc_cfg:
            keep = int(smc_cfg["predictive_prior_size"])
        else:
            keep = int(n * float(smc_cfg["predictive_prior_fraction"]) + 0.5)
        self.sizes, self.keeps = [n] * sets, [keep] * sets

    @property
    def store(self) -> str:
        return self.traffic.get("store", "memory")

    def fit_config(self, database_filename: str = "", **overrides) -> dict:
        cfg = copy.deepcopy(self.smc)
        cfg["database_filename"] = database_filename
        cfg.update(overrides)
        return cfg

    def spec(self):
        """What the reference's judge is given of every fit of this run."""
        return self.reference.spec(self.config, self.smc, self.sizes,
                                   self.keeps, self.obs)
