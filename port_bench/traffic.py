"""The one generator of the benchmark's traffic: from a configuration file,
a cell's traffic parameters and ``--seed`` it makes every fit a run asks
for. A fit is what a user starts: a fresh ``AbcSmc`` from a configuration
dict, then ``run_device(seed=...)``, prior to posterior.

Traffic parameters (``traffic`` in ``workloads/<cell>.json``):

- ``store``: "memory" (the in-memory run store) or "sqlite" (a fresh SQLite
  file for each fit, in a directory under ``TMPDIR``);
- ``device_dispatch``: the configuration key of that name.

The observed row is the configuration's own (``observed: "config"``), or is
simulated by the plain reference at a truth drawn from the seed
(``observed: {"truth_low", "truth_high", "simulation_seed"}``). Every fit
of a run shares it; each fit draws its own seed from the run's.
"""

from __future__ import annotations

import copy

import numpy as np

from port_bench.reference import judge, smc

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
    sets' sizes and keeps, and what the reference is given."""

    def __init__(self, config: dict, traffic: dict, seed: int):
        self.traffic = traffic
        smc_cfg = copy.deepcopy(config["smc"])
        smc_cfg["device_dispatch"] = traffic.get("device_dispatch", "auto")
        ref = self.ref = config["reference"]
        self.npar = len(smc_cfg["parameters"])
        self.nmet = len(smc_cfg["metrics"])
        self.mix = smc.mix_matrix(self.npar, self.nmet)
        self.noise_sd = float(ref["noise_sd"])
        obs_spec = config["observed"]
        if obs_spec == "config":
            self.obs = np.array([m["value"] for m in smc_cfg["metrics"]],
                                np.float64)
        else:
            truth = np.random.default_rng(int(seed) & _M64).uniform(
                obs_spec["truth_low"], obs_spec["truth_high"], self.npar)
            self.obs = smc.simulate(
                truth[None, :],
                np.array([obs_spec["simulation_seed"]], np.uint64),
                self.mix, self.noise_sd)[0].numpy()
            for m, v in zip(smc_cfg["metrics"], self.obs):
                m["value"] = float(v)
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

    def spec(self) -> judge.FitSpec:
        """What the reference is given of every fit of this run."""
        lo = np.array([p["par1"] for p in self.smc["parameters"]], np.float64)
        hi = np.array([p["par2"] for p in self.smc["parameters"]], np.float64)
        if any(p["dist_type"] != "UNIFORM" or p.get("num_type") != "FLOAT"
               for p in self.smc["parameters"]):
            raise SystemExit("port_bench: the reference takes continuous "
                             "UNIFORM priors only")
        return judge.FitSpec(
            sizes=list(self.sizes), keeps=list(self.keeps), lo=lo, hi=hi,
            obs=self.obs, mix=self.mix, noise_sd=self.noise_sd,
            fraction=float(self.smc.get("pls_training_fraction", 0.5)),
            vdv_alpha=float(self.ref["vdv_alpha"]),
            vdv_rows=int(self.ref["vdv_window_rows"]))
