"""The plain reference of ``north_star_1m``: a fit of the linear-Gaussian
simulator with INDEPENDENT proposals, continuous UNIFORM priors and PLS
ranking without Box-Cox, judged by :mod:`port_bench.reference.judge` on
:mod:`port_bench.reference.smc` (the module contract is in
:func:`port_bench.registry.reference`).

The configuration's ``observed`` is ``{"truth_low", "truth_high",
"simulation_seed"}``: the observed row is simulated at a truth drawn
uniform from the run's seed, with that particle seed, and every fit of the
run shares it. Its ``reference`` gives the simulator's ``noise_sd`` and the
van der Voet test's level and window (``vdv_alpha``, ``vdv_window_rows``).
"""

from __future__ import annotations

import numpy as np

from port_bench.reference import judge as _judge
from port_bench.reference import smc

NUMBERS = _judge.NUMBERS
control_fit = _judge.control_fit


def _mix(smc_cfg: dict) -> np.ndarray:
    return smc.mix_matrix(len(smc_cfg["parameters"]), len(smc_cfg["metrics"]))


def observed(config: dict, smc_cfg: dict, seed: int) -> np.ndarray:
    obs_spec = config["observed"]
    truth = np.random.default_rng(int(seed) & ((1 << 64) - 1)).uniform(
        obs_spec["truth_low"], obs_spec["truth_high"],
        len(smc_cfg["parameters"]))
    obs = smc.simulate(truth[None, :],
                       np.array([obs_spec["simulation_seed"]], np.uint64),
                       _mix(smc_cfg), float(config["reference"]["noise_sd"])
                       )[0].numpy()
    for m, v in zip(smc_cfg["metrics"], obs):
        m["value"] = float(v)
    return obs


def spec(config: dict, smc_cfg: dict, sizes, keeps, obs) -> _judge.FitSpec:
    pars = smc_cfg["parameters"]
    if any(p["dist_type"] != "UNIFORM" or p.get("num_type") != "FLOAT"
           for p in pars):
        raise SystemExit("port_bench: the reference takes continuous "
                         "UNIFORM priors only")
    ref = config["reference"]
    return _judge.FitSpec(
        sizes=list(sizes), keeps=list(keeps),
        lo=np.array([p["par1"] for p in pars], np.float64),
        hi=np.array([p["par2"] for p in pars], np.float64),
        obs=obs, mix=_mix(smc_cfg), noise_sd=float(ref["noise_sd"]),
        fraction=float(smc_cfg.get("pls_training_fraction", 0.5)),
        vdv_alpha=float(ref["vdv_alpha"]),
        vdv_rows=int(ref["vdv_window_rows"]))


def judge(sets, spec: _judge.FitSpec, device, seed: int, check: dict) -> dict:
    return _judge.judge(sets, spec, device, seed, int(check["ks_rows"]))
