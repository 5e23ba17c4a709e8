"""The plain reference of ``ricker_1m``: a fit of Wood's Ricker map with
Poisson observations (the builtin ``ricker`` simulator) with INDEPENDENT
proposals, continuous UNIFORM priors and PLS ranking without Box-Cox,
judged by :mod:`port_bench.reference.ricker` (the module contract is in
:func:`port_bench.registry.reference`).

The configuration's ``observed`` is ``{"truth", "simulation_seed"}``: the
observed row is the reference simulator's at that truth with that particle
seed, on the CPU in float32, the same for every run. Its ``reference``
gives the map's ``t_steps``, ``burn_in`` and ``n0`` and the van der Voet
test's level and window (``vdv_alpha``, ``vdv_window_rows``). A cell's
``check`` gives ``ks_rows``, the sample of a set's rows judged in law.
"""

from __future__ import annotations

import numpy as np

from port_bench.reference import ricker

NUMBERS = ricker.NUMBERS
control_fit = ricker.control_fit


def _map(config: dict) -> tuple:
    ref = config["reference"]
    return int(ref["t_steps"]), int(ref["burn_in"]), float(ref["n0"])


def observed(config: dict, smc_cfg: dict, seed: int) -> np.ndarray:
    obs_spec = config["observed"]
    truth = np.asarray(obs_spec["truth"], np.float64)[None, :]
    obs = ricker.simulate(truth, np.array([obs_spec["simulation_seed"]],
                                          np.uint64),
                          *_map(config))[0].double().numpy()
    for m, v in zip(smc_cfg["metrics"], obs):
        m["value"] = float(v)
    return obs


def spec(config: dict, smc_cfg: dict, sizes, keeps,
         obs) -> ricker.RickerSpec:
    pars = smc_cfg["parameters"]
    if any(p["dist_type"] != "UNIFORM" or p.get("num_type") != "FLOAT"
           for p in pars):
        raise SystemExit("port_bench: the reference takes continuous "
                         "UNIFORM priors only")
    if (smc_cfg.get("simulator") != "ricker" or len(pars) != 3
            or len(smc_cfg["metrics"]) != 6
            or smc_cfg.get("noise") != "INDEPENDENT"
            or smc_cfg.get("box_cox", False)
            or smc_cfg.get("resample_method", "multinomial")
            != "multinomial"):
        raise SystemExit("port_bench: the reference judges the builtin "
                         "ricker (3 parameters, 6 metrics) under "
                         "INDEPENDENT noise, multinomial resampling and no "
                         "Box-Cox")
    ref = config["reference"]
    t_steps, burn_in, n0 = _map(config)
    return ricker.RickerSpec(
        sizes=list(sizes), keeps=list(keeps),
        lo=np.array([p["par1"] for p in pars], np.float64),
        hi=np.array([p["par2"] for p in pars], np.float64),
        obs=obs, t_steps=t_steps, burn_in=burn_in, n0=n0,
        fraction=float(smc_cfg.get("pls_training_fraction", 0.5)),
        vdv_alpha=float(ref["vdv_alpha"]),
        vdv_rows=int(ref["vdv_window_rows"]))


def judge(sets, spec: ricker.RickerSpec, device, seed: int,
          check: dict) -> dict:
    return ricker.judge(sets, spec, device, seed, int(check["ks_rows"]))
