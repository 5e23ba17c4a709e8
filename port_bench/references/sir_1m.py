"""The plain reference of ``sir_1m``: a fit of the chain-binomial SIR
epidemic (the builtin ``sir`` simulator) with MULTIVARIATE proposals,
continuous UNIFORM priors and PLS ranking without Box-Cox, judged by
:mod:`port_bench.reference.sir` (the module contract is in
:func:`port_bench.registry.reference`).

The configuration's ``observed`` is ``{"truth", "simulation_seed"}``: the
observed row is the reference simulator's at that truth with that particle
seed, the same for every run. Its ``reference`` gives the epidemic's
``population``, ``t_steps`` and ``i0``, the proposal's ``max_retries`` and
the van der Voet test's level and window (``vdv_alpha``,
``vdv_window_rows``). A cell's ``check`` gives ``ks_rows`` (the sample of a
set's rows judged in law) and ``ref_rows`` (the rows the reference
proposes to judge them against).
"""

from __future__ import annotations

import numpy as np

from port_bench.reference import sir

NUMBERS = sir.NUMBERS
control_fit = sir.control_fit


def _epidemic(config: dict) -> tuple:
    ref = config["reference"]
    return int(ref["population"]), int(ref["t_steps"]), int(ref["i0"])


def observed(config: dict, smc_cfg: dict, seed: int) -> np.ndarray:
    obs_spec = config["observed"]
    truth = np.asarray(obs_spec["truth"], np.float64)[None, :]
    obs = sir.simulate(truth, np.array([obs_spec["simulation_seed"]],
                                       np.uint64),
                       *_epidemic(config))[0].double().numpy()
    for m, v in zip(smc_cfg["metrics"], obs):
        m["value"] = float(v)
    return obs


def spec(config: dict, smc_cfg: dict, sizes, keeps, obs) -> sir.SirSpec:
    pars = smc_cfg["parameters"]
    if any(p["dist_type"] != "UNIFORM" or p.get("num_type") != "FLOAT"
           for p in pars):
        raise SystemExit("port_bench: the reference takes continuous "
                         "UNIFORM priors only")
    if (smc_cfg.get("simulator") != "sir" or len(pars) != 2
            or len(smc_cfg["metrics"]) != 6
            or smc_cfg.get("noise") != "MULTIVARIATE"
            or smc_cfg.get("box_cox", False)
            or smc_cfg.get("resample_method", "multinomial")
            != "multinomial"):
        raise SystemExit("port_bench: the reference judges the builtin sir "
                         "(2 parameters, 6 metrics) under MULTIVARIATE "
                         "noise, multinomial resampling and no Box-Cox")
    ref = config["reference"]
    population, t_steps, i0 = _epidemic(config)
    return sir.SirSpec(
        sizes=list(sizes), keeps=list(keeps),
        lo=np.array([p["par1"] for p in pars], np.float64),
        hi=np.array([p["par2"] for p in pars], np.float64),
        obs=obs, population=population, t_steps=t_steps, i0=i0,
        max_retries=int(ref["max_retries"]),
        fraction=float(smc_cfg.get("pls_training_fraction", 0.5)),
        vdv_alpha=float(ref["vdv_alpha"]),
        vdv_rows=int(ref["vdv_window_rows"]))


def state(abc) -> list:
    """Each set's proposal factor, from the fit's ``device_generation``
    timings (``mvn_factor``: the Cholesky factor the program proposed the
    next set with). A program that gives none cannot be judged here: the
    run stops."""
    gens = [e for e in abc.timings if e["op"] == "device_generation"]
    if any("mvn_factor" not in e for e in gens):
        raise SystemExit("port_bench: the program reports no mvn_factor, "
                         "the proposal's covariance this reference judges")
    return [{"mvn_factor": None if e["mvn_factor"] is None
             else np.asarray(e["mvn_factor"], np.float64)} for e in gens]


def judge(sets, spec: sir.SirSpec, device, seed: int, check: dict) -> dict:
    return sir.judge(sets, spec, device, seed, int(check["ks_rows"]),
                     int(check["ref_rows"]))
