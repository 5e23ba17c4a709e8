"""Simulation-based calibration (SBC) of the ABC-SMC-PLS posterior through
the port's engine (port of tools/calibration_study.py).

    python -m abcsmc_tpu_torch.tools.calibration_study [--reps 100]
        [--n 1024] [--configs lg,sir,...]

For each replicate r of a configuration: a truth theta*_r drawn from the
exact uniform prior, y_r = simulator(theta*_r), a fit through the host
engine loop (``AbcSmc.run``: 5 sets, keep 10 %, the observed vector as an
input, the brain on the device), and per parameter the posterior CDF at the
truth, u_rp = P_post(theta_p <= theta*_rp), which is U(0, 1) for exact
inference (Talts et al. 2018). ABC-SMC posteriors are broadened on purpose
(a kernel-smoothed neighbourhood, a doubled-variance proposal), so mild
over-dispersion is the honest expectation: coverage at or above nominal.

The matrix crosses the model families with the machinery under test
(:func:`study_configs`: the JAX tool's eight configurations, each simulator
built with the JAX factory's arguments). One JSON line per configuration:
the central 50 % / 90 % interval coverage from the engine's own
``posterior_summary`` quantiles (with its binomial sd), the KS distance of
the pooled u-values from U(0, 1) (:func:`ks_uniform`) and the mean abs
error of the posterior mean; then one line with all of them. Truths come
from ``numpy.random.default_rng(20260819)``, as in the JAX tool.
"""

from __future__ import annotations

import io
import sys
from contextlib import redirect_stderr

import numpy as np

from abcsmc_tpu_torch.tools import _common

GENS = 5
QUANTILES = (0.05, 0.25, 0.75, 0.95)


def _unif(name, lo, hi):
    return {"name": name, "dist_type": "UNIFORM", "num_type": "FLOAT",
            "par1": lo, "par2": hi}


def study_configs() -> dict:
    """The family x machinery matrix: name -> simulator factory, parameter
    specs (the uniform priors the truths are drawn from), metric count and
    engine config overrides."""
    from abcsmc_tpu_torch.models import simulators as sims

    lg_pars = [_unif(f"p{i}", 0.0, 1.0) for i in range(6)]
    ricker_pars = [_unif("log_r", 2.0, 5.0), _unif("sigma", 0.1, 0.8),
                   _unif("phi", 4.0, 15.0)]
    return {
        "lg": dict(
            sim=lambda: sims.make_linear_gaussian_simulator(
                6, 13, noise_sd=0.1),
            pars=lg_pars, nmet=13, overrides={"noise": "INDEPENDENT"}),
        "lg-mvn-sys": dict(
            sim=lambda: sims.make_linear_gaussian_simulator(
                6, 13, noise_sd=0.1),
            pars=lg_pars, nmet=13,
            overrides={"noise": "MULTIVARIATE",
                       "resample_method": "systematic"}),
        "sir": dict(
            sim=lambda: sims.make_sir_simulator(population=5000,
                                                t_steps=120),
            pars=[_unif("beta", 0.1, 0.6), _unif("gamma", 0.05, 0.4)],
            nmet=6, overrides={"noise": "INDEPENDENT"}),
        "gauss-tol": dict(
            sim=lambda: sims.make_gaussian_simulator(n_obs=100),
            pars=[_unif("mu", -2.0, 2.0), _unif("sigma", 0.2, 2.0)],
            nmet=2, overrides={"noise": "INDEPENDENT",
                               "pls_optimal_method": "tolerance"}),
        "ricker": dict(
            sim=lambda: sims.make_ricker_simulator(),
            pars=ricker_pars, nmet=6, overrides={"noise": "INDEPENDENT"}),
        "ricker-bc": dict(
            sim=lambda: sims.make_ricker_simulator(),
            pars=ricker_pars, nmet=6,
            overrides={"noise": "INDEPENDENT", "box_cox": True}),
        "ma2": dict(
            sim=lambda: sims.make_ma2_simulator(),
            pars=[_unif("theta1", -2.0, 2.0), _unif("theta2", -1.0, 1.0)],
            nmet=3, overrides={"noise": "MULTIVARIATE"}),
        "gk-mvn": dict(
            sim=lambda: sims.make_gk_simulator(),
            pars=[_unif("A", 0.0, 4.0), _unif("B", 0.5, 3.0),
                  _unif("g", -1.0, 2.0), _unif("k", -0.3, 1.0)],
            nmet=8, overrides={"noise": "MULTIVARIATE",
                               "resample_method": "systematic"}),
    }


MACHINERY = {
    "lg": "INDEPENDENT + multinomial + vdv",
    "lg-mvn-sys": "MULTIVARIATE + systematic + vdv",
    "sir": "INDEPENDENT + multinomial + vdv",
    "gauss-tol": "INDEPENDENT + multinomial + tolerance",
    "ricker": "INDEPENDENT + multinomial + vdv",
    "ricker-bc": "INDEPENDENT + multinomial + vdv + Box-Cox",
    "gk-mvn": "MULTIVARIATE + systematic + vdv",
    "ma2": "MULTIVARIATE + multinomial + vdv",
}
FAMILY = {
    "lg": "linear-Gaussian 6x13", "lg-mvn-sys": "linear-Gaussian 6x13",
    "sir": "stochastic SIR 2x6", "gauss-tol": "conjugate Gaussian 2x2",
    "ricker": "Ricker chaotic map 3x6 (Wood 2010)",
    "ricker-bc": "Ricker chaotic map 3x6 (Wood 2010)",
    "gk-mvn": "g-and-k quantile 4x8",
    "ma2": "MA(2) moving average 2x3 (Marin et al. 2012)",
}


def one_fit(spec, obs, n: int, seed: int, st: _common.Study):
    """One fit through the host engine loop, in memory."""
    from abcsmc_tpu_torch import AbcSmc
    from abcsmc_tpu_torch.storage import MemoryStorage

    cfg = {
        "smc_iterations": GENS, "num_samples": n,
        "predictive_prior_fraction": 0.1,
        "parameters": spec["pars"],
        "metrics": [
            {"name": f"m{j}", "num_type": "FLOAT", "value": float(obs[j])}
            for j in range(spec["nmet"])],
        **spec["overrides"],
    }
    abc = AbcSmc(cfg, device=st.device, dtype=st.dtype,
                 simulator=spec["_sim"], storage=MemoryStorage())
    with redirect_stderr(io.StringIO()):          # the per-set reports
        abc.run(seed=seed)
    return abc


def replicate_scores(pars, w, truth, summary):
    """Per parameter of one fit: the u-value (posterior mass at or below
    the truth), whether the central 50 % and 90 % intervals of
    ``summary`` (``posterior_summary`` at :data:`QUANTILES`) hold the
    truth, and the abs error of the posterior mean."""
    w = np.asarray(w, float)
    w = w / w.sum()
    pars = np.asarray(pars, float)
    u, c50, c90, err = [], [], [], []
    for p, s in enumerate(summary.values()):
        qs = s["quantiles"]
        u.append(float(w[pars[:, p] <= truth[p]].sum()))
        c50.append(qs[0.25] <= truth[p] <= qs[0.75])
        c90.append(qs[0.05] <= truth[p] <= qs[0.95])
        err.append(abs(s["mean"] - truth[p]))
    return (np.array(u), np.array(c50, bool), np.array(c90, bool),
            np.array(err))


def run_config(name, spec, reps: int, n: int, rng, st: _common.Study):
    """(u, cov50, cov90, mean_err), each [reps, npar], of one
    configuration."""
    spec = dict(spec)
    spec["_sim"] = spec["sim"]()
    lo = np.array([p["par1"] for p in spec["pars"]], float)
    hi = np.array([p["par2"] for p in spec["pars"]], float)
    rows = []
    for r in range(reps):
        # truths from the exact prior, or u ~ U(0, 1) does not hold
        truth = rng.uniform(lo, hi)
        obs = np.asarray(spec["_sim"].run_batch(
            truth[None, :], np.array([100_000 + r]), np.array([0]),
            device=st.device, dtype=st.dtype)[0])
        abc = one_fit(spec, obs, n, 31 * r + 7, st)
        pars, w = abc.posterior()
        rows.append(replicate_scores(
            pars, w, truth, abc.posterior_summary(quantiles=QUANTILES)))
    return tuple(np.stack(x) for x in zip(*rows))


def ks_uniform(u) -> float:
    """Kolmogorov-Smirnov distance of the sample ``u`` from U(0, 1)."""
    u = np.sort(np.asarray(u).ravel())
    k = len(u)
    grid = np.arange(1, k + 1) / k
    return float(np.max(np.maximum(np.abs(grid - u),
                                   np.abs(u - (np.arange(k) / k)))))


def main(argv=None) -> int:
    ap = _common.parser(__doc__, dtype=True)
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--configs", default=None,
                    help="comma-separated subset of the matrix")
    args = ap.parse_args(argv)
    st = _common.start("calibration_study", args)
    if st is None:
        return 2
    specs = study_configs()
    names = args.configs.split(",") if args.configs else list(specs)
    unknown = set(names) - set(specs)
    if unknown:
        ap.error(f"unknown configurations {sorted(unknown)}")
    rng = np.random.default_rng(20260819)
    sd50 = np.sqrt(0.5 * 0.5 / args.reps)
    sd90 = np.sqrt(0.9 * 0.1 / args.reps)
    summary = {}
    for name in names:
        u, c50, c90, err = run_config(name, specs[name], args.reps, args.n,
                                      rng, st)
        summary[name] = st.emit({
            "config": name, "family": FAMILY[name],
            "machinery": MACHINERY[name], "reps": args.reps, "n": args.n,
            "sets": GENS, "cov50": float(c50.mean()), "cov50_sd": sd50,
            "cov90": float(c90.mean()), "cov90_sd": sd90,
            "ks_pooled": ks_uniform(u), "mean_abs_err": float(err.mean())})
    st.emit({"metric": "SBC calibration matrix", "device": str(st.device),
             "dtype": args.dtype, "configs": summary})
    return 0


if __name__ == "__main__":
    sys.exit(main())
