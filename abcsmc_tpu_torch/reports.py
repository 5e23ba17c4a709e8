"""Convergence / filtering reports, format-compatible with AbcLog
(src/AbcLog.cpp:24-124); the same text as :mod:`abcsmc_tpu.reports`."""

from __future__ import annotations

import sys

import numpy as np

from abcsmc_tpu_torch.ops import stats

WIDTH = 12
DOUBLE_BAR = "=" * 89


def _w(v) -> str:
    return f"{v:>{WIDTH}.6g}"


def _print_stats(str1, str2, val1, val2, delta, pct_chg, tail, os_):
    os_.write(
        f"    {str1}, {str2}  ( delta, % ): {_w(val1)}, {_w(val2)}"
        f" ( {_w(delta)}, {_w(pct_chg)}% )\n{tail}"
    )


def report_convergence_data(engine, set_t: int, os_=None):
    """AbcLog::report_convergence_data (src/AbcLog.cpp:24-79); writes to
    ``os_``, default the current ``sys.stderr``."""
    os_ = sys.stderr if os_ is None else os_
    if len(engine._predictive_prior) <= set_t:
        raise RuntimeError(
            f"attempting to report stats for set {set_t}, but data aren't "
            "available. This can happen if --process is called on a database "
            "that is not ready to be processed."
        )
    surv = engine._predictive_prior[set_t]
    par_values = engine._particle_parameters[set_t][surv]
    current_means = par_values.mean(axis=0)
    if set_t > 0:
        last = engine._particle_parameters[set_t - 1][
            engine._predictive_prior[set_t - 1]
        ]
        last_means = last.mean(axis=0)

    os_.write(DOUBLE_BAR + "\n")
    if set_t == 0:
        os_.write("Predictive prior summary statistics:\n")
    else:
        os_.write("Convergence data for predictive priors:\n")
    prior_means = engine.par_set.means()
    prior_sds = engine.par_set.sds()
    dv = engine._doubled_variance
    for j, par in enumerate(engine.par_set.params):
        current_stdev = float(np.sqrt(dv[set_t][j] / 2.0))
        pm, ps = prior_means[j], prior_sds[j]
        dm = current_means[j] - pm
        pct_m = 100 * dm / pm if pm != 0 else float("inf")
        ds = current_stdev - ps
        pct_s = 100 * ds / ps if ps != 0 else float("inf")
        os_.write(f'  Par {j}: "{par.name}"\n')
        os_.write("  Means:\n")
        _print_stats("Prior", "current", pm, current_means[j], dm, pct_m, "", os_)
        if set_t != 0:
            d = current_means[j] - last_means[j]
            pct = 100 * d / last_means[j] if last_means[j] != 0 else float("inf")
            _print_stats(
                "Last", " current", last_means[j], current_means[j], d, pct, "\n",
                os_,
            )
        os_.write("  Standard deviations:\n")
        _print_stats(
            "Prior", "current", ps, current_stdev, ds, pct_s, "\n", os_
        )
        if set_t != 0:
            last_sd = float(np.sqrt(dv[set_t - 1][j] / 2.0))
            d = current_stdev - last_sd
            pct = 100 * d / last_sd if last_sd != 0 else float("inf")
            _print_stats(
                "Last", " current", last_sd, current_stdev, d, pct, "\n", os_
            )


def _header(engine, os_):
    for p in engine.par_set.params:
        os_.write(f"{p.short_name:>{WIDTH}}")
    os_.write(" | ")
    for m in engine.metrics:
        os_.write(f"{m.short_name:>{WIDTH}}")
    os_.write("\n")


def filtering_report(
    engine, t: int, posterior_pars: np.ndarray, posterior_mets: np.ndarray,
    os_=None,
):
    """AbcLog::filtering_report (src/AbcLog.cpp:81-124); writes to ``os_``,
    default the current ``sys.stderr``."""
    os_ = sys.stderr if os_ is None else os_
    os_.write(f"{DOUBLE_BAR}\nSet {t}\n{DOUBLE_BAR}\n")
    os_.write("Observed:\n")
    _header(engine, os_)
    for _ in range(posterior_pars.shape[1]):
        os_.write(f"{'---':>{WIDTH}}")
    os_.write(" | ")
    for m in engine.metrics:
        os_.write(_w(m.value))
    os_.write("\n")

    nr = float(stats.nrmse(np.asarray(posterior_mets, np.float64),
                           np.asarray(engine.obs, np.float64)))
    os_.write(
        f"Normalized RMSE for metric means (lower is better):  {nr:.6g}\n"
    )
    os_.write("Posterior means:\n")
    _header(engine, os_)
    for v in posterior_pars.mean(axis=0):
        os_.write(_w(v))
    os_.write(" | ")
    for v in posterior_mets.mean(axis=0):
        os_.write(_w(v))
    os_.write("\n")

    os_.write("Posterior medians:\n")
    _header(engine, os_)
    for j in range(posterior_pars.shape[1]):
        os_.write(_w(float(np.median(posterior_pars[:, j]))))
    os_.write(" | ")
    for j in range(posterior_mets.shape[1]):
        os_.write(_w(float(np.median(posterior_mets[:, j]))))
    os_.write("\n")

    k = min(5, posterior_pars.shape[0])
    os_.write("Best five:\n")
    _header(engine, os_)
    for q in range(k):
        for v in posterior_pars[q]:
            os_.write(_w(v))
        os_.write(" | ")
        for v in posterior_mets[q]:
            os_.write(_w(v))
        os_.write("\n")

    os_.write("Worst five:\n")
    _header(engine, os_)
    for q in range(max(0, posterior_pars.shape[0] - k), posterior_pars.shape[0]):
        for v in posterior_pars[q]:
            os_.write(_w(v))
        os_.write(" | ")
        for v in posterior_mets[q]:
            os_.write(_w(v))
        os_.write("\n")
