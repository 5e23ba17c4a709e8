"""Posterior diagnostics plots from a run database.

Python replacement for the reference's offline R scripts
(vis/abc_plots.R: per-generation posterior distributions per parameter;
vis/abc.pairs.ex.R + pairs.panels.R: pairs panels with correlations), reading
the same job/par/met schema. Usage:

    python -m abcsmc_tpu_torch.vis runs.sqlite out_prefix
"""

from __future__ import annotations

import sys

import numpy as np

from abcsmc_tpu_torch.storage.sqlite_store import SQLiteStorage


def _load(db_path: str):
    store = SQLiteStorage(db_path)
    gens = store.read_generations()
    store.close()
    if not gens:
        from abcsmc_tpu_torch.errors import AbcError

        raise AbcError(f"no generations to plot in {db_path}")
    return store.par_names, store.met_names, gens


def plot_posteriors(db_path: str, out_path: str, posterior_only: bool = True):
    """Violin of each parameter's (predictive-prior) distribution per
    generation - the beanplot panel of vis/abc_plots.R."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    par_names, _, gens = _load(db_path)
    npar = len(par_names)
    fig, axes = plt.subplots(npar, 1, figsize=(8, 2.6 * npar), squeeze=False)
    for j, name in enumerate(par_names):
        ax = axes[j][0]
        data = []
        for gen in gens:
            vals = gen.params[:, j]
            if posterior_only and gen.has_posterior:
                vals = gen.params[gen.predictive_prior_indices(), j]
            data.append(vals)
        ax.violinplot(data, positions=range(len(gens)), widths=0.8,
                      showmedians=True)
        ax.set_ylabel(name)
        ax.set_xlabel("SMC generation")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_pairs(db_path: str, out_path: str, set_num: int = -1):
    """Pairs panel of the last (or given) generation's predictive prior:
    scatter below the diagonal, histograms on it, correlations above
    (vis/pairs.panels.R)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    par_names, _, gens = _load(db_path)
    gen = gens[set_num]
    pars = gen.params
    if gen.has_posterior:
        pars = gen.params[gen.predictive_prior_indices()]
    p = pars.shape[1]
    fig, axes = plt.subplots(p, p, figsize=(2.2 * p, 2.2 * p), squeeze=False)
    for i in range(p):
        for j in range(p):
            ax = axes[i][j]
            if i == j:
                ax.hist(pars[:, i], bins=20, color="#4477aa")
                ax.set_title(par_names[i], fontsize=9)
            elif i > j:
                ax.scatter(pars[:, j], pars[:, i], s=6, alpha=0.5)
            else:
                r = np.corrcoef(pars[:, j], pars[:, i])[0, 1]
                ax.text(0.5, 0.5, f"r = {r:.2f}", ha="center", va="center",
                        fontsize=10 + 8 * abs(r))
                ax.set_axis_off()
            if i < p - 1:
                ax.set_xticklabels([])
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 1:
        print("usage: python -m abcsmc_tpu_torch.vis <runs.sqlite> [out_prefix]")
        return 1
    db = argv[0]
    prefix = argv[1] if len(argv) > 1 else "abc"
    p1 = plot_posteriors(db, f"{prefix}_posteriors.png")
    p2 = plot_pairs(db, f"{prefix}_pairs.png")
    print(p1)
    print(p2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
