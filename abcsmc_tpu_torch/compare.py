"""Posterior comparison between two run databases.

Statistical-parity harness: given two runs of the "same" analysis (e.g. this
engine vs the C++ reference, or two seeds), compare the final predictive
priors per parameter with (unweighted) survivor-set summaries and a
two-sample Kolmogorov-Smirnov distance. Importance weights are not stored in
the database schema, so the comparison treats survivors as equal-role samples
- the same convention the reference's R diagnostics use. Usage:

    python -m abcsmc_tpu_torch.compare a.sqlite b.sqlite
"""

from __future__ import annotations

import json
import sys

import numpy as np

from abcsmc_tpu_torch.storage.sqlite_store import SQLiteStorage


def _final_posterior(db_path: str):
    store = SQLiteStorage(db_path)
    gens = store.read_generations()
    store.close()
    ranked = [g for g in gens if g.has_posterior]
    if not ranked:
        raise ValueError(f"{db_path}: no ranked (posterior > -1) set")
    gen = ranked[-1]
    surv = gen.predictive_prior_indices()
    return store.par_names, gen.params[surv]


def ks_distance(a: np.ndarray, b: np.ndarray) -> float:
    """Two-sample KS statistic (unweighted; predictive priors are the
    equal-role survivor sets)."""
    allv = np.sort(np.concatenate([a, b]))
    cdf_a = np.searchsorted(np.sort(a), allv, side="right") / len(a)
    cdf_b = np.searchsorted(np.sort(b), allv, side="right") / len(b)
    return float(np.abs(cdf_a - cdf_b).max())


def compare(db_a: str, db_b: str) -> dict:
    names_a, post_a = _final_posterior(db_a)
    names_b, post_b = _final_posterior(db_b)
    if names_a != names_b:
        raise ValueError(f"parameter mismatch: {names_a} vs {names_b}")
    out = {}
    for j, name in enumerate(names_a):
        a, b = post_a[:, j], post_b[:, j]
        pooled_sd = np.sqrt((a.var(ddof=1) + b.var(ddof=1)) / 2) or 1.0
        out[name] = {
            "mean_a": float(a.mean()),
            "mean_b": float(b.mean()),
            "mean_diff_in_sd": float(abs(a.mean() - b.mean()) / pooled_sd),
            "sd_a": float(a.std(ddof=1)),
            "sd_b": float(b.std(ddof=1)),
            "ks": ks_distance(a, b),
        }
    return out


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 2:
        print("usage: python -m abcsmc_tpu_torch.compare a.sqlite b.sqlite")
        return 1
    print(json.dumps(compare(argv[0], argv[1]), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
