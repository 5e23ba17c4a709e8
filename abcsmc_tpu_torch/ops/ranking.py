"""Particle ranking, the filtering step of the host engine (port of
:mod:`abcsmc_tpu.ops.ranking`; the two schemes are documented there):

- SIMPLE (src/AbcUtil.cpp:408-421): rank by euclidean distance of the
  z-scored metrics to the z-scored observed row;
- PLS (src/AbcUtil.cpp:423-458): z-score metrics and parameters, fit PLS on
  the first round(n * training_fraction) rows, choose the component count on
  the rest, rank by distance in score space.

Every function runs on the device and dtype of its inputs. Both rankings
return the full stable ascending order and the distances; the PLS ranking
also returns its component count (the JAX function returns the first two).
"""

from __future__ import annotations

import torch

from abcsmc_tpu_torch.ops import pls as pls_mod
from abcsmc_tpu_torch.ops import stats

#: the sign-stream seed of the host ranking's van der Voet test: the JAX
#: ranking passes ``jax.random.PRNGKey(0)``, and ``pls.vdv_seed`` of that
#: key is this uint32 (pinned by a test that computes it with JAX)
HOST_VDV_SEED = 4151515373


def apply_box_cox(metric_vals, obs_row):
    """Per-column Box-Cox transform of the metrics and the observed row, each
    lambda chosen by skewness minimization after a shift to positivity."""
    x = torch.as_tensor(metric_vals)
    obs = torch.as_tensor(obs_row).to(x)
    cols, obs_out = [], []
    for j in range(x.shape[1]):
        col, o = x[:, j], obs[j]
        mn = torch.minimum(col.min(), o)
        shift = torch.where(mn <= 0, 1e-6 - mn, torch.zeros_like(mn))
        lam = stats.optimize_box_cox(col + shift)
        cols.append(stats.box_cox(col + shift, lam))
        obs_out.append(stats.box_cox(o + shift, lam))
    return torch.stack(cols, dim=1), torch.stack(obs_out)


def _guard_sd(sds):
    """A constant column is unit-scale (the reference divides by 0)."""
    return torch.where(sds == 0, torch.ones_like(sds), sds)


def _z(x):
    means = x.mean(dim=0)
    sds = _guard_sd(stats.colwise_stdev(x, means))
    return (x - means[None, :]) / sds[None, :], means, sds


def ranking_simple(metric_vals, obs_row):
    """Full ascending order of particles by z-scored metric distance."""
    x = torch.as_tensor(metric_vals)
    z, means, sds = _z(x)
    obs = (torch.as_tensor(obs_row).to(x) - means) / sds
    dists = stats.euclidean(z, obs)
    return stats.ordered(dists), dists


def pls_scores_for_ranking(metric_vals, param_vals, obs_row,
                           training_fraction: float,
                           max_components: int | None = None,
                           optimal_method: str = "vdv"):
    """Fit, component selection and projection: returns (sim_scores [n, A],
    obs_scores [A], ncomp_used). ``optimal_method`` is "vdv" (van der Voet
    with the fixed seed :data:`HOST_VDV_SEED`) or "tolerance" (PRESS within
    10 % of its minimum)."""
    x = torch.as_tensor(metric_vals)
    y = torch.as_tensor(param_vals).to(x)
    n = x.shape[0]
    z_met, met_means, met_sds = _z(x)
    z_par, _, _ = _z(y)
    obs_met = (torch.as_tensor(obs_row).to(x) - met_means) / met_sds

    # round to nearest, as C round (src/AbcUtil.cpp:438)
    n_train = int(n * training_fraction + 0.5)
    n_train = min(max(n_train, 1), n - 1)

    model = pls_mod.fit(z_met[:n_train], z_par[:n_train], ncomp=max_components)
    if optimal_method == "vdv":
        # absolute row indices: the sign stream is a function of the global
        # row index, as in the generation step
        counts = pls_mod.optimal_num_components_vdv(
            model, z_met[n_train:], z_par[n_train:], HOST_VDV_SEED,
            gidx=torch.arange(n_train, n, device=x.device),
        )
    else:
        em = model.cv_new_data(z_met[n_train:], z_par[n_train:])
        counts = pls_mod.optimal_num_components(em)
    ncomp_used = int(counts.max())
    obs_scores = model.scores(obs_met[None, :], ncomp_used)[0]
    sim_scores = model.scores(z_met, ncomp_used)
    return sim_scores, obs_scores, ncomp_used


def ranking_pls(metric_vals, param_vals, obs_row, training_fraction: float,
                max_components: int | None = None, box_cox: bool = False,
                optimal_method: str = "vdv"):
    """Full ascending order of particles by PLS-score distance, the
    distances and the component count used."""
    assert 0.0 < training_fraction <= 1.0
    if box_cox:
        metric_vals, obs_row = apply_box_cox(metric_vals, obs_row)
    sim_scores, obs_scores, ncomp = pls_scores_for_ranking(
        metric_vals, param_vals, obs_row, training_fraction, max_components,
        optimal_method,
    )
    dists = stats.euclidean(sim_scores, obs_scores)
    order = stats.ordered(dists)
    return order, dists, ncomp


def top_k_from_distances(dists, k: int):
    """Indices of the k smallest distances, ascending."""
    return torch.topk(-torch.as_tensor(dists), k, sorted=True).indices
