"""The comparison that decides ``correct``: a fit's sets, as the program
stored them, held against the plain reference (:mod:`.smc`), and the
control that stands in for the program at a lower precision.

A fit is a list of sets, each a dict of host arrays:
``params`` [N, P], ``seeds`` [N], ``metrics`` [N, M], ``survivors`` [K]
(row indices in rank order), ``weights`` [K] (any positive scale),
``dv`` [P] and ``ncomp`` (the PLS components the ranking used).

The proposal and the van der Voet choice of ``ncomp`` are random, so the
reference follows the fit set by set from the rows the program stored:
set t's ranking is recomputed at the program's ``ncomp`` from set t's stored
parameters and metrics, that ``ncomp`` is held against the van der Voet
test's own statistics, and set t + 1's rows are judged in law against the
mixture that the reference builds from set t's survivors, with weights and
variances that the reference works out again along the whole chain. Set 0's
rows are judged against the prior.

Numbers, each the worst over the fit's sets:

- ``sim_err``: max |metric - reference metric| / (1 + |reference metric|);
- ``rank_excess``: (largest reference distance among the program's
  survivors - the reference's K-th least distance) / the K-th least: 0 when
  the program kept exactly the reference's survivors;
- ``vdv_miss``: how far, in units of the test's z, the program's ``ncomp``
  lies from every count the van der Voet rule could choose
  (:func:`.smc.vdv_miss`): 0 when it is one of them;
- ``weight_err``: max |w - reference w| / max reference w, both summing
  to 1;
- ``dv_err``: max |dv - reference dv| / reference dv;
- ``propose_ks``: the largest Kolmogorov-Smirnov distance of a column of a
  sample of the proposed rows from the reference mixture's CDF.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from . import smc

NUMBERS = ("sim_err", "rank_excess", "vdv_miss", "weight_err", "dv_err",
           "propose_ks")


@dataclass
class FitSpec:
    """What both sides are given: sizes, the prior box, the observed row,
    the simulator's settings and the van der Voet test's (its level and
    its window of rows)."""

    sizes: list
    keeps: list
    lo: np.ndarray
    hi: np.ndarray
    obs: np.ndarray
    mix: np.ndarray
    noise_sd: float
    fraction: float
    vdv_alpha: float
    vdv_rows: int


def _t(x, device):
    return torch.as_tensor(np.asarray(x, np.float64), device=device)


def judge(sets, spec: FitSpec, device, seed: int, n_ks: int) -> dict:
    """The numbers of one fit (see the module's docstring)."""
    lo, hi = _t(spec.lo, device), _t(spec.hi, device)
    pick = torch.Generator(device="cpu")
    pick.manual_seed(int(seed) & 0x7FFFFFFFFFFFFFFF)
    out = dict.fromkeys(NUMBERS, 0.0)

    def worse(key, val):
        val = float(val)
        if not math.isfinite(val) or val > out[key]:
            out[key] = val if math.isfinite(val) else math.inf

    prev = None          # (survivor params, reference w, reference dv)
    for t, s in enumerate(sets):
        params = _t(s["params"], device)
        mets = _t(s["metrics"], device)
        n, keep = params.shape[0], spec.keeps[t]
        if n != spec.sizes[t] or len(s["survivors"]) != keep:
            worse("rank_excess", math.inf)
            return out
        # the proposal that made these rows, in law
        sample = torch.randperm(n, generator=pick)[:n_ks].to(device)
        rows = params[sample]
        for c in range(params.shape[1]):
            if prev is None:
                a, b = float(lo[c]), float(hi[c])
                worse("propose_ks", smc.ks_distance(
                    rows[:, c], lambda x: torch.clamp((x - a) / (b - a),
                                                      0.0, 1.0)))
            elif prev[2][c] > 0:
                cen, w, sd = prev[0][:, c], prev[1], torch.sqrt(prev[2][c])
                worse("propose_ks", smc.ks_distance(
                    rows[:, c], lambda x: smc.mixture_cdf(
                        x, cen, w, sd, float(lo[c]), float(hi[c]))))
        # the simulator
        ref = smc.simulate(s["params"], s["seeds"], spec.mix, spec.noise_sd,
                           device)
        worse("sim_err", ((mets - ref).abs() / (1.0 + ref.abs())).max())
        del ref
        # the ranking, at the program's component count
        surv = torch.as_tensor(np.asarray(s["survivors"], np.int64),
                               device=device)
        if torch.unique(surv).numel() != keep or surv.min() < 0 \
                or surv.max() >= n:
            worse("rank_excess", math.inf)
            return out
        d = smc.distances(params, mets, spec.obs, spec.fraction,
                          int(s["ncomp"]))
        kth = torch.kthvalue(d, keep).values
        worse("rank_excess", (d[surv].max() - kth) / kth)
        del d
        # the component count, against the test that chose it
        worse("vdv_miss", smc.vdv_miss(
            smc.vdv_statistics(params, mets, spec.fraction, spec.vdv_rows),
            abs(int(s["ncomp"])), spec.vdv_alpha))
        # variance and weights, worked out again along the chain
        sp = params[surv]
        dv = smc.doubled_variance(sp)
        live = dv > 0
        worse("dv_err", ((_t(s["dv"], device) - dv).abs()[live]
                         / dv[live]).max() if live.any() else 0.0)
        if prev is None:
            w = torch.full((keep,), 1.0 / keep, dtype=dv.dtype, device=device)
        else:
            w = smc.weights(sp, prev[0], prev[1], prev[2], lo, hi)
        wp = _t(s["weights"], device)
        wp = wp / wp.sum()
        worse("weight_err", (wp - w).abs().max() / w.max())
        prev = (sp, w, dv)
        del params, mets
    return out


def round_tf32(x):
    """``x`` rounded to TF32 (float32 with a 10-bit mantissa, to nearest),
    returned as float64."""
    bits = x.to(torch.float32).view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32).to(torch.float64)


def control_fit(spec: FitSpec, seed: int, device, rounding="tf32",
                fault=None):
    """The reference in the program's place: a whole fit whose every stage
    hands on its results rounded to ``rounding`` ("tf32", "bf16" or None
    for float64). ``fault="unchanged"`` makes every proposal return the
    set's own rows (a step that leaves its state unchanged);
    ``"ncomp_low"`` ranks every set at one component, whatever the van der
    Voet test says. Returns the
    fit's sets in the format :func:`judge` takes."""

    if fault not in (None, "unchanged", "ncomp_low"):
        raise ValueError(f"unknown fault {fault!r}")

    def rnd(x):
        if rounding is None:
            return x
        if rounding == "tf32":
            return round_tf32(x)
        return x.to(torch.bfloat16).to(torch.float64)

    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & 0x7FFFFFFFFFFFFFFF)
    lo, hi = _t(spec.lo, device), _t(spec.hi, device)
    npar = lo.shape[0]
    n = spec.sizes[0]
    params = rnd(lo + (hi - lo) * torch.rand((n, npar), generator=g,
                                             dtype=torch.float64,
                                             device=device))
    seeds = torch.randint(0, 2**31 - 1, (n,), generator=g, device=device)
    sets, prev = [], None
    for t, (n, keep) in enumerate(zip(spec.sizes, spec.keeps)):
        seeds_h = seeds.cpu().numpy().astype(np.uint64)
        mets = rnd(smc.simulate(params.cpu().numpy(), seeds_h, spec.mix,
                                spec.noise_sd, device))
        z = smc.vdv_statistics(params, mets, spec.fraction, spec.vdv_rows)
        ncomp = (1 if fault == "ncomp_low"
                 else smc.vdv_components(z, spec.vdv_alpha))
        del z
        d = rnd(smc.distances(params, mets, spec.obs, spec.fraction, ncomp))
        surv = torch.topk(-d, keep).indices
        sp = params[surv]
        dv = rnd(smc.doubled_variance(sp))
        w = (torch.full((keep,), 1.0 / keep, dtype=torch.float64,
                        device=device) if prev is None
             else rnd(smc.weights(sp, *prev, lo, hi)))
        sets.append({"params": params.cpu().numpy(), "seeds": seeds_h,
                     "metrics": mets.cpu().numpy(),
                     "survivors": surv.cpu().numpy(),
                     "weights": w.cpu().numpy(), "dv": dv.cpu().numpy(),
                     "ncomp": ncomp})
        prev = (sp, w, dv)
        if t + 1 == len(spec.sizes):
            break
        n2 = spec.sizes[t + 1]
        if fault == "unchanged":
            params = params[torch.arange(n2, device=device) % n]
            seeds = torch.randint(0, 2**31 - 1, (n2,), generator=g,
                                  device=device)
            continue
        mu = sp[torch.multinomial(w, n2, replacement=True, generator=g)]
        sd = torch.sqrt(dv)[None, :]
        a = torch.special.ndtr((lo[None, :] - mu) / sd)
        b = torch.special.ndtr((hi[None, :] - mu) / sd)
        u = torch.rand(mu.shape, generator=g, dtype=torch.float64,
                       device=device)
        z = torch.special.ndtri(torch.clamp(a + u * (b - a), 1e-300,
                                            1.0 - 1e-16))
        params = rnd(torch.clamp(mu + sd * z, lo, hi))
        seeds = torch.randint(0, 2**31 - 1, (n2,), generator=g,
                              device=device)
    return sets
