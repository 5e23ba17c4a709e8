"""Plain reference of an ABC-SMC-PLS fit of Wood's Ricker map with Poisson
observations and INDEPENDENT proposals, and its judge.

PyTorch on whatever device the caller names. It imports nothing of the
program under test: the simulator is written from its equations and its
documented column layout; the ranking, the van der Voet test, the weights,
the doubled variance and the proposal's law are :mod:`.smc`'s, and the
counter hash's words are :mod:`.sir`'s.

- Simulator, in float32 (the configuration's dtype), in this operation
  order. With r = exp(clamp(log_r, 0, 6)), sigma = clamp(|sigma|, 1e-3, 2)
  and phi = clamp(|phi|, 1e-2, 50), the population starts at ``n0`` and
  steps ``burn_in + t_steps`` times, N <- clamp(r N exp(-N + sigma e),
  1e-9, 1e6); after the burn-in each step observes y ~ Poisson(phi N). The
  draw: with lam = phi N, above a mean of 10 the rounded normal
  max(round(lam + sqrt(lam) g), 0), half to even; else the inverse CDF on
  the grid k = 0 .. 23: lam' = min(lam, 20), pmf_k = exp(k log(max(lam',
  1e-9)) - lam' - lgamma(k + 1)), a running sum over k, and the first k
  whose sum reaches u, or 23 where u lies past the grid's last sum. Step t
  reads the counter-hash normals e = column 2t and g = column 2t + 1
  (Box-Muller in float64, rounded to float32) and the counter-hash uniform
  u = column t under a salt of its own (rounded to float32, and below 1).
  Metrics of the observed series: its mean, its sd (n - 1), its lag-1 and
  lag-2 autocorrelations over the sum of squares, its zeros and its
  maximum, each sum a fixed binary tree of adds over the series, zero
  padded to a power of two, so that a row's bits do not depend on its
  batch.
- Proposal: resample the survivors by weight and perturb each column by a
  normal of the doubled variance truncated to the prior box, judged in law
  against that mixture's exact CDF (:func:`.smc.mixture_cdf`).
- Weights: the prior density over the previous survivors' kernel mixture
  (:func:`.smc.weights`).

The map is chaotic at the configuration's log r of 3.8: a difference of one
unit in the last place grows by about e^0.4 a step, and one count of the
series off moves the mean by 1 / t_steps. So ``sim_err`` compares a
stored row with this simulator in float32 on the same card, where the same
operations give the same bits and a sound row reads 0. A float64 reference
cannot stand in: it follows another trajectory after a few dozen steps, and
its metrics differ from any float32 program's at O(1).

:func:`judge` and :func:`control_fit` take and give a fit's sets as
:func:`.judge.judge` does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from . import judge as _judge
from . import smc
from .sir import _fmix32, seed_base

# float32 products must not run in TF32 on the card
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

NUMBERS = ("sim_err", "rank_excess", "vdv_miss", "weight_err", "dv_err",
           "propose_ks")
#: faults :func:`control_fit` plants: ``noise`` drops the process noise
#: (N <- r N exp(-N)); ``unclamped`` gives a draw past the grid 24, not 23;
#: ``unchanged`` and ``ncomp_low`` as :func:`.judge.control_fit`
FAULTS = ("noise", "unclamped", "unchanged", "ncomp_low")

_M32 = 0xFFFFFFFF
_UNIFORM_SALT = 0x85EBCA6B
_GRID = 24
#: rows of one block of the simulator
_SIM_ROWS = 1 << 20
_SEED_HIGH = 2**31 - 1


@dataclass
class RickerSpec:
    """What both sides are given: sizes, the prior box, the observed row,
    the map's settings and the van der Voet test's level and window."""

    sizes: list
    keeps: list
    lo: np.ndarray
    hi: np.ndarray
    obs: np.ndarray
    t_steps: int
    burn_in: int
    n0: float
    fraction: float
    vdv_alpha: float
    vdv_rows: int


# ------------------------------------------------------------- simulator
def step_normals(base, t: int):
    """The two standard normals [n, 2] of step ``t`` (columns 2t and
    2t + 1) in float64: Box-Muller of the words (base, 2 col) and (base,
    2 col + 1)."""
    col = torch.tensor([2 * t, 2 * t + 1], dtype=torch.int64,
                       device=base.device)
    h1 = _fmix32(base[:, None] ^ (2 * col)[None, :])
    h2 = _fmix32(base[:, None] ^ (2 * col + 1)[None, :])
    u1 = (h1.to(torch.float64) + 1.0) / 2.0**32
    u2 = h2.to(torch.float64) / 2.0**32
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2)


def step_uniform(ubase, t: int, dtype):
    """The unit uniform [n, 1] of step ``t`` in ``dtype``: the word of
    (ubase, t) over 2^32, rounded, and kept below 1."""
    col = torch.tensor([t], dtype=torch.int64, device=ubase.device)
    u = (_fmix32(ubase[:, None] ^ col[None, :]).to(torch.float64)
         / 2.0**32).to(dtype)
    return torch.clamp_max(u, 1.0 - torch.finfo(dtype).eps / 2)


def _tree(x):
    """Sum over the last axis by halving, zero-padded to a power of two."""
    n = x.shape[-1]
    width = 1 << max(n - 1, 0).bit_length()
    x = torch.nn.functional.pad(x, (0, width - n))
    while width > 1:
        width //= 2
        x = x[..., :width] + x[..., width:]
    return x[..., 0]


def _ricker_block(p, seeds, t_steps: int, burn_in: int, n0: float,
                  fault=None):
    """Metrics [n, 6] and (grid draws, clamped grid draws) of one block."""
    dt, dev, n = p.dtype, p.device, p.shape[0]
    base = seed_base(seeds)
    ubase = _fmix32((seeds.to(torch.int64) & _M32) ^ _UNIFORM_SALT)
    r = torch.exp(torch.clamp(p[:, 0], 0.0, 6.0))
    sigma = torch.clamp(p[:, 1].abs(), 1e-3, 2.0)
    phi = torch.clamp(p[:, 2].abs(), 1e-2, 50.0)
    k = torch.arange(_GRID, dtype=dt, device=dev)
    log_fact = torch.lgamma(k + 1.0)
    k_idx = torch.arange(_GRID, device=dev)
    past_value = float(_GRID if fault == "unclamped" else _GRID - 1)
    pop = torch.full((n,), n0, dtype=dt, device=dev)
    ys = torch.empty((n, t_steps), dtype=dt, device=dev)
    grid_draws = clamped_draws = torch.zeros((), dtype=torch.int64,
                                             device=dev)
    for t in range(burn_in + t_steps):
        z = step_normals(base, t).to(dt)
        u = step_uniform(ubase, t, dt)[:, 0]
        noise = 0.0 if fault == "noise" else sigma * z[:, 0]
        pop = torch.clamp(r * pop * torch.exp(-pop + noise), 1e-9, 1e6)
        if t < burn_in:
            continue
        lam = phi * pop
        lam_s = torch.clamp_max(lam, 20.0)
        log_lam = torch.log(torch.clamp_min(lam_s, 1e-9))
        logpmf = (k[None, :] * log_lam[:, None] - lam_s[:, None]
                  - log_fact[None, :])
        cdf = torch.cumsum(torch.exp(logpmf), dim=1)
        first = torch.where(cdf >= u[:, None], k_idx[None, :],
                            _GRID).amin(dim=1).to(dt)
        past = u > cdf[:, -1]
        on_grid = torch.where(past, torch.full_like(first, past_value),
                              first)
        normal = torch.clamp_min(
            torch.round(lam + torch.sqrt(lam) * z[:, 1]), 0.0)
        big = lam > 10.0
        ys[:, t - burn_in] = torch.where(big, normal, on_grid)
        grid_draws = grid_draws + (~big).sum()
        clamped_draws = clamped_draws + (past & ~big).sum()
    mean = _tree(ys) / t_steps
    yc = ys - mean[:, None]
    ss = _tree(yc * yc)
    sd = torch.sqrt(torch.clamp_min(ss / (t_steps - 1), 0.0))
    denom = torch.clamp_min(ss, 1e-9)
    ac1 = _tree(yc[:, 1:] * yc[:, :-1]) / denom
    ac2 = _tree(yc[:, 2:] * yc[:, :-2]) / denom
    zeros = _tree((ys == 0).to(dt))
    mets = torch.stack([mean, sd, ac1, ac2, zeros, ys.amax(dim=1)], dim=1)
    return mets, (grid_draws, clamped_draws)


def simulate(params, seeds, t_steps: int, burn_in: int, n0: float,
             device="cpu", fault=None, counts: list | None = None,
             dtype=torch.float32):
    """Metrics [n, 6] in ``dtype`` (the configuration's float32 unless a
    test asks for another) on ``device`` of ``params`` [n, 3] and their
    seeds, in blocks of rows (a row's metrics depend on its own parameters
    and seed alone). ``fault``: "noise" or "unclamped" (:data:`FAULTS`).
    ``counts``, where given, gets [grid draws, clamped grid draws] added."""
    p = torch.as_tensor(np.asarray(params, np.float64)).to(device, dtype)
    s = torch.as_tensor(np.asarray(seeds).astype(np.int64)).to(device)
    out = []
    for a in range(0, p.shape[0], _SIM_ROWS):
        mets, got = _ricker_block(p[a:a + _SIM_ROWS], s[a:a + _SIM_ROWS],
                                  t_steps, burn_in, n0, fault)
        out.append(mets)
        if counts is not None:
            counts[0] += int(got[0])
            counts[1] += int(got[1])
    return torch.cat(out)


def _t(x, device):
    return torch.as_tensor(np.asarray(x, np.float64), device=device)


# ----------------------------------------------------------------- judge
def judge(sets, spec: RickerSpec, device, seed: int, n_ks: int) -> dict:
    """The worst of each of :data:`NUMBERS` over one fit's sets, as
    :func:`.judge.judge` has them, with ``sim_err`` = max |metric -
    reference metric| / (1 + |reference metric|) from this module's
    simulator run on each stored row."""
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
        rows = params[torch.randperm(n, generator=pick)[:n_ks].to(device)]
        for c in range(params.shape[1]):
            a, b = float(lo[c]), float(hi[c])
            if prev is None:
                worse("propose_ks", smc.ks_distance(
                    rows[:, c], lambda x: torch.clamp((x - a) / (b - a),
                                                      0.0, 1.0)))
            elif prev[2][c] > 0:
                cen, w, sd = prev[0][:, c], prev[1], torch.sqrt(prev[2][c])
                worse("propose_ks", smc.ks_distance(
                    rows[:, c], lambda x: smc.mixture_cdf(x, cen, w, sd,
                                                          a, b)))
        del rows
        # the simulator
        ref = simulate(s["params"], s["seeds"], spec.t_steps, spec.burn_in,
                       spec.n0, device).to(torch.float64)
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


def control_fit(spec: RickerSpec, seed: int, device, rounding="tf32",
                fault=None):
    """The reference in the program's place: a whole fit whose every stage
    hands on its results rounded to ``rounding`` ("tf32", "bf16" or None;
    the simulator runs in float32, the rest in float64), or with one of
    :data:`FAULTS` planted. Returns the fit's sets in the format
    :func:`judge` takes."""
    if fault not in (None, *FAULTS):
        raise ValueError(f"unknown fault {fault!r}")

    def rnd(x):
        if rounding is None:
            return x
        if rounding == "tf32":
            return _judge.round_tf32(x)
        return x.to(torch.bfloat16).to(torch.float64)

    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & 0x7FFFFFFFFFFFFFFF)
    lo, hi = _t(spec.lo, device), _t(spec.hi, device)
    n = spec.sizes[0]
    params = rnd(lo + (hi - lo) * torch.rand((n, lo.shape[0]), generator=g,
                                             dtype=torch.float64,
                                             device=device))
    sim_fault = fault if fault in ("noise", "unclamped") else None
    sets, prev = [], None
    for t, (n, keep) in enumerate(zip(spec.sizes, spec.keeps)):
        seeds = torch.randint(0, _SEED_HIGH, (n,), generator=g,
                              device=device).cpu().numpy().astype(np.uint64)
        mets = rnd(simulate(params.cpu().numpy(), seeds, spec.t_steps,
                            spec.burn_in, spec.n0, device,
                            sim_fault).to(torch.float64))
        ncomp = (1 if fault == "ncomp_low" else smc.vdv_components(
            smc.vdv_statistics(params, mets, spec.fraction, spec.vdv_rows),
            spec.vdv_alpha))
        d = rnd(smc.distances(params, mets, spec.obs, spec.fraction, ncomp))
        surv = torch.topk(-d, keep).indices
        sp = params[surv]
        dv = rnd(smc.doubled_variance(sp))
        w = (torch.full((keep,), 1.0 / keep, dtype=torch.float64,
                        device=device) if prev is None
             else rnd(smc.weights(sp, *prev, lo, hi)))
        sets.append({"params": params.cpu().numpy(), "seeds": seeds,
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
    return sets
