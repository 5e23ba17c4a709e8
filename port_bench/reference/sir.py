"""Plain reference of an ABC-SMC-PLS fit of a chain-binomial SIR epidemic
with MULTIVARIATE proposals, and its judge.

PyTorch on whatever device the caller names. It imports nothing of the
program under test: the simulator is written from its equations and its
documented column layout, the proposal from the method's description; the
ranking, the van der Voet test, the weights and the doubled variance are
:mod:`.smc`'s.

- Simulator, in float32 (the configuration's dtype). A population of
  ``population`` with ``i0`` infected steps day by day for ``t_steps``
  days. With beta = |params[0]|, gamma = clamp(|params[1]|, 1e-6, 1) and
  p_rec = 1 - exp(-gamma), day t draws new infections ~ Binomial(S, 1 -
  exp(-beta I / population)) and new recoveries ~ Binomial(I, p_rec), each
  binomial approximated as round(n p + sqrt(n p (1 - p)) z), half to even,
  clipped to [0, n]. Day t's z are the counter-hash standard normals of
  columns 2t (infections) and 2t + 1 (recoveries) of the particle's seed
  (the hash of :func:`.smc.counter_normals`, Box-Muller in float64, then
  rounded to float32). Metrics: the final size R + I, the peak prevalence
  (its first day), the peak day, the days with I > 0, the incidence's mean
  day, and the first day on which the running incidence reaches half its
  total. Every state value is a whole count below 2^24, so every float32
  sum is exact; the operations that round (exp, the binomial's mean and
  sd, the mean day) run in the order written above.
- Proposal: resample the survivors by weight and add N(0, S), S the
  survivors' covariance (n - 1 divisor) with its diagonal alone doubled,
  truncated to the prior box by rejection (after ``max_retries`` rounds a
  row falls back to its survivor), in float64.
- Weights: the prior density over the previous survivors' Gaussian kernel
  mixture with the per-parameter doubled variance (:func:`.smc.weights`),
  as for INDEPENDENT proposals: the proposal's covariance does not enter
  the weights.

:func:`judge` and :func:`control_fit` take and give a fit's sets as
:func:`.judge.judge` does, each set also carrying ``mvn_factor``, the
Cholesky factor its proposal used (None for a set that proposed nothing).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from . import judge as _judge
from . import smc

# float32 products must not run in TF32 on the card
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

NUMBERS = ("sim_err", "rank_excess", "vdv_miss", "weight_err", "dv_err",
           "chol_err", "propose_ks")
FAULTS = ("sim_step", "cov_full")

_M32 = 0xFFFFFFFF
_SEED_SALT = 0x9E3779B9
#: rows of one block of the simulator
_SIM_ROWS = 1 << 20
_SEED_HIGH = 2**31 - 1


@dataclass
class SirSpec:
    """What both sides are given: sizes, the prior box, the observed row,
    the epidemic's settings, the proposal's retry bound and the van der
    Voet test's level and window."""

    sizes: list
    keeps: list
    lo: np.ndarray
    hi: np.ndarray
    obs: np.ndarray
    population: int
    t_steps: int
    i0: int
    max_retries: int
    fraction: float
    vdv_alpha: float
    vdv_rows: int


# ------------------------------------------------------------- simulator
def _mul32(x, c: int):
    """(x * c) mod 2^32 of int64 tensors holding 32-bit values, in two
    16-bit halves of ``c`` so that no product leaves int64."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _fmix32(x):
    """murmur3's 32-bit finaliser on int64 tensors holding 32-bit values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def seed_base(seeds):
    """The per-particle word of the counter hash [n] (int64)."""
    return _fmix32((seeds.to(torch.int64) & _M32) ^ _SEED_SALT)


def counter_normal(base, col: int):
    """Standard normals [n] of column ``col``, float64: Box-Muller of the
    words of (base, 2 col) and (base, 2 col + 1)."""
    h1 = _fmix32(base ^ (2 * col))
    h2 = _fmix32(base ^ (2 * col + 1))
    u1 = (h1.to(torch.float64) + 1.0) / 2.0**32
    u2 = h2.to(torch.float64) / 2.0**32
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2)


def _binomial(n, p, z):
    mean = n * p
    sd = torch.sqrt(torch.clamp_min(n * p * (1 - p), 0.0))
    return torch.minimum(torch.clamp_min(torch.round(mean + sd * z), 0.0), n)


def _sir_block(p, seeds, population: int, t_steps: int, i0: int,
               fault_step=None):
    dt, dev, n = p.dtype, p.device, p.shape[0]
    base = seed_base(seeds)
    beta = p[:, 0].abs()
    gamma = torch.clamp(p[:, 1].abs(), 1e-6, 1.0)
    p_rec = 1.0 - torch.exp(-gamma)

    def full(v):
        return torch.full((n,), float(v), dtype=dt, device=dev)

    s, i, r = full(population - i0), full(i0), full(0)
    peak, peak_day, days, total, day_sum = (full(-math.inf), full(0),
                                            full(0), full(0), full(0))
    incidence = torch.empty((t_steps, n), dtype=dt, device=dev)
    for t in range(t_steps):
        z_inf = counter_normal(base, 2 * t).to(dt)
        # the planted fault: one day's recoveries share its infections' z
        z_rec = z_inf if t == fault_step else counter_normal(
            base, 2 * t + 1).to(dt)
        p_inf = 1.0 - torch.exp(-beta * i / population)
        new_inf = _binomial(s, p_inf, z_inf)
        new_rec = _binomial(i, p_rec, z_rec)
        s = s - new_inf
        i = i + new_inf - new_rec
        r = r + new_rec
        higher = i > peak
        peak = torch.where(higher, i, peak)
        peak_day = torch.where(higher, full(t), peak_day)
        days = days + (i > 0).to(dt)
        total = total + new_inf
        day_sum = day_sum + t * new_inf
        incidence[t] = new_inf
    mean_day = day_sum / torch.clamp_min(total, 1.0)
    half = (torch.cumsum(incidence, dim=0) < (total / 2)[None, :]).sum(0)
    return torch.stack([r + i, peak, peak_day, days, mean_day,
                        half.to(dt)], dim=1)


def simulate(params, seeds, population: int, t_steps: int, i0: int,
             device="cpu", fault_step=None):
    """Metrics [n, 6] float32 on ``device`` of ``params`` [n, 2] and their
    seeds, in blocks of rows (a row's metrics depend on its own parameters
    and seed alone). ``fault_step``: the day whose recoveries take the
    infections' normal (a planted fault)."""
    p = torch.as_tensor(np.asarray(params, np.float64)).to(device,
                                                           torch.float32)
    s = torch.as_tensor(np.asarray(seeds).astype(np.int64)).to(device)
    return torch.cat([
        _sir_block(p[a:a + _SIM_ROWS], s[a:a + _SIM_ROWS], population,
                   t_steps, i0, fault_step)
        for a in range(0, p.shape[0], _SIM_ROWS)])


# -------------------------------------------------------------- proposal
def survivor_covariance(surv):
    """The survivors' covariance [P, P] (n - 1 divisor)."""
    c = surv - surv.mean(0)[None, :]
    return c.T @ c / max(surv.shape[0] - 1, 1)


def mvn_factor(surv, fault=None):
    """Lower Cholesky factor of the proposal's covariance: the survivors'
    covariance with its diagonal alone doubled (``fault="cov_full"``:
    the whole matrix doubled)."""
    cov = survivor_covariance(surv)
    if fault == "cov_full":
        cov = 2.0 * cov
    else:
        cov = cov + torch.diag(torch.diagonal(cov))
    return torch.linalg.cholesky(cov)


def propose(surv, w, factor, lo, hi, n: int, generator, max_retries: int):
    """``n`` rows of the proposal: survivors drawn by weight, moved by
    N(0, factor factor') truncated to [lo, hi] by rejection."""
    dev, dt = surv.device, surv.dtype
    mu = surv[torch.multinomial(w, n, replacement=True,
                                generator=generator)]
    out = mu.clone()
    todo = torch.arange(n, device=dev)
    for _ in range(max_retries):
        z = torch.randn((todo.shape[0], surv.shape[1]), generator=generator,
                        dtype=dt, device=dev)
        x = mu[todo] + z @ factor.T
        ok = ((x >= lo) & (x <= hi)).all(1)
        out[todo[ok]] = x[ok]
        todo = todo[~ok]
        if todo.numel() == 0:
            break
    return out


def ks_two_sample(a, b) -> float:
    """Kolmogorov-Smirnov distance of two 1-D samples."""
    a, _ = torch.sort(a)
    b, _ = torch.sort(b)
    x = torch.cat([a, b])
    fa = torch.searchsorted(a, x, right=True).to(torch.float64) / a.shape[0]
    fb = torch.searchsorted(b, x, right=True).to(torch.float64) / b.shape[0]
    return float((fa - fb).abs().max())


def _t(x, device):
    return torch.as_tensor(np.asarray(x, np.float64), device=device)


# ----------------------------------------------------------------- judge
def judge(sets, spec: SirSpec, device, seed: int, n_ks: int,
          n_ref: int) -> dict:
    """The worst of each of :data:`NUMBERS` over one fit's sets:

    - ``sim_err``: max |metric - reference metric| / (1 + |reference
      metric|), the reference simulator run on each stored row;
    - ``rank_excess``, ``vdv_miss``, ``weight_err``, ``dv_err``: as
      :func:`.judge.judge` has them;
    - ``chol_err``: max |L - reference L| / max |reference L| of the
      Cholesky factor each proposing set used (infinite where a set gave
      none), the reference's from the stored survivors in float64;
    - ``propose_ks``: set 0, each column of a sample of ``n_ks`` rows
      against the prior's CDF; later sets, the same sample's columns and
      its projections on both principal axes of the survivors' covariance
      against ``n_ref`` rows that the reference proposes from set t - 1's
      survivors, weights and factor (two-sample distances: a single
      column does not see a wrong off-diagonal)."""
    lo, hi = _t(spec.lo, device), _t(spec.hi, device)
    pick = torch.Generator(device="cpu")
    pick.manual_seed(int(seed) & 0x7FFFFFFFFFFFFFFF)
    draw = torch.Generator(device=device)
    draw.manual_seed((int(seed) ^ 0x5EED) & 0x7FFFFFFFFFFFFFFF)
    out = dict.fromkeys(NUMBERS, 0.0)

    def worse(key, val):
        val = float(val)
        if not math.isfinite(val) or val > out[key]:
            out[key] = val if math.isfinite(val) else math.inf

    prev = None          # (survivor params, reference w, dv, factor)
    for t, s in enumerate(sets):
        params = _t(s["params"], device)
        mets = _t(s["metrics"], device)
        n, keep = params.shape[0], spec.keeps[t]
        if n != spec.sizes[t] or len(s["survivors"]) != keep:
            worse("rank_excess", math.inf)
            return out
        # the proposal that made these rows, in law
        rows = params[torch.randperm(n, generator=pick)[:n_ks].to(device)]
        if prev is None:
            for c in range(params.shape[1]):
                a, b = float(lo[c]), float(hi[c])
                worse("propose_ks", smc.ks_distance(
                    rows[:, c], lambda x: torch.clamp((x - a) / (b - a),
                                                      0.0, 1.0)))
        else:
            ref_rows = propose(prev[0], prev[1], prev[3], lo, hi, n_ref,
                               draw, spec.max_retries)
            axes = torch.linalg.eigh(survivor_covariance(prev[0]))[1]
            for a, b in ((rows, ref_rows), (rows @ axes, ref_rows @ axes)):
                for c in range(a.shape[1]):
                    worse("propose_ks", ks_two_sample(a[:, c], b[:, c]))
            del ref_rows
        # the simulator
        ref = simulate(s["params"], s["seeds"], spec.population,
                       spec.t_steps, spec.i0, device).to(torch.float64)
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
        # variance, factor and weights, worked out again along the chain
        sp = params[surv]
        dv = smc.doubled_variance(sp)
        live = dv > 0
        worse("dv_err", ((_t(s["dv"], device) - dv).abs()[live]
                         / dv[live]).max() if live.any() else 0.0)
        factor = mvn_factor(sp)
        if t + 1 < len(sets):
            got = s.get("mvn_factor")
            worse("chol_err", math.inf if got is None else (
                (_t(got, device) - factor).abs().max()
                / factor.abs().max()))
        if prev is None:
            w = torch.full((keep,), 1.0 / keep, dtype=dv.dtype, device=device)
        else:
            w = smc.weights(sp, prev[0], prev[1], prev[2], lo, hi)
        wp = _t(s["weights"], device)
        wp = wp / wp.sum()
        worse("weight_err", (wp - w).abs().max() / w.max())
        prev = (sp, w, dv, factor)
        del params, mets
    return out


def control_fit(spec: SirSpec, seed: int, device, rounding="tf32",
                fault=None):
    """The reference in the program's place: a whole fit whose every stage
    hands on its results rounded to ``rounding`` ("tf32", "bf16" or None;
    the simulator runs in float32, the rest in float64). Faults
    (:data:`FAULTS`): ``"sim_step"`` simulates with one day's recoveries
    drawn from that day's infection normal; ``"cov_full"`` proposes with
    the survivors' whole covariance doubled, not its diagonal alone.
    Returns the fit's sets in the format :func:`judge` takes."""
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
    sets, prev = [], None
    for t, (n, keep) in enumerate(zip(spec.sizes, spec.keeps)):
        seeds = torch.randint(0, _SEED_HIGH, (n,), generator=g,
                              device=device).cpu().numpy().astype(np.uint64)
        mets = rnd(simulate(params.cpu().numpy(), seeds, spec.population,
                            spec.t_steps, spec.i0, device,
                            spec.t_steps // 2 if fault == "sim_step"
                            else None).to(torch.float64))
        ncomp = smc.vdv_components(
            smc.vdv_statistics(params, mets, spec.fraction, spec.vdv_rows),
            spec.vdv_alpha)
        d = rnd(smc.distances(params, mets, spec.obs, spec.fraction, ncomp))
        surv = torch.topk(-d, keep).indices
        sp = params[surv]
        dv = rnd(smc.doubled_variance(sp))
        w = (torch.full((keep,), 1.0 / keep, dtype=torch.float64,
                        device=device) if prev is None
             else rnd(smc.weights(sp, *prev, lo, hi)))
        last = t + 1 == len(spec.sizes)
        factor = None if last else rnd(mvn_factor(sp, fault))
        sets.append({"params": params.cpu().numpy(), "seeds": seeds,
                     "metrics": mets.cpu().numpy(),
                     "survivors": surv.cpu().numpy(),
                     "weights": w.cpu().numpy(), "dv": dv.cpu().numpy(),
                     "ncomp": ncomp,
                     "mvn_factor": None if last else factor.cpu().numpy()})
        prev = (sp, w, dv)
        if last:
            break
        params = rnd(propose(sp, w, factor, lo, hi, spec.sizes[t + 1], g,
                             spec.max_retries))
    return sets
