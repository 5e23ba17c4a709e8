"""One SMC generation on one device (port of
:class:`abcsmc_tpu.parallel.generation.ShardedGeneration`, resident
single-device path).

Stages, in order (the JAX line numbers name the counterpart):
simulate -> mask padding rows (688-691) -> dual-frame z-score moments
(90-130, 929-966) -> train Grams + Dayal-MacGregor PLS (1010-1017) ->
Gram-PRESS (1019-1041) -> van der Voet selection as one moment expansion,
with the ``U0 >= 0`` self-check, or the PRESS tolerance rule (1043-1204) ->
score distances and top-K (1209-1295) -> doubled variance (1298-1301) ->
mixture weights through the kernel (1303-1330) -> weighted resample and
inverse-CDF truncated perturbation of the next generation (423-526).

With ``box_cox`` the ranking runs on Box-Cox-transformed metrics (global
column min incl. the observed row, shift to positivity, per-column lambda by
least |skewness| over the fixed grid; 720-852, resident branches); stored
and survivor metrics stay raw. With MULTIVARIATE noise the proposal is the
truncated multivariate normal around each resampled survivor (502-518).

Every random draw of a step is an explicit input (:class:`StepDraws`): the
engine draws them from a ``torch.Generator`` on the device, the parity tests
build them from JAX's own keys. With INDEPENDENT noise the step issues no
host sync of its own. The MULTIVARIATE rejection loop reads one "all rows
accepted" flag per round and draws its later rounds from
``StepDraws.retry_generator``; the rounds are counted in
``GenerationResult.mvn_rounds``.

Not yet ported: chunked row passes (``row_block``, incl. chunked Box-Cox),
split propose, two-stage top-K and the mesh collectives (one device only).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from abcsmc_tpu_torch.config import FilterType, NoiseType
from abcsmc_tpu_torch.models.parameters import ParameterSet
from abcsmc_tpu_torch.models.simulators import DeviceSimulator
from abcsmc_tpu_torch.models.transforms import ParameterTransform
from abcsmc_tpu_torch.ops import pls as pls_mod
from abcsmc_tpu_torch.ops import stats as stats_mod
from abcsmc_tpu_torch.ops import weights as weights_mod
from abcsmc_tpu_torch.ops.resample import _stratum_points, setup_mvn_sampler

_SEED_HIGH = np.iinfo(np.int32).max   # per-particle seeds in [0, 2^31 - 1)
VDV_PERMUTATIONS = 199                # sign rows of the van der Voet test
VDV_MAX_ROWS = 131_072                # held-out window of the test (tail rows)


def _dual_moment_stats(s1c, s2c, s1r, s2r, c, n: int):
    """Mean/sd from shifted (around ``c``) and raw one-pass moment sums,
    choosing per column the frame whose ``n*mu^2 / sum-of-squares`` ratio
    is smaller (it lost fewer bits). Returns (mean, sd_unguarded,
    obs_delta = c - mean without re-rounding c + dmean)."""
    dmean = s1c / n
    mean_r = s1r / n
    num_c = n * dmean * dmean
    num_r = n * mean_r * mean_r
    tiny = torch.finfo(s2c.dtype).tiny
    ratio_c = num_c / torch.clamp_min(s2c, tiny)
    ratio_r = num_r / torch.clamp_min(s2r, tiny)
    # default to the shifted frame unless the raw ratio is strictly smaller
    # (a NaN raw ratio from an overflowed sum(x*x) keeps the shifted frame)
    use_c = ~(ratio_r < ratio_c)
    var = torch.where(
        use_c, torch.clamp_min(s2c - num_c, 0.0),
        torch.clamp_min(s2r - num_r, 0.0),
    ) / max(n - 1, 1)
    mean = torch.where(use_c, c + dmean, mean_r)
    obs_delta = torch.where(use_c, -dmean, c - mean_r)
    return mean, torch.sqrt(var), obs_delta


def _sorted_searchsorted(cdf, q_sorted, n: int):
    """``searchsorted(cdf, q)`` (left) for ascending queries without sorting
    them: binary-search the K-1 cdf edges into the queries, scatter +1 at
    each bound, cumsum. Output lies in [0, K-1]."""
    bounds = torch.searchsorted(q_sorted, cdf[:-1], right=True)   # [K-1]
    z = torch.zeros((n + 1,), dtype=torch.int64, device=cdf.device)
    z.index_add_(0, bounds, torch.ones_like(bounds))
    return torch.cumsum(z[:n], dim=0)


@dataclass
class GenerationResult:
    """Outputs of one generation step (all on the step's device)."""

    metrics: torch.Tensor          # [N, M] simulated metrics
    distances: torch.Tensor        # [N] ranking distances (+inf on padding)
    survivor_idx: torch.Tensor     # [K] row indices of survivors, by rank
    survivor_params: torch.Tensor  # [K, P]
    survivor_metrics: torch.Tensor  # [K, M]
    weights: torch.Tensor          # [K] L2-normalized importance weights
    doubled_variance: torch.Tensor  # [P]
    next_params: torch.Tensor      # [N2, P] proposed next generation
    next_seeds: torch.Tensor       # [N2] int64 per-particle seeds
    ncomp_used: torch.Tensor       # 0-d: PLS components used (0 = SIMPLE;
    #                                NEGATIVE = the U0 self-check fired)
    box_cox_lambdas: torch.Tensor | None = None   # [M] chosen lambdas
    mvn_rounds: int = 0            # rounds of the MULTIVARIATE rejection
    #                                loop (0 = no such proposal in this step)
    sim_events: tuple | None = None  # CUDA events around the simulate stage
    #                                  (a step on the card that simulated)


@dataclass
class StepDraws:
    """The random draws of one generation step.

    - ``vdv_seed``: 0-d int64 holding the uint32 van der Voet sign seed
      (JAX: ``pls.vdv_seed(key)``);
    - ``pick``: the resample draws - [N2] unit uniforms (multinomial),
      [N2 + 1] Exp(1) draws (multinomial at N2 >= ``sorted_pick_min``,
      exponential spacings) or a 0-d unit uniform (systematic offset);
    - ``noise_u``: [N2, P] unit uniforms of the truncated perturbation
      (INDEPENDENT noise; None otherwise);
    - ``next_seeds``: [N2] int64 per-particle seeds of the next generation;
    - ``noise_eps``: [N2, P] standard normals, the first round of the
      MULTIVARIATE rejection loop (None with INDEPENDENT noise);
    - ``retry_generator``: the generator that loop draws its later rounds
      from (None: a rejected first round raises).

    The JAX step derives them as ``k_pick, k_noise, k_seed =
    split(fold_in(key, 0), 3)`` (abcsmc_tpu/parallel/generation.py:431-432);
    its first MULTIVARIATE round is ``normal(split(k_noise)[1])``.
    """

    vdv_seed: torch.Tensor
    pick: torch.Tensor
    noise_u: torch.Tensor | None
    next_seeds: torch.Tensor
    noise_eps: torch.Tensor | None = None
    retry_generator: torch.Generator | None = None


class Generation:
    """Single-device generation step. Configuration is fixed at
    construction; shapes (N, K, N2) are per call.

    ``noise_type``, ``max_retries`` (the bound of the MULTIVARIATE
    rejection loop) and ``box_cox`` (PLS filter only, as in the host
    ranking) are the config keys of the same names. ``weight_precision``
    is accepted and ignored: it selects among the TPU kernel's dot schemes,
    and the weight kernel here has one (3xTF32 with an FP32 accumulator),
    so every value runs the same path. Fitting mode only: PSEUDO/POSTERIOR
    parameters raise ``ValueError`` (projection sweeps run through
    ``AbcSmc.run_device``'s projection route)."""

    def __init__(
        self,
        par_set: ParameterSet,
        transform: ParameterTransform,
        simulator: DeviceSimulator | None,
        obs,
        *,
        device,
        dtype=torch.float32,
        filter_type: FilterType = FilterType.PLS,
        noise_type: NoiseType = NoiseType.INDEPENDENT,
        training_fraction: float = 0.5,
        max_retries: int = 1000,
        pls_optimal_method: str = "vdv",
        resample_method: str = "multinomial",
        box_cox: bool = False,
        weight_precision: str = "high",
    ):
        if par_set.pseudo_idx or par_set.posterior_idx:
            raise ValueError(
                "the generation step supports fitting mode (prior "
                "parameters) only; projection-mode grids run through the "
                "engine's projection route"
            )
        if resample_method not in ("multinomial", "systematic"):
            raise ValueError(f"unknown resample method {resample_method!r}")
        if pls_optimal_method not in ("vdv", "tolerance"):
            raise ValueError(
                f"unknown pls_optimal_method {pls_optimal_method!r}"
            )
        self.par_set = par_set
        self.transform = transform
        self.simulator = simulator
        self.obs = np.asarray(obs, np.float64)
        self.device = torch.device(device)
        self.dtype = dtype
        self.filter_type = filter_type
        self.noise_type = noise_type
        self.training_fraction = float(training_fraction)
        self.max_retries = int(max_retries)
        self.box_cox = bool(box_cox)
        self.weight_precision = weight_precision
        self.pls_optimal_method = pls_optimal_method
        self.resample_method = resample_method
        # above this many proposal rows the multinomial pick draws sorted
        # uniforms by exponential spacings and the systematic pick skips
        # the query sort (_sorted_searchsorted), as in the JAX step
        self.sorted_pick_min = 1 << 19
        self._obs_t = torch.as_tensor(self.obs).to(self.device, dtype)
        # the Box-Cox lambda grid as host floats, rounded to the working
        # dtype first (the JAX step casts its grid the same way)
        self._bc_grid = torch.as_tensor(
            stats_mod.box_cox_lambda_grid()).to(dtype).tolist()
        self._prior_means = torch.as_tensor(
            np.nan_to_num(par_set.means(), posinf=0.0, neginf=0.0)
        ).to(self.device, dtype)

    # ------------------------------------------------------------- draws
    def init_population(self, generator: torch.Generator, n: int):
        """Generation 0: prior draws [n, P] and per-particle seeds [n]."""
        params = self.par_set.sample_priors(generator, n, self.dtype)
        seeds = torch.randint(0, _SEED_HIGH, (n,), generator=generator,
                              device=self.device)
        return params, seeds

    def draw_step(self, generator: torch.Generator, n_next: int) -> StepDraws:
        """The draws of one step with an ``n_next``-row proposal (0 = the
        final set: empty proposal draws)."""
        dev, dt = self.device, self.dtype
        vdv_seed = torch.randint(0, 2**32, (), generator=generator,
                                 device=dev)
        if self.resample_method == "systematic":
            pick = torch.rand((), generator=generator, device=dev, dtype=dt)
        elif n_next >= self.sorted_pick_min:
            pick = torch.empty((n_next + 1,), device=dev, dtype=dt)
            pick.exponential_(generator=generator)
        else:
            pick = torch.rand((n_next,), generator=generator, device=dev,
                              dtype=dt)
        shape = (n_next, self.par_set.npar)
        noise_u = noise_eps = None
        if self.noise_type == NoiseType.MULTIVARIATE:
            noise_eps = torch.randn(shape, generator=generator, device=dev,
                                    dtype=dt)
        else:
            noise_u = torch.rand(shape, generator=generator, device=dev,
                                 dtype=dt)
        next_seeds = torch.randint(0, _SEED_HIGH, (n_next,),
                                   generator=generator, device=dev)
        return StepDraws(vdv_seed, pick, noise_u, next_seeds, noise_eps,
                         generator if noise_eps is not None else None)

    # ------------------------------------------------------------- steps
    def step(self, params, seeds, keep: int, n_next: int, draws: StepDraws,
             prev_state=None, n_valid: int | None = None) -> GenerationResult:
        """One generation: simulate ``params`` from ``seeds``, rank, weight,
        and propose ``n_next`` rows (0 = final set, nothing proposed).
        ``prev_state`` is (survivor_params, weights, doubled_variance) of the
        previous generation, None for the first. Rows >= ``n_valid`` are
        padding, masked out of every statistic."""
        events = None
        if self.device.type == "cuda":
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record()
        upars = self.transform.to_model_space(params).to(self.dtype)
        mets = self.simulator.batch_fn(upars, seeds).to(self.dtype)
        if events:
            events[1].record()
        res = self._step(params, mets, keep, n_next, draws, prev_state,
                         n_valid)
        res.sim_events = events
        return res

    def step_precomputed(self, params, metrics, keep: int, n_next: int,
                         draws: StepDraws, prev_state=None,
                         n_valid: int | None = None) -> GenerationResult:
        """:meth:`step` with the simulator excluded: metrics are inputs."""
        return self._step(params, metrics.to(self.dtype), keep, n_next,
                          draws, prev_state, n_valid)

    def _step(self, params, mets, keep, n_next, draws, prev_state, n_valid):
        dt, dev = self.dtype, self.device
        params = params.to(dt)
        n = params.shape[0]
        n_true = n if n_valid is None else int(n_valid)
        if not 1 <= keep <= n_true <= n:
            raise ValueError(f"need 1 <= keep ({keep}) <= n_valid "
                             f"({n_true}) <= rows ({n})")
        first = prev_state is None
        npar = self.par_set.npar
        nmet = len(self.obs)
        n_train = min(max(int(n_true * self.training_fraction + 0.5), 1),
                      n_true - 1)
        max_comp = max(min(n_train - 1, nmet), 1)
        use_pls = self.filter_type == FilterType.PLS
        eps = 1e-30
        obs = self._obs_t

        gidx = torch.arange(n, device=dev)
        vmask = (gidx < n_true).to(dt)[:, None]              # [n, 1]

        # Box-Cox is a ranking-side transform (PLS only, as the host
        # ranking); stored and survivor metrics stay raw
        lambdas = None
        rank_mets = mets
        if self.box_cox and use_pls:
            rank_mets, obs, lambdas = self._box_cox(mets, vmask, n_true)

        # ---- metric moments, dual frames (shifted around obs, and raw) ----
        md = (rank_mets - obs[None, :]) * vmask
        mr = rank_mets * vmask
        mean, sd, obs_delta = _dual_moment_stats(
            md.sum(0), (md * md).sum(0), mr.sum(0), (mr * rank_mets).sum(0),
            obs, n_true,
        )
        # constant column -> unit scale (a tiny floor would blow obs_z up)
        sd = torch.where(sd <= eps, torch.ones_like(sd), sd)
        zmet = (rank_mets - mean) / sd
        obs_z = obs_delta / sd

        if use_pls:
            c_par = self._prior_means if first else prev_state[0].mean(0)
            pd = (params - c_par[None, :]) * vmask
            pr = params * vmask
            pmean, psd, _ = _dual_moment_stats(
                pd.sum(0), (pd * pd).sum(0), pr.sum(0),
                (pr * params).sum(0), c_par, n_true,
            )
            psd = torch.where(psd <= eps, torch.ones_like(psd), psd)
            zpar = (params - pmean) / psd

            # ---- PLS fit on the training rows (Grams) ----
            train = (gidx < n_train).to(dt)[:, None]
            xm = zmet * train
            xtx = xm.T @ xm
            xty = xm.T @ (zpar * train)
            R, _, Q = pls_mod._fit_gram(xtx, xty, max_comp)

            # ---- NEW_DATA CV on the held-out rows, via Grams ----
            T = zmet @ R                                      # [n, A]
            test = vmask - train
            Tt = T * test
            G = Tt.T @ (zpar * test)                          # [A, p]
            H = Tt.T @ Tt                                     # [A, A]
            yty = (zpar * zpar * test).sum(0)                 # [p]
            QT = Q.T                                          # [A, p]
            term2 = 2.0 * torch.cumsum(G * QT, dim=0)
            Z = H[:, :, None] * QT[:, None, :] * QT[None, :, :]
            S = torch.diagonal(
                torch.cumsum(torch.cumsum(Z, dim=0), dim=1), dim1=0, dim2=1,
            ).T                                               # [A, p]
            press = yty[None, :] - term2 + S

            u0_bad = None
            if self.pls_optimal_method == "vdv":
                ok, u0_bad = self._vdv_ok(
                    T, zpar, test, QT, press, draws.vdv_seed, n_true,
                    max_comp, npar,
                )
            else:
                ok = press <= 1.1 * press.min(dim=0).values[None, :]
            ncomp_resp = torch.argmax(ok.to(torch.int32), dim=0) + 1
            ncomp_used = ncomp_resp.max()
            ncomp_report = (
                ncomp_used if u0_bad is None
                else torch.where(u0_bad, -ncomp_used, ncomp_used)
            )
            col_mask = (
                torch.arange(max_comp, device=dev) < ncomp_used
            ).to(dt)[None, :]
            obs_scores = (obs_z @ R) * col_mask[0]
            diff = T * col_mask - obs_scores[None, :]
        else:
            diff = zmet - obs_z[None, :]
            ncomp_report = torch.zeros((), dtype=torch.int64, device=dev)
        d = torch.sqrt((diff * diff).sum(dim=1))
        # padding rows rank last, so they never enter the top-K
        d = torch.where(gidx < n_true, d, torch.full_like(d, float("inf")))

        # ---- top-K ----
        _, surv_idx = torch.topk(-d, keep, sorted=True)
        surv_par = params[surv_idx]
        surv_met = mets[surv_idx]

        # ---- doubled variance + weights ----
        smean = surv_par.mean(0)
        dv = 2.0 * ((surv_par - smean[None, :]) ** 2).sum(0) / max(keep - 1, 1)
        if first:
            w = weights_mod.uniform_weights(keep, device=dev, dtype=dt)
        else:
            prev_par, prev_w, prev_dv = prev_state
            log_num = self.par_set.prior_log_pdf(surv_par).to(dt)
            log_den = weights_mod.log_kernel_mixture_density(
                surv_par, prev_par, torch.log(prev_w.to(dt)), prev_dv,
            )
            log_w = log_num - log_den
            log_w = log_w - log_w.max()
            w = torch.exp(log_w)
            w = w / torch.sqrt((w * w).sum())   # L2-normalize (parity quirk)

        rounds = 0
        if n_next == 0:
            nxt = torch.zeros((0, npar), dtype=dt, device=dev)
            nxt_seeds = torch.zeros((0,), dtype=torch.int64, device=dev)
        else:
            nxt, nxt_seeds, rounds = self.propose(surv_par, w, dv, n_next,
                                                  draws)
        return GenerationResult(
            mets, d, surv_idx, surv_par, surv_met, w, dv, nxt, nxt_seeds,
            ncomp_report, lambdas, rounds,
        )

    def _box_cox(self, mets, vmask, n_true: int):
        """Box-Cox of each metric column and the observed row (the host
        rule: ``ranking.apply_box_cox``): shift to positivity by the column
        min over the valid rows and the observed value, then per column the
        grid lambda of least |skewness|, from two-pass central moments (raw
        third moments cancel at float32). A lambda whose moments overflow
        is disqualified before the comparison; ties keep the first lambda.
        One grid point at a time: no [grid, N, M] block. Returns
        (transformed metrics [n, M], transformed observed row [M], lambdas
        [M])."""
        dt = self.dtype
        obs = self._obs_t
        valid = vmask > 0
        inf = torch.full((), math.inf, dtype=dt, device=self.device)
        col_min = torch.minimum(torch.where(valid, mets, inf).amin(0), obs)
        shift = torch.where(col_min <= 0, 1e-6 - col_min,
                            torch.zeros_like(col_min))
        # padding rows are real draws below no minimum: park them at 1
        # (log and pow of 1 are 0) so that they add nothing and no NaN
        v = torch.where(valid, mets + shift[None, :], torch.ones_like(mets))
        best = torch.full_like(obs, math.inf)
        lam_c = torch.full_like(obs, self._bc_grid[0])
        for lam in self._bc_grid:
            y = torch.log(v) if lam == 0 else (torch.pow(v, lam) - 1.0) / lam
            mu = (y * vmask).sum(0) / n_true
            c = (y - mu[None, :]) * vmask
            c2 = c * c
            var = c2.sum(0) / (n_true - 1)
            third = (c2 * c).sum(0) / n_true
            skew = torch.where(var == 0, torch.zeros_like(var),
                               third / torch.pow(var, 1.5))
            askew = torch.where(torch.isfinite(skew), skew.abs(), inf)
            better = askew < best
            best = torch.where(better, askew, best)
            lam_c = torch.where(better, torch.full_like(lam_c, lam), lam_c)
        return (stats_mod.box_cox(v, lam_c[None, :]),
                stats_mod.box_cox(obs + shift, lam_c), lam_c)

    def _vdv_ok(self, T, zpar, test, QT, press, vdv_seed, n_true, max_comp,
                npar):
        """Van der Voet randomization test as one moment expansion: every
        statistic S_w[a, j] = sum_n w_n test_n (zp_nj - sum_{b<=a} t_nb
        QT_bj)^2, for w = 1 (observed) and each sign row, expands into
        W @ [zp^2 | t x zp | t x t] plus a tiny prefix-sum recombination.
        The three right-hand sides are multiplied separately (never
        concatenated: at 100 metrics the t x t block alone is ~4 GB).
        Returns (ok [A, p], u0_bad 0-d bool)."""
        dt = T.dtype
        nsub = min(T.shape[0], VDV_MAX_ROWS)
        # the window ends at the last valid row: held-out rows live at the
        # tail (training rows are the first n_train indices)
        start = max(n_true - nsub, 0)
        t_s = T[start:start + nsub]
        zp_s = zpar[start:start + nsub]
        test_s = test[start:start + nsub]
        g_s = torch.arange(start, start + nsub, device=T.device)
        sgn = pls_mod.vdv_signs(vdv_seed, VDV_PERMUTATIONS, g_s, dt)
        W = torch.cat([torch.ones((1, nsub), dtype=dt, device=T.device),
                       sgn], dim=0)                            # [K1, ns]
        tm = t_s * test_s
        zpm = zp_s * test_s
        U0 = W @ (zpm * zp_s)                                  # [K1, p]
        U1 = (W @ (t_s[:, :, None] * zpm[:, None, :]).reshape(
            nsub, max_comp * npar)).reshape(-1, max_comp, npar)
        U2 = (W @ (t_s[:, :, None] * tm[:, None, :]).reshape(
            nsub, max_comp * max_comp)).reshape(-1, max_comp, max_comp)
        # self-check: the observed row of U0 is a sum of non-negative
        # terms; a negative entry means the product read corrupted operands
        u0_bad = U0[0].min() < 0
        term1 = torch.cumsum(QT[None] * U1, dim=1)             # [K1, A, p]
        Z2 = U2[:, :, :, None] * QT[None, :, None, :] * QT[None, None, :, :]
        S2 = torch.diagonal(
            torch.cumsum(torch.cumsum(Z2, dim=1), dim=2), dim1=1, dim2=2,
        ).movedim(-1, 1)                                       # [K1, A, p]
        S = U0[:, None, :] - 2.0 * term1 + S2                  # [K1, A, p]
        best = torch.argmin(press, dim=0)                      # [p]
        Sb = torch.gather(
            S, 1, best[None, None, :].expand(S.shape[0], 1, npar)
        )                                                      # [K1, 1, p]
        tstat = S - Sb
        pvals = (tstat[1:].abs() >= tstat[0].abs()[None]).to(dt).mean(0)
        return pvals > 0.25, u0_bad

    def propose(self, surv_par, w, dv, n_next: int, draws: StepDraws):
        """Weighted resample of the survivors + truncated perturbation
        (src/AbcSmc.cpp:479-553). Returns (next_params [N2, P], seeds, rounds
        of the MULTIVARIATE rejection loop; 0 with INDEPENDENT noise)."""
        dt = self.dtype
        keep = surv_par.shape[0]
        cdf = torch.cumsum(w, dim=0)
        pick_draw = draws.pick.to(dt)
        if self.resample_method == "systematic":
            g2 = torch.arange(n_next, device=self.device)
            pts = _stratum_points(g2, pick_draw, cdf[-1] / n_next, dt)
            if n_next >= self.sorted_pick_min:
                # f32 rounding at the 4096-index block edges can invert
                # neighbours by a few ulps; project onto monotone first
                pts = torch.cummax(pts, dim=0).values
                pick = _sorted_searchsorted(cdf, pts, n_next)
            else:
                pick = torch.clamp_max(torch.searchsorted(cdf, pts), keep - 1)
        elif n_next >= self.sorted_pick_min:
            # sorted uniforms by exponential spacings: u_(i) = S_i / S_{n+1}
            s = torch.cumsum(pick_draw, dim=0)
            u = (s[:-1] / s[-1]) * cdf[-1]
            pick = _sorted_searchsorted(cdf, u, n_next)
        else:
            u = pick_draw * cdf[-1]
            pick = torch.clamp_max(torch.searchsorted(cdf, u), keep - 1)
        mu = surv_par[pick]
        rounds = 0
        if self.noise_type == NoiseType.MULTIVARIATE:
            # covariance with the n-1 divisor in full FP32, diagonal alone
            # doubled; a collapsed column gives a NaN factor, as in JAX:
            # no row is ever accepted and every row falls back to its mu
            L = setup_mvn_sampler(surv_par)
            nxt, rounds = self.par_set.noise_multivariate(
                mu, L, draws.noise_eps, self.max_retries,
                draws.retry_generator,
            )
        else:
            nxt = self.par_set.noise_independent(mu, dv, draws.noise_u)
        return nxt.to(dt), draws.next_seeds.to(torch.int64), rounds
