"""One SMC generation on one device (port of
:class:`abcsmc_tpu.parallel.generation.ShardedGeneration`, one device).

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
least |skewness| over the fixed grid; 720-852); stored and survivor metrics
stay raw. With MULTIVARIATE noise the proposal is the truncated multivariate
normal around each resampled survivor (502-518).

Row passes come in two forms. The resident one holds the [n, M] z-scores and
the [n, A] scores at once. The chunked one (``row_block``; 693-718, 737-815,
880-927, 968-1008, 1068-1085, 1210-1246) walks the rows in blocks and keeps
only the raw metrics, the parameters and the [n] distance vector resident;
the algebra is the same, so the two agree up to the order of the sums.
``propose_split`` runs the proposal apart from the ranking so that the
caller can free the population in between (561-612).

Every random draw of a step is an explicit input (:class:`StepDraws`): the
engine draws them from a ``torch.Generator`` on the device, the parity tests
build them from JAX's own keys. The MULTIVARIATE rejection loop runs a
fixed block of ``rejection_block`` masked rounds with no host read (its
later rounds' normals are a counter hash of ``StepDraws.retry_seed`` and
the round, :class:`~abcsmc_tpu_torch.models.parameters.RetryNormals`), so
the step issues no host sync of its own and on a CUDA device it can be
captured into a CUDA graph: :meth:`Generation.run_scan` and
:meth:`Generation.run_chain` replay one captured step per set of a
same-shape bucket (1404-1656). The loop's count is read once per step
(eager) or once per set after its replay; where a row is still rejected
after the block, further rounds run eagerly and give the same bits as one
long loop. The count is ``GenerationResult.mvn_rounds``.

One device only: the mesh collectives are not ported, and ``topk_two_stage``
(a two-stage gather over a mesh) has no effect here.
"""

from __future__ import annotations

import copy
import dataclasses
import math
import time
from dataclasses import dataclass

import numpy as np
import torch

from abcsmc_tpu_torch.config import FilterType, NoiseType
from abcsmc_tpu_torch.models.parameters import (
    REJECTION_BLOCK, ParameterSet, RejectionLoop, draw_retry_seed,
)
from abcsmc_tpu_torch.models.simulators import DeviceSimulator
from abcsmc_tpu_torch.models.transforms import ParameterTransform
from abcsmc_tpu_torch.ops import pls as pls_mod
from abcsmc_tpu_torch.ops import stats as stats_mod
from abcsmc_tpu_torch.ops import weights as weights_mod
from abcsmc_tpu_torch.ops.resample import _stratum_points, setup_mvn_sampler

_SEED_HIGH = np.iinfo(np.int32).max   # per-particle seeds in [0, 2^31 - 1)
ROW_BLOCK_AUTO = 1 << 21              # rows per block when the auto rule chunks
# The share of the card's memory that the auto rules plan with: the rest is
# left to the allocator's slack, the kernel's workspace and the caller.
AUTO_MEMORY_SHARE = 0.8


def _dual_moment_stats(s1c, s2c, s1r, s2r, c, n: int):
    """Mean/sd from shifted (around ``c``) and raw one-pass moment sums,
    choosing per column the frame whose ``n*mu^2 / sum-of-squares`` ratio
    is smaller (it lost fewer bits). Returns (mean, sd_unguarded,
    obs_delta = c - mean without re-rounding c + dmean).

    Deviation from the JAX step (abcsmc_tpu/parallel/generation.py:120-122),
    which keeps the shifted frame whenever the raw ratio is not strictly
    smaller: here a shifted frame whose ratio is not finite (its sums
    overflowed, e.g. float32 data near 0 with an observed value ~1e19) is
    never chosen. Wherever the shifted ratio is finite the two choose
    alike. Where it is not, JAX's variance is inf - inf: NaN moments and
    distances (or, where XLA's max drops the NaN, as on the CPU, a zero
    variance and finite distances that are wrong); here the raw frame
    gives the moments float64 gives."""
    dmean = s1c / n
    mean_r = s1r / n
    num_c = n * dmean * dmean
    num_r = n * mean_r * mean_r
    tiny = torch.finfo(s2c.dtype).tiny
    ratio_c = num_c / torch.clamp_min(s2c, tiny)
    ratio_r = num_r / torch.clamp_min(s2r, tiny)
    # default to the shifted frame unless the raw ratio is strictly smaller
    # (a NaN raw ratio from an overflowed sum(x*x) keeps the shifted frame)
    # or the shifted ratio is not finite (its own sums overflowed)
    use_c = torch.isfinite(ratio_c) & ~(ratio_r < ratio_c)
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
    mvn_rounds: int = 0            # the MULTIVARIATE rejection loop's
    #                                count (JAX's loop counter; 0 = no such
    #                                proposal in this step)
    mvn_loop: RejectionLoop | None = None  # a captured step's loop: its
    #                                count is read after each replay
    mvn_finished_eagerly: bool = False  # rounds ran past the first block
    sim_events: tuple | None = None  # CUDA events around the simulate stage
    #                                  (an eager step on the card that
    #                                  simulated; None for a replayed one)


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
    - ``retry_seed``: 0-d int64 holding the uint32 seed of that loop's
      later rounds (None: a rejected first round raises).

    The JAX step derives them as ``k_pick, k_noise, k_seed =
    split(fold_in(key, 0), 3)`` (abcsmc_tpu/parallel/generation.py:431-432);
    its first MULTIVARIATE round is ``normal(split(k_noise)[1])``.
    """

    vdv_seed: torch.Tensor
    pick: torch.Tensor | None
    noise_u: torch.Tensor | None
    next_seeds: torch.Tensor | None
    noise_eps: torch.Tensor | None = None
    retry_seed: torch.Tensor | None = None


_DRAW_FIELDS = tuple(f.name for f in dataclasses.fields(StepDraws))


class _CapturedStep:
    """One later-set step captured into a CUDA graph: static input tensors
    (population, previous state, draws), the static result, and the number
    of kernel launches the graph holds."""

    def __init__(self, graph, params, seeds, state, draws, result,
                 kernel_launches):
        self.graph = graph
        self.params = params
        self.seeds = seeds
        self.state = state
        self.draws = draws
        self.result = result
        self.kernel_launches = kernel_launches


class Generation:
    """Single-device generation step. Configuration is fixed at
    construction; shapes (N, K, N2) are per call.

    ``noise_type``, ``max_retries`` (the bound of the MULTIVARIATE
    rejection loop) and ``box_cox`` (PLS filter only, as in the host
    ranking) are the config keys of the same names. ``weight_precision``
    is accepted and ignored: it selects among the TPU kernel's dot schemes,
    and the weight kernel here has one (3xTF32 with an FP32 accumulator),
    so every value runs the same path. ``max_pls_components`` (None: no
    cap) caps the PLS components below min(n_train - 1, metrics);
    ``vdv_permutations`` is the number of sign rows of the van der Voet
    test and ``vdv_max_rows`` the rows of its held-out window (the last
    valid rows), as in the JAX step; none of the three is a config key.
    Fitting mode only: PSEUDO/POSTERIOR
    parameters raise ``ValueError`` (projection sweeps run through
    ``AbcSmc.run_device``'s projection route).

    ``row_block``: None = auto, an int > 0 forces chunked row passes with
    that block, 0 disables them; negative raises ``ValueError``.
    ``propose_split``: None = auto, True/False force
    (:meth:`split_propose_active`). Both auto rules are derived at
    construction from the step's bytes per row (:meth:`resident_row_bytes`,
    read on the card; :meth:`chunked_row_bytes` and
    :meth:`propose_row_bytes`, counted and checked there) and the card's
    total memory (``torch.cuda.mem_get_info``): ``row_chunk_threshold`` is
    the population above which the resident step would not fit in
    ``AUTO_MEMORY_SHARE`` of the card, ``split_threshold`` the one above
    which a chunked step and its proposal would not fit together. On the
    CPU both rules are off. ``topk_two_stage`` is accepted and has no
    effect on one device: the two-stage top-K gathers candidate distances
    over a mesh before the rows, and with one shard that is the single
    top-K itself (bit-identical in the JAX package too)."""

    # A resident later-set step with its proposal peaks at this many times
    # the bytes of its population's parameters and metrics: 395-397 bytes
    # per row at 6 x 13 float32 (76 bytes of population) at 2^24, 2^25 and
    # 2^26 rows on an NVIDIA H100 80GB HBM3 (chip_smoke.py, hbm_scale;
    # PERF.md section 6). One point: other widths scale by their own
    # population bytes.
    _RESIDENT_PEAK_FACTOR = 5.2

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
        max_pls_components: int | None = None,
        max_retries: int = 1000,
        pls_optimal_method: str = "vdv",
        vdv_permutations: int = 199,
        vdv_max_rows: int = 131_072,
        resample_method: str = "multinomial",
        box_cox: bool = False,
        weight_precision: str = "high",
        row_block: int | None = None,
        propose_split: bool | None = None,
        topk_two_stage: bool | None = None,
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
        if row_block is not None and int(row_block) < 0:
            raise ValueError(f"row_block must be >= 0, got {row_block!r}")
        self.par_set = par_set
        self.transform = transform
        self.simulator = simulator
        self.obs = np.asarray(obs, np.float64)
        self.device = torch.device(device)
        self.dtype = dtype
        self.filter_type = filter_type
        self.noise_type = noise_type
        self.training_fraction = float(training_fraction)
        self.max_pls_components = max_pls_components
        self.vdv_permutations = int(vdv_permutations)
        self.vdv_max_rows = int(vdv_max_rows)
        self.max_retries = int(max_retries)
        self.box_cox = bool(box_cox)
        self.weight_precision = weight_precision
        self.pls_optimal_method = pls_optimal_method
        self.resample_method = resample_method
        self.row_block = None if row_block is None else int(row_block)
        self.propose_split = propose_split
        self.topk_two_stage = topk_two_stage
        # above this many proposal rows the multinomial pick draws sorted
        # uniforms by exponential spacings and the systematic pick skips
        # the query sort (_sorted_searchsorted), as in the JAX step
        self.sorted_pick_min = 1 << 19
        self._obs_t = torch.as_tensor(self.obs).to(self.device, dtype)
        # the Box-Cox lambda grid as host floats, rounded to the working
        # dtype first (the JAX step casts its grid the same way)
        self._bc_grid = torch.as_tensor(
            stats_mod.box_cox_lambda_grid()).to(dtype).tolist()
        self._bc_grid_t = torch.as_tensor(self._bc_grid, dtype=dtype,
                                          device=self.device)
        self._prior_means = torch.as_tensor(
            np.nan_to_num(par_set.means(), posinf=0.0, neginf=0.0)
        ).to(self.device, dtype)
        # ---- the auto rules, from bytes per row and the card's memory ----
        self.memory_bytes = None
        self.row_chunk_threshold = self.split_threshold = None
        if self.device.type == "cuda":
            self.memory_bytes = torch.cuda.mem_get_info(self.device)[1]
            budget = AUTO_MEMORY_SHARE * self.memory_bytes
            self.row_chunk_threshold = max(
                1, int(budget // self.resident_row_bytes()))
            # a block's temporaries cost about twice a resident row each
            self.split_threshold = max(1, int(
                (budget - 2 * ROW_BLOCK_AUTO * self.resident_row_bytes())
                // (self.chunked_row_bytes() + self.propose_row_bytes())))
        #: what the host submitted through this object: one per eager
        #: init / step / propose call and one per graph replay. A replay
        #: stands for a whole step, so the count grows with the sets on
        #: every route (the JAX package's scan programs grow with the size
        #: transitions instead); what the fused route saves is the
        #: thousands of kernel launches inside each step.
        self.dispatches = 0
        #: CUDA graphs captured / replayed, and the seconds the captures
        #: took (warm-up excluded: the warm-up is a real set of the run)
        self.graph_captures = 0
        self.graph_replays = 0
        self.capture_seconds = 0.0
        #: steps whose MULTIVARIATE rejection loop ran past its first block
        self.mvn_eager_finishes = 0
        self._capturing = False
        #: per set of the last run_scan / run_chain / run: the route
        #: ("eager" or "replay"), CUDA events around the set, the simulate
        #: events of an eager set, the MULTIVARIATE count and whether its
        #: rounds ran past the first block, and the chosen Box-Cox lambdas
        self.set_info: list[dict] = []
        self._graphs: dict = {}

    # ------------------------------------------------------ bytes per row
    def _pop_row_bytes(self) -> int:
        item = torch.empty((), dtype=self.dtype).element_size()
        return item * (self.par_set.npar + len(self.obs))

    def resident_row_bytes(self) -> int:
        """Peak bytes per population row of a resident later-set step, its
        population and its proposal included (``_RESIDENT_PEAK_FACTOR``)."""
        return math.ceil(self._RESIDENT_PEAK_FACTOR * self._pop_row_bytes())

    def chunked_row_bytes(self) -> int:
        """Peak bytes per population row of a chunked step with its
        population: params, metrics, int64 seeds, the distance vector and
        the top-K's negated copy; every other buffer is per block (85 bytes
        per row were read at 2^29 rows of 6 x 13 float32, no seeds held)."""
        item = self._pop_row_bytes() // (self.par_set.npar + len(self.obs))
        return self._pop_row_bytes() + 2 * item + 8

    def propose_row_bytes(self) -> int:
        """Peak bytes per proposed row of a chunked proposal: the draws
        (pick, noise, int64 seeds), the int64 picks with the scatter
        vector they are summed from, and the output; the truncated
        perturbation's temporaries are per block."""
        p = self.par_set.npar
        item = self._pop_row_bytes() // (p + len(self.obs))
        return item * (3 + 2 * p) + 8 + 16

    def row_block_for(self, n: int) -> int:
        """The block of the chunked row passes for an ``n``-row population,
        0 when the passes are resident."""
        if self.row_block is None:
            if (self.row_chunk_threshold is None
                    or n < self.row_chunk_threshold):
                return 0
            return min(ROW_BLOCK_AUTO, n)
        return min(self.row_block, n)

    def split_propose_active(self, n: int, n_next: int) -> bool:
        """True when a step at (n, n_next) runs its proposal apart from its
        ranking (``propose_split``; auto: either size reaches
        ``split_threshold``, beyond which the population, the ranking's
        temporaries and the proposal's buffers do not fit the card
        together). The engine then sequences rank -> fetch -> free ->
        propose itself; :meth:`step` alone cannot free what its caller
        still references."""
        if n_next <= 0:
            return False
        if self.propose_split is not None:
            return bool(self.propose_split)
        if self.split_threshold is None:
            return False
        return max(n, n_next) >= self.split_threshold

    @property
    def capturable(self) -> bool:
        """True when a later-set step can be captured into a CUDA graph: on
        a CUDA device (the step has no host sync of its own; a
        MULTIVARIATE step's count is read after the replay)."""
        return self.device.type == "cuda"

    # ------------------------------------------------------------- draws
    def init_population(self, generator: torch.Generator, n: int):
        """Generation 0: prior draws [n, P] and per-particle seeds [n]."""
        self.dispatches += 1
        params = self.par_set.sample_priors(generator, n, self.dtype)
        seeds = torch.randint(0, _SEED_HIGH, (n,), generator=generator,
                              device=self.device)
        return params, seeds

    def draw_vdv_seed(self, generator: torch.Generator) -> StepDraws:
        """The first draw of a step: the van der Voet sign seed alone (the
        ranking needs no other). :meth:`draw_proposal` completes it."""
        return StepDraws(
            torch.randint(0, 2**32, (), generator=generator,
                          device=self.device), None, None, None)

    def draw_proposal(self, generator: torch.Generator, n_next: int,
                      draws: StepDraws) -> StepDraws:
        """The proposal draws of a step whose seed :meth:`draw_vdv_seed`
        drew from the same generator: together they consume it exactly as
        :meth:`draw_step` does."""
        dev, dt = self.device, self.dtype
        if self.resample_method == "systematic":
            pick = torch.rand((), generator=generator, device=dev, dtype=dt)
        elif n_next >= self.sorted_pick_min:
            pick = torch.empty((n_next + 1,), device=dev, dtype=dt)
            pick.exponential_(generator=generator)
        else:
            pick = torch.rand((n_next,), generator=generator, device=dev,
                              dtype=dt)
        shape = (n_next, self.par_set.npar)
        noise_u = noise_eps = retry_seed = None
        mvn = self.noise_type == NoiseType.MULTIVARIATE
        if mvn:
            noise_eps = torch.randn(shape, generator=generator, device=dev,
                                    dtype=dt)
        else:
            noise_u = torch.rand(shape, generator=generator, device=dev,
                                 dtype=dt)
        next_seeds = torch.randint(0, _SEED_HIGH, (n_next,),
                                   generator=generator, device=dev)
        if mvn:
            retry_seed = draw_retry_seed(generator)
        return StepDraws(draws.vdv_seed, pick, noise_u, next_seeds, noise_eps,
                         retry_seed)

    def draw_step(self, generator: torch.Generator, n_next: int) -> StepDraws:
        """The draws of one step with an ``n_next``-row proposal (0 = the
        final set: empty proposal draws)."""
        return self.draw_proposal(generator, n_next,
                                  self.draw_vdv_seed(generator))

    # ------------------------------------------------------------- steps
    def step(self, params, seeds, keep: int, n_next: int, draws: StepDraws,
             prev_state=None, n_valid: int | None = None) -> GenerationResult:
        """One generation: simulate ``params`` from ``seeds``, rank, weight,
        and propose ``n_next`` rows (0 = final set, nothing proposed).
        ``prev_state`` is (survivor_params, weights, doubled_variance) of the
        previous generation, None for the first. Rows >= ``n_valid`` are
        padding, masked out of every statistic."""
        self.dispatches += 1
        events = None
        if self.device.type == "cuda":
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record()
        mets = self._simulate(params, seeds)
        if events:
            events[1].record()
        res = self._step(params, mets, keep, n_next, draws, prev_state,
                         n_valid)
        res.sim_events = events
        return res

    def _simulate(self, params, seeds):
        """Metrics [n, M] of the population. Where the row passes are
        chunked the simulator runs block by block too (its temporaries are
        many times a metric row); a particle's metrics are a function of
        its own parameters and seed alone, so the blocks change nothing."""
        n = params.shape[0]
        bs = self.row_block_for(n)
        if not bs or bs >= n:
            upars = self.transform.to_model_space(params).to(self.dtype)
            return self.simulator.batch_fn(upars, seeds).to(self.dtype)
        mets = torch.empty((n, len(self.obs)), dtype=self.dtype,
                           device=self.device)
        for start in range(0, n, bs):
            rows = slice(start, min(start + bs, n))
            upars = self.transform.to_model_space(params[rows]).to(self.dtype)
            mets[rows] = self.simulator.batch_fn(upars, seeds[rows])
        return mets

    def step_precomputed(self, params, metrics, keep: int, n_next: int,
                         draws: StepDraws, prev_state=None,
                         n_valid: int | None = None) -> GenerationResult:
        """:meth:`step` with the simulator excluded: metrics are inputs."""
        self.dispatches += 1
        return self._step(params, metrics.to(self.dtype), keep, n_next,
                          draws, prev_state, n_valid)

    def _step(self, params, mets, keep, n_next, draws, prev_state, n_valid):
        params = params.to(self.dtype)
        n = params.shape[0]
        n_true = n if n_valid is None else int(n_valid)
        if not 1 <= keep <= n_true <= n:
            raise ValueError(f"need 1 <= keep ({keep}) <= n_valid "
                             f"({n_true}) <= rows ({n})")
        bs = self.row_block_for(n)
        rank = self._rank_chunked if bs else self._rank_resident
        d, ncomp_report, lambdas = rank(params, mets, n_true, prev_state,
                                        draws.vdv_seed, *((bs,) if bs else ()))
        return self._finish(params, mets, d, ncomp_report, lambdas, keep,
                            n_next, draws, prev_state)

    def _sizes(self, n_true: int):
        """(training rows, PLS component cap) of an ``n_true``-row set."""
        n_train = min(max(int(n_true * self.training_fraction + 0.5), 1),
                      n_true - 1)
        max_comp = min(n_train - 1, len(self.obs))
        if self.max_pls_components:
            max_comp = min(max_comp, self.max_pls_components)
        return n_train, max(max_comp, 1)

    @staticmethod
    def _press(G, H, yty, QT):
        """PRESS[a, j] = sum over held-out rows of (y_ij - sum_{c<=a} T_ic
        Q_jc)^2 from the held-out Grams G = T'Y [A, p], H = T'T [A, A] and
        diag(Y'Y) [p]."""
        term2 = 2.0 * torch.cumsum(G * QT, dim=0)
        Z = H[:, :, None] * QT[:, None, :] * QT[None, :, :]
        S = torch.diagonal(
            torch.cumsum(torch.cumsum(Z, dim=0), dim=1), dim1=0, dim2=1,
        ).T                                                   # [A, p]
        return yty[None, :] - term2 + S

    def _select(self, press, QT, vdv_window, vdv_seed, max_comp):
        """(ncomp_used, the reported count: negated when the U0 self-check
        fired, the [1, A] column mask of the used components).
        ``vdv_window`` makes the (scores, z-parameters, held-out mask, row
        indices) of the test's window."""
        u0_bad = None
        if self.pls_optimal_method == "vdv":
            ok, u0_bad = self._vdv_ok(*vdv_window(), QT, press, vdv_seed)
        else:
            ok = press <= 1.1 * press.min(dim=0).values[None, :]
        ncomp_resp = torch.argmax(ok.to(torch.int32), dim=0) + 1
        ncomp_used = ncomp_resp.max()
        ncomp_report = (
            ncomp_used if u0_bad is None
            else torch.where(u0_bad, -ncomp_used, ncomp_used)
        )
        col_mask = (
            torch.arange(max_comp, device=self.device) < ncomp_used
        ).to(self.dtype)[None, :]
        return ncomp_report, col_mask

    def _par_center(self, prev_state):
        return (self._prior_means if prev_state is None
                else prev_state[0].to(self.dtype).mean(0))

    def _rank_resident(self, params, mets, n_true, prev_state, vdv_seed):
        """Ranking distances [n] with every row buffer resident. Returns
        (distances, reported component count, Box-Cox lambdas or None)."""
        dt, dev = self.dtype, self.device
        n = params.shape[0]
        n_train, max_comp = self._sizes(n_true)
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
        del md, mr
        # constant column (or a NaN sd) -> unit scale (a tiny floor would
        # blow obs_z up)
        sd = torch.where(~(sd > eps), torch.ones_like(sd), sd)
        zmet = (rank_mets - mean) / sd
        obs_z = obs_delta / sd

        if use_pls:
            c_par = self._par_center(prev_state)
            pd = (params - c_par[None, :]) * vmask
            pr = params * vmask
            pmean, psd, _ = _dual_moment_stats(
                pd.sum(0), (pd * pd).sum(0), pr.sum(0),
                (pr * params).sum(0), c_par, n_true,
            )
            del pd, pr
            psd = torch.where(~(psd > eps), torch.ones_like(psd), psd)
            zpar = (params - pmean) / psd

            # ---- PLS fit on the training rows (Grams) ----
            train = (gidx < n_train).to(dt)[:, None]
            xm = zmet * train
            xtx = xm.T @ xm
            xty = xm.T @ (zpar * train)
            del xm
            R, _, Q = pls_mod._fit_gram(xtx, xty, max_comp)

            # ---- NEW_DATA CV on the held-out rows, via Grams ----
            T = zmet @ R                                      # [n, A]
            test = vmask - train
            Tt = T * test
            G = Tt.T @ (zpar * test)                          # [A, p]
            H = Tt.T @ Tt                                     # [A, A]
            del Tt
            yty = (zpar * zpar * test).sum(0)                 # [p]
            QT = Q.T                                          # [A, p]
            press = self._press(G, H, yty, QT)

            def vdv_window():
                nsub = min(n, max(self.vdv_max_rows, 1))
                # the window ends at the last valid row: held-out rows live
                # at the tail (training rows are the first n_train indices)
                start = max(n_true - nsub, 0)
                rows = slice(start, start + nsub)
                return T[rows], zpar[rows], test[rows], gidx[rows]

            ncomp_report, col_mask = self._select(press, QT, vdv_window,
                                                  vdv_seed, max_comp)
            obs_scores = (obs_z @ R) * col_mask[0]
            diff = T * col_mask - obs_scores[None, :]
        else:
            diff = zmet - obs_z[None, :]
            ncomp_report = torch.zeros((), dtype=torch.int64, device=dev)
        d = torch.sqrt((diff * diff).sum(dim=1))
        # padding rows rank last, so they never enter the top-K
        d = torch.where(gidx < n_true, d, torch.full_like(d, float("inf")))
        return d, ncomp_report, lambdas

    def _rank_chunked(self, params, mets, n_true, prev_state, vdv_seed,
                      row_bs: int):
        """:meth:`_rank_resident` with every O(n)-row pass walked in blocks
        of ``row_bs`` rows: no [n, M] z-score, [n, A] score or transformed
        metric buffer exists, only the raw inputs and the [n] distances.
        The last block is shifted back when ``row_bs`` does not divide n,
        and its rows below ``i * row_bs`` (already counted by the block
        before) are masked out of every sum as not ``fresh``."""
        dt, dev = self.dtype, self.device
        n = params.shape[0]
        nmet, npar = len(self.obs), self.par_set.npar
        n_train, max_comp = self._sizes(n_true)
        use_pls = self.filter_type == FilterType.PLS
        use_bc = self.box_cox and use_pls
        eps = 1e-30
        obs = self._obs_t
        n_blocks = -(-n // row_bs)
        starts = [min(i * row_bs, n - row_bs) for i in range(n_blocks)]

        def mask(start, flo, lo, hi):
            """[row_bs, 1] mask of the block's fresh rows with lo <= index
            < hi, or None when that is every row of the block (a product
            with 1 changes no bit, so it is skipped)."""
            if flo <= start and lo <= start and start + row_bs <= hi:
                return None
            g = torch.arange(start, start + row_bs, device=dev)
            return ((g >= max(flo, lo)) & (g < hi)).to(dt)[:, None]

        def masked(x, m):
            return x if m is None else x * m

        def blocks():
            for i, start in enumerate(starts):
                rows = slice(start, start + row_bs)
                yield start, i * row_bs, mets[rows], params[rows]

        lambdas = None
        shift = lam_c = None
        if use_bc:
            inf = torch.full((), math.inf, dtype=dt, device=dev)
            cmin = torch.full((nmet,), math.inf, dtype=dt, device=dev)
            for start, _, mb, _ in blocks():
                if start + row_bs > n_true:
                    g = torch.arange(start, start + row_bs, device=dev)
                    mb = torch.where((g < n_true)[:, None], mb, inf)
                cmin = torch.minimum(cmin, mb.amin(0))
            col_min = torch.minimum(cmin, obs)
            shift = torch.where(col_min <= 0, 1e-6 - col_min,
                                torch.zeros_like(col_min))

        def shifted(start, mb):
            """The block shifted to positivity; padding rows parked at 1
            (they are real draws below no minimum: log and pow of 1 are 0,
            so they add nothing and no NaN)."""
            v = mb + shift[None, :]
            if start + row_bs > n_true:
                g = torch.arange(start, start + row_bs, device=dev)
                v = torch.where((g < n_true)[:, None], v, torch.ones_like(v))
            return v

        if use_bc:
            grid = self._bc_grid
            # per-(lambda, column) sums [L, M]: the rows are read once per
            # pass, every lambda applied to the block while it is at hand
            s1 = torch.zeros((len(grid), nmet), dtype=dt, device=dev)
            for start, flo, mb, _ in blocks():
                vm = mask(start, flo, 0, n_true)
                v = shifted(start, mb)
                for k, lam in enumerate(grid):
                    s1[k] += masked(self._bc_one(v, lam), vm).sum(0)
            bc_mean = s1 / n_true
            s2 = torch.zeros_like(s1)
            s3 = torch.zeros_like(s1)
            for start, flo, mb, _ in blocks():
                vm = mask(start, flo, 0, n_true)
                v = shifted(start, mb)
                for k, lam in enumerate(grid):
                    c = masked(self._bc_one(v, lam) - bc_mean[k][None, :], vm)
                    c2 = c * c
                    s2[k] += c2.sum(0)
                    s3[k] += (c2 * c).sum(0)
            var = s2 / (n_true - 1)
            third = s3 / n_true
            skew = torch.where(var == 0, torch.zeros_like(var),
                               third / torch.pow(var, 1.5))
            askew = torch.where(torch.isfinite(skew), skew.abs(), inf)
            # the first of equal minima, as the resident loop keeps it
            k_idx = torch.arange(len(grid), device=dev)[:, None]
            first_min = torch.where(askew == askew.amin(0)[None, :], k_idx,
                                    len(grid) - 1).amin(0)
            lam_c = self._bc_grid_t[first_min]
            lambdas = lam_c
            obs = stats_mod.box_cox(obs + shift, lam_c)

        def rank_rows(start, mb):
            """The block in ranking space: Box-Cox applied on the fly."""
            if use_bc:
                return stats_mod.box_cox(shifted(start, mb), lam_c[None, :])
            return mb

        # ---- dual-frame moments of metrics and parameters, one pass ----
        c_par = self._par_center(prev_state) if use_pls else None
        acc = [torch.zeros((nmet,), dtype=dt, device=dev) for _ in range(4)]
        if use_pls:
            acc += [torch.zeros((npar,), dtype=dt, device=dev)
                    for _ in range(4)]
        for start, flo, mb, pb in blocks():
            vm = mask(start, flo, 0, n_true)
            rb = rank_rows(start, mb)
            md = masked(rb - obs[None, :], vm)
            mr = masked(rb, vm)
            acc[0] += md.sum(0)
            acc[1] += (md * md).sum(0)
            acc[2] += mr.sum(0)
            acc[3] += (mr * rb).sum(0)
            if use_pls:      # SIMPLE never reads the parameter sums
                pd = masked(pb - c_par[None, :], vm)
                pr = masked(pb, vm)
                acc[4] += pd.sum(0)
                acc[5] += (pd * pd).sum(0)
                acc[6] += pr.sum(0)
                acc[7] += (pr * pb).sum(0)
        mean, sd, obs_delta = _dual_moment_stats(*acc[:4], obs, n_true)
        sd = torch.where(~(sd > eps), torch.ones_like(sd), sd)
        obs_z = obs_delta / sd

        if not use_pls:
            d = torch.empty((n,), dtype=dt, device=dev)
            for start, _, mb, _ in blocks():
                diff = (rank_rows(start, mb) - mean) / sd - obs_z[None, :]
                # overlap rows get the same values again
                d[start:start + row_bs] = torch.sqrt((diff * diff).sum(dim=1))
            d[n_true:] = math.inf
            return d, torch.zeros((), dtype=torch.int64, device=dev), lambdas

        pmean, psd, _ = _dual_moment_stats(*acc[4:], c_par, n_true)
        psd = torch.where(~(psd > eps), torch.ones_like(psd), psd)

        # ---- train and held-out z-Grams in one pass; the held-out Grams
        # in score space factor through R (T'T = R'(X'X)R, T'Y = R'(X'Y)),
        # so PRESS needs no score matrix ----
        xtx = torch.zeros((nmet, nmet), dtype=dt, device=dev)
        xty = torch.zeros((nmet, npar), dtype=dt, device=dev)
        xtx_te = torch.zeros_like(xtx)
        xty_te = torch.zeros_like(xty)
        yty = torch.zeros((npar,), dtype=dt, device=dev)
        for start, flo, mb, pb in blocks():
            if flo >= n_true:
                continue
            zb = (rank_rows(start, mb) - mean) / sd
            zpb = (pb - pmean) / psd
            if max(start, flo) < n_train:
                tr = mask(start, flo, 0, n_train)
                xm = masked(zb, tr)
                xtx += xm.T @ xm
                xty += xm.T @ masked(zpb, tr)
            if start + row_bs > n_train:
                te = mask(start, flo, n_train, n_true)
                xt = masked(zb, te)
                zt = masked(zpb, te)
                xtx_te += xt.T @ xt
                xty_te += xt.T @ zt
                yty += (zt * zpb).sum(0)
        R, _, Q = pls_mod._fit_gram(xtx, xty, max_comp)
        G = R.T @ xty_te                                      # [A, p]
        H = (R.T @ xtx_te) @ R                                # [A, A]
        QT = Q.T
        press = self._press(G, H, yty, QT)

        def vdv_window():
            # z-score and project the window's rows alone
            nsub = min(n, max(self.vdv_max_rows, 1))
            start = max(n_true - nsub, 0)
            rows = slice(start, start + nsub)
            g_s = torch.arange(start, start + nsub, device=dev)
            mb = mets[rows]
            if use_bc:
                v = torch.where((g_s < n_true)[:, None],
                                mb + shift[None, :], torch.ones_like(mb))
                mb = stats_mod.box_cox(v, lam_c[None, :])
            t_s = ((mb - mean) / sd) @ R
            zp_s = (params[rows] - pmean) / psd
            test_s = ((g_s >= n_train) & (g_s < n_true)).to(dt)[:, None]
            return t_s, zp_s, test_s, g_s

        ncomp_report, col_mask = self._select(press, QT, vdv_window,
                                              vdv_seed, max_comp)
        obs_scores = (obs_z @ R) * col_mask[0]
        d = torch.empty((n,), dtype=dt, device=dev)
        for start, _, mb, _ in blocks():
            tb = (((rank_rows(start, mb) - mean) / sd) @ R) * col_mask
            diff = tb - obs_scores[None, :]
            d[start:start + row_bs] = torch.sqrt((diff * diff).sum(dim=1))
        d[n_true:] = math.inf
        return d, ncomp_report, lambdas

    def _finish(self, params, mets, d, ncomp_report, lambdas, keep, n_next,
                draws, prev_state):
        """Top-K, doubled variance, weights and the proposal."""
        dt, dev = self.dtype, self.device
        _, surv_idx = torch.topk(-d, keep, sorted=True)
        surv_par = params[surv_idx]
        surv_met = mets[surv_idx]

        smean = surv_par.mean(0)
        dv = 2.0 * ((surv_par - smean[None, :]) ** 2).sum(0) / max(keep - 1, 1)
        if prev_state is None:
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

        loop = None
        if n_next == 0:
            nxt = torch.zeros((0, self.par_set.npar), dtype=dt, device=dev)
            nxt_seeds = torch.zeros((0,), dtype=torch.int64, device=dev)
        else:
            nxt, nxt_seeds, loop = self._propose(surv_par, w, dv, n_next,
                                                 draws)
        res = GenerationResult(
            mets, d, surv_idx, surv_par, surv_met, w, dv, nxt, nxt_seeds,
            ncomp_report, lambdas)
        if self._capturing:
            res.mvn_loop = loop
        else:
            res.mvn_rounds, res.mvn_finished_eagerly = (
                self._finish_rejection(loop, nxt))
        return res

    def _finish_rejection(self, loop: RejectionLoop | None, nxt):
        """Read the count of a step's MULTIVARIATE rejection loop (one host
        read per block) and, where a row was still rejected after the first
        block, run the further rounds eagerly and write the finished rows
        into ``nxt`` in place. ``loop`` is left as the step made it (a
        captured step's is replayed again). Returns (count, whether rounds
        ran past the first block)."""
        if loop is None:
            return 0, False
        loop = copy.copy(loop)
        first_block = loop.rounds
        rounds, vals = loop.finish()
        more = loop.rounds > first_block
        if more:
            nxt.copy_(vals)
            self.mvn_eager_finishes += 1
        return rounds, more

    @staticmethod
    def _bc_one(v, lam: float):
        return torch.log(v) if lam == 0 else (torch.pow(v, lam) - 1.0) / lam

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
            y = self._bc_one(v, lam)
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

    def _vdv_ok(self, t_s, zp_s, test_s, g_s, QT, press, vdv_seed):
        """Van der Voet randomization test as one moment expansion over the
        window rows (scores ``t_s`` [ns, A], z-parameters ``zp_s`` [ns, p],
        held-out mask ``test_s`` [ns, 1], row indices ``g_s``): every
        statistic S_w[a, j] = sum_n w_n test_n (zp_nj - sum_{b<=a} t_nb
        QT_bj)^2, for w = 1 (observed) and each sign row, expands into
        W @ [zp^2 | t x zp | t x t] plus a tiny prefix-sum recombination.
        The three right-hand sides are multiplied separately (never
        concatenated: at 100 metrics the t x t block alone is ~4 GB).
        Returns (ok [A, p], u0_bad 0-d bool)."""
        dt = t_s.dtype
        nsub, max_comp = t_s.shape
        npar = zp_s.shape[1]
        sgn = pls_mod.vdv_signs(vdv_seed, self.vdv_permutations, g_s, dt)
        W = torch.cat([torch.ones((1, nsub), dtype=dt, device=t_s.device),
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
        """The proposal as a call of its own (the split-propose phase):
        with the same step's ``draws`` it returns what the unsplit step
        would have put into ``next_params`` / ``next_seeds``, draw for
        draw. Returns (next_params [N2, P], seeds, the count of the
        MULTIVARIATE rejection loop; 0 with INDEPENDENT noise)."""
        self.dispatches += 1
        nxt, seeds, loop = self._propose(surv_par, w, dv, n_next, draws)
        return nxt, seeds, self._finish_rejection(loop, nxt)[0]

    def _pick(self, w, pick_draw, n_next: int):
        """Resampled survivor indices [N2] int64 from the pick draws."""
        dt = self.dtype
        keep = w.shape[0]
        cdf = torch.cumsum(w, dim=0)
        pick_draw = pick_draw.to(dt)
        if self.resample_method == "systematic":
            g2 = torch.arange(n_next, device=self.device)
            pts = _stratum_points(g2, pick_draw, cdf[-1] / n_next, dt)
            if n_next >= self.sorted_pick_min:
                # f32 rounding at the 4096-index block edges can invert
                # neighbours by a few ulps; project onto monotone first
                pts = torch.cummax(pts, dim=0).values
                return _sorted_searchsorted(cdf, pts, n_next)
            return torch.clamp_max(torch.searchsorted(cdf, pts), keep - 1)
        if n_next >= self.sorted_pick_min:
            # sorted uniforms by exponential spacings: u_(i) = S_i / S_{n+1}
            s = torch.cumsum(pick_draw, dim=0)
            u = (s[:-1] / s[-1]) * cdf[-1]
            return _sorted_searchsorted(cdf, u, n_next)
        u = pick_draw * cdf[-1]
        return torch.clamp_max(torch.searchsorted(cdf, u), keep - 1)

    def _propose(self, surv_par, w, dv, n_next: int, draws: StepDraws):
        """Weighted resample of the survivors + truncated perturbation
        (src/AbcSmc.cpp:479-553). Returns (next_params, seeds, the
        MULTIVARIATE rejection loop after its first block, or None): the
        caller reads the loop's count (:meth:`_finish_rejection`)."""
        dt = self.dtype
        pick = self._pick(w, draws.pick, n_next)
        bs = self.row_block_for(n_next)
        if bs and bs < n_next and self.noise_type != NoiseType.MULTIVARIATE:
            # the truncated perturbation is a map of each row by itself
            # with many row-sized temporaries: block by block it gives the
            # same bits and holds only the picks and the output whole
            nxt = torch.empty((n_next, surv_par.shape[1]), dtype=dt,
                              device=self.device)
            for start in range(0, n_next, bs):
                rows = slice(start, min(start + bs, n_next))
                nxt[rows] = self.par_set.noise_independent(
                    surv_par[pick[rows]], dv, draws.noise_u[rows])
            return nxt, draws.next_seeds.to(torch.int64), None
        mu = surv_par[pick]
        loop = None
        if self.noise_type == NoiseType.MULTIVARIATE:
            # covariance with the n-1 divisor in full FP32, diagonal alone
            # doubled; a collapsed column gives a NaN factor, as in JAX:
            # no row is ever accepted and every row falls back to its mu
            L = setup_mvn_sampler(surv_par)
            loop = self.par_set.multivariate_rejection(
                mu, L, draws.noise_eps, self.max_retries, draws.retry_seed,
                self.rejection_block,
            )
            nxt = loop.values()
        else:
            nxt = self.par_set.noise_independent(mu, dv, draws.noise_u)
        return nxt.to(dt), draws.next_seeds.to(torch.int64), loop

    # ------------------------------------------------------- fused dispatch
    @staticmethod
    def _leaves(res: GenerationResult, params, seeds, full_history: bool):
        """One set's history leaves, in the JAX package's order."""
        base = (res.survivor_idx, res.survivor_params, res.survivor_metrics,
                res.weights, res.doubled_variance, res.ncomp_used)
        if full_history:
            base += (params, seeds, res.metrics)
        return base

    def _note_set(self, route, events, res):
        self.set_info.append({
            "route": route, "events": events, "sim_events": res.sim_events,
            "mvn_rounds": res.mvn_rounds,
            "mvn_finished_eagerly": res.mvn_finished_eagerly,
            "box_cox_lambdas": (None if res.box_cox_lambdas is None
                                else res.box_cox_lambdas.clone()),
        })

    def _eager_set(self, params, seeds, keep, n_next, draws, state, n_valid):
        events = None
        if self.device.type == "cuda":
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record()
        res = self.step(params, seeds, keep, n_next, draws, state,
                        n_valid=n_valid)
        if events:
            events[1].record()
        self._note_set("eager", events, res)
        return res

    def _capture(self, n: int, keep: int, like: GenerationResult,
                 like_draws: StepDraws) -> _CapturedStep:
        """Capture the later-set step at (n, keep, n_next = n) into a CUDA
        graph with static inputs shaped like an eager set's. The caller
        has just run that eager set on a side stream: the kernel is built
        and loaded, the launch plan and every cached constant exist, so
        the capture meets no first-use work. The kernel's workspace is
        allocated inside the capture (the graph's own pool) and its
        arrival counters and rerun flag are reset by its prologue kernel,
        which is part of the graph."""
        from abcsmc_tpu_torch.ops.kernels import mixture_logsumexp

        t0 = time.perf_counter()
        params = torch.empty_like(like.next_params)
        seeds = torch.empty_like(like.next_seeds)
        state = tuple(torch.empty_like(x) for x in (
            like.survivor_params, like.weights, like.doubled_variance))
        draws = StepDraws(*(
            None if getattr(like_draws, f) is None
            else torch.empty_like(getattr(like_draws, f))
            for f in _DRAW_FIELDS))
        # a valid input for the capture pass's shape-only work
        params.copy_(like.next_params)
        seeds.copy_(like.next_seeds)
        for dst, src in zip(state, (like.survivor_params, like.weights,
                                    like.doubled_variance)):
            dst.copy_(src)
        self._copy_draws(draws, like_draws)
        before = mixture_logsumexp.launches
        torch.cuda.synchronize(self.device)
        graph = torch.cuda.CUDAGraph()
        # the MULTIVARIATE count stays on the device: read after a replay
        self._capturing = True
        try:
            with torch.cuda.graph(graph):
                mets = self._simulate(params, seeds)
                result = self._step(params, mets, keep, n, draws, state, None)
        finally:
            self._capturing = False
        # the wrapper counted the launches it recorded; none ran yet
        held = mixture_logsumexp.launches - before
        mixture_logsumexp.launches = before
        self.graph_captures += 1
        self.capture_seconds += time.perf_counter() - t0
        return _CapturedStep(graph, params, seeds, state, draws, result, held)

    @staticmethod
    def _copy_draws(dst: StepDraws, src: StepDraws):
        for f in _DRAW_FIELDS:
            if getattr(dst, f) is not None:
                getattr(dst, f).copy_(getattr(src, f))

    def _replay(self, cap: _CapturedStep, params, seeds, state,
                draws: StepDraws) -> GenerationResult:
        """One set through the captured step: copy its inputs into the
        static buffers, replay, and return the static result (valid until
        the next replay). A MULTIVARIATE step's count is read here, once
        per set, and a set whose rows were not all accepted in the graph's
        block is finished eagerly in place (:meth:`_finish_rejection`)
        before the caller draws the next set."""
        from abcsmc_tpu_torch.ops.kernels import mixture_logsumexp

        events = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
        events[0].record()
        cap.params.copy_(params)
        cap.seeds.copy_(seeds)
        for dst, src in zip(cap.state, state):
            dst.copy_(src)
        self._copy_draws(cap.draws, draws)
        cap.graph.replay()
        res = cap.result
        res.mvn_rounds, res.mvn_finished_eagerly = self._finish_rejection(
            res.mvn_loop, res.next_params)
        events[1].record()
        self.dispatches += 1
        self.graph_replays += 1
        mixture_logsumexp.launches += cap.kernel_launches
        self._note_set("replay", events, cap.result)
        return cap.result

    #: a bucket is captured only when at least this many of its sets would
    #: replay the graph (the first set of a bucket runs eagerly as the
    #: warm-up, and a capture costs about as much host time as an eager set)
    min_replays = 2
    #: rounds of the MULTIVARIATE rejection loop per block (the rounds a
    #: captured step holds); any value gives the same rows
    rejection_block = REJECTION_BLOCK

    def _run_bucket(self, params, seeds, state, generator, L: int, n: int,
                    keep: int, full_history: bool):
        """``L`` later sets of one shape (n, keep, proposal n), the
        incoming state [keep]-shaped; each set's draws come from
        ``generator`` just before it runs, between replays and never
        inside a capture. On a capturable CUDA step with enough sets the
        first runs eagerly on a side stream (the warm-up), the step is
        captured once per shape and the others replay it; otherwise every
        set runs eagerly. Returns (params, seeds, state, stacked leaves,
        last result)."""
        stacks = None
        res = None
        use_graph = self.capturable and L - 1 >= self.min_replays
        key = (n, keep, self.sorted_pick_min, self.row_block_for(n),
               self.rejection_block)
        cap = self._graphs.get(key) if use_graph else None
        for i in range(L):
            draws = self.draw_step(generator, n)
            if cap is not None:
                res = self._replay(cap, params, seeds, state, draws)
                # the carry may be the static output this replay has just
                # overwritten: the set's population is the static input
                params, seeds = cap.params, cap.seeds
            elif use_graph:
                side = torch.cuda.Stream(self.device)
                main = torch.cuda.current_stream(self.device)
                side.wait_stream(main)
                with torch.cuda.stream(side):
                    res = self._eager_set(params, seeds, keep, n, draws,
                                          state, n)
                main.wait_stream(side)
                for f in dataclasses.fields(res):
                    if isinstance(getattr(res, f.name), torch.Tensor):
                        getattr(res, f.name).record_stream(main)
                cap = self._graphs[key] = self._capture(n, keep, res, draws)
            else:
                res = self._eager_set(params, seeds, keep, n, draws, state,
                                      n)
            leaves = self._leaves(res, params, seeds, full_history)
            if stacks is None:
                stacks = tuple(
                    torch.empty((L,) + tuple(x.shape), dtype=x.dtype,
                                device=x.device) for x in leaves)
            for stack, leaf in zip(stacks, leaves):
                stack[i].copy_(leaf)
            # a replayed set's result is the graph's static output: the next
            # replay copies its carry into the static inputs before it
            # overwrites it, in stream order
            params, seeds = res.next_params, res.next_seeds
            state = (res.survivor_params, res.weights, res.doubled_variance)
        if cap is not None and res is cap.result:
            # what leaves the bucket must outlive later replays
            res = dataclasses.replace(res, **{
                f.name: getattr(res, f.name).clone()
                for f in dataclasses.fields(res)
                if isinstance(getattr(res, f.name), torch.Tensor)})
            params, seeds = res.next_params, res.next_seeds
            state = (res.survivor_params, res.weights, res.doubled_variance)
        return params, seeds, state, stacks, res

    def run_scan(self, generator: torch.Generator, n: int, keep: int,
                 gens: int, full_history: bool = False):
        """``gens`` generations of one shape (n, keep) as one fused run:
        generation 0 eagerly, the others as one bucket
        (:meth:`_run_bucket`). The draws replicate the sequential loop
        (:meth:`init_population`, then one :meth:`draw_step` per set from
        the one generator, just before the set runs), so everything a set
        stores equals the sequential loop's, bit for bit on the CPU.
        Every set proposes ``n`` rows; the last set's proposal is unused.

        On a CUDA device the bucket's step is captured into a CUDA graph
        once per shape and replayed per set (kept on this object for later
        calls); on the CPU and for buckets too short to pay for a capture,
        every set runs eagerly. ``set_info`` says which route each set
        took.

        Returns ``(result, history)``: the last generation's
        :class:`GenerationResult` and the stacked per-generation leaves
        ``(survivor_idx [G,K], survivor_params [G,K,P], survivor_metrics
        [G,K,M], weights [G,K], doubled_variance [G,P], ncomp_used [G])``,
        with ``full_history`` also ``(params [G,N,P], seeds [G,N], metrics
        [G,N,M])``: enough to mirror every generation into the run store.
        That costs ``gens * n * (P + M + 2)`` more words on the device;
        callers gate it by size (``AbcSmc.run_device`` does)."""
        if gens < 1:
            raise ValueError(f"gens must be >= 1, got {gens}")
        self.set_info = []
        params, seeds = self.init_population(generator, n)
        res = self._eager_set(params, seeds, keep, n,
                              self.draw_step(generator, n), None, n)
        first = tuple(x[None] for x in self._leaves(res, params, seeds,
                                                     full_history))
        if gens == 1:
            return res, first
        state = (res.survivor_params, res.weights, res.doubled_variance)
        _, _, _, stacks, last = self._run_bucket(
            res.next_params, res.next_seeds, state, generator, gens - 1, n,
            keep, full_history)
        return last, tuple(torch.cat([a, b]) for a, b in zip(first, stacks))

    @staticmethod
    def bucket_plan(set_sizes, keep_sizes):
        """How :meth:`run_chain` cuts a schedule: a list of (first set,
        length). A set joins an ``n``-bucket when its own (n, keep) matches
        and its successor has ``n`` rows too (the final set joins with an
        unused proposal); set 0 runs singly (it has no previous state), and
        so does the first set of a bucket whose incoming state has another
        ``keep``."""
        G = len(set_sizes)

        def scannable(u: int, n_t: int, keep_t: int) -> bool:
            return (set_sizes[u] == n_t and keep_sizes[u] == keep_t
                    and (u + 1 >= G or set_sizes[u + 1] == n_t))

        plan, t = [], 0
        while t < G:
            n_t, keep_t = set_sizes[t], keep_sizes[t]
            L = 1
            if t > 0 and scannable(t, n_t, keep_t):
                while t + L < G and scannable(t + L, n_t, keep_t):
                    L += 1
            if L > 1 and keep_sizes[t - 1] != keep_t:
                L = 1
            plan.append((t, L))
            t += L
        return plan

    def planned_replays(self, set_sizes, keep_sizes) -> int:
        """The sets of a schedule that the fused route would replay from a
        captured graph (0 where the step is not capturable): every set of a
        long enough bucket but its first."""
        if not self.capturable:
            return 0
        return sum(L - 1 for _, L in self.bucket_plan(set_sizes, keep_sizes)
                   if L - 1 >= self.min_replays)

    def run_chain(self, generator: torch.Generator, set_sizes, keep_sizes,
                  full_history: bool = False, bucketed_history: bool = False):
        """A varying-size schedule: maximal runs of consecutive sets with
        one (n, keep) whose successor has ``n`` rows too form a bucket
        (:meth:`_run_bucket`: one captured step replayed per set where the
        step is capturable); size-transition sets run singly. The final
        set joins a bucket with an unused ``n``-row proposal; the first set
        of a bucket is peeled when the incoming state has another ``keep``
        (the bucket's step has one static state shape). The draws
        replicate the sequential loop, as in :meth:`run_scan`.

        Returns ``(state, history)``: the final (survivor_params, weights,
        doubled_variance) and a list with one tuple of leaves per set
        (:meth:`run_scan`'s layout, unstacked). ``bucketed_history=True``
        returns it unsliced instead: ``("set", leaves)`` and ``("bucket",
        L, stacked leaves [L, ...])`` entries, which a caller fetches whole
        and slices on the host."""
        G = len(set_sizes)
        if G < 1 or len(keep_sizes) != G:
            raise ValueError("set_sizes and keep_sizes must be equally long "
                             "and not empty")
        self.set_info = []

        params, seeds = self.init_population(generator, set_sizes[0])
        state = None
        history = []
        for t, L in self.bucket_plan(set_sizes, keep_sizes):
            n_t, keep_t = set_sizes[t], keep_sizes[t]
            if L == 1:
                n_next = set_sizes[t + 1] if t + 1 < G else 0
                res = self._eager_set(
                    params, seeds, keep_t, n_next,
                    self.draw_step(generator, n_next), state, n_t)
                entry = self._leaves(res, params, seeds, full_history)
                history.append(("set", entry) if bucketed_history else entry)
                state = (res.survivor_params, res.weights,
                         res.doubled_variance)
                params, seeds = res.next_params, res.next_seeds
            else:
                params, seeds, state, ys, _ = self._run_bucket(
                    params, seeds, state, generator, L, n_t, keep_t,
                    full_history)
                if bucketed_history:
                    history.append(("bucket", L, ys))
                else:
                    history.extend(tuple(y[i] for y in ys)
                                   for i in range(L))
        return state, history

    def run(self, generator: torch.Generator, set_sizes, keep_sizes):
        """The sequential loop: every generation as its own eager step.
        Returns the final :class:`GenerationResult` and the per-generation
        (survivor_params, weights, doubled_variance) states."""
        self.set_info = []
        params, seeds = self.init_population(generator, set_sizes[0])
        state, history, res = None, [], None
        for t, (n_t, keep_t) in enumerate(zip(set_sizes, keep_sizes)):
            n_next = set_sizes[t + 1] if t + 1 < len(set_sizes) else 0
            draws = self.draw_step(generator, n_next)
            res = self._eager_set(params, seeds, keep_t, n_next, draws,
                                  state, n_t)
            state = (res.survivor_params, res.weights, res.doubled_variance)
            history.append(state)
            params, seeds = res.next_params, res.next_seeds
        return res, history
