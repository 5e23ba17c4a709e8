"""One SMC generation on one device or over a particle mesh (port of
:class:`abcsmc_tpu.parallel.generation.ShardedGeneration`).

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

The particle mesh (``mesh=``, :mod:`abcsmc_tpu_torch.parallel.mesh`): the
population is cut into ``mesh.size`` equal shards (``n`` padded up to a
multiple, padding masked out of every statistic; 300-308), each shard's
row passes run on its device and their partials are summed in shard order
(the psums of 791-837, 924, 929-966, 1001-1041, 1145); the global top-K
gathers the shards' candidates, in one stage or two (1254-1295); the
weight kernel runs once per shard on ``ceil(keep / size)`` survivors
(1303-1330); each shard proposes its own rows (423-526). A sharded buffer
is a list of this process's shard tensors. Without a mesh the step is the
one-shard mesh on ``device`` and takes and returns plain tensors.

One deviation from the JAX step: the van der Voet window is the last
``vdv_max_rows`` valid rows of the *global* population, split among the
shards that own them (JAX takes the tail ``ceil(vdv_max_rows / size)``
rows of every shard, 1059-1067); the two agree wherever the cap does not
bind, and this rule makes the selection independent of the shard count.
"""

from __future__ import annotations

import copy
import dataclasses
import math
import time
from dataclasses import dataclass

import numpy as np
import torch
from torch.profiler import record_function

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
from abcsmc_tpu_torch.parallel.mesh import (
    ParticleMesh, fetch_rows_global, single_mesh,
)
from abcsmc_tpu_torch.spans import StepStages

_SEED_HIGH = np.iinfo(np.int32).max   # per-particle seeds in [0, 2^31 - 1)
_M64 = (1 << 64) - 1
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


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def shard_seed(step_seed: int, shard: int) -> int:
    """The seed of shard ``shard``'s generator in a step whose seed is
    ``step_seed``: a counter hash, so any process layout with the same
    shard count draws the same numbers (JAX: ``fold_in(key, shard)``)."""
    return _splitmix64(_splitmix64(int(step_seed)) ^ int(shard)) >> 1


def _shard_generator(step_seed: int, shard: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(shard_seed(step_seed, shard))
    return g


def _draw_host_seed(generator: torch.Generator) -> int:
    """One 63-bit seed drawn from ``generator`` (a host read: on a CPU
    generator, no device sync)."""
    return int(torch.randint(0, 2**63 - 1, (), generator=generator,
                             device=generator.device))


def _tmap(fn, x):
    """``fn`` over a tensor or each tensor of a shard list (None stays)."""
    if x is None:
        return None
    if isinstance(x, list):
        return [fn(t) for t in x]
    return fn(x)


def _shard(x, i: int):
    """Shard ``i`` of a shard list; a tensor is shared by every shard."""
    return x[i] if isinstance(x, list) else x


def _tensors(x):
    """``x`` when it is a tensor or a list of tensors, else None."""
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, list) and x and isinstance(x[0], torch.Tensor):
        return x
    return None


def _copy_into(dst, src):
    """``dst.copy_(src)`` for a tensor or each shard of a list."""
    if isinstance(dst, list):
        for d, s in zip(dst, src):
            d.copy_(s)
    else:
        dst.copy_(src)


#: the row length of :func:`_blocked_cumsum`
_SCAN_ROW = 1024


def _cumsum(x):
    """``torch.cumsum(x, 0)`` of a 1-D float tensor, the same bits on every
    call. On a CUDA device a 1-D scan runs through a decoupled look-back
    scan whose float sums take an order that depends on timing (a pick
    near a cdf edge then changes between runs: 140 of 1,000,000 rows at
    keep 50,000 on an H100), so the card runs :func:`_blocked_cumsum`. The
    CPU scan is kept."""
    if x.device.type != "cuda":
        return torch.cumsum(x, dim=0)
    return _blocked_cumsum(x)


def _blocked_cumsum(x, row: int = _SCAN_ROW):
    """The inclusive scan of a 1-D tensor in a fixed order: cut into rows
    of ``row`` entries (the last one zero-padded), each row scanned along
    dim 1 (the per-row kernel of a 2-D tensor, whose order is fixed), the
    row totals scanned the same way, and each row shifted by the total of
    the rows before it: no pass walks the whole vector in one block."""
    n = x.shape[0]
    if n <= row:
        return torch.cumsum(x[None, :].expand(2, -1), dim=1)[0]
    rows = -(-n // row)
    part = torch.nn.functional.pad(x, (0, rows * row - n)).view(
        rows, row).cumsum(dim=1)
    part[1:] += _blocked_cumsum(part[:, -1], row)[:-1, None]
    return part.view(-1)[:n]


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
    """Outputs of one generation step. On a mesh the fields marked
    [sharded] are lists of this process's shard tensors and the others are
    replicated on the lead device; without a mesh all are plain tensors on
    the step's device."""

    metrics: torch.Tensor          # [N, M] [sharded] simulated metrics
    distances: torch.Tensor        # [N] [sharded] distances (+inf: padding)
    survivor_idx: torch.Tensor     # [K] global row indices of survivors
    survivor_params: torch.Tensor  # [K, P]
    survivor_metrics: torch.Tensor  # [K, M]
    weights: torch.Tensor          # [K] L2-normalized importance weights
    doubled_variance: torch.Tensor  # [P]
    next_params: torch.Tensor      # [N2, P] [sharded] next generation
    next_seeds: torch.Tensor       # [N2] [sharded] int64 seeds
    ncomp_used: torch.Tensor       # 0-d: PLS components used (0 = SIMPLE;
    #                                NEGATIVE = the U0 self-check fired)
    box_cox_lambdas: torch.Tensor | None = None   # [M] chosen lambdas
    mvn_rounds: int = 0            # the MULTIVARIATE rejection loop's
    #                                count (JAX's loop counter; 0 = no such
    #                                proposal in this step)
    mvn_loop: RejectionLoop | None = None  # a captured step's loop (a
    #                                list, one per shard, on a mesh): its
    #                                count is read after each replay
    mvn_finished_eagerly: bool = False  # rounds ran past the first block
    sim_events: tuple | None = None  # CUDA events around the simulate stage
    #                                  (an eager step on the card that
    #                                  simulated; None for a replayed one)
    stages: StepStages | None = None  # the stages after it and their
    #                                   events (none timed in a replay)
    sim_steps: float | None = None  # time steps the simulate stage ran a
    #                                 row (a replay: the captured step's;
    #                                 None: no time loop, or no simulate)
    sim_counts: torch.Tensor | None = None  # float64 [k]: the rise of the
    #                                 simulator's device counts a row (its
    #                                 ``count_names``; a replay recomputes
    #                                 them; None: it keeps none)
    sim_stats_events: tuple | None = None  # CUDA event pairs around the
    #                                 simulator's row statistics (an eager
    #                                 step on the card; None: untimed)
    mvn_factor: torch.Tensor | None = None  # [P, P] the MULTIVARIATE
    #                                         proposal's Cholesky factor


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

    The JAX step derives them per shard as ``k_pick, k_noise, k_seed =
    split(fold_in(key, shard), 3)`` (abcsmc_tpu/parallel/generation.py
    :431-432); its first MULTIVARIATE round is ``normal(split(k_noise)[1])``
    and its systematic offset one draw shared by every shard (444-449).

    On a one-shard step the fields are the tensors above, drawn from one
    generator in one order. On a mesh of k > 1 shards ``pick`` (unless
    systematic), ``noise_u``, ``next_seeds`` and ``noise_eps`` are lists of
    this process's shards, each ``ceil(N2 / k)`` rows drawn from the
    shard's own generator (:func:`shard_seed`); ``vdv_seed``,
    ``retry_seed`` and the systematic offset are shared.
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
    (population or, for a precomputed step, parameters and metrics;
    previous state; draws), the static result, and the kernel launches the
    graph holds (what ``kernels.graph_capture_counts`` yielded)."""

    def __init__(self, graph, params, seeds, state, draws, result,
                 kernel_launches: dict, metrics=None):
        self.graph = graph
        self.params = params
        self.seeds = seeds
        self.metrics = metrics          # a precomputed step's static metrics
        self.state = state
        self.draws = draws
        self.result = result
        self.kernel_launches = kernel_launches


class Generation:
    """The generation step, on one device or over a particle mesh.
    Configuration is fixed at construction; shapes (N, K, N2) are per call.
    ``mesh`` (a :class:`~abcsmc_tpu_torch.parallel.mesh.ParticleMesh`)
    shards the step; without one it runs on ``device`` and takes and
    returns plain tensors, as the one-shard mesh there.

    ``noise_type``, ``max_retries`` (the bound of the MULTIVARIATE
    rejection loop) and ``box_cox`` (PLS filter only, as in the host
    ranking) are the config keys of the same names. ``weight_precision``
    is the weight kernel's dot scheme on every shard ("high" 3xTF32,
    "default" one BF16 pass, "highest" FP32 FMAs; each its own program of
    ``csrc/mixture_logsumexp.cu``, as each value is its own dot on the
    TPU); a constant of the step, so a captured graph holds that scheme's
    kernel and no value adds a host sync. On the CPU the value changes
    nothing, as in JAX off the TPU. ``max_pls_components`` (None: no
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
    which a chunked step and its proposal would not fit together; both
    count the rows of every shard that shares the card and compare per
    shard. On the CPU both rules are off. ``topk_two_stage``: None = auto
    (two stages on a mesh of more than one shard once the single stage's
    candidate rows reach ``_TOPK_TWO_STAGE_BYTES``), True/False force; the
    two give the same bits, and with one shard there is one top-K."""

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
        device=None,
        mesh: ParticleMesh | None = None,
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
        if mesh is None and device is None:
            raise ValueError("Generation needs a device or a mesh")
        #: without a mesh the public methods take and return plain tensors
        self._plain = mesh is None
        self.mesh = single_mesh(device) if mesh is None else mesh
        self.device = self.mesh.lead
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
            # thresholds in rows per shard: the shards that share the card
            # share its memory
            share = self.mesh.shards_per_device()
            self.row_chunk_threshold = max(
                1, int(budget // (self.resident_row_bytes() * share)))
            # a block's temporaries cost about twice a resident row each
            self.split_threshold = max(1, int(
                (budget - 2 * ROW_BLOCK_AUTO * self.resident_row_bytes()
                 * share)
                // ((self.chunked_row_bytes() + self.propose_row_bytes())
                    * share)))
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
        #: host seconds of the replayed sets (:meth:`_replay`, span
        #: ``abcsmc.replay``): copies in, the replay, the MULTIVARIATE
        #: count read and any eager finish of its rounds
        self.replay_seconds = 0.0
        #: steps whose MULTIVARIATE rejection loop ran past its first block
        self.mvn_eager_finishes = 0
        self._capturing = False
        #: the stages of the step that is running (:meth:`_step` makes
        #: them; the ranking's selection and :meth:`_finish` mark theirs)
        self._stages = StepStages(timed=False)
        #: per set of the last run_scan / run_chain / run, its
        #: :meth:`set_record`
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
        """The block of the chunked row passes for a shard of ``n`` rows,
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
        k = self.mesh.size
        return (max(self.mesh.padded(n), self.mesh.padded(n_next)) // k
                >= self.split_threshold)

    def capture_blocker(self, with_simulator: bool = True) -> str | None:
        """Why a later-set step cannot be captured into a CUDA graph, or
        None when it can: it needs a CUDA device with every shard of a
        one-process mesh on it (the step has no host sync of its own; a
        MULTIVARIATE step's count is read after the replay) and, where the
        step simulates (``with_simulator``), a simulator without a host
        round trip (``DeviceSimulator.capturable``; a
        :class:`~abcsmc_tpu_torch.models.simulators.HostBridgeSimulator`
        has one). Such steps run eagerly."""
        if self.device.type != "cuda":
            return "no CUDA device"
        if not self.mesh.one_device:
            return "a mesh across devices or processes"
        if with_simulator and not getattr(self.simulator, "capturable",
                                          True):
            return "the simulator makes a host round trip"
        return None

    @property
    def capturable(self) -> bool:
        """True when a later-set step, its simulate stage included, can be
        captured into a CUDA graph (:meth:`capture_blocker`)."""
        return self.capture_blocker() is None

    # ------------------------------------------------------- shard lists
    def _in(self, x):
        """A public argument as a shard list (a plain tensor is the one
        shard of a step without a mesh)."""
        if x is None or isinstance(x, list):
            return x
        if isinstance(x, tuple):
            return list(x)
        if self.mesh.n_local != 1:
            raise ValueError("a mesh step takes a list of shard tensors")
        return [x]

    def _out(self, x):
        """A shard list as the public methods return it."""
        if self._plain and isinstance(x, list):
            return x[0]
        return x

    def _out_result(self, res: GenerationResult) -> GenerationResult:
        if not self._plain:
            return res
        return dataclasses.replace(res, **{
            f.name: getattr(res, f.name)[0] for f in dataclasses.fields(res)
            if isinstance(getattr(res, f.name), list)})

    def shard_rows(self, x, n_valid: int | None = None):
        """A host or device [n, ...] buffer in the step's layout: itself
        on the step's device without a mesh, else padded to a multiple of
        the shard count and cut into this process's shards."""
        if self._plain:
            return torch.as_tensor(x).to(self.device)
        return self.mesh.shard_rows(x, n_valid)

    # ------------------------------------------------------------- draws
    def init_population(self, generator: torch.Generator, n: int):
        """Generation 0: prior draws [n, P] and per-particle seeds [n]. On
        a mesh of k > 1 shards each shard draws its ``ceil(n / k)`` rows
        from its own generator (JAX: ``fold_in(key, shard)``, 310-337)."""
        self.dispatches += 1
        if self.mesh.size == 1:
            params = self.par_set.sample_priors(generator, n, self.dtype)
            seeds = torch.randint(0, _SEED_HIGH, (n,), generator=generator,
                                  device=self.device)
            return self._out([params]), self._out([seeds])
        seed = _draw_host_seed(generator)
        local_n = self.mesh.padded(n) // self.mesh.size
        params, seeds = [], []
        for s, dev in self.mesh.shards:
            g = _shard_generator(seed, s, dev)
            params.append(self.par_set.sample_priors(g, local_n, self.dtype))
            seeds.append(torch.randint(0, _SEED_HIGH, (local_n,),
                                       generator=g, device=dev))
        return params, seeds

    def draw_vdv_seed(self, generator: torch.Generator) -> StepDraws:
        """The first draw of a step: the van der Voet sign seed alone (the
        ranking needs no other). :meth:`draw_proposal` completes it."""
        dev = self.device if self.mesh.size == 1 else generator.device
        return StepDraws(
            torch.randint(0, 2**32, (), generator=generator,
                          device=dev).to(self.device), None, None, None)

    def draw_proposal(self, generator: torch.Generator, n_next: int,
                      draws: StepDraws) -> StepDraws:
        """The proposal draws of a step whose seed :meth:`draw_vdv_seed`
        drew from the same generator: together they consume it exactly as
        :meth:`draw_step` does."""
        if self.mesh.size > 1:
            return self._draw_proposal_mesh(generator, n_next, draws)
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

    def _draw_proposal_mesh(self, generator, n_next: int, draws: StepDraws):
        """:meth:`draw_proposal` on a mesh of k > 1 shards: the step's seed,
        the systematic offset and the retry seed from ``generator`` (host
        reads, no device sync on a CPU generator), then each shard's rows
        from its own generator."""
        dt, lead = self.dtype, self.device
        step_seed = _draw_host_seed(generator)
        mvn = self.noise_type == NoiseType.MULTIVARIATE
        systematic = self.resample_method == "systematic"
        shared_pick = retry_seed = None
        if systematic:
            shared_pick = torch.rand((), generator=generator,
                                     device=generator.device,
                                     dtype=dt).to(lead)
        if mvn:
            retry_seed = draw_retry_seed(generator).to(lead)
        local_next = self.mesh.padded(n_next) // self.mesh.size
        shape = (local_next, self.par_set.npar)
        picks, noise_u, noise_eps, seeds = [], [], [], []
        for s, dev in self.mesh.shards:
            g = _shard_generator(step_seed, s, dev)
            if systematic:
                pass
            elif local_next >= self.sorted_pick_min:
                pick = torch.empty((local_next + 1,), device=dev, dtype=dt)
                picks.append(pick.exponential_(generator=g))
            else:
                picks.append(torch.rand((local_next,), generator=g,
                                        device=dev, dtype=dt))
            if mvn:
                noise_eps.append(torch.randn(shape, generator=g, device=dev,
                                             dtype=dt))
            else:
                noise_u.append(torch.rand(shape, generator=g, device=dev,
                                          dtype=dt))
            seeds.append(torch.randint(0, _SEED_HIGH, (local_next,),
                                       generator=g, device=dev))
        return StepDraws(draws.vdv_seed,
                         shared_pick if systematic else picks,
                         None if mvn else noise_u, seeds,
                         noise_eps if mvn else None, retry_seed)

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
        padding, masked out of every statistic. On a mesh ``params`` and
        ``seeds`` are shard lists (:meth:`shard_rows`)."""
        return self._out_result(self._step_sim(
            self._in(params), self._in(seeds), keep, n_next, draws,
            prev_state, n_valid))

    def _step_sim(self, params, seeds, keep, n_next, draws, prev_state,
                  n_valid):
        self.dispatches += 1
        events = None
        with record_function("abcsmc.step"):
            if self.device.type == "cuda":
                events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                events[0].record()
            with record_function("abcsmc.step.simulate"):
                mets, counted = self._simulate_counted(params, seeds)
            if events:
                events[1].record()
            res = self._step(params, mets, keep, n_next, draws, prev_state,
                             n_valid)
        res.sim_events = events
        res.sim_steps, res.sim_counts, res.sim_stats_events = counted
        return res

    def _simulate_counted(self, params, seeds):
        """:meth:`_simulate`, and what the simulator counted of it:
        (the time steps its loop ran a row, its ``row_steps`` counter over
        the rows, None without one; the rise of its device counts a row, a
        float64 [k] tensor on the lead shard's device computed with no host
        sync, None where it keeps none; the CUDA event pairs around its row
        statistics, None where it times none)."""
        sim = self.simulator
        before = getattr(sim, "row_steps", None)
        names = getattr(sim, "count_names", ())
        devices = list(dict.fromkeys(p.device for p in params))
        start = [sim.device_counts(d).clone() for d in devices] \
            if names else None
        stats = getattr(sim, "stats_events", None)
        if stats is not None:
            stats.clear()
        mets = self._simulate(params, seeds)
        rows = max(sum(p.shape[0] for p in params), 1)
        steps = None if before is None else (sim.row_steps - before) / rows
        counts = None
        if names:
            counts = sum((sim.device_counts(d) - s).to(devices[0])
                         for d, s in zip(devices, start)).double() / rows
        # a tuple: a list in a result is a list of shards
        return mets, (steps, counts, tuple(stats or ()) or None)

    def _simulate(self, params, seeds):
        """Metrics [n, M] of each shard. Where the row passes are chunked
        the simulator runs block by block too (its temporaries are many
        times a metric row); a particle's metrics are a function of its own
        parameters and seed alone, so the blocks change nothing."""
        return [self._simulate_shard(p, s) for p, s in zip(params, seeds)]

    def _simulate_shard(self, params, seeds):
        n = params.shape[0]
        bs = self.row_block_for(n)
        if not bs or bs >= n:
            upars = self.transform.to_model_space(params).to(self.dtype)
            return self.simulator.batch_fn(upars, seeds).to(self.dtype)
        mets = torch.empty((n, len(self.obs)), dtype=self.dtype,
                           device=params.device)
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
        with record_function("abcsmc.step"):
            return self._out_result(self._step(
                self._in(params),
                [m.to(self.dtype) for m in self._in(metrics)],
                keep, n_next, draws, prev_state, n_valid))

    def _step(self, params, mets, keep, n_next, draws, prev_state, n_valid):
        params = [p.to(self.dtype) for p in params]
        local_n = params[0].shape[0]
        n = local_n * self.mesh.size
        n_true = n if n_valid is None else int(n_valid)
        if not 1 <= keep <= n_true <= n:
            raise ValueError(f"need 1 <= keep ({keep}) <= n_valid "
                             f"({n_true}) <= rows ({n})")
        bs = self.row_block_for(local_n)
        rank = self._rank_chunked if bs else self._rank_resident
        # the stages tile the step from the ranking on: the PLS fit (or,
        # without PLS, the distances at once), van der Voet (_select), the
        # distances and top-K, the weights, the proposal; no events in a
        # capture (a replayed set times none)
        stages = self._stages = StepStages(
            timed=self.device.type == "cuda" and not self._capturing)
        try:
            stages.begin("pls_fit" if self.filter_type == FilterType.PLS
                         else "topk")
            d, ncomp_report, lambdas = rank(params, mets, n_true, prev_state,
                                            draws.vdv_seed,
                                            *((bs,) if bs else ()))
            res = self._finish(params, mets, d, ncomp_report, lambdas, keep,
                               n_next, draws, prev_state)
        finally:
            stages.end()
        res.stages = stages
        return res

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
        ``vdv_window`` makes each shard's (scores, z-parameters, held-out
        mask, global row indices) of the test's window."""
        self._stages.begin("vdv")
        u0_bad = None
        if self.pls_optimal_method == "vdv":
            ok, u0_bad = self._vdv_ok(vdv_window(), QT, press, vdv_seed)
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
        self._stages.begin("topk")
        return ncomp_report, col_mask

    def _par_center(self, prev_state):
        return (self._prior_means if prev_state is None
                else prev_state[0].to(self.device, self.dtype).mean(0))

    def _vdv_rows(self, n: int, n_true: int, local_n: int):
        """Each local shard's slice of the van der Voet window, the last
        ``vdv_max_rows`` valid rows of the global population: (local start,
        local stop, global start) per shard, empty where a shard owns none
        of it (held-out rows live at the tail: training rows are the first
        ``n_train`` global indices)."""
        nsub = min(n, max(self.vdv_max_rows, 1))
        start = max(n_true - nsub, 0)
        out = []
        for i in range(self.mesh.n_local):
            off = self.mesh.row_offset(i, local_n)
            a = min(max(start, off), off + local_n)
            b = max(min(start + nsub, off + local_n), a)
            out.append((a - off, b - off, a))
        return out

    def _rank_resident(self, params, mets, n_true, prev_state, vdv_seed):
        """Ranking distances (one [local_n] tensor per shard) with every row
        buffer resident. Returns (distances, reported component count,
        Box-Cox lambdas or None)."""
        dt, mesh = self.dtype, self.mesh
        local_n = params[0].shape[0]
        n = local_n * mesh.size
        n_train, max_comp = self._sizes(n_true)
        use_pls = self.filter_type == FilterType.PLS
        eps = 1e-30
        obs = self._obs_t
        devs = [p.device for p in params]

        gidx = [torch.arange(mesh.row_offset(i, local_n),
                             mesh.row_offset(i, local_n) + local_n,
                             device=dev) for i, dev in enumerate(devs)]
        vmask = [(g < n_true).to(dt)[:, None] for g in gidx]  # [n, 1]

        # Box-Cox is a ranking-side transform (PLS only, as the host
        # ranking); stored and survivor metrics stay raw
        lambdas = None
        rank_mets = mets
        if self.box_cox and use_pls:
            rank_mets, obs, lambdas = self._box_cox(mets, vmask, n_true)

        # ---- metric moments, dual frames (shifted around obs, and raw) ----
        sums = [[], [], [], []]
        for rm, vm in zip(rank_mets, vmask):
            md = (rm - obs.to(rm.device)[None, :]) * vm
            mr = rm * vm
            for acc, x in zip(sums, (md.sum(0), (md * md).sum(0), mr.sum(0),
                                     (mr * rm).sum(0))):
                acc.append(x)
            del md, mr
        mean, sd, obs_delta = _dual_moment_stats(
            *(mesh.psum(x) for x in sums), obs, n_true)
        # constant column (or a NaN sd) -> unit scale (a tiny floor would
        # blow obs_z up)
        sd = torch.where(~(sd > eps), torch.ones_like(sd), sd)
        zmet = [(rm - mean.to(rm.device)) / sd.to(rm.device)
                for rm in rank_mets]
        obs_z = obs_delta / sd

        if use_pls:
            c_par = self._par_center(prev_state)
            sums = [[], [], [], []]
            for p, vm in zip(params, vmask):
                pd = (p - c_par.to(p.device)[None, :]) * vm
                pr = p * vm
                for acc, x in zip(sums, (pd.sum(0), (pd * pd).sum(0),
                                         pr.sum(0), (pr * p).sum(0))):
                    acc.append(x)
                del pd, pr
            pmean, psd, _ = _dual_moment_stats(
                *(mesh.psum(x) for x in sums), c_par, n_true)
            psd = torch.where(~(psd > eps), torch.ones_like(psd), psd)
            zpar = [(p - pmean.to(p.device)) / psd.to(p.device)
                    for p in params]

            # ---- PLS fit on the training rows (Grams) ----
            train = [(g < n_train).to(dt)[:, None] for g in gidx]
            xtx_p, xty_p = [], []
            for zm, zp, tr in zip(zmet, zpar, train):
                xm = zm * tr
                xtx_p.append(xm.T @ xm)
                xty_p.append(xm.T @ (zp * tr))
                del xm
            R, _, Q = pls_mod._fit_gram(mesh.psum(xtx_p), mesh.psum(xty_p),
                                        max_comp)

            # ---- NEW_DATA CV on the held-out rows, via Grams ----
            T, test = [], []
            g_p, h_p, y_p = [], [], []
            for zm, zp, tr, vm in zip(zmet, zpar, train, vmask):
                T.append(zm @ R.to(zm.device))                # [n, A]
                test.append(vm - tr)
                Tt = T[-1] * test[-1]
                g_p.append(Tt.T @ (zp * test[-1]))            # [A, p]
                h_p.append(Tt.T @ Tt)                         # [A, A]
                del Tt
                y_p.append((zp * zp * test[-1]).sum(0))       # [p]
            G, H, yty = mesh.psum(g_p), mesh.psum(h_p), mesh.psum(y_p)
            QT = Q.T                                          # [A, p]
            press = self._press(G, H, yty, QT)

            def vdv_window():
                return [(T[i][a:b], zpar[i][a:b], test[i][a:b], gidx[i][a:b])
                        for i, (a, b, _) in enumerate(
                            self._vdv_rows(n, n_true, local_n))]

            ncomp_report, col_mask = self._select(press, QT, vdv_window,
                                                  vdv_seed, max_comp)
            obs_scores = (obs_z @ R) * col_mask[0]
            diff = [t * col_mask.to(t.device)
                    - obs_scores.to(t.device)[None, :] for t in T]
        else:
            diff = [zm - obs_z.to(zm.device)[None, :] for zm in zmet]
            ncomp_report = torch.zeros((), dtype=torch.int64,
                                       device=self.device)
        out = []
        for df, g in zip(diff, gidx):
            d = torch.sqrt((df * df).sum(dim=1))
            # padding rows rank last, so they never enter the top-K
            out.append(torch.where(g < n_true, d,
                                   torch.full_like(d, float("inf"))))
        return out, ncomp_report, lambdas

    def _rank_chunked(self, params, mets, n_true, prev_state, vdv_seed,
                      row_bs: int):
        """:meth:`_rank_resident` with every O(n)-row pass walked in blocks
        of ``row_bs`` rows of each shard: no [n, M] z-score, [n, A] score or
        transformed metric buffer exists, only the raw inputs and the [n]
        distances. The last block of a shard is shifted back when
        ``row_bs`` does not divide its rows, and its rows below ``i *
        row_bs`` (already counted by the block before) are masked out of
        every sum as not ``fresh``. Each shard's sums are its partials of
        the mesh's psums."""
        dt, mesh = self.dtype, self.mesh
        local_n = params[0].shape[0]
        n = local_n * mesh.size
        nmet, npar = len(self.obs), self.par_set.npar
        n_train, max_comp = self._sizes(n_true)
        use_pls = self.filter_type == FilterType.PLS
        use_bc = self.box_cox and use_pls
        eps = 1e-30
        obs = self._obs_t
        n_blocks = -(-local_n // row_bs)
        starts = [min(i * row_bs, local_n - row_bs) for i in range(n_blocks)]
        devs = [p.device for p in params]
        offs = [mesh.row_offset(i, local_n) for i in range(len(params))]

        def mask(dev, start, flo, lo, hi):
            """[row_bs, 1] mask of the block's fresh rows with lo <= global
            index < hi (``start`` and ``flo`` global), or None when that is
            every row of the block (a product with 1 changes no bit, so it
            is skipped)."""
            if flo <= start and lo <= start and start + row_bs <= hi:
                return None
            g = torch.arange(start, start + row_bs, device=dev)
            return ((g >= max(flo, lo)) & (g < hi)).to(dt)[:, None]

        def masked(x, m):
            return x if m is None else x * m

        def blocks(i):
            """Shard ``i``'s blocks: (global start, global first fresh row,
            metric rows, parameter rows)."""
            for j, start in enumerate(starts):
                rows = slice(start, start + row_bs)
                yield (offs[i] + start, offs[i] + j * row_bs,
                       mets[i][rows], params[i][rows])

        def shards():
            return range(len(params))

        lambdas = None
        shift = lam_c = None
        if use_bc:
            inf = torch.full((), math.inf, dtype=dt, device=self.device)
            cmins = []
            for i in shards():
                cmin = torch.full((nmet,), math.inf, dtype=dt, device=devs[i])
                for start, _, mb, _ in blocks(i):
                    if start + row_bs > n_true:
                        g = torch.arange(start, start + row_bs,
                                         device=devs[i])
                        mb = torch.where((g < n_true)[:, None], mb,
                                         inf.to(devs[i]))
                    cmin = torch.minimum(cmin, mb.amin(0))
                cmins.append(cmin)
            col_min = torch.minimum(mesh.pmin(cmins), obs)
            shift = torch.where(col_min <= 0, 1e-6 - col_min,
                                torch.zeros_like(col_min))

        def shifted(start, mb):
            """The block shifted to positivity; padding rows parked at 1
            (they are real draws below no minimum: log and pow of 1 are 0,
            so they add nothing and no NaN)."""
            v = mb + shift.to(mb.device)[None, :]
            if start + row_bs > n_true:
                g = torch.arange(start, start + row_bs, device=mb.device)
                v = torch.where((g < n_true)[:, None], v, torch.ones_like(v))
            return v

        if use_bc:
            grid = self._bc_grid
            # per-(lambda, column) sums [L, M]: the rows are read once per
            # pass, every lambda applied to the block while it is at hand
            s1s = []
            for i in shards():
                s1 = torch.zeros((len(grid), nmet), dtype=dt, device=devs[i])
                for start, flo, mb, _ in blocks(i):
                    vm = mask(devs[i], start, flo, 0, n_true)
                    v = shifted(start, mb)
                    for k, lam in enumerate(grid):
                        s1[k] += masked(self._bc_one(v, lam), vm).sum(0)
                s1s.append(s1)
            bc_mean = mesh.psum(s1s) / n_true
            s2s, s3s = [], []
            for i in shards():
                s2 = torch.zeros((len(grid), nmet), dtype=dt, device=devs[i])
                s3 = torch.zeros_like(s2)
                bcm = bc_mean.to(devs[i])
                for start, flo, mb, _ in blocks(i):
                    vm = mask(devs[i], start, flo, 0, n_true)
                    v = shifted(start, mb)
                    for k, lam in enumerate(grid):
                        c = masked(self._bc_one(v, lam) - bcm[k][None, :], vm)
                        c2 = c * c
                        s2[k] += c2.sum(0)
                        s3[k] += (c2 * c).sum(0)
                s2s.append(s2)
                s3s.append(s3)
            var = mesh.psum(s2s) / (n_true - 1)
            third = mesh.psum(s3s) / n_true
            skew = torch.where(var == 0, torch.zeros_like(var),
                               third / torch.pow(var, 1.5))
            askew = torch.where(torch.isfinite(skew), skew.abs(), inf)
            # the first of equal minima, as the resident loop keeps it
            k_idx = torch.arange(len(grid), device=self.device)[:, None]
            first_min = torch.where(askew == askew.amin(0)[None, :], k_idx,
                                    len(grid) - 1).amin(0)
            lam_c = self._bc_grid_t[first_min]
            lambdas = lam_c
            obs = stats_mod.box_cox(obs + shift, lam_c)

        def rank_rows(start, mb):
            """The block in ranking space: Box-Cox applied on the fly."""
            if use_bc:
                return stats_mod.box_cox(shifted(start, mb),
                                         lam_c.to(mb.device)[None, :])
            return mb

        # ---- dual-frame moments of metrics and parameters, one pass ----
        c_par = self._par_center(prev_state) if use_pls else None
        accs = []
        for i in shards():
            dev = devs[i]
            obs_i = obs.to(dev)
            acc = [torch.zeros((nmet,), dtype=dt, device=dev)
                   for _ in range(4)]
            if use_pls:
                c_par_i = c_par.to(dev)
                acc += [torch.zeros((npar,), dtype=dt, device=dev)
                        for _ in range(4)]
            for start, flo, mb, pb in blocks(i):
                vm = mask(dev, start, flo, 0, n_true)
                rb = rank_rows(start, mb)
                md = masked(rb - obs_i[None, :], vm)
                mr = masked(rb, vm)
                acc[0] += md.sum(0)
                acc[1] += (md * md).sum(0)
                acc[2] += mr.sum(0)
                acc[3] += (mr * rb).sum(0)
                if use_pls:      # SIMPLE never reads the parameter sums
                    pd = masked(pb - c_par_i[None, :], vm)
                    pr = masked(pb, vm)
                    acc[4] += pd.sum(0)
                    acc[5] += (pd * pd).sum(0)
                    acc[6] += pr.sum(0)
                    acc[7] += (pr * pb).sum(0)
            accs.append(acc)
        acc = [mesh.psum([a[k] for a in accs]) for k in range(len(accs[0]))]
        mean, sd, obs_delta = _dual_moment_stats(*acc[:4], obs, n_true)
        sd = torch.where(~(sd > eps), torch.ones_like(sd), sd)
        obs_z = obs_delta / sd

        def new_distances():
            out = []
            for i in shards():
                d = torch.empty((local_n,), dtype=dt, device=devs[i])
                out.append(d)
            return out

        def pad_inf(ds):
            for i, d in enumerate(ds):
                d[max(n_true - offs[i], 0):] = math.inf
            return ds

        if not use_pls:
            ds = new_distances()
            for i in shards():
                mean_i, sd_i = mean.to(devs[i]), sd.to(devs[i])
                obs_z_i = obs_z.to(devs[i])
                for start, _, mb, _ in blocks(i):
                    diff = (rank_rows(start, mb) - mean_i) / sd_i \
                        - obs_z_i[None, :]
                    # overlap rows get the same values again
                    ls = start - offs[i]
                    ds[i][ls:ls + row_bs] = torch.sqrt(
                        (diff * diff).sum(dim=1))
            return (pad_inf(ds),
                    torch.zeros((), dtype=torch.int64, device=self.device),
                    lambdas)

        pmean, psd, _ = _dual_moment_stats(*acc[4:], c_par, n_true)
        psd = torch.where(~(psd > eps), torch.ones_like(psd), psd)

        # ---- train and held-out z-Grams in one pass; the held-out Grams
        # in score space factor through R (T'T = R'(X'X)R, T'Y = R'(X'Y)),
        # so PRESS needs no score matrix ----
        grams = []
        for i in shards():
            dev = devs[i]
            mean_i, sd_i = mean.to(dev), sd.to(dev)
            pmean_i, psd_i = pmean.to(dev), psd.to(dev)
            xtx = torch.zeros((nmet, nmet), dtype=dt, device=dev)
            xty = torch.zeros((nmet, npar), dtype=dt, device=dev)
            xtx_te = torch.zeros_like(xtx)
            xty_te = torch.zeros_like(xty)
            yty = torch.zeros((npar,), dtype=dt, device=dev)
            for start, flo, mb, pb in blocks(i):
                if flo >= n_true:
                    continue
                zb = (rank_rows(start, mb) - mean_i) / sd_i
                zpb = (pb - pmean_i) / psd_i
                if max(start, flo) < n_train:
                    tr = mask(dev, start, flo, 0, n_train)
                    xm = masked(zb, tr)
                    xtx += xm.T @ xm
                    xty += xm.T @ masked(zpb, tr)
                if start + row_bs > n_train:
                    te = mask(dev, start, flo, n_train, n_true)
                    xt = masked(zb, te)
                    zt = masked(zpb, te)
                    xtx_te += xt.T @ xt
                    xty_te += xt.T @ zt
                    yty += (zt * zpb).sum(0)
            grams.append((xtx, xty, xtx_te, xty_te, yty))
        xtx, xty, xtx_te, xty_te, yty = (
            mesh.psum([g[k] for g in grams]) for k in range(5))
        R, _, Q = pls_mod._fit_gram(xtx, xty, max_comp)
        G = R.T @ xty_te                                      # [A, p]
        H = (R.T @ xtx_te) @ R                                # [A, A]
        QT = Q.T
        press = self._press(G, H, yty, QT)

        def vdv_window():
            # z-score and project the window's rows alone
            out = []
            for i, (a, b, g0) in enumerate(self._vdv_rows(n, n_true,
                                                          local_n)):
                dev = devs[i]
                g_s = torch.arange(g0, g0 + (b - a), device=dev)
                mb = mets[i][a:b]
                if use_bc:
                    v = torch.where((g_s < n_true)[:, None],
                                    mb + shift.to(dev)[None, :],
                                    torch.ones_like(mb))
                    mb = stats_mod.box_cox(v, lam_c.to(dev)[None, :])
                t_s = ((mb - mean.to(dev)) / sd.to(dev)) @ R.to(dev)
                zp_s = (params[i][a:b] - pmean.to(dev)) / psd.to(dev)
                test_s = ((g_s >= n_train) & (g_s < n_true)).to(dt)[:, None]
                out.append((t_s, zp_s, test_s, g_s))
            return out

        ncomp_report, col_mask = self._select(press, QT, vdv_window,
                                              vdv_seed, max_comp)
        obs_scores = (obs_z @ R) * col_mask[0]
        ds = new_distances()
        for i in shards():
            dev = devs[i]
            mean_i, sd_i, R_i = mean.to(dev), sd.to(dev), R.to(dev)
            cm_i, os_i = col_mask.to(dev), obs_scores.to(dev)
            for start, _, mb, _ in blocks(i):
                tb = (((rank_rows(start, mb) - mean_i) / sd_i) @ R_i) * cm_i
                diff = tb - os_i[None, :]
                ls = start - offs[i]
                ds[i][ls:ls + row_bs] = torch.sqrt((diff * diff).sum(dim=1))
        return pad_inf(ds), ncomp_report, lambdas

    # candidate-gather payload (bytes per device) from which the automatic
    # rule takes the two-stage top-K (the JAX package's constant: the
    # distance-only gather is (P + M) / 2 times lighter and the row psum
    # does not grow with the mesh; below it one gather is simpler)
    _TOPK_TWO_STAGE_BYTES = 16 * 2**20

    def _topk_two_stage_active(self, keep: int, local_n: int) -> bool:
        """True when the global top-K runs in two stages: gather the
        candidates' distances and local row indices alone, decide the
        global top-K once, then assemble the survivor rows by a psum of the
        rows each shard owns (zeros elsewhere). The same ``topk`` runs on
        the same gathered distances, and the psum adds exact zeros, so the
        two stages give the single stage's bits."""
        if self.topk_two_stage is not None:
            return bool(self.topk_two_stage)
        if self.mesh.size <= 1:
            return False
        k_local = min(keep, local_n)
        item = torch.empty((), dtype=self.dtype).element_size()
        payload = (self.mesh.size * k_local
                   * (self.par_set.npar + len(self.obs)) * item)
        return payload >= self._TOPK_TWO_STAGE_BYTES

    def _global_topk(self, params, mets, d, keep: int):
        """(survivor global indices, parameters, metrics) of the ``keep``
        least distances over every shard (1254-1295). Candidates are in
        shard-major order, as in the JAX step. One shard runs the same
        gathers (they return their one part, and count as the JAX
        one-device program's do) and skips the second top-K."""
        mesh = self.mesh
        local_n = d[0].shape[0]
        k_local = min(keep, local_n)
        loc = [torch.topk(-di, k_local, sorted=True) for di in d]
        cand_neg = mesh.all_gather_cat([neg for neg, _ in loc])
        if mesh.size > 1 and self._topk_two_stage_active(keep, local_n):
            cand_lidx = mesh.all_gather_cat([li for _, li in loc])
            _, pos = torch.topk(cand_neg, keep, sorted=True)
            owner = torch.div(pos, k_local, rounding_mode="floor")
            slot = cand_lidx[pos]
            surv_idx = owner * local_n + slot
            par_p, met_p = [], []
            for i, (s, dev) in enumerate(mesh.shards):
                sl = slot.to(dev)
                mine = (owner.to(dev) == s)[:, None]
                zero = torch.zeros((), dtype=self.dtype, device=dev)
                par_p.append(torch.where(mine, params[i][sl], zero))
                met_p.append(torch.where(mine, mets[i][sl], zero))
            return surv_idx, mesh.psum(par_p), mesh.psum(met_p)
        cand_par = mesh.all_gather_cat([p[li] for p, (_, li)
                                        in zip(params, loc)])
        cand_met = mesh.all_gather_cat([m[li] for m, (_, li)
                                        in zip(mets, loc)])
        cand_gidx = mesh.all_gather_cat([
            li + off if (off := mesh.row_offset(i, local_n)) else li
            for i, (_, li) in enumerate(loc)])
        if mesh.size == 1:
            # one shard's sorted top-K are the survivors (each gather above
            # returned its one part)
            return cand_gidx, cand_par, cand_met
        _, pos = torch.topk(cand_neg, keep, sorted=True)
        return cand_gidx[pos], cand_par[pos], cand_met[pos]

    def _log_weights(self, surv_par, prev_state, keep: int):
        """Unnormalised log weights [keep]: prior over the kernel mixture
        of the previous survivors. On a mesh the survivor (query) axis is
        sharded: each shard runs the weight kernel on its ``ceil(keep /
        size)`` edge-padded rows against every previous center, and the
        slices are gathered and trimmed (1303-1330)."""
        dt, mesh = self.dtype, self.mesh
        prev_par, prev_w, prev_dv = prev_state
        k_per = -(-keep // mesh.size)
        pad = k_per * mesh.size - keep
        surv_pad = torch.cat([surv_par,
                              surv_par[-1:].expand(pad, surv_par.shape[1])])
        parts = []
        for s, dev in mesh.shards:
            rows = surv_pad[s * k_per:(s + 1) * k_per].to(dev)
            log_num = self.par_set.prior_log_pdf(rows).to(dt)
            log_den = weights_mod.log_kernel_mixture_density(
                rows, prev_par.to(dev), torch.log(prev_w.to(dev, dt)),
                prev_dv.to(dev), precision=self.weight_precision,
            )
            parts.append(log_num - log_den)
        return mesh.all_gather_cat(parts)[:keep]

    def _finish(self, params, mets, d, ncomp_report, lambdas, keep, n_next,
                draws, prev_state):
        """Top-K, doubled variance, weights and the proposal."""
        dt, dev = self.dtype, self.device
        surv_idx, surv_par, surv_met = self._global_topk(params, mets, d,
                                                         keep)

        self._stages.begin("weights")
        smean = surv_par.mean(0)
        dv = 2.0 * ((surv_par - smean[None, :]) ** 2).sum(0) / max(keep - 1, 1)
        if prev_state is None:
            w = weights_mod.uniform_weights(keep, device=dev, dtype=dt)
        else:
            log_w = self._log_weights(surv_par, prev_state, keep)
            log_w = log_w - log_w.max()
            w = torch.exp(log_w)
            w = w / torch.sqrt((w * w).sum())   # L2-normalize (parity quirk)

        loop = factor = None
        if n_next == 0:
            self._stages.end()
            nxt = [torch.zeros((0, self.par_set.npar), dtype=dt, device=sd)
                   for _, sd in self.mesh.shards]
            nxt_seeds = [torch.zeros((0,), dtype=torch.int64, device=sd)
                         for _, sd in self.mesh.shards]
        else:
            self._stages.begin("propose")
            nxt, nxt_seeds, loop, factor = self._propose(
                surv_par, w, dv, n_next, draws, self._stages)
        res = GenerationResult(
            mets, d, surv_idx, surv_par, surv_met, w, dv, nxt, nxt_seeds,
            ncomp_report, lambdas)
        res.mvn_factor = factor
        if self._capturing:
            res.mvn_loop = loop
        else:
            res.mvn_rounds, res.mvn_finished_eagerly = (
                self._finish_rejection(loop, nxt))
        return res

    def _finish_rejection(self, loops, nxts):
        """Read the count of a step's MULTIVARIATE rejection loops (one per
        shard; one host read per block) and, where a row was still rejected
        after the first block, run the further rounds eagerly and write the
        finished rows into the shard's ``nxts`` in place. ``loops`` are left
        as the step made them (a captured step's are replayed again).
        Returns (the count: the most rounds any shard of the mesh ran,
        whether rounds ran past the first block on any shard)."""
        if loops is None:
            return 0, False
        if not isinstance(loops, list):      # a plain step's one loop
            loops, nxts = [loops], [nxts]
        counts, more = [], False
        for loop, nxt in zip(loops, nxts):
            loop = copy.copy(loop)
            first_block = loop.rounds
            rounds, vals = loop.finish()
            counts.append(rounds)
            if loop.rounds > first_block:
                nxt.copy_(vals)
                more = True
        count = max(counts)
        if self.mesh.multi_process:
            count = self.mesh.max_over_processes(count)
            more = self.mesh.any_process(more)
        if more:
            self.mvn_eager_finishes += 1
        return count, more

    @staticmethod
    def _bc_one(v, lam: float):
        return torch.log(v) if lam == 0 else (torch.pow(v, lam) - 1.0) / lam

    def _box_cox(self, mets, vmask, n_true: int):
        """Box-Cox of each metric column and the observed row (the host
        rule: ``ranking.apply_box_cox``): shift to positivity by the column
        min over the valid rows of every shard and the observed value, then
        per column the grid lambda of least |skewness|, from two-pass
        central moments (raw third moments cancel at float32). A lambda
        whose moments overflow is disqualified before the comparison; ties
        keep the first lambda. One grid point at a time: no [grid, N, M]
        block. Returns (transformed metrics per shard, transformed observed
        row [M], lambdas [M])."""
        dt, mesh = self.dtype, self.mesh
        obs = self._obs_t
        valid = [vm > 0 for vm in vmask]
        inf = torch.full((), math.inf, dtype=dt, device=self.device)
        col_min = torch.minimum(mesh.pmin([
            torch.where(va, m, inf.to(m.device)).amin(0)
            for va, m in zip(valid, mets)]), obs)
        shift = torch.where(col_min <= 0, 1e-6 - col_min,
                            torch.zeros_like(col_min))
        # padding rows are real draws below no minimum: park them at 1
        # (log and pow of 1 are 0) so that they add nothing and no NaN
        v = [torch.where(va, m + shift.to(m.device)[None, :],
                         torch.ones_like(m)) for va, m in zip(valid, mets)]
        best = torch.full_like(obs, math.inf)
        lam_c = torch.full_like(obs, self._bc_grid[0])
        for lam in self._bc_grid:
            y = [self._bc_one(vi, lam) for vi in v]
            mu = mesh.psum([(yi * vm).sum(0)
                            for yi, vm in zip(y, vmask)]) / n_true
            c2_p, c3_p = [], []
            for yi, vm in zip(y, vmask):
                c = (yi - mu.to(yi.device)[None, :]) * vm
                c2 = c * c
                c2_p.append(c2.sum(0))
                c3_p.append((c2 * c).sum(0))
            del y
            var = mesh.psum(c2_p) / (n_true - 1)
            third = mesh.psum(c3_p) / n_true
            skew = torch.where(var == 0, torch.zeros_like(var),
                               third / torch.pow(var, 1.5))
            askew = torch.where(torch.isfinite(skew), skew.abs(), inf)
            better = askew < best
            best = torch.where(better, askew, best)
            lam_c = torch.where(better, torch.full_like(lam_c, lam), lam_c)
        return ([stats_mod.box_cox(vi, lam_c.to(vi.device)[None, :])
                 for vi in v],
                stats_mod.box_cox(obs + shift, lam_c), lam_c)

    def _vdv_ok(self, windows, QT, press, vdv_seed):
        """Van der Voet randomization test as one moment expansion over the
        window rows, each shard's slice (scores ``t_s`` [ns, A],
        z-parameters ``zp_s`` [ns, p], held-out mask ``test_s`` [ns, 1],
        global row indices ``g_s``) giving its partials of the psummed
        moments: every statistic S_w[a, j] = sum_n w_n test_n (zp_nj -
        sum_{b<=a} t_nb QT_bj)^2, for w = 1 (observed) and each sign row,
        expands into W @ [zp^2 | t x zp | t x t] plus a tiny prefix-sum
        recombination. The three right-hand sides are multiplied
        separately (never concatenated: at 100 metrics the t x t block
        alone is ~4 GB). Returns (ok [A, p], u0_bad 0-d bool)."""
        dt = self.dtype
        max_comp, npar = QT.shape
        u0_p, u1_p, u2_p = [], [], []
        for t_s, zp_s, test_s, g_s in windows:
            nsub = t_s.shape[0]
            sgn = pls_mod.vdv_signs(vdv_seed, self.vdv_permutations, g_s, dt)
            W = torch.cat([torch.ones((1, nsub), dtype=dt,
                                      device=t_s.device), sgn], dim=0)
            tm = t_s * test_s
            zpm = zp_s * test_s
            u0_p.append(W @ (zpm * zp_s))                      # [K1, p]
            u1_p.append((W @ (t_s[:, :, None] * zpm[:, None, :]).reshape(
                nsub, max_comp * npar)).reshape(-1, max_comp, npar))
            u2_p.append((W @ (t_s[:, :, None] * tm[:, None, :]).reshape(
                nsub, max_comp * max_comp)).reshape(-1, max_comp, max_comp))
        U0, U1, U2 = (self.mesh.psum(u) for u in (u0_p, u1_p, u2_p))
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
        nxt, seeds, loops, _ = self._propose(surv_par, w, dv, n_next, draws)
        rounds = self._finish_rejection(loops, nxt)[0]
        return self._out(nxt), self._out(seeds), rounds

    def _pick(self, w, pick_draw, n_next: int, local_next: int, shard: int):
        """Resampled survivor indices [local_next] int64 of shard
        ``shard`` from its pick draws. Systematic strata tile the whole
        population: shard s takes the points of global rows s * local_next
        + i (clamped into the last of the ``n_next`` true strata, the
        padding rows); one offset is shared by every shard (444-455)."""
        dt = self.dtype
        keep = w.shape[0]
        cdf = _cumsum(w)
        pick_draw = pick_draw.to(w.device, dt)
        if self.resample_method == "systematic":
            g2 = torch.clamp_max(
                torch.arange(shard * local_next, (shard + 1) * local_next,
                             device=w.device), n_next - 1)
            pts = _stratum_points(g2, pick_draw, cdf[-1] / n_next, dt)
            if local_next >= self.sorted_pick_min:
                # f32 rounding at the 4096-index block edges can invert
                # neighbours by a few ulps; project onto monotone first
                pts = torch.cummax(pts, dim=0).values
                return _sorted_searchsorted(cdf, pts, local_next)
            return torch.clamp_max(torch.searchsorted(cdf, pts), keep - 1)
        if local_next >= self.sorted_pick_min:
            # sorted uniforms by exponential spacings: u_(i) = S_i / S_{n+1}
            s = _cumsum(pick_draw)
            u = (s[:-1] / s[-1]) * cdf[-1]
            return _sorted_searchsorted(cdf, u, local_next)
        u = pick_draw * cdf[-1]
        return torch.clamp_max(torch.searchsorted(cdf, u), keep - 1)

    def _propose(self, surv_par, w, dv, n_next: int, draws: StepDraws,
                 stages: StepStages | None = None):
        """Weighted resample of the survivors + truncated perturbation
        (src/AbcSmc.cpp:479-553), each shard its ``padded(n_next) / size``
        rows from its own draws. Returns (next_params, seeds, the
        MULTIVARIATE rejection loops after their first block, one per
        shard, or None, and the MULTIVARIATE Cholesky factor or None): the
        caller reads the loops' count (:meth:`_finish_rejection`). With
        MULTIVARIATE noise every shard picks first; then ``stages``, where
        given, runs the stage ``mvn`` over the factor and the first block
        of rounds, and ends it."""
        dt = self.dtype
        mesh = self.mesh
        local_next = mesh.padded(n_next) // mesh.size
        mvn = self.noise_type == NoiseType.MULTIVARIATE
        nxts, seeds, loops, mus = [], [], [] if mvn else None, []
        rep, L = {}, {}
        for i, (s, dev) in enumerate(mesh.shards):
            if dev not in rep:
                rep[dev] = (surv_par.to(dev, dt), w.to(dev), dv.to(dev))
            sp, wi, dvi = rep[dev]
            pick = self._pick(wi, _shard(draws.pick, i), n_next, local_next,
                              s)
            noise_u = _shard(draws.noise_u, i)
            bs = self.row_block_for(local_next)
            seeds.append(_shard(draws.next_seeds, i).to(torch.int64))
            if bs and bs < local_next and not mvn:
                # the truncated perturbation is a map of each row by itself
                # with many row-sized temporaries: block by block it gives
                # the same bits and holds only the picks and the output
                nxt = torch.empty((local_next, sp.shape[1]), dtype=dt,
                                  device=dev)
                for start in range(0, local_next, bs):
                    rows = slice(start, min(start + bs, local_next))
                    nxt[rows] = self.par_set.noise_independent(
                        sp[pick[rows]], dvi, noise_u[rows])
                nxts.append(nxt)
                continue
            mu = sp[pick]
            if mvn:
                mus.append(mu)
                continue
            nxts.append(self.par_set.noise_independent(mu, dvi, noise_u)
                        .to(dt))
        if not mvn:
            return nxts, seeds, None, None
        if stages is not None:
            stages.begin("mvn")
        for i, ((s, dev), mu) in enumerate(zip(mesh.shards, mus)):
            if dev not in L:
                # covariance with the n-1 divisor in full FP32, diagonal
                # alone doubled; a collapsed column gives a NaN factor,
                # as in JAX: no row is ever accepted and every row
                # falls back to its mu
                L[dev] = setup_mvn_sampler(rep[dev][0])
            loop = self.par_set.multivariate_rejection(
                mu, L[dev], _shard(draws.noise_eps, i), self.max_retries,
                draws.retry_seed, self.rejection_block,
                row0=s * local_next,
            )
            loops.append(loop)
            nxts.append(loop.values().to(dt))
        if stages is not None:
            stages.end()
        return nxts, seeds, loops, L[mesh.shards[0][1]]

    # ------------------------------------------------------- fused dispatch
    @staticmethod
    def _leaves(res: GenerationResult, params, seeds, full_history: bool):
        """One set's history leaves, in the JAX package's order."""
        base = (res.survivor_idx, res.survivor_params, res.survivor_metrics,
                res.weights, res.doubled_variance, res.ncomp_used)
        if full_history:
            base += (params, seeds, res.metrics)
        return base

    @staticmethod
    def set_record(route: str, events, res: GenerationResult) -> dict:
        """What a run keeps of one set for its timings: the route
        ("eager" or "replay"), CUDA events around the set (None off the
        card), the simulate events and the later stages
        (:class:`StepStages`) of an eager set, the MULTIVARIATE count and
        whether its rounds ran past the first block, the proposal's
        Cholesky factor, the simulator's time steps a row, and the chosen
        Box-Cox lambdas. The tensors are copies: a replayed set's result
        is the graph's static output, which the next replay overwrites."""
        return {
            "route": route, "events": events, "sim_events": res.sim_events,
            "stages": res.stages,
            "mvn_rounds": res.mvn_rounds,
            "mvn_finished_eagerly": res.mvn_finished_eagerly,
            "mvn_factor": (None if res.mvn_factor is None
                           else res.mvn_factor.clone()),
            "sim_steps": res.sim_steps,
            "sim_counts": (None if res.sim_counts is None
                           else res.sim_counts.clone()),
            "sim_stats_events": res.sim_stats_events,
            "box_cox_lambdas": (None if res.box_cox_lambdas is None
                                else res.box_cox_lambdas.clone()),
        }

    def _eager_set(self, params, seeds, keep, n_next, draws, state, n_valid):
        events = None
        if self.device.type == "cuda":
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record()
        res = self._step_sim(params, seeds, keep, n_next, draws, state,
                             n_valid)
        if events:
            events[1].record()
        self.set_info.append(self.set_record("eager", events, res))
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
        which is part of the graph. The whole capture is the range
        ``abcsmc.capture``."""
        t0 = time.perf_counter()
        with record_function("abcsmc.capture"):
            params = _tmap(torch.empty_like, like.next_params)
            seeds = _tmap(torch.empty_like, like.next_seeds)
            state = tuple(torch.empty_like(x) for x in (
                like.survivor_params, like.weights, like.doubled_variance))
            draws = StepDraws(*(
                _tmap(torch.empty_like, getattr(like_draws, f))
                for f in _DRAW_FIELDS))
            # a valid input for the capture pass's shape-only work
            _copy_into(params, like.next_params)
            _copy_into(seeds, like.next_seeds)
            for dst, src in zip(state, (like.survivor_params, like.weights,
                                        like.doubled_variance)):
                dst.copy_(src)
            self._copy_draws(draws, like_draws)

            def body():
                mets, counted = self._simulate_counted(params, seeds)
                res = self._step(params, mets, keep, n, draws, state, None)
                res.sim_steps, res.sim_counts, _ = counted
                return res

            graph, result, held = self._record(body)
            self.capture_seconds += time.perf_counter() - t0
        return _CapturedStep(graph, params, seeds, state, draws, result, held)

    def _record(self, body):
        """Capture ``body()`` (a step on static inputs) into a CUDA graph.
        Returns (graph, the static result, the kernel launches the graph
        holds)."""
        from abcsmc_tpu_torch.ops.kernels import graph_capture_counts

        torch.cuda.synchronize(self.device)
        graph = torch.cuda.CUDAGraph()
        # the MULTIVARIATE count stays on the device: read after a replay
        self._capturing = True
        try:
            with graph_capture_counts() as held, torch.cuda.graph(graph):
                result = body()
        finally:
            self._capturing = False
        self.graph_captures += 1
        return graph, result, held

    def capture_precomputed(self, params, metrics, keep: int, n_next: int,
                            draws: StepDraws, prev_state=None,
                            n_valid: int | None = None) -> _CapturedStep:
        """:meth:`step_precomputed` captured into a CUDA graph, on static
        copies of its inputs (parameters, metrics, previous state, draws):
        the counterpart of the one compiled program ``jax.jit`` dispatches.
        The step first runs once eagerly on a side stream (the kernel built
        and every cached constant made, so the capture meets no first-use
        work). :meth:`replay_precomputed` then runs it on new draws."""
        # the simulator is not part of this step: it cannot block it
        if self.capture_blocker(with_simulator=False) is not None:
            raise ValueError(
                "capture_precomputed needs a capturable step (a CUDA device, "
                "every shard of a one-process mesh on it)")
        t0 = time.perf_counter()
        params = _tmap(torch.clone, [p.to(self.dtype)
                                     for p in self._in(params)])
        mets = _tmap(torch.clone, [m.to(self.dtype)
                                   for m in self._in(metrics)])
        state = None if prev_state is None else tuple(
            torch.clone(x) for x in prev_state)
        draws = StepDraws(*(_tmap(torch.clone, getattr(draws, f))
                            for f in _DRAW_FIELDS))
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._step(params, mets, keep, n_next, draws, state, n_valid)
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph, result, held = self._record(lambda: self._step(
            params, mets, keep, n_next, draws, state, n_valid))
        self.capture_seconds += time.perf_counter() - t0
        return _CapturedStep(graph, params, None, state, draws, result, held,
                             metrics=mets)

    def replay_precomputed(self, cap: _CapturedStep,
                           draws: StepDraws) -> GenerationResult:
        """One step of :meth:`capture_precomputed`'s graph on ``draws``
        (copied into the static draws; the population, metrics and state
        are the captured ones). The result is the graph's static output,
        valid until the next replay."""
        return self._out_result(self._replay(cap, None, None, None, draws))

    @staticmethod
    def _copy_draws(dst: StepDraws, src: StepDraws):
        for f in _DRAW_FIELDS:
            if getattr(dst, f) is not None:
                _copy_into(getattr(dst, f), getattr(src, f))

    def _replay(self, cap: _CapturedStep, params, seeds, state,
                draws: StepDraws) -> GenerationResult:
        """One set through the captured step: copy its inputs into the
        static buffers (None: keep the captured ones), replay, and return
        the static result (valid until the next replay). A MULTIVARIATE
        step's count is read here, once per set, and a set whose rows were
        not all accepted in the graph's block is finished eagerly in place
        (:meth:`_finish_rejection`) before the caller draws the next set.
        The whole of it is the range ``abcsmc.replay``, its host seconds
        added to ``replay_seconds``."""
        from abcsmc_tpu_torch.ops.kernels import count_replay

        t0 = time.perf_counter()
        with record_function("abcsmc.replay"):
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            with record_function("abcsmc.step"):
                events[0].record()
                if params is not None:
                    _copy_into(cap.params, params)
                if seeds is not None:
                    _copy_into(cap.seeds, seeds)
                for dst, src in zip(cap.state or (), state or ()):
                    dst.copy_(src)
                self._copy_draws(cap.draws, draws)
                cap.graph.replay()
                res = cap.result
                res.mvn_rounds, res.mvn_finished_eagerly = (
                    self._finish_rejection(res.mvn_loop, res.next_params))
                events[1].record()
            self.dispatches += 1
            self.graph_replays += 1
            count_replay(cap.kernel_launches, self.weight_precision)
            self.set_info.append(self.set_record("replay", events,
                                                 cap.result))
        self.replay_seconds += time.perf_counter() - t0
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
                    _tmap(lambda t: t.record_stream(main),
                          _tensors(getattr(res, f.name)))
                cap = self._graphs[key] = self._capture(n, keep, res, draws)
            else:
                res = self._eager_set(params, seeds, keep, n, draws, state,
                                      n)
            leaves = self._leaves(res, params, seeds, full_history)
            if stacks is None:
                stacks = tuple(
                    _tmap(lambda x: torch.empty((L,) + tuple(x.shape),
                                                dtype=x.dtype,
                                                device=x.device), leaf)
                    for leaf in leaves)
            for stack, leaf in zip(stacks, leaves):
                if isinstance(stack, list):
                    for st, lf in zip(stack, leaf):
                        st[i].copy_(lf)
                else:
                    stack[i].copy_(leaf)
            # a replayed set's result is the graph's static output: the next
            # replay copies its carry into the static inputs before it
            # overwrites it, in stream order
            params, seeds = res.next_params, res.next_seeds
            state = (res.survivor_params, res.weights, res.doubled_variance)
        if cap is not None and res is cap.result:
            # what leaves the bucket must outlive later replays
            res = dataclasses.replace(res, **{
                f.name: _tmap(torch.clone, getattr(res, f.name))
                for f in dataclasses.fields(res)
                if _tensors(getattr(res, f.name)) is not None})
            params, seeds = res.next_params, res.next_seeds
            state = (res.survivor_params, res.weights, res.doubled_variance)
        return params, seeds, state, stacks, res

    def run_scan(self, generator: torch.Generator, n: int, keep: int,
                 gens: int, full_history: bool = False):
        """``gens`` generations of one shape (n, keep) as one fused run:
        :meth:`run_chain`'s loop over that schedule (generation 0 eagerly,
        the others as one bucket), its history stacked. The draws
        replicate the sequential loop (:meth:`init_population`, then one
        :meth:`draw_step` per set from the one generator, just before the
        set runs), so everything a set stores equals the sequential loop's,
        bit for bit on the CPU. Every set proposes ``n`` rows; the last
        set's proposal is unused.

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
        last, _, entries = self._chain(generator, [n] * gens, [keep] * gens,
                                       full_history, n)
        parts = [e[2] if e[0] == "bucket"
                 else tuple(_tmap(lambda x: x[None], leaf) for leaf in e[1])
                 for e in entries]

        def stacked(pieces):
            if isinstance(pieces[0], list):
                return [torch.cat(shards) for shards in zip(*pieces)]
            return torch.cat(pieces)

        return (self._out_result(last),
                tuple(stacked(pieces) for pieces in zip(*parts)))

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
        _, state, entries = self._chain(generator, set_sizes, keep_sizes,
                                        full_history, 0)
        if bucketed_history:
            return state, entries
        history = []
        for e in entries:
            if e[0] == "set":
                history.append(e[1])
            else:
                _, L, ys = e
                history.extend(tuple(_tmap(lambda x: x[i], y) for y in ys)
                               for i in range(L))
        return state, history

    def _chain(self, generator, set_sizes, keep_sizes, full_history: bool,
               n_last: int):
        """The fused loop of :meth:`run_chain` and :meth:`run_scan` over a
        schedule, its final set proposing ``n_last`` rows where it runs
        singly (in a bucket it proposes the bucket's ``n``). Returns the
        last set's :class:`GenerationResult`, the final state and the
        bucketed history."""
        G = len(set_sizes)
        self.set_info = []
        params, seeds = map(self._in,
                            self.init_population(generator, set_sizes[0]))
        state, history, res = None, [], None
        for t, L in self.bucket_plan(set_sizes, keep_sizes):
            n_t, keep_t = set_sizes[t], keep_sizes[t]
            if L == 1:
                n_next = set_sizes[t + 1] if t + 1 < G else n_last
                res = self._eager_set(
                    params, seeds, keep_t, n_next,
                    self.draw_step(generator, n_next), state, n_t)
                history.append(("set", tuple(map(self._out, self._leaves(
                    res, params, seeds, full_history)))))
                state = (res.survivor_params, res.weights,
                         res.doubled_variance)
                params, seeds = res.next_params, res.next_seeds
            else:
                params, seeds, state, ys, res = self._run_bucket(
                    params, seeds, state, generator, L, n_t, keep_t,
                    full_history)
                history.append(("bucket", L, tuple(map(self._out, ys))))
        return res, state, history

    def run(self, generator: torch.Generator, set_sizes, keep_sizes):
        """The sequential loop: every generation as its own eager step.
        Returns the final :class:`GenerationResult` and the per-generation
        (survivor_params, weights, doubled_variance) states."""
        self.set_info = []
        params, seeds = map(self._in,
                            self.init_population(generator, set_sizes[0]))
        state, history, res = None, [], None
        for t, (n_t, keep_t) in enumerate(zip(set_sizes, keep_sizes)):
            n_next = set_sizes[t + 1] if t + 1 < len(set_sizes) else 0
            draws = self.draw_step(generator, n_next)
            res = self._eager_set(params, seeds, keep_t, n_next, draws,
                                  state, n_t)
            state = (res.survivor_params, res.weights, res.doubled_variance)
            history.append(state)
            params, seeds = res.next_params, res.next_seeds
        return self._out_result(res), history


def sharded_simulate(simulator: DeviceSimulator, mesh: ParticleMesh, upars,
                     seeds, n_valid: int) -> np.ndarray:
    """Run a device simulator over the particle mesh (JAX 1682-1730):
    model-space parameter rows are tail-padded to a multiple of the shard
    count, each shard simulates its slice on its device, and the metrics
    of every shard, gathered in order on every process, are trimmed back
    to ``n_valid`` rows. Returns a float64 host array [n_valid, M]."""
    upars = torch.as_tensor(upars)[:n_valid]
    seeds = torch.as_tensor(seeds)[:n_valid]
    mets = [simulator.batch_fn(u, s) for u, s in zip(
        mesh.shard_rows(upars), mesh.shard_rows(seeds))]
    out = fetch_rows_global([m.to(torch.float64) for m in mets], mesh)
    return out[:n_valid]
