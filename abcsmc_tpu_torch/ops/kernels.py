"""The hand-written Hopper kernel of the port and its plain PyTorch version.

:func:`mixture_logsumexp` computes

    out[i] = logsumexp_j(a_i . b_j - |a_i|^2/2 - |b_j|^2/2 + log_w[j])
           = logsumexp_j(log_w[j] - |a_i - b_j|^2 / 2)

the O(N * M * P) kernel-mixture weight denominator
(``abcsmc_tpu.ops.pallas_kernels.mixture_logsumexp``). On a CUDA tensor it
launches ``csrc/mixture_logsumexp.cu`` (built by nvcc for sm_90a at first
use, see :mod:`abcsmc_tpu_torch.ops._build`) or raises; on a CPU tensor it
runs :func:`mixture_logsumexp_reference`. Nothing else chooses between them.

``precision`` chooses the program that forms the logits, as the TPU
wrapper's argument of the same name chooses its dot scheme: "high" (the
config's default ``weight_precision``) is 3xTF32 on tensor cores,
"default" one BF16 tensor-core pass over operands rounded to bfloat16
(the TPU's one bf16 pass; 0.03-0.1 nats from float64 on an H100, as
``chip_smoke.py``'s ``kernel_schemes`` phase measures it, see PERF.md),
"highest" (the wrapper's own default) an FP32 FMA product. Each is a
program of its own in the source. A CPU call ignores the value, as JAX's
XLA path off the TPU does.

Semantics kept from the TPU wrapper: a true -inf log-weight is clamped to the
finite sentinel ``-1e30``; the static max bound ``max_lw`` is the largest
non-sentinel log-weight (0 if there is none); ``mode`` is "static" (sum of
``exp(logit - max_lw)``, no running max: a row whose sum underflows is
-inf), "online" (running max, sound for any input) or "auto" (static, then
an online rerun of the whole call if any row came out non-finite). The
kernel decides the rerun on the device, as the TPU's ``lax.cond`` does: the
static pass raises a flag, and the online pass is always launched but
returns at once unless the flag is up. No mode syncs the host.

A call is the prologue, then one partial kernel a pass (two launches in
static and online, three in auto; :func:`launch_plan`). Up to
``_SHORT_MAX_CENTERS`` centers (the shipped examples' keeps of 102-410,
dengue's 2,048, the tools' 5,000 and 10,000) it takes short splits: at
most ``_SHORT_MAX_SPLIT`` of them, and a prologue block a stage. Above,
the plan is the full rule's.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import NamedTuple

import torch

from abcsmc_tpu_torch.ops import _build
from abcsmc_tpu_torch.ops.sim_kernels import LOOP_KERNELS

NEG_INF = -1e30
MODES = ("auto", "static", "online")
PRECISIONS = ("highest", "high", "default")
_CSRC_MODE = {"static": 0, "online": 1, "auto": 2}
_CSRC_SCHEME = {"high": 0, "default": 1, "highest": 2}
# contraction columns per k-step: an mma.m16n8k8 (TF32), an mma.m16n8k16
# (BF16), one FFMA
_K_STEP = {"high": 8, "default": 16, "highest": 1}
# columns a stage adds to b's p: [1, cb] for the mma schemes; cb alone for
# FFMA, whose accumulators start at ca + cb (csrc, "The FFMA program")
_AUG_COLS = {"high": 2, "default": 2, "highest": 1}
# bytes the b_aug stage holds per center and padded column: a TF32 hi and
# lo, a bfloat16, a float. The stage's size is decided here only: the plan
# passes it to the C entry (csrc ``stage_f4``), which lays stages out at it
# and refuses one larger than the partial kernel's shared-memory buffer.
_BYTES_PER_K = {"high": 8, "default": 2, "highest": 4}
_ROWS = 128                # query rows per block (csrc kRows)
_STAGE_CENTERS = 64        # centers per shared-memory stage (csrc)
_PROLOGUE_THREADS = 256    # centers per prologue block (csrc)
_BLOCKS_PER_SM = 32        # partial-kernel blocks the split aims for per SM
_MAX_SPLIT_STAGES = 2048   # stages (131,072 centers) one split sums at most
_REF_BLOCK = 2048          # centers per block of the plain version


# Short splits: up to this many centers a call takes at most
# _SHORT_MAX_SPLIT splits (fewer, longer splits than _BLOCKS_PER_SM asks
# for) and a prologue block a stage (more blocks than 256 centers each)
_SHORT_MAX_CENTERS = 16_384
_SHORT_MAX_SPLIT = 16


def _max_lw(lw):
    """The a-priori logit bound: the largest non-sentinel log-weight, 0 when
    every weight is the sentinel (abcsmc_tpu/ops/pallas_kernels.py:213-215).
    A 0-d tensor; no host sync."""
    neg = torch.full_like(lw, -torch.inf)
    mx = torch.where(lw > NEG_INF / 2, lw, neg).amax()
    return torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))


def _check_precision(precision):
    if precision not in PRECISIONS:
        raise ValueError(
            f"precision must be one of {PRECISIONS}, got {precision!r}")


def _bf16(x):
    """x rounded to bfloat16 from its float32 value (round to nearest even,
    as the MXU and __float2bfloat16_rn round), back in x's dtype."""
    return x.to(torch.float32).to(torch.bfloat16).to(x.dtype)


def _sq_norms(x):
    """Row sums of squares, summed in float64 and rounded once to x's
    dtype: the kernel's "default" scheme sums them the same way, so both
    round the row and column constants from the same float32 value."""
    return (x.double() ** 2).sum(dim=1).to(x.dtype)


def _bf16_operands(a, b, lw, max_lw):
    """The TPU wrapper's augmented operands in natural units
    (pallas_kernels.py:221-236), a_aug = [a, -|a|^2/2 - max_lw, 1] and
    b_aug = [b, 1, lw - |b|^2/2], each entry rounded to bfloat16 from
    float32. Their dot is the logit minus max_lw as one bf16 pass forms it
    (the products are exact; padded centers, whose weight column is -1e30,
    add exactly 0 and are left out)."""
    n, m = a.shape[0], b.shape[0]
    one_n = torch.ones((n, 1), dtype=a.dtype, device=a.device)
    one_m = torch.ones((m, 1), dtype=a.dtype, device=a.device)
    a_aug = torch.cat([a, (-0.5 * _sq_norms(a) - max_lw)[:, None], one_n], 1)
    b_aug = torch.cat([b, one_m, (lw - 0.5 * _sq_norms(b))[:, None]], 1)
    return _bf16(a_aug), _bf16(b_aug)


def mixture_logsumexp_reference(a, b, log_w, *, mode: str = "auto",
                                precision: str | None = None):
    """Plain PyTorch version of :func:`mixture_logsumexp`, any float dtype:
    a blocked logsumexp over blocks of 2,048 centers (the core of
    ``abcsmc_tpu.ops.weights._log_kernel_mixture_density_xla``) with the
    kernel's clamp, ``max_lw`` and mode semantics.

    ``precision`` None, "high" and "highest" form the logits in the call's
    dtype; "default" forms them as the kernel's BF16 scheme does, from the
    TPU wrapper's augmented operands rounded to bfloat16
    (:func:`_bf16_operands`), their dot in the call's dtype, and adds
    ``max_lw`` back. It is the oracle each scheme of the kernel is held
    against."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if precision is not None:
        _check_precision(precision)
    lw = torch.clamp_min(log_w.to(a.dtype), NEG_INF)
    max_lw = _max_lw(lw)
    n, m = a.shape[0], b.shape[0]
    if precision == "default":
        a_op, b_op = _bf16_operands(a, b, lw, max_lw)

        def logits_of(j0):
            return a_op @ b_op[j0:j0 + _REF_BLOCK].T
    else:
        a_sq = (a * a).sum(dim=1)

        def logits_of(j0):
            bb = b[j0:j0 + _REF_BLOCK]
            return (
                a @ bb.T
                - 0.5 * a_sq[:, None]
                - 0.5 * (bb * bb).sum(dim=1)[None, :]
                + (lw[j0:j0 + _REF_BLOCK] - max_lw)[None, :]
            )

    def run(online: bool):
        run_max = torch.full((n,), NEG_INF, dtype=a.dtype, device=a.device)
        run_sum = torch.zeros((n,), dtype=a.dtype, device=a.device)
        for j0 in range(0, m, _REF_BLOCK):
            logits = logits_of(j0)
            if online:
                new_max = torch.maximum(run_max, logits.amax(dim=1))
                run_sum = run_sum * torch.exp(run_max - new_max) + torch.exp(
                    logits - new_max[:, None]
                ).sum(dim=1)
                run_max = new_max
            else:
                run_sum = run_sum + torch.exp(logits).sum(dim=1)
        out = torch.log(run_sum) + max_lw
        return run_max + out if online else out

    if mode == "online":
        return run(True)
    out = run(False)
    if mode == "static" or bool(torch.isfinite(out).all()):
        return out
    return run(True)


class LaunchPlan(NamedTuple):
    """How one call is cut into launches (all host integers).

    ``ks`` k-steps of ``k_step`` columns (8 for "high", 16 for "default",
    1 for "highest") cover a stage's width, p+2 for the mma schemes (b's
    columns, a column of ones and cb) and p+1 for "highest" (no column of
    ones; its k-steps are a stage's rows); the centers are padded
    to ``n_stages`` stages of 64, and split ``y`` of the partial kernel's
    grid ``(q_blocks, n_split)`` takes stages
    ``[y * stages_per_split, min(n_stages, (y + 1) * stages_per_split))``.
    ``ws_floats`` is the 4-byte workspace: the b_aug stages in the
    scheme's layout (``stage_floats`` words each), the prologue's
    per-block maxima, the per-split partial sums and maxima, the
    per-query-block arrival counters and the rerun flag (int32), each
    starting at an offset in ``offsets`` (multiples of 4 words)."""
    ks: int
    n_stages: int
    stages_per_split: int
    n_split: int
    q_blocks: int
    prologue_blocks: int
    offsets: tuple
    ws_floats: int
    precision: str = "high"

    @property
    def k_step(self) -> int:
        return _K_STEP[self.precision]

    @property
    def k_pad(self) -> int:
        return self.k_step * self.ks

    @property
    def stage_floats(self) -> int:
        return _stage_floats(self.ks, self.precision)

    def split_centers(self, y: int, m: int) -> range:
        """The real centers (index < m) of split ``y``."""
        lo = y * self.stages_per_split * _STAGE_CENTERS
        hi = (y + 1) * self.stages_per_split * _STAGE_CENTERS
        return range(min(lo, m), min(hi, m))


def _stage_floats(ks: int, precision: str) -> int:
    """4-byte words of one stage of 64 centers' b_aug at ``ks`` k-steps."""
    return (_STAGE_CENTERS * _K_STEP[precision] * ks
            * _BYTES_PER_K[precision] // 4)


def _check_split(n_split: int, m: int):
    n_stages = -(-m // _STAGE_CENTERS)
    if not 1 <= n_split <= n_stages:
        raise ValueError(
            f"n_split must be in 1..{n_stages} (stages of {_STAGE_CENTERS} "
            f"centers at m={m}), got {n_split!r}")


@functools.lru_cache(maxsize=64)
def launch_plan(n: int, m: int, p: int, sms: int, online: bool, *,
                n_split: int | None = None,
                precision: str = "high") -> LaunchPlan:
    """The launch plan of one call on a card with ``sms`` SMs: enough center
    splits that the partial kernel has about ``_BLOCKS_PER_SM`` blocks per
    SM (at keep 2,048 there are only 16 query blocks) and that no split
    sums more than ``_MAX_SPLIT_STAGES`` stages, no split empty. The cap
    bounds the length of each FP32 running sum: one split over 1,677,721
    centers read 3.1e-4 nats off the plain version on an H100, past the
    2e-4 bound; the merge then adds the few per-split sums.

    ``n_split`` (1..``n_stages``) asks for that many splits instead, the
    counterpart of the TPU wrapper's ``block_i`` / ``block_j`` for tuning
    sweeps: each split takes ``ceil(n_stages / n_split)`` stages and the
    count is trimmed so that none is empty; the cap is not applied.
    ``precision`` sets the k-step and the b_aug stage's size.

    Two regimes. Up to ``_SHORT_MAX_CENTERS`` (short splits): at most
    ``_SHORT_MAX_SPLIT`` splits (fewer, longer ones: at 2,048-10,000
    centers they read faster than the full aim on an H100, PERF.md) and
    a prologue block a stage. Above: the full aim and a prologue block
    for 256 centers."""
    _check_precision(precision)
    ks = -(-(p + _AUG_COLS[precision]) // _K_STEP[precision])
    n_stages = -(-m // _STAGE_CENTERS)
    q_blocks = -(-n // _ROWS)
    short = m <= _SHORT_MAX_CENTERS
    if n_split is not None:
        _check_split(n_split, m)
    else:
        want = -(-_BLOCKS_PER_SM * sms // q_blocks)
        n_split = max(1, min(want, n_stages),
                      -(-n_stages // _MAX_SPLIT_STAGES))
        if short:
            n_split = min(n_split, _SHORT_MAX_SPLIT)
    sps = -(-n_stages // n_split)
    n_split = -(-n_stages // sps)
    prologue_blocks = (n_stages if short else
                       -(-n_stages * _STAGE_CENTERS // _PROLOGUE_THREADS))
    sizes = (n_stages * _stage_floats(ks, precision), prologue_blocks,
             n_split * n, n_split * n if online else 0, q_blocks, 1)
    offsets, at = [], 0
    for s in sizes:
        offsets.append(at)
        at += -(-s // 4) * 4
    return LaunchPlan(ks, n_stages, sps, n_split, q_blocks, prologue_blocks,
                      tuple(offsets), at, precision)


@functools.lru_cache(maxsize=None)
def _library():
    from abcsmc_tpu_torch.ops._build import load_library

    fn = load_library("mixture_logsumexp").mixture_logsumexp_f32
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.restype = ci
    fn.argtypes = [vp] * 10 + [ci] * 11 + [vp]
    return fn


@functools.lru_cache(maxsize=None)
def _launch_count():
    from abcsmc_tpu_torch.ops._build import load_library

    fn = load_library("mixture_logsumexp").mixture_logsumexp_launch_count
    fn.restype = ctypes.c_ulonglong
    fn.argtypes = []
    return fn


#: what :func:`kernel_launches` adds to the C entry's count: less the
#: launches it counted while a CUDA graph captured them (recorded, not
#: run), plus those the graph's replays ran (:func:`graph_capture_counts`,
#: :func:`count_replay`)
_graph_offset = 0


def _c_launches() -> int:
    """The C entry's count; 0 before its library is loaded (nothing has
    launched yet)."""
    if "mixture_logsumexp" not in _build._loaded:
        return 0
    return int(_launch_count()())


def kernel_launches() -> int:
    """Kernels of the C entry that ran on the card in this process, the
    prologue counted, on every route: each launch the CUDA runtime accepted
    (csrc ``mixture_logsumexp_launch_count``), except those recorded into a
    CUDA graph, which count once per replay of the graph instead. Its
    difference around one call is the kernels that call launched;
    :func:`launches_per_call` is what the plan says it should be."""
    return int(_launch_count()()) + _graph_offset


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


class _Call(NamedTuple):
    """What one (shape, device, mode, scheme, split) call needs besides
    its tensors, made once (:func:`_call_of`): the plan; the C entry's
    int arguments in order (n .. scheme); the floats of the one
    allocation (the output's n, rounded up to 4, then the plan's
    workspace); the byte offsets in it of the six workspace pointers in
    the C entry's order (bfrag, lwmax, part_max, part_sum, arrivals,
    flag); and the partial-kernel passes to count."""
    plan: LaunchPlan
    ints: tuple
    floats: int
    ptr_offsets: tuple
    passes: int


@functools.lru_cache(maxsize=256)
def _call_of(n: int, m: int, p: int, index: int, mode: str,
             precision: str, n_split: int | None) -> _Call:
    online = mode != "static"
    plan = launch_plan(n, m, p, _sm_count(index), online,
                       n_split=n_split, precision=precision)
    ints = (n, m, p, plan.ks, plan.stage_floats // 4, plan.n_stages,
            plan.stages_per_split, plan.n_split, plan.prologue_blocks,
            _CSRC_MODE[mode], _CSRC_SCHEME[precision])
    out_floats = -(-n // 4) * 4
    bfrag, lwmax, psum, pmax, arrivals, flag = (
        4 * (out_floats + o) for o in plan.offsets)
    return _Call(plan, ints, out_floats + plan.ws_floats,
                 (bfrag, lwmax, pmax if online else psum, psum, arrivals,
                  flag), 2 if mode == "auto" else 1)


def _launch(a, b, log_w, mode: str, *, precision: str,
            n_split: int | None = None):
    """One call of the kernel on the current stream (csrc ``mode`` 0
    static, 1 online, 2 auto; the scheme ``precision`` names): the
    prologue, then the static and/or online partial kernel. The output
    and the workspace are one torch.empty (the output its first n
    floats); nothing syncs the host."""
    n, p = a.shape
    m = b.shape[0]
    index = a.device.index
    call = _call_of(n, m, p, index, mode, precision, n_split)
    buf = torch.empty((call.floats,), dtype=torch.float32, device=a.device)
    base = buf.data_ptr()
    # the current stream's raw handle: 3-6 us a call less on the host than
    # torch.cuda.current_stream(...).cuda_stream (PERF.md, host parts)
    args = (a.data_ptr(), b.data_ptr(), log_w.data_ptr(),
            *(base + o for o in call.ptr_offsets), base, *call.ints,
            torch._C._cuda_getCurrentRawStream(index))
    if torch.cuda.current_device() == index:
        err = _library()(*args)
    else:
        with torch.cuda.device(index):   # the launches go to a's device
            err = _library()(*args)
    if err != 0:
        raise RuntimeError(
            f"mixture_logsumexp kernel launch failed: cudaError {err} "
            f"(n={n}, m={m}, p={p}, precision={precision}, "
            f"plan={call.plan[:6]})"
        )
    # partial-kernel launches; auto's online pass counts though it may
    # return at once
    count_launches(call.passes, precision)
    return buf[:n]


def launches_per_call(n: int, m: int, p: int, mode: str, *,
                      precision: str = "highest", sms: int = 132,
                      n_split: int | None = None) -> int:
    """Kernel launches the plan says one call makes on the card: the
    prologue and one partial kernel a pass (auto: two), whatever the
    shape (:func:`kernel_launches` counts what a call did launch)."""
    return (2 if mode == "auto" else 1) + 1


def count_launches(k: int, precision: str):
    """Add ``k`` partial-kernel launches of scheme ``precision`` to the
    counts."""
    mixture_logsumexp.launches += k
    mixture_logsumexp.launches_by_precision[precision] += k


@contextlib.contextmanager
def graph_capture_counts():
    """Around a CUDA graph capture: the launches it records run only when
    the graph is replayed, so every count of the port's kernels is left
    as it was before it. The dict it yields is filled on exit with what
    the graph holds, which each replay passes to :func:`count_replay`:
    "partial" (the weight kernel's partial-kernel launches), "kernels"
    (its C entry's launches, the prologue counted) and, under its name,
    each of ``sim_kernels.LOOP_KERNELS`` (the simulator kernels'
    ``launches``)."""
    global _graph_offset
    launches = mixture_logsumexp.launches
    by_precision = dict(mixture_logsumexp.launches_by_precision)
    loops = {k.__name__: k.launches for k in LOOP_KERNELS}
    c0 = _c_launches()
    held: dict = {}
    try:
        yield held
    finally:
        held["partial"] = mixture_logsumexp.launches - launches
        held["kernels"] = _c_launches() - c0
        for k in LOOP_KERNELS:
            held[k.__name__] = k.launches - loops[k.__name__]
            k.launches = loops[k.__name__]
        mixture_logsumexp.launches = launches
        mixture_logsumexp.launches_by_precision.update(by_precision)
        _graph_offset -= held["kernels"]


def count_replay(held: dict, precision: str):
    """Add one replay of a captured graph to every count: ``held`` is what
    :func:`graph_capture_counts` yielded at its capture, ``precision`` the
    weight kernel's scheme in it. A replay passes through neither the
    wrappers nor the C entry."""
    global _graph_offset
    count_launches(held["partial"], precision)
    _graph_offset += held["kernels"]
    for k in LOOP_KERNELS:
        k.launches += held[k.__name__]


def _check_cuda_inputs(a, b, log_w):
    dev, f32 = a.device, torch.float32
    if not (b.device == dev and log_w.device == dev and a.dtype == f32
            and b.dtype == f32 and log_w.dtype == f32 and a.is_contiguous()
            and b.is_contiguous() and log_w.is_contiguous()):
        for name, t in (("a", a), ("b", b), ("log_w", log_w)):
            if t.device != dev:
                raise ValueError(
                    f"{name} is on {t.device}, a on {dev}: one device only"
                )
            if t.dtype != f32:
                raise TypeError(
                    f"{name} must be float32 on CUDA, got {t.dtype}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
    if a.dim() != 2 or b.dim() != 2 or log_w.dim() != 1:
        raise ValueError(
            f"shapes a{tuple(a.shape)} b{tuple(b.shape)} "
            f"log_w{tuple(log_w.shape)}: expected [n,p], [m,p], [m]"
        )
    n, p = a.shape
    m = b.shape[0]
    if b.shape[1] != p or log_w.shape[0] != m:
        raise ValueError(
            f"shape mismatch: a{tuple(a.shape)} b{tuple(b.shape)} "
            f"log_w{tuple(log_w.shape)}"
        )
    if p < 1 or m < 1 or n < 1:
        raise ValueError(f"empty input: n={n}, m={m}, p={p}")
    if n >= 2**31 or m * (p + 2) >= 2**31:
        raise ValueError(f"unsupported sizes n={n}, m={m}, p={p}")


def mixture_logsumexp(a, b, log_w, *, mode: str = "auto",
                      precision: str = "highest",
                      n_split: int | None = None):
    """out[i] = logsumexp_j(log_w[j] - |a_i - b_j|^2 / 2), [n].

    a: [n, p] scaled queries; b: [m, p] scaled centers; log_w: [m]. CUDA
    tensors (float32, contiguous, any p >= 1) launch the hand-written
    kernel of the scheme ``precision`` names (the TPU wrapper's values and
    default): "high" 3xTF32 on tensor cores, "default" one BF16 pass,
    "highest" FP32 FMAs; on CUDA no mode syncs the host. CPU tensors run
    :func:`mixture_logsumexp_reference` at its own precision whatever
    ``precision`` says: the caller asked for the CPU, where JAX's
    ``log_kernel_mixture_density`` takes its XLA path and ignores the
    value too (``abcsmc_tpu/ops/weights.py``), so CPU runs are the same
    under all three. ``precision`` is validated on both devices.
    ``n_split`` overrides the launch plan's center split
    (:func:`launch_plan`; None keeps the plan's own) and is validated on
    both devices; the plain version has no split."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    _check_precision(precision)
    if n_split is not None:
        _check_split(n_split, b.shape[0])
    if not a.is_cuda:
        return mixture_logsumexp_reference(a, b, log_w, mode=mode)
    _check_cuda_inputs(a, b, log_w)
    return _launch(a, b, log_w, mode, precision=precision, n_split=n_split)


#: partial-kernel launches issued by :func:`mixture_logsumexp`: 1 per
#: static or online call, 2 per auto call (a plain integer; callers reset
#: it to 0 to count the launches of one main-path pass)
mixture_logsumexp.launches = 0
#: the same launches by scheme ("high", "default", "highest"), each a
#: kernel of its own
mixture_logsumexp.launches_by_precision = dict.fromkeys(PRECISIONS, 0)
