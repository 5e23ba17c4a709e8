"""The hand-written Hopper kernel of the port and its plain PyTorch version.

:func:`mixture_logsumexp` computes

    out[i] = logsumexp_j(a_i . b_j - |a_i|^2/2 - |b_j|^2/2 + log_w[j])
           = logsumexp_j(log_w[j] - |a_i - b_j|^2 / 2)

the O(N * M * P) kernel-mixture weight denominator
(``abcsmc_tpu.ops.pallas_kernels.mixture_logsumexp``). On a CUDA tensor it
launches ``csrc/mixture_logsumexp.cu`` (built by nvcc for sm_90a at first
use, see :mod:`abcsmc_tpu_torch.ops._build`) or raises; on a CPU tensor it
runs :func:`mixture_logsumexp_reference`. Nothing else chooses between them.

Semantics kept from the TPU wrapper: a true -inf log-weight is clamped to the
finite sentinel ``-1e30``; the static max bound ``max_lw`` is the largest
non-sentinel log-weight (0 if there is none); ``mode`` is "static" (sum of
``exp(logit - max_lw)``, no running max), "online" (flash-style running
max, sound for any input) or "auto" (static, then an online rerun of the
whole call if any row came out non-finite - one host check per call).
"""

from __future__ import annotations

import ctypes
import math

import torch

NEG_INF = -1e30
MODES = ("auto", "static", "online")
#: largest parameter count the kernel's templates cover (csrc: P in
#: {8, 16, 32, 64}); larger p raises
MAX_P = 64
_THREADS = 128             # query rows per block (csrc kThreads)
_MIN_CENTERS_PER_SPLIT = 64
_REF_BLOCK = 2048          # centers per block of the plain version


def _max_lw(lw):
    """The a-priori logit bound: the largest non-sentinel log-weight, 0 when
    every weight is the sentinel (abcsmc_tpu/ops/pallas_kernels.py:213-215).
    A 0-d tensor; no host sync."""
    neg = torch.full_like(lw, -math.inf)
    mx = torch.where(lw > NEG_INF / 2, lw, neg).amax()
    return torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))


def mixture_logsumexp_reference(a, b, log_w, *, mode: str = "auto"):
    """Plain PyTorch version of :func:`mixture_logsumexp`, any float dtype:
    a blocked logsumexp over blocks of 2,048 centers (the core of
    ``abcsmc_tpu.ops.weights._log_kernel_mixture_density_xla``) with the
    kernel's clamp, ``max_lw`` and mode semantics."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    lw = torch.clamp_min(log_w.to(a.dtype), NEG_INF)
    max_lw = _max_lw(lw)
    n, m = a.shape[0], b.shape[0]
    a_sq = (a * a).sum(dim=1)

    def run(online: bool):
        run_max = torch.full((n,), NEG_INF, dtype=a.dtype, device=a.device)
        run_sum = torch.zeros((n,), dtype=a.dtype, device=a.device)
        for j0 in range(0, m, _REF_BLOCK):
            bb = b[j0:j0 + _REF_BLOCK]
            logits = (
                a @ bb.T
                - 0.5 * a_sq[:, None]
                - 0.5 * (bb * bb).sum(dim=1)[None, :]
                + (lw[j0:j0 + _REF_BLOCK] - max_lw)[None, :]
            )
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


def _library():
    from abcsmc_tpu_torch.ops._build import load_library

    fn = load_library("mixture_logsumexp").mixture_logsumexp_f32
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.restype = ci
    fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp]
    return fn


def _launch(a, b, lw_shift, max_lw, online: bool):
    """One launch of the CUDA kernel pair (partial + combine) on the current
    stream; every buffer is allocated here with torch.empty."""
    fn = _library()
    n, p = a.shape
    m = b.shape[0]
    dev = a.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    q_blocks = -(-n // _THREADS)
    n_split = max(1, min(-(-4 * sms // q_blocks),
                         -(-m // _MIN_CENTERS_PER_SPLIT)))
    cps = -(-m // n_split)
    n_split = -(-m // cps)
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    part_sum = torch.empty((n_split, n), dtype=torch.float32, device=dev)
    part_max = (
        torch.empty((n_split, n), dtype=torch.float32, device=dev)
        if online else part_sum
    )
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), lw_shift.data_ptr(),
                 max_lw.data_ptr(), part_max.data_ptr(), part_sum.data_ptr(),
                 out.data_ptr(), n, m, p, n_split, cps, int(online), stream)
    if err != 0:
        raise RuntimeError(
            f"mixture_logsumexp kernel launch failed: cudaError {err} "
            f"(n={n}, m={m}, p={p}, splits={n_split})"
        )
    mixture_logsumexp.launches += 1
    return out


def _check_cuda_inputs(a, b, log_w):
    for name, t in (("a", a), ("b", b), ("log_w", log_w)):
        if t.device != a.device:
            raise ValueError(
                f"{name} is on {t.device}, a on {a.device}: one device only"
            )
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 on CUDA, got {t.dtype}")
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
    if not 1 <= p <= MAX_P:
        raise ValueError(
            f"mixture_logsumexp kernel takes 1 <= p <= {MAX_P}, got p={p}"
        )
    if m < 1 or n >= 2**31 or m >= 2**31:
        raise ValueError(f"unsupported sizes n={n}, m={m}")


def mixture_logsumexp(a, b, log_w, *, mode: str = "auto"):
    """out[i] = logsumexp_j(log_w[j] - |a_i - b_j|^2 / 2), [n].

    a: [n, p] scaled queries; b: [m, p] scaled centers; log_w: [m]. CUDA
    tensors (float32, contiguous, 1 <= p <= 64) launch the hand-written
    kernel; CPU tensors run :func:`mixture_logsumexp_reference`. The TPU
    wrapper's dot ``precision`` schemes (the config's ``weight_precision``)
    have no counterpart here: every value runs this exact FP32 path."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if not a.is_cuda:
        return mixture_logsumexp_reference(a, b, log_w, mode=mode)
    _check_cuda_inputs(a, b, log_w)
    lw = torch.clamp_min(log_w, NEG_INF)
    max_lw = _max_lw(lw).reshape(1)
    lw_shift = (lw - max_lw).contiguous()
    if mode == "online":
        return _launch(a, b, lw_shift, max_lw, online=True)
    out = _launch(a, b, lw_shift, max_lw, online=False)
    if mode == "static" or bool(torch.isfinite(out).all()):
        return out
    return _launch(a, b, lw_shift, max_lw, online=True)


#: kernel launches issued by :func:`mixture_logsumexp` (a plain integer;
#: callers reset it to 0 to count the launches of one run)
mixture_logsumexp.launches = 0
