"""The port on a CUDA device: the hand-written kernel against its plain
PyTorch version, and the engine's main path through the kernel.

Every test here needs a card (marker ``gpu``) and skips without one. The
file imports neither jax nor abcsmc_tpu, so it also runs on a machine
without JAX; there, skip tests/conftest.py (which sets up JAX's CPU mesh):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Tolerance: 2e-4 nats between the kernel and the FP32 plain version, the
bound of tests/test_pallas_kernels.py (both use the expansion
a.b - |a|^2/2 - |b|^2/2; the kernel forms it in 3xTF32 or FP32 FMAs, or
over bfloat16 operands in one BF16 pass, and sums ex2 terms, the plain
version of the same scheme uses an FP32 matmul and exp, in another order).
The hostile case is held to a float64 plain version."""

import io
import math
from contextlib import redirect_stderr

import numpy as np
import pytest
import torch

from abcsmc_tpu_torch import AbcSmc
from abcsmc_tpu_torch.config import NoiseType, parse_config
from abcsmc_tpu_torch.models.parameters import ParameterSet
from abcsmc_tpu_torch.models.simulators import make_linear_gaussian_simulator
from abcsmc_tpu_torch.models.transforms import ParameterTransform
from abcsmc_tpu_torch.ops import kernels, weights
from abcsmc_tpu_torch.parallel.generation import Generation

pytestmark = pytest.mark.gpu
TOL = 2e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


def _scaled(n, m, p, seed, dev):
    rng = np.random.default_rng(seed)
    f32 = dict(dtype=torch.float32, device=dev)
    a, b, _ = weights._prep_scaled(
        torch.as_tensor(rng.uniform(0, 1, (n, p)), **f32),
        torch.as_tensor(rng.uniform(0.2, 0.8, (m, p)), **f32),
        torch.as_tensor(rng.uniform(0.01, 0.1, p), **f32),
    )
    w = rng.uniform(0.5, 1.5, m)
    lw = torch.as_tensor(np.log(w / w.sum()), **f32)
    return a.contiguous(), b.contiguous(), lw


@pytest.mark.parametrize("precision", kernels.PRECISIONS)
@pytest.mark.parametrize("n,m,p", [(2048, 2048, 16), (5000, 3000, 6),
                                   (129, 70, 1), (300, 500, 64),
                                   (1, 100_000, 8), (4096, 4096, 80),
                                   (37, 1000, 1), (1000, 37, 30)])
def test_kernel_matches_plain(cuda, n, m, p, precision):
    """Each scheme against its own plain version, K from 3 to 82: every
    register instance and the L1 instance of each."""
    a, b, lw = _scaled(n, m, p, 11, cuda)
    before = kernels.mixture_logsumexp.launches
    by_prec = dict(kernels.mixture_logsumexp.launches_by_precision)
    for mode in ("static", "online", "auto"):
        got = kernels.mixture_logsumexp(a, b, lw, mode=mode,
                                        precision=precision)
        torch.cuda.synchronize()
        ref = kernels.mixture_logsumexp_reference(a, b, lw, mode=mode,
                                                  precision=precision)
        assert bool(torch.isfinite(got).all()), mode
        assert float((got - ref).abs().max()) <= TOL, mode
    assert kernels.mixture_logsumexp.launches == before + 4
    by_prec[precision] += 4
    assert kernels.mixture_logsumexp.launches_by_precision == by_prec


@pytest.mark.parametrize("precision", kernels.PRECISIONS)
def test_kernel_schemes_at_main_path_shapes(cuda, precision):
    """Each scheme within 2e-4 nats of its own plain version (auto) at the
    shapes chip_smoke.py's kernel phase gives all three; "default" also
    rounds: at least 10x farther from float64 than "high" at 50,000^2."""
    errs = {}
    for n, m, p in ((2048, 2048, 16), (50_000, 50_000, 6),
                    (200_000, 50_000, 13)):
        a, b, lw = _scaled(n, m, p, n + p, cuda)
        got = kernels.mixture_logsumexp(a, b, lw, precision=precision)
        ref = kernels.mixture_logsumexp_reference(a, b, lw,
                                                  precision=precision)
        assert float((got - ref).abs().max()) <= TOL, (n, m, p)
        if n == 50_000:
            pick = torch.arange(0, n, 25, device=cuda)
            f64 = kernels.mixture_logsumexp_reference(
                a[pick].double(), b.double(), lw.double())
            errs = {pr: float((kernels.mixture_logsumexp(
                a, b, lw, precision=pr)[pick].double() - f64).abs().max())
                for pr in ("high", precision)}
    assert errs[precision] <= (0.2 if precision == "default" else TOL)
    if precision == "default":
        assert errs["default"] >= 10 * errs["high"], errs


@pytest.mark.parametrize("precision", kernels.PRECISIONS)
def test_kernel_graph_capture_equals_eager(cuda, precision):
    """One auto call of each scheme captured into a CUDA graph and
    replayed on new inputs copied into the captured ones: bit-equal to the
    eager call on those inputs."""
    static = list(_scaled(2048, 2048, 16, 1, cuda))
    kernels.mixture_logsumexp(*static, precision=precision)   # warm-up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = kernels.mixture_logsumexp(*static, precision=precision)
    fresh = _scaled(2048, 2048, 16, 2, cuda)
    for dst, src in zip(static, fresh):
        dst.copy_(src)
    graph.replay()
    eager = kernels.mixture_logsumexp(*fresh, precision=precision)
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


@pytest.mark.parametrize("precision", ["high", "highest"])
def test_kernel_underflow_auto_reruns_online(cuda, precision):
    b = torch.zeros((16, 2), device=cuda)
    lw = torch.full((16,), math.log(1.0 / 16), device=cuda)
    a = torch.cat([torch.zeros((3, 2), device=cuda),
                   torch.full((1, 2), 1e4, device=cuda)])
    kw = dict(precision=precision)
    static = kernels.mixture_logsumexp(a, b, lw, mode="static", **kw)
    assert bool(torch.isneginf(static[3]))
    before = kernels.mixture_logsumexp.launches
    auto = kernels.mixture_logsumexp(a, b, lw, mode="auto", **kw)
    # static pass, then the online pass the device flag lets run
    assert kernels.mixture_logsumexp.launches == before + 2
    online = kernels.mixture_logsumexp(a, b, lw, mode="online", **kw)
    assert torch.equal(auto, online)
    np.testing.assert_allclose(float(auto[3]), -1e8 + math.log(1.0 / 16),
                               rtol=1e-6)


@pytest.mark.parametrize("precision", kernels.PRECISIONS)
def test_kernel_true_neg_inf_weights(cuda, precision):
    a, b, lw = _scaled(700, 900, 5, 3, cuda)
    lw = lw.clone()
    lw[450:] = -math.inf
    for mode in ("static", "online", "auto"):
        got = kernels.mixture_logsumexp(a, b, lw, mode=mode,
                                        precision=precision)
        sub = kernels.mixture_logsumexp(a, b[:450].contiguous(),
                                        lw[:450].contiguous(), mode=mode,
                                        precision=precision)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got).all()), mode
        assert float((got - sub).abs().max()) <= TOL, mode


def test_kernel_rejects_what_it_does_not_take(cuda):
    a = torch.zeros((8, 0), device=cuda)
    with pytest.raises(ValueError, match="empty input"):
        kernels.mixture_logsumexp(a, a, torch.zeros(8, device=cuda))
    a = torch.zeros((8, 4), device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError):
        kernels.mixture_logsumexp(a, a, torch.zeros(8, device=cuda))


@pytest.mark.parametrize("precision", ["high", "highest"])
def test_kernel_hostile_coordinates_match_float64(cuda, precision):
    """Coordinates up to 6 kernel sd, where a.b - |a|^2/2 - |b|^2/2 cancels
    most: each query sits within ~1 sd of its parent center, as in an SMC
    state. All modes of the two full-precision schemes within 2e-4 nats of
    a float64 plain version."""
    n = m = 20_000
    p = 16
    rng = np.random.default_rng(5)
    b = rng.uniform(-6, 6, (m, p))
    a = b[rng.integers(0, m, n)] + rng.normal(size=(n, p))
    w = rng.uniform(0.5, 1.5, m)
    lw = np.log(w / w.sum())
    t32 = [torch.as_tensor(x, dtype=torch.float32, device=cuda)
           for x in (a, b, lw)]
    ref = kernels.mixture_logsumexp_reference(
        *(x.double() for x in t32), mode="online")
    for mode in ("static", "online", "auto"):
        got = kernels.mixture_logsumexp(*t32, mode=mode, precision=precision)
        assert float((got.double() - ref).abs().max()) <= TOL, mode


@pytest.mark.parametrize("precision", kernels.PRECISIONS)
def test_kernel_auto_makes_no_host_sync(cuda, precision):
    """No mode syncs the host: the dengue keep (2,048^2 x 16, short
    splits) and 2,048 x 16,448 x 16 (the large-keep plan)."""
    a, b, lw = _scaled(2048, 2048, 16, 4, cuda)
    # build and load outside
    kernels.mixture_logsumexp(a, b, lw, precision=precision)
    torch.cuda.synchronize()
    before = kernels.mixture_logsumexp.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        for mode in ("auto", "static", "online"):
            kernels.mixture_logsumexp(a, b, lw, mode=mode,
                                      precision=precision)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert kernels.mixture_logsumexp.launches == before + 4
    a2, b2, lw2 = _scaled(2048, kernels._SHORT_MAX_CENTERS + 64, 16, 4,
                          cuda)
    kernels.mixture_logsumexp(a2, b2, lw2, precision=precision)
    torch.cuda.synchronize()
    before = kernels.mixture_logsumexp.launches - 4
    torch.cuda.set_sync_debug_mode("error")
    try:
        for mode in ("auto", "static", "online"):
            kernels.mixture_logsumexp(a2, b2, lw2, mode=mode,
                                      precision=precision)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert kernels.mixture_logsumexp.launches == before + 8


# p on both sides of each edge of the FFMA program's instances ("highest":
# KS = ceil((p + 1) / 8) keeps a in shared memory up to p = 23, the KS = 0
# instance streams it in chunks of 16 columns above)
FFMA_EDGES = (1, 2, 6, 7, 8, 13, 14, 15, 16, 22, 23, 24, 30, 80)


def _near(n, m, p, seed, dev):
    """An SMC-like state at width p: centers uniform on [-1, 1]^p, each
    query half a kernel sd from a center, normalised weights. Each row's
    terms stay within float32's normal range at any p, so the static plain
    version is exact to float32 there; _scaled's spread at p = 80 puts
    whole rows 100-160 nats down, where the static float32 plain version
    loses its terms to denormals and underflow (the kernel, with its
    headroom, holds them, or gives -inf as the TPU kernel does)."""
    rng = np.random.default_rng(seed)
    b = rng.uniform(-1, 1, (m, p))
    a = b[rng.integers(0, m, n)] + 0.5 * rng.normal(size=(n, p))
    w = rng.uniform(0.5, 1.5, m)
    return [torch.as_tensor(x, dtype=torch.float32, device=dev)
            for x in (a, b, np.log(w / w.sum()))]


@pytest.mark.parametrize("p", FFMA_EDGES)
def test_highest_at_every_instance_edge(cuda, p):
    """"highest" within 2e-4 nats of its plain version in each mode, on
    ragged n and m (no multiple of the 128-row block or the 64-center
    stage; one row; one center); four "highest" launches per three
    calls and none of another scheme."""
    for n, m in ((300, 517), (1, 65), (129, 1), (2085, 2113)):
        a, b, lw = _near(n, m, p, n + m + p, cuda)
        want = dict(kernels.mixture_logsumexp.launches_by_precision)
        for mode in ("static", "online", "auto"):
            got = kernels.mixture_logsumexp(a, b, lw, mode=mode,
                                            precision="highest")
            torch.cuda.synchronize()
            ref = kernels.mixture_logsumexp_reference(a, b, lw, mode=mode)
            assert bool(torch.isfinite(got).all()), (n, m, mode)
            assert float((got - ref).abs().max()) <= TOL, (n, m, mode)
        want["highest"] += 4
        assert kernels.mixture_logsumexp.launches_by_precision == want


@pytest.mark.parametrize("p", [6, 16, 30])
def test_highest_sentinel_and_dead_weights(cuda, p):
    """Weights at the finite -1e30 sentinel and at -inf beside live ones:
    within 2e-4 nats of the plain version in each mode. Every weight dead
    (max_lw 0): static -inf in every row, as the plain version; online and
    auto the sentinel, -1e30 to float32 rounding (rtol 1e-6: an ulp of
    1e30 is 7.6e22, no absolute bound in nats applies)."""
    a, b, lw = _scaled(700, 900, p, 5, cuda)
    lw = lw.clone()
    lw[::3] = -math.inf
    lw[1::7] = -1e30
    dead = torch.full_like(lw, -math.inf)
    for mode in ("static", "online", "auto"):
        got = kernels.mixture_logsumexp(a, b, lw, mode=mode,
                                        precision="highest")
        ref = kernels.mixture_logsumexp_reference(a, b, lw, mode=mode)
        assert bool(torch.isfinite(got).all()), mode
        assert float((got - ref).abs().max()) <= TOL, mode
        got = kernels.mixture_logsumexp(a, b, dead, mode=mode,
                                        precision="highest")
        ref = kernels.mixture_logsumexp_reference(a, b, dead, mode=mode)
        if mode == "static":
            assert bool(torch.isneginf(got).all())
            assert bool(torch.isneginf(ref).all())
        else:
            torch.testing.assert_close(got, ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("p", [6, 13, 30])
def test_highest_split_forced_to_one_and_to_every_stage(cuda, p):
    """``n_split`` 1 (one block sums all 79 stages) and 79 (one stage a
    split): within 2e-4 nats of the plain version in each mode."""
    a, b, lw = _scaled(2085, 5000, p, 9, cuda)
    for n_split in (1, -(-5000 // 64)):
        for mode in ("static", "online", "auto"):
            got = kernels.mixture_logsumexp(a, b, lw, mode=mode,
                                            precision="highest",
                                            n_split=n_split)
            ref = kernels.mixture_logsumexp_reference(a, b, lw, mode=mode)
            assert float((got - ref).abs().max()) <= TOL, (n_split, mode)


@pytest.mark.parametrize("p", [6, 13, 22, 30])
def test_highest_auto_makes_no_host_sync_in_any_instance(cuda, p):
    a, b, lw = _scaled(2048, 2048, p, 4, cuda)
    kernels.mixture_logsumexp(a, b, lw)   # build and load outside
    torch.cuda.synchronize()
    before = kernels.mixture_logsumexp.launches_by_precision["highest"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        kernels.mixture_logsumexp(a, b, lw, mode="auto")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert (kernels.mixture_logsumexp.launches_by_precision["highest"]
            == before + 2)


def test_highest_refuses_a_stage_of_the_old_width(cuda, monkeypatch):
    """The C entry lays "highest" stages out at p + 1 rows only: a plan
    of the earlier width (p + 2 rows, a column of ones as the mma schemes
    keep) is refused with cudaErrorInvalidValue, before any launch."""
    a, b, lw = _scaled(300, 500, 6, 1, cuda)
    monkeypatch.setitem(kernels._AUG_COLS, "highest", 2)
    _clear_plans()
    try:
        with pytest.raises(RuntimeError, match=r"cudaError 1 "):
            kernels.mixture_logsumexp(a, b, lw, mode="auto",
                                      precision="highest")
    finally:
        _clear_plans()


@pytest.mark.parametrize("precision", kernels.PRECISIONS)
def test_c_entry_refuses_a_plan_without_a_prologue(cuda, monkeypatch,
                                                   precision):
    """Every call starts with the prologue: a plan of ``prologue_blocks``
    0 is refused with cudaErrorInvalidValue, and nothing is launched."""
    a, b, lw = _scaled(205, 205, 2, 1, cuda)
    kernels.mixture_logsumexp(a, b, lw, precision=precision)   # load
    real = kernels.launch_plan
    monkeypatch.setattr(kernels, "launch_plan", lambda *x, **k: real(
        *x, **k)._replace(prologue_blocks=0))
    kernels._call_of.cache_clear()
    before = kernels.kernel_launches()
    try:
        with pytest.raises(RuntimeError, match=r"cudaError 1 "):
            kernels.mixture_logsumexp(a, b, lw, mode="auto",
                                      precision=precision)
    finally:
        kernels._call_of.cache_clear()
    assert kernels.kernel_launches() == before


def _clear_plans():
    """Forget every cached plan and call (after a plan constant is
    patched)."""
    kernels.launch_plan.cache_clear()
    kernels._call_of.cache_clear()


# the survivor keeps the main paths give the kernel (PERF.md): sir,
# lv, ma2, gaussian 102-410 x 2; ricker 410 x 3; gk, mg1 410 x 4; dice
# 256 x 2 and 256 x 128 x 2; dengue 2,048^2 x 16; tools.validate and
# bench_extra 10,000 x 5,000 x 6 and 10,000^2 x 6
SHIPPED_KEEPS = ((102, 102, 2), (205, 205, 2), (410, 410, 3), (410, 410, 4),
                 (256, 256, 2), (256, 128, 2), (2048, 2048, 16),
                 (10_000, 5_000, 6), (10_000, 10_000, 6))


@pytest.mark.parametrize("precision", kernels.PRECISIONS)
def test_kernel_at_the_shipped_keeps(cuda, precision):
    """At every shipped keep (all in short splits): each mode within 2e-4
    nats
    of the scheme's plain version, with weights at the -1e30 sentinel and
    at -inf beside live ones; a far query row whose static sum underflows
    (-inf in static, as JAX returns it) makes auto rerun online: auto
    equals online, and the far row's value is the plain version's to
    1e-6 relative (about -1e8, where a float32 ulp is 8)."""
    for n, m, p in SHIPPED_KEEPS:
        a, b, lw = _scaled(n, m, p, n + m + p, cuda)
        lw = lw.clone()
        lw[::17] = -math.inf
        lw[5::23] = -1e30
        for mode in ("static", "online", "auto"):
            got = kernels.mixture_logsumexp(a, b, lw, mode=mode,
                                            precision=precision)
            ref = kernels.mixture_logsumexp_reference(
                a, b, lw, mode=mode, precision=precision)
            assert bool(torch.isfinite(got).all()), (n, m, p, mode)
            assert float((got - ref).abs().max()) <= TOL, (n, m, p, mode)
        a = a.clone()
        a[-1] = 1e4
        out = {mode: kernels.mixture_logsumexp(a, b, lw, mode=mode,
                                               precision=precision)
               for mode in ("static", "online", "auto")}
        ref = kernels.mixture_logsumexp_reference(a, b, lw, mode="online",
                                                  precision=precision)
        assert bool(torch.isneginf(out["static"][-1]))
        assert bool(torch.isfinite(out["static"][:-1]).all())
        assert torch.equal(out["auto"], out["online"]), (n, m, p)
        torch.testing.assert_close(out["auto"][-1], ref[-1], rtol=1e-6,
                                   atol=0)


def _kernel_names(prof):
    """{kernel name: count} of the weight kernel's launches a profile
    traced on the card."""
    counts = {}
    for ev in prof.key_averages():
        key = ev.key
        if ("partial_kernel" in key or "prologue_kernel" in key) and (
                ev.device_type == torch.autograd.DeviceType.CUDA
                or getattr(ev, "device_time_total", 0) > 0):
            counts[key] = counts.get(key, 0) + ev.count
    return counts


@pytest.mark.parametrize("precision", kernels.PRECISIONS)
def test_profiler_counts_the_plans_launches_at_the_shipped_keeps(
        cuda, precision):
    """torch.profiler on the card: at the shipped keeps (205^2 x 2,
    410^2 x 3, 2,048^2 x 16, short splits), at 4,096^2 x 6 and at
    256 x 16,448 x 6 (the large-keep plan) a call is the prologue, then
    one partial kernel a pass. ``launches_per_call`` (the plan) and
    ``kernel_launches`` (the C entry's count) say the same."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):   # warm the tracer up
        kernels.mixture_logsumexp(*_scaled(205, 205, 2, 8, cuda))
        torch.cuda.synchronize()
    for n, m, p in ((205, 205, 2), (410, 410, 3), (2048, 2048, 16),
                    (4096, 4096, 6), (256, kernels._SHORT_MAX_CENTERS + 64,
                                      6)):
        a, b, lw = _scaled(n, m, p, 8, cuda)
        for mode in ("static", "online", "auto"):
            passes = 2 if mode == "auto" else 1
            for _ in range(3):   # the tracer may drop a record, never add
                kernels.mixture_logsumexp(a, b, lw, mode=mode,
                                          precision=precision)
                torch.cuda.synchronize()
                before = kernels.kernel_launches()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(3):
                        kernels.mixture_logsumexp(a, b, lw, mode=mode,
                                                  precision=precision)
                    torch.cuda.synchronize()
                counted = kernels.kernel_launches() - before
                names = _kernel_names(prof)
                if sum(names.values()) == 3 * (passes + 1):
                    break
            assert kernels.launches_per_call(
                n, m, p, mode, precision=precision) == passes + 1
            assert counted == 3 * (passes + 1), (n, m, p, mode)
            prologues = sum(v for k, v in names.items() if "prologue" in k)
            partials = sum(v for k, v in names.items() if "partial" in k)
            assert partials == 3 * passes, (n, m, p, mode, names)
            assert prologues == 3, (n, m, p, mode, names)


GRAPH_CALLS = (((410, 410, 3), "auto"), ((2048, 2048, 16), "static"),
               ((205, 205, 2), "online"), ((256, 128, 2), "auto"))


@pytest.mark.parametrize("precision", kernels.PRECISIONS)
def test_graph_of_calls_replayed_equals_eager(cuda, precision):
    """Four calls at the shipped keeps (every mode) captured into one CUDA
    graph and replayed 50 times on new inputs copied into the captured
    ones: each replay equals the eager calls on those inputs, bit for bit
    (nothing left behind by one replay: each call's prologue, inside the
    graph, resets its arrival counters and its flag)."""
    static = [list(_scaled(*shape, 1, cuda)) for shape, _ in GRAPH_CALLS]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):     # build, load and plan outside
        for x, (_, mode) in zip(static, GRAPH_CALLS):
            kernels.mixture_logsumexp(*x, mode=mode, precision=precision)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [kernels.mixture_logsumexp(*x, mode=mode, precision=precision)
                for x, (_, mode) in zip(static, GRAPH_CALLS)]
    for rep in range(50):
        fresh = [_scaled(*shape, 100 + rep, cuda) for shape, _ in GRAPH_CALLS]
        for dst, src in zip(static, fresh):
            for d, t in zip(dst, src):
                d.copy_(t)
        graph.replay()
        eager = [kernels.mixture_logsumexp(*x, mode=mode, precision=precision)
                 for x, (_, mode) in zip(fresh, GRAPH_CALLS)]
        torch.cuda.synchronize()
        for o, e in zip(outs, eager):
            assert torch.equal(o, e), rep


@pytest.mark.parametrize("precision", kernels.PRECISIONS)
def test_two_streams_at_once_equal_one_after_the_other(cuda, precision):
    """Auto calls in flight on three streams at once (short splits at
    410 and 4,096 centers, the large-keep plan) equal the same calls run
    one after the other."""
    shapes = ((410, 410, 3), (4096, 4096, 6),
              (256, kernels._SHORT_MAX_CENTERS + 64, 6))
    xs = [_scaled(*shape, 6, cuda) for shape in shapes]
    want = [kernels.mixture_logsumexp(*x, precision=precision) for x in xs]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream() for _ in xs]
    for _ in range(20):
        got = []
        for st, x in zip(streams, xs):
            st.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(st):
                got.append(kernels.mixture_logsumexp(*x, precision=precision))
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_generation_step_cuda_matches_cpu(cuda):
    """The f32 step on the card (kernel weights) and on the CPU (plain
    weights), same data and draws: same survivors, close weights."""
    npar, nmet, n, keep = 6, 13, 20_000, 1_000
    raw = {"smc_iterations": 2, "num_samples": n,
           "predictive_prior_size": keep,
           "parameters": [{"name": f"p{i}", "dist_type": "UNIFORM",
                           "num_type": "FLOAT", "par1": 0.0, "par2": 1.0}
                          for i in range(npar)],
           "metrics": [{"name": f"m{j}", "num_type": "FLOAT", "value": 0.5}
                       for j in range(nmet)]}
    cfg = parse_config(raw)
    sim = make_linear_gaussian_simulator(npar, nmet)
    rng = np.random.default_rng(0)
    params = rng.uniform(0, 1, (n, npar))
    seeds = rng.integers(0, 2**31 - 1, n)
    state = (rng.uniform(0.2, 0.8, (keep, npar)), np.full(keep, 1.0 / keep),
             np.full(npar, 0.02))
    ps = ParameterSet.from_specs(cfg.parameters)
    tr = ParameterTransform(cfg.parameters)
    draws = Generation(ps, tr, sim, np.full(nmet, 0.5),
                       device="cpu").draw_step(
        torch.Generator().manual_seed(1), n)
    out = {}
    for dev in (torch.device("cpu"), cuda):
        gen = Generation(ps, tr, sim, np.full(nmet, 0.5), device=dev)
        f32 = dict(dtype=torch.float32, device=dev)
        out[dev.type] = gen.step(
            torch.as_tensor(params, **f32),
            torch.as_tensor(seeds, device=dev), keep, n,
            type(draws)(*(x.to(dev) for x in (
                draws.vdv_seed, draws.pick, draws.noise_u,
                draws.next_seeds))),
            tuple(torch.as_tensor(x, **f32) for x in state),
        )
    cpu, gpu = out["cpu"], out["cuda"]
    assert int(cpu.ncomp_used) == int(gpu.ncomp_used) > 1
    # near-equal distances may swap rank order between devices: align the
    # per-survivor weights by particle index, not by rank
    ci, gi = cpu.survivor_idx.numpy(), gpu.survivor_idx.cpu().numpy()
    assert set(ci.tolist()) == set(gi.tolist())
    np.testing.assert_allclose(gpu.weights.cpu().numpy()[np.argsort(gi)],
                               cpu.weights.numpy()[np.argsort(ci)],
                               rtol=1e-3)


@pytest.mark.parametrize("precision", kernels.PRECISIONS)
def test_run_device_on_cuda_launches_the_kernel(cuda, precision):
    """Every weighted set's kernel call runs the config's weight_precision
    scheme (the fused route replays it from the captured graph)."""
    npar, nmet = 6, 13
    obs = np.full(nmet, 0.5)
    raw = {"smc_iterations": 3, "num_samples": 4096,
           "weight_precision": precision,
           "predictive_prior_fraction": 0.1,
           "parameters": [{"name": f"p{i}", "dist_type": "UNIFORM",
                           "num_type": "FLOAT", "par1": 0.0, "par2": 1.0}
                          for i in range(npar)],
           "metrics": [{"name": f"m{j}", "num_type": "FLOAT",
                        "value": float(obs[j])} for j in range(nmet)]}
    a = AbcSmc(raw, device="cuda",
               simulator=make_linear_gaussian_simulator(npar, nmet))
    kernels.mixture_logsumexp.launches = 0
    for k in kernels.PRECISIONS:
        kernels.mixture_logsumexp.launches_by_precision[k] = 0
    with redirect_stderr(io.StringIO()):
        a.run_device(seed=0)
    assert kernels.mixture_logsumexp.launches >= 2
    assert kernels.mixture_logsumexp.launches_by_precision == {
        k: kernels.mixture_logsumexp.launches if k == precision else 0
        for k in kernels.PRECISIONS}
    pars, w = a.posterior()
    assert np.isfinite(pars).all() and np.isfinite(w).all()
    gens = [e for e in a.timings if e["op"] == "device_generation"]
    assert len(gens) == 3 and all(e["device_ms"] > 0 for e in gens)


# ---------------------------------------------------------- the host engine
def _gauss_cfg(n, sets):
    return {"smc_iterations": sets, "num_samples": n,
            "predictive_prior_fraction": 0.1, "simulator": "gaussian",
            "parameters": [
                {"name": "mu", "dist_type": "UNIFORM", "num_type": "FLOAT",
                 "par1": 0.0, "par2": 5.0},
                {"name": "sigma", "dist_type": "UNIFORM", "num_type": "FLOAT",
                 "par1": 0.1, "par2": 5.0}],
            "metrics": [{"name": "mean", "num_type": "FLOAT", "value": 2.0},
                        {"name": "sd", "num_type": "FLOAT", "value": 1.5}]}


def test_host_loop_on_cuda_launches_the_kernel(cuda):
    """The host brain on a CUDA engine weighs every set after the first
    through the kernel (2 launches per auto call)."""
    a = AbcSmc(_gauss_cfg(4000, 3), device="cuda")
    kernels.mixture_logsumexp.launches = 0
    highest = kernels.mixture_logsumexp.launches_by_precision["highest"]
    with redirect_stderr(io.StringIO()):
        a.run(seed=0)
    # passes 2 and 3 weigh set 1, pass 3 also set 2: three auto calls,
    # of the FP32 FMA scheme ("highest", JAX's default for the host brain)
    assert kernels.mixture_logsumexp.launches == 6
    assert (kernels.mixture_logsumexp.launches_by_precision["highest"]
            == highest + 6)
    pars, w = a.posterior()
    assert np.isfinite(pars).all() and np.isfinite(w).all()
    assert abs(float(pars[:, 0].mean()) - 2.0) < 0.5
    ranks = [e["ncomp_used"] for e in a.timings if e["op"] == "rank"]
    assert ranks == [2, 2, 2]


def test_device_simulator_run_batch_on_cuda(cuda):
    from abcsmc_tpu_torch.models.simulators import make_dice_simulator

    rng = np.random.default_rng(3)
    for sim, p in (
        (make_linear_gaussian_simulator(6, 13), rng.uniform(0, 1, (500, 6))),
        (make_dice_simulator(), rng.integers(1, 60, (500, 2)).astype(float)),
    ):
        seeds = rng.integers(0, 2**31 - 1, 500)
        got = sim.run_batch(p, seeds, np.arange(500), device=cuda,
                            dtype=torch.float32)
        want = sim.batch_fn(torch.as_tensor(p, dtype=torch.float32,
                                            device=cuda),
                            torch.as_tensor(seeds, device=cuda))
        np.testing.assert_array_equal(got, want.double().cpu().numpy())
        cpu64 = sim.run_batch(p, seeds, np.arange(500), device="cpu",
                              dtype=torch.float64)
        np.testing.assert_allclose(got, cpu64, rtol=1e-5, atol=1e-5)


def test_host_ranking_cuda_matches_cpu(cuda):
    """The f32 ranking on the card picks the f64 CPU ranking's component
    count, and keeps the same survivors at every cut where the f64 gap
    between the last kept and the first dropped particle is wider than
    twice the f32 distances' relative error (``rank_precision`` prints
    both for this data)."""
    from abcsmc_tpu_torch.ops import ranking
    from abcsmc_tpu_torch.rank_precision import gpu_test_rows

    x, y, obs, frac, _ = gpu_test_rows()
    out = {}
    for dev, dt in ((torch.device("cpu"), torch.float64),
                    (cuda, torch.float32)):
        order, d, ncomp = ranking.ranking_pls(
            *(torch.as_tensor(v).to(dev, dt) for v in (x, y, obs)), frac)
        assert order.device.type == dev.type
        out[dev.type] = (order.cpu().numpy(), d.double().cpu().numpy(), ncomp)
    (o64, d64, c64), (o32, d32, c32) = out["cpu"], out["cuda"]
    assert c64 == c32 > 1
    top = o64[:2000]
    err = np.max(np.abs(d32[top] - d64[top]) / d64[top])
    s64 = d64[o64]
    cuts = [k for k in range(100, 2000)
            if (s64[k] - s64[k - 1]) / s64[k] > 2 * err]
    assert len(cuts) >= 100
    for k in cuts:
        assert set(o64[:k]) == set(o32[:k]), k


# ------------------------------ model families, MVN, Box-Cox, projection
def _families():
    from abcsmc_tpu_torch.models import simulators as sim

    return {
        "sir": (sim.make_sir_simulator, [0.3, 0.1]),
        "seir_campaign": (sim.make_seir_campaign_simulator,
                          [0.4, 0.2, 0.1, 0.25, 0.01]),
        "lotka_volterra": (sim.make_lotka_volterra_simulator, [1.0, 0.1]),
        "ricker": (sim.make_ricker_simulator, [3.8, 0.3, 10.0]),
        "gk": (sim.make_gk_simulator, [3.0, 1.0, 2.0, 0.5]),
        "mg1": (sim.make_mg1_simulator, [1.0, 5.0, 0.2]),
        "ma2": (sim.make_ma2_simulator, [0.6, 0.2]),
    }


def _ks(a, b):
    """Two-sample Kolmogorov-Smirnov distance."""
    a, b = np.sort(a), np.sort(b)
    grid = np.concatenate([a, b])
    return float(np.abs(
        np.searchsorted(a, grid, side="right") / len(a)
        - np.searchsorted(b, grid, side="right") / len(b)).max())


@pytest.mark.parametrize("name", ["sir", "seir_campaign", "lotka_volterra",
                                  "ricker", "gk", "mg1", "ma2"])
def test_family_simulator_cuda_float32_agrees_with_cpu_float64(cuda, name):
    """The same seeds on the card at float32 and on the CPU at float64: the
    same law (KS below the alpha = 0.001 critical value at 4,096 vs 4,096),
    finite, and replayable on the card from the stored seed, as a resumed
    run replays it: bit for bit in the same batch and in batches of 4 and
    512, for every family (the time loops are elementwise over particles,
    and every row reduction of a family is a fixed tree of elementwise
    adds, whatever the batch around the row). Rows of the two dtypes are
    not compared."""
    make, point = _families()[name]
    n = 4096
    params = np.repeat(np.array([point]), n, axis=0)
    seeds = np.arange(n) * 7919 + 13
    s = make()
    gpu = s.run_batch(params, seeds, np.arange(n), device=cuda,
                      dtype=torch.float32)
    cpu = s.run_batch(params, seeds, np.arange(n), device="cpu",
                      dtype=torch.float64)
    assert gpu.shape == cpu.shape and np.isfinite(gpu).all()
    crit = 1.95 * np.sqrt(2 / n)
    for j in range(gpu.shape[1]):
        assert _ks(gpu[:, j], cpu[:, j]) < crit, (name, j)
    again = s.run_batch(params, seeds, np.arange(n), device=cuda,
                        dtype=torch.float32)
    np.testing.assert_array_equal(again, gpu)
    for k in (4, 512):
        part = s.run_batch(params[:k], seeds[:k], np.arange(k), device=cuda,
                           dtype=torch.float32)
        np.testing.assert_array_equal(part, gpu[:k])


# ------------------------------------------------- the sir loop's kernel
SIR_ROWS = 1 << 20


def _sir_inputs(n, dev, seed, dtype=torch.float32):
    """params [n, 2] across and beyond ``sir_1m``'s prior box (beta in
    [0.05, 1], gamma in [0.02, 0.5]): negative values, beta near 0 and
    large, gamma over 1 and under the 1e-6 clamp; seeds over the whole
    int64 range (the hash reads their low 32 bits) and the production
    range [0, 2^31 - 1)."""
    rng = np.random.default_rng(seed)
    beta = rng.uniform(-1.5, 3.0, n)
    gamma = rng.uniform(-1.0, 1.5, n)
    k = n // 8
    beta[:k] = rng.uniform(-1e-6, 1e-6, k)
    gamma[k:2 * k] = rng.uniform(-2e-6, 2e-6, k)
    beta[2 * k:3 * k] = rng.uniform(5.0, 60.0, k)
    gamma[3 * k:4 * k] = rng.uniform(1.0, 4.0, k)
    box = slice(4 * k, 6 * k)
    beta[box] = rng.uniform(0.05, 1.0, 2 * k)
    gamma[box] = rng.uniform(0.02, 0.5, 2 * k)
    seeds = rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64)
    seeds[::2] = rng.integers(0, 2**31 - 1, (n + 1) // 2)
    return (torch.as_tensor(np.stack([beta, gamma], 1), dtype=dtype,
                            device=dev),
            torch.as_tensor(seeds, device=dev))


def _sir_chain(sim, params, seeds):
    from abcsmc_tpu_torch.models.simulators import CounterNoise

    return sim.metrics_from_noise(params, CounterNoise(seeds, params.dtype))


@pytest.mark.parametrize("population,t_steps,i0,dtype",
                         [(10_000, 160, 10, torch.float32),
                          (100_000, 37, 1, torch.float32),
                          (2**25 + 7, 300, 3, torch.float32),
                          (10_000, 160, 10, torch.float64),
                          (2**25 + 7, 300, 3, torch.float64)])
def test_sir_kernel_bits_equal_the_chain(cuda, population, t_steps, i0,
                                         dtype):
    """The hand kernel against the PyTorch chain it replaces
    (``metrics_from_noise`` with the seeds' counter noise), 1,048,576 rows
    at the published settings, a larger population over a shorter loop,
    and a population over 2^24 over more days than 32 chunks of one day
    hold; in float32 and float64: all six metrics to the bit, one launch a
    call."""
    from abcsmc_tpu_torch.models.simulators import make_sir_simulator
    from abcsmc_tpu_torch.ops.sim_kernels import sir_loop

    sim = make_sir_simulator(population, t_steps, i0)
    params, seeds = _sir_inputs(SIR_ROWS, cuda, 20 + t_steps, dtype)
    launches = sir_loop.launches
    got = sim.batch_fn(params, seeds)
    want = _sir_chain(sim, params, seeds)
    assert sir_loop.launches == launches + 1
    assert sim.row_steps == 2 * t_steps * SIR_ROWS
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (SIR_ROWS, 6)
    got, want = got.cpu().numpy(), want.cpu().numpy()
    for j in range(6):
        np.testing.assert_array_equal(got[:, j], want[:, j], err_msg=str(j))
    # enough rows take off to reach every branch of the loop
    assert (got[:, 0] > 10 * i0).mean() > 0.25
    assert (got[:, 5] > 0).mean() > 0.25


RICKER_ROWS = (1, 4097, 131_073)


def _ricker_kernel_inputs(n, dev, seed, dtype):
    """params [n, 3] over ``ricker_1m``'s prior box (log r in [2, 5], sigma
    in [0.05, 1], phi in [2, 30]) and past it, an eighth of the rows each:
    log r below its clamp at 0 and above its clamp at 6, |sigma| under its
    clamp at 1e-3 and over its clamp at 2, |phi| under its clamp at 1e-2
    and over its clamp at 50, phi in [8, 25] (means straddling 10 and 20
    as the population swings); every sixteenth row at Wood's truth (3.8,
    0.3, 10), the first of them row 0, where the means near 10 put draws
    past the grid; a NaN in each parameter in rows 1-3. Seeds over the
    whole int64 range (the hash reads their low 32 bits) and the
    production range [0, 2^31 - 1)."""
    rng = np.random.default_rng(seed)
    params = rng.uniform([2.0, 0.05, 2.0], [5.0, 1.0, 30.0], (n, 3))
    k = n // 8
    sign = rng.choice([-1.0, 1.0], k)
    params[k:2 * k, 0] = rng.uniform(-2.0, 0.5, k)
    params[2 * k:3 * k, 0] = rng.uniform(5.5, 9.0, k)
    params[3 * k:4 * k, 1] = rng.uniform(-3e-3, 3e-3, k)
    params[4 * k:5 * k, 1] = sign * rng.uniform(1.5, 4.0, k)
    params[5 * k:6 * k, 2] = rng.uniform(-0.03, 0.03, k)
    params[6 * k:7 * k, 2] = sign * rng.uniform(40.0, 90.0, k)
    params[7 * k:, 2] = rng.uniform(8.0, 25.0, n - 7 * k)
    params[::16] = (3.8, 0.3, 10.0)
    for j in range(min(n - 1, 3)):
        params[1 + j, j] = np.nan
    seeds = rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64)
    seeds[::2] = rng.integers(0, 2**31 - 1, (n + 1) // 2)
    return (torch.as_tensor(params, dtype=dtype, device=dev),
            torch.as_tensor(seeds, device=dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", RICKER_ROWS)
def test_ricker_kernel_bits_equal_the_chain(cuda, n, dtype):
    """The hand kernel against the PyTorch chain it replaces
    (``metrics_from_noise`` with the seeds' counter noise) on ragged row
    counts, in float32 and float64: all six metrics to the bit, the grid
    and clamped counts equal, 150 steps a row counted by each, one launch
    a call and no host sync. The kernel's contract is a row's bits in any
    batch of two rows or more, where ``torch.cumsum`` scans each row alone
    in one order (a lone row goes to another scan: the kernel's header), so
    a single row is held to the chain's on that row twice over."""
    from abcsmc_tpu_torch.models.simulators import (
        CounterNoise, make_ricker_simulator,
    )
    from abcsmc_tpu_torch.ops.sim_kernels import ricker_loop

    kernel, chain = make_ricker_simulator(), make_ricker_simulator()
    params, seeds = _ricker_kernel_inputs(n, cuda, 30 + n, dtype)
    counts = kernel.device_counts(cuda)
    launches = ricker_loop.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = kernel.batch_fn(params, seeds)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert ricker_loop.launches == launches + 1
    reps = 2 if n == 1 else 1
    want = chain.metrics_from_noise(
        params.repeat(reps, 1), CounterNoise(seeds.repeat(reps), dtype))
    assert kernel.row_steps == 150 * n and chain.row_steps == 150 * n * reps
    assert got.dtype == dtype and got.shape == (n, 6)
    got, want = got.cpu().numpy(), want.cpu().numpy()
    for j in range(6):
        for r in range(reps):
            np.testing.assert_array_equal(
                got[:, j], want[r * n:(r + 1) * n, j], err_msg=str(j))
    assert torch.equal(counts * reps, chain.device_counts(cuda))
    if n > 1:
        # draws on the grid and on the normal
        assert 0 < counts[0] < 100 * n
    if n > 100_000:
        # Wood's truth puts a few draws past the grid
        assert 0 < counts[1] < counts[0]
    assert np.isfinite(got).all()


def test_ricker_kernel_replayed_in_a_graph_equals_the_chain(cuda):
    """The kernel recorded into a CUDA graph with the row statistics after
    it (static [N, 6] metrics in the graph's pool) and replayed twice with
    new rows copied in: each replay's metrics and counts equal the chain's
    on those rows to the bit, and each replay counts the one launch the
    graph holds."""
    from abcsmc_tpu_torch.models.simulators import (
        CounterNoise, make_ricker_simulator,
    )
    from abcsmc_tpu_torch.ops.sim_kernels import ricker_loop

    sim, chain = make_ricker_simulator(), make_ricker_simulator()
    n = 131_073
    params, seeds = _ricker_kernel_inputs(n, cuda, 1, torch.float32)
    counts = sim.device_counts(cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        sim.batch_fn(params, seeds)          # the build and load
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    launches = ricker_loop.launches
    with kernels.graph_capture_counts() as held, torch.cuda.graph(graph):
        out = sim.batch_fn(params, seeds)
    assert held["ricker_loop"] == 1 and ricker_loop.launches == launches
    for k, seed in enumerate((2, 3), start=1):
        p, s = _ricker_kernel_inputs(n, cuda, seed, torch.float32)
        params.copy_(p)
        seeds.copy_(s)
        counts.zero_()
        chain.device_counts(cuda).zero_()
        graph.replay()
        kernels.count_replay(held, "high")
        assert ricker_loop.launches == launches + k
        want = chain.metrics_from_noise(p, CounterNoise(s, torch.float32))
        torch.cuda.synchronize()
        np.testing.assert_array_equal(out.cpu().numpy(), want.cpu().numpy())
        assert torch.equal(counts, chain.device_counts(cuda))


def _ricker_inputs(n, dev, seed):
    """params [n, 3] over ``ricker_1m``'s prior box (log r in [2, 5], sigma
    in [0.05, 1], phi in [2, 30]), a sixteenth of them at Wood's truth
    (3.8, 0.3, 10), where the means near 10 put draws past the grid; seeds
    in the production range [0, 2^31 - 1)."""
    rng = np.random.default_rng(seed)
    params = rng.uniform([2.0, 0.05, 2.0], [5.0, 1.0, 30.0], (n, 3))
    params[::16] = (3.8, 0.3, 10.0)
    return (torch.as_tensor(params, dtype=torch.float32, device=dev),
            torch.as_tensor(rng.integers(0, 2**31 - 1, n), device=dev))


def test_ricker_rows_are_the_same_bits_in_any_batch(cuda):
    """A 1,048,576-row ``ricker`` batch (``ricker_1m``'s set) against the
    same rows simulated in blocks of 4,096 (16 blocks across the batch) and
    of 131,072 (every row): every metric to the bit, as the chaotic map
    needs for a stored row to replay. The counts of grid and clamped draws
    of the blocks add up to the batch's, a call makes no host sync, and it
    times its row statistics once."""
    from abcsmc_tpu_torch.models.simulators import make_ricker_simulator

    sim = make_ricker_simulator()
    n = 1 << 20
    params, seeds = _ricker_inputs(n, cuda, 5)
    counts = sim.device_counts(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        whole = sim.batch_fn(params, seeds)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert len(sim.stats_events) == 1
    whole = whole.cpu().numpy()
    once = counts.clone()
    # many rows take the grid, some clamp past it, many take the normal
    assert 0 < once[1] < once[0] < 100 * n
    for rows in (4096, 1 << 17):
        counts.zero_()
        starts = range(0, n, rows) if rows > 4096 else range(
            0, n, n // 16)
        for a in starts:
            got = sim.batch_fn(params[a:a + rows], seeds[a:a + rows])
            np.testing.assert_array_equal(got.cpu().numpy(),
                                          whole[a:a + rows], err_msg=str(a))
        if rows > 4096:
            assert torch.equal(counts, once)
    assert np.isfinite(whole).all()


def test_ricker_counts_and_times_on_both_routes(cuda):
    """``ricker`` as ``examples/ricker.json`` ships it, sequential and
    fused (sets 2-5 replay a captured step): the same rows, and the same
    ``sim_grid_steps`` and ``sim_clamped_draws`` a row in every set (a
    replay's counted by the graph itself); 150 steps a row; the row
    statistics timed on eager sets only; one launch of the loop's kernel
    a set on each route."""
    import json
    from pathlib import Path

    raw = json.loads((Path(__file__).resolve().parent.parent / "examples"
                      / "ricker.json").read_text())
    raw.update(num_samples=1 << 14, database_filename="")
    from abcsmc_tpu_torch.ops.sim_kernels import ricker_loop

    runs = {}
    for dispatch in ("sequential", "fused"):
        a = AbcSmc(dict(raw, device_dispatch=dispatch), device="cuda")
        ricker_loop.launches = 0
        with redirect_stderr(io.StringIO()):
            a.run_device(seed=4)
        # the loop's kernel once a set, a replay's as captured
        assert ricker_loop.launches == 6, dispatch
        runs[dispatch] = [e for e in a.timings
                          if e["op"] == "device_generation"], a
    (seq, a_seq), (fused, a_fused) = runs["sequential"], runs["fused"]
    assert [e["route"] for e in fused] == ["eager"] * 2 + ["replay"] * 4
    for x, y in zip(a_seq.storage.read_generations(),
                    a_fused.storage.read_generations()):
        np.testing.assert_array_equal(x.metrics, y.metrics)
    for e, f in zip(seq, fused):
        assert e["sim_steps"] == f["sim_steps"] == 150.0
        assert 0 < e["sim_grid_steps"] == f["sim_grid_steps"] <= 100.0
        assert e["sim_clamped_draws"] == f["sim_clamped_draws"]
        assert e["sim_stats_ms"] > 0
        assert (f["sim_stats_ms"] is None) == (f["route"] == "replay")


def test_sir_kernel_replayed_in_a_graph_equals_the_chain(cuda):
    """The kernel recorded into a CUDA graph (a static [N, 6] output in
    the graph's pool) and replayed twice with new rows copied in: each
    replay's metrics equal the chain's on those rows to the bit."""
    from abcsmc_tpu_torch.models.simulators import make_sir_simulator

    sim = make_sir_simulator()
    params, seeds = _sir_inputs(SIR_ROWS, cuda, 1)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        sim.batch_fn(params, seeds)          # the build and load
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = sim.batch_fn(params, seeds)
    for seed in (2, 3):
        p, s = _sir_inputs(SIR_ROWS, cuda, seed)
        params.copy_(p)
        seeds.copy_(s)
        graph.replay()
        torch.cuda.synchronize()
        np.testing.assert_array_equal(out.cpu().numpy(),
                                      _sir_chain(sim, p, s).cpu().numpy())


def test_sir_kernel_counts_and_dispatch(cuda):
    """One call adds ``t_steps * n`` to ``row_steps`` and one to the
    kernel's launches and makes no host sync; ``run_batch`` on the card
    takes the kernel in float32 and in float64 (the chain's bits in each),
    ``metrics_from_noise`` never reaches it, and a dtype it does not take
    raises."""
    from abcsmc_tpu_torch.models.simulators import make_sir_simulator
    from abcsmc_tpu_torch.ops.sim_kernels import sir_loop

    sim = make_sir_simulator()
    n = 4099
    params, seeds = _sir_inputs(n, cuda, 4)
    sim.batch_fn(params[:8], seeds[:8])       # the build and load
    sim.row_steps = sir_loop.launches = 0
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sim.batch_fn(params, seeds)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert (sim.row_steps, sir_loop.launches) == (160 * n, 1)
    p64, s64 = params.double().cpu().numpy(), seeds.cpu().numpy()
    for k, dtype in enumerate((torch.float32, torch.float64), start=2):
        got = sim.run_batch(p64, s64, np.arange(n), device=cuda,
                            dtype=dtype)
        want = _sir_chain(sim, torch.as_tensor(p64, dtype=dtype,
                                               device=cuda), seeds)
        np.testing.assert_array_equal(
            got, want.cpu().double().numpy())
        assert sir_loop.launches == k
    assert sim.row_steps == 5 * 160 * n
    with pytest.raises(TypeError, match="float32 or float64"):
        sim.batch_fn(params.half(), seeds)
    assert sir_loop.launches == 3


def test_generation_step_mvn_box_cox_cuda_matches_cpu(cuda):
    """The float32 step with MULTIVARIATE noise and Box-Cox on the card and
    on the CPU, same data and draws: lambdas within one grid step, nearly
    the same survivors, the first-round proposals of the same law."""
    from abcsmc_tpu_torch.config import NoiseType

    npar, nmet, n, keep = 3, 6, 20_000, 1_000
    raw = {"smc_iterations": 2, "num_samples": n,
           "predictive_prior_size": keep,
           "parameters": [{"name": f"p{i}", "dist_type": "UNIFORM",
                           "num_type": "FLOAT", "par1": 0.0, "par2": 1.0}
                          for i in range(npar)],
           "metrics": [{"name": f"m{j}", "num_type": "FLOAT", "value": 1.0}
                       for j in range(nmet)]}
    cfg = parse_config(raw)
    rng = np.random.default_rng(0)
    params = rng.uniform(0, 1, (n, npar))
    mix = rng.normal(size=(npar, nmet))
    mets = np.exp(params @ mix + 0.3 * rng.normal(size=(n, nmet)))
    mets[:, 0] -= 1.0                       # a column with a negative min
    obs = np.exp(np.array([0.4, 0.6, 0.5]) @ mix)
    obs[0] -= 1.0
    state = (rng.uniform(0.3, 0.7, (keep, npar)), np.full(keep, 1.0 / keep),
             np.full(npar, 0.02))
    ps = ParameterSet.from_specs(cfg.parameters)
    tr = ParameterTransform(cfg.parameters)
    kw = dict(noise_type=NoiseType.MULTIVARIATE, box_cox=True)
    draws = Generation(ps, tr, None, obs, device="cpu", **kw).draw_step(
        torch.Generator().manual_seed(1), n)
    out = {}
    for dev in (torch.device("cpu"), cuda):
        gen = Generation(ps, tr, None, obs, device=dev, **kw)
        f32 = dict(dtype=torch.float32, device=dev)
        d = type(draws)(draws.vdv_seed.to(dev), draws.pick.to(dev), None,
                        draws.next_seeds.to(dev), draws.noise_eps.to(dev),
                        torch.tensor(2, device=dev))
        out[dev.type] = gen.step_precomputed(
            torch.as_tensor(params, **f32), torch.as_tensor(mets, **f32),
            keep, n, d, tuple(torch.as_tensor(x, **f32) for x in state))
    cpu, gpu = out["cpu"], out["cuda"]
    np.testing.assert_allclose(gpu.box_cox_lambdas.cpu().numpy(),
                               cpu.box_cox_lambdas.numpy(), atol=0.1001)
    ci = set(cpu.survivor_idx.tolist())
    gi = set(gpu.survivor_idx.cpu().tolist())
    assert len(ci & gi) >= 0.98 * keep
    assert gpu.mvn_rounds >= 1 and cpu.mvn_rounds >= 1
    nxt = gpu.next_params.cpu()
    assert bool(ps.valid_mask(nxt).all())
    for j in range(npar):
        assert _ks(nxt[:, j].numpy(), cpu.next_params[:, j].numpy()) < 0.03


def test_shipped_fit_with_mvn_noise_runs_on_cuda(cuda):
    """examples/sir.json cut to 3 sets of 4,096 with Box-Cox on, in memory:
    2 kernel launches per set after the first, MVN rounds counted."""
    import json
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    raw = json.loads((root / "examples" / "sir.json").read_text())
    raw.update(smc_iterations=3, num_samples=4096, database_filename="",
               box_cox=True)
    a = AbcSmc(raw, device="cuda")
    kernels.mixture_logsumexp.launches = 0
    with redirect_stderr(io.StringIO()):
        a.run_device(seed=0)
    assert kernels.mixture_logsumexp.launches == 4
    gens = [e for e in a.timings if e["op"] == "device_generation"]
    assert [e["mvn_rounds"] >= 1 for e in gens] == [True, True, False]
    assert all(len(e["box_cox_lambdas"]) == 6 for e in gens)
    pars, w = a.posterior()
    assert np.isfinite(pars).all() and np.isfinite(w).all()
    assert abs(float(pars[:, 0].mean()) - 0.3) < 0.1
    assert abs(float(pars[:, 1].mean()) - 0.1) < 0.05


def test_projection_on_cuda_launches_no_kernel(cuda):
    """examples/pseudo.json in memory on the card: 25 rows in odometer
    order, all done, and no weight kernel (a projection has no weights)."""
    import json
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    raw = json.loads((root / "examples" / "pseudo.json").read_text())
    raw["database_filename"] = ""
    a = AbcSmc(raw, device="cuda")
    kernels.mixture_logsumexp.launches = 0
    with redirect_stderr(io.StringIO()):
        a.run_device(seed=0)
    assert kernels.mixture_logsumexp.launches == 0
    (gen,) = a.storage.read_generations()
    assert gen.size == 25 and gen.complete
    assert gen.params[:6].tolist() == [[1, 2], [2, 2], [3, 2], [4, 2],
                                       [5, 2], [1, 4]]
    assert gen.params[-1].tolist() == [5, 10]
    assert np.all(gen.metrics[:, 0] >= gen.params[:, 0])
    assert np.all(gen.metrics[:, 0] <= gen.params[:, 0] * gen.params[:, 1])


# ------------------- chunked row passes, graph replays, the surfaces
def _scale_problem(n, keep, seed=0):
    """A 6 x 13 linear-Gaussian population with rank structure, a previous
    state, and the pieces of a Generation."""
    npar, nmet = 6, 13
    rng = np.random.default_rng(seed)
    mix = rng.normal(size=(npar, nmet))
    obs = np.full(npar, 0.5) @ mix
    raw = {"smc_iterations": 2, "num_samples": n,
           "predictive_prior_size": keep,
           "parameters": [{"name": f"p{i}", "dist_type": "UNIFORM",
                           "num_type": "FLOAT", "par1": 0.0, "par2": 1.0}
                          for i in range(npar)],
           "metrics": [{"name": f"m{j}", "num_type": "FLOAT",
                        "value": float(obs[j])} for j in range(nmet)]}
    cfg = parse_config(raw)
    params = rng.uniform(0, 1, (n, npar))
    mets = params @ mix + 0.3 * rng.normal(size=(n, nmet))
    state = (rng.uniform(0.3, 0.7, (keep, npar)), np.full(keep, keep ** -0.5),
             np.full(npar, 0.02))
    ps = ParameterSet.from_specs(cfg.parameters)
    tr = ParameterTransform(cfg.parameters)
    sim = make_linear_gaussian_simulator(npar, nmet, mix=mix)
    return raw, ps, tr, sim, obs, params, mets, state


@pytest.mark.parametrize("row_block", [4096, 3000])
def test_chunked_step_matches_resident_on_cuda(cuda, row_block):
    """float32 on the card, a dividing and a non-dividing block, proposal
    inside the step and apart from it: the same component count, nearly
    the same survivors (near-equal distances may swap at the cut), the
    same doubled variance to 1e-3; the split proposal equals the unsplit
    one bit for bit."""
    n, keep = 32_768, 1_638
    _, ps, tr, _, obs, params, mets, state = _scale_problem(n, keep)
    f32 = dict(dtype=torch.float32, device=cuda)
    p, m = torch.as_tensor(params, **f32), torch.as_tensor(mets, **f32)
    st = tuple(torch.as_tensor(x, **f32) for x in state)
    res = {}
    for rb in (0, row_block):
        gen = Generation(ps, tr, None, obs, device=cuda, row_block=rb)
        draws = gen.draw_step(torch.Generator(device=cuda).manual_seed(3), n)
        res[rb] = gen.step_precomputed(p, m, keep, n, draws, st)
    a, b = res[0], res[row_block]
    assert int(a.ncomp_used) == int(b.ncomp_used) > 1
    both = set(a.survivor_idx.tolist()) & set(b.survivor_idx.tolist())
    assert len(both) >= 0.999 * keep
    np.testing.assert_allclose(b.doubled_variance.cpu().numpy(),
                               a.doubled_variance.cpu().numpy(), rtol=1e-3)
    gen = Generation(ps, tr, None, obs, device=cuda, row_block=row_block,
                     propose_split=True)
    g = torch.Generator(device=cuda).manual_seed(3)
    assert gen.split_propose_active(n, n)
    d = gen.draw_vdv_seed(g)
    ranked = gen.step_precomputed(p, m, keep, 0, d, st)
    nxt, seeds, _ = gen.propose(ranked.survivor_params, ranked.weights,
                                ranked.doubled_variance, n,
                                gen.draw_proposal(g, n, d))
    assert torch.equal(nxt, b.next_params)
    assert torch.equal(seeds, b.next_seeds)


def test_auto_thresholds_come_from_this_card(cuda):
    _, ps, tr, _, obs, *_ = _scale_problem(64, 8)
    gen = Generation(ps, tr, None, obs, device=cuda)
    total = torch.cuda.mem_get_info(cuda)[1]
    assert gen.memory_bytes == total
    assert gen.row_chunk_threshold == int(
        0.8 * total // gen.resident_row_bytes())
    assert gen.row_chunk_threshold < gen.split_threshold
    assert gen.row_block_for(1 << 20) == 0
    assert gen.row_block_for(gen.row_chunk_threshold) == 1 << 21
    assert not gen.split_propose_active(1 << 20, 1 << 20)
    assert gen.split_propose_active(gen.split_threshold, 1)
    cpu = Generation(ps, tr, None, obs, device="cpu")
    assert cpu.row_chunk_threshold is None and cpu.row_block_for(1 << 40) == 0


def test_replayed_step_equals_eager_step(cuda):
    """run_scan on the card: sets 0 and 1 eager, the step captured once
    (under sync-debug "error": a capture that syncs the host raises) and
    sets 2-5 replayed; everything stored equals the sequential loop's bit
    for bit, and the launch counter moves by 2 per set after set 0 on both
    routes though a replay passes through no Python."""
    n, keep, gens = 8192, 410, 6
    _, ps, tr, sim, obs, *_ = _scale_problem(n, keep)

    def make():
        return Generation(ps, tr, sim, obs, device=cuda)

    def g():
        return torch.Generator(device=cuda).manual_seed(9)

    seq = make()
    kernels.mixture_logsumexp.launches = 0
    last, states = seq.run(g(), [n] * gens, [keep] * gens)
    assert kernels.mixture_logsumexp.launches == 2 * (gens - 1)
    fused = make()
    kernels.mixture_logsumexp.launches = 0
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        flast, hist = fused.run_scan(g(), n, keep, gens, full_history=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert kernels.mixture_logsumexp.launches == 2 * (gens - 1)
    assert (fused.graph_captures, fused.graph_replays) == (1, gens - 2)
    assert fused.dispatches == seq.dispatches == gens + 1
    assert [i["route"] for i in fused.set_info] == (
        ["eager"] * 2 + ["replay"] * (gens - 2))
    for t, (sp, w, dv) in enumerate(states):
        assert torch.equal(hist[1][t], sp)
        assert torch.equal(hist[3][t], w)
        assert torch.equal(hist[4][t], dv)
    assert torch.equal(flast.survivor_idx, last.survivor_idx)
    assert torch.equal(flast.metrics, last.metrics)
    assert torch.equal(hist[8][-1], last.metrics)
    # a second run on the same object replays the kept graph: no capture
    fused.run_scan(g(), n, keep, gens)
    assert fused.graph_captures == 1
    assert fused.graph_replays == 2 * (gens - 2) + 1


@pytest.mark.parametrize("block", [64, 2])
def test_replayed_mvn_step_equals_eager_step(cuda, block):
    """MULTIVARIATE noise replays too: run_scan captures the step once (a
    capture that read the host would fail) and replays it; every set's
    rejection count, survivors (rows of the proposal before it), weights
    and doubled variance equal the sequential loop's bit for bit. This problem needs 20-41 rounds a set: a block of
    64 holds them all inside the graph, a block of 2 makes every set
    finish its rounds eagerly after the replay, with the same bits."""
    n, keep, gens = 8192, 410, 6
    _, ps, tr, sim, obs, *_ = _scale_problem(n, keep)

    def make():
        return Generation(ps, tr, sim, obs, device=cuda,
                          noise_type=NoiseType.MULTIVARIATE)

    def g():
        return torch.Generator(device=cuda).manual_seed(9)

    seq = make()
    kernels.mixture_logsumexp.launches = 0
    last, states = seq.run(g(), [n] * gens, [keep] * gens)
    assert kernels.mixture_logsumexp.launches == 2 * (gens - 1)
    fused = make()
    fused.rejection_block = block
    kernels.mixture_logsumexp.launches = 0
    flast, hist = fused.run_scan(g(), n, keep, gens, full_history=True)
    assert kernels.mixture_logsumexp.launches == 2 * (gens - 1)
    assert (fused.graph_captures, fused.graph_replays) == (1, gens - 2)
    assert [i["route"] for i in fused.set_info] == (
        ["eager"] * 2 + ["replay"] * (gens - 2))
    # run_scan's last set proposes too (an unused proposal), run's does not
    rounds = [i["mvn_rounds"] for i in fused.set_info]
    assert rounds[:-1] == [i["mvn_rounds"] for i in seq.set_info][:-1]
    assert min(rounds) > 2 and seq.set_info[-1]["mvn_rounds"] == 0
    finished = [i["mvn_finished_eagerly"] for i in fused.set_info]
    assert finished == [r > block for r in rounds]
    assert fused.mvn_eager_finishes == sum(finished)
    for t, (sp, w, dv) in enumerate(states):
        assert torch.equal(hist[1][t], sp)
        assert torch.equal(hist[3][t], w)
        assert torch.equal(hist[4][t], dv)
    assert torch.equal(flast.survivor_idx, last.survivor_idx)
    assert torch.equal(flast.metrics, last.metrics)


def test_fused_engine_run_equals_sequential_on_cuda(cuda):
    raw, *_ = _scale_problem(4096, 205)
    raw.update(smc_iterations=6, simulator="linear_gaussian",
               database_filename="")
    runs = {}
    for dispatch in ("sequential", "fused"):
        a = AbcSmc(dict(raw, device_dispatch=dispatch), device="cuda")
        kernels.mixture_logsumexp.launches = 0
        with redirect_stderr(io.StringIO()):
            a.run_device(seed=1)
        assert kernels.mixture_logsumexp.launches == 10
        runs[dispatch] = a
    seq, fused = runs["sequential"], runs["fused"]
    ph = [e for e in fused.timings if e["op"] == "run_device_phases"][0]
    assert (ph["route"], ph["graph_replays"], ph["programs"]) == ("scan", 4, 7)
    for x, y in zip(seq.storage.read_generations(),
                    fused.storage.read_generations()):
        np.testing.assert_array_equal(x.params, y.params)
        np.testing.assert_array_equal(x.metrics, y.metrics)
        np.testing.assert_array_equal(x.posterior_ranks, y.posterior_ranks)
    for x, y in zip(seq._weights, fused._weights):
        np.testing.assert_array_equal(x, y)
    gens = [e for e in fused.timings if e["op"] == "device_generation"]
    assert [e["route"] for e in gens] == ["eager"] * 2 + ["replay"] * 4
    assert all(e["device_ms"] > 0 for e in gens)
    assert [e["simulate_ms"] is None for e in gens] == [False] * 2 + [True] * 4


STAGE_KEYS = ("pls_fit_ms", "vdv_ms", "topk_ms", "weights_ms", "propose_ms")


@pytest.mark.parametrize("row_block", [None, 3000],
                         ids=["resident", "chunked"])
def test_eager_stages_tile_the_step(cuda, row_block):
    """An eager fit on the card: each set's simulate stage and the five
    stages after it (the last set proposes nothing) share their boundary
    events, so together they take 85-100 % of the set's ``device_ms``."""
    raw, *_ = _scale_problem(1 << 16, 1000)
    raw.update(smc_iterations=4, simulator="linear_gaussian",
               database_filename="", device_dispatch="sequential")
    if row_block is not None:
        raw["row_block"] = row_block
    a = AbcSmc(raw, device="cuda")
    with redirect_stderr(io.StringIO()):
        a.run_device(seed=3)
    gens = [e for e in a.timings if e["op"] == "device_generation"]
    assert [e["route"] for e in gens] == ["eager"] * 4
    for e in gens:
        stages = [e[k] for k in STAGE_KEYS]
        assert all(ms is not None for ms in stages[:4]), e
        assert (e["propose_ms"] is None) == (e["set"] == 3), e
        total = e["simulate_ms"] + sum(ms for ms in stages if ms is not None)
        assert 0.85 * e["device_ms"] <= total <= e["device_ms"] + 1e-3, e


def test_replayed_sets_time_no_stage_and_count_their_launches(cuda):
    """A fused fit captures its step (no event is recorded in the capture)
    and replays it: its replayed sets read None for every stage, its eager
    ones a time for each. ``kernel_launches`` counts what ran on either
    route: the capture's recorded launches not at all, each replay's once,
    so both routes count the same, one auto call a set after set 0."""
    raw, *_ = _scale_problem(4096, 205)
    raw.update(smc_iterations=6, simulator="linear_gaussian",
               database_filename="")
    counted = {}
    for dispatch in ("sequential", "fused"):
        a = AbcSmc(dict(raw, device_dispatch=dispatch), device="cuda")
        before = kernels.kernel_launches()
        with redirect_stderr(io.StringIO()):
            a.run_device(seed=1)
        torch.cuda.synchronize()
        counted[dispatch] = kernels.kernel_launches() - before
        gens = [e for e in a.timings if e["op"] == "device_generation"]
        for e in gens:
            replayed = e["route"] == "replay"
            assert all((e[k] is None) == replayed for k in STAGE_KEYS[:4]), e
        if dispatch == "fused":
            assert [e["route"] for e in gens] == (
                ["eager"] * 2 + ["replay"] * 4)
    assert counted["fused"] == counted["sequential"] == 5 * (
        kernels.launches_per_call(205, 205, 6, "auto", precision="high"))


def test_fused_mvn_time_loop_captures_once_and_replays(cuda):
    """The builtin ``sir`` (a 160-step loop) under MULTIVARIATE noise on the
    fused route: set 0 and the warm-up set eagerly, one capture inside an
    ``abcsmc.capture`` range, each later set an ``abcsmc.replay`` range
    around its ``abcsmc.step``, their host seconds in ``capture_s`` and
    ``replay_s``. Every set reads the loop's 160 steps a row (a replay the
    captured step's) and runs the loop's kernel once; the eager sets time
    the ``mvn`` stage, the replays none."""
    import json
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    from abcsmc_tpu_torch.ops.sim_kernels import sir_loop

    raw = json.loads((Path(__file__).resolve().parent.parent / "examples"
                      / "sir.json").read_text())
    raw.update(smc_iterations=6, num_samples=1 << 14, database_filename="",
               device_dispatch="fused")
    a = AbcSmc(raw, device="cuda")
    sir_loop.launches = 0
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            redirect_stderr(io.StringIO()):
        a.run_device(seed=2)
    ranges = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith("abcsmc.")]
    names = [n for n, _, _ in ranges]
    assert names.count("abcsmc.capture") == 1
    assert names.count("abcsmc.replay") == 4
    steps = [(x, y) for n, x, y in ranges if n == "abcsmc.step"]
    for n, x, y in ranges:
        if n == "abcsmc.replay":
            assert any(x <= u and v <= y for u, v in steps)
    ph = [e for e in a.timings if e["op"] == "run_device_phases"][0]
    assert (ph["route"], ph["graph_captures"], ph["graph_replays"]) == (
        "scan", 1, 4)
    assert 0 < ph["capture_s"] < ph["dispatch_s"]
    assert 0 < ph["replay_s"] < ph["dispatch_s"]
    gens = [e for e in a.timings if e["op"] == "device_generation"]
    assert [e["route"] for e in gens] == ["eager"] * 2 + ["replay"] * 4
    assert [e["sim_steps"] for e in gens] == [160.0] * 6
    # the hand kernel ran once a set, a replay's as captured
    assert sir_loop.launches == 6
    assert [e["mvn_ms"] is None for e in gens] == [False] * 2 + [True] * 4
    assert all(e["mvn_ms"] > 0 for e in gens[:2])
    assert all(np.isfinite(e["mvn_factor"]).all() for e in gens[:5])


def test_surfaces_on_cuda(cuda, tmp_path):
    from abcsmc_tpu_torch import crc32

    raw, *_ = _scale_problem(4096, 205)
    raw.update(smc_iterations=3, simulator="linear_gaussian",
               database_filename=str(tmp_path / "run.sqlite"))
    a = AbcSmc(raw, device="cuda")
    with redirect_stderr(io.StringIO()):
        a.run_device(seed=1)
    pred = a.posterior_predictive(500, seed=2)
    assert pred.shape == (500, 13) and np.isfinite(pred).all()
    np.testing.assert_array_equal(pred, a.posterior_predictive(500, seed=2))
    assert 1.0 < a.ess() <= 205
    ckpt = str(tmp_path / "ckpt.sqlite")
    a.checkpoint(ckpt)
    assert crc32.verify_checkpoint(ckpt)
    b = AbcSmc.direct(raw["parameters"], raw["metrics"], 4096,
                      smc_iterations=3, predictive_prior_size=205,
                      simulator=a.simulator, device="cuda")
    with redirect_stderr(io.StringIO()):
        b.run_device(seed=1, mirror_store=False)
    assert not b.storage.exists()
    np.testing.assert_array_equal(b.posterior()[0], a.posterior()[0])


@pytest.mark.parametrize("n", [50_000, 1 << 22])
def test_pick_cdf_scan_is_the_same_on_every_call(cuda, n):
    """The pick's cdf scan on the card gives the same bits on every call
    (a 1-D torch.cumsum does not) and agrees with the float64 cumsum."""
    from abcsmc_tpu_torch.parallel.generation import _cumsum

    w = torch.rand(n, generator=torch.Generator(device=cuda).manual_seed(n),
                   device=cuda)
    first = _cumsum(w)
    for _ in range(10):
        assert torch.equal(_cumsum(w), first)
    ref = torch.cumsum(w.double(), 0)
    assert float(((first.double() - ref).abs() / ref).max()) < 1e-5


def _mesh_gen(ps, tr, sim, obs, devices, **kw):
    from abcsmc_tpu_torch.parallel.mesh import particle_mesh

    return Generation(ps, tr, sim, obs, mesh=particle_mesh(devices, **kw))


def test_mesh_step_on_cuda_matches_one_shard(cuda):
    """A 4-shard mesh of the card against one shard, float32, the same van
    der Voet seed: the same component count and survivors (near-equal
    distances may swap at the cut: the psums sum in another order), the
    weights of the common survivors and the doubled variance to 1e-4; the
    kernel runs once per shard on ceil(keep / 4) survivors."""
    import dataclasses

    n, keep = 32_771, 1_639          # neither divides by 4
    _, ps, tr, _, obs, params, mets, state = _scale_problem(n, keep)
    f32 = dict(dtype=torch.float32, device=cuda)
    st = tuple(torch.as_tensor(x, **f32) for x in state)
    one = _mesh_gen(ps, tr, None, obs, ["cuda"])
    four = _mesh_gen(ps, tr, None, obs, ["cuda"] * 4)
    d1 = one.draw_step(torch.Generator(device=cuda).manual_seed(3), n)
    d4 = dataclasses.replace(four.draw_step(torch.Generator().manual_seed(3),
                                            n), vdv_seed=d1.vdv_seed)
    res = {}
    for name, gen, d in (("one", one, d1), ("four", four, d4)):
        p = gen.shard_rows(torch.as_tensor(params, **f32), n)
        m = gen.shard_rows(torch.as_tensor(mets, **f32), n)
        kernels.mixture_logsumexp.launches = 0
        res[name] = gen.step_precomputed(p, m, keep, n, d, st, n_valid=n)
        res[name + "_launches"] = kernels.mixture_logsumexp.launches
    a, b = res["one"], res["four"]
    assert (res["one_launches"], res["four_launches"]) == (2, 8)
    assert int(a.ncomp_used) == int(b.ncomp_used) > 1
    sa, sb = a.survivor_idx.tolist(), b.survivor_idx.tolist()
    both = set(sa) & set(sb)
    assert len(both) >= 0.999 * keep
    wa = dict(zip(sa, a.weights.tolist()))
    wb = dict(zip(sb, b.weights.tolist()))
    top = max(wa.values())
    assert max(abs(wa[i] - wb[i]) for i in both) <= 1e-4 * top
    np.testing.assert_allclose(b.doubled_variance.cpu().numpy(),
                               a.doubled_variance.cpu().numpy(), rtol=1e-4)
    assert sum(x.shape[0] for x in b.next_params) == 32_772
    assert bool(ps.valid_mask(torch.cat(b.next_params)).all())


def test_mesh_replay_on_one_card_equals_eager(cuda):
    """A 4-shard mesh whose shards all sit on the card captures its step
    into one CUDA graph and replays it: every set equals the sequential
    loop's bit for bit, 2 launches per shard per later set."""
    n, keep, gens = 8192, 410, 5
    _, ps, tr, sim, obs, *_ = _scale_problem(n, keep)

    def g():
        return torch.Generator().manual_seed(9)

    seq = _mesh_gen(ps, tr, sim, obs, ["cuda"] * 4)
    kernels.mixture_logsumexp.launches = 0
    last, states = seq.run(g(), [n] * gens, [keep] * gens)
    assert kernels.mixture_logsumexp.launches == 8 * (gens - 1)
    fused = _mesh_gen(ps, tr, sim, obs, ["cuda"] * 4)
    assert fused.capturable
    kernels.mixture_logsumexp.launches = 0
    flast, hist = fused.run_scan(g(), n, keep, gens, full_history=True)
    assert kernels.mixture_logsumexp.launches == 8 * (gens - 1)
    assert (fused.graph_captures, fused.graph_replays) == (1, gens - 2)
    for t, (sp, w, dv) in enumerate(states):
        assert torch.equal(hist[1][t], sp)
        assert torch.equal(hist[3][t], w)
        assert torch.equal(hist[4][t], dv)
    assert torch.equal(torch.cat(flast.metrics), torch.cat(last.metrics))


def test_one_rank_nccl_step_equals_one_shard(cuda):
    """The collectives through a one-rank NCCL group give the bits of the
    one-shard step without a group."""
    import socket

    import torch.distributed as dist

    n, keep = 8192, 410
    _, ps, tr, sim, obs, params, mets, state = _scale_problem(n, keep)
    f32 = dict(dtype=torch.float32, device=cuda)
    st = tuple(torch.as_tensor(x, **f32) for x in state)
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        out = []
        for group in (None, dist.group.WORLD):
            gen = _mesh_gen(ps, tr, None, obs, ["cuda"], group=group)
            assert gen.mesh.size == 1
            d = gen.draw_step(torch.Generator(device=cuda).manual_seed(4), n)
            out.append(gen.step_precomputed(
                [torch.as_tensor(params, **f32)],
                [torch.as_tensor(mets, **f32)], keep, n, d, st))
    finally:
        dist.destroy_process_group()
    a, b = out
    for f in ("survivor_idx", "weights", "doubled_variance", "ncomp_used"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert torch.equal(a.next_params[0], b.next_params[0])


def test_split_override_holds_at_every_split(cuda):
    """``n_split`` at 200,000^2 x 6 (the sweep's shape): every split the
    sweep times, from 1 to one 64-center stage a split, within 2e-4 nats of
    the float64 plain version on sampled rows; the plan's own count, asked
    for explicitly, gives the bits of ``n_split=None``."""
    from abcsmc_tpu_torch.bench_kernel import sampled_error_f64
    from abcsmc_tpu_torch.tools.sweep_weight_kernel import split_points

    k = 200_000
    a, b, lw = _scaled(k, k, 6, 3, cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for mode in ("static", "online"):
        base = kernels.mixture_logsumexp(a, b, lw, mode=mode,
                                         precision="high")
        own = kernels.launch_plan(k, k, 6, sms, mode != "static").n_split
        assert torch.equal(kernels.mixture_logsumexp(
            a, b, lw, mode=mode, precision="high", n_split=own), base)
        for ask in split_points(k)[1:]:
            got = kernels.mixture_logsumexp(a, b, lw, mode=mode,
                                            precision="high", n_split=ask)
            err = sampled_error_f64(a, b, lw, got, 2048, mode=mode)
            assert err <= TOL, (mode, ask, err)


# each study harness at a small size on the card (chip_smoke.py's study
# phase runs them at full size)
SMALL_STUDY = {
    "bench_weight_kernel": ["--k", "5000", "--truncation-k", "512", "--n",
                            "20000", "--keep", "1000", "--reps", "2"],
    "sweep_weight_kernel": ["--k-accuracy", "4000", "--k-sweep", "6000",
                            "--reps", "2"],
    "bench_scale": ["--n", "100000", "--keep", "5000", "--sim", "--reps",
                    "2"],
    "mirror_scale": ["--n", "20000", "--keep", "1000"],
    "bench_reference_shape": ["--n", "2000", "--sets", "3"],
    "quickstart_chip": ["--sets", "6"],
    "million_run": ["--n", "50000", "--sets", "2"],
    "stat_validate": ["--fits", "gaussian", "--n", "5000", "--keep", "500",
                      "--sets", "5"],
    "calibration_study": ["--reps", "1", "--n", "256", "--configs",
                          "lg,ma2"],
    "bench_native": ["--jobs", "50", "--workers", "1", "2"],
    "validate": ["--shapes", "10000x5000x6,20000x8000x13", "--n", "200000",
                 "--keep", "10000", "--row-block", "65536", "--reps", "2"],
}


@pytest.mark.parametrize("tool", sorted(SMALL_STUDY))
def test_study_harness_on_the_card(cuda, tool, tmp_path):
    """The harness's main on CUDA: exit 0 (its own checks held), the card
    line first, and every time it reports measured (not null)."""
    import importlib
    import json

    out = tmp_path / "lines.jsonl"
    main = importlib.import_module(f"abcsmc_tpu_torch.tools.{tool}").main
    assert main([*SMALL_STUDY[tool], "--out", str(out)]) == 0
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    assert lines[0]["tool"] == tool and lines[0]["card"] != "cpu"
    assert len(lines) > 1
    for row in lines[1:]:
        if row.get("unit") in ("ms", "s"):
            assert row["value"] > 0, row
        if "ms" in row:
            assert row["ms"] > 0, row


def test_gen_dengue_surrogate_on_the_card_equals_cpu(cuda, capsys):
    """The config computed on the card (its default device) is byte-equal
    to the one computed on the CPU: float64 on both, values rounded to 6
    digits."""
    from abcsmc_tpu_torch.tools import gen_dengue_surrogate

    assert gen_dengue_surrogate.main([]) == 0
    card = capsys.readouterr().out
    assert gen_dengue_surrogate.main(["--device", "cpu"]) == 0
    assert capsys.readouterr().out == card
    assert len(card) > 1000


def _json_lines(text):
    import json

    return [json.loads(x) for x in text.splitlines() if x.startswith("{")]


@pytest.mark.parametrize("route", ["eager", "replay"])
def test_bench_on_the_card(cuda, route, capsys):
    """The north-star bench at a mid size: one line, ncomp_used > 1; the
    replay route holds its first replay bit-equal to the eager step on the
    same draws before it times (a difference raises)."""
    from abcsmc_tpu_torch import bench

    assert bench.main(["--route", route, "--n", "200000", "--keep",
                       "10000"]) == 0
    (row,) = _json_lines(capsys.readouterr().out)
    assert row["route"] == route and row["ncomp_used"] > 1
    assert row["value"] > 0 and row["device"] != "cpu"
    assert row["vs_baseline"] is None


def test_bench_replay_result_bit_equal_to_eager(cuda):
    """capture_precomputed / replay_precomputed against the eager step on
    the same draws, field by field, and again on new draws."""
    from abcsmc_tpu_torch import bench
    from abcsmc_tpu_torch.tools import _common

    n, keep = 200_000, 10_000
    gen = _common.generation(
        _common.unit_box_config(n, keep, [0.0] * bench.NMET,
                                npar=bench.NPAR), None, [cuda])
    params, mets, state = (torch.from_numpy(x).to(cuda) if i < 2 else
                           tuple(torch.from_numpy(s).to(cuda) for s in x)
                           for i, x in enumerate(bench.make_data(n, keep)))
    g = _common.step_generator(gen)
    d0 = gen.draw_step(g, n)
    eager0 = gen.step_precomputed(params, mets, keep, n, d0, state)
    cap = gen.capture_precomputed(params, mets, keep, n, d0, state)
    assert bench.results_bit_equal(gen.replay_precomputed(cap, d0),
                                   eager0) == []
    d1 = gen.draw_step(g, n)
    eager1 = gen.step_precomputed(params, mets, keep, n, d1, state)
    assert bench.results_bit_equal(gen.replay_precomputed(cap, d1),
                                   eager1) == []
    assert gen.graph_captures == 1 and gen.graph_replays == 2


def test_bench_extra_on_the_card(cuda, capsys):
    from abcsmc_tpu_torch import bench_extra

    kernels.mixture_logsumexp.launches = 0
    assert bench_extra.main(["--kernel-k", "3000", "--gen-n", "20000"]) == 0
    rows = _json_lines(capsys.readouterr().out)
    assert len(rows) == 5
    assert rows[1]["metric"] == "mixture-weight kernel (CUDA) 3000x3000"
    assert all(r["value"] > 0 for r in rows)
    assert kernels.mixture_logsumexp.launches > 0


def test_entry_and_dryrun_on_the_card(cuda, capsys):
    from abcsmc_tpu_torch import graft_entry

    fn, args = graft_entry.entry("cuda")
    surv, w, nxt = fn(*args)
    assert tuple(surv.shape) == (128, 2) and tuple(nxt.shape) == (1024, 2)
    assert surv.is_cuda and bool(torch.isfinite(w).all())
    lines = graft_entry.dryrun_multichip(2)
    assert "all variants" in capsys.readouterr().out.splitlines()[-1]
    assert any("CUDA-graph replays" in x and "(0 " not in x for x in lines)


def test_scaling_counts_on_cuda_equal_cpu(cuda):
    from abcsmc_tpu_torch.tools import scaling_analysis

    for k in (1, 4):
        on_card = scaling_analysis.analyze(k, 4096, 256, device="cuda")
        on_cpu = scaling_analysis.analyze(k, 4096, 256, device="cpu")
        for key in ("collectives", "flops_total", "weight_stage_flops",
                    "topk_two_stage"):
            assert on_card[key] == on_cpu[key], key


# the same elementwise function twice, numpy for the bridge and torch for a
# device simulator (IEEE multiplies and adds, one op at a time, and an
# integer seed term), 6 parameters -> 13 metrics. No division: on CUDA
# torch divides a float32 tensor by a scalar as a product with its
# reciprocal, so the two would differ in the last bit.
_BRIDGE_COEF = np.linspace(-1.5, 2.0, 13)
_INV_997 = 1.0 / 997


def _np_lin(params, seeds):
    s = ((np.asarray(seeds).astype(np.int64) % 997).astype(params.dtype)
         * params.dtype.type(_INV_997))
    cols = params[:, np.arange(13) % 6]
    return (cols * _BRIDGE_COEF.astype(params.dtype)
            + (0.3 * s.astype(params.dtype))[:, None])


def _torch_lin(params, seeds):
    s = (seeds.to(torch.int64) % 997).to(params.dtype) * _INV_997
    cols = params[:, torch.arange(13, device=params.device) % 6]
    coef = torch.as_tensor(_BRIDGE_COEF).to(params)
    return cols * coef + (0.3 * s)[:, None]


def test_bridged_step_on_cuda_equals_device_simulator_step(cuda):
    """The host bridge in a float32 step on the card against the same
    function as a torch DeviceSimulator on the same draws: the same
    metrics, survivors and ncomp_used; the bridge's step is not capturable
    (its host round trip), the same step without the simulator is."""
    from abcsmc_tpu_torch.models.simulators import (
        DeviceSimulator, HostBridgeSimulator,
    )

    n, keep = 20_000, 1_000
    raw, ps, tr, _, obs, *_ = _scale_problem(n, keep)
    out, calls = {}, []

    def host(params, seeds):
        calls.append((params.dtype, seeds.dtype, len(params)))
        return _np_lin(params, seeds)

    for name, sim in (("bridge", HostBridgeSimulator(host, 13)),
                      ("device", DeviceSimulator(_torch_lin, 13))):
        gen = Generation(ps, tr, sim, obs, device=cuda)
        g = torch.Generator(device=cuda).manual_seed(4)
        params, seeds = gen.init_population(g, n)
        res0 = gen.step(params, seeds, keep, n, gen.draw_step(g, n))
        state = (res0.survivor_params, res0.weights, res0.doubled_variance)
        res1 = gen.step(res0.next_params, res0.next_seeds, keep, n,
                        gen.draw_step(g, n), state)
        out[name] = (gen, res0, res1)
    bgen, *bres = out["bridge"]
    dgen, *dres = out["device"]
    assert bgen.capture_blocker() == "the simulator makes a host round trip"
    assert bgen.capture_blocker(with_simulator=False) is None
    assert dgen.capturable and not bgen.capturable
    assert calls == [(np.dtype(np.float32), np.dtype(np.uint32), n)] * 2
    for b, d in zip(bres, dres):
        assert b.metrics.device.type == "cuda"
        assert torch.equal(b.metrics, d.metrics)
        assert torch.equal(b.survivor_idx, d.survivor_idx)
        assert int(b.ncomp_used) == int(d.ncomp_used) > 1
        assert torch.equal(b.weights, d.weights)
    # the step without its simulator still captures (bench --route replay)
    from abcsmc_tpu_torch.bench import results_bit_equal

    params1, mets1 = bres[0].next_params, bres[1].metrics
    state = (bres[0].survivor_params, bres[0].weights,
             bres[0].doubled_variance)
    draws = bgen.draw_step(torch.Generator(device=cuda).manual_seed(5), n)
    eager = bgen.step_precomputed(params1, mets1, keep, n, draws, state)
    cap = bgen.capture_precomputed(params1, mets1, keep, n, draws, state)
    assert results_bit_equal(bgen.replay_precomputed(cap, draws), eager) == []
    assert bgen.graph_captures == 1


def test_bridged_run_device_on_cuda_never_captures(cuda):
    """run_device with the bridge on the card: the device path (not the
    host engine), every set eager under "fused" too, no graph captured,
    the kernel launched for every set after set 0, the stored rows equal
    on both routes."""
    from abcsmc_tpu_torch.models.simulators import HostBridgeSimulator

    raw, *_ = _scale_problem(4096, 205)
    raw.update(smc_iterations=5, database_filename="")
    runs = {}
    for dispatch in ("sequential", "fused"):
        a = AbcSmc(dict(raw, device_dispatch=dispatch), device="cuda",
                   simulator=HostBridgeSimulator(_np_lin, 13))
        kernels.mixture_logsumexp.launches = 0
        with redirect_stderr(io.StringIO()) as err:
            a.run_device(seed=1, verbose=True)
        assert kernels.mixture_logsumexp.launches == 8
        assert "falling back" not in err.getvalue()
        runs[dispatch] = a
    seq, fused = runs["sequential"], runs["fused"]
    ph = [e for e in fused.timings if e["op"] == "run_device_phases"][0]
    assert (ph["route"], ph["graph_captures"], ph["graph_replays"]) == \
        ("scan", 0, 0)
    for x, y in zip(seq.storage.read_generations(),
                    fused.storage.read_generations()):
        np.testing.assert_array_equal(x.params, y.params)
        np.testing.assert_array_equal(x.metrics, y.metrics)
        np.testing.assert_array_equal(x.posterior_ranks, y.posterior_ranks)
    gens = [e for e in fused.timings if e["op"] == "device_generation"]
    assert [e["route"] for e in gens] == ["eager"] * 5
    assert all(e["simulate_ms"] > 0 for e in gens)
