"""The host half of the weight kernel's FFMA program ("highest",
``csrc/mixture_logsumexp.cu``, "The FFMA program"), on the CPU: its launch
plan at the edges of each kernel instance, a model of the micro-tile's
index map, its arithmetic in numpy float32 against float64; how
``bench_kernel --baseline`` pairs an earlier source with the wrapper and
plan beside it, the issue-slot floor printed beside the bound, and the
parsers of ``kernel_sass``.

The kernel itself runs only on the card (tests/test_torch_gpu.py).
Tolerance: 2e-4 nats, the f32 kernel contract of
tests/test_pallas_kernels.py."""

import re
import subprocess
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from abcsmc_tpu_torch import bench_kernel, kernel_sass
from abcsmc_tpu_torch.ops import _build, kernels

SRC = (Path(__file__).resolve().parents[1] / "abcsmc_tpu_torch" / "csrc"
       / "mixture_logsumexp.cu")
# p at the edges of the FFMA instances (KS = ceil((p + 1) / 8): 1 up to
# p = 7, 2 up to 15, 3 up to 23, the chunked KS = 0 above) and beyond
K_EDGES = (1, 2, 6, 7, 8, 13, 14, 15, 16, 22, 23, 24, 30, 80)
SIZES = (1, 37, 2048, 50_000)
SMS = 132
LOG2E = np.float32(1.4426950408889634)


def _source_constants():
    """The C entry's instance rule, read from the source: the largest KS
    each scheme keeps on chip and the stage buffer's float4s per KS."""
    text = SRC.read_text()
    reg = re.search(r"return scheme == kHigh \? (\d+) : scheme == kBf16 \? "
                    r"(\d+) : (\d+);", text)
    cap = re.search(r"return kStageTiles \* ks \* \(scheme == kHigh \? "
                    r"(\d+) : (\d+)\);", text)
    tiles = re.search(r"constexpr int kStageTiles = (\d+);", text)
    assert reg and cap and tiles
    return int(reg.group(3)), int(tiles.group(1)) * int(cap.group(2))


@pytest.mark.parametrize("p", K_EDGES)
def test_highest_plan_at_the_instance_edges(p):
    """The "highest" plan at every n, m in SIZES: p + 1 stage rows (b's
    columns and cb, what the C entry demands), whole float4s a stage,
    16-byte aligned disjoint workspace segments, every center in one
    split and no split empty, the stage within the buffer of the instance
    the C entry picks, and at least two partial blocks per SM wherever
    the centers allow a split (short splits, at most _SHORT_MAX_SPLIT,
    up to _SHORT_MAX_CENTERS centers)."""
    max_ks, cap_f4_per_ks = _source_constants()
    for n in SIZES:
        for m in SIZES:
            for online in (False, True):
                plan = kernels.launch_plan(n, m, p, SMS, online,
                                           precision="highest")
                assert plan.ks == plan.k_pad == p + 1
                assert plan.stage_floats == 64 * (p + 1)
                kreg = -(-plan.ks // 8)
                if kreg <= max_ks:
                    assert plan.stage_floats // 4 <= cap_f4_per_ks * kreg
                sizes = (plan.n_stages * plan.stage_floats,
                         plan.prologue_blocks, plan.n_split * n,
                         plan.n_split * n if online else 0,
                         plan.q_blocks, 1)
                ends = [o + s for o, s in zip(plan.offsets, sizes)]
                assert all(o % 4 == 0 for o in plan.offsets)
                assert all(e <= o for e, o in zip(ends, plan.offsets[1:]))
                assert ends[-1] <= plan.ws_floats
                seen = np.zeros(m, np.int64)
                for y in range(plan.n_split):
                    r = plan.split_centers(y, m)
                    assert len(r) > 0
                    seen[r.start:r.stop] += 1
                assert (seen == 1).all()
                if m <= kernels._SHORT_MAX_CENTERS:
                    assert plan.n_split <= kernels._SHORT_MAX_SPLIT
                    assert plan.n_split == min(
                        kernels._SHORT_MAX_SPLIT, plan.n_stages,
                        -(-kernels._BLOCKS_PER_SM * SMS // plan.q_blocks))
                elif n >= 2048 and m >= 2048:
                    assert plan.q_blocks * plan.n_split >= 2 * SMS
                high = kernels.launch_plan(n, m, p, SMS, online)
                assert plan[1:6] == high[1:6]


def _micro_tile(warp, lane):
    """The rows and centers of thread (warp, lane) in a block's 128 rows x
    a 64-center stage, as ``ffma_partial_kernel`` lays them out."""
    rg, cg = 4 * warp + (lane >> 3), lane & 7
    rows = [4 * rg + i for i in range(4)] + [64 + 4 * rg + i for i in range(4)]
    cols = [4 * cg + j for j in range(4)] + [32 + 4 * cg + j for j in range(4)]
    return rows, cols


def test_micro_tile_covers_each_pair_once():
    """Each (row, center) of the block's 128 x 64 tile belongs to exactly
    one thread; the eight threads that share a row are the lanes 8q .. 8q+7
    of one warp (the xor-1, 2, 4 shuffles merge them); within each quarter
    warp the b reads (LDS.128 at 4 cg and 32 + 4 cg) hit 32 distinct banks
    and the a reads one address. The model's formulas are the source's."""
    text = SRC.read_text()
    assert "const int rg = 4 * warp + (lane >> 3), cg = lane & 7;" in text
    assert "return (i < 4 ? 0 : 64 - 4) + 4 * rg + i;" in text
    assert "sb_k + 4 * cg" in text and "sb_k + 32 + 4 * cg" in text
    hits = np.zeros((128, 64), np.int64)
    owners = {}
    for warp in range(4):
        for lane in range(32):
            rows, cols = _micro_tile(warp, lane)
            hits[np.ix_(rows, cols)] += 1
            for r in rows:
                owners.setdefault(r, set()).add((warp, lane))
    assert (hits == 1).all()
    for r, who in owners.items():
        assert len(who) == 8 and len({w for w, _ in who}) == 1
        assert len({lane >> 3 for _, lane in who}) == 1
    for warp in range(4):
        for q in range(4):
            lanes = range(8 * q, 8 * q + 8)
            for off in (0, 32):
                banks = [(off + 4 * (lane & 7) + i) % 32
                         for lane in lanes for i in range(4)]
                assert sorted(banks) == list(range(32))
            assert len({_micro_tile(warp, lane)[0][0] for lane in lanes}) == 1


def _fma(x, y, z):
    """float32 fused multiply-add (the product is exact in float64)."""
    return (x.astype(np.float64) * y + z).astype(np.float32)


def _ffma_model(a, b, lw):
    """The FFMA program's arithmetic in numpy float32 (static mode): b's
    columns times log2(e) and cb = log2(e) (lw - |b|^2/2), the sentinel
    for a dead center; ca = log2(e) (-|a|^2/2 - max_lw) + 64; each logit
    fl(ca + cb), then one FMA per column in column order; a row's sum of
    2^logit, its log2 less 64 in nats plus max_lw."""
    a, b = a.astype(np.float32), b.astype(np.float32)
    lw = np.maximum(lw.astype(np.float32), np.float32(-1e30))
    live = lw > np.float32(-5e29)
    max_lw = np.float32(lw[live].max() if live.any() else 0.0)
    bsq = np.zeros(len(b), np.float32)
    for k in range(b.shape[1]):
        bsq = _fma(b[:, k], b[:, k], bsq)
    cb = np.where(live, LOG2E * _fma(np.float32(-0.5), bsq, lw),
                  np.float32(-1e30) * LOG2E).astype(np.float32)
    b2 = np.where(live[:, None], LOG2E * b, 0).astype(np.float32)
    sq = np.zeros(len(a), np.float32)
    for k in range(a.shape[1]):
        sq = _fma(a[:, k], a[:, k], sq)
    ca = _fma(LOG2E, _fma(np.float32(-0.5), sq, -max_lw), np.float32(64))
    d = (ca[:, None] + cb[None, :]).astype(np.float32)
    for k in range(a.shape[1]):
        d = _fma(a[:, k, None], b2[None, :, k], d)
    s = np.exp2(d.astype(np.float64)).sum(1)
    return (np.log2(s) - 64) * np.log(2) + max_lw


@pytest.mark.parametrize("case", ["ops", "hostile", "dead"])
def test_ffma_rounding_order_against_float64(case):
    """The kernel's rounding order (fl(ca + cb), then the p FMAs) in
    float32 within 2e-4 nats of the float64 plain version: uniform
    queries, coordinates up to 6 kernel sd (where a.b - |a|^2/2 - |b|^2/2
    cancels most), and a third of the weights dead."""
    rng = np.random.default_rng({"ops": 1, "hostile": 2, "dead": 3}[case])
    n, m, p = 150, 230, 13
    if case == "hostile":
        b = rng.uniform(-6, 6, (m, p))
        a = b[rng.integers(0, m, n)] + rng.normal(size=(n, p))
    else:
        a = rng.uniform(-2, 2, (n, p))
        b = rng.uniform(-1, 1, (m, p))
    w = rng.uniform(0.5, 1.5, m)
    lw = np.log(w / w.sum())
    if case == "dead":
        lw[::3] = -np.inf
        lw[1::7] = -1e30
    got = _ffma_model(a, b, lw)
    ref = kernels.mixture_logsumexp_reference(
        *(torch.as_tensor(x.astype(np.float32)).double() for x in (a, b, lw)),
        mode="online").numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= 2e-4


def _baseline_source(tmp_path, kernels_text=None):
    """An earlier source in ``tmp_path`` (here the tree's), with
    ``kernels_text`` as the ``kernels.py`` beside it when given."""
    src = tmp_path / "mixture_logsumexp.cu"
    src.write_text(SRC.read_text())
    if kernels_text is not None:
        (tmp_path / "kernels.py").write_text(kernels_text)
    return src


def test_baseline_takes_the_plan_beside_its_source(tmp_path):
    """``bench_kernel --baseline`` lays an earlier source out by the
    ``kernels.py`` beside it, loaded apart from the package's: here the
    tree's module with "highest"'s stage at p + 2 rows, the layout before
    the FFMA program dropped the column of ones. Its "highest" plan is its
    own; its "high" and "default" plans are the package's."""
    text = Path(kernels.__file__).read_text()
    now_cols = '_AUG_COLS = {"high": 2, "default": 2, "highest": 1}'
    assert now_cols in text
    old = bench_kernel.baseline_kernels(_baseline_source(
        tmp_path, text.replace(now_cols, now_cols.replace("1}", "2}"))))
    assert old is not kernels
    assert Path(old.__file__) == tmp_path / "kernels.py"
    for p in K_EDGES:
        for n in SIZES:
            got = old.launch_plan(n, 50_000, p, SMS, True,
                                  precision="highest")
            now = kernels.launch_plan(n, 50_000, p, SMS, True,
                                      precision="highest")
            assert (got.ks, now.ks) == (p + 2, p + 1)
            assert got.stage_floats == 64 * (p + 2)
            for prec in ("high", "default"):
                assert (old.launch_plan(n, 50_000, p, SMS, True,
                                        precision=prec)
                        == kernels.launch_plan(n, 50_000, p, SMS, True,
                                               precision=prec))


def test_baseline_without_a_plan_runs_the_trees_wrapper(tmp_path):
    """With no ``kernels.py`` beside the source (an edited copy of the
    current one), the baseline is the tree's wrapper loaded apart: the
    same plans, and on CPU tensors the same plain values, every scheme."""
    old = bench_kernel.baseline_kernels(_baseline_source(tmp_path))
    assert old is not kernels
    assert Path(old.__file__) == Path(kernels.__file__)
    assert old.PRECISIONS == kernels.PRECISIONS
    for prec in kernels.PRECISIONS:
        assert (old.launch_plan(50_000, 50_000, 6, SMS, False,
                                precision=prec)
                == kernels.launch_plan(50_000, 50_000, 6, SMS, False,
                                       precision=prec))
    rng = np.random.default_rng(3)
    a = torch.as_tensor(rng.normal(size=(37, 6)), dtype=torch.float32)
    b = torch.as_tensor(rng.normal(size=(50, 6)), dtype=torch.float32)
    lw = torch.full((50,), -float(np.log(50)))
    for prec in kernels.PRECISIONS:
        assert torch.equal(
            old.mixture_logsumexp(a, b, lw, precision=prec),
            kernels.mixture_logsumexp(a, b, lw, precision=prec))


def test_baseline_binds_its_own_source(tmp_path, monkeypatch):
    """The baseline wrapper's C entry is the library built from its own
    source, under a name of its own, whatever name the wrapper asks the
    loader for; the loader is put back afterwards and the entry bound
    once."""
    src = _baseline_source(tmp_path)
    entry = types.SimpleNamespace()
    calls = []

    def fake(name, path=None):
        calls.append((name, path))
        return types.SimpleNamespace(mixture_logsumexp_f32=entry)

    monkeypatch.setattr(_build, "load_library", fake)
    old = bench_kernel.baseline_kernels(src)
    assert old._library() is entry
    assert old._library() is entry
    assert calls == [("baseline_mixture_logsumexp", src)]
    assert len(entry.argtypes) == 22
    assert _build.load_library is fake


def test_parse_shapes():
    """``--shapes`` takes n x m x p triples, comma-separated."""
    assert bench_kernel.parse_shapes("50000x50000x6,2048x2048x16") == (
        (50_000, 50_000, 6), (2048, 2048, 16))
    assert bench_kernel.parse_shapes("1x37x80,") == ((1, 37, 80),)


def test_issue_term_beside_the_bound(monkeypatch):
    """The issue-slot floor, (K + 2) thread-instructions a logit for
    "highest" at 128 per SM and clock, is returned as ``issue_model_ms``
    beside the bound, outside its terms and not part of it; the bound's
    own terms are as before."""
    assert bench_kernel.issue_per_logit(6, "highest") == 10
    assert bench_kernel.issue_per_logit(13, "highest") == 17
    assert bench_kernel.issue_per_logit(13, "high") == 2 + 6 * 32 / 128
    assert bench_kernel.issue_per_logit(13, "default") == 2 + 32 / 128
    with pytest.raises(ValueError):
        bench_kernel.issue_per_logit(6, "fast")
    monkeypatch.setattr(subprocess, "run", lambda *a, **k: types.
                        SimpleNamespace(stdout="1980\n"))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(
                            multi_processor_count=132))
    per_ms = 132 * 1980 * 1e3
    for n, m, p in ((50_000, 50_000, 6), (200_000, 50_000, 13)):
        got = bench_kernel.kernel_bound_ms(n, m, p, "highest")
        terms = got["terms_ms"]
        assert got["issue_model_ms"] == pytest.approx(
            (p + 4) * n * m / (128 * per_ms), rel=1e-12)
        assert "issue" not in terms
        assert got["bound_ms"] == max(terms["ex2"], terms["ffma"],
                                      terms["bytes"])
        assert got["issue_model_ms"] > got["bound_ms"]
    at_6 = bench_kernel.kernel_bound_ms(50_000, 50_000, 6, "highest")
    assert at_6["terms_ms"]["ex2"] == pytest.approx(
        at_6["terms_ms"]["ffma"], rel=1e-12)


PTXAS = """\
ptxas info    : Compiling entry function '_Z3fooILi1ELb0EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z3fooILi1ELb0EEvv
    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 24576 bytes smem, \
400 bytes cmem[0]
"""
SASS = """\
        Function : _Z3fooILi1ELb0EEvv
        .headerflags    @"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;      /* 0x0 */
        /*0010*/                   LDS.128 R4, [R2] ;          /* 0x0 */
        /*0020*/                   FFMA R8, R4, R5, R8 ;       /* 0x0 */
        /*0030*/                   FFMA R9, R4, R6, R9 ;       /* 0x0 */
        /*0040*/                   MUFU.EX2 R10, R8 ;          /* 0x0 */
        /*0050*/                   FADD R11, R10, R11 ;        /* 0x0 */
        /*0060*/               @P0 BRA 0x10 ;                  /* 0x0 */
        /*0070*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ; /* 0x0 */
        /*0080*/              @!P1 BRA 0x70 ;                  /* 0x0 */
        /*0090*/                   EXIT ;                      /* 0x0 */
"""


def test_kernel_sass_parsers():
    """``kernel_sass`` reads ptxas's registers, shared memory and spills
    and counts a kernel's SASS by class, over the whole kernel and over
    the shortest loop that holds a MUFU."""
    name = "_Z3fooILi1ELb0EEvv"
    info = kernel_sass.parse_ptxas(PTXAS)[name]
    assert info == {"registers": 128, "smem_bytes": 24576, "stack_bytes": 0,
                    "spill_stores": 8, "spill_loads": 4}
    insns = kernel_sass.parse_sass(SASS)[name]
    assert len(insns) == 10
    whole = kernel_sass.counts(insns)
    assert (whole["FFMA"], whole["MUFU"], whole["LDS"], whole["FADD"],
            whole["other"]) == (2, 1, 1, 1, 5)
    loop = kernel_sass.hot_loop(insns)
    assert [a for a, _, _ in loop] == [0x10, 0x20, 0x30, 0x40, 0x50, 0x60]
    assert kernel_sass.counts(loop)["other"] == 1
