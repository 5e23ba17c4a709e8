"""The weight kernel at the survivor keeps the main paths give it, on the
CPU: the launch plan takes short splits up to ``_SHORT_MAX_CENTERS``
centers (at most ``_SHORT_MAX_SPLIT`` splits, a prologue block a stage)
and keeps the earlier plan above it; the plain version against the JAX
package's Pallas wrapper in interpret mode at the shipped keeps.

The kernel itself runs only on the card (tests/test_torch_gpu.py).
Tolerance: 2e-4 nats, the f32 kernel contract of
tests/test_pallas_kernels.py, as tests/test_torch_precision.py holds the
schemes to JAX's interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from abcsmc_tpu.ops.pallas_kernels import mixture_logsumexp as j_mls
from abcsmc_tpu_torch.ops import kernels

SMS = 132
# every keep^2 x p the shipped examples give the kernel (sir, lv, ma2,
# gaussian 102-410 x 2; ricker 410 x 3; gk, mg1 410 x 4; dice 256 x 2),
# dengue_surrogate's 2,048^2 x 16 and tools.validate's / bench_extra's
# 10,000 x 5,000 x 6 and 10,000^2 x 6
SHIPPED_KEEPS = ((102, 102, 2), (205, 205, 2), (410, 410, 3), (410, 410, 4),
                 (256, 256, 2), (256, 128, 2), (2048, 2048, 16),
                 (10_000, 5_000, 6), (10_000, 10_000, 6))
# the plans before the small keeps had their own (commit 839c81a,
# ``launch_plan(n, m, p, 132, online, precision=...)``), tuple by tuple:
# static, then online
EARLIER_PLANS = {
    ((50_000, 50_000, 6), "highest"): (
        (7, 782, 72, 11, 391, 196,
         (0, 350336, 350532, 900532, 900532, 900924), 900928, "highest"),
        (7, 782, 72, 11, 391, 196,
         (0, 350336, 350532, 900532, 1450532, 1450924), 1450928, "highest")),
    ((50_000, 50_000, 6), "high"): (
        (1, 782, 72, 11, 391, 196,
         (0, 800768, 800964, 1350964, 1350964, 1351356), 1351360, "high"),
        (1, 782, 72, 11, 391, 196,
         (0, 800768, 800964, 1350964, 1900964, 1901356), 1901360, "high")),
    ((50_000, 50_000, 6), "default"): (
        (1, 782, 72, 11, 391, 196,
         (0, 400384, 400580, 950580, 950580, 950972), 950976, "default"),
        (1, 782, 72, 11, 391, 196,
         (0, 400384, 400580, 950580, 1500580, 1500972), 1500976, "default")),
    ((52_429, 52_429, 2), "highest"): (
        (3, 820, 75, 11, 410, 205,
         (0, 157440, 157648, 734368, 734368, 734780), 734784, "highest"),
        (3, 820, 75, 11, 410, 205,
         (0, 157440, 157648, 734368, 1311088, 1311500), 1311504, "highest")),
    ((52_429, 52_429, 2), "high"): (
        (1, 820, 75, 11, 410, 205,
         (0, 839680, 839888, 1416608, 1416608, 1417020), 1417024, "high"),
        (1, 820, 75, 11, 410, 205,
         (0, 839680, 839888, 1416608, 1993328, 1993740), 1993744, "high")),
    ((52_429, 52_429, 2), "default"): (
        (1, 820, 75, 11, 410, 205,
         (0, 419840, 420048, 996768, 996768, 997180), 997184, "default"),
        (1, 820, 75, 11, 410, 205,
         (0, 419840, 420048, 996768, 1573488, 1573900), 1573904, "default")),
    ((200_000, 50_000, 13), "highest"): (
        (14, 782, 261, 3, 1563, 196,
         (0, 700672, 700868, 1300868, 1300868, 1302432), 1302436, "highest"),
        (14, 782, 261, 3, 1563, 196,
         (0, 700672, 700868, 1300868, 1900868, 1902432), 1902436, "highest")),
    ((200_000, 50_000, 13), "high"): (
        (2, 782, 261, 3, 1563, 196,
         (0, 1601536, 1601732, 2201732, 2201732, 2203296), 2203300, "high"),
        (2, 782, 261, 3, 1563, 196,
         (0, 1601536, 1601732, 2201732, 2801732, 2803296), 2803300, "high")),
    ((200_000, 50_000, 13), "default"): (
        (1, 782, 261, 3, 1563, 196,
         (0, 400384, 400580, 1000580, 1000580, 1002144), 1002148, "default"),
        (1, 782, 261, 3, 1563, 196,
         (0, 400384, 400580, 1000580, 1600580, 1602144), 1602148, "default")),
}


def _covers_each_center_once(plan, m):
    seen = np.zeros(m, np.int64)
    for y in range(plan.n_split):
        r = plan.split_centers(y, m)
        assert len(r) > 0
        seen[r.start:r.stop] += 1
    return bool((seen == 1).all())


def _full_split(n, m, sms=SMS):
    """The full rule: about ``_BLOCKS_PER_SM`` blocks a SM, at most
    ``_MAX_SPLIT_STAGES`` stages a split, no split empty."""
    n_stages, q_blocks = -(-m // 64), -(-n // 128)
    want = -(-kernels._BLOCKS_PER_SM * sms // q_blocks)
    ns = max(1, min(want, n_stages),
             -(-n_stages // kernels._MAX_SPLIT_STAGES))
    return ns


def _trimmed(plan, want):
    """``want`` splits as the plan trims them: each split takes
    ceil(n_stages / want) stages, and none is empty."""
    return -(-plan.n_stages // -(-plan.n_stages // want))


@pytest.mark.parametrize("prec", kernels.PRECISIONS)
@pytest.mark.parametrize("n,m,p", SHIPPED_KEEPS)
def test_plan_at_the_shipped_keeps(n, m, p, prec):
    """At every shipped keep (102-10,000 centers, all up to
    ``_SHORT_MAX_CENTERS``), in every scheme and mode: every center in
    exactly one split, 16-byte aligned workspace offsets, and short
    splits: the full rule capped at ``_SHORT_MAX_SPLIT`` splits, a
    prologue block a stage, the prologue and one launch a pass."""
    assert m <= kernels._SHORT_MAX_CENTERS
    for online in (False, True):
        plan = kernels.launch_plan(n, m, p, SMS, online, precision=prec)
        assert plan.n_split * plan.stages_per_split >= plan.n_stages
        assert _covers_each_center_once(plan, m)
        assert all(o % 4 == 0 for o in plan.offsets)
        assert plan.offsets[-1] < plan.ws_floats   # the rerun flag
        assert plan.prologue_blocks == plan.n_stages
        assert plan.n_split == _trimmed(
            plan, min(_full_split(n, m), kernels._SHORT_MAX_SPLIT))
    assert [kernels.launches_per_call(n, m, p, mode, precision=prec)
            for mode in ("static", "online", "auto")] == [2, 2, 3]


@pytest.mark.parametrize("prec", kernels.PRECISIONS)
def test_short_split_threshold_and_the_plan_on_each_side(prec):
    """Short splits up to ``_SHORT_MAX_CENTERS`` and not one stage above:
    at 16,384 centers the full rule capped at ``_SHORT_MAX_SPLIT`` splits
    and a prologue block a stage, at 16,448 the full rule and a prologue
    block for 256 centers. 512 and 513 centers take one rule, at any
    width, and so do the small keeps on a wide query set. An ``n_split``
    asked for is kept, past the cap too, trimmed so that no split is
    empty. On both sides a call is the prologue and one partial kernel a
    pass."""
    short = kernels._SHORT_MAX_CENTERS
    for m, cap in ((short, kernels._SHORT_MAX_SPLIT), (short + 64, None)):
        plan = kernels.launch_plan(2048, m, 6, SMS, False, precision=prec)
        want = _full_split(2048, m)
        assert plan.n_split == _trimmed(plan, min(want, cap or want))
        assert plan.prologue_blocks == (
            plan.n_stages if cap else -(-plan.n_stages // 4))
        assert plan.prologue_blocks * kernels._PROLOGUE_THREADS >= (
            plan.n_stages * kernels._STAGE_CENTERS)
    for m in (512, 513):
        for n, p in ((256, 2), (2048, 6), (410, 30), (410, 31),
                     (200_000, 6)):
            plan = kernels.launch_plan(n, m, p, SMS, True, precision=prec)
            assert plan.prologue_blocks == plan.n_stages == -(-m // 64)
            assert plan.n_split == _trimmed(
                plan, min(_full_split(n, m), kernels._SHORT_MAX_SPLIT))
            assert _covers_each_center_once(plan, m)
    for ask in (1, 3, 8):
        plan = kernels.launch_plan(256, 512, 2, SMS, True, n_split=ask,
                                   precision=prec)
        assert plan.n_split == _trimmed(plan, ask)
        assert plan.prologue_blocks == plan.n_stages
    asked = kernels.launch_plan(2085, 5000, 6, SMS, True, n_split=79,
                                precision=prec)
    assert asked.n_split == 79 > kernels._SHORT_MAX_SPLIT
    assert kernels.launch_plan(205, 205, 2, SMS, False,
                               precision=prec).n_split == 4
    for m in (512, 513, short, short + 64):
        assert [kernels.launches_per_call(2048, m, 6, mode, precision=prec)
                for mode in ("static", "online", "auto")] == [2, 2, 3]


@pytest.mark.parametrize("shape,prec", sorted(EARLIER_PLANS))
def test_plan_above_the_thresholds_is_the_earlier_one(shape, prec):
    """At 50,000^2 x 6, 52,429^2 x 2 and 200,000 x 50,000 x 13 on 132 SMs
    each scheme's plan is the earlier one, field for field, and a call
    is still the prologue and one partial kernel a pass."""
    for online, want in zip((False, True), EARLIER_PLANS[(shape, prec)]):
        plan = kernels.launch_plan(*shape, SMS, online, precision=prec)
        assert tuple(plan) == want
    assert kernels.launches_per_call(*shape, "auto", precision=prec) == 3


def _keep_case(n, m, p, seed):
    """An SMC-like keep: centers uniform on [0.3, 0.7]^p, Dirichlet(5)
    weights, queries drawn by weight and perturbed by the kernel sd,
    scaled to unit kernel sd; one true -inf weight; the last query moved
    far out (1e4 sd), so that its static sum underflows to -inf while
    auto reruns it online to a finite value."""
    rng = np.random.default_rng(seed)
    prev = rng.uniform(0.3, 0.7, (m, p))
    dv = 2.0 * prev.var(axis=0, ddof=1)
    w = rng.gamma(5.0, size=m)
    w /= w.sum()
    q = prev[rng.choice(m, n, p=w)] + np.sqrt(dv) * rng.normal(size=(n, p))
    a = (q - prev.mean(0)) / np.sqrt(dv)
    b = (prev - prev.mean(0)) / np.sqrt(dv)
    lw = np.log(w)
    lw[m // 3] = -np.inf
    a[-1] = 1e4
    return [x.astype(np.float32) for x in (a, b, lw)]


@pytest.mark.parametrize("n,m,p", [(102, 102, 2), (205, 205, 2),
                                   (410, 410, 3), (410, 410, 4),
                                   (256, 256, 2)])
def test_plain_version_against_pallas_interpret_at_the_keeps(n, m, p):
    """At each shipped keep shape, in every mode: the wrapper on CPU
    tensors (the plain version, whatever ``precision`` says) within 2e-4
    nats of JAX's Pallas wrapper in interpret mode, and the plain
    versions of "high" and "highest" too, where finite; the static row
    that underflows is -inf in both, and finite in auto and online in
    both (held to 1e-6 relative: its value is about -1e8, where a float32
    ulp is 8). JAX's CPU ignores a dot's precision, so "default"'s bf16 plain
    version is held to its emulation in tests/test_torch_precision.py,
    not here."""
    a, b, lw = _keep_case(n, m, p, seed=n + m + p)
    ja, jb, jlw = (jnp.asarray(x) for x in (a, b, lw))
    t = [torch.as_tensor(x) for x in (a, b, lw)]
    for mode in ("static", "online", "auto"):
        want = np.asarray(j_mls(ja, jb, jlw, block_i=128, block_j=256,
                                interpret=True, precision="highest",
                                mode=mode))
        assert np.isfinite(want[:-1]).all()
        assert np.isneginf(want[-1]) == (mode == "static")
        got = {prec: kernels.mixture_logsumexp(*t, mode=mode,
                                               precision=prec).numpy()
               for prec in kernels.PRECISIONS}
        got.update({f"plain/{prec}": kernels.mixture_logsumexp_reference(
            *t, mode=mode, precision=prec).numpy()
            for prec in ("high", "highest")})
        for key, val in got.items():
            np.testing.assert_array_equal(np.isneginf(val),
                                          np.isneginf(want), err_msg=key)
            np.testing.assert_allclose(val[:-1], want[:-1], rtol=0,
                                       atol=2e-4, err_msg=f"{key} {mode}")
            if mode != "static":
                np.testing.assert_allclose(val[-1], want[-1], rtol=1e-6,
                                           err_msg=f"{key} {mode}")
