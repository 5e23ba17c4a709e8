"""The plain reference against the program where both can be computed
exactly (float64 on the CPU), and the roofline arithmetic."""

import contextlib
import io

import numpy as np
import pytest
import torch

from port_bench import registry
from port_bench.kernels import weights as kernel_weights
from port_bench.reference import judge, smc
from port_bench.traffic import Traffic


def test_frozen_bound_at_50000_squared_x6():
    assert kernel_weights.least_ms(50_000, 50_000, 6, "high") == \
        pytest.approx(0.598, abs=5e-4)
    t = kernel_weights.terms_ms(50_000, 50_000, 6, "high")
    assert max(t, key=t.get) == "ex2"


def test_counter_normals_match_the_simulators_stream():
    from abcsmc_tpu_torch.models.simulators import counter_normals

    seeds = np.array([0, 1, 7, 2**31 - 2, 123456789], np.uint64)
    got = counter_normals(torch.as_tensor(seeds.astype(np.int64)), 13,
                          torch.float64).numpy()
    # the same words and formula; numpy and torch may round log and cos
    # apart by an ulp
    assert np.allclose(smc.counter_normals(seeds, 13), got, rtol=1e-14,
                       atol=1e-14)


def test_weights_match_the_programs_plain_version():
    from abcsmc_tpu_torch.ops import weights

    g = torch.Generator().manual_seed(4)
    prev = torch.rand((300, 5), generator=g, dtype=torch.float64)
    surv = torch.rand((200, 5), generator=g, dtype=torch.float64)
    pw = torch.rand(300, generator=g, dtype=torch.float64) + 0.1
    dv = smc.doubled_variance(prev)
    lo = torch.zeros(5, dtype=torch.float64)
    hi = torch.ones(5, dtype=torch.float64)
    ref = smc.weights(surv, prev, pw / pw.sum(), dv, lo, hi)
    got = weights.weight_predictive_prior(
        surv, prev, pw, dv, lambda x: torch.zeros(x.shape[0],
                                                  dtype=torch.float64))
    assert torch.allclose(ref, got / got.sum(), rtol=1e-10, atol=1e-14)


def test_mixture_cdf_and_ks():
    g = torch.Generator().manual_seed(1)
    x = torch.rand(20_000, generator=g, dtype=torch.float64)
    assert smc.ks_distance(x, lambda v: v) < 0.015
    cen = torch.tensor([0.3, 0.7], dtype=torch.float64)
    w = torch.tensor([0.25, 0.75], dtype=torch.float64)
    grid = torch.tensor([0.0, 0.5, 1.0], dtype=torch.float64)
    cdf = smc.mixture_cdf(grid, cen, w, torch.tensor(0.05,
                                                     dtype=torch.float64),
                          0.0, 1.0)
    assert cdf[0] == 0.0 and abs(cdf[1] - 0.25) < 1e-4 and cdf[2] == 1.0


@pytest.mark.parametrize("cell", ["north_star_1m.eager_mem"])
def test_program_in_float64_agrees_with_the_reference(cell):
    from abcsmc_tpu_torch import AbcSmc
    from abcsmc_tpu_torch.models import simulators

    from port_bench.run import _posterior_state, _store_rows

    bench = registry.benchmark()
    entry = next(w for w in bench["workloads"] if w["name"] == cell)
    cfg = registry.config(entry["config"])
    cfg["smc"].update(num_samples=2048, smc_iterations=3,
                      predictive_prior_fraction=0.05)
    tr = Traffic(cfg, registry.workload(cell)["traffic"], 2147483650,
                 registry.reference(entry["config"]))
    sim = None
    if cfg["program_simulator"] is not None:
        sim = simulators.make_linear_gaussian_simulator(
            tr.npar, tr.nmet, **cfg["program_simulator"])
    with contextlib.redirect_stderr(io.StringIO()):
        abc = AbcSmc(tr.fit_config(), device="cpu", dtype=torch.float64,
                     simulator=sim).run_device(seed=99)
    sets = [{**r, **s} for r, s in zip(_store_rows(abc),
                                       _posterior_state(abc))]
    got = judge.judge(sets, tr.spec(), "cpu", 5, 2048)
    assert got["sim_err"] < 1e-13
    assert got["rank_excess"] == 0.0 and got["vdv_miss"] < 0.5
    assert got["weight_err"] < 1e-10
    assert got["dv_err"] < 1e-12
    assert got["propose_ks"] < 4.0 / 2048 ** 0.5


def test_reference_in_the_programs_place_reads_near_zero():
    cfg = registry.config("north_star_1m")
    cfg["smc"].update(num_samples=2048, smc_iterations=3,
                      predictive_prior_fraction=0.05)
    tr = Traffic(cfg, {"store": "memory"}, 7,
                 registry.reference("north_star_1m"))
    spec = tr.spec()
    got = judge.judge(judge.control_fit(spec, 3, "cpu", rounding=None),
                      spec, "cpu", 3, 2048)
    assert got["sim_err"] == 0.0 and got["rank_excess"] == 0.0
    assert got["vdv_miss"] == 0.0
    assert got["weight_err"] < 1e-12 and got["dv_err"] == 0.0
    assert got["propose_ks"] < 4.0 / 2048 ** 0.5


def test_vdv_normal_limit_matches_sign_flips():
    """The z of :func:`smc.vdv_statistics` against the sign-flip test
    itself, done with many draws on the same rows, and the rule's own
    count reading 0 beside its neighbours."""
    cfg = registry.config("north_star_1m")
    cfg["smc"].update(num_samples=4096, smc_iterations=1)
    tr = Traffic(cfg, {"store": "memory"}, 5,
                 registry.reference("north_star_1m"))
    spec = tr.spec()
    s = judge.control_fit(spec, 5, "cpu", rounding=None)[0]
    params = torch.as_tensor(s["params"])
    mets = torch.as_tensor(s["metrics"])
    z = smc.vdv_statistics(params, mets, spec.fraction, spec.vdv_rows)
    # the same residuals, and 20,000 sign rows
    n, n_train = 4096, smc.training_rows(4096, spec.fraction)
    zm, zp = smc._zscore(mets)[0], smc._zscore(params)[0]
    xt = zm[:n_train]
    R, Q = smc.pls_fit(xt.T @ xt, xt.T @ zp[:n_train], z.shape[0])
    e2 = (zp[n_train:, None, :] - torch.cumsum(
        (zm[n_train:] @ R)[:, :, None] * Q.T[None], dim=1)) ** 2
    best = e2.sum(0).argmin(0)
    d = e2 - e2[:, best, torch.arange(e2.shape[2])][:, None, :]
    g = torch.Generator().manual_seed(1)
    w = torch.randint(0, 2, (20_000, d.shape[0]), generator=g) * 2.0 - 1.0
    flips = torch.einsum("kn,nap->kap", w.to(d.dtype), d).abs()
    p_mc = (flips >= d.sum(0).abs()[None]).to(d.dtype).mean(0)
    p_normal = 2.0 * (1.0 - torch.special.ndtr(z.abs()))
    near = (p_normal > 0.02) & (p_normal < 0.98)
    assert near.any()
    assert (p_mc - p_normal)[near].abs().max() < 0.03
    c = smc.vdv_components(z, spec.vdv_alpha)
    assert c == s["ncomp"] and smc.vdv_miss(z, c, spec.vdv_alpha) == 0.0
    assert smc.vdv_miss(z, 1, spec.vdv_alpha) > 1.0
