"""The plain reference of the ``sir_1m`` configuration
(``port_bench/reference/sir.py``) against the port on the CPU at small
sizes: the SIR loop draw for draw, the MULTIVARIATE proposal's factor, the
weights, a whole fit judged correct, and the controls and planted faults
that its judge has to catch. The readings at the cell's own size come from
``port_bench/control.py`` on the card."""

import contextlib
import io

import numpy as np
import pytest
import torch

from abcsmc_tpu_torch import AbcSmc
from abcsmc_tpu_torch.models import simulators
from abcsmc_tpu_torch.ops import weights
from abcsmc_tpu_torch.ops.resample import setup_mvn_sampler
from abcsmc_tpu_torch.parallel import generation
from port_bench import faults, registry
from port_bench.reference import sir, smc
from port_bench.run import _posterior_state, _store_rows
from port_bench.traffic import Traffic

CELL, CONFIG = "sir_1m.fused_mvn", "sir_1m"
N, SETS = 4096, 3


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: a fit here runs thousands of small CPU ops,
    which beside the suite's other worker processes spend their time in
    the thread pool's waits (minutes a test instead of seconds)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _traffic(seed=2147483650, n=N, sets=SETS):
    cfg = registry.config(CONFIG)
    cfg["smc"].update(num_samples=n, smc_iterations=sets)
    return Traffic(cfg, registry.workload(CELL)["traffic"], seed,
                   registry.reference(CONFIG))


def _limits(n=N):
    limits = dict(registry.workload(CELL)["check"]["limits"])
    # the largest KS distance of a dozen columns of n rows against a large
    # reference sample, ~1.9 / sqrt(n), well inside this
    limits["propose_ks"] = 4.0 / n ** 0.5
    return limits


def _judge(sets, tr, seed=5, n=N):
    return registry.reference(CONFIG).judge(
        sets, tr.spec(), "cpu", seed, {"ks_rows": n, "ref_rows": 16 * n})


def _fit(tr, seed=99):
    with contextlib.redirect_stderr(io.StringIO()):
        abc = AbcSmc(tr.fit_config(), device="cpu").run_device(seed=seed)
    state = [{**a, **b} for a, b in zip(
        _posterior_state(abc), registry.reference(CONFIG).state(abc))]
    return [{**r, **s} for r, s in zip(_store_rows(abc), state)]


def _beyond(got, n=N):
    limits = _limits(n)
    return sorted(k for k, v in got.items() if v > limits[k])


def test_counter_normals_are_the_hash_of_the_shared_reference():
    seeds = np.array([0, 1, 7, 2**31 - 2, 123456789], np.uint64)
    base = sir.seed_base(torch.as_tensor(seeds.astype(np.int64)))
    got = torch.stack([sir.counter_normal(base, c) for c in range(13)], 1)
    # the same words and formula; numpy and torch may round log and cos
    # apart by an ulp
    assert np.allclose(smc.counter_normals(seeds, 13), got.numpy(),
                       rtol=1e-14, atol=1e-14)


@pytest.mark.parametrize("rows", ["prior", "near_truth"])
def test_plain_sir_loop_matches_the_programs_sir(rows):
    """Every metric equal to the program's, to the bit, in float32 (the
    configuration's dtype): ``sim_err`` reads 0 on the same device."""
    g = torch.Generator().manual_seed(3)
    n = 2000
    if rows == "prior":
        params = torch.stack([0.05 + 0.95 * torch.rand(n, generator=g),
                              0.02 + 0.48 * torch.rand(n, generator=g)], 1)
    else:
        params = torch.tensor([0.30, 0.10]) + 0.02 * torch.randn(
            (n, 2), generator=g)
    params = params.to(torch.float32)
    seeds = torch.randint(0, 2**31 - 1, (n,), generator=g)
    prog = simulators.make_sir_simulator().batch_fn(params, seeds)
    ref = sir.simulate(params.double().numpy(), seeds.numpy(), 10_000, 160,
                       10)
    assert prog.dtype == ref.dtype == torch.float32
    assert torch.equal(prog, ref)
    # the epidemics took off and died out in many rows
    assert (ref[:, 0] > 1000).sum() > 100 and (ref[:, 3] < 160).sum() > 100


def test_multivariate_factor_matches_the_reference():
    """The program's factor (covariance with the n - 1 divisor, diagonal
    alone doubled, Cholesky) against the reference's, in float64."""
    g = torch.Generator().manual_seed(5)
    surv = torch.randn((700, 2), generator=g, dtype=torch.float64) \
        @ torch.tensor([[0.05, 0.02], [0.0, 0.01]], dtype=torch.float64)
    got = setup_mvn_sampler(surv)
    want = sir.mvn_factor(surv)
    assert torch.allclose(got, want, rtol=1e-12, atol=1e-15)
    cov = torch.cov(surv.T)
    assert torch.allclose(want @ want.T, cov + torch.diag(torch.diag(cov)),
                          rtol=1e-12, atol=1e-15)
    assert not torch.allclose(sir.mvn_factor(surv, "cov_full"), want,
                              rtol=1e-3)


def test_weights_match_the_programs_over_the_sir_box():
    """The weights of a MULTIVARIATE fit are the per-parameter kernel's, as
    with INDEPENDENT proposals: the program's plain version against the
    reference's over the configuration's prior box, in float64."""
    tr = _traffic()
    spec = tr.spec()
    lo, hi = (torch.as_tensor(x) for x in (spec.lo, spec.hi))
    g = torch.Generator().manual_seed(4)
    prev = lo + (hi - lo) * torch.rand((300, 2), generator=g,
                                       dtype=torch.float64)
    surv = lo + (hi - lo) * torch.rand((200, 2), generator=g,
                                       dtype=torch.float64)
    pw = torch.rand(300, generator=g, dtype=torch.float64) + 0.1
    dv = smc.doubled_variance(prev)
    ref = smc.weights(surv, prev, pw / pw.sum(), dv, lo, hi)
    got = weights.weight_predictive_prior(
        surv, prev, pw, dv, lambda x: torch.zeros(x.shape[0],
                                                  dtype=torch.float64))
    assert torch.allclose(ref, got / got.sum(), rtol=1e-10, atol=1e-14)


def test_a_whole_fit_is_judged_correct():
    """A fit of the cell's configuration at 4,096 particles and 3 sets (on
    the CPU the fused route runs eagerly), in float32 as the cell runs it,
    judged within the cell's limits."""
    tr = _traffic()
    sets = _fit(tr)
    assert len(sets) == SETS and all(s["mvn_factor"] is not None
                                     for s in sets[:-1])
    got = _judge(sets, tr)
    assert not _beyond(got), got
    assert got["sim_err"] == 0.0 and got["vdv_miss"] == 0.0


@contextlib.contextmanager
def _program_fault(name):
    """A fault planted in the program: ``sim_step``, one day's recoveries of
    the builtin sir drawn with the sign of their normal flipped;
    ``cov_full``, the proposal's factor from the whole covariance doubled,
    not its diagonal alone."""
    mp = pytest.MonkeyPatch()
    if name == "sim_step":
        orig, calls = simulators._binomial_normal, [0]

        def altered(n, p, z):
            calls[0] += 1
            # two draws a day, infections first: day 80's recoveries
            return orig(n, p, -z if calls[0] % 320 == 162 else z)

        mp.setattr(simulators, "_binomial_normal", altered)
    else:
        def doubled(params):
            c = params - params.mean(0)[None, :]
            cov = c.T @ c / (params.shape[0] - 1)
            return torch.linalg.cholesky(2.0 * cov)

        mp.setattr(generation, "setup_mvn_sampler", doubled)
    try:
        yield
    finally:
        mp.undo()


@pytest.mark.parametrize("case", [
    "reference_tf32", "reference_bf16", "reference_sim_step",
    "reference_cov_full", "program_sim_step", "program_cov_full",
    "program_altered"])
def test_control_or_planted_fault_fails(case):
    """Each control (the reference in the program's place at TF32 or
    BF16) and each planted fault (in the reference in the program's place,
    or in the program) fails at least the number it should."""
    tr = _traffic(n=N)
    kind, what = case.split("_", 1)
    if kind == "reference":
        rounding = what if what in ("tf32", "bf16") else None
        sets = sir.control_fit(tr.spec(), 11, "cpu", rounding=rounding,
                               fault=None if rounding else what)
    elif what == "altered":
        with faults.planted("altered"):
            sets = _fit(tr)
    else:
        with _program_fault(what):
            sets = _fit(tr)
    beyond = _beyond(_judge(sets, tr))
    want = {"tf32": "sim_err", "bf16": "sim_err", "sim_step": "sim_err",
            "altered": "sim_err", "cov_full": "chol_err"}[what]
    assert want in beyond, beyond


def test_reference_in_the_programs_place_passes():
    tr = _traffic(n=N)
    got = _judge(sir.control_fit(tr.spec(), 11, "cpu", rounding=None), tr)
    assert not _beyond(got), got
    assert got["sim_err"] == got["chol_err"] == got["vdv_miss"] == 0.0
