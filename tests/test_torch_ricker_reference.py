"""The plain reference of the ``ricker_1m`` configuration
(``port_bench/reference/ricker.py``) against the port on the CPU at small
sizes: the Ricker loop draw for draw, its counts of grid and clamped
Poisson draws, a whole fit judged correct, and the controls and planted
faults that its judge has to catch. The readings at the cell's own size
come from ``port_bench/control.py`` on the card."""

import contextlib
import io

import pytest
import torch

from abcsmc_tpu_torch import AbcSmc
from abcsmc_tpu_torch.models import simulators
from port_bench import faults, registry
from port_bench.reference import ricker
from port_bench.run import _posterior_state, _store_rows
from port_bench.traffic import Traffic

CELL, CONFIG = "ricker_1m.eager_mem", "ricker_1m"
N, SETS = 4096, 3
#: rows of the control fits: at 2,048 each planted fault still fails its
#: number, in a quarter of the time of the whole fit's 4,096
N_CONTROL = 2048


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


def _limits(n):
    limits = dict(registry.workload(CELL)["check"]["limits"])
    # the largest KS distance of 9 columns of n rows from the exact
    # mixture CDF, ~1.6 / sqrt(n), well inside this
    limits["propose_ks"] = 4.0 / n ** 0.5
    return limits


def _beyond(got, n):
    limits = _limits(n)
    return sorted(k for k, v in got.items() if v > limits[k])


def _judge(sets, tr, n, seed=5):
    return registry.reference(CONFIG).judge(sets, tr.spec(), "cpu", seed,
                                            {"ks_rows": n})


def _fit(tr, seed=99):
    with contextlib.redirect_stderr(io.StringIO()):
        abc = AbcSmc(tr.fit_config(), device="cpu").run_device(seed=seed)
    return [{**r, **s} for r, s in zip(_store_rows(abc),
                                       _posterior_state(abc))], abc


def _rows(kind, n, dtype):
    """params [n, 3]: the prior box, Wood's chaotic regime around log r =
    3.8, or a stable fixed point N* = log r = 1 observed with a mean just
    under 10, where draws clamp past the grid."""
    g = torch.Generator().manual_seed(3)
    if kind == "prior":
        lo = torch.tensor([2.0, 0.05, 2.0], dtype=torch.float64)
        hi = torch.tensor([5.0, 1.0, 30.0], dtype=torch.float64)
        p = lo + (hi - lo) * torch.rand((n, 3), generator=g,
                                        dtype=torch.float64)
    elif kind == "chaotic":
        p = torch.tensor([3.8, 0.3, 10.0], dtype=torch.float64) \
            + torch.tensor([0.05, 0.02, 0.5], dtype=torch.float64) \
            * torch.randn((n, 3), generator=g, dtype=torch.float64)
    else:
        p = torch.stack([torch.full((n,), 1.0, dtype=torch.float64),
                         torch.full((n,), 0.01, dtype=torch.float64),
                         9.5 + 0.4 * torch.rand(n, generator=g,
                                                dtype=torch.float64)], 1)
    seeds = torch.randint(0, 2**31 - 1, (n,), generator=g)
    return p.to(dtype), seeds


def test_counter_draws_are_the_programs():
    """The reference's step normals and uniforms are the program's
    counter-hash draws, column for column, to the bit."""
    seeds = torch.tensor([0, 1, 7, 2**31 - 2, 123456789])
    noise = simulators.CounterNoise(seeds, torch.float32)
    base = ricker.seed_base(seeds)
    ubase = ricker._fmix32((seeds & 0xFFFFFFFF) ^ ricker._UNIFORM_SALT)
    for t in range(4):
        assert torch.equal(noise.normals(2),
                           ricker.step_normals(base, t).to(torch.float32))
        assert torch.equal(noise.uniforms(1),
                           ricker.step_uniform(ubase, t, torch.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("kind", ["prior", "chaotic", "clamping"])
def test_plain_ricker_loop_matches_the_programs_ricker(kind, dtype):
    """Every metric equal to the program's, to the bit, on the CPU in
    both dtypes, in the chaotic regime too (where one ulp apart grows by
    e^0.4 a step); and the program's device counts of grid and clamped
    draws equal the reference's."""
    n = 2000
    params, seeds = _rows(kind, n, dtype)
    sim = simulators.make_ricker_simulator()
    prog = sim.batch_fn(params, seeds)
    counts = [0, 0]
    ref = ricker.simulate(params.double().numpy(), seeds.numpy(), 100, 50,
                          1.0, counts=counts, dtype=dtype)
    assert prog.dtype == ref.dtype == dtype
    assert torch.equal(prog, ref)
    assert sim.device_counts("cpu").tolist() == counts
    assert sim.row_steps == 150 * n
    if kind == "clamping":
        # nearly every draw on the grid, and some past it
        assert counts[0] > 0.95 * 100 * n and counts[1] > 0
    else:
        # both branches of the draw, and rows with zeros in their series
        assert 0 < counts[0] < 100 * n and (ref[:, 4] > 0).sum() > 10


def test_a_whole_fit_is_judged_correct():
    """A fit of the cell's configuration at 4,096 particles and 3 sets on
    the eager route, in float32 as the cell runs it, judged within the
    cell's limits; each set reports 150 steps a row and its counts of grid
    and clamped draws."""
    tr = _traffic()
    sets, abc = _fit(tr)
    assert len(sets) == SETS
    got = _judge(sets, tr, N)
    assert not _beyond(got, N), got
    assert got["sim_err"] == 0.0 and got["vdv_miss"] == 0.0
    gens = [e for e in abc.timings if e["op"] == "device_generation"]
    for e, s in zip(gens, sets):
        counts = [0, 0]
        ricker.simulate(s["params"], s["seeds"], 100, 50, 1.0,
                        counts=counts)
        assert e["sim_steps"] == 150.0 and e["sim_stats_ms"] is None
        assert e["sim_grid_steps"] * N == counts[0]
        assert e["sim_clamped_draws"] * N == counts[1]


@pytest.mark.parametrize("case", [
    "reference_tf32", "reference_noise", "reference_unclamped",
    "reference_unchanged", "program_half", "program_unchanged"])
def test_control_or_planted_fault_fails(case):
    """Each control (the reference in the program's place at TF32) and
    each planted fault (in the reference in the program's place, or in
    the program) fails at least the number it should."""
    tr = _traffic(n=N_CONTROL)
    kind, what = case.split("_", 1)
    if kind == "reference":
        rounding = "tf32" if what == "tf32" else None
        sets = ricker.control_fit(tr.spec(), 11, "cpu", rounding=rounding,
                                  fault=None if rounding else what)
    else:
        with faults.planted(what):
            sets, _ = _fit(tr)
    if what == "unclamped":
        # the fault shows only in rows with a draw past the grid, which a
        # fit this small may not hold: set 0 takes 500 rows that have
        # some, simulated with the fault
        params, seeds = _rows("clamping", 500, torch.float64)
        counts = [0, 0]
        bad = ricker.simulate(params.numpy(), seeds.numpy(), 100, 50, 1.0,
                              fault="unclamped", counts=counts)
        assert counts[1] > 0
        sets[0]["params"][:500] = params.numpy()
        sets[0]["seeds"][:500] = seeds.numpy()
        sets[0]["metrics"][:500] = bad.double().numpy()
    beyond = _beyond(_judge(sets, tr, N_CONTROL), N_CONTROL)
    want = {"tf32": "sim_err", "noise": "sim_err", "unclamped": "sim_err",
            "unchanged": "propose_ks", "half": "rank_excess"}[what]
    assert want in beyond, beyond


def test_reference_in_the_programs_place_passes():
    tr = _traffic(n=N_CONTROL)
    got = _judge(ricker.control_fit(tr.spec(), 11, "cpu", rounding=None),
                 tr, N_CONTROL)
    assert not _beyond(got, N_CONTROL), got
    assert got["sim_err"] == got["vdv_miss"] == 0.0
