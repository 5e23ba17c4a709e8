"""The port's named spans: ``torch.profiler`` ranges ``abcsmc.*`` around the
run's phases, each set's fetch, store writes and reports and each stage of
the step, the host seconds and counts they add to ``run_device_phases``,
the step's stage milliseconds in each ``device_generation`` entry (None on
the CPU, which times no device stage), and the launch counter's graph
accounting. The CUDA side (stage events, replays, the C entry's count) is
held on the card in tests/test_torch_gpu.py."""

import io
import json
from contextlib import redirect_stderr
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from abcsmc_tpu_torch import AbcSmc, spans
from abcsmc_tpu_torch.models.simulators import make_linear_gaussian_simulator
from abcsmc_tpu_torch.ops import _build, kernels, sim_kernels

ROOT = Path(__file__).resolve().parent.parent
NPAR, NMET, N, KEEP, SETS = 3, 5, 400, 40, 3
MIX = np.random.default_rng(11).normal(size=(NPAR, NMET))
OBS = np.array([0.3, 0.7, 0.5]) @ MIX

HOST = ["abcsmc.dispatch", "abcsmc.mirror", "abcsmc.fetch",
        "abcsmc.store.insert_generation_complete",
        "abcsmc.report.filtering", "abcsmc.report.convergence"]
#: the stages of an INDEPENDENT fit's step: every stage but ``mvn``
INDEPENDENT_STAGES = [s for s in spans.STAGES if s != "mvn"]
STEP = ["abcsmc.step", "abcsmc.step.simulate"] + [
    f"abcsmc.step.{s}" for s in INDEPENDENT_STAGES]


def _raw(db="", **extra):
    return {
        "smc_iterations": SETS, "num_samples": N,
        "predictive_prior_size": KEEP, "database_filename": db,
        "parameters": [
            {"name": f"p{i}", "dist_type": "UNIFORM", "num_type": "FLOAT",
             "par1": 0.0, "par2": 1.0} for i in range(NPAR)],
        "metrics": [
            {"name": f"m{j}", "num_type": "FLOAT", "value": float(OBS[j])}
            for j in range(NMET)],
        **extra,
    }


def _engine(raw):
    return AbcSmc(raw, device="cpu", simulator=make_linear_gaussian_simulator(
        NPAR, NMET, mix=MIX))


def _traced_fit(raw, own_simulator=False, **kw):
    a = AbcSmc(raw, device="cpu") if own_simulator else _engine(raw)
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            redirect_stderr(io.StringIO()):
        a.run_device(seed=4, **kw)
    ranges = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith("abcsmc.")]
    return a, ranges


def _phases(a):
    return [e for e in a.timings if e["op"] == "run_device_phases"][-1]


def _within(ranges, inner, outer):
    """Every range named ``inner`` lies inside one named ``outer``."""
    outs = [(a, b) for n, a, b in ranges if n == outer]
    return all(any(a <= x and y <= b for a, b in outs)
               for n, x, y in ranges if n == inner)


def _set_bytes(n, keep, item=4):
    """A set's leaves as fetched: params, int64 seeds, metrics, int64
    survivor indices, weights, doubled variance, the 0-d int64 count."""
    return (n * (NPAR + NMET) * item + n * 8 + keep * 8 + keep * item
            + NPAR * item + 8)


@pytest.mark.parametrize("store", ["memory", "sqlite"])
@pytest.mark.parametrize("row_block", [None, 96], ids=["resident", "chunked"])
def test_a_fit_names_every_span(store, row_block, tmp_path):
    db = str(tmp_path / "fit.sqlite") if store == "sqlite" else ""
    extra = {} if row_block is None else {"row_block": row_block}
    a, ranges = _traced_fit(_raw(db, **extra))
    names = {n for n, _, _ in ranges}
    assert set(HOST + STEP + ["abcsmc.store.create"]) <= names
    # once per set or per stage, never per row
    count = {n: sum(1 for m, _, _ in ranges if m == n) for n in names}
    assert count["abcsmc.step"] == count["abcsmc.step.simulate"] == SETS
    assert count["abcsmc.store.insert_generation_complete"] == SETS
    assert count["abcsmc.report.filtering"] == SETS
    assert count["abcsmc.step.propose"] == SETS - 1   # the last set: none
    for s in INDEPENDENT_STAGES:
        assert count[f"abcsmc.step.{s}"] <= SETS
    assert "abcsmc.step.mvn" not in names
    # a stage's parent is its set's step, a set's the run's phase
    for s in ["simulate", *spans.STAGES]:
        assert _within(ranges, f"abcsmc.step.{s}", "abcsmc.step")
    assert _within(ranges, "abcsmc.step", "abcsmc.dispatch")
    for n in ("abcsmc.fetch", "abcsmc.store.create",
              "abcsmc.store.insert_generation_complete",
              "abcsmc.report.filtering"):
        assert _within(ranges, n, "abcsmc.mirror")
    # the stages follow one another
    starts = sorted((a, n) for n, a, _ in ranges
                    if n.startswith("abcsmc.step.")
                    and n != "abcsmc.step.simulate")
    assert [n for _, n in starts[:5]] == [
        f"abcsmc.step.{s}" for s in INDEPENDENT_STAGES]
    if store == "sqlite":
        a.storage.close()


@pytest.mark.parametrize("extra", [{}, {"device_dispatch": "fused"},
                                   {"row_block": 96}],
                         ids=["sequential", "fused", "chunked"])
def test_phases_hold_the_spans_seconds_and_counts(extra):
    a = _engine(_raw(**extra))
    with redirect_stderr(io.StringIO()):
        a.run_device(seed=4)
    ph = _phases(a)
    for key in ("fetch_s", "store_s", "report_s", "dispatch_s", "mirror_s"):
        assert ph[key] >= 0.0, key
    assert ph["fetch_s"] > 0 and ph["store_s"] > 0 and ph["report_s"] > 0
    assert ph["fetch_s"] + ph["store_s"] <= ph["mirror_s"]
    written = sum(len(g.params) for g in a.storage.read_generations())
    assert ph["store_rows"] == written == SETS * N
    assert ph["fetch_bytes"] == SETS * _set_bytes(N, KEEP)
    assert ph["sets"] == SETS and ph["first_set"] == 0
    # the CPU times no device stage
    gens = [e for e in a.timings if e["op"] == "device_generation"]
    assert [e["set"] for e in gens] == list(range(SETS))
    for e in gens:
        for key in ["device_ms", "simulate_ms"] + [
                f"{s}_ms" for s in spans.STAGES]:
            assert e[key] is None, key


def test_a_fit_without_its_store_writes_no_row():
    a = _engine(_raw())
    with redirect_stderr(io.StringIO()):
        a.run_device(seed=4, mirror_store=False)
    ph = _phases(a)
    assert (ph["store_rows"], ph["store_s"]) == (0, 0.0)
    assert ph["fetch_bytes"] == SETS * _set_bytes(N, KEEP)


def test_a_resumed_set_is_written_back_under_its_spans(tmp_path):
    """Mid-set resume: set 0's rows exist, so its results and ranks are
    written back (a span each) and its rows count once."""
    db = str(tmp_path / "resume.sqlite")
    p = _engine(_raw(db))
    p.build_database(seed=1)
    p.simulate_next_particles(150)
    p.storage.close()
    a, ranges = _traced_fit(_raw(db))
    names = {n for n, _, _ in ranges}
    assert {"abcsmc.store.write_results",
            "abcsmc.store.write_posterior_ranks"} <= names
    assert "abcsmc.store.create" not in names
    ph = _phases(a)
    assert ph["first_set"] == 0 and ph["store_rows"] == SETS * N
    a.storage.close()


def test_split_propose_sets_are_fetched_in_the_dispatch():
    a, ranges = _traced_fit(_raw(propose_split=True))
    assert _within(ranges, "abcsmc.step", "abcsmc.dispatch")
    fetches = [(x, y) for n, x, y in ranges if n == "abcsmc.fetch"]
    dispatch = [(x, y) for n, x, y in ranges if n == "abcsmc.dispatch"]
    # every set but the last proposes apart, so is fetched before it
    inside = sum(1 for x, y in fetches if any(a <= x and y <= b
                                              for a, b in dispatch))
    assert inside == SETS - 1
    assert _phases(a)["fetch_bytes"] == SETS * _set_bytes(N, KEEP)


def test_stage_ranges_nest_and_close_without_events():
    """Off the card (or in a capture) a step's stages are ranges alone:
    each begins where the one before ends, the last is ended by ``end``,
    and no event is recorded."""
    st = spans.StepStages(timed=False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        st.begin("pls_fit")
        st.begin("vdv")
        st.begin("topk")
        assert st.end() is None
        assert st.end() is None         # nothing left running
    got = [e.name() for e in prof.profiler.kineto_results.events()
           if e.name().startswith("abcsmc.")]
    assert sorted(got) == sorted(f"abcsmc.step.{s}"
                                 for s in ("pls_fit", "vdv", "topk"))
    assert st.events == {}
    assert spans.stage_ms(st) == spans.stage_ms(None) == {
        f"{s}_ms": None for s in spans.STAGES}


def test_host_span_adds_its_seconds_to_its_field():
    phases = {"fetch_s": 1.0}
    with spans.host(phases, "fetch_s", "abcsmc.fetch"):
        pass
    assert phases["fetch_s"] >= 1.0


def test_launch_counter_counts_replays_not_captures(monkeypatch):
    """The graph accounting of ``kernel_launches`` against a stand-in for
    the C entry's count: what a capture records comes off every count, the
    sir and ricker kernels' too, and each replay adds what the graph
    holds."""
    c_count = [100]
    monkeypatch.setattr(kernels, "_launch_count", lambda: lambda: c_count[0])
    monkeypatch.setitem(_build._loaded, "mixture_logsumexp", object())
    monkeypatch.setattr(kernels, "_graph_offset", 0)
    monkeypatch.setattr(kernels.mixture_logsumexp, "launches", 7)
    monkeypatch.setattr(kernels.mixture_logsumexp, "launches_by_precision",
                        dict.fromkeys(kernels.PRECISIONS, 0))
    monkeypatch.setattr(sim_kernels.sir_loop, "launches", 5)
    monkeypatch.setattr(sim_kernels.ricker_loop, "launches", 9)
    before = kernels.kernel_launches()
    with kernels.graph_capture_counts() as held:
        # one auto call recorded: prologue + 2 passes; one sir loop, two
        # ricker loops
        c_count[0] += 3
        kernels.count_launches(2, "high")
        sim_kernels.sir_loop.launches += 1
        sim_kernels.ricker_loop.launches += 2
    assert held == {"partial": 2, "kernels": 3, "sir_loop": 1,
                    "ricker_loop": 2}
    assert kernels.kernel_launches() == before
    assert kernels.mixture_logsumexp.launches == 7
    assert kernels.mixture_logsumexp.launches_by_precision["high"] == 0
    assert sim_kernels.sir_loop.launches == 5
    assert sim_kernels.ricker_loop.launches == 9
    for rep in range(1, 4):
        kernels.count_replay(held, "high")
        assert kernels.kernel_launches() == before + 3 * rep
        assert kernels.mixture_logsumexp.launches == 7 + 2 * rep
        assert sim_kernels.sir_loop.launches == 5 + rep
        assert sim_kernels.ricker_loop.launches == 9 + 2 * rep
    # eager launches after it still count as the C entry counts them
    c_count[0] += 2
    assert kernels.kernel_launches() == before + 11


def _sir_raw(noise, **extra):
    """A small fit of the builtin chain-binomial ``sir`` (160 daily steps),
    its observed row the shipped example's."""
    raw = json.loads((ROOT / "examples" / "sir.json").read_text())
    raw.update(smc_iterations=SETS, num_samples=N, database_filename="",
               noise=noise, **extra)
    raw.pop("predictive_prior_fraction")
    raw["predictive_prior_size"] = KEEP
    return raw


@pytest.mark.parametrize("dispatch", ["sequential", "fused"])
@pytest.mark.parametrize("sim", ["sir", "linear_gaussian"])
def test_time_loop_steps_are_counted_per_set(sim, dispatch):
    """``sim_steps``: the simulator's time steps a row, in every set's
    entry (the builtin ``sir`` runs 160); None for a simulator without a
    time loop. The CPU runs the fused route eagerly: no capture, no
    replay, and no replay seconds."""
    if sim == "sir":
        a = AbcSmc(_sir_raw("INDEPENDENT", device_dispatch=dispatch),
                   device="cpu")
    else:
        a = _engine(_raw(device_dispatch=dispatch))
    with redirect_stderr(io.StringIO()):
        a.run_device(seed=4)
    gens = [e for e in a.timings if e["op"] == "device_generation"]
    want = 160.0 if sim == "sir" else None
    assert [e["sim_steps"] for e in gens] == [want] * SETS
    assert a.simulator.row_steps == (None if want is None
                                     else 160 * N * SETS)
    ph = _phases(a)
    assert (ph["graph_captures"], ph["graph_replays"]) == (0, 0)
    assert ph["capture_s"] == ph["replay_s"] == 0.0


@pytest.mark.parametrize("noise", ["MULTIVARIATE", "INDEPENDENT"])
def test_multivariate_sets_run_the_mvn_stage(noise):
    """A MULTIVARIATE set that proposes runs ``abcsmc.step.mvn`` (the
    covariance, its doubled diagonal, the Cholesky factor and the first
    block of rejection rounds) right after ``abcsmc.step.propose`` (the
    resample), inside its step; its entry carries the factor, the one of
    the stored survivors. The CPU times no stage: ``mvn_ms`` is None. An
    INDEPENDENT fit has no such range and no factor."""
    from abcsmc_tpu_torch.ops.resample import setup_mvn_sampler

    a, ranges = _traced_fit(_sir_raw(noise), own_simulator=True)
    count = {n: sum(1 for m, _, _ in ranges if m == n)
             for n, _, _ in ranges}
    gens = [e for e in a.timings if e["op"] == "device_generation"]
    assert all(e["mvn_ms"] is None for e in gens)
    if noise == "INDEPENDENT":
        assert "abcsmc.step.mvn" not in count
        assert all(e["mvn_factor"] is None for e in gens)
        return
    assert count["abcsmc.step.mvn"] == count["abcsmc.step.propose"] \
        == SETS - 1
    assert _within(ranges, "abcsmc.step.mvn", "abcsmc.step")
    props = sorted(x for n, x, _ in ranges if n == "abcsmc.step.propose")
    prop_ends = sorted(y for n, _, y in ranges if n == "abcsmc.step.propose")
    mvns = sorted(x for n, x, _ in ranges if n == "abcsmc.step.mvn")
    assert all(p <= e <= m for p, e, m in zip(props, prop_ends, mvns))
    assert gens[-1]["mvn_factor"] is None      # the last set: no proposal
    for g, e in zip(a.storage.read_generations(), gens[:-1]):
        surv = np.asarray(g.posterior_ranks)
        kept = np.argsort(np.where(surv >= 0, surv, np.iinfo(np.int64).max),
                          kind="stable")[:KEEP]
        want = setup_mvn_sampler(torch.as_tensor(
            np.asarray(g.params)[kept], dtype=torch.float32))
        got = np.asarray(e["mvn_factor"])
        assert got.shape == (2, 2) and got[0, 1] == 0.0
        np.testing.assert_allclose(got, want.numpy(), rtol=1e-6)
