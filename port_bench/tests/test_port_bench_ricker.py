"""The ``ricker_1m`` configuration's cell on the CPU at a tiny size, the
readers of its two metrics on synthetic records (a value where the program
gives the grid counter and the statistics span, None where a program
without them, or a CPU run, gives nothing), and the Ricker loop's roofline
arithmetic."""

import contextlib
import io

import pytest

from port_bench import registry, run
from port_bench.kernels import ricker_loop
from port_bench.tests import tiny

CELL = "ricker_1m.eager_mem"
ARGS = ["--workload", CELL, "--seed", "2147483711", "--seconds", "0.3"]


class _Traffic:
    sizes = [1000, 1000, 1000]


def _record(fits):
    return {"fits": fits, "traffic": _Traffic(),
            "config": registry.config("ricker_1m")}


def _fit(sets):
    return {"phases": {"sets": len(sets)}, "sets": sets}


def _set(t, sim_ms=None, grid=None, stats=None):
    return {"set": t, "route": "eager", "simulate_ms": sim_ms,
            "sim_steps": 150.0, "sim_grid_steps": grid,
            "sim_stats_ms": stats}


def test_readers_on_a_program_with_the_counter_and_span():
    rec = _record([_fit([_set(0, 40.0, 60.0, 1.0), _set(1, 60.0, 40.0, 3.0),
                         _set(2, 50.0, 50.0, 2.5)])])
    least = sum(ricker_loop.least_ms(150.0, 100.0, g, 1000)
                for g in (60.0, 40.0, 50.0))
    assert registry.metric("ricker_loop_roofline").read(rec) == \
        pytest.approx(100.0 * least / 150.0)
    assert registry.metric("sim_stats_ms").read(rec) == pytest.approx(2.5)


@pytest.mark.parametrize("name", ["ricker_loop_roofline", "sim_stats_ms"])
def test_readers_read_nothing_without_them(name):
    read = registry.metric(name).read
    # a program without the grid counter and the span (the parent's)
    old = _record([_fit([{"set": t, "route": "eager", "simulate_ms": 50.0,
                          "sim_steps": 150.0} for t in range(3)])])
    assert read(old) is None
    assert read(_record([])) is None
    # the CPU: every set counted but none timed
    assert read(_record([_fit([_set(t, None, 50.0) for t in range(3)])])) \
        is None


def test_loop_roofline_terms():
    rows = 1 << 20
    t = ricker_loop.terms_ms(150, 100, 50, rows)
    per_ms = 132 * 1980.0 * 1e3
    assert t["sfu"] == pytest.approx(
        (7 * 150 + 25 * 50 + 50 + 4) * rows / (16 * per_ms))
    assert t["issue"] == pytest.approx(
        (77 * 150 + 125 * 50 + 6 * 50 + 8 * 100) * rows / (128 * per_ms))
    assert t["bytes"] == pytest.approx(44 * rows / 3.35e9)
    # the grid's exps bound the loop where most draws take it, the hash
    # and the map's issue where few do
    assert max(ricker_loop.terms_ms(150, 100, 100, rows).items(),
               key=lambda kv: kv[1])[0] == "sfu"
    assert max(ricker_loop.terms_ms(150, 100, 0, rows).items(),
               key=lambda kv: kv[1])[0] == "issue"
    assert ricker_loop.least_ms(150, 100, 50, rows) == max(t.values())


@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_runs_and_is_correct_on_the_cpu(tmp_path, monkeypatch,
                                                 trace):
    tiny.make(tmp_path, monkeypatch)
    with contextlib.redirect_stderr(io.StringIO()):
        result, code = run.run([*ARGS, "--trace", str(trace)], device="cpu")
    assert code == 0 and result["correct"] is True, result
    assert set(result["checks"]) == set(
        registry.reference("ricker_1m").NUMBERS)
    assert result["checks"]["sim_err"]["value"] == 0.0
    if trace:
        # the CPU times no simulate stage and no statistics
        assert result["metrics"] == {}
    else:
        assert set(result["metrics"]) == {"particles_per_s", "setup_s"}
