"""The ``sir_1m`` configuration's cell on the CPU at a tiny size, the
readers of its four metrics on synthetic records (a value where the
program gives the counter or span, None where a program without them, or
a CPU run, gives nothing), and the SIR loop's roofline arithmetic."""

import contextlib
import io

import pytest

from port_bench import registry, run
from port_bench.kernels import sir_loop
from port_bench.tests import tiny

CELL = "sir_1m.fused_mvn"
ARGS = ["--workload", CELL, "--seed", "2147483711", "--seconds", "0.3"]


class _Traffic:
    sizes = [1000, 1000, 1000]


def _record(fits):
    return {"fits": fits, "traffic": _Traffic()}


def _fit(sets, **phases):
    return {"phases": {"sets": len(sets), **phases}, "sets": sets}


def _eager(t, sim_ms=None, steps=None, mvn=None):
    return {"set": t, "route": "eager", "simulate_ms": sim_ms,
            "sim_steps": steps, "mvn_ms": mvn}


def _replay(t, steps=None):
    return {"set": t, "route": "replay", "simulate_ms": None,
            "sim_steps": steps, "mvn_ms": None}


def _new_program():
    """Two fits of the program with the counter and spans: sets 0-1 eager,
    set 2 replayed."""
    sets = [_eager(0, 4.0, 160.0, 2.0), _eager(1, 6.0, 160.0, 4.0),
            _replay(2, 160.0)]
    return _record([
        _fit(sets, capture_s=0.3, replay_s=0.02, graph_captures=1,
             graph_replays=1),
        _fit(sets, capture_s=0.5, replay_s=0.04, graph_captures=1,
             graph_replays=1)])


def _old_program():
    """The same fits from a program without them: no ``sim_steps``,
    ``mvn_ms`` or ``replay_s`` (its ``capture_s`` is there)."""
    sets = [{"set": t, "route": r, "simulate_ms": ms} for t, r, ms in
            ((0, "eager", 4.0), (1, "eager", 6.0), (2, "replay", None))]
    return _record([_fit(sets, capture_s=0.3, graph_captures=1,
                         graph_replays=1)])


def test_readers_on_a_program_with_the_counter_and_spans():
    rec = _new_program()
    least = sir_loop.least_ms(160.0, 1000)
    assert registry.metric("sim_loop_roofline").read(rec) == pytest.approx(
        100.0 * 4 * least / 20.0)
    assert registry.metric("mvn_ms").read(rec) == pytest.approx(3.0)
    assert registry.metric("replay_host_ms_per_set").read(rec) == \
        pytest.approx(1e3 * 0.06 / 2)
    assert registry.metric("capture_ms_per_fit").read(rec) == \
        pytest.approx(1e3 * 0.8 / 2)


@pytest.mark.parametrize("name", ["sim_loop_roofline", "mvn_ms",
                                  "replay_host_ms_per_set",
                                  "capture_ms_per_fit"])
def test_readers_read_nothing_without_them(name):
    read = registry.metric(name).read
    assert read(_old_program()) is None
    assert read(_record([])) is None
    # the CPU: every set eager and untimed, nothing captured or replayed
    cpu = _record([_fit([_eager(t, None, 160.0) for t in range(3)],
                        capture_s=0.0, replay_s=0.0, graph_captures=0,
                        graph_replays=0)])
    assert read(cpu) is None


def test_loop_roofline_terms():
    t = sir_loop.terms_ms(160, 1 << 20)
    # the issue term bounds the loop at the cell's size
    assert max(t, key=t.get) == "issue"
    assert sir_loop.least_ms(160, 1 << 20) == pytest.approx(0.4413, abs=1e-4)
    assert t["bytes"] == pytest.approx(40 * (1 << 20) / 3.35e9)


@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_runs_and_is_correct_on_the_cpu(tmp_path, monkeypatch,
                                                 trace):
    tiny.make(tmp_path, monkeypatch)
    with contextlib.redirect_stderr(io.StringIO()):
        result, code = run.run([*ARGS, "--trace", str(trace)], device="cpu")
    assert code == 0 and result["correct"] is True, result
    assert set(result["checks"]) == set(registry.reference("sir_1m").NUMBERS)
    assert result["checks"]["sim_err"]["value"] == 0.0
    if not trace:
        assert set(result["metrics"]) == {"particles_per_s", "setup_s"}


def test_a_program_without_the_factor_stops_the_run(tmp_path, monkeypatch):
    """The parent program reports no proposal factor: the reference cannot
    judge its fits, and the run stops with a message, not a result."""
    tiny.make(tmp_path, monkeypatch)
    from abcsmc_tpu_torch import engine

    real = engine.AbcSmc.run_device

    def without_factor(self, *args, **kwargs):
        out = real(self, *args, **kwargs)
        for e in self.timings:
            e.pop("mvn_factor", None)
        return out

    monkeypatch.setattr(engine.AbcSmc, "run_device", without_factor)
    with contextlib.redirect_stderr(io.StringIO()), \
            pytest.raises(SystemExit, match="no mvn_factor"):
        run.run([*ARGS, "--trace", "0"], device="cpu")
