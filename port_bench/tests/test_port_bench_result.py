"""A run's result line and its guards, driven on the CPU at a tiny size."""

import contextlib
import gc
import io
import json
import random
import sys
import time
import types

import pytest

from port_bench import registry, run
from port_bench.tests import tiny
from port_bench.traffic import fit_seed

ARGS = ["--seed", "2147483711", "--seconds", "0.5"]


@pytest.fixture
def small(tmp_path, monkeypatch):
    return tiny.make(tmp_path, monkeypatch)


@pytest.mark.parametrize("cell,trace", [
    ("north_star_1m.eager_mem", 0), ("north_star_1m.eager_mem", 1)])
def test_result_line_keys(small, cell, trace):
    result, code = run.run(["--workload", cell, *ARGS, "--trace",
                            str(trace)], device="cpu")
    assert code == 0
    keys = list(result)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert set(keys) <= {"correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"}
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] >= 1
    for name, m in result["metrics"].items():
        assert set(m) == {"value", "unit"} and m["value"] is not None
    wanted = {m["name"] for m in small["per_layer" if trace
                                       else "end_to_end"]
              if cell in m.get("workloads", [cell])}
    assert set(result["metrics"]) <= wanted
    if not trace:
        # the CPU has no memory peak to read; every other one is there
        assert set(result["metrics"]) == wanted - {"peak_mem_gib"}
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    for c in result["checks"].values():
        assert c["value"] <= c["limit"]


def test_main_prints_the_result_last(small, capsys):
    code = run.main(["--workload", "north_star_1m.eager_mem", *ARGS,
                     "--trace", "0"])
    out = capsys.readouterr()
    # this machine has no card: no result, a code other than 0
    assert code != 0 and out.out == ""
    assert "needs 1 CUDA card" in out.err


def test_forbidden_module_stops_the_result(small, monkeypatch):
    monkeypatch.setitem(sys.modules, "abcsmc_tpu",
                        types.ModuleType("abcsmc_tpu"))
    result, code = run.run(["--workload", "north_star_1m.eager_mem",
                            *ARGS, "--trace", "0"], device="cpu")
    assert result is None and code != 0


def test_forbidden_names_compared_whole():
    got = run.forbidden_modules({"abcsmc_tpu.x": 1, "abcsmc_tpu_torch.x": 1,
                                 "abcsmc_tpu_torch": 1, "jaxlib.xla": 1,
                                 "jax_like": 1, "flax": 1, "numpy": 1})
    assert got == ["abcsmc_tpu.x", "flax", "jaxlib.xla"]


def test_result_is_json(small):
    result, _ = run.run(["--workload", "north_star_1m.eager_mem", *ARGS,
                         "--trace", "0"], device="cpu")
    assert json.loads(json.dumps(result)) == result


def test_window_closing_in_the_collection_judges_its_last_fit(small,
                                                              monkeypatch):
    """The clock passes the window's end during the collection after a fit
    that is not among the picks, with fewer fits than ``among``: that fit
    was not the last, the next one is, and it is judged."""
    cell = "north_star_1m.eager_mem"
    check = registry.workload(cell)["check"]
    seed = next(s for s in range(2147483711, 2147483811)
                if 0 not in random.Random(fit_seed(s, -2)).sample(
                    range(check["among"]), check["fits"]))
    real, collect, skew = time.perf_counter, gc.collect, [0.0]

    def late_collect(*args):
        skew[0] += 1000.0
        return collect(*args)

    monkeypatch.setattr(run.time, "perf_counter", lambda: real() + skew[0])
    monkeypatch.setattr(run.gc, "collect", late_collect)
    with contextlib.redirect_stderr(io.StringIO()) as err:
        result, code = run.run(["--workload", cell, "--seed", str(seed),
                                "--seconds", "30", "--trace", "0"],
                               device="cpu")
    assert code == 0 and result["attempted"] == 2, err.getvalue()
    assert result["correct"] is True and "judged 1 fits" in err.getvalue()


def test_limits_must_name_the_references_numbers(small):
    path = registry.HERE / "workloads" / "north_star_1m.eager_mem.json"
    cell = json.loads(path.read_text())
    cell["check"]["limits"]["extra"] = 1.0
    path.write_text(json.dumps(cell))
    with contextlib.redirect_stderr(io.StringIO()) as err:
        result, code = run.run(["--workload", "north_star_1m.eager_mem",
                                *ARGS, "--trace", "0"], device="cpu")
    assert result is None and code == 2
    assert "its reference's numbers are" in err.getvalue()
