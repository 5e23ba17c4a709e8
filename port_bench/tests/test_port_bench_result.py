"""A run's result line and its guards, driven on the CPU at a tiny size."""

import json
import sys
import types

import pytest

from port_bench import run
from port_bench.tests import tiny

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
