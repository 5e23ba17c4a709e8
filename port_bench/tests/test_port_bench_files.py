"""The benchmark's files: BENCHMARK.json within its contract, every file it
names present and parseable, and a new cell and metric found by name from
new files alone."""

import ast
import json
import re

import pytest

from port_bench import registry, run
from port_bench.reference import judge
from port_bench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture
def bench():
    return registry.benchmark()


def test_top_level_keys_and_command(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "port_bench/run.py"]
    assert bench["paths"] == ["port_bench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) <= 64 * 1024


def test_names_units_and_lines(bench):
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in bench[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for e in bench["configs"] + bench["workloads"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]


def test_every_file_parses_and_agrees(bench):
    cells = {w["name"] for w in bench["workloads"]}
    for c in bench["configs"]:
        cfg = registry.config(c["name"])
        assert c["file"] == f"port_bench/configs/{c['name']}.json"
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in bench["workloads"])
    for w in bench["workloads"]:
        cell = registry.workload(w["name"])
        assert (cell["config"], cell["traffic_name"], cell["chips"],
                cell["why"]) == (w["config"], w["traffic"], w["chips"],
                                 w["why"])
        assert w["chips"] == 1
        assert set(cell["check"]["limits"]) == set(judge.NUMBERS)
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        mod = registry.metric(m["name"])
        assert (mod.UNIT, mod.BETTER, mod.SOURCE) == (
            m["unit"], m["better"], m["source"])
        assert set(m.get("workloads", cells)) <= cells
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])
    for m in bench["per_layer"]:
        mod = registry.metric(m["name"])
        assert (mod.UNIT, mod.BETTER, mod.SOURCE, mod.LAYER, mod.MOVES) == (
            m["unit"], m["better"], m["source"], m["layer"], m["moves"])
        assert set(m["workloads"]) <= cells
        # every cell it names reports the end-to-end metric it moves
        moved = next(e for e in bench["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in cells:
        assert registry.cell_metrics(bench, w, "per_layer")
        assert len(registry.cell_metrics(bench, w, "end_to_end")) >= 2


def test_new_cell_and_metric_need_only_new_files(tmp_path, monkeypatch):
    bench = tiny.make(tmp_path, monkeypatch, n=512, sets=2)
    here = tmp_path / "port_bench"
    (here / "metrics" / "fits_in_window.py").write_text(
        'UNIT, BETTER, SOURCE = "fits", "higher", "host_clock"\n'
        "def read(record):\n    return len(record['fits'])\n")
    # a cell of other traffic (a SQLite store a fit, read back by the
    # reference's own reader) and an end-to-end metric of its own
    cell = json.loads((here / "workloads" /
                       "north_star_1m.eager_mem.json").read_text())
    cell["traffic"] = {"store": "sqlite", "device_dispatch": "sequential"}
    (here / "workloads" / "north_star_1m.extra.json").write_text(
        json.dumps(cell))
    bench["workloads"].append({"name": "north_star_1m.extra",
                               "config": "north_star_1m",
                               "traffic": "extra", "chips": 1, "why": "x"})
    bench["end_to_end"].append({"name": "fits_in_window", "unit": "fits",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["north_star_1m.extra"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    result, code = run.run(["--workload", "north_star_1m.extra", "--seed",
                            "3", "--seconds", "0.5", "--trace", "0"],
                           device="cpu")
    assert code == 0 and result["correct"]
    assert result["metrics"]["fits_in_window"]["value"] == result["attempted"]


def test_harness_imports_nothing_forbidden():
    banned = set(run.FORBIDDEN) | {"bench", "bench_extra", "chip_smoke",
                                   "tools"}
    for path in registry.HERE.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                top = mod.split(".")[0]
                assert top not in banned, (path, mod)
                assert not mod.startswith("abcsmc_tpu_torch.tools"), (path,
                                                                      mod)
