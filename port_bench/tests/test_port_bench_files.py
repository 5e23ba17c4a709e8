"""The benchmark's files: BENCHMARK.json within its contract, every file it
names present and parseable, and a new cell and metric found by name from
new files alone."""

import ast
import json
import re

import pytest

from port_bench import registry, run
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
        assert set(cell["check"]["limits"]) == set(
            registry.reference(w["config"]).NUMBERS)
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


#: the plain reference of a configuration of another kind of fit (the
#: same simulator under MULTIVARIATE proposals), written as a new file: its
#: own checks, a judge that reads a piece of posterior state of its own
#: choosing, and a record of its calls
OTHER_REFERENCE = '''
import numpy as np

from port_bench.reference import smc

NUMBERS = ("sim_err", "kept_err")
CALLS = []


def _mix(smc_cfg):
    return smc.mix_matrix(len(smc_cfg["parameters"]), len(smc_cfg["metrics"]))


def observed(config, smc_cfg, seed):
    truth = np.full((1, len(smc_cfg["parameters"])), 0.5)
    obs = smc.simulate(truth, np.array([7], np.uint64), _mix(smc_cfg),
                       0.1)[0].numpy()
    for m, v in zip(smc_cfg["metrics"], obs):
        m["value"] = float(v)
    return obs


def spec(config, smc_cfg, sizes, keeps, obs):
    return {"keeps": list(keeps), "mix": _mix(smc_cfg)}


def state(abc):
    return [{"kept": np.sort(np.asarray(s))} for s in abc._predictive_prior]


def judge(sets, spec, device, seed, check):
    CALLS.append([sorted(s) for s in sets])
    sim = kept = 0.0
    for s, keep in zip(sets, spec["keeps"]):
        ref = smc.simulate(s["params"], s["seeds"], spec["mix"], 0.1).numpy()
        sim = max(sim, float((abs(s["metrics"] - ref) / (1 + abs(ref))).max()))
        kept = max(kept, float(len(s["survivors"]) != keep or not
                               np.array_equal(np.sort(s["survivors"]),
                                              s["kept"])))
    return {"sim_err": sim, "kept_err": kept}
'''


def _new_cell(tmp_path, bench):
    """A cell of other traffic (a SQLite store a fit, read back by the
    reference's own reader) on the copy's configuration."""
    here = tmp_path / "port_bench"
    cell = json.loads((here / "workloads" /
                       "north_star_1m.eager_mem.json").read_text())
    cell["traffic"] = {"store": "sqlite", "device_dispatch": "sequential"}
    (here / "workloads" / "north_star_1m.extra.json").write_text(
        json.dumps(cell))
    bench["workloads"].append({"name": "north_star_1m.extra",
                               "config": "north_star_1m",
                               "traffic": "extra", "chips": 1, "why": "x"})
    return "north_star_1m.extra"


def _new_config(tmp_path, bench):
    """A configuration of MULTIVARIATE fits, its plain reference and a
    cell of it."""
    here = tmp_path / "port_bench"
    cfg = json.loads((here / "configs" / "north_star_1m.json").read_text())
    cfg["name"] = "mvn_fit"
    cfg["smc"]["noise"] = "MULTIVARIATE"
    del cfg["observed"]
    (here / "configs" / "mvn_fit.json").write_text(json.dumps(cfg))
    (here / "references" / "mvn_fit.py").write_text(OTHER_REFERENCE)
    cell = {"config": "mvn_fit", "traffic_name": "mem", "chips": 1,
            "why": "x", "traffic": {"store": "memory"},
            "check": {"fits": 1, "among": 2,
                      "limits": {"sim_err": 2e-5, "kept_err": 0.0}}}
    (here / "workloads" / "mvn_fit.mem.json").write_text(json.dumps(cell))
    bench["configs"].append({**next(c for c in bench["configs"]
                                    if c["name"] == "north_star_1m"),
                             "name": "mvn_fit",
                             "file": "port_bench/configs/mvn_fit.json"})
    bench["workloads"].append({"name": "mvn_fit.mem", "config": "mvn_fit",
                               "traffic": "mem", "chips": 1, "why": "x"})
    return "mvn_fit.mem"


@pytest.mark.parametrize("new", [_new_cell, _new_config],
                         ids=["cell", "config"])
def test_new_cell_and_metric_need_only_new_files(tmp_path, monkeypatch, new):
    bench = tiny.make(tmp_path, monkeypatch, n=512, sets=2)
    here = tmp_path / "port_bench"
    before = {p: p.read_bytes() for p in tmp_path.rglob("*") if p.is_file()}
    (here / "metrics" / "fits_in_window.py").write_text(
        'UNIT, BETTER, SOURCE = "fits", "higher", "host_clock"\n'
        "def read(record):\n    return len(record['fits'])\n")
    # a new cell, and an end-to-end metric of its own
    name = new(tmp_path, bench)
    bench["end_to_end"].append({"name": "fits_in_window", "unit": "fits",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": [name]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    del before[tmp_path / "BENCHMARK.json"]
    result, code = run.run(["--workload", name, "--seed", "3", "--seconds",
                            "0.5", "--trace", "0"], device="cpu")
    assert code == 0 and result["correct"]
    assert result["metrics"]["fits_in_window"]["value"] == result["attempted"]
    limits = registry.workload(name)["check"]["limits"]
    assert {k: c["limit"] for k, c in result["checks"].items()} == limits
    if new is _new_config:
        # its own judge ran, on sets that carry its own piece of state
        calls = registry.reference("mvn_fit").CALLS
        assert calls and all("kept" in s for s in calls[0])
    assert {p: p.read_bytes() for p in before} == before


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
