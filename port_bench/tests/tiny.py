"""A copy of the benchmark's files at CPU size, for the tests: the cells
of ``BENCHMARK.json`` over configurations cut to a thousand particles and
three sets (a keep of a twentieth), found through :mod:`port_bench.registry` pointed at the
copy."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

from port_bench import registry

N, SETS = 1024, 3


def make(tmp: Path, monkeypatch, n: int = N, sets: int = SETS) -> dict:
    """Write the copy under ``tmp`` and point the registry at it. Returns
    its BENCHMARK.json."""
    here = tmp / "port_bench"
    for sub in ("metrics", "kernels", "references"):
        shutil.copytree(registry.HERE / sub, here / sub)
    bench = copy.deepcopy(registry.benchmark())
    (here / "configs").mkdir(parents=True)
    for c in bench["configs"]:
        cfg = registry.config(c["name"])
        cfg["smc"]["num_samples"] = n
        cfg["smc"]["smc_iterations"] = sets
        # a keep of a twentieth, as a fraction or a size
        if "predictive_prior_size" in cfg["smc"]:
            cfg["smc"]["predictive_prior_size"] = n // 20
        else:
            cfg["smc"]["predictive_prior_fraction"] = 0.05
        (here / "configs" / f"{c['name']}.json").write_text(json.dumps(cfg))
    (here / "workloads").mkdir()
    for w in bench["workloads"]:
        cell = registry.workload(w["name"])
        cell["check"]["ks_rows"] = n
        # the largest KS distance of ~50 columns of n rows: ~1.9 / sqrt(n)
        cell["check"]["limits"]["propose_ks"] = 4.0 / n ** 0.5
        (here / "workloads" / f"{w['name']}.json").write_text(
            json.dumps(cell))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(registry, "HERE", here)
    monkeypatch.setattr(registry, "ROOT", tmp)
    registry._module.cache_clear()
    return bench
