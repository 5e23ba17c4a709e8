"""Finds everything of the benchmark by name: ``BENCHMARK.json`` at the root
of the checkout, and beside this file one file per configuration
(``configs/<config>.json``), per cell (``workloads/<cell>.json``), per metric
(``metrics/<metric>.py``) and per kernel roofline (``kernels/<kernel>.py``).
A new cell, configuration, metric or kernel is a new file and a new entry in
``BENCHMARK.json``; nothing here names one."""

from __future__ import annotations

import importlib.util
import json
from functools import lru_cache
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _json(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"port_bench: no {kind[:-1]} file {path}")
    return json.loads(path.read_text())


def config(name: str) -> dict:
    return _json("configs", name)


def workload(name: str) -> dict:
    return _json("workloads", name)


@lru_cache(maxsize=None)
def _module(kind: str, name: str):
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"port_bench: no {kind[:-1]} file {path}")
    spec = importlib.util.spec_from_file_location(
        f"port_bench.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric(name: str):
    """The reader of one metric: ``read(record)`` returns its value, or None
    where the run gave it nothing to read."""
    return _module("metrics", name)


def kernel(name: str):
    """One kernel's roofline arithmetic and the names it has in a trace."""
    return _module("kernels", name)


def cell_metrics(bench: dict, cell: str, kind: str) -> list[dict]:
    """The entries of ``bench[kind]`` ("end_to_end" or "per_layer") that
    this cell reports: those without a ``workloads`` list, and those whose
    list names it."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]
