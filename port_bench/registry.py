"""Finds everything of the benchmark by name: ``BENCHMARK.json`` at the root
of the checkout, and beside this file one file per configuration
(``configs/<config>.json``) and its plain reference
(``references/<config>.py``), per cell (``workloads/<cell>.json``), per
metric (``metrics/<metric>.py``) and per kernel roofline
(``kernels/<kernel>.py``). A new cell, configuration, metric or kernel is a
new file and a new entry in ``BENCHMARK.json``; nothing here names one."""

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


def reference(name: str):
    """The plain reference of one configuration, the one module that knows
    its kind of fit (simulator, proposal, ranking, weights). It has:

    - ``observed(config, smc_cfg, seed) -> ndarray``: the observed row of a
      run; where the configuration simulates it, it also writes each
      metric's ``value`` into ``smc_cfg`` (the fits' configuration);
    - ``spec(config, smc_cfg, sizes, keeps, obs)``: what its judge is given
      of every fit of a run; it refuses a configuration it cannot judge;
    - ``NUMBERS``: the names of its checks, which a cell's
      ``check.limits`` names exactly;
    - ``judge(sets, spec, device, seed, check) -> dict``: the worst of each
      of ``NUMBERS`` over one fit's sets, ``check`` being the cell's
      ``check``; a set is a dict of its rows as the run store gives them
      back (``params``, ``seeds``, ``metrics``, ``survivors``) and of its
      posterior state (``weights``, ``dv``, ``ncomp``, and whatever
      ``state`` adds);
    - ``control_fit(spec, seed, device, rounding, fault)``: the reference
      in the program's place, a fit's sets as ``judge`` takes them, at
      ``rounding`` ("tf32", "bf16" or None) or with ``fault`` planted;
    - optionally ``state(abc) -> list[dict]``: more of a finished fit's
      posterior state, one dict a set, for its judge.

    The shared plain code such modules import is in ``reference/``."""
    return _module("references", name)


def cell_metrics(bench: dict, cell: str, kind: str) -> list[dict]:
    """The entries of ``bench[kind]`` ("end_to_end" or "per_layer") that
    this cell reports: those without a ``workloads`` list, and those whose
    list names it."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]
