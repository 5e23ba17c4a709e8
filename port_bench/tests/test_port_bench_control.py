"""The control and the faults: each comes out as not correct. At a tiny
size on the CPU here; the readings at the cells' own sizes come from
``port_bench/control.py`` on the card (PERF.md). The program's own
lower-precision path acts only on a CUDA tensor, so its test needs the
card."""

import contextlib
import io
import json
from pathlib import Path

import pytest
import torch

from port_bench import control, faults, registry, run
from port_bench.tests import tiny

CELLS = ["north_star_1m.eager_mem"]
#: every mode's readings of tiny's copy of the cell at seeds 1-3, as the
#: frozen judge gives them on the CPU: any change is a change of yardstick
PINNED = json.loads(Path(__file__).with_name("pinned_readings.json")
                    .read_text())


def _beyond(workload, readings):
    limits = registry.workload(workload)["check"]["limits"]
    return [k for k, v in readings.items() if v > limits[k]]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("rounding", ["reference_tf32", "reference_bf16"])
def test_reference_at_lower_precision_fails(tmp_path, monkeypatch, cell,
                                            rounding):
    tiny.make(tmp_path, monkeypatch, n=2048)
    got = control.readings(cell, rounding, 11, device="cpu")
    assert _beyond(cell, got), got


@pytest.mark.parametrize("cell", CELLS)
def test_reference_ranking_at_one_component_fails(tmp_path, monkeypatch,
                                                  cell):
    tiny.make(tmp_path, monkeypatch, n=2048)
    got = control.readings(cell, "reference_ncomp_low", 11, device="cpu")
    assert "vdv_miss" in _beyond(cell, got), got


@pytest.mark.parametrize("cell", CELLS)
def test_reference_in_the_programs_place_passes(tmp_path, monkeypatch, cell):
    tiny.make(tmp_path, monkeypatch, n=2048)
    got = control.readings(cell, "reference_float64", 11, device="cpu")
    assert not _beyond(cell, got) and got["vdv_miss"] == 0.0, got


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", faults.FAULTS)
def test_planted_fault_fails(tmp_path, monkeypatch, cell, fault):
    tiny.make(tmp_path, monkeypatch)
    with faults.planted(fault), contextlib.redirect_stderr(io.StringIO()):
        result, code = run.run(["--workload", cell, "--seed", "2147483721",
                                "--seconds", "0.3", "--trace", "0"],
                               device="cpu")
    assert code == 0 and result["correct"] is False, result["checks"]


@pytest.mark.gpu
def test_programs_bf16_weights_fail_on_the_card(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the BF16 weight scheme runs only "
                    "in the card's kernel")
    tiny.make(tmp_path, monkeypatch, n=8192)
    got = control.readings(CELLS[0], "weights_bf16", 13)
    assert "weight_err" in _beyond(CELLS[0], got), got


@pytest.mark.parametrize("mode,seed", [(m, s) for m in PINNED
                                       for s in PINNED[m]])
def test_readings_equal_the_pinned_ones(tmp_path, monkeypatch, mode, seed):
    tiny.make(tmp_path, monkeypatch)
    with contextlib.redirect_stderr(io.StringIO()):
        got = control.readings(CELLS[0], mode, int(seed), device="cpu")
    assert got == PINNED[mode][seed]
