"""The port's multi-shard scaling structure, read by counting
(``abcsmc_tpu_torch.tools.scaling_analysis``), held to the contract of
tests/test_scaling_structure.py at the same N = 4096, keep = 256:

- the reduction payload (psum, pmin) is identical at 1, 2, 4 and 8 shards
  and at 4 N; the same collective calls run at every mesh size;
- the gather payload does not grow with N while every shard holds at
  least keep rows, and grows 7-8x from 1 to 8 shards (one shard's calls
  move no data, and count what its gathers return);
- the FLOPs over all shards at 8 shards are within 2 % of one shard's (no
  O(N) pass is replicated), the weight stage counted from its shape;
- a forced two-stage top-K gathers less and reduces more;
- the counters are host integers: counting dispatches no tensor op;
- beside the JAX tool (``tools/scaling_analysis.py``, run on the virtual
  CPU mesh as tests/test_scaling_structure.py runs it) at (1, N), (8, N)
  and (8, 4 N): the reduction payload is the JAX all-reduce payload plus
  one [13] float32 vector, the gather payload the JAX all-gather payload
  plus the survivor indices' extra width (none under x64), and the FLOPs
  within a stated band of JAX's.
"""

import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from abcsmc_tpu_torch.parallel.mesh import particle_mesh
from abcsmc_tpu_torch.tools import scaling_analysis

N, KEEP = 4096, 256
NMET = 13
JAX_CASES = [(1, N), (8, N), (8, 4 * N)]

#: the JAX tool observes its 13 metrics at the constant 0, so in its
#: compiled program the shifted metric sum, sum(x - 0), is the raw sum
#: sum(x), and XLA reduces that [13] float32 vector once where the port,
#: which runs the ops it is given, reduces it twice
#: (test_jax_all_reduce_equals_the_port_with_a_nonzero_observation)
OBS_ZERO_CSE_BYTES = NMET * 4



def index_width_bytes() -> int:
    """How much wider a gathered survivor index is in the port than in the
    JAX program: torch.topk's indices are int64, the JAX step's are int32,
    or int64 with jax_enable_x64 (as tests/conftest.py sets it)."""
    import jax

    return 8 - (8 if jax.config.jax_enable_x64 else 4)


@functools.lru_cache(maxsize=None)
def analyze(shards, n=N, topk="auto"):
    return scaling_analysis.analyze(shards, n, KEEP, topk, device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_tool():
    """The JAX package's tools/scaling_analysis.py, loaded from its file
    (under its own module name: the port's tool shares its short name)."""
    path = Path(__file__).resolve().parents[1] / "tools" / \
        "scaling_analysis.py"
    spec = importlib.util.spec_from_file_location("jax_scaling_analysis",
                                                  path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


@functools.lru_cache(maxsize=None)
def jax_analyze(ndev, n=N):
    return _jax_tool().analyze(ndev, n, KEEP)


def _bytes(row, kinds):
    return sum(row["collectives"].get(k, {"bytes": 0})["bytes"]
               for k in kinds)


def test_reduction_payload_identical_across_shards_and_n():
    rows = [analyze(k) for k in (1, 2, 4, 8)] + [analyze(8, 4 * N)]
    for r in rows:
        assert set(r["collectives"]) <= {"psum", "pmin", "all_gather"}
        assert not r["topk_two_stage"]
    assert len({_bytes(r, ("psum", "pmin")) for r in rows}) == 1
    assert len({r["collective_count"] for r in rows}) == 1
    assert _bytes(rows[0], ("psum",)) > 0


def test_gather_payload_fixed_in_n_and_grows_with_shards():
    r1, r8, r8_big = analyze(1), analyze(8), analyze(8, 4 * N)
    assert _bytes(r8, ("all_gather",)) == _bytes(r8_big, ("all_gather",))
    ratio = _bytes(r8, ("all_gather",)) / _bytes(r1, ("all_gather",))
    assert 7.0 < ratio <= 8.0, ratio
    assert not r1["moves_data"] and r8["moves_data"]


def test_flops_total_not_replicated():
    f1, f8 = analyze(1)["flops_total"], analyze(8)["flops_total"]
    assert abs(f8 - f1) / f1 < 0.02, (f1, f8)
    assert analyze(8)["flops_per_shard"] == pytest.approx(f8 / 8)
    # the weight stage from its shape: keep x keep x (p + 2) multiply-adds
    for k in (1, 8):
        assert analyze(k)["weight_stage_flops"] == 2 * KEEP * KEEP * 8


def test_forced_topk_strategy_changes_the_collectives():
    single, two = analyze(8, topk="single"), analyze(8, topk="two")
    assert not single["topk_two_stage"] and two["topk_two_stage"]
    assert _bytes(two, ("all_gather",)) < _bytes(single, ("all_gather",))
    assert (two["collectives"]["psum"]["count"]
            > single["collectives"]["psum"]["count"])


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("shards", [1, 4])
def test_counters_dispatch_no_tensor_op(shards):
    mesh = particle_mesh(["cpu"] * shards)
    parts = [torch.ones(3, 5) for _ in range(shards)]
    with _Ops() as seen:
        mesh._count("psum", parts[0])
        mesh._count("all_gather", parts[0], shards)
    assert seen.ops == []
    mesh.reset_collectives()
    with _Ops() as seen:
        mesh.psum(parts)
        mesh.all_gather_cat(parts)
    if shards == 1:
        assert seen.ops == []      # one part: returned as it is
    assert mesh.collectives["psum"] == {"count": 1, "bytes": 60}
    assert mesh.collectives["all_gather"] == {"count": 1,
                                              "bytes": 60 * shards}


@pytest.mark.parametrize("shards,n", JAX_CASES)
def test_payloads_are_the_jax_tools(shards, n):
    port, ref = analyze(shards, n), jax_analyze(shards, n)
    jax_coll = ref["collectives"]
    assert set(jax_coll) == {"all-reduce", "all-gather"}
    assert (_bytes(port, ("psum", "pmin"))
            == jax_coll["all-reduce"]["bytes"] + OBS_ZERO_CSE_BYTES)
    assert (_bytes(port, ("all_gather",))
            == jax_coll["all-gather"]["bytes"]
            + shards * KEEP * index_width_bytes())
    # the same gathers; the port reduces each moment and Gram apart where
    # XLA fuses them into 3 all-reduces
    assert (port["collectives"]["all_gather"]["count"]
            == jax_coll["all-gather"]["count"])
    assert jax_coll["all-reduce"]["count"] == 3
    assert port["collectives"]["psum"]["count"] == 16


def test_jax_all_reduce_equals_the_port_with_a_nonzero_observation(
        monkeypatch):
    """The cause of OBS_ZERO_CSE_BYTES: observed at 0.5, the JAX program's
    shifted and raw metric sums differ and its all-reduce payload is the
    port's to the byte (the port's does not depend on the observation)."""
    from abcsmc_tpu.parallel import generation as jax_generation

    init = jax_generation.ShardedGeneration.__init__

    def observed_at_half(self, par_set, transform, sim, obs, *a, **kw):
        init(self, par_set, transform, sim, np.full(len(obs), 0.5), *a,
             **kw)

    monkeypatch.setattr(jax_generation.ShardedGeneration, "__init__",
                        observed_at_half)
    ref = _jax_tool().analyze(8, N, KEEP)
    assert (ref["collectives"]["all-reduce"]["bytes"]
            == _bytes(analyze(8), ("psum", "pmin")))


def test_flops_within_a_band_of_the_jax_tools():
    """FlopCounterMode counts matmul-class products only (XLA's cost
    analysis counts elementwise work too), and the port's per-shard figure
    is its total over the shards, so the small math the JAX program
    repeats on every device counts once: the port's per-shard FLOPs are
    80-100 % of JAX's per-device FLOPs in every case, and its 1 -> 8 shard
    scaling is the ideal 8x where JAX's lies a little under it."""
    for shards, n in JAX_CASES:
        share = (analyze(shards, n)["flops_per_shard"]
                 / jax_analyze(shards, n)["flops_per_device"])
        assert 0.8 < share <= 1.0, (shards, n, share)
    port = analyze(1)["flops_per_shard"] / analyze(8)["flops_per_shard"]
    ref = (jax_analyze(1)["flops_per_device"]
           / jax_analyze(8)["flops_per_device"])
    assert ref <= port <= 8.0 and port / ref < 1.15, (port, ref)
