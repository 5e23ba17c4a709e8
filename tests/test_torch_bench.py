"""The port's bench programs (``abcsmc_tpu_torch.bench`` / ``bench_extra``)
on the CPU at small sizes, held against the JAX bench programs on the
same numpy inputs.

- ``bench.main`` prints one JSON line with the JAX bench's keys plus
  ``device`` and ``route``; ``vs_baseline`` is null;
- its data are the JAX bench's construction bit for bit (at the test size
  and at the full 1M x 6 x 13);
- on those data, fed JAX's own draws (``test_torch_step.jax_draws``), the
  port's step gives JAX ``ShardedGeneration.step_precomputed``'s
  ``ncomp_used`` and survivor indices, float32 both;
- ``--route replay`` on the CPU, and every entry point asked for CUDA where
  there is none, exit 2;
- ``bench_extra.main`` prints one line per measurement in the JAX order;
- ``pls._fit_arrays`` equals JAX's at float64 within 1e-10;
- the resample's indices equal ``jnp.searchsorted(jnp.cumsum(w), u,
  method="sort")`` on the same sorted queries ``u``. The weights are
  integers in float32, so both cumulative sums are exact and equal (an
  assertion): the comparison is of the search alone.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from abcsmc_tpu.config import parse_config as j_parse
from abcsmc_tpu.models.parameters import ParameterSet as JParameterSet
from abcsmc_tpu.models.simulators import make_gaussian_simulator
from abcsmc_tpu.models.transforms import ParameterTransform as JTransform
from abcsmc_tpu.ops import pls as jpls
from abcsmc_tpu.parallel import ShardedGeneration, particle_mesh
from abcsmc_tpu_torch import bench, bench_extra, graft_entry
from abcsmc_tpu_torch.ops import pls
from abcsmc_tpu_torch.tools import _common, scaling_analysis
from test_torch_step import jax_draws

N, KEEP = 4096, 256
SMALL = ["--device", "cpu", "--n", str(N), "--keep", str(KEEP)]
KEYS = {"metric", "value", "unit", "vs_baseline", "ncomp_used", "device",
        "route"}


def _lines(capsys):
    return [json.loads(x) for x in capsys.readouterr().out.splitlines()
            if x.strip()]


def test_bench_prints_one_line(capsys):
    assert bench.main(SMALL) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1
    row = json.loads(out[0])
    assert set(row) == KEYS
    assert row["vs_baseline"] is None and row["route"] == "eager"
    assert row["unit"] == "s" and row["value"] > 0
    assert row["ncomp_used"] > 1 and row["device"] == "cpu"
    assert f"{N} particles" in row["metric"] and f"keep {KEEP}" in row[
        "metric"] and "1 cpu device(s)" in row["metric"]


def test_bench_on_a_virtual_mesh_names_its_shards(capsys):
    assert bench.main(SMALL + ["--shards", "4"]) == 0
    row = json.loads(capsys.readouterr().out)
    assert row["metric"].endswith("1 cpu device(s), 4 shards")
    assert row["ncomp_used"] > 1


def _jax_bench_data(n, keep):
    """bench.py:153-166, verbatim in its draws."""
    rng = np.random.default_rng(0)
    params = jnp.asarray(rng.uniform(0, 1, size=(n, 6)), jnp.float32)
    mix = rng.normal(size=(6, 13)).astype(np.float32)
    mets_np = (np.asarray(params) @ mix + 0.3 * rng.normal(size=(n, 13))
               ).astype(np.float32)
    prev_state = (
        jnp.asarray(rng.uniform(0.3, 0.7, size=(keep, 6)), jnp.float32),
        jnp.full((keep,), 1.0 / keep, jnp.float32),
        jnp.full((6,), 0.02, jnp.float32),
    )
    return np.asarray(params), mets_np, tuple(map(np.asarray, prev_state))


@pytest.mark.parametrize("n,keep", [(N, KEEP), (bench.N, bench.KEEP)])
def test_bench_data_is_the_jax_construction(n, keep):
    params, mets, state = bench.make_data(n, keep)
    jparams, jmets, jstate = _jax_bench_data(n, keep)
    for a, b in [(params, jparams), (mets, jmets), *zip(state, jstate)]:
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_bench_step_matches_jax_step():
    params, mets, state = bench.make_data(N, KEEP)
    jcfg = j_parse({
        "smc_iterations": 2, "num_samples": N, "predictive_prior_size": KEEP,
        "parameters": [{"name": f"p{i}", "dist_type": "UNIFORM",
                        "num_type": "FLOAT", "par1": 0.0, "par2": 1.0}
                       for i in range(6)],
        "metrics": [{"name": f"m{i}", "num_type": "FLOAT", "value": 0.0}
                    for i in range(13)],
    })
    jgen = ShardedGeneration(
        JParameterSet.from_specs(jcfg.parameters),
        JTransform(jcfg.parameters), make_gaussian_simulator(),
        np.zeros(13), mesh=particle_mesh(jax.devices()[:1]),
        dtype=jnp.float32)
    key = jax.random.PRNGKey(3)
    jres = jgen.step_precomputed(key, jnp.asarray(params), jnp.asarray(mets),
                                 KEEP, N, tuple(map(jnp.asarray, state)))
    gen = _common.generation(
        _common.unit_box_config(N, KEEP, [0.0] * 13, npar=6), None,
        [torch.device("cpu")])
    res = gen.step_precomputed(
        torch.from_numpy(params), torch.from_numpy(mets), KEEP, N,
        jax_draws(jgen, key, N), tuple(map(torch.from_numpy, state)))
    assert int(res.ncomp_used) == int(jres.ncomp_used) > 1
    np.testing.assert_array_equal(res.survivor_idx.numpy(),
                                  np.asarray(jres.survivor_idx))
    np.testing.assert_allclose(res.weights.numpy(), np.asarray(jres.weights),
                               rtol=1e-3)


@pytest.mark.parametrize("main,argv", [
    (bench.main, ["--device", "cpu", "--route", "replay"]),
    (bench.main, []),
    (bench.main, ["--route", "replay"]),
    (bench_extra.main, []),
    (graft_entry.main, []),
    (scaling_analysis.main, []),
], ids=["bench-replay-cpu", "bench", "bench-replay", "bench_extra",
        "graft_entry", "scaling_analysis"])
def test_refusals_exit_2(main, argv, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(argv + ["--n", "64", "--keep", "8"]
                if main is bench.main else argv) == 2
    captured = capsys.readouterr()
    assert captured.out == "" and "cpu" in captured.err


def test_bench_extra_one_line_per_measurement(capsys):
    argv = ["--device", "cpu", "--kernel-k", "300,500", "--gen-n",
            "2000,3000"]
    assert bench_extra.main(argv) == 0
    rows = _lines(capsys)
    names = [r["metric"] for r in rows]
    assert names == [
        "PLS fit 1k x 100 mets, 10 comps",
        "mixture-weight kernel (plain PyTorch version, cpu) 300x300",
        "mixture-weight kernel (plain PyTorch version, cpu) 500x500",
        "inverse-CDF resample 1M from 50k",
        "SMC generation 2000 particles (sim excluded), 1 cpu device(s)",
        "SMC generation 2000 particles (sim included), 1 cpu device(s)",
        "SMC generation 3000 particles (sim excluded), 1 cpu device(s)",
        "SMC generation 3000 particles (sim included), 1 cpu device(s)",
    ]
    for r in rows:
        assert r["unit"] == "ms" and r["value"] > 0
    for r in rows[4:]:
        assert r["particles_per_sec"] > 0


def test_fit_arrays_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(1000, 100))
    y = x[:, :10] @ rng.normal(size=(10, 10)) + rng.normal(size=(1000, 10))
    got = pls._fit_arrays(torch.from_numpy(x), torch.from_numpy(y), 10)
    want = jpls._fit_arrays(jnp.asarray(x), jnp.asarray(y), 10)
    for a, b in zip(got, want):
        assert a.dtype == torch.float64
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-10)


def test_resample_indices_match_jnp_searchsorted():
    rng = np.random.default_rng(0)
    w = torch.as_tensor(rng.integers(1, 4, 50_000), dtype=torch.float32)
    g = torch.Generator().manual_seed(0)
    idx, u = bench_extra.resample(w, 1_000_000, g)
    jc = jnp.cumsum(jnp.asarray(w.numpy()))
    np.testing.assert_array_equal(np.asarray(jc),
                                  torch.cumsum(w, 0).numpy())
    want = jnp.searchsorted(jc, jnp.asarray(u.numpy()), method="sort")
    assert idx.dtype == torch.int64
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want))
    assert bool((u[1:] >= u[:-1]).all()) and float(u[-1]) < float(jc[-1])
