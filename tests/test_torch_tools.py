"""The study harnesses (``abcsmc_tpu_torch.tools``) on the CPU.

Each harness runs its ``main`` with ``--device cpu`` at a tiny size (in
float64 where it takes a dtype): exit 0 means its own checks held, and its
JSON lines carry the keys the chip run reads. Without CUDA and without
``--device cpu`` each exits 2. Parity with the JAX tools on the same numpy
inputs: the truncation study's fractions and spread against the formula
over ``abcsmc_tpu.ops.weights._prep_scaled`` (rtol 1e-6, float64); the
calibration study's ``ks_uniform`` and its u-value / coverage computation
against the JAX tool's own functions (``tools/calibration_study.py``,
loaded by path: its top level imports only numpy), and its configuration
matrix against the JAX tool's ``study_configs()``; the configurations of
``stat_validate`` and ``quickstart_chip`` against the JAX tools' dicts,
copied below as literals (the JAX ``quickstart_chip.py`` parses argv when
imported, so it is never imported). The times of a CPU run are null: no
CPU number stands for a device time.
"""

import importlib
import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from abcsmc_tpu_torch.ops import kernels
from abcsmc_tpu_torch.tools import (
    _common, bench_weight_kernel, calibration_study, quickstart_chip,
    stat_validate, sweep_weight_kernel,
)

REPO = Path(__file__).resolve().parents[1]
F64 = ["--dtype", "float64"]

# tool -> tiny argv (besides --device cpu)
TINY = {
    "bench_weight_kernel": F64 + ["--k", "300", "700", "--truncation-k",
                                  "128", "--n", "1200", "--keep", "60",
                                  "--reps", "1", "--sample-rows", "32"],
    "sweep_weight_kernel": ["--k-accuracy", "300", "--k-sweep", "500",
                            "--reps", "1", "--sample-rows", "32"],
    "bench_scale": F64 + ["--n", "2000", "--keep", "100", "--row-block",
                          "768", "--max-comp", "4", "--sim", "--reps", "1"],
    "mirror_scale": F64 + ["--n", "3000", "--keep", "100"],
    "bench_reference_shape": F64 + ["--n", "600", "--sets", "2"],
    "quickstart_chip": F64 + ["--sets", "3"],
    "million_run": F64 + ["--n", "2000", "--sets", "2"],
    "stat_validate": F64 + ["--fits", "gaussian", "--n", "20", "--keep",
                            "2", "--sets", "5"],
    "calibration_study": F64 + ["--reps", "1", "--n", "128", "--configs",
                                "gauss-tol,ma2"],
    "bench_native": ["--jobs", "30", "--workers", "1", "3"],
    "validate": ["--shapes", "300x200x6,500x300x13", "--n", "4000",
                 "--keep", "200", "--row-block", "1024", "--reps", "1"],
}

# keys of every measurement line of a tool (the first line names the card)
KEYS = {
    "bench_weight_kernel": {"metric", "value", "unit"},
    "sweep_weight_kernel": {"metric", "value", "unit"},
    "bench_scale": {"metric", "value", "unit", "ms", "particles_per_sec",
                    "ncomp_used", "peak_bytes", "row_block"},
    "mirror_scale": {"metric", "n", "keep", "wall_s", "dispatch_s",
                     "mirror_s", "peak_rss_gb", "db_gb", "rows_ok"},
    "bench_reference_shape": {"metric", "value", "unit", "label", "route",
                              "max_abs_posterior_err", "ncomp_used",
                              "set_ms"},
    "quickstart_chip": {"metric", "sets", "programs", "route", "wall_s",
                        "dispatch_s", "mirror_s", "ess", "posterior"},
    "million_run": set(),
    "stat_validate": {"metric", "mu", "sigma", "mu_err", "sigma_err",
                      "checks_hold", "device", "dtype"},
    "calibration_study": set(),
    "bench_native": {"metric", "workers", "jobs", "seconds", "value",
                     "unit"},
    "validate": {"metric", "ms"},
}


def _run(tool, argv, tmp_path):
    out = tmp_path / f"{tool}.jsonl"
    main = importlib.import_module(f"abcsmc_tpu_torch.tools.{tool}").main
    assert main([*argv, "--device", "cpu", "--out", str(out)]) == 0
    return [json.loads(x) for x in out.read_text().splitlines()]


def _bench_weight_kernel(lines):
    kern = [r for r in lines if r.get("metric", "").startswith("mixture")]
    assert {(r["shape"][0], r["mode"]) for r in kern} == {
        (300, "auto"), (300, "online"), (700, "auto"), (700, "online")}
    assert all(r["max_abs_err_f64_sampled"] <= _common.TOL for r in kern)
    assert all(r["library_ms"] is None and "plain_ms" in r for r in kern)
    gen = [r for r in lines if r.get("metric", "").startswith("SMC")]
    assert len(gen) == 4 and all(r["ncomp_used"] > 1 for r in gen)


def _sweep_weight_kernel(lines):
    asked = [r["n_split_asked"] for r in lines if "n_split_asked" in r]
    # every split point for each mode of each dot scheme
    assert asked == sweep_weight_kernel.split_points(500) * 2 * 3
    assert [r["precision"] for r in lines if "n_split_asked" in r] == [
        prec for prec in kernels.PRECISIONS
        for _ in range(2 * len(sweep_weight_kernel.split_points(500)))]


def _calibration_study(lines):
    assert [r["config"] for r in lines[1:-1]] == ["gauss-tol", "ma2"]
    for r in lines[1:-1]:
        assert 0 <= r["cov50"] <= r["cov90"] <= 1 and r["reps"] == 1
        assert 0 < r["ks_pooled"] <= 1
    assert set(lines[-1]["configs"]) == {"gauss-tol", "ma2"}


def _million_run(lines):
    assert [r["set"] for r in lines[1:-1]] == [0, 1]
    assert all(r["ncomp_used"] > 1 for r in lines[1:-1])
    assert len(lines[-1]["posterior"]) == 6


def _validate(lines):
    kern, step, chunked = lines[1:3], lines[3], lines[4]
    assert [r["shape"] for r in kern] == [[300, 200, 6], [500, 300, 13]]
    # on the CPU the wrapper runs the plain version itself
    assert all(r["max_abs_err"] == 0.0 and r["plain_ms"] is None
               and r["bound_ms"] is None for r in kern)
    assert step["ncomp_used"] > 1 and step["weights_finite"]
    assert chunked["ncomp_used"] == chunked["ncomp_resident"]
    assert chunked["survivor_overlap"] > 0.999
    assert chunked["metric"].startswith("chunked row passes (row_block "
                                        "1024, 4 blocks")


# what the chip run reads from each kind of line, checked on the CPU
NUMBERS = {"bench_weight_kernel": _bench_weight_kernel,
           "sweep_weight_kernel": _sweep_weight_kernel,
           "calibration_study": _calibration_study,
           "million_run": _million_run,
           "validate": _validate}


@pytest.mark.parametrize("tool", sorted(TINY))
def test_harness_runs_on_the_cpu(tool, tmp_path, capsys):
    lines = _run(tool, TINY[tool], tmp_path)
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert printed == lines                     # --out copies stdout
    assert lines[0]["tool"] == tool and lines[0]["card"] == "cpu"
    assert len(lines) > 1
    for row in lines[1:]:
        assert KEYS[tool] <= set(row), (tool, row)
        if row.get("unit") == "ms" or "ms" in row:
            # a CPU run gives no device time
            assert row.get("ms") is None and (
                row.get("unit") != "ms" or row["value"] is None), row
    NUMBERS.get(tool, lambda lines: None)(lines)


@pytest.mark.parametrize("tool", sorted(TINY))
def test_harness_without_cuda_exits_2(tool, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = importlib.import_module(f"abcsmc_tpu_torch.tools.{tool}").main
    assert main(TINY[tool]) == 2
    cap = capsys.readouterr()
    assert cap.out == "" and "needs a CUDA device" in cap.err


def test_stat_validate_gaussian_holds_at_its_smallest_size(tmp_path):
    """The JAX tool's Gaussian bounds (mu, sigma within 0.25 of (2, 1.5))
    on the CPU in float64 at the smallest size of the ladder n = 10, 20,
    30, ... (keep n / 10, the JAX tool's ratio; its 5 sets; its fit seed
    11) at which they hold: n = 20, keep 2 (n = 10, keep 1 reads mu 3.29,
    sigma 2.31)."""
    lines = _run("stat_validate", TINY["stat_validate"], tmp_path)
    row = lines[1]
    assert row["checks_hold"] and row["dtype"] == "float64"
    assert row["mu_err"] < 0.25 and row["sigma_err"] < 0.25


def test_stat_validate_raises_when_its_bound_fails(tmp_path):
    with pytest.raises(RuntimeError, match="Gaussian posterior"):
        _run("stat_validate", F64 + ["--fits", "gaussian", "--n", "10",
                                     "--keep", "1", "--sets", "5"],
             tmp_path)


# ------------------------------------------------------------- parity


def test_truncation_stats_match_the_jax_formula():
    """The same numpy state through the port's function and through the
    JAX tool's formula over abcsmc_tpu.ops.weights._prep_scaled
    (tools/bench_weight_kernel.py:90-111), float64."""
    from abcsmc_tpu.ops.weights import _prep_scaled

    rng = np.random.default_rng(3)
    k, p = 300, 6
    prev = rng.uniform(0.3, 0.7, (k, p))
    dv = 2.0 * prev.var(axis=0, ddof=1)
    w = rng.dirichlet(np.full(k, 5.0))
    queries = prev[rng.choice(k, k, p=w)] + np.sqrt(dv) * rng.normal(
        size=(k, p))
    got = bench_weight_kernel.truncation_stats(
        *(torch.as_tensor(x) for x in (prev, dv, w, queries)))
    a, b, _ = _prep_scaled(jnp.asarray(queries), jnp.asarray(prev),
                           jnp.asarray(dv))
    d2 = jnp.sum(a * a, 1)[:, None] + jnp.sum(b * b, 1)[None, :] \
        - 2.0 * a @ b.T
    logits = -0.5 * d2 + jnp.log(jnp.asarray(w))[None, :]
    best = jnp.max(logits, axis=1, keepdims=True)
    for t in (10.0, 30.0):
        want = float(jnp.mean((logits >= best - t).astype(jnp.float64)))
        np.testing.assert_allclose(got["fractions"][t], want, rtol=1e-6)
    spread = float(jnp.mean(best - jnp.min(logits, axis=1, keepdims=True)))
    np.testing.assert_allclose(got["spread"], spread, rtol=1e-6)
    assert got["fractions"][10.0] < 1.0


def test_realistic_state_is_the_jax_tools_law():
    """Dirichlet(5) weights (sum 1, mean 1/k, the Dirichlet variance
    (k - 1) / (k^2 (5k + 1))), queries inside a few kernel sd of [0.3,
    0.7]."""
    st = _common.Study("t", _common.parser("t", dtype=True).parse_args(
        ["--device", "cpu", "--dtype", "float64", "--seed", "5"]))
    k = 4000
    prev, dv, w, q = bench_weight_kernel.realistic_state(k, 6, st)
    assert float(w.sum()) == pytest.approx(1.0, abs=1e-12)
    var = (k - 1) / (k * k * (5 * k + 1))
    assert float(w.var()) == pytest.approx(var, rel=0.1)
    torch.testing.assert_close(dv, 2.0 * prev.var(dim=0))
    assert float(q.min()) > 0.3 - 8 * float(dv.sqrt().max())


def _jax_calibration():
    spec = importlib.util.spec_from_file_location(
        "jax_calibration_study", REPO / "tools" / "calibration_study.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_ks_uniform_matches_the_jax_tool():
    jax_ks = _jax_calibration().ks_uniform
    rng = np.random.default_rng(0)
    for u in (rng.uniform(size=50), rng.beta(2, 2, size=(7, 3)),
              np.array([0.5]), np.linspace(0, 1, 11)):
        assert calibration_study.ks_uniform(u) == jax_ks(u)


class _FakeFit:
    """A posterior from a seeded numpy generator, summarised by the
    engine's quantile rule (``AbcSmc.posterior_summary``)."""

    def __init__(self, spec, seed):
        rng = np.random.default_rng(seed)
        self.names = [p["name"] for p in spec["pars"]]
        lo = np.array([p["par1"] for p in spec["pars"]], float)
        hi = np.array([p["par2"] for p in spec["pars"]], float)
        self.pars = rng.uniform(lo, hi, (64, len(lo)))
        self.w = rng.uniform(0.1, 1.0, 64)

    def posterior(self):
        # copies: the JAX tool normalises the weights it gets in place
        return self.pars.copy(), self.w.copy()

    def posterior_summary(self, quantiles):
        w = self.w / self.w.sum()
        out = {}
        for j, name in enumerate(self.names):
            x = self.pars[:, j]
            order = np.argsort(x)
            cw = np.cumsum(w[order])
            qs = {q: float(x[order][np.searchsorted(cw, q, side="left")
                                    .clip(0, len(x) - 1)])
                  for q in quantiles}
            out[name] = {"mean": float((x * w).sum()), "quantiles": qs}
        return out


class _FakeSim:
    def run_batch(self, params, seeds, serials, **kw):
        return np.asarray(params) * 2.0


def test_u_values_and_coverage_match_the_jax_tool(monkeypatch):
    """run_config of both tools on the same truths (the same numpy
    generator) and the same fits: u-values, 50 % / 90 % coverage and
    mean errors equal."""
    jax_mod = _jax_calibration()
    spec = {"sim": _FakeSim,
            "pars": [{"name": n, "par1": lo, "par2": hi}
                     for n, lo, hi in (("a", 0, 1), ("b", -2, 3),
                                       ("c", 5, 6))],
            "nmet": 3, "overrides": {}}
    monkeypatch.setattr(jax_mod, "one_fit",
                        lambda spec, obs, n, seed: _FakeFit(spec, seed))
    monkeypatch.setattr(calibration_study, "one_fit",
                        lambda spec, obs, n, seed, st: _FakeFit(spec, seed))
    want = jax_mod.run_config("x", spec, 12, 64,
                              np.random.default_rng(20260819))
    st = _common.Study("t", _common.parser("t").parse_args(
        ["--device", "cpu"]))
    got = calibration_study.run_config("x", spec, 12, 64,
                                       np.random.default_rng(20260819), st)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert 0 < got[1].mean() < 1 and 0 < got[2].mean() <= 1


def _factory_calls(module, specs_fn, monkeypatch):
    """{config: (factory name, args, kwargs)} of each spec's ``sim()``,
    with ``module``'s factories replaced by recorders."""
    calls = []
    for name in dir(module):
        if name.startswith("make_") and name.endswith("_simulator"):
            monkeypatch.setattr(
                module, name,
                lambda *a, _n=name, **k: calls.append((_n, a, k)))
    specs = specs_fn()
    out = {}
    for cfg, spec in specs.items():
        spec["sim"]()
        out[cfg] = calls.pop()
    return specs, out


def test_calibration_configs_match_the_jax_tools(monkeypatch):
    """Names, priors, metric counts, overrides and each simulator
    factory's arguments, against the JAX tool's study_configs()."""
    import abcsmc_tpu.models.simulators as jax_sims

    import abcsmc_tpu_torch.models.simulators as torch_sims

    jax_specs, jax_calls = _factory_calls(
        jax_sims, _jax_calibration().study_configs, monkeypatch)
    specs, calls = _factory_calls(
        torch_sims, calibration_study.study_configs, monkeypatch)
    assert list(specs) == list(jax_specs) and len(specs) == 8
    for name, spec in specs.items():
        for key in ("pars", "nmet", "overrides"):
            assert spec[key] == jax_specs[name][key], (name, key)
    assert calls == jax_calls
    assert set(calibration_study.FAMILY) == set(specs)
    assert set(calibration_study.MACHINERY) == set(specs)


# tools/tpu_stat_validate.py:51-64 (N, KEEP, GENS = 100_000, 10_000, 5)
JAX_GAUSSIAN_CFG = {
    "smc_iterations": 5, "num_samples": 100_000,
    "predictive_prior_size": 10_000, "noise": "INDEPENDENT",
    "parameters": [
        {"name": "mu", "dist_type": "UNIFORM", "num_type": "FLOAT",
         "par1": -10, "par2": 10},
        {"name": "sigma", "dist_type": "UNIFORM", "num_type": "FLOAT",
         "par1": 0.1, "par2": 5},
    ],
    "metrics": [
        {"name": "mean", "num_type": "FLOAT", "value": 2.0},
        {"name": "sd", "num_type": "FLOAT", "value": 1.5},
    ],
}
# tools/tpu_stat_validate.py:90-103 (DICE_GENS, DICE_KEEP = 10, 5_000)
JAX_DICE_CFG = {
    "smc_iterations": 10, "num_samples": 100_000,
    "predictive_prior_size": 5_000, "noise": "INDEPENDENT",
    "parameters": [
        {"name": "ndice", "dist_type": "UNIFORM", "num_type": "INT",
         "par1": 1, "par2": 100},
        {"name": "sides", "dist_type": "UNIFORM", "num_type": "INT",
         "par1": 1, "par2": 100},
    ],
    "metrics": [
        {"name": "sum", "num_type": "INT", "value": 44},
        {"name": "sd", "num_type": "FLOAT", "value": 2.39925},
    ],
}
# tools/quickstart_chip.py:46-61
JAX_QUICKSTART_CFG = {
    "smc_iterations": 30,
    "num_samples": [300, 500, 500, 750, 1000],
    "predictive_prior_fraction": 0.5,
    "pls_training_fraction": 0.5,
    "noise": "MULTIVARIATE",
    "parameters": [
        {"name": "ndice", "dist_type": "UNIFORM", "num_type": "INT",
         "par1": 1, "par2": 1000},
        {"name": "sides", "dist_type": "UNIFORM", "num_type": "INT",
         "par1": 1, "par2": 1000},
    ],
    "metrics": [
        {"name": "sum", "num_type": "INT", "value": 44},
        {"name": "sd", "num_type": "FLOAT", "value": 2.39925},
    ],
}


def test_stat_validate_and_quickstart_configs_match_the_jax_tools():
    sv = stat_validate
    assert sv.gaussian_config(sv.N, sv.KEEP, sv.GENS) == JAX_GAUSSIAN_CFG
    assert sv.dice_config(sv.N, sv.DICE_KEEP, sv.DICE_GENS) == JAX_DICE_CFG
    assert quickstart_chip.config() == JAX_QUICKSTART_CFG


def test_split_points_cover_the_plans_range():
    assert sweep_weight_kernel.split_points(200_000) == (
        [None] + [2**i for i in range(12)] + [3125])
    assert sweep_weight_kernel.split_points(64) == [None, 1]


def test_validate_holds_the_jax_tools_shapes_and_data():
    """The JAX tool's kernel shapes, step sizes and row block are the
    defaults, and its data are drawn in its order from default_rng(0)."""
    from abcsmc_tpu_torch.tools import validate

    assert validate.SHAPES == ((10_000, 5_000, 6), (50_000, 50_000, 6),
                               (200_000, 50_000, 13), (1_000_000, 50_000, 6))
    assert (validate.N, validate.KEEP, validate.NPAR, validate.NMET,
            validate.ROW_BLOCK) == (1_000_000, 50_000, 6, 13, 1 << 17)
    assert validate.parse_shape("200000x50000x13") == (200_000, 50_000, 13)


def test_gen_dengue_surrogate_reproduces_the_shipped_config(capsys,
                                                           monkeypatch):
    """Every field of examples/dengue_surrogate.json but the observed
    values, and those within 6 sd (0.3) of the shipped ones. They are
    truth @ mix plus the port's noise: the noise-free part equals
    truth @ JAX's (16, 100) mixing matrix (PRNGKey(7), as JAX's
    make_linear_gaussian_simulator builds it) to 1e-12 in float64;
    the port's noise (a counter hash) and the shipped file's (threefry)
    each lie within 6 sd (0.3) of it. The output is the same on every
    call, laid out as the shipped file is; without CUDA and without
    ``--device cpu`` the tool exits 2."""
    import jax

    from abcsmc_tpu_torch.models.simulators import counter_normals
    from abcsmc_tpu_torch.tools import gen_dengue_surrogate

    shipped_text = (REPO / "examples" / "dengue_surrogate.json").read_text()
    shipped = json.loads(shipped_text)
    cpu = ["--device", "cpu"]
    assert gen_dengue_surrogate.main(cpu) == 0
    first = capsys.readouterr().out
    assert gen_dengue_surrogate.main(cpu) == 0
    assert capsys.readouterr().out == first
    got = json.loads(first)
    assert first == json.dumps(got, indent=1) + "\n"
    assert shipped_text == json.dumps(shipped, indent=1) + "\n"
    assert list(got) == list(shipped)
    for key in got:
        if key != "metrics":
            assert got[key] == shipped[key], key
    assert len(got["metrics"]) == len(shipped["metrics"]) == 100
    for g, s in zip(got["metrics"], shipped["metrics"]):
        assert {k: v for k, v in g.items() if k != "value"} == \
            {k: v for k, v in s.items() if k != "value"}

    truth, obs = gen_dengue_surrogate.observed("cpu")
    assert [m["value"] for m in got["metrics"]] == \
        [round(float(v), 6) for v in obs]
    jax_mix = np.asarray(jax.random.normal(jax.random.PRNGKey(7), (16, 100),
                                           dtype=jnp.float32), np.float64)
    mean = truth @ jax_mix
    noise = 0.3 * counter_normals(torch.tensor([2024]), 100,
                                  torch.float64)[0].numpy()
    np.testing.assert_allclose(obs - noise, mean, rtol=0, atol=1e-12)
    assert np.abs(noise).max() <= 6 * 0.3
    shipped_vals = np.array([m["value"] for m in shipped["metrics"]])
    assert np.abs(shipped_vals - mean).max() <= 6 * 0.3
    assert np.abs(shipped_vals - obs).max() <= 6 * 0.3

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert gen_dengue_surrogate.main([]) == 2
    assert "--device cpu" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        gen_dengue_surrogate.main(["--bad"])
