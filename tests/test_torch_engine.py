"""The port's engine (abcsmc_tpu_torch.AbcSmc.run_device) held against the
JAX engine, plus the port's packaging contracts: no jax import, verbatim
copies of the jax-free modules, identical config parsing, and the engine's
surfaces (checkpoint, ess, posterior_summary, posterior_predictive, direct,
compare, crc32) against the JAX engine on one JAX-written store.

Law tolerance: the two engines draw from different generators, so their
posteriors agree in law only. Final predictive priors (200 survivors each)
are compared per parameter by the two-sample KS distance (< 0.2, about the
alpha = 0.001 critical value 1.95 * sqrt(2 / 200) = 0.195) and the mean
difference in pooled sds (< 0.4). Over seeds 0-7 on a CPU the largest
values seen were 0.11 and 0.18."""

import dataclasses
import enum
import io
import json
import re
import sqlite3
import subprocess
import sys
from contextlib import closing, redirect_stderr
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from abcsmc_tpu import AbcSmc as JAbcSmc
from abcsmc_tpu.compare import ks_distance
from abcsmc_tpu.config import parse_config as j_parse
from abcsmc_tpu_torch import AbcSmc, resolve_device
from abcsmc_tpu_torch.config import parse_config
from abcsmc_tpu_torch.errors import AbcError
from abcsmc_tpu_torch.models.simulators import make_linear_gaussian_simulator
from abcsmc_tpu_torch.storage import MemoryStorage

REPO = Path(__file__).resolve().parents[1]
NPAR, NMET = 3, 5
TRUTH = np.array([0.3, 0.7, 0.5])


def _mix():
    # the JAX builtin's matrix at the test suite's x64 precision
    return np.asarray(jax.random.normal(jax.random.PRNGKey(7), (NPAR, NMET)))


def _cfg(db="", sets=3, n=2000, **extra):
    obs = TRUTH @ _mix()
    return {
        "smc_iterations": sets, "num_samples": n,
        "predictive_prior_fraction": 0.1, "simulator": "linear_gaussian",
        "database_filename": db,
        "parameters": [
            {"name": f"p{i}", "dist_type": "UNIFORM", "num_type": "FLOAT",
             "par1": 0.0, "par2": 1.0} for i in range(NPAR)
        ],
        "metrics": [
            {"name": f"m{j}", "num_type": "FLOAT", "value": float(obs[j])}
            for j in range(NMET)
        ],
        **extra,
    }


def _port(cfg, **kw):
    return AbcSmc(cfg, device="cpu", dtype=torch.float64,
                  simulator=make_linear_gaussian_simulator(NPAR, NMET,
                                                           mix=_mix()),
                  **kw)


def _schema(db):
    with closing(sqlite3.connect(db)) as con:
        tables = con.execute(
            "select name, sql from sqlite_master where type in "
            "('table', 'index', 'view') order by name").fetchall()
        rows = con.execute(
            "select smcSet, count(*), sum(status = 'D'), sum(posterior > -1)"
            " from job group by smcSet order by smcSet").fetchall()
        npar = con.execute("select count(*) from par").fetchone()[0]
        nmet = con.execute("select count(*) from met").fetchone()[0]
    return tables, rows, npar, nmet


def test_run_device_matches_jax_engine_in_law(tmp_path, capfd):
    jdb, tdb = str(tmp_path / "jax.sqlite"), str(tmp_path / "torch.sqlite")
    ja = JAbcSmc(_cfg(jdb)).run_device(seed=0)
    capfd.readouterr()
    ta = _port(_cfg(tdb)).run_device(seed=0)
    text = capfd.readouterr().err
    jt, jrows, jnp_, jnm = _schema(jdb)
    tt, trows, tnp, tnm = _schema(tdb)
    assert tt == jt
    assert trows == jrows == [(t, 2000, 2000, 200) for t in range(3)]
    assert (tnp, tnm) == (jnp_, jnm) == (3 * 2000, 3 * 2000)
    jp, jw = ja.posterior()
    tp, tw = ta.posterior()
    assert tp.shape == jp.shape == (200, NPAR)
    assert np.isfinite(tw).all()
    assert float(np.linalg.norm(tw)) == pytest.approx(1.0, abs=1e-9)
    for j in range(NPAR):
        a, b = jp[:, j], tp[:, j]
        assert ks_distance(a, b) < 0.2, j
        pooled = np.sqrt((a.var(ddof=1) + b.var(ddof=1)) / 2)
        assert abs(a.mean() - b.mean()) / pooled < 0.4, j
    gens = [e for e in ta.timings if e["op"] == "device_generation"]
    assert [e["set"] for e in gens] == [0, 1, 2]
    assert all(e["ncomp_used"] >= 1 for e in gens)
    assert all(e["device_ms"] is None for e in gens)   # no CUDA events here
    # the reports the JAX engine prints
    assert text.count("Normalized RMSE for metric means") == 3
    assert "Convergence data for predictive priors:" in text


# A fixed-seed run of the port (CPU, float64, in-memory store): the CRC-32
# of every stored set's parameters, metrics, seeds and posterior ranks.
# Pinned on torch 2.13.0+cpu; any change to a draw, the ranking, the
# weights or the proposal (the MULTIVARIATE retry stream included) moves it.
PINNED_CRC = {"INDEPENDENT": "6a5009be", "MULTIVARIATE": "ee6c277e"}


@pytest.mark.parametrize("noise", sorted(PINNED_CRC))
def test_pinned_port_run(noise):
    from abcsmc_tpu_torch import crc32
    from abcsmc_tpu_torch.models.simulators import make_dice_simulator

    cfg = {"smc_iterations": 4, "num_samples": 400,
           "predictive_prior_size": 40, "noise": noise,
           "parameters": [
               {"name": n, "dist_type": "UNIFORM", "num_type": "INT",
                "par1": 1, "par2": 100} for n in ("ndice", "sides")],
           "metrics": [{"name": "sum", "num_type": "INT", "value": 44},
                       {"name": "sd", "num_type": "FLOAT",
                        "value": 2.39925}]}
    a = AbcSmc(cfg, device="cpu", dtype=torch.float64,
               simulator=make_dice_simulator(max_dice=100))
    with redirect_stderr(io.StringIO()):
        a.run_device(seed=12345)
    crc = 0
    for g in a.storage.read_generations():
        for arr in (g.params, g.metrics, g.seeds, g.posterior_ranks):
            crc = crc32.partial_crc(crc, np.ascontiguousarray(arr).tobytes())
    assert f"{crc:08x}" == PINNED_CRC[noise], torch.__version__
    rounds = [e["mvn_rounds"] for e in a.timings
              if e["op"] == "device_generation"]
    assert (rounds == [12, 8, 5, 0]) == (noise == "MULTIVARIATE")


def test_run_device_deterministic_and_memory_store():
    a = _port(_cfg(n=600, sets=2))
    b = _port(_cfg(n=600, sets=2))
    with redirect_stderr(io.StringIO()):
        a.run_device(seed=4)
        b.run_device(seed=4)
    assert isinstance(a.storage, MemoryStorage)
    np.testing.assert_array_equal(a.posterior()[0], b.posterior()[0])
    gens = a.storage.read_generations()
    assert [g.size for g in gens] == [600, 600]
    assert all(g.complete and g.has_posterior for g in gens)


def test_every_weight_precision_runs_the_same_fp32_path():
    """On the CPU the config's ``weight_precision`` changes nothing, as
    JAX's XLA path off the TPU ignores it: every value gives the identical
    run. (On a card each value launches its own dot scheme of the kernel;
    tests/test_torch_gpu.py holds each against its plain version.)"""
    posts = []
    for prec in ("high", "highest", "default"):
        a = _port(_cfg(n=600, sets=2, weight_precision=prec))
        with redirect_stderr(io.StringIO()):
            a.run_device(seed=2)
        posts.append(a.posterior())
    for pars, w in posts[1:]:
        np.testing.assert_array_equal(pars, posts[0][0])
        np.testing.assert_array_equal(w, posts[0][1])


def test_nrmse_tolerance_stops_early():
    a = _port(_cfg(n=600, sets=4, nrmse_tolerance=10.0))
    with redirect_stderr(io.StringIO()):
        a.run_device(seed=1)
    assert len(a.storage.read_generations()) == 1


def test_negative_ncomp_raises_before_store_write():
    a = _port(_cfg(n=20, sets=1))
    n = 20
    host = (np.zeros((n, NPAR)), np.arange(n), np.zeros((n, NMET)),
            np.arange(2), np.ones(2), np.ones(NPAR), np.array(-3))
    with pytest.raises(AbcError, match="self-check"):
        a._mirror_fetched_sets([host])
    assert a.storage.read_generations() == []


def test_device_and_host_engines_take_box_cox_and_mvn(tmp_path):
    """The device step and the host brain both take Box-Cox and
    MULTIVARIATE noise; projection configs and every builtin simulator
    construct; nothing in the package says "not yet ported"."""
    dev = _port(_cfg(n=200, sets=2, box_cox=True, noise="MULTIVARIATE"))
    with redirect_stderr(io.StringIO()):
        dev.run_device(seed=1)
    gens = [e for e in dev.timings if e["op"] == "device_generation"]
    assert len(gens[0]["box_cox_lambdas"]) == NMET
    assert gens[0]["mvn_rounds"] >= 1 and gens[1]["mvn_rounds"] == 0
    db = str(tmp_path / "host.sqlite")
    with redirect_stderr(io.StringIO()):
        _port(_cfg(db, n=50, sets=2, box_cox=True,
                   noise="MULTIVARIATE")).run(seed=1)
    assert [g.size for g in
            _port(_cfg(db, n=50, sets=2)).storage.read_generations()] == [50, 50]
    for example in ("pseudo.json", "sir.json"):
        raw = json.loads((REPO / "examples" / example).read_text())
        raw["database_filename"] = str(tmp_path / (example + ".sqlite"))
        eng = AbcSmc(raw, device="cpu")
        assert eng.simulator.is_device
        eng.storage.close()
    for path in (REPO / "abcsmc_tpu_torch").rglob("*.py"):
        text = path.read_text()
        assert "not yet ported" not in text, path
        assert "NotImplementedError(" not in text or path.name in (
            "simulators.py", "parameters.py", "base.py"), path


# ------------------------------------------------------------ the surfaces
@pytest.fixture(scope="module")
def jax_store(tmp_path_factory):
    """One store written by the JAX engine, and that engine."""
    db = str(tmp_path_factory.mktemp("surfaces") / "jax.sqlite")
    with redirect_stderr(io.StringIO()):
        ja = JAbcSmc(_cfg(db, n=800)).run_device(seed=3)
    return db, ja


def _reader(db):
    """The port on a finished store: the resume pass reads every set."""
    ta = _port(_cfg(db, n=800))
    with redirect_stderr(io.StringIO()):
        ta.run_device(seed=0)
    return ta


def test_ess_and_posterior_summary_equal_the_jax_engine(jax_store):
    db, ja = jax_store
    ta = _reader(db)
    for t in (0, 1, -1):
        assert ta.ess(t) == pytest.approx(ja.ess(t), rel=1e-8)
    assert ta.ess(0) == pytest.approx(80.0)          # uniform weights: K
    assert 1.0 < ta.ess() <= 80.0
    want, got = ja.posterior_summary(), ta.posterior_summary()
    assert list(got) == list(want) == ["p0", "p1", "p2"]
    for name in want:
        for k in ("mean", "sd", "ess"):
            assert got[name][k] == pytest.approx(want[name][k], rel=1e-8)
        assert got[name]["quantiles"] == pytest.approx(
            want[name]["quantiles"], rel=1e-12)
    q = ta.posterior_summary(set_num=1, quantiles=(0.1, 0.9))["p1"]
    jq = ja.posterior_summary(set_num=1, quantiles=(0.1, 0.9))["p1"]
    assert q["quantiles"] == pytest.approx(jq["quantiles"], rel=1e-12)
    ta.storage.close()


def test_posterior_predictive_agrees_with_the_jax_engine_in_law(jax_store):
    """Different generators: the draws agree in law. 4,000 draws each; per
    metric the KS distance stays under the alpha = 0.001 critical value
    1.95 * sqrt(2 / 4000) = 0.0436."""
    db, ja = jax_store
    ta = _reader(db)
    n = 4000
    want = ja.posterior_predictive(n, seed=1)
    got = ta.posterior_predictive(n, seed=1)
    assert got.shape == want.shape == (n, NMET) and np.isfinite(got).all()
    np.testing.assert_array_equal(got, ta.posterior_predictive(n, seed=1))
    assert not np.array_equal(got, ta.posterior_predictive(n, seed=2))
    for j in range(NMET):
        assert ks_distance(got[:, j], want[:, j]) < 0.0436, j
    first = ta.posterior_predictive(50, seed=1, set_num=0)
    assert first.shape == (50, NMET) and np.isfinite(first).all()
    no_sim = AbcSmc({k: v for k, v in _cfg(db, n=800).items()
                     if k != "simulator"}, device="cpu")
    from abcsmc_tpu_torch.errors import SimulatorError
    with pytest.raises(SimulatorError):
        no_sim.posterior_predictive(5)
    no_sim.storage.close()
    ta.storage.close()


def test_checkpoint_round_trip_and_crc_equal_the_jax_package(jax_store,
                                                             tmp_path):
    from abcsmc_tpu import crc32 as jcrc
    from abcsmc_tpu_torch import compare, crc32

    db, ja = jax_store
    ta = _reader(db)
    copy = tmp_path / "shipped.sqlite"
    stamp = ta.checkpoint(copy)                       # a PathLike target
    assert crc32.verify_checkpoint(copy) is True
    assert jcrc.verify_checkpoint(copy) is True       # the same stamp format
    assert stamp["crc32"] == f"{jcrc.file_crc(str(copy)):08x}"
    assert stamp == jcrc.database_crc(str(copy)) | {"mtime": stamp["mtime"]}
    assert crc32.file_crc(db) == jcrc.file_crc(db)
    data = b"the quick brown fox"
    assert crc32.partial_crc(0, data) == jcrc.partial_crc(0, data)
    # the copy holds the store: same rows, KS 0 against the original
    assert _schema(str(copy))[1:] == _schema(db)[1:]
    assert max(v["ks"] for v in compare.compare(db, str(copy)).values()) == 0
    # stamping the live database in place, and no stamp on request
    assert ta.checkpoint(db)["path"] == db
    assert crc32.verify_checkpoint(db) is True
    assert ta.checkpoint(tmp_path / "plain.sqlite", stamp=False) == {}
    assert not (tmp_path / "plain.sqlite.crc.json").exists()
    # a corrupted copy fails the check
    with open(copy, "r+b") as fh:
        fh.seek(100)
        fh.write(b"\x00\x01\x02\x03")
    assert crc32.verify_checkpoint(copy) is False
    ta.storage.close()
    # a memory store is snapshotted, and the snapshot resumes
    mem = _port(_cfg(n=300, sets=2))
    with redirect_stderr(io.StringIO()):
        mem.run_device(seed=1)
    snap = str(tmp_path / "snap.sqlite")
    mem.checkpoint(snap)
    assert _schema(snap)[1] == [(0, 300, 300, 30), (1, 300, 300, 30)]
    more = _port(_cfg(snap, n=300, sets=3))
    with redirect_stderr(io.StringIO()):
        more.run_device(seed=2)
    assert _schema(snap)[1][-1] == (2, 300, 300, 30)
    more.storage.close()


def test_compare_cli_prints_what_the_jax_module_prints(jax_store, tmp_path):
    db, _ = jax_store
    other = str(tmp_path / "other.sqlite")
    with redirect_stderr(io.StringIO()):
        _port(_cfg(other, n=800)).run_device(seed=9)
    outs = []
    for mod in ("abcsmc_tpu_torch.compare", "abcsmc_tpu.compare"):
        run = subprocess.run([sys.executable, "-m", mod, db, other],
                             cwd=REPO, capture_output=True, text=True,
                             timeout=300)
        assert run.returncode == 0, run.stderr
        outs.append(json.loads(run.stdout))
    assert outs[0] == outs[1]
    assert set(outs[0]) == {"p0", "p1", "p2"}
    assert all(0 < v["ks"] < 0.5 for v in outs[0].values())
    usage = subprocess.run([sys.executable, "-m", "abcsmc_tpu_torch.compare"],
                           cwd=REPO, capture_output=True, text=True,
                           timeout=120)
    assert usage.returncode == 1 and "abcsmc_tpu_torch.compare" in usage.stdout


def test_direct_builds_the_config_the_jax_engine_builds():
    cfg = _cfg()
    extra = dict(device_dispatch="sequential", row_block=64,
                 resample_method="systematic")
    ja = JAbcSmc.direct(cfg["parameters"], cfg["metrics"], [100, 200],
                        smc_iterations=3, predictive_prior_fraction=0.1,
                        noise="MULTIVARIATE", **extra)
    ta = AbcSmc.direct(cfg["parameters"], cfg["metrics"], [100, 200],
                       smc_iterations=3, predictive_prior_fraction=0.1,
                       noise="MULTIVARIATE", device="cpu",
                       dtype=torch.float64, **extra)
    assert _plain(ta.config) == _plain(ja.config)
    assert ta.device == torch.device("cpu") and ta.dtype == torch.float64
    assert isinstance(ta.storage, MemoryStorage)
    sized = AbcSmc.direct(cfg["parameters"], cfg["metrics"], 50,
                          predictive_prior_size=7, device="cpu",
                          simulator=make_linear_gaussian_simulator(
                              NPAR, NMET, mix=_mix()))
    with redirect_stderr(io.StringIO()):
        sized.run_device(seed=0)
    assert sized.posterior()[0].shape == (7, NPAR)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            AbcSmc.direct(cfg["parameters"], cfg["metrics"], 50,
                          predictive_prior_size=7)


def test_resolve_device_is_explicit():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device("cuda")
        with pytest.raises(RuntimeError):
            AbcSmc(_cfg(n=50, sets=1))        # the default device is cuda


def test_import_leaves_jax_out():
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import abcsmc_tpu_torch, abcsmc_tpu_torch.engine, "
        "abcsmc_tpu_torch.parallel.generation, abcsmc_tpu_torch.ops.kernels, "
        "abcsmc_tpu_torch.ops._build, abcsmc_tpu_torch.reports, "
        "abcsmc_tpu_torch.cli, abcsmc_tpu_torch.ops.ranking, "
        "abcsmc_tpu_torch.native, abcsmc_tpu_torch.vis, "
        "abcsmc_tpu_torch.models.ref_shim, abcsmc_tpu_torch.rank_precision, "
        "abcsmc_tpu_torch.compare, abcsmc_tpu_torch.crc32, "
        "abcsmc_tpu_torch.models, abcsmc_tpu_torch.ops.regression\n"
        "bad = sorted(m for m in set(sys.modules) - before if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib', 'abcsmc_tpu.')) or m == 'abcsmc_tpu')\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# storage/memstore.py is the port's own columnar store, held to the JAX
# store's behaviour by tests/test_torch_memstore_parity.py instead
COPIED = ["errors.py", "config.py", "models/metrics.py",
          "storage/__init__.py", "storage/base.py",
          "storage/sqlite_store.py", "models/ref_shim.py", "native.py",
          "vis.py", "crc32.py", "compare.py", "ops/regression.py"]


# the only differences allowed: the package name in import paths, and two
# comment rewrites (citations of the reference's sources drop the absolute
# path of its checkout; one comment names the process role differently)
REWRITES = [(r"\babcsmc_tpu\b", "abcsmc_tpu_torch"),
            (r"/[a-z]+/reference/", ""),
            (r"the [a-z]+'s --process", "the coordinator's --process")]


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_has_not_drifted(rel):
    """The jax-free modules are verbatim copies, up to REWRITES."""
    original = (REPO / "abcsmc_tpu" / rel).read_text()
    for pattern, repl in REWRITES:
        original = re.sub(pattern, repl, original)
    assert (REPO / "abcsmc_tpu_torch" / rel).read_text() == original


def _plain(x):
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.name)
    if dataclasses.is_dataclass(x):
        return {f.name: _plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


@pytest.mark.parametrize(
    "path", sorted((REPO / "examples").glob("*.json")), ids=lambda p: p.name)
def test_examples_parse_equal_in_both_packages(path):
    assert _plain(parse_config(str(path))) == _plain(j_parse(str(path)))
    raw = json.loads(path.read_text())
    assert parse_config(raw).raw == j_parse(raw).raw
