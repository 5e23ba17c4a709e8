"""The port's engine (abcsmc_tpu_torch.AbcSmc.run_device) held against the
JAX engine, plus the port's packaging contracts: no jax import, verbatim
copies of the jax-free modules, identical config parsing, and a clear
"not yet ported" error for everything outside the slice.

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
    """The TPU kernel's dot schemes (config ``weight_precision``) have no
    counterpart in the port: every value gives the identical run."""
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


def test_out_of_slice_raises_not_yet_ported(tmp_path):
    a = _port(_cfg(n=50, sets=1))
    for call in (a.run, a.build_database, a.process_database,
                 a.simulate_next_particles):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            call()
    for extra in ({"box_cox": True}, {"noise": "MULTIVARIATE"},
                  {"row_block": 64}, {"propose_split": True},
                  {"topk_two_stage": True}, {"device_dispatch": "fused"}):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            _port(_cfg(n=50, sets=1, **extra)).run_device()
    db = str(tmp_path / "resume.sqlite")
    with redirect_stderr(io.StringIO()):
        _port(_cfg(db, n=50, sets=1)).run_device()
    with pytest.raises(NotImplementedError, match="resume"):
        _port(_cfg(db, n=50, sets=2)).run_device()
    with pytest.raises(NotImplementedError, match="not yet ported"):
        AbcSmc(str(REPO / "examples" / "pseudo.json"), device="cpu")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        AbcSmc(str(REPO / "examples" / "sir.json"), device="cpu")


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
        "abcsmc_tpu_torch.ops._build, abcsmc_tpu_torch.reports\n"
        "bad = sorted(m for m in set(sys.modules) - before if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib', 'abcsmc_tpu.')) or m == 'abcsmc_tpu')\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


COPIED = ["errors.py", "config.py", "models/metrics.py",
          "storage/__init__.py", "storage/base.py", "storage/memstore.py",
          "storage/sqlite_store.py"]


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
