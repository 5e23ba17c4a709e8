"""Projection mode in the port (PSEUDO grids, POSTERIOR parameters sourced
from an earlier run's store, retained ranks) held against the JAX engine.

A projection draws nothing for its parameters: the sweep is the host
odometer (first PSEUDO parameter fastest, the posterior rank slowest), so
the par rows of the two engines must be EQUAL, in the same serial order.
Only the simulator's noise differs between the packages; the tests that
compare metrics use simulators without noise (an echo of the model-space
parameters) or dice with one face."""

import io
import json
import sqlite3
from contextlib import closing, redirect_stderr
from pathlib import Path

import numpy as np
import pytest
import torch

from abcsmc_tpu import AbcSmc as JAbcSmc
from abcsmc_tpu.config import parse_config as j_parse
from abcsmc_tpu.models.parameters import ParameterSet as JParameterSet
from abcsmc_tpu.models.simulators import (
    PySimulator as JPySimulator, make_dice_simulator as j_dice,
)
from abcsmc_tpu_torch import AbcSmc
from abcsmc_tpu_torch.cli import main
from abcsmc_tpu_torch.config import parse_config
from abcsmc_tpu_torch.errors import ConfigError
from abcsmc_tpu_torch.models.parameters import (
    ParameterSet, PosteriorParameter, PseudoParameter,
)
from abcsmc_tpu_torch.models.simulators import (
    DeviceSimulator, PySimulator, make_dice_simulator,
)
from abcsmc_tpu_torch.storage import MemoryStorage

REPO = Path(__file__).resolve().parents[1]
F64 = torch.float64

GRID = [
    {"name": "a", "dist_type": "PSEUDO", "num_type": "INT",
     "par1": 1, "par2": 3},
    {"name": "b", "dist_type": "PSEUDO", "num_type": "FLOAT",
     "vals": [0.5, 1.5]},
]
METRICS2 = [{"name": "m1", "num_type": "FLOAT", "value": 0},
            {"name": "m2", "num_type": "FLOAT", "value": 0}]


def _quiet(fn, *args, **kwargs):
    with redirect_stderr(io.StringIO()):
        return fn(*args, **kwargs)


def _table(db, sql):
    with closing(sqlite3.connect(db)) as con:
        return con.execute(sql).fetchall()


def _par_rows(db, cols):
    return _table(db, f"select {', '.join('p.' + c for c in cols)} "
                      "from par p order by p.serial")


def _jobs(db):
    return _table(db, "select serial, smcSet, particleIdx, status, posterior "
                      "from job order by serial")


def echo_device_sim(nmet):
    """Device simulator without noise: the first ``nmet`` model-space
    parameters, echoed."""
    return DeviceSimulator(lambda p, seeds: p[:, :nmet].clone(), nmet=nmet)


def test_indexed_grid_values_equal_jax_order_included():
    raw = {
        "posterior_database_filename": "unused.sqlite",
        "parameters": GRID + [
            {"name": "x", "dist_type": "POSTERIOR", "num_type": "FLOAT",
             "par1": 0, "par2": 3},
            {"name": "y", "dist_type": "POSTERIOR", "num_type": "FLOAT",
             "par1": 0, "par2": 3},
        ],
        "metrics": METRICS2,
    }
    cfg, jcfg = parse_config(raw), j_parse(raw)
    assert cfg.projection_mode and cfg.smc_set_sizes == [3 * 2 * 4]
    ps = ParameterSet.from_specs(cfg.parameters)
    jps = JParameterSet.from_specs(jcfg.parameters)
    assert (ps.prior_idx, ps.pseudo_idx, ps.posterior_idx,
            ps.posterior_size) == (jps.prior_idx, jps.pseudo_idx,
                                   jps.posterior_idx, jps.posterior_size)
    assert isinstance(ps.params[0], PseudoParameter)
    assert isinstance(ps.params[2], PosteriorParameter)
    for n in (24, 30, 5):                  # past the grid it wraps around
        vals, ranks = ps.indexed_grid_values(n)
        jvals, jranks = jps.indexed_grid_values(n)
        np.testing.assert_array_equal(vals, jvals)
        np.testing.assert_array_equal(ranks, jranks)
    vals, ranks = ps.indexed_grid_values(24)
    assert vals[:4].tolist() == [[1, 0.5], [2, 0.5], [3, 0.5], [1, 1.5]]
    assert ranks[:7].tolist() == [0] * 6 + [1]

    # sample_priors fills POSTERIOR columns from the matrix, as in JAX
    import jax

    pm = np.random.default_rng(0).normal(size=(9, 2))
    got = ps.sample_priors(torch.Generator().manual_seed(0), 24, F64, pm)
    want, want_ranks = jps.sample_priors(jax.random.PRNGKey(0), 24, pm)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(ranks, np.asarray(want_ranks))
    with pytest.raises(ConfigError, match="posterior matrix"):
        ps.sample_priors(torch.Generator().manual_seed(0), 24, F64)


def test_indexed_parameters_refuse_density_recast_and_noise():
    cfg = parse_config({"parameters": GRID, "metrics": METRICS2})
    ps = ParameterSet.from_specs(cfg.parameters)
    x = torch.zeros((4, 2), dtype=F64)
    with pytest.raises(ConfigError, match="likelihood"):
        ps.prior_log_pdf(x)
    with pytest.raises(ConfigError, match="validity"):
        ps.valid_mask(x)
    with pytest.raises(ConfigError, match="noise"):
        ps.noise_independent(x, torch.ones(2), torch.rand(4, 2))
    with pytest.raises(ConfigError, match="noise"):
        ps.noise_multivariate(x, torch.eye(2), torch.zeros(4, 2))
    with pytest.raises(ConfigError, match="randomly sample"):
        ps.params[0].sample(torch.Generator(), 3, F64)
    with pytest.raises(ConfigError, match="recast"):
        ps.params[0].recast(x)


@pytest.mark.parametrize("route", ["host", "run_device"])
def test_projection_pseudo_sweep_enumerates_grid(route, tmp_path):
    db, jdb = str(tmp_path / "proj.sqlite"), str(tmp_path / "jax.sqlite")
    cfg = {"database_filename": db, "parameters": GRID, "metrics": METRICS2}
    if route == "host":
        abc = AbcSmc(cfg, device="cpu", dtype=F64,
                     simulator=PySimulator(lambda p, seed, ser: list(p)))
        assert abc.config.projection_mode
        assert abc.config.smc_set_sizes == [6]
        _quiet(abc.process_database, seed=0)
        abc.simulate_next_particles(n=-1)
        assert _quiet(abc.process_database, seed=1) is True
    else:
        abc = AbcSmc(cfg, device="cpu", dtype=F64,
                     simulator=echo_device_sim(2))
        _quiet(abc.run_device, seed=0)
        sims = [e for e in abc.timings if e["op"] == "simulate_device"]
        assert [e["n"] for e in sims] == [6]     # one claim, one call
    abc.storage.close()
    rows = _table(db, "select p.a, p.b, m.m1, m.m2 from par p, met m "
                      "where p.serial = m.serial order by p.serial")
    # odometer semantics: first parameter fastest (ParRNG.h:17-36)
    assert [(r[0], r[1]) for r in rows] == [
        (1.0, 0.5), (2.0, 0.5), (3.0, 0.5), (1.0, 1.5), (2.0, 1.5), (3.0, 1.5),
    ]
    for a, b, m1, m2 in rows:
        assert (m1, m2) == (a, b)
    # the JAX engine writes the same rows for the same config
    jabc = JAbcSmc({**cfg, "database_filename": jdb},
                   simulator=JPySimulator(lambda p, seed, ser: list(p)))
    _quiet(jabc.run_device, seed=0)
    jabc.storage.close()
    assert _par_rows(db, "ab") == _par_rows(jdb, "ab")
    assert _jobs(db) == _jobs(jdb)
    # in-memory state of a projection: every row "survives", flat weights
    pars, w = abc.posterior()
    assert pars.shape == (6, 2)
    np.testing.assert_allclose(w, np.full(6, 1 / 6))


@pytest.mark.parametrize("route", ["run_device", "cli"])
def test_pseudo_example_matches_jax_engine(route, tmp_path):
    """examples/pseudo.json: 25 rows, all 'D', the JAX engine's par rows in
    the JAX engine's serial order."""
    raw = json.loads((REPO / "examples" / "pseudo.json").read_text())
    db, jdb = str(tmp_path / "pseudo.sqlite"), str(tmp_path / "jax.sqlite")
    raw["database_filename"] = db
    if route == "run_device":
        abc = _quiet(AbcSmc(raw, device="cpu").run_device, seed=0)
        abc.storage.close()
    else:
        path = tmp_path / "pseudo.json"
        path.write_text(json.dumps(raw))
        rc = _quiet(main, [str(path), "--process", "--simulate", "--all",
                           "--seed", "0", "--torch-device", "cpu"])
        assert rc == 0
    jabc = _quiet(JAbcSmc({**raw, "database_filename": jdb}).run_device,
                  seed=0)
    jabc.storage.close()
    rows = _par_rows(db, ["ndice", "sides"])
    assert len(rows) == 25
    assert rows == _par_rows(jdb, ["ndice", "sides"])
    assert rows[:6] == [(1, 2), (2, 2), (3, 2), (4, 2), (5, 2), (1, 4)]
    assert rows[-1] == (5, 10)
    assert _jobs(db) == _jobs(jdb)
    assert {j[3] for j in _jobs(db)} == {"D"}
    mets = np.array(_table(db, "select sum, sd from met order by serial"))
    pars = np.array(rows, float)
    assert np.all(mets[:, 0] >= pars[:, 0])
    assert np.all(mets[:, 0] <= pars[:, 0] * pars[:, 1])
    assert np.all(mets[pars[:, 0] == 1, 1] == 0.0)     # one die: sd 0


FIT = {
    "smc_iterations": 2, "num_samples": 60, "predictive_prior_size": 8,
    "parameters": [
        {"name": "ndice", "dist_type": "UNIFORM", "num_type": "INT",
         "par1": 1, "par2": 50},
        {"name": "sides", "dist_type": "UNIFORM", "num_type": "INT",
         "par1": 1, "par2": 50},
    ],
    "metrics": [{"name": "sum", "num_type": "INT", "value": 44},
                {"name": "sd", "num_type": "FLOAT", "value": 2.39925}],
}


def _project(tmp_path, fit_db, retain, name="proj.sqlite"):
    return {
        "database_filename": str(tmp_path / name),
        "posterior_database_filename": fit_db,
        "retain_posterior_rank": retain,
        "parameters": [
            {"name": "scenario", "dist_type": "PSEUDO", "num_type": "INT",
             "par1": 0, "par2": 2},
            {"name": "ndice", "dist_type": "POSTERIOR", "num_type": "INT",
             "par1": 0, "par2": 7},
            {"name": "sides", "dist_type": "POSTERIOR", "num_type": "INT",
             "par1": 0, "par2": 7},
        ],
        "metrics": [{"name": "sum", "num_type": "INT", "value": 0},
                    {"name": "sd", "num_type": "FLOAT", "value": 0},
                    {"name": "scen", "num_type": "FLOAT", "value": 0}],
    }


def _fit(tmp_path, writer):
    """A fitted dice store, written by the port or by the JAX package."""
    fit_db = str(tmp_path / f"fit_{writer}.sqlite")
    cfg = {**FIT, "database_filename": fit_db}
    if writer == "port":
        abc = AbcSmc(cfg, device="cpu", dtype=F64,
                     simulator=make_dice_simulator(max_dice=50))
        _quiet(abc.run_device, seed=4)
    else:
        abc = JAbcSmc(cfg, simulator=j_dice(max_dice=50))
        _quiet(abc.run, seed=4)
    abc.storage.close()
    return fit_db


@pytest.mark.parametrize("retain", [True, False])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_posterior_parameters_source_from_fit_db(writer, retain, tmp_path):
    fit_db = _fit(tmp_path, writer)
    cfg = _project(tmp_path, fit_db, retain)
    # metrics = (2 ndice, 3 sides, scenario), on the device path
    sim = DeviceSimulator(
        lambda p, seeds: torch.stack([p[:, 1] * 2, p[:, 2] * 3, p[:, 0]],
                                     dim=1), nmet=3)
    abc = AbcSmc(cfg, device="cpu", dtype=F64, simulator=sim)
    assert abc.config.projection_mode
    assert abc.config.smc_set_sizes == [24]          # 3 scenarios x 8 ranks
    # parity quirk: rows with posterior > -1 across ALL sets, serial order
    # (src/AbcSmc.cpp:302-334): 2 sets x 8 survivors; ranks 0..7 index the
    # first 8 of them
    assert abc._posterior_matrix.shape == (16, 2)
    _quiet(abc.run_device, seed=0)
    abc.storage.close()

    post_rows = set(_table(
        fit_db, "select p.ndice, p.sides from par p, job j "
                "where p.serial = j.serial and j.posterior > -1"))
    rows = _table(cfg["database_filename"],
                  "select j.posterior, p.scenario, p.ndice, p.sides, m.sum, "
                  "m.sd, m.scen, j.status from par p, job j, met m "
                  "where p.serial = j.serial and m.serial = j.serial "
                  "order by j.serial")
    assert len(rows) == 24
    for rank, scen, nd, sd, m0, m1, m2, status in rows:
        assert (nd, sd) in post_rows
        assert (m0, m1, m2) == (2 * nd, 3 * sd, scen)
        assert status == "D"
        assert (rank > -1) == retain           # the retained source rank
    assert [r[1] for r in rows[:6]] == [0, 1, 2, 0, 1, 2]
    ranks = [r[0] for r in rows]
    if retain:
        assert ranks == [i // 3 for i in range(24)]

    # the JAX engine, from the same source store: the same rows
    jcfg = _project(tmp_path, fit_db, retain, name="jproj.sqlite")
    jabc = JAbcSmc(jcfg, simulator=JPySimulator(
        lambda p, seed, ser: [p[1] * 2, p[2] * 3, p[0]]))
    _quiet(jabc.run_device, seed=0)
    jabc.storage.close()
    cols = ["scenario", "ndice", "sides"]
    assert (_par_rows(cfg["database_filename"], cols)
            == _par_rows(jcfg["database_filename"], cols))
    assert _jobs(cfg["database_filename"]) == _jobs(jcfg["database_filename"])


def test_untransform_upar_table_on_the_projection_route(tmp_path):
    """A projection whose PSEUDO parameter has an untransform: the upar
    table holds the model-space values and the simulator receives them."""
    db = str(tmp_path / "u.sqlite")
    cfg = {
        "database_filename": db,
        "parameters": [
            {"name": "logx", "dist_type": "PSEUDO", "num_type": "FLOAT",
             "vals": [-1.0, 0.0, 0.5, 2.0], "untransform": "POW_10"},
            {"name": "k", "dist_type": "PSEUDO", "num_type": "INT",
             "par1": 1, "par2": 2},
        ],
        "metrics": [{"name": "mx", "num_type": "FLOAT", "value": 0},
                    {"name": "mk", "num_type": "FLOAT", "value": 0}],
    }
    abc = AbcSmc(cfg, device="cpu", dtype=F64, simulator=echo_device_sim(2))
    _quiet(abc.run_device, seed=0)
    abc.storage.close()
    rows = _table(db, "select p.logx, p.k, u.logx, u.k, m.mx, m.mk "
                      "from par p, upar u, met m where p.serial = u.serial "
                      "and p.serial = m.serial order by p.serial")
    assert len(rows) == 8
    assert [r[0] for r in rows[:5]] == [-1.0, 0.0, 0.5, 2.0, -1.0]
    for fx, fk, ux, uk, mx, mk in rows:
        assert ux == pytest.approx(10 ** fx, rel=1e-12)
        assert (uk, mx, mk) == (fk, ux, uk)


def test_weights_with_indexed_pars_rejected():
    """Fitting mode that mixes a prior with a PSEUDO parameter aborts at
    the weight step in the reference (IndexedPars.h:20-28); the host engine
    raises at the same point and the device path refuses it up front."""
    cfg = {
        "smc_iterations": 3, "num_samples": 20, "predictive_prior_size": 5,
        "parameters": [
            {"name": "x", "dist_type": "UNIFORM", "num_type": "FLOAT",
             "par1": 0, "par2": 1},
            {"name": "g", "dist_type": "PSEUDO", "num_type": "INT",
             "par1": 0, "par2": 3},
        ],
        "metrics": [{"name": "m", "num_type": "FLOAT", "value": 0.5}],
    }
    abc = AbcSmc(cfg, device="cpu", dtype=F64, storage=MemoryStorage(),
                 simulator=PySimulator(lambda p, s, ser: [p[0]]))
    assert not abc.config.projection_mode
    with pytest.raises(ConfigError):
        _quiet(abc.run, seed=0)
    # the JAX engine routes such a config to its projection loop as well,
    # where the second brain pass asks the PSEUDO parameter for a density
    dev = AbcSmc(cfg, device="cpu", dtype=F64, storage=MemoryStorage(),
                 simulator=echo_device_sim(1))
    with pytest.raises(ConfigError):
        _quiet(dev.run_device, seed=0)
    from abcsmc_tpu.models.simulators import DeviceSimulator as JDeviceSim

    jdev = JAbcSmc(cfg, simulator=JDeviceSim(lambda p, key: p[:1], nmet=1))
    with pytest.raises(Exception) as info:
        _quiet(jdev.run_device, seed=0)
    assert type(info.value).__name__ == "ConfigError"
