"""The port's seven model-family simulators (sir, seir_campaign,
lotka_volterra, ricker, gk, mg1, ma2) held against the JAX package's.

Deterministic part. The two packages draw from different generators
(threefry keys vs a counter hash), so each port simulator is written as
``metrics_from_noise(params, noise)`` and the test serves it the JAX
function's own draws: the normals / uniforms / exponentials are taken from
the same keys the JAX function derives (``fold_in(PRNGKey(0), seed)``, then
its splits), laid out in the port's documented column order. Every
simulator took this route; none needed a numpy transcription. Float64,
64 particles over the example configs' prior boxes: rtol 1e-6 for ma2, gk,
mg1 and lotka_volterra; for sir, seir_campaign and ricker (they round to
counts) exact equality of the integer-valued metrics and rtol 1e-6 of the
rest. The Ricker map is chaotic above log r of about 2.7: there a last-bit
difference between the two libraries' ``exp`` grows by e^0.4 a step, so
its draw-for-draw case keeps log r in [0.5, 2.0] (a stable fixed point),
and the chaotic regime is held in law only.

In law. 4,096 particles at one parameter point per simulator, each with its
own noise: the two-sample Kolmogorov-Smirnov distance per metric stays below
the alpha = 0.001 critical value 1.95 * sqrt(2 / 4096) = 0.0431.

Replay. A particle's row is the same in a batch of 1 and of 4,096, through
``run_batch`` and through the generation step."""

import io
import json
from contextlib import redirect_stderr
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from abcsmc_tpu.compare import ks_distance
from abcsmc_tpu.models import simulators as jsim
from abcsmc_tpu_torch import AbcSmc
from abcsmc_tpu_torch.config import parse_config
from abcsmc_tpu_torch.errors import SimulatorError
from abcsmc_tpu_torch.models import simulators as sim
from abcsmc_tpu_torch.models.parameters import ParameterSet
from abcsmc_tpu_torch.models.transforms import ParameterTransform
from abcsmc_tpu_torch.parallel.generation import Generation

REPO = Path(__file__).resolve().parents[1]
F64 = jnp.float64
KS_CRIT = 1.95 * np.sqrt(2 / 4096)


class ArrayNoise:
    """Serves given draws in the order a simulator asks for them: the
    test-side counterpart of ``CounterNoise``."""

    def __init__(self, normals=None, uniforms=None, exponentials=None):
        self._blocks = {"n": normals, "u": uniforms, "e": exponentials}
        self._next = {"n": 0, "u": 0, "e": 0}

    def _take(self, kind, ncols):
        first = self._next[kind]
        self._next[kind] = first + ncols
        block = self._blocks[kind][:, first:first + ncols]
        assert block.shape[1] == ncols, "simulator asked past the layout"
        return torch.as_tensor(np.array(block))

    def normals(self, ncols):
        return self._take("n", ncols)

    def uniforms(self, ncols):
        return self._take("u", ncols)

    def exponentials(self, ncols):
        return self._take("e", ncols)


def _particle_keys(seeds):
    """The key the JAX DeviceSimulator gives each particle."""
    return jax.vmap(
        lambda s: jax.random.fold_in(jax.random.PRNGKey(0), s)
    )(jnp.asarray(np.asarray(seeds, np.uint32)))


def _per_particle(fn, seeds):
    return {k: np.asarray(v) for k, v in
            jax.vmap(fn)(_particle_keys(seeds)).items()}


def _split_normals(width):
    """Steps whose key is split into ``width`` keys, one scalar normal
    each (sir: 2, seir_campaign: 4)."""
    def per_steps(t_steps):
        def draws(key):
            def one(k):
                ks = jax.random.split(k, width)
                return jnp.stack([jax.random.normal(ks[j], (), F64)
                                  for j in range(width)])
            z = jax.vmap(one)(jax.random.split(key, t_steps))
            return {"normals": z.reshape(-1)}
        return draws
    return per_steps


def _lv_draws(key):
    k_traj, k_noise = jax.random.split(key)
    e = jax.vmap(lambda k: jax.random.normal(k, (2,), F64))(
        jax.random.split(k_traj, 320))
    return {"normals": jnp.concatenate(
        [e.reshape(-1), jax.random.normal(k_noise, (16,), F64)])}


def _ricker_draws(key):
    def one(k):
        k_e, k_y = jax.random.split(k)
        return (jnp.stack([
            jax.random.normal(k_e, (), F64),
            jax.random.normal(jax.random.fold_in(k_y, 1), (), F64),
        ]), jax.random.uniform(k_y, (), F64))
    z, u = jax.vmap(one)(jax.random.split(key, 150))
    return {"normals": z.reshape(-1), "uniforms": u}


def _mg1_draws(key):
    k_a, k_s = jax.random.split(key)
    return {"exponentials": jax.random.exponential(k_a, (50,), F64),
            "uniforms": jax.random.uniform(k_s, (50,), F64)}


# name -> (port factory, JAX factory, the JAX function's draws, prior box,
#          parameter point of the law test, integer-valued metric columns)
FAMILIES = {
    "sir": (sim.make_sir_simulator, jsim.make_sir_simulator,
            _split_normals(2)(160),
            [(0.05, 1.0), (0.02, 0.5)], [0.3, 0.1], [0, 1, 2, 3, 5]),
    "seir_campaign": (sim.make_seir_campaign_simulator,
                      jsim.make_seir_campaign_simulator,
                      _split_normals(4)(365),
                      [(0.1, 0.8), (0.05, 0.5), (0.05, 0.4), (0.0, 1.0),
                       (0.0, 0.05)],
                      [0.4, 0.2, 0.1, 0.25, 0.01], [0, 1, 2, 3, 4, 6, 7]),
    "lotka_volterra": (sim.make_lotka_volterra_simulator,
                       jsim.make_lotka_volterra_simulator, _lv_draws,
                       [(0.1, 3.0), (0.01, 0.5)], [1.0, 0.1], []),
    "ricker": (sim.make_ricker_simulator, jsim.make_ricker_simulator,
               _ricker_draws,
               [(0.5, 2.0), (0.05, 1.0), (2.0, 30.0)], [3.8, 0.3, 10.0],
               [4, 5]),
    "gk": (sim.make_gk_simulator, jsim.make_gk_simulator,
           lambda key: {"normals": jax.random.normal(key, (500,), F64)},
           [(0.0, 10.0), (0.1, 5.0), (0.0, 5.0), (-0.2, 2.0)],
           [3.0, 1.0, 2.0, 0.5], []),
    "mg1": (sim.make_mg1_simulator, jsim.make_mg1_simulator, _mg1_draws,
            [(0.0, 10.0), (0.0, 20.0), (0.001, 0.5)], [1.0, 5.0, 0.2], []),
    "ma2": (sim.make_ma2_simulator, jsim.make_ma2_simulator,
            lambda key: {"normals": jax.random.normal(key, (202,), F64)},
            [(-2.0, 2.0), (-1.0, 1.0)], [0.6, 0.2], []),
}


def _run(s, params, seeds):
    return s.run_batch(params, seeds, np.arange(len(seeds)), device="cpu",
                       dtype=torch.float64)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_simulator_matches_jax_on_the_same_draws(name):
    make, jmake, draws, box, _, int_cols = FAMILIES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    n = 64
    params = np.stack([rng.uniform(lo, hi, n) for lo, hi in box], axis=1)
    seeds = rng.integers(0, 2**31 - 1, n)
    want = jmake().run_batch(params, seeds, np.arange(n))
    noise = ArrayNoise(**_per_particle(draws, seeds))
    got = make().metrics_from_noise(torch.as_tensor(params), noise).numpy()
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[:, int_cols], want[:, int_cols])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_simulator_matches_jax_in_law(name):
    make, jmake, _, _, point, _ = FAMILIES[name]
    n = 4096
    params = np.repeat(np.array([point]), n, axis=0)
    seeds = np.arange(n, dtype=np.uint64) * 7919 + 13
    a = jmake().run_batch(params, seeds, np.arange(n))
    b = _run(make(), params, seeds)
    assert a.shape == b.shape and np.isfinite(b).all()
    for j in range(a.shape[1]):
        assert ks_distance(a[:, j], b[:, j]) < KS_CRIT, (name, j)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_simulator_replays_from_seed(name):
    """The same (params, seed) gives the same row alone, in a batch of
    4,096 in another order, and inside the generation step."""
    make, _, _, box, _, _ = FAMILIES[name]
    rng = np.random.default_rng(3)
    n = 4096
    params = np.stack([rng.uniform(lo, hi, n) for lo, hi in box], axis=1)
    seeds = rng.integers(0, 2**31 - 1, n)
    s = make()
    full = _run(s, params, seeds)
    np.testing.assert_array_equal(_run(s, params[17:18], seeds[17:18]),
                                  full[17:18])
    perm = rng.permutation(n)[:300]
    np.testing.assert_array_equal(_run(s, params[perm], seeds[perm]),
                                  full[perm])
    assert not np.array_equal(_run(s, params[:1], seeds[1:2]), full[:1])

    npar, nmet = params.shape[1], full.shape[1]
    cfg = parse_config({
        "smc_iterations": 1, "num_samples": 256, "predictive_prior_size": 16,
        "parameters": [
            {"name": f"p{i}", "dist_type": "UNIFORM", "num_type": "FLOAT",
             "par1": lo, "par2": hi} for i, (lo, hi) in enumerate(box)],
        "metrics": [{"name": f"m{j}", "num_type": "FLOAT",
                     "value": float(full[0, j])} for j in range(nmet)],
    })
    gen = Generation(
        ParameterSet.from_specs(cfg.parameters),
        ParameterTransform(cfg.parameters), s, full[0], device="cpu",
        dtype=torch.float64)
    res = gen.step(torch.as_tensor(params[:256]),
                   torch.as_tensor(seeds[:256].astype(np.int64)), 16, 0,
                   gen.draw_step(torch.Generator().manual_seed(0), 0))
    assert npar == gen.par_set.npar
    np.testing.assert_array_equal(res.metrics.numpy(), full[:256])


def test_counter_columns_do_not_depend_on_the_block():
    """A column's draw is a function of (seed, column) alone: asking for
    columns 5..9 gives the slice of asking for 0..19, for each kind."""
    seeds = torch.arange(50) * 977 + 5
    for fn in (lambda n, f: sim.counter_normals(seeds, n, torch.float64, f),
               lambda n, f: sim.counter_uniforms(seeds, n, f),
               lambda n, f: sim.counter_exponentials(seeds, n, f)):
        np.testing.assert_array_equal(fn(5, 5).numpy(),
                                      fn(20, 0)[:, 5:10].numpy())
    noise = sim.CounterNoise(seeds, torch.float64)
    parts = torch.cat([noise.normals(3), noise.normals(4)], dim=1)
    np.testing.assert_array_equal(
        parts.numpy(), sim.counter_normals(seeds, 7, torch.float64).numpy())
    e = sim.counter_exponentials(torch.arange(20000), 4)
    assert float(e.min()) >= 0.0 and bool(torch.isfinite(e).all())
    assert abs(float(e.mean()) - 1.0) < 0.02
    u32 = sim.CounterNoise(torch.arange(200000), torch.float32).uniforms(8)
    assert float(u32.max()) < 1.0 and float(u32.min()) >= 0.0


def test_row_quantiles_match_jax_quantile():
    """The octiles of a fixed numpy sample, against jnp.quantile, 1e-6."""
    x = np.random.default_rng(0).standard_t(3, size=(7, 500))
    q = np.arange(1, 8) / 8.0
    want = np.asarray(jnp.quantile(jnp.asarray(x), jnp.asarray(q), axis=1)).T
    got = sim._row_quantiles(torch.as_tensor(x), sim._OCTILES).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(
        got, torch.quantile(torch.as_tensor(x), torch.as_tensor(q),
                            dim=1).T.numpy(), rtol=1e-12)


def test_mg1_departure_closed_form_matches_recursion():
    rng = np.random.default_rng(7)
    for _ in range(5):
        n = 64
        a = np.cumsum(rng.exponential(2.0, n))
        s = rng.uniform(0.5, 4.0, n)
        d_ref = np.empty(n)
        prev = 0.0
        for i in range(n):
            prev = s[i] + max(a[i], prev)
            d_ref[i] = prev
        d = sim.mg1_departure_times(torch.as_tensor(a), torch.as_tensor(s))
        np.testing.assert_allclose(d.numpy(), d_ref, rtol=1e-12)
        np.testing.assert_allclose(
            d.numpy(),
            np.asarray(jsim.mg1_departure_times(jnp.asarray(a),
                                                jnp.asarray(s))),
            rtol=1e-12)


def test_ma2_autocovariances_match_analytic():
    t1, t2 = 0.6, 0.2
    mets = _run(sim.make_ma2_simulator(n_obs=200_000),
                np.array([[t1, t2]]), np.array([11]))[0]
    np.testing.assert_allclose(
        mets, [1 + t1**2 + t2**2, t1 * (1 + t2), t2], atol=0.03)


def test_ricker_poisson_right_tail_clamps_to_grid_max():
    """A uniform past the 24-point grid's CDF gives 23, not 0."""
    noise = ArrayNoise(normals=np.zeros((2, 300)),
                       uniforms=np.stack([np.full(150, 1.0 - 1e-16),
                                          np.full(150, 0.5)]))
    p = torch.tensor([[1.0, 0.3, 9.0]] * 2, dtype=torch.float64)
    mets = sim.make_ricker_simulator().metrics_from_noise(p, noise).numpy()
    assert mets[0, 5] == 23.0 and mets[0, 4] == 0.0
    assert mets[1, 5] < 23.0


def test_all_builtins_resolve_from_config():
    for name, npar, nmet in (
        ("dice", 2, 2), ("gaussian", 2, 2), ("sir", 2, 6),
        ("linear_gaussian", 6, 13), ("lotka_volterra", 2, 16),
        ("seir_campaign", 5, 8), ("ricker", 3, 6), ("gk", 4, 8),
        ("mg1", 3, 8), ("ma2", 2, 3),
    ):
        raw = {
            "smc_iterations": 1, "num_samples": 8,
            "predictive_prior_size": 2, "simulator": name,
            "parameters": [
                {"name": f"p{i}", "dist_type": "UNIFORM",
                 "num_type": "FLOAT", "par1": 0.0, "par2": 1.0}
                for i in range(npar)],
            "metrics": [{"name": f"m{j}", "num_type": "FLOAT", "value": 0.1}
                        for j in range(nmet)],
        }
        s = sim.resolve_simulator(parse_config(raw))
        assert isinstance(s, sim.DeviceSimulator) and s.nmet == nmet
        mets = _run(s, np.full((3, npar), 0.5), np.array([1, 2, 3]))
        assert mets.shape == (3, nmet) and np.isfinite(mets).all()
    assert sorted(sim.BUILTIN_SIMULATORS) == sorted(jsim.BUILTIN_SIMULATORS)
    assert not hasattr(sim, "NOT_YET_PORTED")
    raw["simulator"] = "no_such_model"
    with pytest.raises(SimulatorError, match="unknown builtin"):
        sim.resolve_simulator(parse_config(raw))


FITS = sorted(p.name for p in (REPO / "examples").glob("*.json")
              if p.name != "pseudo.json")


@pytest.mark.parametrize("example", FITS)
def test_example_runs_through_run_device(example, tmp_path):
    """Every shipped fit, cut to 2 sets of 256 particles with a temporary
    store, runs the device path on the CPU."""
    cfg = json.loads((REPO / "examples" / example).read_text())
    cfg.update(smc_iterations=2, num_samples=256,
               database_filename=str(tmp_path / "run.sqlite"))
    cfg.pop("predictive_prior_size", None)
    cfg.setdefault("predictive_prior_fraction", 0.1)
    with redirect_stderr(io.StringIO()):
        run = AbcSmc(cfg, device="cpu").run_device(seed=3)
    gens = [e for e in run.timings if e["op"] == "device_generation"]
    assert len(gens) == 2
    assert all(e["ncomp_used"] >= 1 for e in gens)
    multivariate = cfg.get("noise") == "MULTIVARIATE"
    assert (gens[0]["mvn_rounds"] >= 1) == multivariate
    assert gens[1]["mvn_rounds"] == 0          # the last set proposes nothing
    pars, w = run.posterior()
    assert np.isfinite(pars).all() and np.isfinite(w).all()
    stored = run.storage.read_generations()
    run.storage.close()
    assert [g.size for g in stored] == [256, 256]
    assert all(g.complete and g.has_posterior for g in stored)
