"""Chunked row passes (``row_block``) and split propose of the port's
generation step, held against the JAX step with the same ``row_block`` forced
(ShardedGeneration on a 1-device mesh, JAX's own draws injected as in
tests/test_torch_step.py) and against the port's resident step.

Tolerances (float64): survivor indices and component counts identical;
distances, weights and doubled variance rtol 1e-8 against JAX (Gram and
moment sums run in another order) and rtol 1e-9 between the port's chunked
and resident passes (the blocks only reorder sums). A split proposal equals
the unsplit step's draw for draw, bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from abcsmc_tpu_torch.config import NoiseType
from abcsmc_tpu_torch.parallel.generation import Generation, StepDraws
from tests.test_torch_step import (
    KEEP, N, NMET, NPAR, _data, _pair, _skewed_data, jax_draws,
)


def _tt(x):
    return None if x is None else tuple(torch.as_tensor(a) for a in x)


def _jt(x):
    return None if x is None else tuple(jnp.asarray(a) for a in x)


def _assert_same_ranking(res, jres, rtol=1e-8):
    np.testing.assert_array_equal(res.survivor_idx.numpy(),
                                  np.asarray(jres.survivor_idx))
    assert int(res.ncomp_used) == int(jres.ncomp_used)
    np.testing.assert_allclose(res.distances.numpy(),
                               np.asarray(jres.distances), rtol=rtol)
    np.testing.assert_allclose(res.weights.numpy(), np.asarray(jres.weights),
                               rtol=rtol)
    np.testing.assert_allclose(res.doubled_variance.numpy(),
                               np.asarray(jres.doubled_variance), rtol=rtol)


# a dividing block (N = 400) and two that do not divide it
@pytest.mark.parametrize("row_block", [100, 96, 333])
@pytest.mark.parametrize("filter_type,optimal,first", [
    ("PLS", "vdv", False),
    ("PLS", "vdv", True),
    ("PLS", "tolerance", False),
    ("SIMPLE", "vdv", False),
])
def test_chunked_step_matches_jax_chunked_step(row_block, filter_type,
                                               optimal, first):
    params, mets, obs, prev = _data()
    prev = None if first else prev
    kw = dict(filter_type=filter_type, pls_optimal_method=optimal)
    jgen, gen = _pair(obs, np.float64, row_block=row_block, **kw)
    key = jax.random.PRNGKey(5)
    n_next = 300
    jres = jgen.step_precomputed(key, jnp.asarray(params), jnp.asarray(mets),
                                 KEEP, n_next, _jt(prev))
    draws = jax_draws(jgen, key, n_next)
    res = gen.step_precomputed(torch.as_tensor(params), torch.as_tensor(mets),
                               KEEP, n_next, draws, _tt(prev))
    assert gen.row_block_for(N) == row_block
    _assert_same_ranking(res, jres)
    assert (int(res.ncomp_used) > 0) == (filter_type == "PLS")
    np.testing.assert_allclose(res.next_params.numpy(),
                               np.asarray(jres.next_params), rtol=1e-10)
    np.testing.assert_array_equal(res.next_seeds.numpy(),
                                  np.asarray(jres.next_seeds, np.int64))
    # and the port's own resident passes
    _, resident = _pair(obs, np.float64, row_block=0, **kw)
    ref = resident.step_precomputed(torch.as_tensor(params),
                                    torch.as_tensor(mets), KEEP, n_next,
                                    draws, _tt(prev))
    assert resident.row_block_for(N) == 0
    _assert_same_ranking(res, ref, rtol=1e-9)
    np.testing.assert_array_equal(res.next_params.numpy(),
                                  ref.next_params.numpy())


@pytest.mark.parametrize("row_block", [100, 150])
@pytest.mark.parametrize("first", [False, True])
def test_chunked_box_cox_matches_jax_and_resident(row_block, first):
    params, mets, obs, prev = _skewed_data()
    prev = None if first else prev
    jgen, gen = _pair(obs, np.float64, box_cox=True, row_block=row_block)
    key = jax.random.PRNGKey(6)
    jres = jgen.step_precomputed(key, jnp.asarray(params), jnp.asarray(mets),
                                 KEEP, 0, _jt(prev))
    draws = jax_draws(jgen, key, 0)
    res = gen.step_precomputed(torch.as_tensor(params), torch.as_tensor(mets),
                               KEEP, 0, draws, _tt(prev))
    _assert_same_ranking(res, jres)
    _, resident = _pair(obs, np.float64, box_cox=True)
    ref = resident.step_precomputed(torch.as_tensor(params),
                                    torch.as_tensor(mets), KEEP, 0, draws,
                                    _tt(prev))
    np.testing.assert_array_equal(res.box_cox_lambdas.numpy(),
                                  ref.box_cox_lambdas.numpy())
    _assert_same_ranking(res, ref, rtol=1e-9)
    # stored and survivor metrics stay raw
    np.testing.assert_array_equal(res.survivor_metrics.numpy(),
                                  mets[res.survivor_idx.numpy()])


@pytest.mark.parametrize("box_cox", [False, True])
@pytest.mark.parametrize("row_block", [64, 150])
def test_chunked_step_masks_padding_rows(row_block, box_cox):
    """Padding rows (hostile ones: far away, non-positive under Box-Cox)
    reach no sum of a chunked pass, whichever block they fall into; the
    JAX chunked step on the same padded buffer agrees."""
    params, mets, obs, prev = _skewed_data() if box_cox else _data()
    pad = 37
    pp = np.concatenate([params, params[:pad] * 3.0])
    pm = np.concatenate([mets, -50.0 - np.abs(mets[:pad])])
    jgen, gen = _pair(obs, np.float64, row_block=row_block, box_cox=box_cox)
    key = jax.random.PRNGKey(3)
    draws = jax_draws(jgen, key, 0)
    got = gen.step_precomputed(torch.as_tensor(pp), torch.as_tensor(pm),
                               KEEP, 0, draws, _tt(prev), n_valid=N)
    ref = gen.step_precomputed(torch.as_tensor(params), torch.as_tensor(mets),
                               KEEP, 0, draws, _tt(prev))
    np.testing.assert_array_equal(got.survivor_idx.numpy(),
                                  ref.survivor_idx.numpy())
    assert int(got.ncomp_used) == int(ref.ncomp_used) > 0
    np.testing.assert_allclose(got.distances[:N].numpy(),
                               ref.distances.numpy(), rtol=1e-9)
    assert torch.isinf(got.distances[N:]).all()
    np.testing.assert_allclose(got.weights.numpy(), ref.weights.numpy(),
                               rtol=1e-9)
    # JAX pads to its mesh by itself: a 1-device mesh takes the unpadded
    # rows, and its chunked step with n_valid on the padded buffer agrees
    jres = jgen.step_precomputed(key, jnp.asarray(params), jnp.asarray(mets),
                                 KEEP, 0, _jt(prev))
    np.testing.assert_array_equal(got.survivor_idx.numpy(),
                                  np.asarray(jres.survivor_idx))
    np.testing.assert_allclose(got.weights.numpy(), np.asarray(jres.weights),
                               rtol=1e-8)


def test_chunked_step_holds_no_row_sized_intermediate(monkeypatch):
    """In chunked mode no product or Gram sees more than ``row_block``
    rows, apart from the raw inputs: every matmul operand of the ranking
    has at most row_block (or the van der Voet window's) rows."""
    params, mets, obs, prev = _data()
    _, gen = _pair(obs, np.float64, row_block=64)
    seen = []
    real = torch.Tensor.__matmul__

    def spy(a, b):
        seen.append(max(a.shape[0] if a.dim() == 2 else 0,
                        b.shape[0] if b.dim() == 2 else 0,
                        a.shape[-1], b.shape[-1]))
        return real(a, b)

    monkeypatch.setattr(torch.Tensor, "__matmul__", spy)
    d, _, _ = gen._rank_chunked([torch.as_tensor(params)],
                                [torch.as_tensor(mets)], N, _tt(prev),
                                torch.tensor(7), 64)
    monkeypatch.undo()
    assert d[0].shape == (N,)
    # the van der Voet window is min(n, 131,072) rows: here all N
    assert max(seen) == N and sorted(set(seen))[-2] <= 64


@pytest.mark.parametrize("noise", ["INDEPENDENT", "MULTIVARIATE"])
@pytest.mark.parametrize("method", ["multinomial", "systematic"])
@pytest.mark.parametrize("row_block", [0, 96])
def test_split_propose_equals_unsplit_step(noise, method, row_block):
    """rank -> propose as two calls with the step's own draws gives the
    unsplit step's proposal draw for draw, with the draws taken from one
    generator in the same order (the seed first, the proposal's after the
    ranking)."""
    params, mets, obs, prev = _data(truth=(0.05, 0.9, 18.0))
    kw = dict(noise_type=noise, resample_method=method, row_block=row_block)
    _, whole = _pair(obs, np.float64, **kw)
    _, split = _pair(obs, np.float64, propose_split=True, **kw)
    assert split.split_propose_active(N, 300)
    assert not split.split_propose_active(N, 0)
    assert not whole.split_propose_active(N, 300)     # auto is off on the CPU
    p, m, st = torch.as_tensor(params), torch.as_tensor(mets), _tt(prev)
    g1 = torch.Generator().manual_seed(12)
    ref = whole.step_precomputed(p, m, KEEP, 300, whole.draw_step(g1, 300),
                                 st)
    g2 = torch.Generator().manual_seed(12)
    d = split.draw_vdv_seed(g2)
    ranked = split.step_precomputed(p, m, KEEP, 0, d, st)
    assert ranked.next_params.shape == (0, NPAR)
    nxt, seeds, rounds = split.propose(
        ranked.survivor_params, ranked.weights, ranked.doubled_variance, 300,
        split.draw_proposal(g2, 300, d))
    np.testing.assert_array_equal(ranked.survivor_idx.numpy(),
                                  ref.survivor_idx.numpy())
    np.testing.assert_array_equal(nxt.numpy(), ref.next_params.numpy())
    np.testing.assert_array_equal(seeds.numpy(), ref.next_seeds.numpy())
    assert rounds == ref.mvn_rounds
    assert (rounds > 0) == (noise == "MULTIVARIATE")
    # both generators end in the same state
    assert torch.equal(g1.get_state(), g2.get_state())


def test_split_propose_matches_jax_propose():
    """JAX's own split phase (ShardedGeneration.propose with the step key)
    against the port's, on JAX's draws."""
    params, mets, obs, prev = _data()
    jgen, gen = _pair(obs, np.float64, propose_split=True)
    key = jax.random.PRNGKey(4)
    jres = jgen.step_precomputed(key, jnp.asarray(params), jnp.asarray(mets),
                                 KEEP, 250, _jt(prev))
    draws = jax_draws(jgen, key, 250)
    ranked = gen.step_precomputed(torch.as_tensor(params),
                                  torch.as_tensor(mets), KEEP, 0, draws,
                                  _tt(prev))
    nxt, seeds, _ = gen.propose(ranked.survivor_params, ranked.weights,
                                ranked.doubled_variance, 250, draws)
    np.testing.assert_allclose(nxt.numpy(), np.asarray(jres.next_params),
                               rtol=1e-10)
    np.testing.assert_array_equal(seeds.numpy(),
                                  np.asarray(jres.next_seeds, np.int64))


def test_chunked_proposal_equals_whole_proposal():
    """With row_block the INDEPENDENT perturbation runs block by block (a
    row's draw depends on its own uniforms alone): the same bits."""
    params, mets, obs, prev = _data()
    for method in ("multinomial", "systematic"):
        _, a = _pair(obs, np.float64, row_block=0, resample_method=method)
        _, b = _pair(obs, np.float64, row_block=70, resample_method=method)
        a.sorted_pick_min = b.sorted_pick_min = 64   # the big-N pick too
        draws = a.draw_step(torch.Generator().manual_seed(2), 300)
        w = torch.as_tensor(prev[1])
        args = (torch.as_tensor(prev[0]), w, torch.as_tensor(prev[2]), 300,
                draws)
        np.testing.assert_array_equal(a.propose(*args)[0].numpy(),
                                      b.propose(*args)[0].numpy())


def test_row_block_and_split_arguments():
    params, mets, obs, prev = _data()
    with pytest.raises(ValueError, match="row_block"):
        _pair(obs, np.float64, row_block=-1)
    _, gen = _pair(obs, np.float64)
    # on the CPU both auto rules are off, whatever the size
    assert gen.row_chunk_threshold is None and gen.split_threshold is None
    assert gen.row_block_for(1 << 40) == 0
    assert not gen.split_propose_active(1 << 40, 1 << 40)
    _, forced = _pair(obs, np.float64, row_block=1 << 21, propose_split=False,
                      topk_two_stage=True)
    assert forced.row_block_for(N) == N          # the block is cut to n
    assert not forced.split_propose_active(1 << 40, 1 << 40)
    assert forced.topk_two_stage is True
    # the bytes-per-row model: a chunked row is the raw inputs and little
    # more, a resident row several times that
    assert gen.chunked_row_bytes() < gen.resident_row_bytes() / 3
    assert gen.propose_row_bytes() < gen.resident_row_bytes() / 2
    assert not gen.capturable                    # no CUDA device here
    assert gen.noise_type == NoiseType.INDEPENDENT
    assert isinstance(gen.draw_vdv_seed(torch.Generator().manual_seed(0)),
                      StepDraws)


@pytest.mark.parametrize("value", [True, False, None])
def test_topk_two_stage_changes_nothing_on_one_device(value):
    params, mets, obs, prev = _data()
    jgen, gen = _pair(obs, np.float64, topk_two_stage=value)
    key = jax.random.PRNGKey(9)
    jres = jgen.step_precomputed(key, jnp.asarray(params), jnp.asarray(mets),
                                 KEEP, 0, _jt(prev))
    res = gen.step_precomputed(torch.as_tensor(params), torch.as_tensor(mets),
                               KEEP, 0, jax_draws(jgen, key, 0), _tt(prev))
    _assert_same_ranking(res, jres)
    assert isinstance(gen, Generation) and NMET == len(obs)
