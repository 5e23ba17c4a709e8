"""The port's entry points (``abcsmc_tpu_torch.graft_entry``) on the
CPU, beside the JAX repo's ``__graft_entry__``.

- ``entry("cpu")``'s ``fn`` on its example args gives JAX ``entry()``'s
  output shapes and dtypes, finite values and, in a first generation, the
  same uniform weights. The survivors agree in law only: the port's dice
  noise is a counter hash, not threefry;
- ``dryrun_multichip(n, device="cpu")`` passes its whole matrix on an
  n-shard CPU mesh (the two-process gloo engine run included) and prints
  one OK line per case.
"""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from abcsmc_tpu_torch import graft_entry


def test_entry_matches_jax_entry_shapes():
    fn, args = graft_entry.entry("cpu")
    out = fn(*args)
    jfn, jargs = jentry.entry()
    jout = jax.jit(jfn)(*jargs)
    assert len(out) == len(jout) == 3
    for got, want in zip(out, jout):
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape
        assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
        assert bool(torch.isfinite(got).all())
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(jout[1]))
    # survivors are dice parameters inside the prior box
    surv = out[0].numpy()
    assert surv.min() >= 1 and surv.max() <= 100


@pytest.mark.parametrize("n_devices", [1, 4])
def test_dryrun_multichip_on_cpu(n_devices, capsys):
    lines = graft_entry.dryrun_multichip(n_devices, device="cpu")
    out = capsys.readouterr().out.splitlines()
    cases = graft_entry.dryrun_cases(n_devices)
    assert len(lines) == len(cases) + 4
    assert out[-1] == f"dryrun_multichip({n_devices}): OK - all variants"
    assert all(f"dryrun_multichip({n_devices}): OK - " in x for x in lines)
    assert (n_devices >= 2) == any("bend" in label for label, *_ in cases)
    assert "288 rows" in lines[-1]
