"""Faults planted in the program under test, to show that the comparison
catches them (``port_bench/control.py`` on the card, the tests on the CPU).
Each is a context manager that patches a method of the generation step and
restores it on exit:

- ``unchanged``: every step returns its own population as the next one
  (a step that leaves its state unchanged);
- ``half``: the ranking sees only the first half of each set's rows (the
  second half's distances are infinite);
- ``altered``: one metric of one particle is altered where the simulator
  produces it;
- ``ncomp``: the ranking uses one PLS component, whatever the van der Voet
  test chose;
- ``store``: the in-memory run store writes one particle's metric wrong.

A cell on one card has no exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib

FAULTS = ("unchanged", "half", "altered", "ncomp", "store")


@contextlib.contextmanager
def planted(name: str):
    import numpy as np
    import torch

    from abcsmc_tpu_torch.parallel.generation import Generation
    from abcsmc_tpu_torch.storage.memstore import MemoryStorage

    cls = Generation
    if name == "unchanged":
        attr = "_finish"
        orig = Generation._finish

        def patched(self, params, *args, **kwargs):
            res = orig(self, params, *args, **kwargs)
            if sum(p.shape[0] for p in res.next_params) == \
                    sum(p.shape[0] for p in params):
                res.next_params = [p.clone() for p in params]
            return res
    elif name == "half":
        attr = "_rank_resident"
        orig = Generation._rank_resident

        def patched(self, params, *args, **kwargs):
            d, ncomp, lambdas = orig(self, params, *args, **kwargs)
            out = []
            for x in d:
                x = x.clone()
                x[x.shape[0] // 2:] = float("inf")
                out.append(x)
            return out, ncomp, lambdas
    elif name == "altered":
        attr = "_simulate"
        orig = Generation._simulate

        def patched(self, params, seeds):
            mets = orig(self, params, seeds)
            mets[0][0, 0] += 1.0
            return mets
    elif name == "ncomp":
        attr = "_select"
        orig = Generation._select

        def patched(self, *args, **kwargs):
            report, mask = orig(self, *args, **kwargs)
            mask = torch.zeros_like(mask)
            mask[:, 0] = 1
            return torch.ones_like(report), mask
    elif name == "store":
        cls, attr = MemoryStorage, "write_results"
        orig = MemoryStorage.write_results

        def patched(self, serials, metrics, *args, **kwargs):
            metrics = np.array(metrics, np.float64)
            metrics[0, 0] += 1.0
            return orig(self, serials, metrics, *args, **kwargs)
    else:
        raise ValueError(f"unknown fault {name!r}; known: {FAULTS}")
    setattr(cls, attr, patched)
    try:
        yield
    finally:
        setattr(cls, attr, orig)
