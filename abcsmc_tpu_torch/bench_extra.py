"""The extended benchmark sweep on the card (port of the JAX repo's
``bench_extra.py``; informational, the tracked line is
:mod:`abcsmc_tpu_torch.bench`). One JSON line per measurement, ``unit``
"ms", in the JAX order:

- PLS fit, 1,000 rows x 100 metrics, 10 components (``pls._fit_arrays``);
- the weight kernel (``ops.kernels.mixture_logsumexp`` on
  ``weights._prep_scaled`` inputs) at 10,000^2, 50,000^2 and 200,000^2 x 6;
  under ``--device cpu`` that call runs its plain version and the line
  says so;
- the inverse-CDF resample of 1M from 50k, with the step's own pick
  (sorted uniforms by exponential spacings, ``generation._cumsum`` and
  ``_sorted_searchsorted``);
- the generation step at 100,000 and 1,000,000 particles, keep n / 20,
  the linear-Gaussian 6 x 13 simulator (the shipped JAX mixing matrix),
  with the simulator excluded (``step_precomputed``) and included
  (``step``), each with ``particles_per_sec``; the generations run on
  one card, or on a mesh over the visible cards when there are more.

    python -m abcsmc_tpu_torch.bench_extra [--device cuda|cpu]

Every time is wall seconds around a call with the card synchronised, the
best of 5 after one warm-up (``bench_extra.py``'s ``timeit``). The data
come from one ``np.random.default_rng(0)`` drawn in the JAX order; the
draws from a ``torch.Generator`` seeded 0. ``--kernel-k`` and
``--gen-n`` set the kernel's and the generations' sizes for small runs;
every label carries its sizes. No CUDA and no ``--device cpu``: exit 2.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from abcsmc_tpu_torch.bench import best_of, devices_label, mesh_devices
from abcsmc_tpu_torch.parallel.generation import (
    _cumsum, _sorted_searchsorted,
)
from abcsmc_tpu_torch.tools._common import (
    generation, needs_cuda, step_generator, unit_box_config,
)

NPAR, NMET = 6, 13


def timeit(fn, devices, reps: int = 5) -> float:
    """Best wall seconds of ``reps`` calls after one warm-up call."""
    fn()
    return best_of(fn, devices, reps)[0]


def emit(metric: str, seconds: float, **extra):
    print(json.dumps({"metric": metric, "value": seconds * 1000,
                      "unit": "ms", **extra}), flush=True)


def sorted_queries(n: int, total, generator: torch.Generator, dtype):
    """``n`` ascending uniforms on [0, total): exponential spacings,
    u_(i) = S_i / S_{n+1} * total, as the step's pick draws them."""
    e = torch.empty((n + 1,), dtype=dtype, device=generator.device)
    s = _cumsum(e.exponential_(generator=generator))
    return (s[:-1] / s[-1]) * total


def resample(w, n: int, generator: torch.Generator):
    """(indices [n] into ``w``, the sorted queries): ``n`` weighted draws
    by the inverse CDF."""
    cdf = _cumsum(w)
    u = sorted_queries(n, cdf[-1], generator, w.dtype)
    return _sorted_searchsorted(cdf, u, n), u


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m abcsmc_tpu_torch.bench_extra",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default), cuda:N or cpu; no fallback")
    ap.add_argument("--kernel-k", default="10000,50000,200000",
                    help="comma-separated k of the k x k x 6 kernel lines")
    ap.add_argument("--gen-n", default="100000,1000000",
                    help="comma-separated populations of the generation "
                         "lines (keep n / 20)")
    return ap


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    if needs_cuda(args.device, "abcsmc_tpu_torch.bench_extra"):
        return 2
    from abcsmc_tpu_torch import resolve_device
    from abcsmc_tpu_torch.models.simulators import (
        make_linear_gaussian_simulator,
    )
    from abcsmc_tpu_torch.ops import pls
    from abcsmc_tpu_torch.ops.kernels import mixture_logsumexp
    from abcsmc_tpu_torch.ops.weights import _prep_scaled

    device = resolve_device(args.device)
    on = [device]
    f32 = dict(dtype=torch.float32, device=device)
    rng = np.random.default_rng(0)
    g = torch.Generator(device=device).manual_seed(0)

    # --- PLS fit: the BASELINE.md tracked shape ---
    x = torch.as_tensor(rng.normal(size=(1000, 100)), **f32)
    y = torch.as_tensor(rng.normal(size=(1000, 10)), **f32)
    emit("PLS fit 1k x 100 mets, 10 comps",
         timeit(lambda: pls._fit_arrays(x, y, 10), on))

    # --- weight kernel ---
    route = ("CUDA" if device.type == "cuda"
             else "plain PyTorch version, cpu")
    for k in (int(v) for v in args.kernel_k.split(",") if v):
        prev = torch.as_tensor(rng.uniform(0.3, 0.7, (k, NPAR)), **f32)
        w = torch.full((k,), 1.0 / k, **f32)
        dv = torch.full((NPAR,), 0.02, **f32)
        a, b, _ = _prep_scaled(prev, prev, dv)
        a, b, lw = a.contiguous(), b.contiguous(), torch.log(w)
        # 3xTF32, the config default's scheme
        emit(f"mixture-weight kernel ({route}) {k}x{k}",
             timeit(lambda: mixture_logsumexp(a, b, lw, precision="high"),
                    on))
        del prev, a, b, lw

    # --- resample ---
    w = torch.as_tensor(rng.uniform(0.5, 1.5, 50_000), **f32)
    emit("inverse-CDF resample 1M from 50k",
         timeit(lambda: resample(w, 1_000_000, g), on))

    # --- full generations ---
    devices = mesh_devices(device, None)
    sim = make_linear_gaussian_simulator(NPAR, NMET)
    for n in (int(v) for v in args.gen_n.split(",") if v):
        n -= n % len(devices)
        keep = n // 20
        gen = generation(
            unit_box_config(n, keep, [0.0] * NMET, npar=NPAR), sim, devices)
        params = gen.shard_rows(torch.as_tensor(
            rng.uniform(0, 1, (n, NPAR)), dtype=torch.float32), n)
        seeds = gen.shard_rows(torch.as_tensor(
            rng.integers(0, 2**31, n, dtype=np.int64).astype(np.uint32)
            .astype(np.int64)), n)
        mets = gen.shard_rows(torch.as_tensor(
            rng.normal(size=(n, NMET)), dtype=torch.float32), n)
        state = (
            torch.as_tensor(rng.uniform(0.3, 0.7, (keep, NPAR)),
                            dtype=torch.float32, device=gen.device),
            torch.full((keep,), 1.0 / keep, dtype=torch.float32,
                       device=gen.device),
            torch.full((NPAR,), 0.02, dtype=torch.float32,
                       device=gen.device),
        )
        gg = step_generator(gen)
        where = devices_label(devices)
        t = timeit(lambda: gen.step_precomputed(
            params, mets, keep, n, gen.draw_step(gg, n), state), devices)
        emit(f"SMC generation {n} particles (sim excluded), {where}", t,
             particles_per_sec=round(n / t))
        t = timeit(lambda: gen.step(
            params, seeds, keep, n, gen.draw_step(gg, n), state), devices)
        emit(f"SMC generation {n} particles (sim included), {where}", t,
             particles_per_sec=round(n / t))
        del gen, params, seeds, mets, state
    return 0


if __name__ == "__main__":
    sys.exit(main())
