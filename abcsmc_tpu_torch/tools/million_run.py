"""A 1M-particle multi-generation SMC run on the particle mesh, with the
time of each generation and its survivors against the truth (port of
examples/million_run.py).

    python -m abcsmc_tpu_torch.tools.million_run [--n 1000000] [--sets 3]

6 parameters x 13 metrics, the linear-Gaussian device simulator with noise
sd 0.1 observed at a truth drawn from ``numpy.random.default_rng(42)``,
keep n / 20, through ``Generation.init_population`` and ``Generation.step``
on ``particle_mesh()`` (every visible card; ``--device`` alone on the CPU).
One JSON line per set: CUDA-event milliseconds around the step (set 0
includes the kernel's first load), particles/s, the mean abs error of the
survivors' mean against the truth and ``ncomp_used``; then the truth and
the last posterior mean.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from abcsmc_tpu_torch.tools import _common

NPAR, NMET = 6, 13


def main(argv=None) -> int:
    ap = _common.parser(__doc__, dtype=True)
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--sets", type=int, default=3)
    args = ap.parse_args(argv)
    st = _common.start("million_run", args)
    if st is None:
        return 2
    from abcsmc_tpu_torch.models.simulators import (
        make_linear_gaussian_simulator,
    )
    from abcsmc_tpu_torch.parallel.mesh import particle_mesh

    mesh = particle_mesh(None if st.on_card else [st.device])
    n = args.n - args.n % mesh.size
    keep = n // 20
    truth = np.random.default_rng(42).uniform(0.2, 0.8, NPAR)
    sim = make_linear_gaussian_simulator(NPAR, NMET, noise_sd=0.1)
    obs = sim.run_batch(truth[None, :], np.array([7]), np.array([0]),
                        device=st.device, dtype=st.dtype)[0]
    gen = _common.generation(
        _common.unit_box_config(n, keep, obs, npar=NPAR, sets=args.sets),
        sim, [st.device], st.dtype, mesh=mesh)
    g = st.generator
    params, seeds = gen.init_population(g, n)
    state = None
    for t in range(args.sets):
        draws = gen.draw_step(g, n)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)] \
            if st.on_card else None
        if ev:
            ev[0].record()
        res = gen.step(params, seeds, keep, n, draws, state)
        if ev:
            ev[1].record()
        st.sync()
        ms = ev[0].elapsed_time(ev[1]) if ev else None
        surv = res.survivor_params.double().cpu().numpy()
        st.emit({
            "set": t, "label": "first use + run" if t == 0 else "run",
            "ms": ms, "n": n, "keep": keep, "devices": mesh.size,
            "particles_per_sec": None if ms is None else n / (ms * 1e-3),
            "mean_abs_survivor_err": float(
                np.abs(surv.mean(0) - truth).mean()),
            "ncomp_used": int(res.ncomp_used)})
        state = (res.survivor_params, res.weights, res.doubled_variance)
        params, seeds = res.next_params, res.next_seeds
        del res
    st.emit({"truth": truth.tolist(), "posterior": surv.mean(0).tolist()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
