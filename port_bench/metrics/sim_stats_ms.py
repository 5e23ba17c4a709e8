"""Median over the window's eager sets of ``timings[*]["sim_stats_ms"]``:
the program's CUDA events around the simulator's row statistics after its
time loop (range ``abcsmc.sim.stats``; the ``ricker`` simulator's mean,
sd, autocorrelations, zeros and maximum of the observed series), in ms.
None on a replayed set, on the CPU, and in a program without the span."""

import numpy as np

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER, MOVES = "simulator", "particles_per_s"


def read(record):
    ms = [s["sim_stats_ms"] for f in record["fits"] for s in f["sets"]
          if s.get("sim_stats_ms") is not None]
    return float(np.median(ms)) if ms else None
