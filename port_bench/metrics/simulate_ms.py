"""Median over the window's eager sets of ``timings[*]["simulate_ms"]``:
the program's CUDA events around the simulate stage (None on a replayed
set), in ms."""

import numpy as np

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER, MOVES = "simulator", "particles_per_s"


def read(record):
    ms = [s["simulate_ms"] for f in record["fits"] for s in f["sets"]
          if s.get("simulate_ms") is not None]
    return float(np.median(ms)) if ms else None
