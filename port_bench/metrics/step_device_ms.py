"""Median over the window's sets of ``timings[*]["device_ms"]``: the
program's CUDA events around each set's eager step or graph replay, in
ms."""

import numpy as np

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER, MOVES = "generation step", "particles_per_s"


def read(record):
    ms = [s["device_ms"] for f in record["fits"] for s in f["sets"]
          if s.get("device_ms") is not None]
    return float(np.median(ms)) if ms else None
