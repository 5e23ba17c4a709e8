"""Median over the window's eager sets of ``timings[*]["vdv_ms"]``: the
program's CUDA events around the step's ``abcsmc.step.vdv`` stage (the
component count chosen by van der Voet's test), in ms. None on a
replayed set, on the CPU, and in a program without the stage."""

import numpy as np

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER, MOVES = "van der Voet", "particles_per_s"


def read(record):
    ms = [s["vdv_ms"] for f in record["fits"] for s in f["sets"]
          if s.get("vdv_ms") is not None]
    return float(np.median(ms)) if ms else None
