"""Median over the window's eager sets of ``timings[*]["pls_fit_ms"]``: the
program's CUDA events around the step's ``abcsmc.step.pls_fit`` stage (the
PLS fit: metric and parameter moments, the training Grams, the components
and the held-out PRESS), in ms. None on a replayed set, on the CPU, and in a
program without the stage."""

import numpy as np

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER, MOVES = "PLS fit", "particles_per_s"


def read(record):
    ms = [s["pls_fit_ms"] for f in record["fits"] for s in f["sets"]
          if s.get("pls_fit_ms") is not None]
    return float(np.median(ms)) if ms else None
