"""Median over the window's eager sets of ``timings[*]["weights_ms"]``: the
program's CUDA events around the step's ``abcsmc.step.weights`` stage (the
doubled variance, the weights through the kernel and their normalisation),
in ms. None on a replayed set, on the CPU, and in a program without the
stage."""

import numpy as np

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER, MOVES = "weight stage", "particles_per_s"


def read(record):
    ms = [s["weights_ms"] for f in record["fits"] for s in f["sets"]
          if s.get("weights_ms") is not None]
    return float(np.median(ms)) if ms else None
