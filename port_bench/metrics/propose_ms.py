"""Median over the window's eager sets of ``timings[*]["propose_ms"]``: the
program's CUDA events around the step's ``abcsmc.step.propose`` stage (the
weighted resample and the perturbation of the next set), in ms. None on a
replayed set, on the CPU, and in a program without the stage."""

import numpy as np

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER, MOVES = "proposal", "particles_per_s"


def read(record):
    ms = [s["propose_ms"] for f in record["fits"] for s in f["sets"]
          if s.get("propose_ms") is not None]
    return float(np.median(ms)) if ms else None
