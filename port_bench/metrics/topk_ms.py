"""Median over the window's eager sets of ``timings[*]["topk_ms"]``: the
program's CUDA events around the step's ``abcsmc.step.topk`` stage (the
distances of every row and the global top-K), in ms. None on a replayed set,
on the CPU, and in a program without the stage."""

import numpy as np

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER, MOVES = "top-K", "particles_per_s"


def read(record):
    ms = [s["topk_ms"] for f in record["fits"] for s in f["sets"]
          if s.get("topk_ms") is not None]
    return float(np.median(ms)) if ms else None
