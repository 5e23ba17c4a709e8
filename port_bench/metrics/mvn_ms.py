"""Median over the window's eager sets of ``timings[*]["mvn_ms"]``: the
program's CUDA events around the step's ``abcsmc.step.mvn`` stage (the
MULTIVARIATE proposal's survivor covariance, doubled diagonal, Cholesky
factor and first block of rejection rounds), in ms. None on a replayed
set, on the CPU, with INDEPENDENT noise and in a program without the
stage."""

import numpy as np

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER, MOVES = "proposal", "particles_per_s"


def read(record):
    ms = [s["mvn_ms"] for f in record["fits"] for s in f["sets"]
          if s.get("mvn_ms") is not None]
    return float(np.median(ms)) if ms else None
