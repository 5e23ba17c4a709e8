"""Roofline of the chain-binomial SIR time loop (the builtin ``sir``
simulator, ``models/simulators.py::make_sir_simulator``): the least time
one H100 SXM could take for ``steps`` daily steps over ``rows`` particles,
counted from the loop's equations alone.

A step of a row draws two counter-hash normals and two binomials and
updates its state. The least time is the largest of three terms at the
published 132 SMs and 1,980 MHz, 3.35 TB/s:

- special functions: ``SFU_PER_ROW_STEP`` = 9 (each normal's log, sqrt and
  cos, each binomial's sqrt, the infection probability's exp), plus
  ``SFU_PER_ROW`` = 2 once a row (the recovery probability's exp, the mean
  day's division), at 16 a clock per SM. The normals' Box-Muller is
  evaluated in float64 by the program; counting each of its functions as
  one special-function issue makes this term a lower bound of any
  implementation's;
- issue: ``OPS_PER_ROW_STEP`` = 88 FP32 and INT32 operations (40 for the
  four murmur3 words of the two normals, 18 for their Box-Muller
  arithmetic, 3 for the infection probability, 16 for the two binomials'
  mean, variance, round and clip, 11 for the compartments, the peak, the
  days infected and the incidence sums), at 128 a clock per SM (four
  schedulers of 32 lanes);
- bytes that any implementation must move: each row's parameters and seed
  read once and its metrics written once (``BYTES_PER_ROW`` = 2 x 4 + 8 +
  6 x 4). The per-step state and the incidence series are not counted: a
  loop fused into one kernel keeps them on the chip.
"""

SMS = 132
SM_CLOCK_MHZ = 1980.0
SFU_PER_SM_CLOCK = 16
ISSUE_PER_SM_CLOCK = 128
HBM_BYTES_PER_S = 3.35e12
SFU_PER_ROW_STEP = 9
SFU_PER_ROW = 2
OPS_PER_ROW_STEP = 88
BYTES_PER_ROW = 2 * 4 + 8 + 6 * 4


def terms_ms(steps: float, rows: int) -> dict:
    per_ms = SMS * SM_CLOCK_MHZ * 1e3
    return {
        "sfu": (SFU_PER_ROW_STEP * steps + SFU_PER_ROW) * rows
        / (SFU_PER_SM_CLOCK * per_ms),
        "issue": OPS_PER_ROW_STEP * steps * rows
        / (ISSUE_PER_SM_CLOCK * per_ms),
        "bytes": 1e3 * BYTES_PER_ROW * rows / HBM_BYTES_PER_S,
    }


def least_ms(steps: float, rows: int) -> float:
    return max(terms_ms(steps, rows).values())
