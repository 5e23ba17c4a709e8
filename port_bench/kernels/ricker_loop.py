"""Roofline of the Ricker map's time loop (the builtin ``ricker``
simulator, ``models/simulators.py::make_ricker_simulator``): the least time
one H100 SXM could take for a set's loop, counted from the loop's equations
and the program's own counts of its row-steps: ``steps`` time steps a row
(``sim_steps``, burn-in included), ``observed`` of them after the burn-in,
``grid`` of those with a Poisson mean of at most 10 (``sim_grid_steps``,
the inverse CDF on the 24-point grid; the rest take the rounded normal).

The least time is the largest of three terms at the published 132 SMs and
1,980 MHz, 3.35 TB/s:

- special functions, at 16 a clock per SM:
  ``SFU_PER_ROW_STEP`` = 7 on every step (the two normals' log, sqrt and
  cos, the map's exp); ``SFU_PER_GRID_STEP`` = 25 on a grid step (the
  mean's log and the 24 terms' exp); ``SFU_PER_NORMAL_STEP`` = 1 on a
  normal step (the mean's sqrt); ``SFU_PER_ROW`` = 4 once a row (r's exp,
  the sd's sqrt, the two autocorrelations' divisions). The normals'
  Box-Muller is evaluated in float64 by the program; counting each of its
  functions as one special-function issue makes this term a lower bound of
  any implementation's;
- issue, FP32 and INT32 operations at 128 a clock per SM (four schedulers
  of 32 lanes): ``OPS_PER_ROW_STEP`` = 77 on every step (50 for the five
  murmur3 words of the two normals and the uniform, 18 for the normals'
  Box-Muller arithmetic, 3 for the uniform's scale and bound, 6 for the
  map's product, exponent and clamp); ``OPS_PER_GRID_STEP`` = 125 (the
  mean's clamps 2, the 24 terms' log-pmf 48, their running sum 23, the
  first index reaching u 48, the past-the-grid test and choice 2, the mean
  and the branch 2); ``OPS_PER_NORMAL_STEP`` = 6 (the mean, its normal
  draw's product, add, round and clamp, the branch); ``OPS_PER_OBSERVED``
  = 8 (the series' sum, the centred value, its square, the two lagged
  products, the zero test and its count, the maximum);
- bytes that any implementation must move: each row's parameters and seed
  read once and its metrics written once (``BYTES_PER_ROW`` = 3 x 4 + 8 +
  6 x 4). The population, the Poisson grid and the observed series are not
  counted: a loop fused into one kernel keeps them on the chip, and its
  statistics can be running sums.
"""

SMS = 132
SM_CLOCK_MHZ = 1980.0
SFU_PER_SM_CLOCK = 16
ISSUE_PER_SM_CLOCK = 128
HBM_BYTES_PER_S = 3.35e12
SFU_PER_ROW_STEP = 7
SFU_PER_GRID_STEP = 25
SFU_PER_NORMAL_STEP = 1
SFU_PER_ROW = 4
OPS_PER_ROW_STEP = 77
OPS_PER_GRID_STEP = 125
OPS_PER_NORMAL_STEP = 6
OPS_PER_OBSERVED = 8
BYTES_PER_ROW = 3 * 4 + 8 + 6 * 4


def terms_ms(steps: float, observed: float, grid: float, rows: int) -> dict:
    """The three terms, in ms, of ``rows`` rows that each ran ``steps``
    steps, ``observed`` of them observed and ``grid`` of those on the
    grid (each a count a row)."""
    per_ms = SMS * SM_CLOCK_MHZ * 1e3
    normal = observed - grid
    return {
        "sfu": (SFU_PER_ROW_STEP * steps + SFU_PER_GRID_STEP * grid
                + SFU_PER_NORMAL_STEP * normal + SFU_PER_ROW) * rows
        / (SFU_PER_SM_CLOCK * per_ms),
        "issue": (OPS_PER_ROW_STEP * steps + OPS_PER_GRID_STEP * grid
                  + OPS_PER_NORMAL_STEP * normal
                  + OPS_PER_OBSERVED * observed) * rows
        / (ISSUE_PER_SM_CLOCK * per_ms),
        "bytes": 1e3 * BYTES_PER_ROW * rows / HBM_BYTES_PER_S,
    }


def least_ms(steps: float, observed: float, grid: float, rows: int) -> float:
    return max(terms_ms(steps, observed, grid, rows).values())
