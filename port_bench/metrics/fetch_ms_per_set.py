"""Sum over the window's fits of ``run_device_phases.fetch_s`` (host clock,
the program's ``abcsmc.fetch`` spans: each set's leaves copied from the
card, widened to float64 and appended to the posterior state) per set, in
ms. Nothing is read from a program without the span."""

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER, MOVES = "fetch", "particles_per_s"


def read(record):
    phases = [f["phases"] for f in record["fits"]]
    sets = sum(p["sets"] for p in phases)
    if not sets or any("fetch_s" not in p for p in phases):
        return None
    return 1e3 * sum(p["fetch_s"] for p in phases) / sets
