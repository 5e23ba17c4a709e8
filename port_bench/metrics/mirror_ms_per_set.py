"""Sum over the window's fits of ``run_device_phases.mirror_s`` (host
clock: each set fetched from the card once and written to the run store)
per set, in ms."""

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER, MOVES = "run store", "particles_per_s"


def read(record):
    sets = sum(f["phases"]["sets"] for f in record["fits"])
    if not sets:
        return None
    return 1e3 * sum(f["phases"]["mirror_s"] for f in record["fits"]) / sets
