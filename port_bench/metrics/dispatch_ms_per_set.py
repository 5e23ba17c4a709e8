"""Sum over the window's fits of ``run_device_phases.dispatch_s`` (host
clock: submitting the sets' steps, graph capture included) per set, in
ms."""

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER, MOVES = "fused dispatch", "particles_per_s"


def read(record):
    sets = sum(f["phases"]["sets"] for f in record["fits"])
    if not sets:
        return None
    return 1e3 * sum(f["phases"]["dispatch_s"] for f in record["fits"]) / sets
