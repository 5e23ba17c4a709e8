"""Sum over the window's fits of ``run_device_phases.report_s`` (host
clock, the program's ``abcsmc.report.filtering`` spans, one a set, and its
``abcsmc.report.convergence`` span, one a fit) per set, in ms. Nothing is
read from a program without the spans."""

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER, MOVES = "reports", "particles_per_s"


def read(record):
    phases = [f["phases"] for f in record["fits"]]
    sets = sum(p["sets"] for p in phases)
    if not sets or any("report_s" not in p for p in phases):
        return None
    return 1e3 * sum(p["report_s"] for p in phases) / sets
