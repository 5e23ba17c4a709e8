"""Rows the window's fits wrote to their run store per second of the
program's ``abcsmc.store.<method>`` spans (host clock): the sum of
``run_device_phases.store_rows`` over the sum of ``store_s``. Nothing is
read from a program without the spans, or where no row was written."""

UNIT, BETTER, SOURCE = "rows/s", "higher", "program_span"
LAYER, MOVES = "run store", "particles_per_s"


def read(record):
    phases = [f["phases"] for f in record["fits"]]
    if not phases or any("store_s" not in p for p in phases):
        return None
    rows = sum(p["store_rows"] for p in phases)
    seconds = sum(p["store_s"] for p in phases)
    return rows / seconds if rows and seconds > 0 else None
