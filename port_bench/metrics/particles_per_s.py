"""Particles taken through whole SMC sets per second of the window: every
fit's sets times their particles, over the window's wall time (host
clock), set-up excluded. A particle is simulated, ranked, weighed,
proposed and written to the cell's run store."""

UNIT, BETTER, SOURCE = "particles/s", "higher", "host_clock"


def read(record):
    if not record["fits"]:
        return None
    return sum(f["particles"] for f in record["fits"]) / record["window_s"]
