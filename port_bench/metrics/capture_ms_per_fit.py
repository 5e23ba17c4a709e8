"""Mean over the window's fits of ``run_device_phases.capture_s`` (host
clock, the program's ``abcsmc.capture`` spans: recording the step into a
CUDA graph, once per shape a fit), in ms. Read only from a program that
names its captures and replays (its phases carry ``replay_s``), and where
a fit captured."""

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER, MOVES = "fused dispatch", "particles_per_s"


def read(record):
    phases = [f["phases"] for f in record["fits"]]
    if not phases or any("replay_s" not in p for p in phases):
        return None
    if not any(p["graph_captures"] for p in phases):
        return None
    return 1e3 * sum(p["capture_s"] for p in phases) / len(phases)
