"""Sum over the window's fits of ``run_device_phases.replay_s`` (host
clock, the program's ``abcsmc.replay`` spans: a replayed set's copies into
the graph's inputs, the replay, and the read of its MULTIVARIATE count with
any eager finish of its rounds) per replayed set (``graph_replays``), in
ms. Nothing is read from a program without the span, or where no set was
replayed."""

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER, MOVES = "fused dispatch", "particles_per_s"


def read(record):
    phases = [f["phases"] for f in record["fits"]]
    if not phases or any("replay_s" not in p for p in phases):
        return None
    replays = sum(p["graph_replays"] for p in phases)
    if not replays:
        return None
    return 1e3 * sum(p["replay_s"] for p in phases) / replays
