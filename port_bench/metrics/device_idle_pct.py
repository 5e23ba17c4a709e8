"""Share of the traced window in which no kernel, copy or memset ran on
the card (``torch.profiler``, CUPTI), in percent."""

UNIT, BETTER, SOURCE = "%", "lower", "device_trace"
LAYER, MOVES = "device", "particles_per_s"


def read(record):
    t = record["trace"]
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
