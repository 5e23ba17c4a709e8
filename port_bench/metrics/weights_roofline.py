"""The weight kernel's share of its roofline over the traced fits, in
percent: the least time the card could take for every call's work,
counted from each call's shapes alone (``kernels/weights.py``), over the
summed device time of the kernel's launches, matched by name in the
profiler trace. Nothing is read where the trace holds a different number
of the kernel's launches than the program's own launch counter, or none."""

from port_bench import registry

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER, MOVES = "weight kernel", "particles_per_s"


def read(record):
    t = record["trace"]
    if t is None:
        return None
    k = registry.kernel("weights")
    calls = k.calls(record)
    device_s = t.kernel_seconds(k.NAMES)
    if not calls or device_s <= 0:
        return None
    if t.kernel_count(k.NAMES) != record["traced_weight_launches"]:
        return None
    least_s = sum(k.least_ms(*c) for c in calls) * 1e-3
    return 100.0 * least_s / device_s
