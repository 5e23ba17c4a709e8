"""Reduction of a ``torch.profiler`` trace of the window to what the
metrics read: the seconds in which an operation ran on the device, device
time by kernel name, and the idle gaps between device operations labelled
by what the host was doing (the innermost host event that covers the
gap's middle: an ATen op, or one of the harness's ``port_bench.*`` spans
around the calls into the program)."""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field

WINDOW_SPAN = "port_bench.window"
_DEVICE_KINDS = ("kernel", "memcpy", "memset")
#: gaps shorter than this are launch spacing, not idle time worth a label
_GAP_LABEL_MIN_NS = 20_000
_LABEL_SCAN = 4096


def _call(e, method, default=None):
    """``e.method()`` where this torch's event has it (the kineto event's
    methods differ between releases), else ``default``."""
    f = getattr(e, method, None)
    return f() if f is not None else default


def _span_ns(e):
    start = _call(e, "start_ns")
    if start is None:
        return int(e.start_us() * 1000), int(e.duration_us() * 1000)
    return start, _call(e, "duration_ns")


def _side(e) -> str:
    return str(e.device_type()).split(".")[-1]


def _is_device_op(e) -> bool:
    """A kernel, copy or memset on the card: a CUDA-side event that is not
    the device-side shadow of a ``record_function`` span."""
    if _side(e) != "CUDA":
        return False
    if _call(e, "is_user_annotation", False) \
            or e.name().startswith("port_bench."):
        return False
    kind = _call(e, "activity_type")
    return kind is None or any(k in str(kind).lower() for k in _DEVICE_KINDS)


@dataclass
class TraceData:
    window_s: float
    busy_s: float
    device_ops: list = field(default_factory=list)   # [(name, seconds)]
    idle_gaps: list = field(default_factory=list)    # [(label, seconds)]
    by_name: dict = field(default_factory=dict)      # kernel name -> seconds
    count_by_name: dict = field(default_factory=dict)  # kernel name -> ops

    def kernel_seconds(self, names) -> float:
        """Summed device seconds of the operations whose name contains any
        of ``names``."""
        return sum(s for n, s in self.by_name.items()
                   if any(k in n for k in names))

    def kernel_count(self, names) -> int:
        """Device operations whose name contains any of ``names``."""
        return sum(c for n, c in self.count_by_name.items()
                   if any(k in n for k in names))


def reduce(prof) -> TraceData | None:
    """The window's numbers from a stopped profiler, or None when the trace
    holds no device operation or no window span."""
    events = prof.profiler.kineto_results.events()
    window = None
    dev, host = [], []
    for e in events:
        if _is_device_op(e):
            start, dur = _span_ns(e)
            if dur > 0:
                dev.append((start, start + dur, e.name()))
        elif _side(e) == "CPU":
            start, dur = _span_ns(e)
            if e.name() == WINDOW_SPAN:
                window = (start, start + dur)
            elif dur > 0:
                host.append((start, start + dur, e.name()))
    if window is None or not dev:
        return None
    w0, w1 = window
    dev = sorted((max(a, w0), min(b, w1), n) for a, b, n in dev
                 if b > w0 and a < w1)
    if not dev:
        return None
    by_name, count = defaultdict(float), defaultdict(int)
    busy, gaps = 0, []
    cur0, cur1 = dev[0][0], dev[0][1]
    if cur0 > w0:
        gaps.append((w0, cur0))
    for a, b, n in dev:
        by_name[n] += (b - a) * 1e-9
        count[n] += 1
        if a > cur1:
            busy += cur1 - cur0
            gaps.append((cur1, a))
            cur0, cur1 = a, b
        else:
            cur1 = max(cur1, b)
    busy += cur1 - cur0
    if cur1 < w1:
        gaps.append((cur1, w1))

    host.sort()
    starts = [h[0] for h in host]
    # the harness's own spans around its calls into the program, for gaps
    # that no host op of the program covers
    spans = sorted((h for h in host if h[2].startswith("port_bench.")),
                   key=lambda h: h[1] - h[0])
    idle = defaultdict(float)
    for a, b in gaps:
        if b - a < _GAP_LABEL_MIN_NS:
            idle["(launch spacing under 20 us)"] += (b - a) * 1e-9
            continue
        mid = (a + b) // 2
        label = next((f"{h[2]} (no op of its own)" for h in spans
                      if h[0] <= mid <= h[1]), "(no host event)")
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - _LABEL_SCAN, -1), -1):
            if host[j][1] >= mid:
                if not host[j][2].startswith("port_bench."):
                    label = host[j][2]
                break
        idle[label] += (b - a) * 1e-9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps_top = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return TraceData(window_s=(w1 - w0) * 1e-9, busy_s=busy * 1e-9,
                     device_ops=[[n, s] for n, s in top],
                     idle_gaps=[[n, s] for n, s in gaps_top],
                     by_name=dict(by_name), count_by_name=dict(count))
