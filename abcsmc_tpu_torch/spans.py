"""Named spans of the program, on the profiler's clock and in
``AbcSmc.timings``.

A host span (:func:`host`) is a ``torch.profiler.record_function`` range
named ``abcsmc.<layer>[.<stage>]`` whose ``time.perf_counter`` seconds are
added to one field of the running ``run_device_phases`` entry. A device
stage (:class:`StepStages`) is a range ``abcsmc.step.<stage>`` that, on a
CUDA device outside a graph capture, also records a CUDA event at each of
its boundaries, as the simulate stage's ``sim_events`` do. The ranges land
in the same trace as the device operations, so a profiler run can name the
host time between them. Spans are always on: with no profiler running a
range costs the host a few microseconds, and each is entered once per set
or per stage, never per row.
"""

from __future__ import annotations

import contextlib
import time

import torch
from torch.profiler import record_function

#: the timed stages of the eager step after its simulate stage, in order
#: (``mvn``, the MULTIVARIATE proposal's covariance, factor and first block
#: of rejection rounds, runs only with that noise)
STAGES = ("pls_fit", "vdv", "topk", "weights", "propose", "mvn")


@contextlib.contextmanager
def host(phases: dict, field: str, name: str):
    """The range ``name`` around the body; the body's host seconds are
    added to ``phases[field]``."""
    t0 = time.perf_counter()
    with record_function(name):
        yield
    phases[field] += time.perf_counter() - t0


class StepStages:
    """The stages of one step, each begun where the one before it ends:
    a range ``abcsmc.step.<stage>`` and, where ``timed``, a CUDA event at
    each boundary, shared by the stage that ends there and the one that
    begins (N + 1 events for N adjacent stages). ``events`` maps each stage
    that ran to its (start, end) events; it stays empty where not
    ``timed``."""

    def __init__(self, timed: bool):
        self.timed = timed
        self.events: dict = {}
        self._name = self._range = self._start = None

    def _event(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def begin(self, name: str):
        """End the running stage, if any, and begin ``name`` at its end."""
        boundary = self.end()
        self._range = record_function(f"abcsmc.step.{name}")
        self._range.__enter__()
        self._name = name
        if self.timed:
            self._start = boundary if boundary is not None else self._event()

    def end(self):
        """End the running stage; returns its end event (None: no stage
        ran, or not ``timed``)."""
        if self._name is None:
            return None
        ev = None
        if self.timed:
            ev = self._event()
            self.events[self._name] = (self._start, ev)
        self._range.__exit__(None, None, None)
        self._name = self._range = self._start = None
        return ev


def stage_ms(stages: StepStages | None) -> dict:
    """``<stage>_ms`` of each of ``STAGES``: the device milliseconds between
    its events, None where it did not run or was not timed (or ``stages``
    is None). Reads the events, so the device must be past them."""
    ev = {} if stages is None else stages.events
    return {f"{s}_ms": ev[s][0].elapsed_time(ev[s][1]) if s in ev else None
            for s in STAGES}
