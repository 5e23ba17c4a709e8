"""The readers of the program's own spans (``run_device_phases`` fields and
each set's stage milliseconds) on synthetic records: the right value where
the fields are there, None where a run has nothing to read (a program
without the spans, a replayed or CPU set, a fit that wrote no row)."""

import pytest

from port_bench import registry

STAGES = ("pls_fit", "vdv", "topk", "weights", "propose")


def _fit(sets, stage_ms, **phases):
    return {"phases": {"sets": len(sets), **phases},
            "sets": [{**{f"{s}_ms": stage_ms(i, s) for s in STAGES},
                      "device_ms": 10.0} for i in range(len(sets))]}


def _record(fits):
    return {"fits": fits}


def _two_fits(stage_ms=lambda i, s: None):
    return _record([
        _fit([0, 1, 2], stage_ms, fetch_s=0.3, report_s=0.06,
             store_s=2.0, store_rows=3000),
        _fit([0, 1], stage_ms, fetch_s=0.2, report_s=0.04, store_s=0.5,
             store_rows=2000)])


@pytest.mark.parametrize("name,want", [
    ("fetch_ms_per_set", 1e3 * 0.5 / 5),
    ("report_ms_per_set", 1e3 * 0.1 / 5),
    ("store_rows_per_s", 5000 / 2.5)])
def test_phase_readers(name, want):
    got = registry.metric(name).read(_two_fits())
    assert got == pytest.approx(want)


@pytest.mark.parametrize("name", ["fetch_ms_per_set", "report_ms_per_set",
                                  "store_rows_per_s"])
def test_phase_readers_read_nothing_without_the_spans(name):
    read = registry.metric(name).read
    # the parent program's phases: dispatch and mirror alone
    old = _record([{"phases": {"sets": 3, "dispatch_s": 0.1,
                               "mirror_s": 4.0}, "sets": []}])
    assert read(old) is None
    assert read(_record([])) is None
    # a fit without its store (mirror_store=False): no row written
    if name == "store_rows_per_s":
        none = _record([_fit([0], lambda i, s: None, fetch_s=0.1,
                             report_s=0.0, store_s=0.0, store_rows=0)])
        assert read(none) is None


@pytest.mark.parametrize("stage", STAGES)
def test_stage_readers_take_the_median_of_timed_sets(stage):
    read = registry.metric(f"{stage}_ms").read
    # set i of either fit: (i + 1) ms for this stage, 100 ms for the others;
    # the last set of each fit untimed (a replay)
    def ms(i, s):
        if i == 2:
            return None
        return float(i + 1) if s == stage else 100.0

    assert read(_two_fits(ms)) == pytest.approx(1.5)
    assert read(_two_fits()) is None
    assert read(_record([{"phases": {"sets": 1},
                          "sets": [{"device_ms": 5.0}]}])) is None
