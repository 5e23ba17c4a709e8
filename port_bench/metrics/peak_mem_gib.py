"""The card's memory one fit of this cell holds at its peak, in GiB: over
the window's fits, the most that ``torch.cuda.max_memory_allocated()``
rose during a fit above ``torch.cuda.memory_allocated()`` at its start
(the peak is reset before each fit), plus what the process held when the
window began. It bounds the largest population one card takes, and reads
the same however many fits a window holds: memory that an earlier fit
left behind is not counted again in each later one."""

UNIT, BETTER, SOURCE = "GiB", "lower", "host_clock"


def read(record):
    peak = record["peak_bytes"]
    return None if not peak else peak / 2**30
