"""Seconds from the start of the harness's process to the start of the
window (host clock): imports, the CUDA context, the kernel library from
its build cache (built on a checkout's first run), the configuration and
one warm-up fit."""

UNIT, BETTER, SOURCE = "s", "lower", "host_clock"


def read(record):
    return record["setup_s"]
