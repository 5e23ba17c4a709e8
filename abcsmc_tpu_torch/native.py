"""ctypes bindings for the native C++ worker pool (native/abcq.cpp).

``run_workers`` claims jobs from a SQLite run store and executes an external
simulator command over a dynamically load-balanced process pool - the native
replacement for both the reference's serial --simulate worker loop
(src/AbcSmc.cpp:967-1039) and the AbcMPI master-worker balancer
(src/AbcMPI.cpp:8-99)."""

from __future__ import annotations

import ctypes
import os
import subprocess

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libabcq.so")
_lib: ctypes.CDLL | None = None


def load_abcq(build_if_missing: bool = True) -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_SO_PATH) and build_if_missing:
        subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                       capture_output=True)
    lib = ctypes.CDLL(_SO_PATH)
    lib.abcq_run.restype = ctypes.c_int
    lib.abcq_run.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int,
    ]
    lib.abcq_version.restype = ctypes.c_char_p
    _lib = lib
    return lib


def run_workers(
    db_path: str, command: str, n_jobs: int = -1, n_workers: int = 4,
    verbose: bool = False, chunk_size: int | None = None,
) -> int:
    """Run up to ``n_jobs`` queued/stuck jobs (-1 = drain the queue) through
    ``n_workers`` parallel child processes. Returns jobs completed.

    Claims happen in chunks (default ``max(4 * n_workers, 16)``) so multiple
    machines pointing at the same database share the queue fairly instead of
    one worker claiming everything in a single transaction - the reference's
    ``--simulate -n 1000``-per-claim deployment pattern."""
    lib = load_abcq()
    chunk = chunk_size or max(4 * int(n_workers), 16)
    total = 0
    while n_jobs < 0 or total < n_jobs:
        ask = chunk if n_jobs < 0 else min(chunk, n_jobs - total)
        rc = lib.abcq_run(
            db_path.encode(), command.encode(), int(ask), int(n_workers),
            1 if verbose else 0,
        )
        if rc < 0:
            raise RuntimeError(f"abcq_run failed with code {rc}")
        total += rc
        if rc == 0:
            # queue drained, or every remaining job is failing - stop rather
            # than spin re-claiming 'R' rows
            break
    return total
