"""CRC-32 checksums (parity with the reference's vendored CCRC32 component).

The reference links ``lib/CCRC32`` into ``libabc`` (CMakeLists.txt:22) but never
calls it from ``src/`` — the component is vestigial there. Its API
(``lib/CCRC32/include/CCRC32.h:14-34``) is the standard
reflected CRC-32 (polynomial 0x04C11DB7, init/xorout 0xFFFFFFFF), which is
bit-identical to :func:`zlib.crc32`.  We expose the same three operations —
full-buffer, incremental (partial), and file — on top of the zlib primitive,
and put the component to an actual use the reference never did: integrity
stamps for SQLite checkpoint files (see :func:`database_crc`).
"""

from __future__ import annotations

import json
import os
import zlib

__all__ = [
    "full_crc", "partial_crc", "file_crc", "database_crc", "verify_checkpoint",
]

_DEFAULT_BUFSIZE = 1 << 20


def full_crc(data: bytes | bytearray | memoryview) -> int:
    """CRC-32 of a whole buffer (CCRC32::FullCRC, CCRC32.h:27-28).

    Passes the buffer straight to zlib (no copy), so memoryviews over large
    mmapped checkpoints are checksummed zero-copy."""
    return zlib.crc32(data) & 0xFFFFFFFF


def partial_crc(crc: int, data: bytes | bytearray | memoryview) -> int:
    """Fold more bytes into a running CRC (CCRC32::PartialCRC, CCRC32.h:30).

    The reference keeps the running value pre-inverted; here the value is the
    finalized CRC after every call (start from 0), which chains identically:
    ``partial_crc(partial_crc(0, a), b) == full_crc(a + b)``.
    """
    return zlib.crc32(data, crc & 0xFFFFFFFF) & 0xFFFFFFFF


def file_crc(path: str | os.PathLike, buffer_size: int = _DEFAULT_BUFSIZE) -> int:
    """Streamed CRC-32 of a file (CCRC32::FileCRC, CCRC32.h:21-25)."""
    if buffer_size <= 0:
        raise ValueError(f"buffer_size must be positive, got {buffer_size}")
    crc = 0
    with open(path, "rb") as fh:
        while chunk := fh.read(buffer_size):
            crc = partial_crc(crc, chunk)
    return crc


def database_crc(path: str | os.PathLike) -> dict:
    """Integrity stamp for a run database: CRC-32, size, and mtime.

    Useful for verifying that a checkpoint copied between filesystems (the
    reference's cluster pattern ships ``.sqlite`` files around, e.g.
    ``examples/scratch/job.slurm``) arrived intact.
    """
    st = os.stat(path)
    return {
        "path": os.fspath(path),
        "crc32": f"{file_crc(path):08x}",
        "bytes": st.st_size,
        "mtime": st.st_mtime,
    }


def verify_checkpoint(path: str | os.PathLike) -> bool:
    """Verify a checkpoint against the ``<path>.crc.json`` stamp written by
    ``AbcSmc.checkpoint``. Returns True iff the stamp exists and both the byte
    count and CRC-32 match the file's current contents (mtime is informational
    only — copies legitimately change it)."""
    stamp_path = os.fspath(path) + ".crc.json"
    try:
        with open(stamp_path) as fh:
            stamp = json.load(fh)
        st = os.stat(path)
        crc = file_crc(path)
    except (OSError, ValueError):
        # missing/unreadable checkpoint OR stamp: both are verification
        # failures, not crashes - the lost-in-transit case is exactly what
        # this function exists to detect
        return False
    return st.st_size == stamp.get("bytes") and (
        f"{crc:08x}" == stamp.get("crc32")
    )
