"""Reads a fit's rows back from its SQLite run store file, as the plain
reference sees them: the ``job``, ``par`` and ``met`` tables of the
reference's schema (one row a particle; ``posterior`` the survivor rank or
-1), with nothing of the program's reader."""

from __future__ import annotations

import sqlite3

import numpy as np


def read_sets(path: str) -> list:
    """Per set, in set order: ``params`` [N, P], ``seeds`` [N],
    ``metrics`` [N, M] and ``survivors`` (row positions in rank order)."""
    conn = sqlite3.connect(f"file:{path}?mode=ro", uri=True)
    try:
        pars = [r[1] for r in conn.execute("pragma table_info(par)")
                if r[1] not in ("serial", "seed")]
        mets = [r[1] for r in conn.execute("pragma table_info(met)")
                if r[1] != "serial"]
        cols = ", ".join([f"P.{c}" for c in pars] + [f"M.{c}" for c in mets])
        rows = conn.execute(
            f"select J.smcSet, J.posterior, P.seed, {cols} from job J "
            "join par P on J.serial = P.serial join met M on "
            "J.serial = M.serial order by J.smcSet, J.particleIdx").fetchall()
    finally:
        conn.close()
    table = np.array(rows, dtype=np.float64)
    out = []
    for t in np.unique(table[:, 0]):
        block = table[table[:, 0] == t]
        rank = block[:, 1].astype(np.int64)
        kept = np.nonzero(rank >= 0)[0]
        out.append({
            "params": block[:, 3:3 + len(pars)],
            "seeds": block[:, 2].astype(np.uint64),
            "metrics": block[:, 3 + len(pars):],
            "survivors": kept[np.argsort(rank[kept], kind="stable")],
        })
    return out
