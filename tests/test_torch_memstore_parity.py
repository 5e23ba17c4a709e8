"""The port's columnar MemoryStorage held against the JAX package's row-list
MemoryStorage: each case drives one call sequence through both stores and
requires equal values and dtypes from every read (``read_generations``,
``claim_jobs`` in all three modes, ``read_runnable``), the counts
``write_results`` returns, ``is_empty`` and ``insert_generation``'s
``if_empty``. Calls the JAX store refuses with IndexError (serials past
the end, insert columns shorter than ``params``) raise it from the port's
store too, before it writes anything. A last case snapshots both stores
into SQLite and compares every row of job, par and met but the start times
(a wall clock)."""

import dataclasses
import sqlite3
from contextlib import closing

import numpy as np
import pytest

from abcsmc_tpu.storage import SQLiteStorage as RefSQLite
from abcsmc_tpu.storage.memstore import MemoryStorage as RefStore
from abcsmc_tpu_torch.storage import SQLiteStorage
from abcsmc_tpu_torch.storage.memstore import STATUS, MemoryStorage

PARS, METS = ["p1", "p2", "p3"], ["m1", "m2"]


def _params(n, t=0):
    return np.random.default_rng(10 + t).random((n, len(PARS)))


def _metrics(n, t=0):
    return np.random.default_rng(20 + t).random((n, len(METS)))


def _seeds(n, t=0):
    return np.arange(n, dtype=np.uint64) + np.uint64(1000 * t)


def _pause(st, serial):
    """Set a row to 'P' (paused): no store call does, SQL or an operator
    does, and the writeback guard has to admit it."""
    if isinstance(st, RefStore):
        st.status[serial] = "P"
        return
    b = st._blocks[np.searchsorted(st._starts, serial, side="right") - 1]
    b.status[serial - b.start] = list(STATUS).index("P")


def bulk_complete(st):
    st.create(PARS, METS, False)
    ranks = np.array([-1, 2, -1, 0, 1, -1])
    out = [st.is_empty(),
           st.insert_generation_complete(0, _params(6), _seeds(6),
                                         _metrics(6), None, ranks),
           st.insert_generation_complete(1, _params(5, 1), _seeds(5, 1),
                                         _metrics(5, 1)),
           st.is_empty(), st.read_generations(), st.claim_jobs(n=-1),
           st.read_runnable()]
    for gen in st.read_generations():     # reads are copies, not views
        gen.params[:] = -1.0
        gen.metrics[:] = -1.0
        gen.statuses[:] = "Q"
        gen.posterior_ranks[:] = 7
    return out + [st.read_generations()]


def host_batches_reclaim(st):
    st.create(PARS, METS, False)
    st.insert_generation(0, _params(7), _seeds(7))
    out = [st.claim_jobs(n=3), st.claim_jobs(n=2),
           st.write_results([1], _metrics(1), [5], [0.5]),
           st.claim_jobs(n=4),    # the Q rows, then R rows by attempts
           st.claim_jobs(n=3)]    # re-claims: fewest attempts, then serial
    st.insert_generation(1, _params(4, 1), _seeds(4, 1))
    out += [st.claim_jobs(n=5),   # set 1's Q rows before set 0's R rows
            st.write_results([0, 3, 8], _metrics(3, 1), [6, 6, 6],
                             [1.0, 2.0, 3.0]),
            st.read_runnable(), st.claim_jobs(n=-1), st.claim_jobs(n=0),
            st.read_generations()]
    return out


def guard_paused_and_done(st):
    st.create(PARS, METS, False)
    st.insert_generation(0, _params(5), _seeds(5))
    out = [st.claim_jobs(n=2),
           st.write_results([0], _metrics(1), [1], [0.1])]
    _pause(st, 2)
    _pause(st, 3)
    # row 0 is 'D' and keeps its first metrics; 3 ('P'), 4 ('Q') and
    # 1 ('R') are written; row 2 stays 'P' and is never claimable
    out += [st.write_results([0, 3, 4, 1], _metrics(4, 1), [2, 2, 2, 2],
                             [0.2, 0.2, 0.2, 0.2]),
            st.read_generations(), st.read_runnable(), st.claim_jobs(n=-1),
            st.write_results([2], _metrics(1, 2), [3], [0.3]),
            st.read_generations()]
    return out


def duplicate_serials(st):
    st.create(PARS, METS, False)
    st.insert_generation(0, _params(6), _seeds(6))
    # the first writeback of a serial wins and counts once
    out = [st.write_results([2, 4, 2, 5, 4], _metrics(5), [1, 2, 3, 4, 5],
                            [0.1, 0.2, 0.3, 0.4, 0.5]),
           st.write_results([1, 0], _metrics(2, 1), [6, 7], [0.6, 0.7])]
    # the last rank given for a serial wins
    st.write_posterior_ranks([1, 3, 1, 0, 3], [7, 2, 9, 4, 8])
    st.write_posterior_ranks(np.array([5, 5]), np.array([3, 1]))
    out += [st.read_generations(), st.claim_jobs(posterior_req=9),
            st.claim_jobs(posterior_req=7)]
    return out


def seeds_past_int64(st):
    st.create(PARS, METS, False)
    st.insert_generation(0, _params(4), np.array(
        [2**64 - 1, 2**63, 2**63 + 12345, 7], np.uint64))
    st.insert_generation(1, _params(2, 1), [2**63 + 1, 2**64 - 2])
    st.insert_generation(2, _params(3, 2), [2**63 + 5, 1, 2**64 - 3])
    return [st.read_generations(), st.read_runnable(), st.claim_jobs(n=3),
            st.claim_jobs(serial_req=5), st.claim_jobs(serial_req=7),
            st.read_generations()]


def upars_given(st):
    st.create(PARS, METS, True)
    params = _params(4)
    st.insert_generation(0, params, _seeds(4), upars=np.exp(params))
    out = [st.claim_jobs(n=2), st.read_runnable()]
    params = _params(3, 1)
    out += [st.insert_generation_complete(1, params, _seeds(3, 1),
                                          _metrics(3, 1), np.exp(params),
                                          [1, -1, 0]),
            st.claim_jobs(serial_req=5), st.claim_jobs(posterior_req=0),
            st.read_generations()]
    return out


def upars_absent(st):
    st.create(PARS, METS, True)     # an upar table, but no upars given
    st.insert_generation(0, _params(4), _seeds(4))
    out = [st.claim_jobs(n=3), st.read_runnable()]
    st.write_posterior_ranks([0, 2], [1, 0])
    return out + [st.claim_jobs(posterior_req=1), st.read_generations()]


def one_set_two_calls(st):
    st.create(PARS, METS, False)
    out = [st.insert_generation(0, _params(2), _seeds(2), if_empty=True),
           st.insert_generation(0, _params(3, 1), _seeds(3, 1)),
           st.insert_generation(0, _params(1, 2), _seeds(1, 2),
                               if_empty=True),
           st.insert_generation(1, _params(2, 3), _seeds(2, 3)),
           # a run of serials across the two calls' rows and the next set
           st.write_results([1, 2, 3, 4, 5, 6], _metrics(6),
                            [1, 1, 1, 1, 1, 1], [0, 0, 0, 0, 0, 0]),
           st.claim_jobs(n=-1)]
    st.write_posterior_ranks([4, 3, 2, 1], [0, 1, 2, 3])
    return out + [st.read_generations(), st.claim_jobs(posterior_req=2)]


def posterior_claims(st):
    st.create(PARS, METS, False)
    st.insert_generation(0, _params(5), _seeds(5))
    out = [st.claim_jobs(posterior_req=0)]    # no ranked set yet: empty
    st.write_posterior_ranks([3, 1], [0, 1])
    out += [st.claim_jobs(posterior_req=0), st.claim_jobs(posterior_req=0)]
    st.insert_generation(1, _params(4, 1), _seeds(4, 1),
                         posterior_ranks=np.array([-1, 0, -1, 1]))
    # the newest ranked set is set 1 now, whatever its rows' status
    out += [st.claim_jobs(posterior_req=0), st.claim_jobs(posterior_req=1),
            st.claim_jobs(posterior_req=5), st.read_runnable(),
            st.read_generations()]
    return out


def serial_claims(st):
    st.create(PARS, METS, False)
    st.insert_generation(0, _params(4), _seeds(4))
    out = [st.claim_jobs(serial_req=2), st.claim_jobs(serial_req=2),
           st.claim_jobs(serial_req=99), st.claim_jobs(serial_req=0)]
    out.append(st.write_results([2], _metrics(1), [4], [0.4]))
    return out + [st.claim_jobs(serial_req=2), st.claim_jobs(n=-1),
                  st.read_generations()]


def empty_store(st):
    st.create(PARS, METS, False)
    return [st.is_empty(), st.read_generations(), st.claim_jobs(),
            st.claim_jobs(n=-1), st.claim_jobs(serial_req=0),
            st.claim_jobs(posterior_req=0), st.read_runnable(),
            st.write_results([], [], [], []),
            st.write_posterior_ranks([], []),
            st.insert_generation(0, _params(2), _seeds(2), if_empty=True),
            st.is_empty()]


def complete_engine_shaped(st):
    """The mirror's columns as the engine hands them over (float64 params
    and metrics, uint64 seeds, int64 ranks, all C-contiguous: the port's
    store keeps them), then the writes and claims that come after."""
    st.create(PARS, METS, False)
    ranks = np.full(6, -1, np.int64)
    ranks[[4, 1, 2]] = [0, 1, 2]
    out = [st.insert_generation_complete(0, _params(6), _seeds(6),
                                         _metrics(6), None, ranks),
           # every row is 'D': nothing is written, the metrics stay
           st.write_results(np.arange(6), _metrics(6, 1), np.full(6, 3),
                            np.zeros(6)),
           st.read_generations()]
    ranks = np.full(5, -1, np.int64)
    ranks[[3, 0]] = [0, 1]
    out.append(st.insert_generation_complete(1, _params(5, 1),
                                             _seeds(5, 1), _metrics(5, 1),
                                             None, ranks))
    st.write_posterior_ranks([0, 3, 7], [3, 4, 2])
    out += [st.claim_jobs(serial_req=2), st.claim_jobs(posterior_req=1),
            st.claim_jobs(posterior_req=2), st.read_runnable(),
            # the claimed rows are open again and take these metrics
            st.write_results([2, 6, 7, 9], _metrics(4, 2), [5, 5, 5, 5],
                             [0.5, 0.5, 0.5, 0.5]),
            st.claim_jobs(n=-1), st.read_generations()]
    return out


def complete_columns_copied(st):
    """Columns the port's store cannot keep (float32, int64 seeds, a
    strided view, lists) are copied and read the same."""
    st.create(PARS, METS, True)
    wide = np.random.default_rng(30).random((5, 2 * len(METS)))
    params = _params(5).astype(np.float32)
    out = [st.insert_generation_complete(
               0, params, _seeds(5).astype(np.int64), wide[:, ::2],
               np.exp(params).tolist(), [1, -1, 0, -1, -1]),
           st.insert_generation_complete(
               1, _params(3, 1).tolist(), [2**63 + 5, 1, 2],
               _metrics(3, 1).tolist()),
           st.read_generations(), st.claim_jobs(serial_req=6),
           st.claim_jobs(posterior_req=0), st.read_runnable(),
           st.write_results([6, 0], _metrics(2, 2), [4, 4], [0.4, 0.4]),
           st.read_generations()]
    return out


CASES = [bulk_complete, host_batches_reclaim, guard_paused_and_done,
         duplicate_serials, seeds_past_int64, upars_given, upars_absent,
         one_set_two_calls, posterior_claims, serial_claims, empty_store,
         complete_engine_shaped, complete_columns_copied]


def _same(ref, port, at="result"):
    if isinstance(ref, np.ndarray):
        assert isinstance(port, np.ndarray), at
        assert (port.dtype, port.shape) == (ref.dtype, ref.shape), at
        np.testing.assert_array_equal(port, ref, err_msg=at)
    elif dataclasses.is_dataclass(ref):
        assert type(port).__name__ == type(ref).__name__, at
        for f in dataclasses.fields(ref):
            _same(getattr(ref, f.name), getattr(port, f.name),
                  f"{at}.{f.name}")
    elif isinstance(ref, (list, tuple)):
        assert len(port) == len(ref), at
        for i, (r, p) in enumerate(zip(ref, port)):
            _same(r, p, f"{at}[{i}]")
    else:
        assert (type(port), port) == (type(ref), ref), at


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__)
def test_port_store_matches_reference_store(case):
    _same(case(RefStore()), case(MemoryStorage()), case.__name__)


def _six_rows(st):
    st.create(PARS, METS, False)
    st.insert_generation(0, _params(4), _seeds(4))
    st.insert_generation(1, _params(2, 1), _seeds(2, 1))


BAD_CALLS = {
    # a run of serials that leaves the store, and one out of order
    "write_results_run_past_end": lambda st: st.write_results(
        [5, 6, 7], _metrics(3), [1, 1, 1], [0, 0, 0]),
    "write_results_scattered_past_end": lambda st: st.write_results(
        [0, 9, 2], _metrics(3), [1, 1, 1], [0, 0, 0]),
    "write_posterior_ranks_past_end": lambda st: st.write_posterior_ranks(
        [4, 6], [0, 1]),
    "insert_short_seeds": lambda st: st.insert_generation(
        2, _params(3), _seeds(2)),
    "insert_short_upars": lambda st: st.insert_generation(
        2, _params(3), _seeds(3), upars=_params(2)),
    "insert_short_posterior_ranks": lambda st: st.insert_generation(
        2, _params(3), _seeds(3), posterior_ranks=[0, 1]),
    "insert_complete_short_seeds": lambda st: st.insert_generation_complete(
        2, _params(3), _seeds(2), _metrics(3)),
}


@pytest.mark.parametrize("call", BAD_CALLS.values(), ids=BAD_CALLS.keys())
def test_port_store_raises_where_reference_store_raises(call):
    ref, port = RefStore(), MemoryStorage()
    _six_rows(ref)
    _six_rows(port)
    with pytest.raises(IndexError):
        call(ref)
    before = port.read_generations()
    with pytest.raises(IndexError):
        call(port)
    # the reference has written the rows before the bad one; the port
    # raises before it writes anything
    _same(before, port.read_generations())


def test_port_posterior_claim_before_any_ranked_set_is_empty(tmp_path):
    """The port's SQLite and memory stores agree on a posterior claim before
    any set is ranked (empty) and after (the ranked row)."""
    sql, mem = SQLiteStorage(str(tmp_path / "post.sqlite")), MemoryStorage()
    for st in (sql, mem):
        st.create(["p1", "p2"], ["m1"], False)
        st.insert_generation(0, np.arange(8.0).reshape(4, 2),
                             np.arange(4, dtype=np.uint64))
        claimed = st.claim_jobs(posterior_req=0)
        assert claimed.serials.size == 0, type(st).__name__
        assert claimed.params.shape[0] == 0
        st.write_posterior_ranks([1], [0])
        claimed = st.claim_jobs(posterior_req=0)
        assert claimed.serials.tolist() == [1], type(st).__name__
    sql.close()


def _run_for_snapshot(st):
    st.create(PARS, METS, True)
    params = _params(5)
    st.insert_generation_complete(0, params, _seeds(5), _metrics(5),
                                  np.exp(params), [2, -1, 0, -1, 1])
    st.insert_generation(1, _params(3, 1), [2**63 + 5, 1, 2])
    st.insert_generation(1, _params(2, 2), _seeds(2, 2))
    st.claim_jobs(n=3)
    _pause(st, 9)
    st.write_results([6, 9, 5, 6], _metrics(4, 1), [1, 1, 1, 1],
                     [0.25, np.nan, 1.5, 9.0])
    st.write_posterior_ranks([5, 6, 5], [1, 0, 3])


def _rows(path):
    with closing(sqlite3.connect(path)) as con:
        out = {}
        for table in ("job", "par", "met", "upar"):
            cur = con.execute(f"select * from {table} order by serial")
            names = [d[0] for d in cur.description]
            out[table] = (names, [
                tuple(v for name, v in zip(names, row) if name != "startTime")
                for row in cur.fetchall()])
        return out


def test_snapshot_to_sqlite_matches_reference(tmp_path):
    ref, port = RefStore(), MemoryStorage()
    _run_for_snapshot(ref)
    _run_for_snapshot(port)
    ref.snapshot_to(RefSQLite(str(tmp_path / "ref.sqlite"))).close()
    port.snapshot_to(SQLiteStorage(str(tmp_path / "port.sqlite"))).close()
    want = _rows(tmp_path / "ref.sqlite")
    assert len(want["job"][1]) == 10
    assert _rows(tmp_path / "port.sqlite") == want
