"""In-memory columnar run store - the hot path.

Same job-lifecycle semantics as the SQLite store (Q/R/D/P states, attempts
ordering, guarded writeback) but held as numpy columns, so a fully on-device
run never touches disk. ``snapshot_to`` provides checkpointing by dumping into
any other Storage (e.g. the SQLite store for durability).

Each insert appends one block of whole columns. Serials are the row
numbers, contiguous within a block and across blocks, so a serial's block
is found by a binary search over the blocks' first serials, and no
operation loops over rows in Python. A block is never copied again.

``insert_generation`` copies the columns it is given. The mirror's
``insert_generation_complete`` keeps them: params, upars, seeds, posterior
ranks and metrics become the block's own columns, unless a column is not
already a C-contiguous array of the store's dtype (float64, uint64, int64),
when it is copied. The store marks the kept params, upars, seeds and
metrics read-only, since the caller holds the same arrays and the store
never writes into them, so a later write by either raises instead of
making the two differ. It keeps the ranks writable, because
``write_posterior_ranks`` writes into them (the engine keeps no reference
to the ranks it hands over). Start time, duration, status and attempts are
always the store's own, since claims write them. ``copied_bytes`` counts
the bytes copied where a column was not kept.
"""

from __future__ import annotations

import time

import numpy as np

from abcsmc_tpu_torch.storage.base import ClaimedJobs, GenerationData, Storage

# status codes: the index into STATUS; 'Q' < 'R' keeps the SQL claim order
STATUS = np.array(["Q", "R", "D", "P"])
_R, _D = 1, 2


class _Block:
    """The rows of one insert: serials ``start`` to ``start + n - 1``, all
    of set ``set_num``. The first five columns may be a caller's (the
    module docstring); the last four are always the store's own."""

    def __init__(self, start, set_num, params, upars, seeds, posterior,
                 n_met, now):
        n = len(params)
        self.start, self.n, self.set_num, self.n_met = start, n, set_num, n_met
        self.params = params            # [n, P] float64
        self.upars = upars              # [n, P] float64; params when absent
        self.seeds = seeds              # [n] uint64
        self.posterior = posterior      # [n] int64, writable
        # [n, M] float64; None (every row NaN) until a write, so that a
        # write of the whole block fills its memory once
        self.metrics = None
        self.start_time = np.full(n, now, np.int64)
        self.duration = np.full(n, np.nan)
        self.status = np.zeros(n, np.uint8)
        self.attempts = np.zeros(n, np.int64)

    def serials(self):
        return np.arange(self.start, self.start + self.n, dtype=np.int64)

    def metrics_or_nan(self):
        if self.metrics is None:
            return np.full((self.n, self.n_met), np.nan)
        return self.metrics


def _run(idx):
    """``idx`` as a slice when it is an ascending run of consecutive
    integers (a view, and a copy at memory speed), else unchanged."""
    if len(idx) and idx[-1] - idx[0] == len(idx) - 1 and (
            len(idx) == 1 or bool((np.diff(idx) == 1).all())):
        return slice(int(idx[0]), int(idx[-1]) + 1)
    return idx


def _cat(blocks, name):
    """Column ``name`` of ``blocks`` end to end, as a new array."""
    return np.concatenate([getattr(b, name) for b in blocks])


def _one_of_each(keys, last=False):
    """Positions, ascending, that keep one occurrence of each key: its
    first, or with ``last`` its last. A slice when the keys ascend."""
    if len(keys) < 2 or bool((np.diff(keys) > 0).all()):
        return slice(0, len(keys))
    if last:
        return np.sort(len(keys) - 1 -
                       np.unique(keys[::-1], return_index=True)[1])
    return np.sort(np.unique(keys, return_index=True)[1])


class MemoryStorage(Storage):
    shared = False  # process-private: each process writes its own copy

    def __init__(self):
        self._created = False
        self.par_names: list[str] = []
        self.met_names: list[str] = []
        self.has_upar = False
        self._blocks: list[_Block] = []
        self._starts = np.zeros(0, np.int64)   # each block's first serial
        self._rows = 0
        #: bytes of the callers' columns copied into columns of the store's
        #: own: every column ``insert_generation`` takes, those the keeping
        #: calls could not keep, and a kept metrics column a later write
        #: has to change
        self.copied_bytes = 0

    # -- lifecycle -------------------------------------------------------------
    def exists(self) -> bool:
        return self._created

    def create(self, par_names, met_names, has_upar):
        self._created = True
        self.par_names = list(par_names)
        self.met_names = list(met_names)
        self.has_upar = has_upar

    def is_empty(self) -> bool:
        return self._rows == 0

    def insert_generation(
        self, set_num, params, seeds, upars=None, posterior_ranks=None,
        if_empty=False,
    ):
        if if_empty and self._rows != 0:
            # conditional repair insert lost the (in-process) race
            return None
        return self._append(set_num, params, seeds, upars, posterior_ranks,
                            keep=False)

    def insert_generation_complete(
        self, set_num, params, seeds, metrics, upars=None,
        posterior_ranks=None,
    ):
        """Bulk-insert an already-simulated set (status 'D') as one block
        that keeps the caller's params, upars, seeds and ranks, the first
        three read-only (the module docstring says why). The metrics go
        through ``write_results``, whose write of a whole new block keeps
        them too, read-only. A column shorter than ``params`` raises
        IndexError before anything is written."""
        serials = self._append(set_num, params, seeds, upars,
                               posterior_ranks, keep=True, metrics=metrics)
        n = len(serials)
        # one value a column, broadcast: the block's own columns take them
        self.write_results(serials, metrics,
                           np.broadcast_to(np.int64(time.time()), n),
                           np.broadcast_to(0.0, n))
        return serials

    def _append(self, set_num, params, seeds, upars, posterior_ranks, keep,
                metrics=None):
        """Append one block of 'Q' rows, its columns by ``_column``'s rule;
        returns its serials. ``metrics`` is only checked for length."""
        start = self._rows
        n = len(params)
        for name, col in (("seeds", seeds), ("upars", upars),
                          ("posterior_ranks", posterior_ranks),
                          ("metrics", metrics)):
            if col is not None and len(col) < n:
                raise IndexError(f"{name} has {len(col)} rows, params {n}")
        if n:
            params = self._column(params, n, np.float64, keep)
            self._blocks.append(_Block(
                start, int(set_num), params,
                params if upars is None
                else self._column(upars, n, np.float64, keep),
                self._column(seeds, n, np.uint64, keep),
                np.full(n, -1, np.int64) if posterior_ranks is None
                else self._column(posterior_ranks, n, np.int64, keep,
                                  writable=True),
                len(self.met_names), int(time.time()),
            ))
            self._starts = np.append(self._starts, start)
            self._rows += n
        return np.arange(start, start + n, dtype=np.int64)

    def _column(self, x, n, dtype, keep, writable=False):
        """Rows ``:n`` of the caller's column ``x`` as a C-contiguous
        ``dtype`` column of a block. With ``keep`` that is ``x`` itself
        where it already is one: made read-only, or with ``writable`` left
        writable (a read-only one is copied). Else a copy, whose bytes
        ``copied_bytes`` counts."""
        src = x if len(x) == n else x[:n]
        col = (np.ascontiguousarray(src, dtype) if keep
               else np.array(src, dtype))
        if col is src and not writable:
            col.setflags(write=False)
        elif col is src and not col.flags.writeable:
            col = col.copy()
        if col is not src:
            self.copied_bytes += col.nbytes
        return col

    # -- row access -----------------------------------------------------------
    def _parts(self, rows):
        """Split serials ``rows`` by block: (block, positions in ``rows``,
        offsets in the block), as slices where ``rows`` is a run. A serial
        outside the store raises IndexError before the first part."""
        if len(rows) and (rows.min() < 0 or rows.max() >= self._rows):
            raise IndexError(f"serial out of range [0, {self._rows})")
        run = _run(rows)
        if isinstance(run, slice):
            first = np.searchsorted(self._starts, run.start, side="right")
            for b in self._blocks[max(first - 1, 0):]:
                if b.start >= run.stop:
                    break
                lo, hi = max(run.start, b.start), min(run.stop, b.start + b.n)
                yield (b, slice(lo - run.start, hi - run.start),
                       slice(lo - b.start, hi - b.start))
            return
        k = np.searchsorted(self._starts, rows, side="right") - 1
        for j in np.unique(k):
            b = self._blocks[j]
            where = np.flatnonzero(k == j)
            yield b, where, rows[where] - b.start

    def _gather(self, name, rows):
        parts = list(self._parts(rows))
        col = getattr(parts[0][0], name)
        out = np.empty((len(rows),) + col.shape[1:], col.dtype)
        for b, where, local in parts:
            out[where] = getattr(b, name)[local]
        return out

    def _status(self):
        """Every row's status code, in serial order."""
        return np.concatenate(
            [b.status for b in self._blocks] or [np.zeros(0, np.uint8)])

    def _sets(self):
        """(set number, its blocks in serial order), by ascending set."""
        for t in sorted({b.set_num for b in self._blocks}):
            yield t, [b for b in self._blocks if b.set_num == t]

    # -- reads -------------------------------------------------------------------
    def read_generations(self):
        out = []
        for t, blocks in self._sets():
            # particleIdx order == insertion order here
            out.append(
                GenerationData(
                    set_num=t,
                    serials=np.concatenate([b.serials() for b in blocks]),
                    params=_cat(blocks, "params"),
                    metrics=np.concatenate(
                        [b.metrics_or_nan() for b in blocks]),
                    posterior_ranks=_cat(blocks, "posterior"),
                    statuses=STATUS[_cat(blocks, "status")],
                    seeds=_cat(blocks, "seeds"),
                )
            )
        return out

    def write_posterior_ranks(self, serials, ranks):
        serials = np.asarray(serials, np.int64)
        ranks = np.asarray(ranks, np.int64)
        k = min(len(serials), len(ranks))
        # the last rank given for a serial wins, as in a loop over them
        keep = _one_of_each(serials[:k], last=True)
        serials, ranks = serials[keep], ranks[keep]
        for b, where, local in self._parts(serials):
            b.posterior[local] = ranks[where]

    # -- job queue -----------------------------------------------------------------
    def claim_jobs(self, n=1, serial_req=-1, posterior_req=-1):
        if serial_req > -1:
            # unknown serial -> empty claim (SQLite-store / reference parity)
            chosen = np.array(
                [serial_req] if serial_req < self._rows else [], np.int64)
        elif posterior_req > -1:
            # no posterior-ranked set yet -> empty claim (top is None),
            # matching the SQLite store (whose subquery is NULL then,
            # selecting nothing) so the engine API is backend-invariant
            top = max((b.set_num for b in self._blocks
                       if bool((b.posterior > -1).any())), default=None)
            chosen = np.concatenate([np.zeros(0, np.int64)] + [
                b.start + np.flatnonzero(b.posterior == posterior_req)
                for b in self._blocks if b.set_num == top
            ])
        else:
            status = self._status()
            cand = np.flatnonzero(status <= _R)
            # order by (status, attempts): 'Q' < 'R' lexically, like the
            # SQL; lexsort is stable, so ties stay in serial order
            if len(cand):
                cand = cand[np.lexsort(
                    (self._gather("attempts", cand), status[cand]))]
            chosen = cand if n == -1 else cand[:n]

        now = int(time.time())
        for b, _, local in self._parts(chosen):
            b.start_time[local] = now
            b.status[local] = _R
            b.attempts[local] += 1
        return self._claimed(chosen)

    def _claimed(self, chosen):
        if not len(chosen):
            return ClaimedJobs(serials=np.zeros(0, np.int64),
                               seeds=np.zeros(0, np.uint64),
                               params=np.zeros((0, len(self.par_names))))
        return ClaimedJobs(
            serials=chosen.astype(np.int64),
            seeds=self._gather("seeds", chosen),
            params=self._gather("upars" if self.has_upar else "params",
                                chosen),
        )

    def read_runnable(self):
        """Read-only claim view: see Storage.read_runnable."""
        return self._claimed(np.flatnonzero(self._status() <= _R))

    def write_results(self, serials, metrics, start_times, durations):
        """Guarded writeback. A write of a whole block, its serials in
        order, before the block has metrics and while every row is open,
        keeps ``metrics`` as the block's column by ``_column``'s rule
        (read-only); every other write copies the open rows into the
        store's own column, first a copy of a kept one."""
        serials = np.asarray(serials, np.int64)
        start_times = np.asarray(start_times, np.int64)
        durations = np.asarray(durations, np.float64)
        k = min(len(serials), len(metrics), len(start_times), len(durations))
        b = self._whole_block(serials[:k], np.shape(metrics)[1:])
        if b is not None:
            b.metrics = self._column(metrics, k, np.float64, keep=True)
            b.start_time[:] = start_times[:k]
            b.duration[:] = durations[:k]
            b.status.fill(_D)
            return b.n
        metrics = np.asarray(metrics, np.float64)
        # the first writeback of a serial wins; later ones find it 'D'
        keep = _one_of_each(serials[:k])
        serials, metrics = serials[keep], metrics[keep]
        start_times, durations = start_times[keep], durations[keep]
        written = 0
        for b, where, local in self._parts(serials):
            open_ = b.status[local] != _D      # the guard: Q, R or P
            n_open = int(open_.sum())
            if not n_open:
                continue
            if n_open < len(open_):
                where = np.arange(len(serials))[where][open_]
                local = np.arange(b.n)[local][open_]
            col = b.metrics
            if col is None:     # kept only once the write has succeeded
                # the serials are distinct, so n_open == b.n is every row
                col = (np.empty((b.n, b.n_met)) if n_open == b.n
                       else b.metrics_or_nan())
            elif not col.flags.writeable:   # kept from a caller
                col = col.copy()
                self.copied_bytes += col.nbytes
            col[local] = metrics[where]
            b.metrics = col
            b.start_time[local] = start_times[where]
            b.duration[local] = durations[where]
            b.status[local] = _D
            written += n_open
        return written

    def _whole_block(self, serials, row_shape):
        """The block whose serials ``serials`` are, all and in order, where
        that block has no metrics yet, every row is open and metric rows
        of ``row_shape`` fit it; else None."""
        if not len(serials):
            return None
        j = int(np.searchsorted(self._starts, serials[0], side="right")) - 1
        if j < 0:
            return None
        b = self._blocks[j]
        if (b.start != serials[0] or b.n != len(serials)
                or b.metrics is not None or row_shape != (b.n_met,)
                or not isinstance(_run(serials), slice)
                or bool((b.status == _D).any())):
            return None
        return b

    # -- durability -----------------------------------------------------------------
    def snapshot_to(self, other: Storage):
        """Dump this in-memory run into another store (e.g. SQLite for
        durability / R-vis compatibility). The target must be empty."""
        other.create(self.par_names, self.met_names, self.has_upar)
        gens = self.read_generations()
        for gen, (_, blocks) in zip(gens, self._sets()):
            serials = other.insert_generation(
                gen.set_num,
                gen.params,
                gen.seeds,
                _cat(blocks, "upars") if self.has_upar else None,
            )
            done = gen.statuses == "D"
            if done.any():
                other.write_results(
                    serials[done], gen.metrics[done],
                    _cat(blocks, "start_time")[done],
                    np.nan_to_num(_cat(blocks, "duration")[done]),
                )
            ranked = gen.posterior_ranks > -1
            if ranked.any():
                other.write_posterior_ranks(
                    serials[ranked], gen.posterior_ranks[ranked]
                )
        return other
