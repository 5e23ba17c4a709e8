"""In-memory columnar run store - the hot path.

Same job-lifecycle semantics as the SQLite store (Q/R/D/P states, attempts
ordering, guarded writeback) but held as numpy columns, so a fully on-device
run never touches disk. ``snapshot_to``/``load_from`` provide checkpointing by
dumping into any other Storage (e.g. the SQLite store for durability).
"""

from __future__ import annotations

import time

import numpy as np

from abcsmc_tpu_torch.storage.base import ClaimedJobs, GenerationData, Storage


class MemoryStorage(Storage):
    shared = False  # process-private: each process writes its own copy

    def __init__(self):
        self._created = False
        self.par_names: list[str] = []
        self.met_names: list[str] = []
        self.has_upar = False
        # columnar job/par/met tables, append-only
        self.serial: list[int] = []
        self.smc_set: list[int] = []
        self.particle_idx: list[int] = []
        self.start_time: list[int] = []
        self.duration: list[float] = []
        self.status: list[str] = []
        self.posterior: list[int] = []
        self.attempts: list[int] = []
        self.seeds: list[int] = []
        self.params: list[np.ndarray] = []
        self.upars: list[np.ndarray] = []
        self.metrics: list[np.ndarray] = []

    # -- lifecycle -------------------------------------------------------------
    def exists(self) -> bool:
        return self._created

    def create(self, par_names, met_names, has_upar):
        self._created = True
        self.par_names = list(par_names)
        self.met_names = list(met_names)
        self.has_upar = has_upar

    def is_empty(self) -> bool:
        return not self.serial

    def insert_generation(
        self, set_num, params, seeds, upars=None, posterior_ranks=None,
        if_empty=False,
    ):
        params = np.asarray(params, np.float64)
        n = params.shape[0]
        start = len(self.serial)
        if if_empty and start != 0:
            # conditional repair insert lost the (in-process) race
            return None
        serials = np.arange(start, start + n, dtype=np.int64)
        now = int(time.time())
        for i in range(n):
            self.serial.append(start + i)
            self.smc_set.append(set_num)
            self.particle_idx.append(i)
            self.start_time.append(now)
            self.duration.append(np.nan)
            self.status.append("Q")
            self.posterior.append(
                int(posterior_ranks[i]) if posterior_ranks is not None else -1
            )
            self.attempts.append(0)
            self.seeds.append(int(seeds[i]))
            self.params.append(params[i])
            self.upars.append(
                np.asarray(upars[i], np.float64) if upars is not None else params[i]
            )
            self.metrics.append(np.full(len(self.met_names), np.nan))
        return serials

    # -- reads -------------------------------------------------------------------
    def read_generations(self):
        if not self.serial:
            return []
        sets = np.asarray(self.smc_set)
        out = []
        for t in np.unique(sets):
            idx = np.nonzero(sets == t)[0]
            # particleIdx order == insertion order here
            out.append(
                GenerationData(
                    set_num=int(t),
                    serials=np.asarray(self.serial, np.int64)[idx],
                    params=np.stack([self.params[i] for i in idx]),
                    metrics=np.stack([self.metrics[i] for i in idx]),
                    posterior_ranks=np.asarray(self.posterior, np.int64)[idx],
                    statuses=np.asarray(self.status)[idx],
                    seeds=np.asarray(self.seeds, np.uint64)[idx],
                )
            )
        return out

    def write_posterior_ranks(self, serials, ranks):
        for s, r in zip(serials, ranks):
            self.posterior[int(s)] = int(r)

    # -- job queue -----------------------------------------------------------------
    def claim_jobs(self, n=1, serial_req=-1, posterior_req=-1):
        if serial_req > -1:
            # unknown serial -> empty claim (SQLite-store / reference parity)
            chosen = [serial_req] if serial_req < len(self.serial) else []
        elif posterior_req > -1:
            post = np.asarray(self.posterior)
            sets = np.asarray(self.smc_set)
            with_post = sets[post > -1]
            if with_post.size == 0:
                # no posterior-ranked set yet -> empty claim, matching the
                # SQLite store (whose subquery is NULL then, selecting
                # nothing) so the engine API is backend-invariant
                chosen = []
            else:
                max_set = with_post.max()
                chosen = [
                    i for i in range(len(self.serial))
                    if sets[i] == max_set and post[i] == posterior_req
                ]
        else:
            cand = [
                i for i in range(len(self.serial)) if self.status[i] in ("Q", "R")
            ]
            # order by (status, attempts): 'Q' < 'R' lexically, like the SQL
            cand.sort(key=lambda i: (self.status[i], self.attempts[i]))
            chosen = cand if n == -1 else cand[:n]

        now = int(time.time())
        for i in chosen:
            self.start_time[i] = now
            self.status[i] = "R"
            self.attempts[i] += 1
        table = self.upars if self.has_upar else self.params
        return ClaimedJobs(
            serials=np.asarray(chosen, np.int64),
            seeds=np.asarray([self.seeds[i] for i in chosen], np.uint64),
            params=(
                np.stack([table[i] for i in chosen])
                if chosen else np.zeros((0, len(self.par_names)))
            ),
        )

    def read_runnable(self):
        """Read-only claim view: see Storage.read_runnable."""
        chosen = sorted(
            i for i in range(len(self.serial)) if self.status[i] in ("Q", "R")
        )
        table = self.upars if self.has_upar else self.params
        return ClaimedJobs(
            serials=np.asarray(chosen, np.int64),
            seeds=np.asarray([self.seeds[i] for i in chosen], np.uint64),
            params=(
                np.stack([table[i] for i in chosen])
                if chosen else np.zeros((0, len(self.par_names)))
            ),
        )

    def write_results(self, serials, metrics, start_times, durations):
        written = 0
        for s, met, st, dur in zip(serials, metrics, start_times, durations):
            i = int(s)
            if self.status[i] in ("Q", "R", "P"):
                self.metrics[i] = np.asarray(met, np.float64)
                self.start_time[i] = int(st)
                self.duration[i] = float(dur)
                self.status[i] = "D"
                written += 1
        return written

    # -- durability -----------------------------------------------------------------
    def snapshot_to(self, other: Storage):
        """Dump this in-memory run into another store (e.g. SQLite for
        durability / R-vis compatibility). The target must be empty."""
        other.create(self.par_names, self.met_names, self.has_upar)
        gens = self.read_generations()
        for gen in gens:
            idx = [int(s) for s in gen.serials]
            upars = (
                np.stack([self.upars[i] for i in idx])
                if self.has_upar else None
            )
            serials = other.insert_generation(
                gen.set_num,
                gen.params,
                gen.seeds,
                upars,
            )
            done = gen.statuses == "D"
            if done.any():
                other.write_results(
                    serials[done], gen.metrics[done],
                    np.asarray([self.start_time[i] for i in idx])[done],
                    np.nan_to_num(
                        np.asarray([self.duration[i] for i in idx])[done]
                    ),
                )
            ranked = gen.posterior_ranks > -1
            if ranked.any():
                other.write_posterior_ranks(
                    serials[ranked], gen.posterior_ranks[ranked]
                )
        return other
