"""Run-store interface.

The reference uses a 4-table SQLite database as job queue, storage, and
checkpoint at once (src/AbcSmc.cpp:33-36, 819-834). Here the store is an
interface with two implementations:

- :class:`abcsmc_tpu_torch.storage.memstore.MemoryStorage` - in-memory columnar
  tables, the hot path for fully on-device runs,
- :class:`abcsmc_tpu_torch.storage.sqlite_store.SQLiteStorage` - byte-compatible
  reference schema, for durability, multi-process workers, and the reference's
  R visualization scripts.

Job lifecycle parity: status 'Q' (queued) -> 'R' (running) -> 'D' (done), with
'P' (paused) honored in writeback guards; at-least-once execution via re-claiming
of 'R' jobs ordered by (status, attempts) (src/AbcSmc.cpp:983-991) and
first-writeback-wins idempotent updates (src/AbcSmc.cpp:1017-1029).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class GenerationData:
    """All rows of one SMC set, in particleIdx order."""

    set_num: int
    serials: np.ndarray           # [N] int64
    params: np.ndarray            # [N, P] fitting-space values (par table)
    metrics: np.ndarray           # [N, M]; NaN where not yet simulated
    posterior_ranks: np.ndarray   # [N] int64; -1 = not in predictive prior
    statuses: np.ndarray          # [N] unicode in {Q, R, D, P}
    seeds: np.ndarray             # [N] uint64

    @property
    def size(self) -> int:
        return len(self.serials)

    @property
    def complete(self) -> bool:
        return bool(np.all(self.statuses == "D"))

    @property
    def has_posterior(self) -> bool:
        return bool(np.any(self.posterior_ranks > -1))

    def predictive_prior_indices(self) -> np.ndarray:
        """Survivor particle indices ordered by posterior rank
        (src/AbcSmc.cpp:625-631)."""
        mask = self.posterior_ranks > -1
        idx = np.nonzero(mask)[0]
        ranks = self.posterior_ranks[idx]
        order = np.argsort(ranks)
        return idx[order]


@dataclass
class ClaimedJobs:
    serials: np.ndarray       # [n]
    seeds: np.ndarray         # [n] uint64
    params: np.ndarray        # [n, P] *model-space* values (upar table if present)


class Storage:
    """Abstract run store."""

    #: True when one store instance is visible to every process of a
    #: multi-process (jax.distributed) mesh - a SQLite file on a shared
    #: filesystem, the reference's deployment medium. The engine's device
    #: path gates its deterministic-replicated writes to process 0 for
    #: shared stores; process-private stores (MemoryStorage) are written by
    #: every process, each holding its own identical copy.
    shared = True

    def exists(self) -> bool:
        raise NotImplementedError

    def create(self, par_names: list[str], met_names: list[str], has_upar: bool):
        raise NotImplementedError

    def is_empty(self) -> bool:
        """True when the store holds no particle rows. Tables may already
        exist: ``create()`` and the first ``insert_generation`` are separate
        transactions, so a crash between them leaves an existing-but-empty
        store, which the engine repairs by enqueueing generation 0.

        Deliberate deviation (docs/PARITY.md "Deliberate deviations"): the
        reference's build-on-open (src/AbcSmc.cpp:810-874) returns false
        whenever any table exists - even empty - and never repairs this
        crash window; resuming such a database there fails in the weight
        step. The repair here is an intentional improvement."""
        return not self.exists() or len(self.read_generations()) == 0

    def insert_generation(
        self,
        set_num: int,
        params: np.ndarray,
        seeds: np.ndarray,
        upars: np.ndarray | None = None,
        posterior_ranks: np.ndarray | None = None,
        if_empty: bool = False,
    ) -> np.ndarray | None:
        """Enqueue a generation as 'Q' rows; returns assigned serials.

        ``if_empty``: make the insert conditional on the store still holding
        ZERO particle rows, checked atomically inside the insert transaction
        (the crash-window repair path: two workers can both observe an
        empty store, but only one may repair it - the reference's analog is
        the exclusive create-table transaction, src/AbcSmc.cpp:819-835,
        which makes the second process fail instead). Returns None when the
        store turned out non-empty and nothing was inserted."""
        raise NotImplementedError

    def insert_generation_complete(
        self,
        set_num: int,
        params: np.ndarray,
        seeds: np.ndarray,
        metrics: np.ndarray,
        upars: np.ndarray | None = None,
        posterior_ranks: np.ndarray | None = None,
    ) -> np.ndarray:
        """Bulk-insert an already-simulated generation (status 'D', metrics
        filled) - the on-device mirror path. Default: insert + writeback."""
        serials = self.insert_generation(set_num, params, seeds, upars,
                                         posterior_ranks)
        n = len(serials)
        import time as _time

        self.write_results(
            serials, metrics, np.full(n, int(_time.time())), np.zeros(n)
        )
        return serials

    def read_generations(self) -> list[GenerationData]:
        """All sets ascending by smcSet (src/AbcSmc.cpp:562-621)."""
        raise NotImplementedError

    def write_posterior_ranks(self, serials: np.ndarray, ranks: np.ndarray):
        raise NotImplementedError

    def claim_jobs(
        self, n: int = 1, serial_req: int = -1, posterior_req: int = -1
    ) -> ClaimedJobs:
        raise NotImplementedError

    def read_runnable(self) -> ClaimedJobs:
        """claim_jobs(-1)'s SELECT (every job with status Q or R) WITHOUT the
        claim update, ordered by serial. Read-only: the view a non-writer
        process of a multi-process mesh uses to participate in the lockstep
        SPMD simulate of the batch process 0 just claimed (the writer sorts
        its claim by serial too, so both see identical global arrays)."""
        raise NotImplementedError

    def write_results(
        self,
        serials: np.ndarray,
        metrics: np.ndarray,
        start_times: np.ndarray,
        durations: np.ndarray,
    ) -> int:
        """Guarded writeback; returns the number of rows actually updated."""
        raise NotImplementedError
