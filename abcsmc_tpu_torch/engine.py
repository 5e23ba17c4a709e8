"""The SMC orchestrator (port of :class:`abcsmc_tpu.engine.AbcSmc`).

Two ways to run, as in the JAX package:

- the host engine (src/AbcSmc.cpp:452-1066): :meth:`AbcSmc.build_database`,
  :meth:`AbcSmc.process_database` (the brain: read complete sets, rank,
  weigh, propose and enqueue the next set) and
  :meth:`AbcSmc.simulate_next_particles` (claim-and-run workers) over the
  run store as a job queue, and :meth:`AbcSmc.run`, the ``--all`` loop. The
  brain computes on ``self.device`` in ``self.dtype`` (the weights through
  the hand-written kernel on a CUDA engine); simulation runs through the
  config's simulator;
- :meth:`AbcSmc.run_device`: one generation step per set on the device,
  each set mirrored into the store afterwards. It resumes from an existing
  store (at a set boundary or mid-set) and hands a host-only simulator to
  :meth:`AbcSmc.run`. A projection config (PSEUDO/POSTERIOR parameters,
  src/AbcSmc.cpp:54-137, 341-396) takes the projection route instead: the
  host odometer builds the sweep, and the whole sweep is simulated in one
  call on the device.

``run_device(mesh=...)`` shards every step over a particle mesh
(:mod:`abcsmc_tpu_torch.parallel.mesh`): one process with one or more
shards, or several processes in a ``torch.distributed`` group against one
store. Every process computes the same replicated state; the JAX package's
gating decides who writes: process 0 mirrors a shared store
(``_store_writer``), barriers publish its writes (``_mesh_sync``), an error
on one process raises on all (``_writer_guard``), the brain's early stop
reaches every loop (``_broadcast_flag``), and the host engine refuses a
shared store on several processes. The brain runs on the mesh's lead
device. ``weight_precision`` is the weight kernel's dot scheme in the
device step ("high" 3xTF32, "default" one BF16 pass, "highest" FP32
FMAs), as it is the Pallas kernel's in the JAX step; the host brain's
weights run "highest", JAX's default there. A CPU run ignores it, as JAX
off the TPU does.
"""

from __future__ import annotations

import contextlib
import json
import os
import sqlite3
import sys
import time

import numpy as np
import torch

from abcsmc_tpu_torch import reports, spans
from abcsmc_tpu_torch.config import FilterType, NoiseType, SmcConfig, parse_config
from abcsmc_tpu_torch.errors import AbcError, SimulatorError, StorageError
from abcsmc_tpu_torch.models.metrics import Metric, observed_vector
from abcsmc_tpu_torch.models.parameters import ParameterSet
from abcsmc_tpu_torch.models.simulators import (
    DeviceSimulator, Simulator, resolve_simulator,
)
from abcsmc_tpu_torch.models.transforms import ParameterTransform
from abcsmc_tpu_torch.ops import ranking, resample, stats, weights
from abcsmc_tpu_torch.parallel.generation import (
    _SEED_HIGH, Generation, sharded_simulate,
)
from abcsmc_tpu_torch.parallel.mesh import fetch_rows_global, single_mesh
from abcsmc_tpu_torch.storage import MemoryStorage, SQLiteStorage, Storage


#: full-history bytes up to which ``device_dispatch: "auto"`` may take the
#: fused route (the stacked populations live on the device until the mirror)
_FUSED_HISTORY_BYTES = 256 * 2**20
#: replayed sets from which ``device_dispatch: "auto"`` takes the fused
#: route: a capture costs about two eager sets and the stacked history a
#: little more to fetch, so a run must replay a few sets to come out ahead
_AUTO_MIN_REPLAYS = 4
#: rows from which the mirror announces the size of its store write
_MIRROR_NOTICE_ROWS = 1 << 24


def _run_phases(first_set: int, route: str | None) -> dict:
    """A device-path run's "run_device_phases" entry before its spans add
    their seconds, bytes and rows to it."""
    return {"op": "run_device_phases", "sets": 0, "first_set": first_set,
            "route": route, "dispatch_s": 0.0, "mirror_s": 0.0,
            "fetch_s": 0.0, "fetch_bytes": 0, "store_s": 0.0,
            "store_rows": 0, "store_copied_bytes": 0, "report_s": 0.0}


def _host(x) -> np.ndarray:
    """A tensor as a float64 numpy array on the host (syncs the device)."""
    return x.detach().to("cpu", torch.float64).numpy()


class AbcSmc:
    """One ABC-SMC-PLS analysis on one device (``run_device`` also over a
    particle mesh).

    Parameters
    ----------
    config:
        An :class:`SmcConfig`, or a path / dict accepted by
        :func:`parse_config`.
    device:
        "cuda" (default; raises when no CUDA device is visible) or "cpu".
    dtype:
        Working float type of the brain and the device path (default
        float32). The store keeps float64.
    simulator:
        Optional explicit simulator; otherwise bound from the config
        (builtin name, shared object, executable).
    storage:
        Optional run store; defaults to SQLite at
        ``config.database_filename``, or in-memory when no filename is set.
    """

    def __init__(
        self,
        config: SmcConfig | str | dict,
        *,
        device="cuda",
        dtype=torch.float32,
        simulator: Simulator | None = None,
        storage: Storage | None = None,
    ):
        from abcsmc_tpu_torch import resolve_device

        if not isinstance(config, SmcConfig):
            config = parse_config(config)
        self.config = config
        self.device = resolve_device(device)
        self.dtype = dtype
        self.par_set = ParameterSet.from_specs(config.parameters)
        self.transform = ParameterTransform(config.parameters)
        self.metrics = [Metric.from_spec(m) for m in config.metrics]
        self.obs = observed_vector(self.metrics)
        self.simulator = resolve_simulator(config, simulator)

        if storage is not None:
            self.storage = storage
        elif config.database_filename:
            self.storage = SQLiteStorage(config.database_filename)
        else:
            self.storage = MemoryStorage()
        if hasattr(self.storage, "meta") and self.storage.meta is None:
            from abcsmc_tpu_torch import __version__

            self.storage.meta = {
                "framework": f"abcsmc-tpu-torch {__version__}",
                "created": int(time.time()),
                "config": json.dumps(config.raw) if config.raw else "",
            }

        # POSTERIOR parameters source their values from a previous run's
        # store (src/AbcSmc.cpp:385-396)
        self._posterior_matrix = None
        if self.par_set.posterior_idx:
            post_names = [self.par_set.params[i].short_name
                          for i in self.par_set.posterior_idx]
            src = SQLiteStorage(config.posterior_database_filename)
            self._posterior_matrix = src.read_posterior_matrix(post_names)
            src.close()

        #: per-call stage timings: "process" / "rank" / "simulate" entries
        #: from the host engine; from the device path one
        #: "device_generation" entry per set (its "set"; CUDA-event
        #: milliseconds of the step, "device_ms", and of its stages,
        #: "simulate_ms", "pls_fit_ms", "vdv_ms", "topk_ms", "weights_ms",
        #: "propose_ms", "mvn_ms", each None where the stage did not run or
        #: was not timed: the CPU, a replayed set, a filter without PLS,
        #: INDEPENDENT noise; the simulator's time steps a row, "sim_steps",
        #: each of its device counts a row under its name (``ricker``:
        #: "sim_grid_steps", "sim_clamped_draws"), the milliseconds of its
        #: row statistics, "sim_stats_ms" (span "abcsmc.sim.stats"; None
        #: but on an eager set on the card of a simulator that times them),
        #: and the MULTIVARIATE proposal's Cholesky factor, "mvn_factor")
        #: and one "run_device_phases" entry per run ("first_set", "sets";
        #: the host seconds of the graph captures, span "abcsmc.capture",
        #: in "capture_s" and of the replayed sets, span "abcsmc.replay",
        #: in "replay_s"; the host
        #: seconds of the spans "abcsmc.dispatch" in "dispatch_s" and
        #: "abcsmc.mirror" in "mirror_s", inside it "abcsmc.fetch" in
        #: "fetch_s" with the bytes copied from the device in "fetch_bytes",
        #: "abcsmc.store.<method>" in "store_s" with the rows written in
        #: "store_rows" and the rise of the memory store's ``copied_bytes``
        #: in "store_copied_bytes", "abcsmc.report.filtering" and, after
        #: the mirror,
        #: "abcsmc.report.convergence" in "report_s"; a split-propose set is
        #: fetched inside the dispatch); one "simulate_device" entry per set
        #: from the projection route
        self.timings: list[dict] = []
        #: the particle mesh of the running device-path call (one shard on
        #: ``self.device`` without a mesh), None elsewhere: the gating below
        #: and the projection's simulate read it
        self._mesh = None
        self._stopped_early = False
        self._particle_parameters: list[np.ndarray] = []
        self._particle_metrics: list[np.ndarray] = []
        self._predictive_prior: list[np.ndarray] = []
        self._weights: list[np.ndarray] = []
        self._doubled_variance: list[np.ndarray] = []

    @classmethod
    def direct(
        cls,
        parameters: list[dict],
        metrics: list[dict],
        num_samples,
        smc_iterations: int | None = None,
        predictive_prior_fraction=None,
        predictive_prior_size=None,
        pls_training_fraction: float = 0.5,
        noise: str = "INDEPENDENT",
        database_filename: str = "",
        simulator: Simulator | None = None,
        storage: Storage | None = None,
        device="cuda",
        dtype=torch.float32,
        **extra,
    ) -> "AbcSmc":
        """Programmatic construction without a config file, the reference's
        'direct' example surface (examples/direct/main.cpp:
        add_next_parameter / add_next_metric / set_smc_iterations /
        set_num_samples / ...). ``parameters`` and ``metrics`` take the
        same dicts as the JSON schema; ``extra`` any other config key."""
        cfg: dict = {
            "parameters": parameters,
            "metrics": metrics,
            "num_samples": num_samples,
            "pls_training_fraction": pls_training_fraction,
            "noise": noise,
            **extra,
        }
        if smc_iterations is not None:
            cfg["smc_iterations"] = smc_iterations
        if predictive_prior_fraction is not None:
            cfg["predictive_prior_fraction"] = predictive_prior_fraction
        if predictive_prior_size is not None:
            cfg["predictive_prior_size"] = predictive_prior_size
        if database_filename:
            cfg["database_filename"] = database_filename
        return cls(cfg, device=device, dtype=dtype, simulator=simulator,
                   storage=storage)

    @property
    def npar(self) -> int:
        return self.config.npar

    @property
    def nmet(self) -> int:
        return self.config.nmet

    # ------------------------------------------------------------ helpers
    def _generator(self, seed: int) -> torch.Generator:
        """The brain's generator for one pass, on the engine's device, seeded
        as the JAX brain's key (``seed & 0xFFFFFFFF``)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed) & 0xFFFFFFFF)
        return gen

    def _tensor(self, x) -> torch.Tensor:
        """Host rows as a contiguous ``self.dtype`` tensor on the device."""
        return torch.as_tensor(np.asarray(x)).to(
            self.device, self.dtype).contiguous()

    def _draw_seeds(self, generator: torch.Generator, n: int) -> np.ndarray:
        """Per-particle stored RNG seeds in [0, 2^31 - 1)
        (src/AbcSmc.cpp:535-537)."""
        return torch.randint(0, _SEED_HIGH, (n,), generator=generator,
                             device=self.device).cpu().numpy().astype(
                                 np.uint64)

    def _reset_state(self):
        for lst in (self._particle_parameters, self._particle_metrics,
                    self._weights, self._predictive_prior,
                    self._doubled_variance):
            lst.clear()

    # ------------------------------------------------------ build (set 0)
    def build_database(self, seed: int = 0, verbose: bool = False) -> bool:
        """Create the store and enqueue set 0 unless it holds rows
        (src/AbcSmc.cpp:810-874). Returns True if it enqueued set 0.

        An existing store with no rows (a crash between table creation and
        the first insert) is repaired by enqueueing set 0 into its tables,
        after checking that their columns match the config."""
        repairing = False
        if self.storage.exists():
            if not self.storage.is_empty():
                return False
            repairing = True
            want_par = list(self.par_set.short_names())
            want_met = [m.short_name for m in self.metrics]
            have_par = list(getattr(self.storage, "par_names", want_par))
            have_met = list(getattr(self.storage, "met_names", want_met))
            if have_par != want_par or have_met != want_met:
                raise StorageError(
                    "existing (empty) database schema does not match the "
                    f"configuration: par columns {have_par} vs config "
                    f"{want_par}; met columns {have_met} vs config "
                    f"{want_met}",
                    code=1,
                )
        else:
            self.storage.create(
                self.par_set.short_names(),
                [m.short_name for m in self.metrics],
                self.transform.has_any,
            )
        gen = self._generator(seed)
        n = self.config.smc_size_at(0)
        samples = self.par_set.sample_priors(gen, n, self.dtype,
                                             self._posterior_matrix)
        seeds = self._draw_seeds(gen, n)
        upars = (_host(self.transform.to_model_space(samples))
                 if self.transform.has_any else None)
        # a projection over a posterior keeps each row's source rank
        ranks = None
        if self.config.retain_posterior_rank and self.par_set.posterior_idx:
            ranks = self.par_set.indexed_grid_values(n)[1]
        serials = self.storage.insert_generation(
            0, _host(samples), seeds, upars, ranks, if_empty=repairing
        )
        # None: another worker repaired the store between the emptiness
        # check and the insert; read it like any other store
        return serials is not None

    # ------------------------------------------------------------ process
    def process_database(self, seed: int = 0, verbose: bool = False) -> bool:
        """The SMC brain (src/AbcSmc.cpp:452-559): build if absent;
        otherwise read the complete sets, rank any unranked set, weigh,
        report, and enqueue the next set if more are needed. Returns False
        when a set is not complete yet."""
        self._stopped_early = False
        if self.build_database(seed, verbose):
            return True
        self._reset_state()

        t0 = time.perf_counter()
        gens, rank_s, weight_s = self._read_smc_sets()
        t_read = time.perf_counter() - t0
        if gens is None:
            return False
        next_set = len(gens)
        last_set = next_set - 1

        reports.report_convergence_data(self, last_set)
        sys.stderr.write("\n\n")

        t0 = time.perf_counter()
        t_enqueue = 0.0
        more = self.config.num_smc_sets > next_set
        self._stopped_early = more and self._converged()
        if more and not self._stopped_early:
            gen = self._generator(seed)
            n = self.config.smc_size_at(next_set)
            surv = self._predictive_prior[last_set]
            prev_params = self._tensor(self._particle_parameters[last_set][surv])
            prev_w = self._tensor(self._weights[last_set])
            method = self.config.resample_method
            if self.config.noise == NoiseType.MULTIVARIATE:
                L = resample.setup_mvn_sampler(prev_params)
                noised = resample.sample_mvn_predictive_priors(
                    gen, n, prev_w, prev_params, self.par_set, L,
                    self.config.max_retries, method,
                )
            else:
                noised = resample.sample_predictive_priors(
                    gen, n, prev_w, prev_params, self.par_set,
                    self._tensor(self._doubled_variance[last_set]),
                    self.config.max_retries, method,
                )
            if verbose:
                sys.stderr.write(
                    f"Populating next set using {self.config.noise.name} "
                    "noising of parameters.\n"
                )
            params = _host(noised)
            seeds = self._draw_seeds(gen, n)
            upars = (_host(self.transform.to_model_space(noised))
                     if self.transform.has_any else None)
            t1 = time.perf_counter()
            self.storage.insert_generation(next_set, params, seeds, upars)
            t_enqueue = time.perf_counter() - t1
        elif not more:
            sys.stderr.write(
                f"Database already contains {self.config.num_smc_sets} "
                "complete sets.\n"
            )
        self.timings.append({
            "op": "process", "sets": next_set,
            "read_rank_weight_s": round(t_read, 4),
            "rank_s": round(rank_s, 4),
            "weight_s": round(weight_s, 4),
            "propose_s": round(time.perf_counter() - t0 - t_enqueue, 4),
            "enqueue_s": round(t_enqueue, 4),
        })
        return True

    def _read_smc_sets(self):
        """read_SMC_sets_from_database (src/AbcSmc.cpp:562-679): every set
        must be complete and of the configured size. Returns (the sets, or
        None when one is incomplete; rank seconds; weight seconds)."""
        gens = self.storage.read_generations()
        rank_s = weight_s = 0.0
        for gen in gens:
            t = gen.set_num
            if not gen.complete:
                sys.stderr.write(
                    "ERROR: Failed to read SMC set from database because not "
                    f"all particles are complete in set {t}\n"
                )
                return None, rank_s, weight_s
            if gen.size != self.config.smc_size_at(t):
                raise StorageError(
                    f"Set {t} in configuration file has size "
                    f"{self.config.smc_size_at(t)} vs size {gen.size} in "
                    "database.",
                    code=1,
                )
            self._particle_parameters.append(gen.params)
            self._particle_metrics.append(gen.metrics)
            if self.config.projection_mode:
                # no filtering or weighting: the sweep itself is the
                # product; retained ranks, if any, came from the source
                # posterior (src/AbcSmc.cpp:341, 849-853)
                surv = (gen.predictive_prior_indices() if gen.has_posterior
                        else np.arange(gen.size))
                self._predictive_prior.append(surv)
                self._doubled_variance.append(
                    _host(stats.doubled_variance(self._tensor(gen.params))))
                self._weights.append(np.full(len(surv), 1.0 / len(surv)))
                continue
            dt_rank, dt_weight = self._ingest_complete_set(gen, t)
            rank_s += dt_rank
            weight_s += dt_weight
        return gens, rank_s, weight_s

    def _ingest_complete_set(self, gen, t: int):
        """Survivors (ranked and written back if the set is unranked) and
        weights of one complete set; its params and metrics are already
        appended. Returns (rank seconds, weight seconds)."""
        dt_rank = 0.0
        if gen.has_posterior:
            self._predictive_prior.append(gen.predictive_prior_indices())
        else:
            t0 = time.perf_counter()
            order, ncomp = self._rank_particles(gen.metrics, gen.params)
            keep = self.config.pred_prior_size_at(t)
            surv = order[:keep]
            dt_rank = time.perf_counter() - t0
            self.timings.append({"op": "rank", "set": t, "ncomp_used": ncomp,
                                 "rank_s": round(dt_rank, 4)})
            self._predictive_prior.append(surv)
            self.storage.write_posterior_ranks(gen.serials[surv],
                                               np.arange(keep))
            reports.filtering_report(self, t, gen.params[surv],
                                     gen.metrics[surv])
        t0 = time.perf_counter()
        self._calculate_predictive_prior_weights(t)
        return dt_rank, time.perf_counter() - t0

    def _rank_particles(self, mets, pars):
        """(full ascending order as numpy, PLS components used; 0 for
        SIMPLE), computed on the engine's device."""
        if self.config.filter == FilterType.PLS:
            order, _, ncomp = ranking.ranking_pls(
                self._tensor(mets), self._tensor(pars), self._tensor(self.obs),
                self.config.pls_training_fraction,
                box_cox=self.config.box_cox,
                optimal_method=self.config.pls_optimal_method,
            )
        else:
            order, _ = ranking.ranking_simple(self._tensor(mets),
                                              self._tensor(self.obs))
            ncomp = 0
        return order.cpu().numpy(), ncomp

    def _calculate_predictive_prior_weights(self, set_num: int):
        """src/AbcSmc.cpp:1041-1066, on the engine's device: set 0 is
        uniform, later sets go through the kernel-mixture weights."""
        assert len(self._doubled_variance) == set_num
        surv = self._predictive_prior[set_num]
        pars = self._tensor(self._particle_parameters[set_num][surv])
        self._doubled_variance.append(_host(stats.doubled_variance(pars)))
        if set_num == 0:
            w = weights.uniform_weights(len(surv), device=self.device,
                                        dtype=self.dtype)
        else:
            prev_surv = self._predictive_prior[set_num - 1]
            w = weights.weight_predictive_prior(
                pars,
                self._tensor(self._particle_parameters[set_num - 1][prev_surv]),
                self._tensor(self._weights[set_num - 1]),
                self._tensor(self._doubled_variance[set_num - 1]),
                self.par_set.prior_log_pdf,
            )
        self._weights.append(_host(w))

    # ----------------------------------------------------------- simulate
    def simulate_next_particles(self, n: int = 1, serial_req: int = -1,
                                posterior_req: int = -1) -> bool:
        """Claim-and-run workers (src/AbcSmc.cpp:967-1039): claim up to n
        queued or stuck-running jobs (-1 = all), run the simulator (a device
        simulator on the engine's device and dtype), write the metrics back
        guarded by job status.

        Inside ``run_device``'s projection sweep the batch is simulated
        over the run's particle mesh
        (:func:`~abcsmc_tpu_torch.parallel.generation.sharded_simulate`,
        JAX engine :1387-1446): on several processes against a shared
        store process 0 claims, the others read the same rows after a
        barrier, both in serial order, and only the store writer writes
        back."""
        assert n == 1 or (serial_req == -1 and posterior_req == -1)
        assert serial_req == -1 or posterior_req == -1
        if self.simulator is None:
            raise SimulatorError(
                "simulator not set (no executable/shared/builtin binding)",
                code=-211,
            )
        mesh = self._mesh
        t0 = time.perf_counter()
        claimed = self._claim_jobs(n, serial_req, posterior_req)
        t_claim = time.perf_counter() - t0
        if claimed.serials.size == 0:
            return True
        start = time.time()
        t0 = time.perf_counter()
        if mesh is None:
            mets = self.simulator.run_batch(
                claimed.params, claimed.seeds, claimed.serials,
                device=self.device, dtype=self.dtype,
            )
        else:
            mets = sharded_simulate(
                self.simulator, mesh,
                torch.as_tensor(np.asarray(claimed.params, np.float64)).to(
                    self.dtype),
                torch.as_tensor(claimed.seeds.astype(np.int64)),
                len(claimed.serials),
            )
        t_sim = time.perf_counter() - t0
        if mets.shape[1] != self.nmet:
            raise SimulatorError(
                "simulator function returned the wrong number of metrics: "
                f"expected {self.nmet}, received {mets.shape[1]}",
                code=-211,
            )
        if not np.isfinite(mets).all():
            # non-finite metric bandaid (src/AbcMPI.cpp:81-94): the row's
            # metrics become DBL_MIN
            bad = ~np.isfinite(mets).all(axis=1)
            sys.stderr.write(
                f"WARNING: {int(bad.sum())} particle(s) returned non-finite "
                "metrics; overwriting with DBL_MIN\n"
            )
            mets = np.array(mets)
            mets[bad] = np.finfo(np.float64).tiny
        nrun = len(claimed.serials)
        t0 = time.perf_counter()
        with self._writer_guard("the simulate writeback"):
            if self._store_writer():
                self.storage.write_results(
                    claimed.serials, mets, np.full(nrun, int(start)),
                    np.full(nrun, t_sim / max(nrun, 1)),
                )
        self.timings.append({
            "op": "simulate", "n": nrun, "claim_s": round(t_claim, 4),
            "sim_s": round(t_sim, 4),
            "writeback_s": round(time.perf_counter() - t0, 4),
        })
        return True

    def _claim_jobs(self, n: int, serial_req: int, posterior_req: int):
        """The jobs :meth:`simulate_next_particles` runs. On a
        multi-process mesh against a shared store every process must
        simulate the same batch: process 0 claims, and the others read the
        runnable rows once its claim is done, both in serial order."""
        if not (self._multi() and getattr(self.storage, "shared", True)):
            with self._writer_guard("the job claim"):
                return self.storage.claim_jobs(n, serial_req, posterior_req)
        claimed = None
        with self._writer_guard("the job claim"):
            if self._proc0():
                claimed = self.storage.claim_jobs(n, serial_req,
                                                  posterior_req)
                order = np.argsort(claimed.serials)
                claimed = type(claimed)(
                    serials=claimed.serials[order],
                    seeds=claimed.seeds[order],
                    params=claimed.params[order],
                )
        self._mesh_sync()   # the writer's claim happens-before the read
        with self._writer_guard("the runnable-row read"):
            if not self._proc0():
                claimed = self.storage.read_runnable()
        return claimed

    def simulate_particle_by_serial(self, serial_req: int) -> bool:
        return self.simulate_next_particles(1, serial_req, -1)

    def simulate_particle_by_posterior_idx(self, posterior_req: int) -> bool:
        return self.simulate_next_particles(1, -1, posterior_req)

    # ---------------------------------------------------------- full loop
    def _nrmse_converged(self, survivor_metrics, set_num: int) -> bool:
        """Early-stopping rule: NRMSE of the posterior metric means vs
        observed below ``config.nrmse_tolerance`` (0 = off)."""
        tol = self.config.nrmse_tolerance
        if not tol:
            return False
        sm = torch.as_tensor(survivor_metrics).detach().to("cpu",
                                                           torch.float64)
        val = float(stats.nrmse(sm, torch.as_tensor(self.obs)))
        if val < tol:
            sys.stderr.write(
                f"Converged: NRMSE {val:.6g} < tolerance {tol} after set "
                f"{set_num}; stopping early.\n"
            )
            return True
        return False

    def _converged(self) -> bool:
        if not self.config.nrmse_tolerance or not self._predictive_prior:
            return False
        t = len(self._predictive_prior) - 1
        surv = self._predictive_prior[t]
        return self._nrmse_converged(self._particle_metrics[t][surv], t)

    def run(self, seed: int = 0, verbose: bool = False):
        """The --all loop (examples/include/examples.h:57-94): per set,
        process then simulate the whole set; one final process pass reads
        the last posterior. Stops early at ``config.nrmse_tolerance``."""
        for t in range(self.config.num_smc_sets):
            self.process_database(seed + t, verbose)
            if self._stopped_early:
                return self
            self.simulate_next_particles(n=-1)
        self.process_database(seed + self.config.num_smc_sets, verbose)
        return self

    # ------------------------------------------------ multi-process gating
    def _proc0(self) -> bool:
        """True on process 0 of the running device path's mesh (every
        one-process mesh, and the host engine): the single writer of the
        device path's replicated store mutations on a multi-process mesh
        (JAX engine :154-165). Every process computes the same
        generations, so without this gate each would race to mirror the
        same rows into a shared store."""
        return self._mesh is None or self._mesh.process_index == 0

    def _store_writer(self) -> bool:
        """True when this process performs the replicated store writes:
        process 0 of a shared store, every process of a private one (each
        then holds its own identical copy)."""
        return self._proc0() or not getattr(self.storage, "shared", True)

    def _require_single_process_for_host_fallback(self, why: str) -> None:
        """The host engine (:meth:`run`) has no process gating: on several
        processes against a shared store each would drive the brain at once.
        Refuse instead; process-private stores run independent identical
        host fits."""
        import torch.distributed as dist

        if (dist.is_initialized() and dist.get_world_size() > 1
                and getattr(self.storage, "shared", True)):
            raise AbcError(
                f"run_device: {why}, which requires the host engine - but "
                "the host engine cannot run on a multi-process mesh against "
                "a shared store (no single-writer gating). Run it as one "
                "process, or give each process a private store.",
            )

    def _multi(self) -> bool:
        return self._mesh is not None and self._mesh.multi_process

    def _mesh_sync(self):
        """Barrier across the processes of the run's mesh: a store write by
        the writer before it is visible to every process's read after it.
        No-op with one process."""
        if self._multi():
            self._mesh.barrier()

    def _broadcast_flag(self, value: bool) -> bool:
        """Process 0's boolean on every process (an early stop decided by
        the writer's brain must end every process's loop)."""
        if self._multi():
            return self._mesh.broadcast_flag(value)
        return bool(value)

    @contextlib.contextmanager
    def _writer_guard(self, what: str):
        """A scope of fallible work that one process does and the others do
        not (the store writer's writes): a local error is held, the
        processes agree on whether any failed, then the failing process
        re-raises its own error and the peers raise a coded
        :class:`AbcError` naming the phase, instead of waiting in the next
        collective until its timeout. No collective may run inside the
        scope. One process: the error is re-raised as it is."""
        err: Exception | None = None
        try:
            yield
        except Exception as e:  # noqa: BLE001 - re-raised after agreeing
            err = e
        if self._multi():
            failed = self._mesh.any_process(err is not None)
            if err is not None:
                raise err
            if failed:
                raise AbcError(
                    f"a peer process failed during {what}; aborting this "
                    "process instead of hanging in the next collective "
                    "(see the failing process's traceback)",
                )
        elif err is not None:
            raise err

    def _fetch_global(self, x, axis: int = 0) -> np.ndarray:
        """A device leaf as a host array: a shard list through
        :func:`~abcsmc_tpu_torch.parallel.mesh.fetch_rows_global` (every
        process gets every row, a large buffer window by window), a
        replicated tensor as it is."""
        if isinstance(x, list):
            return fetch_rows_global(x, self._mesh, axis=axis)
        return x.detach().cpu().numpy()

    # --------------------------------------------------------- device path
    def _resume_point(self, seed: int, verbose: bool):
        """Rebuild the state of the sets the store already holds
        (src/AbcSmc.cpp:452-479, completeness gating at :571-592). Returns
        ("done", None), ("host", None) when more than one set is incomplete,
        or ("device", pending): the set the device loop starts from, None
        for a fresh store."""
        cfg = self.config
        if not self.storage.exists():
            return "device", None
        gens = self.storage.read_generations()
        for g in gens:
            if g.size != cfg.smc_size_at(g.set_num):
                raise StorageError(
                    f"Set {g.set_num} in configuration file has size "
                    f"{cfg.smc_size_at(g.set_num)} vs size {g.size} in "
                    "database.",
                    code=1,
                )
        n_complete = 0
        while n_complete < len(gens) and gens[n_complete].complete:
            n_complete += 1
        if len(gens) - n_complete > 1:
            # not a state this engine produces: the host path reports it
            self._require_single_process_for_host_fallback(
                "the store holds more than one incomplete set")
            return "host", None
        if n_complete == len(gens):
            # at a set boundary: the brain ingests, reports, honours the
            # early stop and enqueues the next set (or finds the run done).
            # Only the store writer runs it; the others wait for its
            # enqueue, take its stop decision and rebuild the same state
            # from the store it has just ranked
            with self._writer_guard("the boundary-resume brain pass"):
                if self._store_writer():
                    self.process_database(seed, verbose)
            self._mesh_sync()
            stopped = self._broadcast_flag(self._stopped_early)
            with self._writer_guard("the boundary-resume state rebuild"):
                gens = self.storage.read_generations()
                if not self._store_writer():
                    done = gens if gens[-1].complete else gens[:-1]
                    for t, g in enumerate(done):
                        self._particle_parameters.append(g.params)
                        self._particle_metrics.append(g.metrics)
                        self._ingest_complete_set(g, t)
            if stopped or gens[-1].complete:
                return "done", None
        else:
            for t, g in enumerate(gens[:n_complete]):
                self._particle_parameters.append(g.params)
                self._particle_metrics.append(g.metrics)
                self._ingest_complete_set(g, t)
        return "device", gens[-1]

    def run_device(self, seed: int = 0, verbose: bool = False,
                   mirror_store: bool = True, mesh=None):
        """SMC on ``self.device``: one generation step per set
        (:class:`abcsmc_tpu_torch.parallel.generation.Generation`), every
        draw from one ``torch.Generator`` seeded with ``seed``. The sets stay
        on the device until the end; then each is fetched once and mirrored
        into the run store, and the reports are printed.
        ``mirror_store=False`` skips every store write: the posterior state
        in memory, the reports and the surfaces built on them
        (:meth:`posterior`, :meth:`ess`, :meth:`posterior_summary`,
        :meth:`posterior_predictive`) are all a run then leaves.

        An existing store resumes where it stopped. At a set boundary the
        brain (:meth:`process_database`) enqueues the next set first;
        mid-set, the rows already 'D' keep their stored metrics and only the
        others are simulated, on the device, from their stored seeds. A
        host-only simulator runs the host engine (:meth:`run`) instead.

        Routes (config ``device_dispatch``). ``"sequential"``: one eager
        step per set. ``"fused"``: a fresh run goes through
        ``Generation.run_chain`` (route "scan" where every set has one
        ``(n, keep)``, "chain" otherwise): on a CUDA device each same-shape
        bucket replays one CUDA graph of the step per set, MULTIVARIATE
        noise included (its rejection loop runs a fixed block of rounds in
        the graph; the count is read once per set after the replay, and a
        set whose rows are not all accepted within the block finishes its
        rounds eagerly before the next set); on the CPU the chain runs
        eagerly (said under ``verbose``, and every set's route is in
        ``timings``). Every set is computed, and an ``nrmse_tolerance``
        cuts the mirror at the first converged set afterwards: the stored
        rows are the sequential run's. ``"auto"`` takes the fused route
        only where at least 4 sets would replay a graph and the full
        history (every set's population, stacked on the device) stays
        under 256 MiB, and is sequential otherwise: PERF.md, section 6
        ("fused dispatch"), has the readings on an NVIDIA H100 behind that
        rule (stored rows equal on both routes; with 4 replays the wall
        was shorter or within 5 %, with 3 inside the spread of two
        sequential runs). A resumed run, and a
        run in which any set proposes apart from its ranking
        (``propose_split``, or its auto rule at sizes near the card's
        memory), is sequential: such a set is ranked, fetched and freed
        before its proposal is made (rank -> fetch -> free -> propose).
        ``row_block`` chunks the row passes on every route.

        ``mesh`` (:func:`~abcsmc_tpu_torch.parallel.mesh.particle_mesh`)
        shards every step over its shards; the brain then runs on the
        mesh's lead device. A mesh of several shards draws each shard's
        rows from its own generator (the run's generator, on the CPU, draws
        the shared seeds), so its rows differ from a one-shard run's; with
        one shard they are the same. On a mesh whose shards all sit on one
        CUDA device the fused route replays CUDA graphs as above; across
        devices or processes its sets run eagerly. Every process of a
        multi-process mesh calls ``run_device`` with the same arguments;
        process 0 writes a shared store and prints the reports."""
        if mesh is not None:
            self.device = mesh.lead
        if not isinstance(self.simulator, DeviceSimulator):
            self._require_single_process_for_host_fallback(
                "the configuration is not device-runnable")
            if verbose:
                sys.stderr.write(
                    "run_device: configuration not device-runnable, "
                    "falling back to host engine\n"
                )
            return self.run(seed, verbose)
        # the gating runs on the one-shard mesh too, where it is a no-op
        self._mesh = single_mesh(self.device) if mesh is None else mesh
        try:
            return self._run_device_on_mesh(seed, verbose, mirror_store,
                                            mesh)
        finally:
            self._mesh = None

    def _run_device_on_mesh(self, seed, verbose, mirror_store, mesh):
        """:meth:`run_device` of a device-runnable configuration, its
        gating on ``self._mesh``; the step takes ``mesh`` (None: plain
        tensors on ``self.device``)."""
        cfg = self.config
        if (cfg.projection_mode or self.par_set.pseudo_idx
                or self.par_set.posterior_idx):
            return self._run_device_projection(seed, verbose)
        self._reset_state()
        kind, pending = self._resume_point(seed, verbose)
        if kind == "done":
            return self
        if kind == "host":
            self._mesh = None
            return self.run(seed, verbose)
        t_first = 0 if pending is None else pending.set_num
        gen = Generation(
            self.par_set, self.transform, self.simulator, self.obs,
            device=self.device, mesh=mesh, dtype=self.dtype,
            filter_type=cfg.filter,
            noise_type=cfg.noise,
            training_fraction=cfg.pls_training_fraction,
            max_retries=cfg.max_retries,
            pls_optimal_method=cfg.pls_optimal_method,
            resample_method=cfg.resample_method,
            box_cox=cfg.box_cox,
            weight_precision=cfg.weight_precision,
            row_block=cfg.row_block,
            propose_split=cfg.propose_split,
            topk_two_stage=cfg.topk_two_stage,
        )
        # a mesh of several shards draws only host seeds from the run's
        # generator (each shard's rows come from its own): no device sync
        generator = torch.Generator(
            device=self.device if gen.mesh.size == 1 else "cpu")
        generator.manual_seed(int(seed) & 0xFFFFFFFFFFFFFFFF)

        # ---- the route ----
        n_sets = cfg.num_smc_sets
        sizes = [cfg.smc_size_at(t) for t in range(n_sets)]
        keeps = [cfg.pred_prior_size_at(t) for t in range(n_sets)]
        item = torch.empty((), dtype=self.dtype).element_size()
        hist_bytes = sum(n_t * ((self.npar + self.nmet) * item + 8)
                         for n_t in sizes)
        any_split = any(
            gen.split_propose_active(sizes[t],
                                     sizes[t + 1] if t + 1 < n_sets else 0)
            for t in range(n_sets)
        )
        fused_ok = (
            pending is None and t_first == 0
            and (cfg.device_dispatch == "fused"
                 or (cfg.device_dispatch == "auto"
                     and hist_bytes <= _FUSED_HISTORY_BYTES
                     and gen.planned_replays(sizes, keeps)
                     >= _AUTO_MIN_REPLAYS))
            and not any_split
        )
        route = ("sequential" if not fused_ok
                 else "scan" if len(set(zip(sizes, keeps))) == 1
                 else "chain")
        if verbose and fused_ok:
            blocker = gen.capture_blocker()
            sys.stderr.write(
                f"run_device: fused dispatch ({route}): "
                + ("same-shape sets replay one CUDA graph of the step\n"
                   if blocker is None else
                   f"the step is not capturable ({blocker}), running the "
                   "eager chain\n"))

        # filled by the run's spans as they run, appended to ``timings``
        # after the mirror
        phases = _run_phases(t_first, route)
        pending_serials = None
        with spans.host(phases, "dispatch_s", "abcsmc.dispatch"):
            if not fused_ok:
                fetched, info, pending_serials = self._run_sequential(
                    gen, generator, pending, t_first, sizes, keeps, phases)
            else:
                _, entries = gen.run_chain(generator, sizes, keeps,
                                           full_history=True,
                                           bucketed_history=True)
                fetched, info = None, gen.set_info

        # ---- fetch every set once, then mirror into the run store ----
        with spans.host(phases, "mirror_s", "abcsmc.mirror"):
            with spans.host(phases, "fetch_s", "abcsmc.fetch"):
                if fetched is None:
                    fetched = self._fetch_history(entries, t_first, phases)
                    del entries
                else:
                    fetched = [tuple(self._fetch_counted(x, phases)
                                     for x in tup) for tup in fetched]
            # the mirror is collective-free: a store error on the writer
            # must not leave its peers waiting in the barrier below
            with self._writer_guard("the store mirror"):
                self._mirror_fetched_sets(fetched, t_first, pending_serials,
                                          mirror_store, phases)
            # the mirror appended one "device_generation" entry per set, in
            # order
            for entry, inf in zip(self.timings[-len(fetched):], info):
                ev, sim = inf["events"], inf["sim_events"]
                entry["route"] = inf["route"]
                entry["device_ms"] = ev[0].elapsed_time(ev[1]) if ev else None
                entry["simulate_ms"] = (sim[0].elapsed_time(sim[1]) if sim
                                        else None)
                entry.update(spans.stage_ms(inf["stages"]))
                # the MULTIVARIATE rejection loop's count (read once per
                # set), and whether its rounds ran past the block a replay
                # holds
                entry["mvn_rounds"] = inf["mvn_rounds"]
                entry["mvn_finished_eagerly"] = inf["mvn_finished_eagerly"]
                # the proposal's Cholesky factor (None: not MULTIVARIATE,
                # or the set proposed nothing), and the simulator's time
                # steps a row (None: no time loop, or nothing simulated)
                entry["mvn_factor"] = (
                    None if inf["mvn_factor"] is None
                    else _host(inf["mvn_factor"]).tolist())
                entry["sim_steps"] = inf["sim_steps"]
                # the rise of the simulator's device counts a row (a replay
                # its own), and the CUDA-event milliseconds of its row
                # statistics (an eager set on the card)
                if inf["sim_counts"] is not None:
                    entry.update(zip(gen.simulator.count_names,
                                     _host(inf["sim_counts"]).tolist()))
                stats = inf["sim_stats_events"]
                entry["sim_stats_ms"] = (
                    sum(a.elapsed_time(b) for a, b in stats) if stats
                    else None)
                if inf["box_cox_lambdas"] is not None:
                    entry["box_cox_lambdas"] = _host(
                        inf["box_cox_lambdas"]).tolist()
        phases.update({
            "sets": len(fetched),
            # what the host submitted: init, steps, proposals and graph
            # replays (one per set on every route), and the graphs apart
            "programs": gen.dispatches,
            "graph_captures": gen.graph_captures,
            "graph_replays": gen.graph_replays,
            "capture_s": gen.capture_seconds,
            "replay_s": gen.replay_seconds,
            "mvn_eager_finishes": gen.mvn_eager_finishes,
            "shards": gen.mesh.size,
        })
        self.timings.append(phases)
        if self._proc0():
            with spans.host(phases, "report_s", "abcsmc.report.convergence"):
                reports.report_convergence_data(
                    self, t_first + len(fetched) - 1)
        # every process may read the store once run_device returns
        self._mesh_sync()
        return self

    def _run_sequential(self, gen, generator, pending, t_first, sizes,
                        keeps, phases):
        """One eager step per set from ``t_first`` on. Returns (per-set
        tuples (params, seeds, metrics, survivor_idx, weights,
        doubled_variance, ncomp_used): device tensors, or host arrays for
        a split-propose set, fetched here under the run's ``phases``; per-set
        info as ``Generation.set_info``; the serials of a resumed set's
        rows or None)."""
        cfg = self.config
        on_cuda = self.device.type == "cuda"
        n_sets = len(sizes)
        pending_mets = pending_serials = None
        if pending is None:
            params, seeds = gen.init_population(generator, sizes[0])
        else:
            # the pending set padded and cut into the step's shards; its
            # not-yet-done rows simulated over the mesh
            n_t = sizes[t_first]
            host_pars = np.asarray(pending.params, np.float64)
            host_seeds = pending.seeds.astype(np.int64)
            params = gen.shard_rows(
                torch.as_tensor(host_pars).to(self.dtype), n_t)
            seeds = gen.shard_rows(torch.as_tensor(host_seeds), n_t)
            pending_serials = pending.serials
            if np.any(pending.statuses == "D"):
                todo = np.nonzero(pending.statuses != "D")[0]
                merged = np.array(pending.metrics, np.float64)
                if todo.size:
                    upars = self.transform.to_model_space(
                        self._tensor(host_pars)).to(self.dtype)
                    merged[todo] = sharded_simulate(
                        self.simulator, gen.mesh,
                        upars[torch.as_tensor(todo, device=self.device)],
                        torch.as_tensor(host_seeds[todo]), todo.size)
                pending_mets = gen.shard_rows(
                    torch.as_tensor(merged).to(self.dtype), n_t)
        state = None
        if t_first > 0:
            surv = self._predictive_prior[t_first - 1]
            state = (
                self._tensor(self._particle_parameters[t_first - 1][surv]),
                self._tensor(self._weights[t_first - 1]),
                self._tensor(self._doubled_variance[t_first - 1]),
            )

        tuples, info = [], []
        for t in range(t_first, n_sets):
            n_t = sizes[t]
            n_next = sizes[t + 1] if t + 1 < n_sets else 0
            # at sizes near the card's memory the caller's [N, P] / [N, M]
            # buffers must be freed before the proposal's buffers exist:
            # rank -> fetch -> free -> propose, which step() alone cannot do
            split_t = gen.split_propose_active(n_t, n_next)
            draws = (gen.draw_vdv_seed(generator) if split_t
                     else gen.draw_step(generator, n_next))
            eff_next = 0 if split_t else n_next
            ev = None
            if on_cuda:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
            if pending_mets is not None:
                res = gen.step_precomputed(params, pending_mets, keeps[t],
                                           eff_next, draws, state,
                                           n_valid=n_t)
                pending_mets = None
            else:
                res = gen.step(params, seeds, keeps[t], eff_next, draws,
                               state, n_valid=n_t)
            if on_cuda:
                ev[1].record()
            state = (res.survivor_params, res.weights, res.doubled_variance)
            converged = self._nrmse_converged(res.survivor_metrics, t)
            inf = gen.set_record("eager", ev, res)
            info.append(inf)
            if split_t:
                # the set's seven buffers at once, then its O(N) device
                # buffers die before the [N2, P] proposal is made
                with spans.host(phases, "fetch_s", "abcsmc.fetch"):
                    tuples.append(tuple(
                        self._fetch_counted(x, phases) for x in (
                            params, seeds, res.metrics, res.survivor_idx,
                            res.weights, res.doubled_variance,
                            res.ncomp_used)))
                del params, seeds, res
                if converged:
                    break
                draws = gen.draw_proposal(generator, n_next, draws)
                finishes = gen.mvn_eager_finishes
                params, seeds, inf["mvn_rounds"] = gen.propose(
                    *state, n_next, draws)
                inf["mvn_finished_eagerly"] = gen.mvn_eager_finishes > finishes
                del draws
            else:
                tuples.append((params, seeds, res.metrics, res.survivor_idx,
                               res.weights, res.doubled_variance,
                               res.ncomp_used))
                params, seeds = res.next_params, res.next_seeds
                if converged:
                    break
        return tuples, info, pending_serials

    def _fetch_counted(self, x, phases) -> np.ndarray:
        """:meth:`_fetch_global` of a device leaf, its host bytes added to
        ``phases["fetch_bytes"]``; a host array as it is."""
        if isinstance(x, np.ndarray):
            return x
        host = self._fetch_global(x)
        phases["fetch_bytes"] += host.nbytes
        return host

    def _fetch_history(self, entries, t_first: int, phases):
        """The fused routes' history (``("set", leaves)`` / ``("bucket", L,
        stacked leaves)`` entries) as per-set host tuples, the bytes
        fetched added to ``phases["fetch_bytes"]``. With an
        ``nrmse_tolerance`` the small survivor-metric leaves are fetched
        first and the history is cut at the first converged set, exactly
        where the sequential loop stops: the O(N) leaves of the sets after
        it are never fetched. A bucket is fetched whole (sliced on the
        device once where the cut falls inside it) and split per set on
        the host."""
        cut = None
        if self.config.nrmse_tolerance:
            smets = []
            for e in entries:
                sm = _host(e[1][2] if e[0] == "set" else e[2][2])
                phases["fetch_bytes"] += sm.nbytes
                smets.extend([sm] if e[0] == "set" else list(sm))
            cut = len(smets)
            for i, sm in enumerate(smets):
                if self._nrmse_converged(sm, t_first + i):
                    cut = i + 1
                    break
        fetched, s0 = [], 0
        for e in entries:
            blen, h = (1, e[1]) if e[0] == "set" else (e[1], e[2])
            if cut is not None:
                if s0 >= cut:
                    break
                blen = min(blen, cut - s0)
            s0 += blen
            tup = (h[6], h[7], h[8], h[0], h[3], h[4], h[5])
            if e[0] == "set":
                fetched.append(tuple(self._fetch_counted(x, phases)
                                     for x in tup))
                continue
            # stacked shard leaves are [L, local_n, ...]: rows on axis 1
            host = tuple(
                self._fetch_global([y[:blen] for y in x], axis=1)
                if isinstance(x, list) else self._fetch_global(x[:blen])
                for x in tup)
            phases["fetch_bytes"] += sum(leaf.nbytes for leaf in host)
            fetched.extend(tuple(leaf[g] for leaf in host)
                           for g in range(blen))
        return fetched

    def _mirror_fetched_sets(self, fetched, t0: int = 0,
                             pending_serials=None, mirror_store: bool = True,
                             phases: dict | None = None):
        """Mirror the fetched per-set host tuples (sets t0, t0+1, ...) into
        the store and the in-memory posterior state, then print each set's
        filtering report. Set t0's rows already exist when
        ``pending_serials`` is given (a resume): their results are written
        back guarded (rows already 'D' keep their metrics), then their
        ranks. A negative ``ncomp_used`` (the step's U0 self-check) raises
        before any store write for that set. ``mirror_store=False`` writes
        nothing to the store and does the rest. On a multi-process mesh
        only the store writer writes and process 0 reports; every process
        fills its in-memory state. No collective runs in here. The run's
        ``phases`` (:func:`_run_phases`; None: a new one) take the spans'
        seconds, the rows written and the bytes the store copied."""
        cfg = self.config
        if phases is None:
            phases = _run_phases(t0, None)
        mirror_store = mirror_store and self._store_writer()
        if mirror_store and not self.storage.exists():
            with spans.host(phases, "store_s", "abcsmc.store.create"):
                self.storage.create(
                    self.par_set.short_names(),
                    [m.short_name for m in self.metrics],
                    self.transform.has_any,
                )
        copied = getattr(self.storage, "copied_bytes", 0)
        for i, host in enumerate(fetched):
            t = t0 + i
            n_t = cfg.smc_size_at(t)
            (pars_h, seeds_h, mets_h, surv_h, w_h, dv_h, ncomp_h) = host
            ncomp_val = int(np.asarray(ncomp_h))
            if ncomp_val < 0:
                raise AbcError(
                    f"set {t}: PLS component selection self-check failed "
                    f"(ncomp_used={ncomp_val}): the van der Voet moment "
                    "matmul produced a negative sum-of-squares, i.e. it read "
                    "corrupted operands. Re-run with "
                    "pls_optimal_method='tolerance' and report the device "
                    "and library versions.",
                )
            with spans.host(phases, "fetch_s", "abcsmc.fetch"):
                pars_np = np.asarray(pars_h, np.float64)[:n_t]
                seeds_np = np.asarray(seeds_h).astype(np.uint64)[:n_t]
                mets_np = np.asarray(mets_h, np.float64)[:n_t]
                surv = np.asarray(surv_h, np.int64)
                ranks = np.full(len(pars_np), -1, np.int64)
                ranks[surv] = np.arange(len(surv))
            if mirror_store and n_t >= _MIRROR_NOTICE_ROWS:
                # say what the store write will cost instead of looking
                # hung: the streamed insert is linear in the rows
                vals_per_row = self.npar * (2 if self.transform.has_any
                                            else 1) + self.nmet + 3
                sys.stderr.write(
                    f"mirroring set {t}: {n_t:,} rows into the durable "
                    f"store (~{n_t * 10e-6:.0f} s, "
                    f"~{n_t * vals_per_row * 15 / 2**30:.1f} GB on disk; "
                    "pass mirror_store=False to run without durability)\n"
                )
            if mirror_store and i == 0 and pending_serials is not None:
                n_rows = len(pending_serials)
                with spans.host(phases, "store_s",
                                "abcsmc.store.write_results"):
                    self.storage.write_results(
                        pending_serials, mets_np,
                        np.full(n_rows, int(time.time())), np.zeros(n_rows),
                    )
                with spans.host(phases, "store_s",
                                "abcsmc.store.write_posterior_ranks"):
                    self.storage.write_posterior_ranks(pending_serials, ranks)
                phases["store_rows"] += n_rows
            elif mirror_store:
                with spans.host(phases, "store_s",
                                "abcsmc.store.insert_generation_complete"):
                    upars = (
                        self.transform.to_model_space(
                            torch.as_tensor(pars_np)).numpy()
                        if self.transform.has_any else None
                    )
                    self.storage.insert_generation_complete(
                        t, pars_np, seeds_np, mets_np, upars, ranks
                    )
                phases["store_rows"] += len(pars_np)
            with spans.host(phases, "fetch_s", "abcsmc.fetch"):
                self._particle_parameters.append(pars_np)
                self._particle_metrics.append(mets_np)
                self._predictive_prior.append(surv)
                self._weights.append(np.asarray(w_h, np.float64))
                self._doubled_variance.append(np.asarray(dv_h, np.float64))
            self.timings.append({
                "op": "device_generation", "set": t,
                "ncomp_used": ncomp_val,
            })
            if self._proc0():
                with spans.host(phases, "report_s",
                                "abcsmc.report.filtering"):
                    reports.filtering_report(self, t, pars_np[surv],
                                             mets_np[surv])
        phases["store_copied_bytes"] += (
            getattr(self.storage, "copied_bytes", 0) - copied)

    # ---------------------------------------------------------- projection
    def _run_device_projection(self, seed: int, verbose: bool):
        """Projection sweeps (PSEUDO/POSTERIOR grids, src/AbcSmc.cpp:54-137,
        341-396) on the device path: the brain builds the population with
        the host odometer exactly as ``--process`` would (ParRNG.h:17-36
        order), then each set is simulated in one call over the run's mesh
        instead of claim-sized host batches: claim all, one
        ``sharded_simulate`` call, DBL_MIN bandaid, guarded writeback. The
        set's timing entry is filed under the op "simulate_device".

        On several processes the store writer runs the brain, a barrier
        publishes each enqueue, every process simulates the same
        serial-ordered batch (the writer claims it, the others read it),
        the writer writes back, and the others ingest the finished store
        at the end so that the posterior surfaces agree everywhere."""
        cfg = self.config
        for t in range(cfg.num_smc_sets):
            with self._writer_guard("the projection brain pass"):
                if self._store_writer():
                    self.process_database(seed + t, verbose)
            stop = self._broadcast_flag(self._stopped_early)
            self._mesh_sync()
            if stop:
                if not self._store_writer():
                    self.process_database(seed + t, verbose)
                return self
            filed = len(self.timings)
            self.simulate_next_particles(n=-1)
            for entry in self.timings[filed:]:
                entry["op"] = "simulate_device"
            self._mesh_sync()
        with self._writer_guard("the final projection brain pass"):
            if self._store_writer():
                self.process_database(seed + cfg.num_smc_sets, verbose)
        self._mesh_sync()
        if not self._store_writer():
            # read-only final ingest: every write is gated off
            self.process_database(seed + cfg.num_smc_sets, verbose)
        return self

    # ------------------------------------------------------------ results
    @property
    def particle_parameters(self) -> list[np.ndarray]:
        return self._particle_parameters

    @property
    def particle_metrics(self) -> list[np.ndarray]:
        return self._particle_metrics

    def posterior(self, set_num: int = -1) -> tuple[np.ndarray, np.ndarray]:
        """(params, weights) of the predictive prior of a set (default
        last)."""
        if set_num == -1:
            set_num = len(self._predictive_prior) - 1
        surv = self._predictive_prior[set_num]
        return (
            self._particle_parameters[set_num][surv],
            self._weights[set_num],
        )

    # ------------------------------------------------------------ surfaces
    def checkpoint(self, path, stamp: bool = True) -> dict:
        """Write the run store to a reference-schema SQLite file and stamp
        it. An in-memory store is snapshotted; a SQLite store is copied
        through the sqlite3 online-backup API (safe against concurrent
        writers) or, when ``path`` is the live database itself, left in
        place (the database already is the checkpoint,
        src/AbcSmc.cpp:452-479). With ``stamp`` a CRC-32 integrity stamp
        (:func:`abcsmc_tpu_torch.crc32.database_crc`) is written beside the
        file as ``<path>.crc.json``, so that a copy shipped between
        filesystems can be verified on arrival
        (:func:`abcsmc_tpu_torch.crc32.verify_checkpoint`). Returns the
        stamp dict (empty when ``stamp=False``)."""
        from abcsmc_tpu_torch import crc32

        path = os.fspath(path)
        if isinstance(self.storage, MemoryStorage):
            target = SQLiteStorage(path)
            self.storage.snapshot_to(target)
            target.close()
        elif isinstance(self.storage, SQLiteStorage) and (
            os.path.abspath(path) != os.path.abspath(self.storage.path)
        ):
            # closing: sqlite3's own context manager only commits
            with contextlib.closing(
                sqlite3.connect(self.storage.path)
            ) as src, contextlib.closing(sqlite3.connect(path)) as dst:
                src.backup(dst)
        if not stamp:
            return {}
        info = crc32.database_crc(path)
        with open(path + ".crc.json", "w") as fh:
            json.dump(info, fh)
        return info

    def ess(self, set_num: int = -1) -> float:
        """Effective sample size of a generation's importance weights,
        (sum w)^2 / sum w^2."""
        if set_num == -1:
            set_num = len(self._weights) - 1
        w = self._weights[set_num]
        return float(w.sum() ** 2 / (w**2).sum())

    def posterior_predictive(self, n: int = 100, seed: int = 0,
                             set_num: int = -1) -> np.ndarray:
        """Posterior-predictive metric draws [n, M]: resample ``n``
        posterior particles by weight, rerun the simulator with fresh
        seeds. The pick's uniforms and the seeds come from a generator on
        the engine's device, and a device simulator runs there in the
        engine's dtype. Compare to ``self.obs`` for model criticism."""
        if self.simulator is None:
            raise SimulatorError("simulator not set", code=-211)
        pars, w = self.posterior(set_num)
        gen = self._generator(seed)
        method = self.config.resample_method
        u = resample.draw_pick_uniforms(gen, n, method, self.dtype)
        idx = resample.resample_indices(self._tensor(w), n, u,
                                        method).cpu().numpy()
        upars = _host(self.transform.to_model_space(
            torch.as_tensor(pars[idx])))
        seeds = self._draw_seeds(gen, n)
        return self.simulator.run_batch(upars, seeds, np.arange(n),
                                        device=self.device, dtype=self.dtype)

    def posterior_summary(
        self, set_num: int = -1,
        quantiles: tuple[float, ...] = (0.025, 0.25, 0.5, 0.75, 0.975),
    ) -> dict:
        """Weighted posterior summary per parameter: mean, sd and weighted
        quantiles (inverse CDF over the weight distribution)."""
        pars, w = self.posterior(set_num)
        w = np.asarray(w, np.float64)
        w = w / w.sum()
        ess = self.ess(set_num)
        out = {}
        for j, p in enumerate(self.par_set.params):
            x = pars[:, j]
            mean = float((x * w).sum())
            var = float(((x - mean) ** 2 * w).sum())
            order = np.argsort(x)
            cw = np.cumsum(w[order])
            qs = {
                q: float(x[order][np.searchsorted(cw, q, side="left").clip(
                    0, len(x) - 1)])
                for q in quantiles
            }
            out[p.short_name] = {
                "mean": mean, "sd": float(np.sqrt(var)), "quantiles": qs,
                "ess": ess,
            }
        return out
