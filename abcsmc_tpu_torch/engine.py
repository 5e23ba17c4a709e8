"""The SMC orchestrator (port of :class:`abcsmc_tpu.engine.AbcSmc`).

Ported: construction from a config, :meth:`AbcSmc.run_device` on a fresh
store (the per-set sequential loop, one generation step per set on one
device), the mirror of every set into the run store (SQLite or in-memory,
the same job/par/upar/met schema), the filtering and convergence reports,
and the posterior surfaces.

Not yet ported, each raising ``NotImplementedError`` where it is reached:
the host loop (``run``, ``build_database``, ``process_database``,
``simulate_next_particles``), resume from an existing store, projection,
the fused ``run_scan``/``run_chain`` dispatch, chunked row passes, Box-Cox,
split propose, two-stage top-K, MULTIVARIATE noise, and the simulators
other than ``linear_gaussian`` and ``gaussian``.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from abcsmc_tpu_torch import reports
from abcsmc_tpu_torch.config import NoiseType, SmcConfig, parse_config
from abcsmc_tpu_torch.errors import AbcError
from abcsmc_tpu_torch.models.metrics import Metric, observed_vector
from abcsmc_tpu_torch.models.parameters import ParameterSet
from abcsmc_tpu_torch.models.simulators import DeviceSimulator, resolve_simulator
from abcsmc_tpu_torch.models.transforms import ParameterTransform
from abcsmc_tpu_torch.ops import stats
from abcsmc_tpu_torch.storage import MemoryStorage, SQLiteStorage, Storage


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not yet ported to abcsmc_tpu_torch; use the JAX package "
        "abcsmc_tpu for it"
    )


class AbcSmc:
    """One ABC-SMC-PLS analysis on one device.

    Parameters
    ----------
    config:
        An :class:`SmcConfig`, or a path / dict accepted by
        :func:`parse_config`.
    device:
        "cuda" (default; raises when no CUDA device is visible) or "cpu".
    dtype:
        Working float type of the device path (default float32).
    simulator:
        Optional explicit :class:`DeviceSimulator`; otherwise bound from
        the config's ``simulator`` key.
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
        simulator: DeviceSimulator | None = None,
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

        #: per-run stage timings: one "device_generation" entry per set and
        #: one "run_device_phases" entry per run
        self.timings: list[dict] = []
        self._particle_parameters: list[np.ndarray] = []
        self._particle_metrics: list[np.ndarray] = []
        self._predictive_prior: list[np.ndarray] = []
        self._weights: list[np.ndarray] = []
        self._doubled_variance: list[np.ndarray] = []

    @property
    def npar(self) -> int:
        return self.config.npar

    @property
    def nmet(self) -> int:
        return self.config.nmet

    # ------------------------------------------------ not yet ported: host
    def build_database(self, *args, **kwargs):
        raise _not_ported("the host engine (build_database)")

    def process_database(self, *args, **kwargs):
        raise _not_ported("the host engine (process_database)")

    def simulate_next_particles(self, *args, **kwargs):
        raise _not_ported("the host engine (simulate_next_particles)")

    def run(self, *args, **kwargs):
        raise _not_ported("the host engine loop (run)")

    # ------------------------------------------------------------ helpers
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

    def _check_slice(self):
        cfg = self.config
        if not isinstance(self.simulator, DeviceSimulator):
            raise _not_ported("a run without a device simulator (host loop)")
        if cfg.projection_mode:
            raise _not_ported("projection mode")
        if cfg.box_cox:
            raise _not_ported("Box-Cox ranking (box_cox)")
        if cfg.noise == NoiseType.MULTIVARIATE:
            raise _not_ported("MULTIVARIATE noise")
        if cfg.row_block:
            raise _not_ported("chunked row passes (row_block)")
        if cfg.propose_split:
            raise _not_ported("split propose (propose_split)")
        if cfg.topk_two_stage:
            raise _not_ported("two-stage top-K (topk_two_stage)")
        if cfg.device_dispatch == "fused":
            raise _not_ported("fused dispatch (run_scan / run_chain)")
        if self.storage.exists() and not self.storage.is_empty():
            raise _not_ported("resume from an existing store")

    # --------------------------------------------------------- device path
    def run_device(self, seed: int = 0):
        """A fresh SMC run on ``self.device``: one generation step per set
        (:class:`abcsmc_tpu_torch.parallel.generation.Generation`), every
        draw from one ``torch.Generator`` seeded with ``seed``. All sets stay
        on the device until the end; then each set is fetched once and
        mirrored into the run store, and the reports are printed."""
        from abcsmc_tpu_torch.parallel.generation import Generation

        self._check_slice()
        cfg = self.config
        for lst in (self._particle_parameters, self._particle_metrics,
                    self._weights, self._predictive_prior,
                    self._doubled_variance):
            lst.clear()
        gen = Generation(
            self.par_set, self.transform, self.simulator, self.obs,
            device=self.device, dtype=self.dtype,
            filter_type=cfg.filter,
            training_fraction=cfg.pls_training_fraction,
            pls_optimal_method=cfg.pls_optimal_method,
            resample_method=cfg.resample_method,
        )
        generator = torch.Generator(device=self.device)
        generator.manual_seed(int(seed) & 0xFFFFFFFFFFFFFFFF)
        on_cuda = self.device.type == "cuda"

        t_dispatch0 = time.perf_counter()
        params, seeds = gen.init_population(generator, cfg.smc_size_at(0))
        state = None
        results, pops, marks = [], [], []
        for t in range(cfg.num_smc_sets):
            n_t = cfg.smc_size_at(t)
            last = t + 1 >= cfg.num_smc_sets
            n_next = 0 if last else cfg.smc_size_at(t + 1)
            draws = gen.draw_step(generator, n_next)
            ev = None
            if on_cuda:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
            res = gen.step(params, seeds, cfg.pred_prior_size_at(t), n_next,
                           draws, state, n_valid=n_t)
            if on_cuda:
                ev[1].record()
            marks.append(ev)
            state = (res.survivor_params, res.weights, res.doubled_variance)
            converged = self._nrmse_converged(res.survivor_metrics, t)
            pops.append((params, seeds, res.metrics))
            results.append(res)
            params, seeds = res.next_params, res.next_seeds
            if converged:
                break
        t_dispatch = time.perf_counter() - t_dispatch0

        # ---- fetch every set once, then mirror into the run store ----
        t_mirror0 = time.perf_counter()
        fetched = [
            tuple(x.detach().cpu().numpy() for x in (
                pars_d, seeds_d, mets_d, res.survivor_idx, res.weights,
                res.doubled_variance, res.ncomp_used,
            ))
            for res, (pars_d, seeds_d, mets_d) in zip(results, pops)
        ]
        self._mirror_fetched_sets(fetched)
        # the mirror appended one "device_generation" entry per set, in order
        for entry, ev in zip(self.timings[-len(marks):], marks):
            entry["device_ms"] = ev[0].elapsed_time(ev[1]) if ev else None
        self.timings.append({
            "op": "run_device_phases", "sets": len(fetched),
            "dispatch_s": t_dispatch,
            "mirror_s": time.perf_counter() - t_mirror0,
        })
        reports.report_convergence_data(self, len(fetched) - 1)
        return self

    def _mirror_fetched_sets(self, fetched):
        """Mirror the fetched per-set host tuples into the store and the
        in-memory posterior state, then print each set's filtering report.
        A negative ``ncomp_used`` (the step's U0 self-check) raises before
        any store write for that set."""
        cfg = self.config
        if not self.storage.exists():
            self.storage.create(
                self.par_set.short_names(),
                [m.short_name for m in self.metrics],
                self.transform.has_any,
            )
        for t, host in enumerate(fetched):
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
            pars_np = np.asarray(pars_h, np.float64)[:n_t]
            seeds_np = np.asarray(seeds_h).astype(np.uint64)[:n_t]
            mets_np = np.asarray(mets_h, np.float64)[:n_t]
            surv = np.asarray(surv_h, np.int64)
            ranks = np.full(len(pars_np), -1, np.int64)
            ranks[surv] = np.arange(len(surv))
            upars = (
                self.transform.to_model_space(torch.as_tensor(pars_np)).numpy()
                if self.transform.has_any else None
            )
            self.storage.insert_generation_complete(
                t, pars_np, seeds_np, mets_np, upars, ranks
            )
            self._particle_parameters.append(pars_np)
            self._particle_metrics.append(mets_np)
            self._predictive_prior.append(surv)
            self._weights.append(np.asarray(w_h, np.float64))
            self._doubled_variance.append(np.asarray(dv_h, np.float64))
            self.timings.append({
                "op": "device_generation", "set": t,
                "ncomp_used": ncomp_val,
            })
            reports.filtering_report(self, t, pars_np[surv], mets_np[surv])

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
