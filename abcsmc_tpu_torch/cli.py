"""Command-line interface of the port, argument-compatible with
:mod:`abcsmc_tpu.cli` (and so with the reference's example binaries,
examples/include/examples.h:12-94):

    python -m abcsmc_tpu_torch config.json --process
    python -m abcsmc_tpu_torch config.json --simulate [-n N]
    python -m abcsmc_tpu_torch config.json --process --simulate --all

One flag more: ``--torch-device {cuda,cpu}`` (default cuda; there is no
silent fall back to the CPU). ``--profile-dir`` writes a ``torch.profiler``
trace. With ``--verbose`` the engine's timings and the weight kernel's
launch counts (``mixture_logsumexp.launches``, and by dot scheme) go to
stderr.
"""

from __future__ import annotations

import argparse
import json
import os
import sqlite3
import sys
import time
from contextlib import nullcontext

from abcsmc_tpu_torch.errors import AbcError


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="abcsmc-tpu-torch",
        description="ABC-SMC with PLS particle filtering on PyTorch/CUDA",
    )
    ap.add_argument("config_file")
    ap.add_argument("--process", action="store_true", dest="process_db")
    ap.add_argument("--simulate", action="store_true", dest="simulate_db")
    ap.add_argument("-n", type=int, default=1, dest="buffer_size",
                    help="simulations per database write")
    ap.add_argument("--all", action="store_true", dest="do_all")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument(
        "--device", action="store_true",
        help="run the SMC loop as one generation step per set on the "
             "device (resuming any existing store); a host-only simulator "
             "runs the host engine instead",
    )
    ap.add_argument(
        "--torch-device", choices=("cuda", "cpu"), default="cuda",
        help="where the port computes (default cuda; cpu only when asked)",
    )
    ap.add_argument(
        "--serial", type=int, default=-1,
        help="re-simulate the particle with this serial "
             "(simulate_particle_by_serial parity)",
    )
    ap.add_argument(
        "--posterior", type=int, default=-1,
        help="simulate the particle with this posterior rank in the latest "
             "ranked set (simulate_particle_by_posterior_idx parity)",
    )
    ap.add_argument(
        "--profile-dir", default="",
        help="write a torch.profiler trace of the run to this directory",
    )
    ap.add_argument(
        "--workers", type=int, default=1,
        help="run external-executable simulations through the native "
             "parallel worker pool with this many processes",
    )
    ap.add_argument(
        "--vis", default="", metavar="PREFIX",
        help="after the run (or standalone, with no action flags), write "
             "posterior-violin and pairs-panel plots of the config's "
             "database to PREFIX_posteriors.png / PREFIX_pairs.png",
    )
    return ap


def _simulate(abc, args, n):
    if (
        args.workers > 1
        and abc.config.executable
        and abc.config.database_filename
    ):
        from abcsmc_tpu_torch.native import run_workers

        run_workers(
            abc.config.database_filename, abc.config.executable,
            n_jobs=n, n_workers=args.workers, verbose=args.verbose,
        )
    else:
        abc.simulate_next_particles(n)


def _write_plots(abc, prefix: str) -> None:
    """The two offline-analysis plots of the reference's R scripts
    (vis/abc_plots.R, vis/abc.pairs.ex.R), from the run database."""
    db = abc.config.database_filename
    if not db:
        raise AbcError("--vis requires a database_filename in the config")
    if not os.path.exists(db):
        raise AbcError(f"--vis: database not found: {db}")
    from abcsmc_tpu_torch import vis

    for path in (
        vis.plot_posteriors(db, f"{prefix}_posteriors.png"),
        vis.plot_pairs(db, f"{prefix}_pairs.png"),
    ):
        sys.stderr.write(f"{path}\n")


def _profiler(directory: str, device: str):
    """A torch.profiler context that writes a Chrome trace into
    ``directory`` on exit (CPU activity, and CUDA activity on a card)."""
    if not directory:
        return nullcontext()
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(directory, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if device == "cuda":
        activities.append(ProfilerActivity.CUDA)

    def export(prof):
        path = os.path.join(directory, f"trace_{os.getpid()}.json")
        prof.export_chrome_trace(path)
        sys.stderr.write(f"profiler trace: {path}\n")

    return profile(activities=activities, on_trace_ready=export)


def _drive(abc, args, seed: int) -> None:
    if args.serial > -1:
        abc.simulate_particle_by_serial(args.serial)
    elif args.posterior > -1:
        abc.simulate_particle_by_posterior_idx(args.posterior)
    elif args.device:
        abc.run_device(seed, verbose=args.verbose)
    elif args.do_all:
        # examples.h:76-93: per set, process + simulate the whole set,
        # then one final process pass
        for t in range(abc.config.num_smc_sets):
            if args.process_db:
                abc.process_database(seed + t, args.verbose)
            if args.simulate_db:
                _simulate(abc, args, -1)
        if args.process_db:
            abc.process_database(seed + abc.config.num_smc_sets,
                                 args.verbose)
    else:
        if args.process_db:
            abc.process_database(seed, args.verbose)
        if args.simulate_db:
            _simulate(abc, args, args.buffer_size)


def main(argv: list[str] | None = None) -> int:
    args = build_argparser().parse_args(argv)
    seed = args.seed
    if seed is None:
        # reference: time(NULL) * getpid() (examples.h:63)
        seed = (int(time.time()) * os.getpid()) & 0x7FFFFFFF

    from abcsmc_tpu_torch.engine import AbcSmc
    from abcsmc_tpu_torch.ops.kernels import mixture_logsumexp

    try:
        abc = AbcSmc(args.config_file, device=args.torch_device)
        with _profiler(args.profile_dir, args.torch_device):
            _drive(abc, args, seed)
        if args.vis:
            _write_plots(abc, args.vis)
    except AbcError as e:
        sys.stderr.write(f"{e}\n")
        return -(e.code or 1) if e.code and e.code < 0 else (e.code or 1)
    except sqlite3.Error as e:
        # operational sqlite failures (disk I/O, corruption appearing
        # mid-run, lock timeout past busy_timeout) - message, not traceback
        sys.stderr.write(f"database error: {e}\n")
        return 1
    if args.verbose:
        for row in abc.timings:
            sys.stderr.write(f"[timing] {row}\n")
        sys.stderr.write(
            f"[kernel] mixture_logsumexp.launches {mixture_logsumexp.launches}"
            "\n"
        )
        sys.stderr.write(
            "[kernel] mixture_logsumexp.launches_by_precision "
            f"{json.dumps(mixture_logsumexp.launches_by_precision)}\n"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
