"""Run one cell of the benchmark of ``abcsmc_tpu_torch`` once.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

(or ``python3 -m port_bench.run ...``) from the root of a checkout, on a
machine with as many CUDA cards as the cell asks for. It exits 3, and
prints no result, without them; it never falls back to the CPU.

A run: set-up (imports, the CUDA context, the kernel library from its
build cache, one warm-up fit of the cell's shapes and route), then a window
of whole fits back to back, each a fresh ``AbcSmc(config,
device="cuda").run_device(seed=...)`` with a seed drawn from ``--seed``.
A fit starts where the window was still open as the fit before it ended
(the collection after a fit is window time, but decides nothing); the last
is finished and counted, and the window runs to its end. Then the
comparison that decides ``correct`` (the judge of the configuration's plain
reference, ``references/<config>.py``) on fits sampled from the window by
the seed, each number printed beside its limit. The last line of standard
output is the result: ``correct``, ``attempted`` (fits started),
``failed``, ``metrics`` (``--trace 0``: the cell's end-to-end metrics;
``--trace 1``: its per-layer metrics, from ``torch.profiler`` over the
fits of the window's last ``TRACE_SECONDS`` and from the program's spans
of the fits before them), ``device``,
``breakdown`` (traced runs) and ``checks``.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: build and kernel caches of the program, at fixed paths in the checkout
CACHE = ROOT / "build" / "port_bench_cache"
#: top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "abcsmc_tpu")
#: seconds at the end of the window that a traced run profiles
TRACE_SECONDS = 5.0


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``,
    compared whole (``abcsmc_tpu_torch`` is not ``abcsmc_tpu``)."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


def _pin_caches():
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)


class _Sink:
    """Takes the program's reports (stderr) of the fits and drops them."""

    def write(self, s):
        return len(s)

    def flush(self):
        pass


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap


def _posterior_state(abc) -> list:
    """A finished fit's weights, variances and component counts per set,
    from its posterior state in memory."""
    ncomp = [e["ncomp_used"] for e in abc.timings
             if e["op"] == "device_generation"]
    return [{"weights": w, "dv": dv, "ncomp": c} for w, dv, c in
            zip(abc._weights, abc._doubled_variance, ncomp)]


def _store_rows(abc) -> list:
    """A finished fit's rows as its run store gives them back through the
    store's interface (``read_generations``, what a resumed fit reads):
    per set the parameters, seeds, metrics, and the survivors in rank
    order from the stored posterior ranks."""
    out = []
    for g in abc.storage.read_generations():
        rank = np.asarray(g.posterior_ranks, np.int64)
        kept = np.nonzero(rank >= 0)[0]
        out.append({"params": np.asarray(g.params, np.float64),
                    "seeds": np.asarray(g.seeds, np.uint64),
                    "metrics": np.asarray(g.metrics, np.float64),
                    "survivors": kept[np.argsort(rank[kept], kind="stable")]})
    return out


def run(argv=None, *, device=None, overrides=None):
    """One run; returns (result dict or None, exit code). ``device`` other
    than None skips the look for a card and runs there (tests on the CPU);
    ``overrides`` are configuration keys set on every fit of the window
    (the control: ``{"weight_precision": "default"}``)."""
    from port_bench import registry
    from port_bench.traffic import Traffic, fit_seed

    args = _parser().parse_args(argv)
    bench = registry.benchmark()
    entry = next((w for w in bench["workloads"]
                  if w["name"] == args.workload), None)
    if entry is None:
        sys.stderr.write(f"port_bench: no workload {args.workload!r} in "
                         "BENCHMARK.json\n")
        return None, 2
    cell = registry.workload(args.workload)
    cfg = registry.config(entry["config"])
    ref = registry.reference(entry["config"])
    limits = cell["check"]["limits"]
    if set(limits) != set(ref.NUMBERS):
        sys.stderr.write(
            f"port_bench: {args.workload}'s limits name {sorted(limits)}; "
            f"its reference's numbers are {sorted(ref.NUMBERS)}\n")
        return None, 2

    _pin_caches()
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    if device is None:
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < entry["chips"]:
            sys.stderr.write(
                f"port_bench: {args.workload} needs {entry['chips']} CUDA "
                f"card(s); torch sees {torch.cuda.device_count()}\n")
            return None, 3
        device = "cuda"
    on_card = torch.device(device).type == "cuda"

    from abcsmc_tpu_torch import AbcSmc
    from abcsmc_tpu_torch.models import simulators
    from abcsmc_tpu_torch.ops import kernels

    traffic = Traffic(cfg, cell["traffic"], args.seed, ref)
    sim_kwargs = cfg.get("program_simulator")
    factory = getattr(simulators,
                      f"make_{cfg['reference']['simulator']}_simulator")
    store_dir = None
    if traffic.store == "sqlite":
        store_dir = Path(tempfile.mkdtemp(prefix="port_bench_"))
    sink = _Sink()

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def one_fit(index: int, store: str, mirror_store: bool = True):
        db = "" if store == "memory" else str(store_dir / f"fit{index}.sqlite")
        fit_cfg = traffic.fit_config(db, **(overrides or {}))
        if on_card:
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        with record_function("port_bench.fit"), \
                contextlib.redirect_stderr(sink):
            with record_function("port_bench.AbcSmc"):
                abc = AbcSmc(fit_cfg, device=device, simulator=(
                    None if sim_kwargs is None else
                    factory(traffic.npar, traffic.nmet, **sim_kwargs)))
            with record_function("port_bench.run_device"):
                abc.run_device(seed=fit_seed(args.seed, index),
                               mirror_store=mirror_store)
            sync()
        wall = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated() if on_card else None
        phases = next(e for e in abc.timings
                      if e["op"] == "run_device_phases")
        first, n_sets = phases["first_set"], phases["sets"]
        rec = {"index": index, "wall_s": wall,
               "particles": sum(traffic.sizes[first:first + n_sets]),
               "sets": [e for e in abc.timings
                        if e["op"] == "device_generation"],
               "phases": phases, "peak_bytes": peak,
               "own_bytes": None if peak is None else peak - base}
        return abc, rec

    def drop(abc, keep_file=False):
        close = getattr(abc.storage, "close", None)
        if close is not None:
            close()
        name = abc.config.database_filename
        if name and os.path.exists(name) and not keep_file:
            os.unlink(name)

    def sample(abc) -> dict:
        """What the comparison needs of a sampled fit: its rows as the run
        store gives them back, and the weights, variances and component
        counts of its posterior state, which the store does not hold (with
        whatever more the reference's ``state`` reads). A SQLite store's
        file is kept and read back after the window by the reference's own
        reader; an in-memory store's rows are read back now, so that the
        harness holds none of the program's objects while later fits
        run."""
        name = abc.config.database_filename
        state = _posterior_state(abc)
        if hasattr(ref, "state"):
            state = [{**a, **b} for a, b in zip(state, ref.state(abc))]
        return {"state": state, "file": name or None,
                "rows": None if name else _store_rows(abc)}

    # ---- set-up: one warm-up fit of the cell's shapes and route (the run
    # store is Python and sqlite3, with nothing to warm up: it is skipped) ----
    abc, _ = one_fit(-1, "memory", mirror_store=False)
    del abc
    gc.collect()
    sync()
    setup_s = time.perf_counter() - T0
    base_bytes = torch.cuda.memory_allocated() if on_card else None

    # ---- the window ----
    from port_bench import trace as trace_mod

    # Its time is the wall time from its start to the end of its last fit,
    # less the harness's own work between fits: reading a sampled fit's
    # rows back from its store for the comparison (so that the harness
    # holds no store of the program's while later fits run) and starting
    # the profiler. Collecting the program's garbage after each fit counts.
    fits, failures, sampled = [], [], []
    # the fits judged for the comparison: ``fits`` of them, drawn from the
    # seed among the window's first ``among``; where the window holds fewer,
    # its last fits stand in. Each is read back as it ends (the read-back
    # of a fit at 1M rows a set takes seconds, so no more are read)
    k_check = int(cell["check"]["fits"])
    among = max(int(cell["check"].get("among", k_check)), k_check)
    picks = set(random.Random(fit_seed(args.seed, -2)).sample(range(among),
                                                              k_check))
    # A traced run profiles the fits that start in the last TRACE_SECONDS
    # of the window, or the last fit at least, to the window's end: the
    # profiler slows the fits under it and, once stopped, those after it,
    # so the fits before it give the program's own spans untouched.
    prof = span = None
    traced_from = launches = launches0 = None
    bookkeeping = 0.0
    w0 = time.perf_counter()
    index = 0

    def window_open():
        # (a traced run whose last fit outran the forecast traces one more)
        return (time.perf_counter() - w0 - bookkeeping < args.seconds
                or bool(args.trace) and prof is None)

    # read once as each fit ends: it decides both whether that fit is the
    # window's last (and so judged where fewer than ``among`` ran) and
    # whether another starts; the collection after it does not change it
    still_open = True
    while still_open:
        elapsed = time.perf_counter() - w0 - bookkeeping
        if args.trace and prof is None and (
                elapsed >= args.seconds - TRACE_SECONDS
                or fits and elapsed + fits[-1]["wall_s"] >= args.seconds):
            t_book = time.perf_counter()
            prof = profile(activities=[ProfilerActivity.CPU]
                           + ([ProfilerActivity.CUDA] if on_card else []))
            prof.start()
            traced_from = len(fits)
            launches0 = kernels.kernel_launches() if on_card else 0
            span = record_function(trace_mod.WINDOW_SPAN)
            bookkeeping += time.perf_counter() - t_book
            span.__enter__()
        try:
            abc, rec = one_fit(index, traffic.store)
        except Exception:  # a fit that fails counts, and the run goes on
            failures.append(f"fit {index}: {traceback.format_exc(limit=3)}")
            index += 1
            still_open = window_open()
            continue
        t_book = time.perf_counter()
        fits.append(rec)
        index += 1
        still_open = window_open()
        judged = len(sampled) < k_check and (
            index - 1 in picks or not still_open)
        if judged:
            sampled.append(sample(abc))
        drop(abc, keep_file=judged)
        del abc
        bookkeeping += time.perf_counter() - t_book
        # each fit starts from a collected heap, as in a fresh process: the
        # program's cyclic garbage (its CUDA graphs and their memory pools
        # among it) is freed here, in the window, rather than at a time
        # that varies
        gc.collect()
    window_s = time.perf_counter() - w0 - bookkeeping
    if prof is not None:
        span.__exit__(None, None, None)
        launches = (kernels.kernel_launches() if on_card else 0) - launches0
        prof.stop()
    # the fullest the card was in the window, and the most one fit took on
    # top of what the process held when the window began (memory that an
    # earlier fit left behind is not counted again in each later fit)
    peaks = [f["peak_bytes"] for f in fits if f["peak_bytes"] is not None]
    peak = max(peaks) if peaks else None
    fit_peak = (base_bytes + max(f["own_bytes"] for f in fits)
                if peaks else None)

    # ---- the metrics ----
    t_reduce = time.perf_counter()
    tdata = trace_mod.reduce(prof) if prof is not None else None
    t_reduce = time.perf_counter() - t_reduce
    # a traced run's program spans come from the fits before the profiler
    untraced = fits[:traced_from] if traced_from else fits
    record = {
        "cell": args.workload, "config": cfg, "traffic": traffic,
        "setup_s": setup_s, "window_s": window_s, "fits": untraced,
        "peak_bytes": fit_peak, "trace": tdata,
        "traced_fits": fits[traced_from:] if prof is not None else [],
        "traced_weight_launches": launches,
        "weight_precision": traffic.smc.get("weight_precision", "high"),
    }
    kind = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in registry.cell_metrics(bench, args.workload, kind):
        value = registry.metric(m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # ---- correct: the sampled fits against the plain reference ----
    from port_bench.reference import store

    t_judge = time.perf_counter()
    gc.collect()
    sets = [[{**row, **st} for row, st in zip(
        f["rows"] if f["file"] is None else store.read_sets(f["file"]),
        f["state"])] for f in sampled]
    if on_card:
        torch.cuda.empty_cache()
    spec = traffic.spec()
    numbers = dict.fromkeys(ref.NUMBERS, 0.0)
    for i, fit_sets in enumerate(sets):
        got = ref.judge(fit_sets, spec, device, fit_seed(args.seed, -3 - i),
                        cell["check"])
        for key, val in got.items():
            numbers[key] = max(numbers[key], val)
    t_judge = time.perf_counter() - t_judge
    if store_dir is not None:
        shutil.rmtree(store_dir, ignore_errors=True)
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = (bool(fits) and not failures and bool(sets)
               and all(v <= limits[k] for k, v in numbers.items()))

    result = {"correct": correct, "attempted": len(fits) + len(failures),
              "failed": len(failures), "metrics": metrics}
    result["device"] = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
        "count": entry["chips"] if on_card else 1,
        "memory_peak_bytes": peak if on_card else 0,
    }
    if tdata is not None:
        result["device"]["busy_s"] = tdata.busy_s
        result["device"]["window_s"] = tdata.window_s
        result["breakdown"] = {"device_ops": tdata.device_ops,
                               "idle_gaps": tdata.idle_gaps}
    result["checks"] = checks

    for msg in failures[:5]:
        sys.stderr.write(f"port_bench: {msg}\n")
    sys.stderr.write(
        f"port_bench: {args.workload} seed {args.seed}: {len(fits)} fits in "
        f"{window_s:.3f} s (+ {bookkeeping:.3f} s of the harness's), routes "
        f"{sorted({e['route'] for f in fits for e in f['sets']})}, "
        f"fit walls {[round(f['wall_s'], 4) for f in fits[:12]]}, setup "
        f"{setup_s:.3f} s, judged {len(sets)} fits in {t_judge:.1f} s\n")
    for f in fits[:3]:
        ph = f["phases"]
        sys.stderr.write(
            f"port_bench: fit {f['index']}: route {ph['route']} dispatch "
            f"{ph['dispatch_s']:.4f} s mirror {ph['mirror_s']:.4f} s capture "
            f"{ph['capture_s']:.4f} s, set ms "
            f"{[s.get('device_ms') for s in f['sets']]}\n")
    if tdata is not None:
        sys.stderr.write(
            f"port_bench: trace: {len(record['traced_fits'])} fits, busy "
            f"{tdata.busy_s:.4f} of {tdata.window_s:.4f} s, "
            f"{sum(tdata.count_by_name.values())} device ops, weight "
            f"launches counted {record['traced_weight_launches']} traced "
            f"{tdata.kernel_count(registry.kernel('weights').NAMES)}, "
            f"reduced in {t_reduce:.1f} s\n")
    for k, c in checks.items():
        sys.stderr.write(f"check {k} {c['value']!r} limit {c['limit']!r}\n")
    bad = forbidden_modules()
    if bad:
        sys.stderr.write(f"port_bench: loaded forbidden modules: {bad}\n")
        return None, 4
    return result, 0


def main(argv=None) -> int:
    result, code = run(argv)
    if result is not None:
        sys.stdout.write(json.dumps(result) + "\n")
        sys.stdout.flush()
    return code


if __name__ == "__main__":
    sys.exit(main())
