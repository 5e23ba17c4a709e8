"""What the study harnesses and the bench programs share: the common
flags, the device rule, the card line, JSON lines, the unit-box
generation step and the linear-Gaussian population they time.

Every harness takes ``--device`` (default ``cuda``, through
:func:`abcsmc_tpu_torch.resolve_device`), ``--seed`` (its
``torch.Generator``) and ``--out`` (a copy of the JSON lines). With no
CUDA device and no ``--device cpu`` it prints why and exits 2; nothing
falls back to the CPU. On the CPU a timing is not taken: the work runs once
and its ``ms`` is null (a CPU run gives no device time).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from abcsmc_tpu_torch import resolve_device
from abcsmc_tpu_torch.bench_kernel import cuda_ms

TOL = 2e-4      # nats: the kernel against its plain version (chip_smoke.py)
DTYPES = {"float32": torch.float32, "float64": torch.float64}


def parser(doc: str, dtype: bool = False) -> argparse.ArgumentParser:
    """An argument parser with the common flags (``--dtype`` where the
    harness runs the engine or the step)."""
    ap = device_parser(doc)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the harness's torch.Generator")
    ap.add_argument("--out", help="also write the JSON lines to this file")
    if dtype:
        ap.add_argument("--dtype", choices=sorted(DTYPES),
                        default="float32")
    return ap


def device_parser(doc: str) -> argparse.ArgumentParser:
    """An argument parser with ``--device`` alone (default ``cuda``)."""
    ap = argparse.ArgumentParser(
        description=doc.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default), cuda:N or cpu; no fallback")
    return ap


def card_line(device: torch.device) -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` of the card, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else 0
    return subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


class Study:
    """One harness run: its device, its generator and its JSON lines (the
    first one names the tool and the card)."""

    def __init__(self, tool: str, args: argparse.Namespace):
        self.device = resolve_device(args.device)
        self.on_card = self.device.type == "cuda"
        self.dtype = DTYPES[getattr(args, "dtype", "float32")]
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(args.seed)
        self.out = args.out
        self.lines: list[dict] = []
        if self.out:
            open(self.out, "w").close()
        self.emit({"tool": tool, "card": card_line(self.device),
                   "device": str(self.device), "torch": torch.__version__})

    def emit(self, row: dict) -> dict:
        print(json.dumps(row), flush=True)
        self.lines.append(row)
        if self.out:
            with open(self.out, "a") as fh:
                fh.write(json.dumps(row) + "\n")
        return row

    def ms(self, fn, reps: int):
        """CUDA-event milliseconds per call after a warm-up on the card;
        on the CPU ``fn`` runs once and the time is None."""
        if self.on_card:
            return cuda_ms(fn, reps)
        fn()
        return None

    def sync(self):
        sync(self.device)


def needs_cuda(device, prog: str) -> bool:
    """True (after a message) when CUDA was asked for and there is none:
    the caller exits 2."""
    if torch.device(device).type == "cuda" and \
            not torch.cuda.is_available():
        print(f"{prog}: needs a CUDA device (torch.cuda.is_available() is "
              "False); pass --device cpu to run on the CPU",
              file=sys.stderr)
        return True
    return False


def sync(device: torch.device):
    """Wait for ``device``'s work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def start(tool: str, args: argparse.Namespace) -> Study | None:
    """The harness's :class:`Study`, or None (the caller exits 2) when CUDA
    was asked for and there is none."""
    if needs_cuda(args.device, tool):
        return None
    return Study(tool, args)


def check(cond: bool, what: str):
    """A harness's own check: raises, so that no caller goes on past it."""
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def label(n: int) -> str:
    """10000000 -> "10M", 500000 -> "500k" (the JAX tools' metric names)."""
    if n % 1_000_000 == 0:
        return f"{n // 1_000_000}M"
    if n % 1000 == 0:
        return f"{n // 1000}k"
    return str(n)


def unit_box_config(n: int, keep: int, obs, npar: int = 6, sets: int = 2,
                    **extra) -> dict:
    """The tools' linear-Gaussian config: ``len(obs)`` metrics over
    ``npar`` parameters ``p0..`` uniform on [0, 1]."""
    return {
        "smc_iterations": sets, "num_samples": n,
        "predictive_prior_size": keep,
        "parameters": [
            {"name": f"p{i}", "dist_type": "UNIFORM", "num_type": "FLOAT",
             "par1": 0.0, "par2": 1.0} for i in range(npar)],
        "metrics": [
            {"name": f"m{j}", "num_type": "FLOAT", "value": float(v)}
            for j, v in enumerate(obs)],
        **extra,
    }


def generation(raw: dict, simulator, devices, dtype=torch.float32, **kw):
    """The generation step of config ``raw``: one plain step on
    ``devices[0]``, or a particle mesh over ``devices`` when there are
    more (repeats make a virtual mesh)."""
    from abcsmc_tpu_torch.config import parse_config
    from abcsmc_tpu_torch.models.parameters import ParameterSet
    from abcsmc_tpu_torch.models.transforms import ParameterTransform
    from abcsmc_tpu_torch.parallel.generation import Generation
    from abcsmc_tpu_torch.parallel.mesh import particle_mesh

    cfg = parse_config(raw)
    where = ({"device": devices[0]} if len(devices) == 1
             else {"mesh": particle_mesh(devices)})
    return Generation(
        ParameterSet.from_specs(cfg.parameters),
        ParameterTransform(cfg.parameters), simulator,
        np.array([m.value for m in cfg.metrics]), dtype=dtype, **where,
        **kw)


def step_generator(gen, seed: int = 0) -> torch.Generator:
    """The step's draws' generator: on the step's device for one shard, on
    the host for a mesh (its shards seed their own from it)."""
    dev = gen.device if gen.mesh.size == 1 else torch.device("cpu")
    return torch.Generator(device=dev).manual_seed(seed)


def population(n: int, mix, g: torch.Generator, dtype=torch.float32,
               block: int = 1 << 21):
    """Parameters uniform on [0, 1]^P and metrics = params @ mix + 0.3
    N(0, 1), made block by block from ``g`` on its device."""
    dev = g.device
    mix = torch.as_tensor(np.asarray(mix)).to(dev, dtype)
    params = torch.rand((n, mix.shape[0]), generator=g, device=dev,
                        dtype=dtype)
    mets = torch.empty((n, mix.shape[1]), device=dev, dtype=dtype)
    for start in range(0, n, block):
        rows = slice(start, min(start + block, n))
        mets[rows] = params[rows] @ mix
        mets[rows] += 0.3 * torch.randn(mets[rows].shape, generator=g,
                                        device=dev, dtype=dtype)
    return params, mets


def previous_state(keep: int, npar: int, g: torch.Generator,
                   dtype=torch.float32):
    """The tools' previous generation, from ``g`` on its device: ``keep``
    survivors uniform on [0.3, 0.7]^P, equal weights, doubled variance
    0.02."""
    dev = g.device
    return (0.3 + 0.4 * torch.rand((keep, npar), generator=g, device=dev,
                                   dtype=dtype),
            torch.full((keep,), 1.0 / keep, device=dev, dtype=dtype),
            torch.full((npar,), 0.02, device=dev, dtype=dtype))
