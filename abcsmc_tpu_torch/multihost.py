"""Multi-process fitting against one shared run store (counterpart of
``examples/multihost_launch.py``).

Every process joins one ``torch.distributed`` group, builds its particle
mesh from its own devices and calls ``run_device`` against the same store
(a SQLite file on a shared filesystem). Process 0 writes the store; the
others compute the same replicated generations and write nothing, so the
store equals a one-process run's with the same shard count.

Once per process:

    python -m abcsmc_tpu_torch.multihost CONFIG.json \\
        --coordinator host0:1234 --num-processes 4 --process-id I

or under torchrun, which sets the rank, the world size and the address:

    torchrun --nproc-per-node 4 -m abcsmc_tpu_torch.multihost CONFIG.json

``--shards-per-device K`` gives each device K shards (a virtual mesh);
``--torch-device cpu`` runs CPU shards over the gloo backend.
"""

from __future__ import annotations

import argparse


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m abcsmc_tpu_torch.multihost")
    ap.add_argument("config")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0 (default: torchrun's "
                         "MASTER_ADDR:MASTER_PORT)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--torch-device", choices=("cuda", "cpu"),
                    default="cuda")
    ap.add_argument("--shards-per-device", type=int, default=1)
    ap.add_argument("--timeout-s", type=float, default=600.0,
                    help="seconds a collective waits for its peers")
    ap.add_argument("--verbose", action="store_true")
    return ap


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    import torch.distributed as dist

    from abcsmc_tpu_torch import AbcSmc
    from abcsmc_tpu_torch.parallel.mesh import (
        initialize_distributed, particle_mesh,
    )

    initialize_distributed(args.coordinator, args.num_processes,
                           args.process_id, device=args.torch_device,
                           timeout_s=args.timeout_s)
    try:
        devices = None if args.torch_device == "cuda" else ["cpu"]
        mesh = particle_mesh(devices)
        mesh = particle_mesh([d for d in mesh.devices
                              for _ in range(args.shards_per_device)],
                             mesh.group)
        abc = AbcSmc(args.config, device=mesh.lead)
        abc.run_device(seed=args.seed, verbose=args.verbose, mesh=mesh)
        if mesh.process_index == 0:
            for name, s in abc.posterior_summary().items():
                print(f"{name}: mean={s['mean']:.6g} sd={s['sd']:.6g}")
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
