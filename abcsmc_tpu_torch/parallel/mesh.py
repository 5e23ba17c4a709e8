"""The particle mesh (port of :mod:`abcsmc_tpu.parallel.mesh`).

SMC over a 1-D mesh on the particle axis: every particle-indexed buffer is
cut into ``size`` equal shards, shard ``s`` holding global rows
``[s * local_n, (s + 1) * local_n)``. A sharded buffer is a Python list of
this process's shard tensors, in shard order, each on its shard's device.
The small replicated math (PLS fit, top-K decision, weights' normalisation)
runs on the mesh's lead device, the first local shard's.

PyTorch's idiom in place of ``Mesh`` / ``NamedSharding``: a
:class:`ParticleMesh` names this process's shards (global index and
device), the lead device and an optional ``torch.distributed`` process
group, and carries the collectives the generation step needs. A shard list
may name one device several times (``["cuda:0"] * 4``, ``["cpu"] * 8``):
a virtual mesh, which runs the whole sharded algebra on one device.

Collectives are deterministic: :meth:`ParticleMesh.psum` gathers the
per-shard partials and sums them in shard order (``all_reduce`` sums in
whatever order its ring takes), so 2 processes x 4 shards give the bits of
1 process x 8 shards. Across processes they ride ``torch.distributed``
(``nccl`` for CUDA shards, ``gloo`` for CPU shards).

``replicate_ident`` and the jit caches of the JAX module (its lines 55-101)
have no counterpart: torch runs eagerly, a gather is a plain call, and a
window of :func:`assemble_rows_chunked` is assembled from this process's
own shard slices.
"""

from __future__ import annotations

import collections
import datetime
import os

import numpy as np
import torch

#: the kinds of :attr:`ParticleMesh.collectives`
COLLECTIVE_KINDS = ("psum", "pmin", "all_gather")

#: default seconds a collective of :func:`initialize_distributed`'s group
#: waits for its peers before it raises
DEFAULT_TIMEOUT_S = 600.0


def _dist():
    import torch.distributed as dist

    return dist


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    device="cuda",
    timeout_s: float = DEFAULT_TIMEOUT_S,
):
    """Join the process group (replaces the reference's MPI_Init): call once
    per process before :func:`particle_mesh`. ``coordinator_address`` is
    ``host:port`` of process 0; each argument left None is read from
    torchrun's environment (``MASTER_ADDR`` / ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``). The backend is ``nccl`` for a ``cuda``
    ``device`` and ``gloo`` for ``cpu``. No-op when the group is already
    up. Returns the default group."""
    dist = _dist()
    if dist.is_initialized():
        return dist.group.WORLD
    if coordinator_address is None:
        addr = os.environ.get("MASTER_ADDR")
        port = os.environ.get("MASTER_PORT")
        if not addr or not port:
            raise ValueError(
                "initialize_distributed: give coordinator_address "
                "('host:port') or set MASTER_ADDR and MASTER_PORT")
        coordinator_address = f"{addr}:{port}"
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    dev = torch.device(device)
    if dev.type == "cuda":
        from abcsmc_tpu_torch import resolve_device

        resolve_device(dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=float(timeout_s)),
    )
    return dist.group.WORLD


def _local_cuda_devices():
    from abcsmc_tpu_torch import resolve_device

    resolve_device("cuda")
    local_rank = os.environ.get("LOCAL_RANK")
    dist = _dist()
    if (local_rank is not None and dist.is_initialized()
            and dist.get_world_size() > 1):
        # torchrun: one process per card of the host
        return [torch.device("cuda", int(local_rank))]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class ParticleMesh:
    """A 1-D particle mesh: this process's shards and the process group.

    ``devices`` are this process's shards in shard order (repeats make a
    virtual mesh); ``group`` is the ``torch.distributed`` process group the
    mesh spans, None for a one-process mesh without collectives. Every
    process must hold the same number of shards; process ``r``'s shards are
    the global shards ``r * n_local .. (r + 1) * n_local - 1``.

    Every :meth:`psum`, :meth:`pmin`, :meth:`all_gather` and
    :meth:`all_gather_cat` call adds to :attr:`collectives`, by kind, one
    to ``count`` and its per-shard payload to ``bytes``, with the
    definitions of ``tools/scaling_analysis.py`` of the JAX package: a
    reduction counts one shard's partial, a gather the gathered result
    (every shard's part). Each call counts, a virtual mesh's and a
    one-shard mesh's too, where the call returns its one part and no data
    moves: the counts are the step's collectives whatever the mesh. They
    are host integers read from shapes (no device work, no sync); in a
    CUDA graph capture the calls run, and count, once, at capture, and a
    replay adds nothing. :meth:`reset_collectives` zeroes them.
    """

    def __init__(self, devices, group=None):
        devs = []
        for d in devices:
            d = torch.device(d)
            if d.type == "cuda" and d.index is None:
                d = torch.device("cuda", torch.cuda.current_device())
            if d.type not in ("cuda", "cpu"):
                raise ValueError(f"unsupported mesh device {d} (cuda or cpu)")
            devs.append(d)
        if not devs:
            raise ValueError("a particle mesh needs at least one device")
        self.devices = devs
        self.group = group
        self.lead = devs[0]
        if group is None:
            self.process_index, self.process_count = 0, 1
        else:
            dist = _dist()
            self.process_index = dist.get_rank(group)
            self.process_count = dist.get_world_size(group)
        self.n_local = len(devs)
        self.size = self.n_local * self.process_count
        self.first_shard = self.process_index * self.n_local
        self.reset_collectives()
        self._comm = None
        if group is not None:
            backend = _dist().get_backend(group)
            kinds = {d.type for d in devs}
            if backend == "nccl":
                if kinds != {"cuda"}:
                    raise ValueError("an nccl group needs CUDA shards")
                torch.cuda.set_device(self.lead)
                self._comm = self.lead
            else:
                self._comm = torch.device("cpu")
            counts = self._gather_stack(
                torch.tensor([self.n_local], dtype=torch.int64))
            if int(counts.min()) != int(counts.max()):
                raise ValueError(
                    "every process of a particle mesh must hold the same "
                    f"number of shards, got {counts.flatten().tolist()}")

    # ------------------------------------------------------------ layout
    @property
    def shards(self) -> list[tuple[int, torch.device]]:
        """(global shard index, device) of this process's shards."""
        return [(self.first_shard + i, d) for i, d in enumerate(self.devices)]

    @property
    def multi_process(self) -> bool:
        return self.process_count > 1

    def padded(self, n: int) -> int:
        """``n`` rounded up to a multiple of the shard count: the rows of
        a population buffer (rows >= n are padding)."""
        return -(-int(n) // self.size) * self.size

    def row_offset(self, i: int, local_n: int) -> int:
        """The global index of local shard ``i``'s first row."""
        return (self.first_shard + i) * int(local_n)

    def shards_per_device(self) -> int:
        """The most local shards that share one device (the auto memory
        rules plan for all of them)."""
        return max(collections.Counter(self.devices).values())

    @property
    def one_device(self) -> bool:
        """True when every shard of the mesh lives on one device of this
        process (a CUDA graph can capture the whole step)."""
        return self.process_count == 1 and len(set(self.devices)) == 1

    def shard_rows(self, x, n_valid: int | None = None):
        """A host or device [n, ...] buffer as this process's shards: tail
        padded with copies of its last row to :meth:`padded` rows (valid
        values for a simulator, masked out of every statistic), cut, and
        each shard moved to its device."""
        x = torch.as_tensor(x)
        n = x.shape[0]
        n_pad = self.padded(n if n_valid is None else n_valid)
        if n_pad != n:
            x = torch.cat([x, x[-1:].expand(n_pad - n, *x.shape[1:])])
        local_n = n_pad // self.size
        return [x[self.row_offset(i, local_n):
                  self.row_offset(i, local_n) + local_n].to(d).contiguous()
                for i, d in enumerate(self.devices)]

    # ------------------------------------------------------- collectives
    def _gather_stack(self, local):
        """[process_count, *local.shape] of every process's ``local``, on
        the communication device."""
        dist = _dist()
        local = local.to(self._comm).contiguous()
        out = [torch.empty_like(local) for _ in range(self.process_count)]
        dist.all_gather(out, local, group=self.group)
        return torch.stack(out)

    def reset_collectives(self):
        """Zero the collective counters (:attr:`collectives`)."""
        self.collectives = {kind: {"count": 0, "bytes": 0}
                            for kind in COLLECTIVE_KINDS}

    def _count(self, kind: str, part, shards: int = 1):
        """Add one ``kind`` collective to :attr:`collectives`: ``shards``
        times the bytes of one shard's ``part``. Shape and dtype alone: no
        device work, no sync."""
        entry = self.collectives[kind]
        entry["count"] += 1
        entry["bytes"] += shards * part.numel() * part.element_size()

    def _all_gather(self, parts):
        if self.group is None:
            return [p.to(self.lead) for p in parts]
        local = torch.stack([p.to(self._comm) for p in parts])
        every = self._gather_stack(local)
        return [x.to(self.lead) for x in every.reshape(
            self.size, *local.shape[1:]).unbind(0)]

    def all_gather(self, parts):
        """Every shard's tensor, in shard order, on the lead device:
        ``parts`` holds this process's (equal shapes on every shard)."""
        self._count("all_gather", parts[0], self.size)
        return self._all_gather(parts)

    def all_gather_cat(self, parts):
        """:meth:`all_gather` concatenated along axis 0."""
        self._count("all_gather", parts[0], self.size)
        if self.group is None and len(parts) == 1:
            return parts[0]
        return torch.cat(self._all_gather(parts))

    def psum(self, parts):
        """The sum over every shard of the per-shard partials, in shard
        order, on the lead device: the same bits on every process and for
        every process layout of the same shard count. One shard without a
        group returns its partial itself."""
        self._count("psum", parts[0])
        if self.group is None and len(parts) == 1:
            return parts[0]
        every = self._all_gather(parts)
        acc = every[0]
        for x in every[1:]:
            acc = acc + x
        return acc

    def pmin(self, parts):
        """The elementwise minimum over every shard's partial."""
        self._count("pmin", parts[0])
        if self.group is None and len(parts) == 1:
            return parts[0]
        return torch.stack(self._all_gather(parts)).amin(0)

    def any_process(self, flag: bool) -> bool:
        """True when ``flag`` is set on any process (False everywhere
        single-process when it is False here)."""
        if not self.multi_process:
            return bool(flag)
        every = self._gather_stack(torch.tensor([int(bool(flag))]))
        return bool(every.any())

    def max_over_processes(self, value: int) -> int:
        """The largest of every process's ``value``."""
        if not self.multi_process:
            return int(value)
        return int(self._gather_stack(torch.tensor([int(value)])).max())

    def broadcast_flag(self, value: bool) -> bool:
        """Process 0's boolean on every process."""
        if not self.multi_process:
            return bool(value)
        every = self._gather_stack(torch.tensor([int(bool(value))]))
        return bool(every[0, 0])

    def barrier(self):
        """Returns after every process of the mesh reached it."""
        if self.multi_process:
            # a gather, not dist.barrier: nccl's barrier guesses a device
            self._gather_stack(torch.zeros((1,), dtype=torch.int64))


def particle_mesh(devices=None, group=None) -> ParticleMesh:
    """A 1-D particle mesh over this process's ``devices`` (default: every
    visible CUDA device, or under torchrun with several processes the card
    of ``LOCAL_RANK``). Repeats are allowed (``["cuda:0"] * 4``, ``["cpu"] *
    8``). ``group`` defaults to the default ``torch.distributed`` group
    when one is up with more than one process; pass a group explicitly to
    run the collectives through ``torch.distributed`` with one process."""
    if devices is None:
        devices = _local_cuda_devices()
    if group is None:
        dist = _dist()
        if dist.is_initialized() and dist.get_world_size() > 1:
            group = dist.group.WORLD
    return ParticleMesh(list(devices), group)


def single_mesh(device) -> ParticleMesh:
    """The one-shard mesh on ``device``: the generation step without a
    mesh."""
    return ParticleMesh([device])


def _rows_axis0(arr, axis: int):
    return [torch.movedim(a.detach(), axis, 0) for a in arr]


def assemble_rows_chunked(arr, mesh: ParticleMesh, chunk_rows: int,
                          axis: int = 0) -> np.ndarray:
    """Host copy of a row-sharded buffer (``arr``: this process's shards),
    assembled window by window so the peak extra memory is one
    ``chunk_rows``-row window per process, not the whole buffer. ``axis``
    is the row axis (0 for [N, ...] population buffers, 1 for [G, N, ...]
    stacked histories). Each local shard copies its overlap with the
    window straight into the window on the lead device; a window's rows
    are then placed by their owning process, not summed, so the copy is
    exact. The final window is the partial remainder."""
    parts = _rows_axis0(arr, axis)
    local_n = parts[0].shape[0]
    n = local_n * mesh.size
    per_proc = local_n * mesh.n_local
    out = []
    for start in range(0, n, chunk_rows):
        stop = min(start + chunk_rows, n)
        win = torch.zeros((stop - start,) + tuple(parts[0].shape[1:]),
                          dtype=parts[0].dtype, device=mesh.lead)
        for i, part in enumerate(parts):
            off = mesh.row_offset(i, local_n)
            a, b = max(start, off), min(stop, off + local_n)
            if a < b:
                win[a - start:b - start] = part[a - off:b - off]
        if mesh.multi_process:
            every = mesh._gather_stack(win)                   # [procs, w, ...]
            owner = torch.div(torch.arange(start, stop), per_proc,
                              rounding_mode="floor")
            win = every[owner.to(every.device),
                        torch.arange(stop - start, device=every.device)]
        out.append(win.cpu())
    return torch.movedim(torch.cat(out), 0, axis).numpy()


def fetch_rows_global(arr, mesh: ParticleMesh, chunk_rows: int = 1 << 22,
                      axis: int = 0) -> np.ndarray:
    """Host copy of a row-sharded buffer that is safe on multi-process
    meshes and at memory-bound N. One process: its shards concatenated in
    order. Several: one shard-ordered gather up to ``chunk_rows`` rows along
    ``axis``, and above that :func:`assemble_rows_chunked` in windows."""
    if not mesh.multi_process:
        return torch.cat([a.detach().cpu() for a in arr], dim=axis).numpy()
    rows = arr[0].shape[axis] * mesh.size
    if rows > chunk_rows:
        return assemble_rows_chunked(arr, mesh, chunk_rows, axis)
    parts = _rows_axis0(arr, axis)
    every = mesh.all_gather(parts)
    return torch.movedim(torch.cat(every), 0, axis).cpu().numpy()
