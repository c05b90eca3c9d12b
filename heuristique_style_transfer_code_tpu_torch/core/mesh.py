"""The data-parallel mesh of the port (``core/mesh.py`` of the JAX package).

The JAX package lays a 1-D ``Mesh`` over the ``data`` axis and lets GSPMD
insert every collective. Here the mesh is one process a device, joined by
a ``torch.distributed`` process group (``parallel/multihost.py`` starts
it): NCCL between cards, gloo on the CPU. ``Mesh`` holds this rank's
place (rank, world size, device, backend) and the few collectives the
train step needs, each bucketed (one flat buffer per dtype) and each
waited on with the group's timeout, so no collective hangs a run.

A rank holds its rows of the single-device run's global batch (``rows``):
the contiguous block ``[r B/N, (r+1) B/N)``, JAX's ``P("data")`` layout of
the same loader output. Under ``--grad_accum K`` each of the K
micro-batches (global rows ``[k B/K, (k+1) B/K)``) is split the same way,
so a micro-batch's batch-norm statistics are those of the single-device
run's micro-batch.

Gloo on CUDA tensors: gloo's support for them differs between torch
versions and collectives (it has no CUDA reduce-scatter), so a gloo mesh
whose device is a card stages every collective through host memory (a
copy to the CPU, the collective, a copy back). Only a caller that names
gloo and CUDA devices gets such a mesh (``create_mesh(devices=)``, as the
chip smoke's two ranks sharing one card do); the CLIs put NCCL on cards.

An evaluation rank decodes its rows of each padded loader batch
(``HostLoader(rows=mesh.rows(B))``), runs the eval step on them and
``gather_valid`` puts the global batch back together on every rank, in
the single-device order, trimmed to its valid rows.

``DeviceGroup`` is the servers' ``--devices N``: one process holding one
replica a device, with no process group and no collective (an eval
forward exchanges nothing between rows), each batch split into N
contiguous blocks of rows.

``activate(mesh, n_accum)`` makes the mesh the one that the batch norms
and the batch mixing of a train step see (``active``), as GSPMD's mesh is
implicit in the JAX step; it is a process-wide setting, not a
thread-local one, since the autograd engine may run a remat block's
recompute on another thread.
"""
from __future__ import annotations

import contextlib
import datetime
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

DEFAULT_TIMEOUT_S = 600.0


def collective_timeout() -> datetime.timedelta:
    """The timeout of every collective (and of the group's start)."""
    return datetime.timedelta(seconds=DEFAULT_TIMEOUT_S)


def pad_to_multiple(n: int, k: int) -> int:
    """``n`` rounded up to a multiple of ``k`` (a batch padded for a mesh of
    ``k`` ranks, as the JAX helper)."""
    return ((n + k - 1) // k) * k


def local_rows(batch: int, rank: int, world: int, n_accum: int = 1) -> np.ndarray:
    """The global rows of a ``batch``-row batch that rank ``rank`` of
    ``world`` holds, in its local order: for each of the ``n_accum``
    micro-batches its ``rank``-th block of B / (K N) rows."""
    if batch % (world * n_accum):
        raise ValueError(f"batch {batch} is not divisible by {world} devices x "
                         f"{n_accum} micro-batches")
    mb = batch // n_accum
    lmb = mb // world
    return np.concatenate([np.arange(k * mb + rank * lmb, k * mb + (rank + 1) * lmb)
                           for k in range(n_accum)])


class Mesh:
    """One rank of a 1-D data-parallel mesh. Without a ``backend`` (no
    process group: one device) its collectives are the identity; with one,
    they run, a one-rank group's included."""

    def __init__(self, rank: int, world_size: int, device, backend: Optional[str] = None):
        self.rank = int(rank)
        self.world_size = int(world_size)
        self.device = torch.device(device)
        self.backend = backend
        self.distributed = backend is not None
        self.timeout = collective_timeout()
        # gloo on a card: every collective goes through host memory
        self.stage_on_host = backend == "gloo" and self.device.type == "cuda"

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def __repr__(self):
        return (f"Mesh(rank={self.rank}, world_size={self.world_size}, device={self.device}, "
                f"backend={self.backend})")

    # -- rows ---------------------------------------------------------------
    def rows(self, batch: int, n_accum: int = 1) -> np.ndarray:
        return local_rows(batch, self.rank, self.world_size, n_accum)

    def local(self, x, n_accum: int = 1):
        """This rank's rows of a global array or tensor (leading axis)."""
        idx = self.rows(x.shape[0], n_accum)
        if torch.is_tensor(x):
            return x[torch.as_tensor(idx, device=x.device)]
        return np.asarray(x)[idx]

    # -- collectives --------------------------------------------------------
    def _wait(self, work) -> None:
        if self.backend == "gloo":
            work.wait(self.timeout)
        else:
            work.wait()

    def _staged(self, t: torch.Tensor) -> torch.Tensor:
        return t.cpu() if self.stage_on_host else t

    def _flat_all_reduce(self, flat: torch.Tensor, op) -> torch.Tensor:
        import torch.distributed as dist

        buf = self._staged(flat)
        self._wait(dist.all_reduce(buf, op=op, async_op=True))
        return buf.to(flat.device) if buf.device != flat.device else buf

    def all_reduce(self, tensors: Sequence[torch.Tensor], op: str = "sum") -> List[torch.Tensor]:
        """The element-wise sum (or max) over the ranks of each tensor: one
        flat buffer per dtype, one collective each. New tensors; the
        inputs are not written."""
        tensors = list(tensors)
        if not self.distributed:
            return [t.clone() for t in tensors]
        import torch.distributed as dist

        rop = dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX
        out: List[Optional[torch.Tensor]] = [None] * len(tensors)
        by_dtype = {}
        for i, t in enumerate(tensors):
            by_dtype.setdefault(t.dtype, []).append(i)
        with torch.profiler.record_function("hst_dp::all_reduce"):
            for idx in by_dtype.values():
                flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
                red = self._flat_all_reduce(flat, rop)
                for i, part in zip(idx, torch.split(red, [tensors[i].numel() for i in idx])):
                    out[i] = part.view(tensors[i].shape)
        return out

    def any(self, flag: bool) -> bool:
        """Whether any rank's ``flag`` is set (every rank gets the answer)."""
        if not self.distributed:
            return bool(flag)
        t = torch.tensor([1.0 if flag else 0.0], device=self.device)
        return bool(self.all_reduce([t], op="max")[0].item() > 0)

    def max(self, value: float) -> float:
        if not self.distributed:
            return float(value)
        t = torch.tensor([float(value)], dtype=torch.float64, device=self.device)
        return float(self.all_reduce([t], op="max")[0].item())

    def broadcast(self, obj):
        """Rank 0's ``obj`` (any picklable value; tensors on the CPU) on
        every rank; the other ranks' ``obj`` is ignored."""
        if not self.distributed:
            return obj
        import torch.distributed as dist

        box = [obj if self.is_main else None]
        dist.broadcast_object_list(box, src=0, device=self.device if self.backend == "nccl"
                                   else torch.device("cpu"))
        return box[0]

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``t`` (same shape and dtype on all), in rank order."""
        if not self.distributed:
            return [t]
        import torch.distributed as dist

        with torch.profiler.record_function("hst_dp::all_gather"):
            src = self._staged(t.detach().contiguous())
            parts = [torch.empty_like(src) for _ in range(self.world_size)]
            self._wait(dist.all_gather(parts, src, async_op=True))
        return [p.to(t.device) for p in parts] if self.stage_on_host else parts

    def gather_rows(self, t: torch.Tensor, n_accum: int = 1) -> torch.Tensor:
        """The global batch whose rows the ranks hold (``rows``), in the
        single-device order."""
        if not self.distributed:
            return t
        parts = torch.stack(self.all_gather(t))  # (N, K * lmb, ...)
        n, rest = self.world_size, tuple(t.shape[1:])
        lmb = t.shape[0] // n_accum
        return parts.reshape((n, n_accum, lmb) + rest).transpose(0, 1).reshape(
            (n * t.shape[0],) + rest)

    def reduce_scatter(self, flat: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of ``flat`` (length divisible by N), of
        which this rank keeps its contiguous 1/N."""
        if not self.distributed:
            return flat.clone()
        import torch.distributed as dist

        chunk = flat.numel() // self.world_size
        with torch.profiler.record_function("hst_dp::reduce_scatter"):
            src = self._staged(flat.detach().contiguous())
            out = torch.empty(chunk, dtype=src.dtype, device=src.device)
            self._wait(dist.reduce_scatter_tensor(out, src, async_op=True))
        return out.to(flat.device) if self.stage_on_host else out


def gather_valid(mesh: Optional[Mesh], parts: Sequence, n_valid: Optional[int] = None,
                 n_accum: int = 1) -> List[np.ndarray]:
    """The evaluation helper: each of ``parts`` (tensors or arrays, rows
    first) holds this rank's rows (``Mesh.rows(B, n_accum)``) of a padded
    loader batch; returns each part's rows of the global batch, in the
    single-device order (``Mesh.gather_rows``), its first ``n_valid`` rows
    (all with None), as numpy. The parts of a kind (floating, integer) go
    as one flat buffer: one all_gather each. Without a data-parallel mesh,
    the parts themselves, trimmed."""
    dp = data_parallel(mesh)
    cut = slice(None) if n_valid is None else slice(0, int(n_valid))
    if dp is None:
        return [(p.detach().cpu().numpy() if torch.is_tensor(p) else np.asarray(p))[cut]
                for p in parts]
    tensors = [p.detach() if torch.is_tensor(p) else torch.from_numpy(np.ascontiguousarray(p))
               for p in parts]
    out: List[Optional[np.ndarray]] = [None] * len(tensors)
    kinds = {}
    for i, t in enumerate(tensors):
        kinds.setdefault(t.is_floating_point(), []).append(i)
    for floating, idx in kinds.items():
        dtypes = {tensors[i].dtype for i in idx}
        wide = dtypes.pop() if len(dtypes) == 1 else (torch.float64 if floating
                                                      else torch.int64)
        rows = tensors[idx[0]].shape[0]
        flat = torch.cat([tensors[i].to(dp.device, wide).reshape(rows, -1) for i in idx], dim=1)
        whole = dp.gather_rows(flat, n_accum).cpu()
        start = 0
        for i in idx:
            t = tensors[i]
            width = int(np.prod(t.shape[1:], dtype=np.int64))
            part = whole[:, start:start + width].reshape((whole.shape[0],) + tuple(t.shape[1:]))
            out[i] = part.to(t.dtype).numpy()[cut]
            start += width
    return out


def row_blocks(batch: int, n: int) -> List[slice]:
    """The rows of each of ``n`` replicas in a batch of ``batch`` rows: ``n``
    contiguous blocks, replica k taking block k."""
    if batch % n:
        raise ValueError(f"batch {batch} is not divisible by {n} devices")
    b = batch // n
    return [slice(k * b, (k + 1) * b) for k in range(n)]


class DeviceGroup:
    """The servers' ``--devices N``: one replica a device in this process
    (a device may repeat: two replicas on one card). A batch of B rows goes
    out as N contiguous blocks of B / N rows (``row_blocks``), replica k
    taking block k, and the answers come back in the same order."""

    def __init__(self, devices: Sequence):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a device group needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self):
        return f"DeviceGroup({[str(d) for d in self.devices]})"

    def per_device(self, build) -> list:
        """``build(device)`` once a replica: two replicas on one device get
        one each, as replicas on two cards do."""
        return [build(d) for d in self.devices]


def create_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """This process's rank of the data-parallel mesh (the JAX
    ``create_mesh(n_devices, devices)``). Without a process group it is the
    one-device mesh on ``devices[0]`` (the CPU by default). With one
    (``parallel.multihost.initialize_distributed``) ``n_devices`` must be
    its world size, and ``devices`` lists each rank's device; a device may
    repeat where the backend allows it (gloo: two ranks on one card, whose
    collectives are staged through host memory). By default a NCCL rank
    takes card ``LOCAL_RANK`` and a gloo rank the CPU."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        if n_devices not in (None, 1):
            raise ValueError(f"a mesh of {n_devices} devices needs a process group "
                             "(parallel.multihost.initialize_distributed)")
        return Mesh(0, 1, devices[0] if devices else "cpu")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_devices not in (None, world):
        raise ValueError(f"create_mesh({n_devices}) in a process group of {world} ranks")
    backend = dist.get_backend()
    if devices is None:
        if backend == "nccl":
            local = int(os.environ.get("LOCAL_RANK", rank))
            devices = [None] * world
            devices[rank] = torch.device("cuda", local)
        else:
            devices = ["cpu"] * world
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    device = torch.device(devices[rank])
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("a NCCL rank needs a CUDA device")
    if backend == "nccl":
        cards = [torch.device(d) for d in devices if d is not None]
        if len(set(cards)) < len(cards):
            raise ValueError("NCCL refuses two ranks on one card; name gloo for that")
    return Mesh(rank, world, device, backend)


_ACTIVE: Optional[Tuple[Mesh, int]] = None


@contextlib.contextmanager
def activate(mesh: Optional[Mesh], n_accum: int = 1):
    """Within the block, ``active()`` is ``(mesh, n_accum)`` when the mesh
    has a process group (``data_parallel``), else None."""
    global _ACTIVE
    previous = _ACTIVE
    _ACTIVE = (mesh, int(n_accum)) if data_parallel(mesh) is not None else None
    try:
        yield
    finally:
        _ACTIVE = previous


def active() -> Optional[Tuple[Mesh, int]]:
    """The ``(mesh, n_accum)`` of the train step being run, or None."""
    return _ACTIVE


def data_parallel(mesh: Optional[Mesh]) -> Optional[Mesh]:
    """``mesh`` when it has a process group, else None: a mesh without one
    (one device) runs the single-device path; a one-rank group (one NCCL
    rank under ``torchrun``) runs the data-parallel one, with the same
    numbers."""
    return mesh if mesh is not None and mesh.distributed else None
