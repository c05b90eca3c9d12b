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

The (data, spatial) mesh (``create_mesh(spatial=S)``, ``--shard_spatial``):
rank r is (data r // S, spatial r % S), JAX's ``reshape(n // S, S)`` of
the devices. ``data_axis`` and ``spatial_axis`` are meshes of their own
over the ranks of this rank's data and spatial groups (every rank makes
every group, in one order), with the same collectives and the group's
timeout; the rows of a batch (``rows``, ``local``, ``gather_rows``) go
over the data axis.

The (data, model, spatial) mesh (``create_mesh(model=M, spatial=S)``,
``parallel.sharding.make_mesh_3d``; with S = 1 the (data, model) mesh of
``make_mesh_2d``): rank r = (d M + m) S + s, JAX's ``reshape(data, model,
spatial)``. ``model_axis`` is the M ranks of this rank's (d, s), over
which the tensor-parallel heads split their columns
(``parallel/tensor_parallel.py``); ``replica_axis`` is the (data,
spatial) plane of its model index m, D S ranks in the order (d, s), over
which gradients and batch-norm statistics reduce (the world on a mesh
without a model axis, the data axis on one without a spatial axis). The
ranks of a model or spatial group hold the same rows. ``bands(mesh)`` makes the spatial axis the one whose
row bands the ops see (``active_bands``): inside it every NHWC activation
is this rank's band of rows of its image (``parallel/spatial.py``), and
``replicated()`` suspends that for work on whole, replicated maps.

The (fold, data) mesh of ``--parallel_folds`` (``FoldMesh``, JAX's
``make_fold_mesh``): rank r < F D is (fold r // D, data r % D), each fold
group holding K / F folds on D ranks; the evaluation mesh is the first
ranks of the same world, of JAX's ``build_mesh`` size, so the world is the
larger of the two (``fold_world``).
"""
from __future__ import annotations

import contextlib
import datetime
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

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
    they run, a one-rank group's included. ``group`` (a process group of
    the members ``ranks``, by global rank) makes it the mesh of one axis of
    a 2-D mesh; None is the whole world."""

    def __init__(self, rank: int, world_size: int, device, backend: Optional[str] = None,
                 group=None, ranks: Optional[Sequence[int]] = None):
        self.rank = int(rank)
        self.world_size = int(world_size)
        self.device = torch.device(device)
        self.backend = backend
        self.distributed = backend is not None
        self.timeout = collective_timeout()
        # gloo on a card: every collective goes through host memory
        self.stage_on_host = backend == "gloo" and self.device.type == "cuda"
        self.group = group
        self.ranks = list(range(self.world_size)) if ranks is None else [int(r) for r in ranks]
        # a 1-D mesh is its own data axis and replica plane; create_mesh(
        # model=M, spatial=S) sets the axes
        self.spatial = 1
        self.model = 1
        self.data_axis: "Mesh" = self
        self.spatial_axis: Optional["Mesh"] = None
        self.model_axis: Optional["Mesh"] = None
        self.replica_axis: "Mesh" = self

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def data_index(self) -> int:
        """This rank's index on the data axis: the process of a loader's
        stride (``HostLoader(process_index=)``, over the data axis's
        ``world_size`` processes). The ranks of a model or spatial group
        share it, as they share their rows."""
        return self.data_axis.rank

    def __deepcopy__(self, memo):
        # a handle on the process group, not data: a copied model (an
        # EMA's, a gathered FSDP one) keeps its heads on the same axes
        return self

    def __repr__(self):
        extra = f", model={self.model}" if self.model > 1 else ""
        extra += f", spatial={self.spatial}" if self.spatial > 1 else ""
        return (f"Mesh(rank={self.rank}, world_size={self.world_size}, device={self.device}, "
                f"backend={self.backend}{extra})")

    # -- rows ---------------------------------------------------------------
    def rows(self, batch: int, n_accum: int = 1) -> np.ndarray:
        """This rank's rows of a batch: its data rank's block (the ranks of
        a model or spatial group hold the same rows)."""
        data = self.data_axis
        return local_rows(batch, data.rank, data.world_size, n_accum)

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
        self._wait(dist.all_reduce(buf, op=op, async_op=True, group=self.group))
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
        with torch.profiler.record_function("hst_dp::all_reduce"):
            return _by_dtype(tensors, lambda flat: self._flat_all_reduce(flat, rop))

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
        dist.broadcast_object_list(box, src=self.ranks[0], group=self.group,
                                   device=self.device if self.backend == "nccl"
                                   else torch.device("cpu"))
        return box[0]

    def broadcast_tensors(self, tensors: Sequence[torch.Tensor], src: int) -> None:
        """Member ``src``'s ``tensors`` written into every member's, in
        place (same shapes and dtypes on all): one flat buffer per dtype,
        one broadcast each."""
        tensors = list(tensors)
        if not self.distributed or not tensors:
            return
        import torch.distributed as dist

        def bcast(flat):
            buf = self._staged(flat)
            self._wait(dist.broadcast(buf, src=self.ranks[src], group=self.group,
                                      async_op=True))
            return buf.to(flat.device) if buf.device != flat.device else buf

        with torch.no_grad(), torch.profiler.record_function("hst_pf::broadcast"):
            for t, got in zip(tensors, _by_dtype(tensors, bcast)):
                t.copy_(got)

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``t`` (same shape and dtype on all), in rank order."""
        if not self.distributed:
            return [t]
        import torch.distributed as dist

        with torch.profiler.record_function("hst_dp::all_gather"):
            src = self._staged(t.detach().contiguous())
            parts = [torch.empty_like(src) for _ in range(self.world_size)]
            self._wait(dist.all_gather(parts, src, async_op=True, group=self.group))
        return [p.to(t.device) for p in parts] if self.stage_on_host else parts

    def sum_in_order(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The sum over the members of each tensor, added in member order
        from one all-gather a dtype (one flat buffer each): the same bits on
        every member, whatever the backend's reduction order. New tensors."""
        tensors = list(tensors)
        if not self.distributed:
            return [t.clone() for t in tensors]

        def ordered_sum(flat):
            parts = self.all_gather(flat)
            total = parts[0]
            for p in parts[1:]:
                total = total + p
            return total

        with torch.profiler.record_function("hst_sp::sum_in_order"):
            return _by_dtype(tensors, ordered_sum)

    def exchange(self, sends: Dict[int, torch.Tensor],
                 receives: Dict[int, Tuple[Tuple[int, ...], torch.dtype]]) -> Dict[int, torch.Tensor]:
        """Point to point within the group: ``sends[q]`` goes to member q,
        and a tensor of ``receives[q]``'s (shape, dtype) comes from member
        q, on this mesh's device; every pair's messages in one batch
        (``batch_isend_irecv``), each waited on with the timeout."""
        if not sends and not receives:
            return {}
        import torch.distributed as dist

        where = torch.device("cpu") if self.stage_on_host else self.device
        ops, bufs = [], {}
        with torch.profiler.record_function("hst_sp::exchange"):
            for q, t in sends.items():
                ops.append(dist.P2POp(dist.isend, self._staged(t.detach().contiguous()),
                                      self.ranks[q], self.group))
            for q, (shape, dtype) in receives.items():
                bufs[q] = torch.empty(shape, dtype=dtype, device=where)
                ops.append(dist.P2POp(dist.irecv, bufs[q], self.ranks[q], self.group))
            for work in dist.batch_isend_irecv(ops):
                self._wait(work)
        return {q: b.to(self.device) for q, b in bufs.items()}

    def gather_rows(self, t: torch.Tensor, n_accum: int = 1) -> torch.Tensor:
        """The global batch whose rows the ranks hold (``rows``), in the
        single-device order (over the data axis)."""
        if self.data_axis is not self:
            return self.data_axis.gather_rows(t, n_accum)
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
            self._wait(dist.reduce_scatter_tensor(out, src, async_op=True, group=self.group))
        return out.to(flat.device) if self.stage_on_host else out


def _by_dtype(tensors: Sequence[torch.Tensor], reduce_flat) -> List[torch.Tensor]:
    """``reduce_flat`` of one flat buffer a dtype of ``tensors``, cut back
    into tensors of their shapes."""
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = reduce_flat(torch.cat([tensors[i].detach().reshape(-1) for i in idx]))
        for i, part in zip(idx, torch.split(flat, [tensors[i].numel() for i in idx])):
            out[i] = part.view(tensors[i].shape)
    return out


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


def create_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None,
                spatial: int = 1, model: int = 1) -> Mesh:
    """This process's rank of the data-parallel mesh (the JAX
    ``create_mesh(n_devices, devices)``). Without a process group it is the
    one-device mesh on ``devices[0]`` (the CPU by default). With one
    (``parallel.multihost.initialize_distributed``) ``n_devices`` must be
    its world size, and ``devices`` lists each rank's device; a device may
    repeat where the backend allows it (gloo: two ranks on one card, whose
    collectives are staged through host memory). By default a NCCL rank
    takes card ``LOCAL_RANK`` and a gloo rank the CPU. ``model`` M and
    ``spatial`` S > 1 make it the (data, model, spatial) mesh of the world
    (module docstring), which needs a process group whose size M S
    divides."""
    import torch.distributed as dist

    spatial, model = int(spatial), int(model)
    if not (dist.is_available() and dist.is_initialized()):
        if n_devices not in (None, 1) or spatial != 1 or model != 1:
            raise ValueError(f"a mesh of {n_devices} devices (model {model}, spatial {spatial}) "
                             "needs a process group (parallel.multihost.initialize_distributed)")
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
    mesh = Mesh(rank, world, device, backend)
    if spatial != 1 or model != 1:
        _split_axes(mesh, spatial, model)
    return mesh


def _split_axes(mesh: Mesh, spatial: int, model: int = 1) -> None:
    """Make ``mesh`` (the world) the (data, model, spatial) mesh: rank r =
    (d M + m) S + s. Every rank makes every group, in one order, as
    ``dist.new_group`` requires: the spatial groups (S > 1), the model
    groups (M > 1), the data groups, then the (data, spatial) plane of
    each model index (where M and S are both > 1; otherwise the plane is
    the world or the data axis), each family in order of its indices."""
    import torch.distributed as dist

    world = mesh.world_size
    if spatial < 1 or model < 1 or world % (spatial * model):
        raise ValueError(f"a model axis of {model} and a spatial axis of {spatial} do not "
                         f"divide {world} ranks")
    data = world // (spatial * model)

    def rank_of(d: int, m: int, s: int) -> int:
        return (d * model + m) * spatial + s

    made = {}

    def make(key, ranks):
        made[key] = ranks, dist.new_group(ranks, timeout=mesh.timeout)

    if spatial > 1:
        for d in range(data):
            for m in range(model):
                make(("spatial", d, m), [rank_of(d, m, s) for s in range(spatial)])
    if model > 1:
        for d in range(data):
            for s in range(spatial):
                make(("model", d, s), [rank_of(d, m, s) for m in range(model)])
    for m in range(model):
        for s in range(spatial):
            make(("data", m, s), [rank_of(d, m, s) for d in range(data)])
    if model > 1 and spatial > 1:
        for m in range(model):
            make(("replica", m), [rank_of(d, m, s) for d in range(data) for s in range(spatial)])
    d, rest = divmod(mesh.rank, model * spatial)
    m, s = divmod(rest, spatial)

    def axis(key, rank, size):
        ranks, group = made[key]
        return Mesh(rank, size, mesh.device, mesh.backend, group, ranks)

    mesh.data_axis = axis(("data", m, s), d, data)
    if spatial > 1:
        mesh.spatial_axis = axis(("spatial", d, m), s, spatial)
    if model > 1:
        mesh.model_axis = axis(("model", d, s), m, model)
        mesh.replica_axis = (axis(("replica", m), d * spatial + s, data * spatial)
                             if spatial > 1 else mesh.data_axis)
    mesh.spatial, mesh.model = spatial, model


def fold_mesh_shape(k_folds: int, n_devices: int, batch_size: Optional[int] = None
                    ) -> Tuple[int, int]:
    """(fold, data) of the JAX ``make_fold_mesh`` (``foldparallel.py:48-66``)
    over ``n_devices``: the fold axis gcd(K, n), each fold group holding
    K / F folds; the data axis n // F, lowered until it divides
    ``batch_size``."""
    fold = math.gcd(int(k_folds), int(n_devices))
    data = int(n_devices) // fold
    if batch_size is not None:
        while data > 1 and batch_size % data:
            data -= 1
    return fold, data


def fold_world(k_folds: int, n_devices: int, batch_size: int) -> Tuple[int, int, int, int]:
    """(fold, data, evaluation ranks, world) of ``--parallel_folds`` over
    ``n_devices``. JAX builds both meshes from one device list: the fold
    mesh F x D (``fold_mesh_shape``) and the evaluation mesh, the count
    lowered to a divisor of the batch (``build_mesh``); each starts at the
    first device, so the world is the larger of the two, each mesh keeping
    JAX's shape (8 devices, B = 6, K = 4: fold 4 x data 2 over 8 ranks,
    evaluation over the first 6)."""
    fold, data = fold_mesh_shape(k_folds, n_devices, batch_size)
    n_eval = max(1, int(n_devices))
    while n_eval > 1 and batch_size % n_eval:
        n_eval -= 1
    return fold, data, n_eval, max(fold * data, n_eval)


class FoldMesh:
    """This rank's place in the (fold, data) mesh of ``--parallel_folds``
    over the ranks of ``world``: rank r < F D is (fold r // D, data r % D),
    JAX's fold-major ``reshape(F, D)``; fold group f trains the folds
    ``[f K/F, (f+1) K/F)`` (JAX's ``P("fold")`` blocks of the stacked axis)
    on its D ranks, each holding its rows of every fold's batch. A rank at
    or past F D holds no fold. ``data_axis`` (this rank's fold group) and
    ``fold_axis`` (the F ranks of its data index) are meshes of their own,
    None outside the grid; ``evaluation`` is the mesh of the first
    ``n_eval`` ranks (a one-rank mesh without a process group on rank 0
    when ``n_eval`` is 1), None on the ranks past it."""

    def __init__(self, world: Mesh, k_folds: int, fold: int, data: int, n_eval: int):
        import torch.distributed as dist

        if k_folds % fold or fold * data > world.world_size or n_eval > world.world_size:
            raise ValueError(f"a fold mesh {fold} x {data} (evaluation {n_eval}) of {k_folds} "
                             f"folds over {world.world_size} ranks")
        self.world, self.k_folds, self.fold, self.data = world, int(k_folds), int(fold), int(data)
        self.index = world.rank // data if world.rank < fold * data else None
        self.data_axis: Optional[Mesh] = None
        self.fold_axis: Optional[Mesh] = None
        if world.distributed:  # every rank makes every group, in one order
            made = {}
            for f in range(fold):
                ranks = [f * data + d for d in range(data)]
                made[("data", f)] = ranks, dist.new_group(ranks, timeout=world.timeout)
            for d in range(data):
                ranks = [f * data + d for f in range(fold)]
                made[("fold", d)] = ranks, dist.new_group(ranks, timeout=world.timeout)
            if 1 < n_eval < world.world_size:
                ranks = list(range(n_eval))
                made["evaluation"] = ranks, dist.new_group(ranks, timeout=world.timeout)
            if self.index is not None:
                d = world.rank % data
                ranks, group = made[("data", self.index)]
                self.data_axis = Mesh(d, data, world.device, world.backend, group, ranks)
                ranks, group = made[("fold", d)]
                self.fold_axis = Mesh(self.index, fold, world.device, world.backend, group, ranks)
        elif self.index is not None:
            self.data_axis = self.fold_axis = Mesh(0, 1, world.device)
        if world.rank >= n_eval:
            self.evaluation = None
        elif n_eval == 1:
            self.evaluation = Mesh(0, 1, world.device)
        elif n_eval == world.world_size:
            self.evaluation = world
        else:
            ranks, group = made["evaluation"]
            self.evaluation = Mesh(world.rank, n_eval, world.device, world.backend, group, ranks)

    def folds(self, f: Optional[int] = None) -> range:
        """The folds of fold group ``f`` (this rank's by default; none
        outside the grid)."""
        f = self.index if f is None else f
        if f is None:
            return range(0)
        per = self.k_folds // self.fold
        return range(f * per, (f + 1) * per)


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


_BANDS: Optional[Mesh] = None


@contextlib.contextmanager
def _banded_by(axis: Optional[Mesh]):
    global _BANDS
    previous = _BANDS
    _BANDS = axis
    try:
        yield
    finally:
        _BANDS = previous


def bands(mesh: Optional[Mesh]):
    """Within the block, ``active_bands()`` is the spatial axis of ``mesh``
    when it has one of more than one rank (``--shard_spatial``), else None:
    the ops then treat every NHWC activation as this rank's band of rows
    of its image (``parallel/spatial.py``). Process-wide, as ``activate``."""
    axis = getattr(mesh, "spatial_axis", None)
    return _banded_by(axis if axis is not None and axis.world_size > 1 else None)


def replicated():
    """Within the block no band is active: work on whole maps that every
    rank of a spatial group holds alike (family 3's pooled maps)."""
    return _banded_by(None)


def active_bands() -> Optional[Mesh]:
    """The spatial axis whose row bands the ops see, or None."""
    return _BANDS


def data_parallel(mesh: Optional[Mesh]) -> Optional[Mesh]:
    """``mesh`` when it has a process group, else None: a mesh without one
    (one device) runs the single-device path; a one-rank group (one NCCL
    rank under ``torchrun``) runs the data-parallel one, with the same
    numbers."""
    return mesh if mesh is not None and mesh.distributed else None
