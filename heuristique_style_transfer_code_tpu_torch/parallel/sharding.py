"""Data-parallel and ZeRO-1 parts of ``parallel/sharding.py`` of the JAX
package: the bucketed gradient reduction of a data-parallel step and the
ZeRO-1 layout of the optimiser state (``--zero1``).

Under jit the JAX package gets both from sharding annotations: GSPMD
turns the gradient all-reduce into a reduce-scatter into each device's
momentum shard and an all-gather of the updated parameters. Here the
schedule is written out over the mesh's collectives (``core/mesh.py``):

- plain data parallelism: one all-reduce (SUM) of every gradient, one flat
  buffer per dtype (``core.mesh.Mesh.all_reduce``, which ``train/optim.py``
  calls);
- ``Zero1Layout``: JAX's per-leaf policy (``_zero1_leaf_spec``): each
  trainable leaf is split over the ranks along its largest dimension that
  the rank count divides (and that is at least the rank count); a leaf
  with none stays replicated (biases, norm scales: KBs). The policy reads
  the port's tensor layout (OIHW kernels), so a kernel may be split along
  another axis than JAX's HWIO one: the same bytes a rank. One step
  reduce-scatters the sharded leaves' gradients into each rank's shard
  (all of them in one flat buffer), all-reduces the replicated ones, and,
  after the update of each rank's shards, all-gathers the parameters.

Spatial partitioning (``--shard_spatial``, JAX ``:100-143``): the
(data, spatial) mesh (``make_mesh_spatial``, ``core.mesh.create_mesh(
spatial=S)``), each rank's block of a batch of images (``image_sharding``:
its data rows, and its band of their rows, JAX's ``P("data",
"spatial")``) and the spatial eval step (``make_spatial_eval_step``). The
bands of a layer's rows (``RowSharding``) and the banded ops are in
``parallel/spatial.py``.

Not ported yet: the TP heads, FSDP and the model axis of the 2-D and 3-D
meshes (JAX ``:32-98,211-275``).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from ..core.mesh import Mesh, bands, create_mesh
from .spatial import RowSharding, band_of  # noqa: F401 (RowSharding: this module's API)


def zero1_leaf_dim(shape: Sequence[int], n: int) -> Optional[int]:
    """The dimension a leaf of ``shape`` is split along over ``n`` ranks:
    its largest one that ``n`` divides (the first of equals), or None
    (replicated), as JAX's ``_zero1_leaf_spec``."""
    if len(shape) == 0:
        return None
    for i in sorted(range(len(shape)), key=lambda j: -shape[j]):
        if shape[i] >= n and shape[i] % n == 0:
            return i
    return None


def zero1_state_shardings(shapes: Dict[str, Sequence[int]], n: int) -> Dict[str, Optional[int]]:
    """{leaf name: split dimension or None} of an optimiser state's leaves
    (by their parameters' shapes) over ``n`` ranks."""
    return {name: zero1_leaf_dim(tuple(s), n) for name, s in shapes.items()}


class Zero1Layout:
    """The ZeRO-1 layout of the trainable leaves ``shapes`` over ``mesh``:
    which leaves are split and along which dimension, this rank's shards,
    and the collectives that move gradients into shards and shards back
    into whole tensors."""

    def __init__(self, mesh: Mesh, shapes: Dict[str, Sequence[int]]):
        self.mesh = mesh
        self.shapes = {n: tuple(int(d) for d in s) for n, s in shapes.items()}
        self.dims = zero1_state_shardings(self.shapes, mesh.world_size)
        self.sharded = [n for n, d in self.dims.items() if d is not None]
        self.replicated = [n for n, d in self.dims.items() if d is None]

    def _chunk(self, name: str) -> int:
        return self.shapes[name][self.dims[name]] // self.mesh.world_size

    def part(self, name: str, full: torch.Tensor, rank: Optional[int] = None) -> torch.Tensor:
        """Rank ``rank``'s (this one's by default) view of a whole leaf
        (the whole tensor for a replicated one)."""
        d = self.dims[name]
        if d is None:
            return full
        c = self._chunk(name)
        r = self.mesh.rank if rank is None else rank
        return full.narrow(d, r * c, c)

    def shard(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's own copy of its part of a whole leaf."""
        return self.part(name, full).clone().contiguous()

    def scatter_gradients(self, grads: Dict[str, torch.Tensor]
                          ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """(this rank's shard of the rank-summed gradient of each split
        leaf, the rank-summed gradient of each replicated leaf): one
        reduce-scatter over a buffer laid out rank by rank, one all-reduce
        of the rest."""
        mesh = self.mesh
        shards: Dict[str, torch.Tensor] = {}
        if self.sharded:
            flat = torch.cat([self.part(n, grads[n], q).reshape(-1)
                              for q in range(mesh.world_size) for n in self.sharded])
            mine = mesh.reduce_scatter(flat)
            sizes = [self.part(n, grads[n]).numel() for n in self.sharded]
            for n, piece in zip(self.sharded, torch.split(mine, sizes)):
                shards[n] = piece.view(self.part(n, grads[n]).shape)
        full = dict(zip(self.replicated,
                        mesh.all_reduce([grads[n] for n in self.replicated])))
        return shards, full

    def gather(self, shards: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The whole leaves from every rank's shards (``shards`` holds this
        rank's, for the split leaves): one all-gather."""
        if not self.sharded:
            return {}
        names = self.sharded
        flat = torch.cat([shards[n].reshape(-1) for n in names])
        parts = self.mesh.all_gather(flat)
        sizes = [shards[n].numel() for n in names]
        pieces = [torch.split(p, sizes) for p in parts]
        return {n: torch.cat([pieces[q][i].view(shards[n].shape)
                              for q in range(self.mesh.world_size)], dim=self.dims[n])
                for i, n in enumerate(names)}

    def state_bytes(self, tensors: Dict[str, torch.Tensor]) -> Tuple[int, int]:
        """(bytes of this rank's split leaves, bytes of the replicated
        ones) of a state part held in this layout."""
        split = sum(tensors[n].numel() * tensors[n].element_size() for n in self.sharded)
        repl = sum(tensors[n].numel() * tensors[n].element_size() for n in self.replicated)
        return int(split), int(repl)


# ------------------------------------------------------------ spatial axis


def _axis_factor(n: int) -> int:
    """JAX's default size of a non-data axis: 2 on an even count, else 1."""
    return 2 if n % 2 == 0 and n >= 2 else 1


def make_mesh_spatial(n_devices: Optional[int] = None, spatial: Optional[int] = None,
                      devices: Optional[Sequence] = None) -> Mesh:
    """This rank of the (data, spatial) mesh of the process group's ranks
    (JAX ``make_mesh_spatial``): the batch over ``data``, each image's H
    rows over ``spatial`` (2 by default on an even count), rank r = (r // S,
    r % S). ``n_devices`` must be the group's size; ``devices`` as
    ``create_mesh``'s."""
    import torch.distributed as dist

    n = n_devices or (dist.get_world_size() if dist.is_initialized() else 1)
    if spatial is None:
        spatial = _axis_factor(n)
    if n % spatial:
        raise ValueError(f"a spatial axis of {spatial} does not divide {n} devices")
    return create_mesh(n, devices, spatial=spatial)


def image_sharding(mesh: Optional[Mesh]) -> Callable[[torch.Tensor], torch.Tensor]:
    """JAX's ``image_sharding``: ``cut(images)`` gives this rank's block of
    a global batch of NHWC images, its data rows (``Mesh.local``) and, on
    a spatial axis, its band of their rows; the identity without a mesh."""

    def cut(images: torch.Tensor) -> torch.Tensor:
        if mesh is None or not mesh.distributed:
            return images
        x = mesh.local(images)
        return band_of(x, mesh.spatial_axis) if mesh.spatial > 1 else x

    return cut


def make_spatial_eval_step(forward_eval, mesh: Mesh, crop: int = 224):
    """JAX's ``make_spatial_eval_step``: ``step(model, images_u8) ->
    outputs`` of a global uint8 batch (B, H, W, 3). Each rank takes its
    data rows, ``eval_preprocess``es them on its device, cuts its band of
    rows and runs ``forward_eval(model, band)`` under ``core.mesh.bands``
    (the halos, the global pool a spatial sum); the outputs, whole on each
    rank of a spatial group, are gathered over the data axis: every rank
    returns the (B, ...) outputs in the batch's order, without a
    gradient."""
    from ..data.augment import eval_preprocess

    cut = image_sharding(mesh)

    def step(model, images_u8: torch.Tensor) -> torch.Tensor:
        if mesh is not None:
            images_u8 = images_u8.to(mesh.device)
        with torch.no_grad(), bands(mesh):
            out = forward_eval(model, cut(eval_preprocess(images_u8, crop)))
        return out if mesh is None else mesh.gather_rows(out)

    return step
