"""``parallel/sharding.py`` of the JAX package: the meshes, the layouts of
the variables and of the optimiser state, and the sharded train steps.

Under jit the JAX package gets every collective from sharding
annotations: GSPMD turns the gradient all-reduce into a reduce-scatter
into each device's momentum shard and an all-gather of the updated
parameters, splits the heads' matmuls over ``model`` and inserts the conv
halo exchanges over ``spatial``. Here the schedule is written out over
the mesh's collectives (``core/mesh.py``; one process a device):

- plain data parallelism: one all-reduce (SUM) of every gradient, one flat
  buffer per dtype (``core.mesh.Mesh.all_reduce``, which ``train/optim.py``
  calls), over the (data, spatial) plane of the rank's model index
  (``Mesh.replica_axis``: the world on a 1-D mesh);
- ``Zero1Layout``: JAX's per-leaf policy (``_zero1_leaf_spec``): each
  trainable leaf is split over the data axis along its largest dimension
  that the rank count divides (and that is at least the rank count); a
  leaf with none stays replicated (biases, norm scales: KBs). The policy
  reads the port's tensor layout (OIHW kernels), so a kernel may be split
  along another axis than JAX's HWIO one: the same bytes a rank. One step
  sums the gradients over the spatial axis (where there is one),
  reduce-scatters the sharded leaves' gradients into each rank's shard
  (all of them in one flat buffer), all-reduces the replicated ones, and,
  after the update of each rank's shards, all-gathers the parameters.
  FSDP (``make_fsdp_train_step``, ``fsdp_variable_shardings``) keeps the
  parameters in the same layout: the step all-gathers them whole (one
  bucketed all-gather), and the update reduce-scatters the gradients into
  the shards, updates them and releases the whole tensors
  (``train/optim.py``);
- the (data, model) and (data, model, spatial) meshes (``make_mesh_2d``,
  ``make_mesh_3d``; JAX ``:32-40,86-98``) and ``variable_shardings``
  (``:57-76``): the dense heads split over ``model`` by rows of their
  (out, in) weights (JAX's columns), each a ``column_linear``
  (``parallel/tensor_parallel.py``); everything else replicated;
- spatial partitioning (``--shard_spatial``, JAX ``:100-143``): the
  (data, spatial) mesh (``make_mesh_spatial``), each rank's block of a
  batch of images (``image_sharding``: its data rows, and its band of
  their rows, JAX's ``P("data", "spatial")``) and the spatial eval step
  (``make_spatial_eval_step``). The bands of a layer's rows
  (``RowSharding``) and the banded ops are in ``parallel/spatial.py``.

The three train-step factories (``make_sharded_train_step``,
``make_zero1_train_step``, ``make_fsdp_train_step``; JAX ``:146-275``)
return the step and its layouts as JAX's do. A layout is ``{state-dict
key: split dimension or None}``; the factories place the model (and the
optimiser state) on the mesh in place, where the JAX caller
``device_put``s its trees. Their ``optimizer`` is
``train.optim.sgd_momentum(..., mesh=mesh)``, whose update reduces the
gradients (GSPMD inserts that reduction in JAX).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch

from ..core.mesh import Mesh, bands, create_mesh
from .spatial import RowSharding, band_of  # noqa: F401 (RowSharding: this module's API)

DATA_AXIS, MODEL_AXIS, SPATIAL_AXIS = "data", "model", "spatial"


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
    """The ZeRO-1 layout of the trainable leaves ``shapes`` over the data
    axis of ``mesh`` (``self.mesh``; JAX's ``zero1_state_shardings`` over
    ``DATA_AXIS``): which leaves are split and along which dimension, this
    rank's shards, and the collectives that move gradients into shards and
    shards back into whole tensors. On a spatial axis the gradients are
    summed over it first (``self.spatial``)."""

    def __init__(self, mesh: Mesh, shapes: Dict[str, Sequence[int]]):
        self.spatial = mesh.spatial_axis if mesh.spatial > 1 else None
        mesh = mesh.data_axis
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
        of the rest (after one all-reduce of all of them over the spatial
        axis, where there is one)."""
        mesh = self.mesh
        if self.spatial is not None:
            names = list(grads)
            grads = dict(zip(names, self.spatial.all_reduce([grads[n] for n in names])))
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


# ------------------------------------------------------------ meshes


def _axis_factor(n: int) -> int:
    """JAX's default size of a non-data axis: 2 on an even count, else 1."""
    return 2 if n % 2 == 0 and n >= 2 else 1


def mesh_shape_2d(n_devices: int, model_parallel: Optional[int] = None) -> Dict[str, int]:
    """``dict(make_mesh_2d(n, model_parallel).shape)`` of JAX: the model
    axis 2 on an even count by default, else 1."""
    n = int(n_devices)
    model = _axis_factor(n) if model_parallel is None else int(model_parallel)
    if model < 1 or n % model:
        raise ValueError(f"a model axis of {model} does not divide {n} devices")
    return {DATA_AXIS: n // model, MODEL_AXIS: model}


def mesh_shape_3d(n_devices: int) -> Dict[str, int]:
    """``dict(make_mesh_3d(n).shape)`` of JAX: spatial and then model each
    take a factor of 2 where the count allows it."""
    n = int(n_devices)
    spatial = _axis_factor(n)
    model = _axis_factor(n // spatial)
    return {DATA_AXIS: n // (spatial * model), MODEL_AXIS: model, SPATIAL_AXIS: spatial}


def _world(n_devices: Optional[int]) -> int:
    import torch.distributed as dist

    return n_devices or (dist.get_world_size() if dist.is_initialized() else 1)


def make_mesh_2d(n_devices: Optional[int] = None, model_parallel: Optional[int] = None,
                 devices: Optional[Sequence] = None) -> Mesh:
    """This rank of the (data, model) mesh of the process group's ranks
    (JAX ``make_mesh_2d``, ``mesh_shape_2d``): rank r = (r // M, r % M).
    ``n_devices`` must be the group's size; ``devices`` as
    ``create_mesh``'s."""
    shape = mesh_shape_2d(_world(n_devices), model_parallel)
    return create_mesh(n_devices, devices, model=shape[MODEL_AXIS])


def make_mesh_3d(n_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """This rank of the (data, model, spatial) mesh of the process group's
    ranks (JAX ``make_mesh_3d``, ``mesh_shape_3d``): rank r = (d M + m) S +
    s."""
    shape = mesh_shape_3d(_world(n_devices))
    return create_mesh(n_devices, devices, model=shape[MODEL_AXIS],
                       spatial=shape[SPATIAL_AXIS])


def make_mesh_spatial(n_devices: Optional[int] = None, spatial: Optional[int] = None,
                      devices: Optional[Sequence] = None) -> Mesh:
    """This rank of the (data, spatial) mesh of the process group's ranks
    (JAX ``make_mesh_spatial``): the batch over ``data``, each image's H
    rows over ``spatial`` (2 by default on an even count), rank r = (r // S,
    r % S). ``n_devices`` must be the group's size; ``devices`` as
    ``create_mesh``'s."""
    n = _world(n_devices)
    if spatial is None:
        spatial = _axis_factor(n)
    if n % spatial:
        raise ValueError(f"a spatial axis of {spatial} does not divide {n} devices")
    return create_mesh(n, devices, spatial=spatial)


# ------------------------------------------------------------ layouts


def variable_shardings(shapes: Dict[str, Sequence[int]], mesh: Union[Mesh, int]
                       ) -> Dict[str, Optional[int]]:
    """JAX's ``variable_shardings`` (``:57-76``) on the port's tree
    ({state-dict key: shape}) over a model axis of ``mesh.model`` ranks (or
    of ``mesh`` ranks, an int): the (out, in) weights of the ``fc``,
    ``classifier`` and ``feature_projection`` heads split along dim 0 where
    the model size divides it (JAX's columns of its (in, out) kernel), the
    ``fc`` and ``feature_projection`` biases likewise; the classifier's
    own bias (``classifier.bias``) and everything else replicated (None)."""
    model = mesh if isinstance(mesh, int) else mesh.model
    out: Dict[str, Optional[int]] = {}
    for name, shape in shapes.items():
        shape = tuple(shape)
        head = name.endswith(("fc.weight", "classifier.weight", "feature_projection.weight"))
        split_bias = name.endswith(("fc.bias", "feature_projection.bias"))
        if head and len(shape) == 2 and shape[0] % model == 0:
            out[name] = 0
        elif split_bias and len(shape) == 1 and shape[0] % model == 0:
            out[name] = 0
        else:
            out[name] = None
    return out


# JAX ``:211-216``: the parameters take the optimiser state's per-leaf
# policy, so the two layouts cannot drift apart
fsdp_variable_shardings = zero1_state_shardings


def batch_sharding(mesh: Optional[Mesh]) -> Callable:
    """JAX's ``batch_sharding`` (``P("data")``): ``cut(x)`` gives this
    rank's data rows of a global batch (labels, combination ids: arrays
    or tensors, rows first); the identity without a mesh. ``cut.mesh`` is
    ``mesh``."""

    def cut(x):
        if mesh is None or not mesh.distributed:
            return x
        return mesh.local(x)

    cut.mesh = mesh
    return cut


def image_sharding(mesh: Optional[Mesh]) -> Callable[[torch.Tensor], torch.Tensor]:
    """JAX's ``image_sharding``: ``cut(images)`` gives this rank's block of
    a global batch of NHWC images, its data rows (``Mesh.local``) and, on
    a spatial axis, its band of their rows; the identity without a mesh.
    On a 3-D mesh the ranks of a model group get the same block. (The
    train steps cut the band themselves, after the augmentation: they take
    each rank's whole rows.) ``cut.mesh`` is ``mesh``."""

    def cut(images: torch.Tensor) -> torch.Tensor:
        if mesh is None or not mesh.distributed:
            return images
        x = mesh.local(images)
        return band_of(x, mesh.spatial_axis) if mesh.spatial > 1 else x

    cut.mesh = mesh
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


# ------------------------------------------------------------ train steps


def _shapes(model: torch.nn.Module) -> Dict[str, Tuple[int, ...]]:
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def _step_body(forward_train, optimizer, augment_fn, mesh, label_smoothing, mix_fn):
    from ..train.train_loop import make_train_step_body

    if getattr(optimizer[1], "mesh", None) is not mesh:
        raise ValueError("a sharded step's optimiser reduces its gradients over the mesh: "
                         "build it with train.optim.sgd_momentum(..., mesh=mesh)")
    return make_train_step_body(forward_train, optimizer, augment_fn, label_smoothing, mix_fn,
                                mesh)


def make_sharded_train_step(forward_train, optimizer, augment_fn, mesh: Mesh,
                            model: torch.nn.Module, label_smoothing: float = 0.0,
                            mix_fn: Optional[Callable] = None):
    """JAX's ``make_sharded_train_step``: the train step
    (``train/train_loop.make_train_step_body``) over a 1-D, 2-D or 3-D mesh,
    each rank's arguments its data rows of the global batch
    (``batch_sharding``): the batch over ``data``, the heads over
    ``model`` and, on a spatial axis, each image's rows over ``spatial``
    (cut after the augmentation). ``model`` is placed in place
    (``tensor_parallel.shard_heads`` of ``variable_shardings``); make the
    optimiser state of the placed model (``optimizer[0](model)``), which
    mirrors its parameters, as JAX's does. Returns (step, the variables'
    layout)."""
    from .tensor_parallel import shard_heads

    v_shard = variable_shardings(_shapes(model), mesh)
    shard_heads(model, mesh, v_shard)
    return _step_body(forward_train, optimizer, augment_fn, mesh, label_smoothing,
                      mix_fn), v_shard


def make_zero1_train_step(forward_train, optimizer, augment_fn, mesh: Mesh,
                          model: torch.nn.Module, opt_state: dict,
                          label_smoothing: float = 0.0, mix_fn: Optional[Callable] = None):
    """JAX's ``make_zero1_train_step``: the same step with the optimiser
    state ``opt_state`` (``optimizer[0]`` of the whole model) split 1/D over
    the data axis (``train.optim.shard_state``), in place; on a mesh with a
    model axis the heads split over it first (``variable_shardings``, JAX
    ``:191-197``), their state with them. Returns (step, the state's
    layout: {trainable leaf: split dimension or None})."""
    from ..train.optim import shard_state
    from .tensor_parallel import shard_heads, shard_state_heads

    step = _step_body(forward_train, optimizer, augment_fn, mesh, label_smoothing, mix_fn)
    if mesh.model > 1:
        shard_heads(model, mesh, variable_shardings(_shapes(model), mesh))
        shard_state_heads(model, opt_state)
    shard_state(model, opt_state, mesh)
    return step, dict(opt_state["zero1"].dims)


def make_fsdp_train_step(forward_train, optimizer, augment_fn, mesh: Mesh,
                         model: torch.nn.Module, opt_state: dict,
                         label_smoothing: float = 0.0, mix_fn: Optional[Callable] = None):
    """JAX's ``make_fsdp_train_step`` (ZeRO-3): the trainable parameters
    and the optimiser state stored 1/D over the data axis
    (``fsdp_variable_shardings``), ``model`` and ``opt_state`` placed in
    place. A step all-gathers the split parameters (one bucketed
    all-gather), runs the forward and backward, reduce-scatters the
    gradients into the shards, updates them and releases the whole tensors
    (``train/optim.py``); ``train.optim.full_params`` gathers the model for
    evaluation and checkpoints. The batch norms' running buffers (KBs,
    updated by the forward alike on every rank) stay replicated, where JAX
    splits those the rank count divides. The whole parameters are gathered
    at once for the step, not a layer at a time as XLA does. Returns
    (step, the variables' layout, the state's layout)."""
    from ..train.optim import gather_params, shard_state

    if mesh.model > 1:
        raise ValueError("FSDP shards over the data axis: give it a mesh without a model axis")
    body = _step_body(forward_train, optimizer, augment_fn, mesh, label_smoothing, mix_fn)
    shard_state(model, opt_state, mesh, fsdp=True)

    def step(model, opt_state, images_u8, labels, combos=None, draws=None, mix_key=None):
        gather_params(model, opt_state)
        return body(model, opt_state, images_u8, labels, combos, draws, mix_key)

    dims = dict(opt_state["zero1"].dims)
    return step, {k: dims.get(k) for k in _shapes(model)}, dims
