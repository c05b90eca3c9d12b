"""Sharded checkpoints in the JAX package's on-disk format
(``checkpoint/sharded_io.py`` of the JAX package): each rank writes only
the blocks it owns, and a checkpoint loads on another rank count.

The plain npz path (``io.py``) needs every leaf whole on one rank, which
under ZeRO-1 and FSDP (``parallel/sharding.py``) means gathering the
state first. Here:

- ``save_sharded_pytree(tree, directory)`` is collective: every rank of
  the process group calls it with the same tree (one process, no group,
  is one rank). A leaf is a whole tensor or array (replicated, or host
  side), which global rank 0 writes, or a ``Shard``: this rank's block of
  the leaf, its global shape, the block's start and whether this rank
  owns it. Exactly one rank owns each block (the counterpart of JAX's
  ``replica_id == 0``): the one whose indices are 0 on every mesh axis
  the leaf is not split over. Each rank writes ``shards_pNNNNN.npz``
  (chunks ``c0``, ``c1``, ... in the tree's order) and
  ``manifest_pNNNNN.json`` (``{"file", "leaves": {key: {"shape",
  "dtype", "chunks": [{"key", "start", "stop"}]}}}``; structure markers
  ``{"marker": true}``, from rank 0 only), where NNNNN is the global rank;
  after a barrier rank 0 commits ``MANIFEST.json`` (``{"format": 1,
  "process_count", "manifests"}``). JAX's order of steps: rank 0 removes
  an earlier ``MANIFEST.json``, barrier, write, barrier, commit, barrier;
  every file is written to a temporary name and renamed, so a torn save
  never loads. A rank that owns nothing still writes its (empty) files.
- ``load_sharded_pytree(directory, shardings=None, like=None)`` reads only
  the chunks that overlap the box each leaf's spec (``Split``) asks for;
  ``shardings=None`` gives every leaf whole (numpy arrays; bfloat16
  leaves as CPU tensors). The saved boxes need not match the asked ones:
  a checkpoint of N ranks loads on M.
- bfloat16: numpy has no such type. A bf16 leaf is written as JAX writes
  an ml_dtypes array (dtype name ``"bfloat16"``, a ``'<V2'`` npy header,
  2-byte payloads) and loads back as ``torch.bfloat16``, bit for bit.
- The barrier is the process group's store (a counter key a barrier),
  not a collective of the training groups, so the asynchronous writer's
  thread can wait at it while the main thread runs a step's collectives;
  it touches no CUDA stream. Every rank saves in the same order, each
  barrier keyed by the directory and this process's count of saves to
  it, as JAX's ids pair up.

The port's training state as such a tree (``state_tree``): ``{"variables":
..., "opt": {"count", "trace", "ema"?}}``, in the layout of the in-progress
files (``train/kfold._inprogress_tree``): the JAX package's names and HWIO
and (in, out) layouts (``checkpoint/convert.to_jax_tree``), each rank's
block of a split leaf (FSDP parameters, ZeRO-1 trace and EMA, the TP heads
and their state) a ``Shard`` whose block, start and global shape are
transposed alike: nothing is gathered. ``state_shardings`` gives the
specs of a freshly built state of any kind on any rank count, and
``load_state``/``restore_state`` put a checkpoint into it in place. The
optimiser state is the port's own tree (``train/optim.sgd_momentum``):
the port writes the same files as JAX, not optax's state structure.
"""
from __future__ import annotations

import itertools
import json
import os
import tempfile
import zipfile
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .io import _flatten, _unflatten

_MANIFEST = "MANIFEST.json"
BF16 = "bfloat16"
AXES = ("data", "model", "spatial")


class Split:
    """The box of a leaf that a rank holds or asks for. Each cut (dim,
    index, count) cuts the box left by the cuts before it along ``dim``
    into ``count`` equal blocks and keeps block ``index`` (a head's ZeRO-1
    state: its block over ``model``, then its shard of that over
    ``data``); no cut is the whole leaf."""

    def __init__(self, *cuts: Tuple[int, int, int]):
        self.cuts = tuple((int(d), int(i), int(n)) for d, i, n in cuts)

    def __repr__(self):
        return f"Split{self.cuts}"

    def box(self, shape: Sequence[int]) -> Tuple[List[int], List[int]]:
        """(start, stop) of the box in a leaf of the global ``shape``."""
        start, stop = [0] * len(shape), [int(s) for s in shape]
        for d, i, n in self.cuts:
            size = stop[d] - start[d]
            if size % n:
                raise ValueError(f"{self}: dimension {d} of {tuple(shape)} does not split "
                                 f"into {n} blocks")
            start[d] += i * (size // n)
            stop[d] = start[d] + size // n
        return start, stop

    def global_shape(self, block_shape: Sequence[int]) -> Tuple[int, ...]:
        """The leaf's shape, from the shape of one of its blocks."""
        shape = [int(s) for s in block_shape]
        for d, _, n in self.cuts:
            shape[d] *= n
        return tuple(shape)

    def permuted(self, perm: Optional[Sequence[int]]) -> "Split":
        """The same box of the leaf transposed by ``perm`` (its dimension j
        is dimension ``perm[j]`` here)."""
        if perm is None:
            return self
        return Split(*((list(perm).index(d), i, n) for d, i, n in self.cuts))


WHOLE = Split()


class Shard:
    """A rank's block of one leaf: ``data`` (a tensor or array), the
    leaf's global ``shape``, the block's ``start`` in each dimension, and
    ``owner``, whether this rank writes it."""

    __slots__ = ("data", "shape", "start", "owner")

    def __init__(self, data, shape: Sequence[int], start: Sequence[int], owner: bool):
        self.data = data
        self.shape = tuple(int(s) for s in shape)
        self.start = [int(s) for s in start]
        self.owner = bool(owner)

    @property
    def stop(self) -> List[int]:
        return [a + int(n) for a, n in zip(self.start, self.data.shape)]

    def snapshot(self) -> "Shard":
        """A host copy that owns its block (``checkpoint/async_io.py``): a
        later in-place step cannot race the write. A block this rank does
        not own is never written, so it is not copied."""
        data = self.data
        if self.owner:
            data = (data.detach().to("cpu", copy=True) if torch.is_tensor(data)
                    else np.array(data, copy=True))
        return Shard(data, self.shape, self.start, self.owner)


def _is_marker(key: str) -> bool:
    return key.endswith((".__none__", ".__empty_dict__", ".__empty_list__"))


def _dtype_name(x) -> str:
    if torch.is_tensor(x):
        return str(x.dtype).replace("torch.", "")
    return np.asarray(x).dtype.name


def _c_order(arr: np.ndarray) -> np.ndarray:
    # (np.ascontiguousarray would make a 0-d array 1-d)
    return arr if arr.flags.c_contiguous else np.ascontiguousarray(arr)


def _host_array(x) -> np.ndarray:
    """A leaf's values as a C-contiguous host array, a bfloat16 tensor's as
    its uint16 bit patterns."""
    if torch.is_tensor(x):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            return _c_order(t.view(torch.int16).numpy().view(np.uint16))
        return _c_order(t.numpy())
    return _c_order(np.asarray(x))


def _write_npz(f, payload: Dict[str, Tuple[np.ndarray, str]]) -> None:
    """The file ``np.savez`` writes (a stored zip, one ``<key>.npy`` a
    chunk, zip64 forced), a bfloat16 chunk with the ``'<V2'`` header that
    ``np.savez`` of an ml_dtypes array writes."""
    with zipfile.ZipFile(f, mode="w", compression=zipfile.ZIP_STORED, allowZip64=True) as zf:
        for key, (arr, dtype) in payload.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                if dtype == BF16:
                    np.lib.format.write_array_header_1_0(
                        fid, {"descr": "<V2", "fortran_order": False, "shape": arr.shape})
                    fid.write(arr.tobytes())
                else:
                    np.lib.format.write_array(fid, arr, allow_pickle=False)


def _atomic_write(directory: str, name: str, write_fn) -> None:
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            write_fn(f)
        os.replace(tmp, os.path.join(directory, name))
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _world() -> Tuple[int, int]:
    """(this process's index, the process count): its global rank and the
    world size of the process group; (0, 1) without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


_save_counts: Dict[str, Iterator[int]] = {}


def _barrier(tag: str, count: int) -> None:
    """Every rank waits until all ``count`` have reached ``tag``: one
    counter key in the process group's store, the last rank in sets its
    done key; each wait bounded by the collective timeout. Not a
    collective, so it is safe on a writer's thread beside the training
    collectives."""
    if count <= 1:
        return
    from torch.distributed import distributed_c10d

    from ..core.mesh import collective_timeout

    store = distributed_c10d._get_default_store()
    key = f"hst_sharded:{tag}"
    if store.add(key, 1) == count:
        store.set(key + ":done", "1")
    store.wait([key + ":done"], collective_timeout())


def save_sharded_pytree(tree: Any, directory: str) -> None:
    """Collective sharded save (module docstring): every rank calls it
    with the same tree."""
    pi, pc = _world()
    os.makedirs(directory, exist_ok=True)
    seq = next(_save_counts.setdefault(os.path.normpath(directory), itertools.count()))
    tag = f"{os.path.normpath(directory)}:{seq}"
    # an earlier MANIFEST must not make a half-overwritten save loadable
    if pi == 0 and os.path.exists(os.path.join(directory, _MANIFEST)):
        os.unlink(os.path.join(directory, _MANIFEST))
    _barrier(tag + ":clear", pc)

    payload: Dict[str, Tuple[np.ndarray, str]] = {}
    leaves: Dict[str, dict] = {}
    for key, leaf in _flatten(tree, coerce=lambda x: x).items():
        if _is_marker(key):
            if pi == 0:  # structure carries no data: the manifest only, once
                leaves[key] = {"marker": True}
            continue
        if isinstance(leaf, Shard):
            dtype, chunks = _dtype_name(leaf.data), []
            if leaf.owner:
                ck = f"c{len(payload)}"
                payload[ck] = (_host_array(leaf.data), dtype)
                chunks.append({"key": ck, "start": leaf.start, "stop": leaf.stop})
            if chunks or pi == 0:
                leaves[key] = {"shape": list(leaf.shape), "dtype": dtype, "chunks": chunks}
        elif pi == 0:  # a whole leaf: global rank 0 owns it
            arr, dtype = _host_array(leaf), _dtype_name(leaf)
            ck = f"c{len(payload)}"
            payload[ck] = (arr, dtype)
            leaves[key] = {"shape": list(arr.shape), "dtype": dtype,
                           "chunks": [{"key": ck, "start": [0] * arr.ndim,
                                       "stop": list(arr.shape)}]}

    shard_file = f"shards_p{pi:05d}.npz"
    _atomic_write(directory, shard_file, lambda f: _write_npz(f, payload))
    _atomic_write(directory, f"manifest_p{pi:05d}.json",
                  lambda f: f.write(json.dumps({"file": shard_file, "leaves": leaves}).encode()))
    _barrier(tag + ":written", pc)
    if pi == 0:
        manifest = {"format": 1, "process_count": pc,
                    "manifests": [f"manifest_p{i:05d}.json" for i in range(pc)]}
        _atomic_write(directory, _MANIFEST,
                      lambda f: f.write(json.dumps(manifest, indent=2).encode()))
    _barrier(tag + ":committed", pc)


class _Chunk:
    __slots__ = ("npz", "key", "start", "stop")

    def __init__(self, npz, key, start, stop):
        self.npz, self.key = npz, key
        self.start, self.stop = start, stop


def _read_slice(meta: dict, chunks: List[_Chunk], starts: List[int], stops: List[int]
                ) -> np.ndarray:
    """The box [starts, stops) of a leaf from its saved chunks, reading
    only those that overlap it (a bfloat16 leaf as uint16 bits)."""
    bf16 = meta["dtype"] == BF16
    dtype = np.dtype(np.uint16) if bf16 else np.dtype(meta["dtype"])

    def fetch(c):
        arr = c.npz[c.key]
        return arr.view(np.uint16) if bf16 else arr

    for c in chunks:  # one chunk is the box itself
        if c.start == starts and c.stop == stops:
            return fetch(c)

    out_shape = [b - a for a, b in zip(starts, stops)]
    out = np.empty(out_shape, dtype)
    filled = 0
    for c in chunks:
        lo = [max(a, ca) for a, ca in zip(starts, c.start)]
        hi = [min(b, cb) for b, cb in zip(stops, c.stop)]
        if any(a >= b for a, b in zip(lo, hi)):
            continue
        src = fetch(c)[tuple(slice(a - ca, b - ca) for a, b, ca in zip(lo, hi, c.start))]
        out[tuple(slice(a - ra, b - ra) for a, b, ra in zip(lo, hi, starts))] = src
        filled += src.size
    want = int(np.prod(out_shape)) if out_shape else 1
    if filled != want:
        raise ValueError(f"sharded checkpoint is missing data for the box {starts}-{stops} "
                         f"(covered {filled}/{want} elements): saved under a different "
                         "replica layout or corrupted")
    return out


def _leaf(arr: np.ndarray, dtype: str):
    """A read box as the leaf it was: numpy, or a bfloat16 CPU tensor."""
    if dtype == BF16:
        return torch.from_numpy(_c_order(arr).view(np.int16)).view(torch.bfloat16)
    return arr


def _tree_leaves(tree) -> list:
    """The leaves in JAX's order: dict keys sorted, None no leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tree_leaves(v)]
    return [] if tree is None else [tree]


def _rehang(like, leaves: Iterator):
    """``like``'s containers around ``leaves``, taken in ``_tree_leaves``
    order."""
    if isinstance(like, dict):
        built = {k: _rehang(like[k], leaves) for k in sorted(like)}
        return {k: built[k] for k in like}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rehang(v, leaves) for v in like))
    if isinstance(like, (list, tuple)):
        return type(like)(_rehang(v, leaves) for v in like)
    return None if like is None else next(leaves)


def load_sharded_pytree(directory: str, shardings: Optional[Any] = None,
                        like: Optional[Any] = None) -> Any:
    """Load a ``save_sharded_pytree`` checkpoint (of either package).

    ``shardings``: one ``Split`` for every leaf, or a tree of them
    mirroring the saved tree (a saved key without one raises KeyError), or
    None for every leaf whole (JAX's ``as_jax=False``). Each leaf comes
    back as its box: a numpy array, a bfloat16 leaf a CPU tensor. ``like``:
    a template whose containers the leaves are re-hung on, in JAX's leaf
    order (tuples and named tuples are lists in the file). A directory
    without ``MANIFEST.json`` (no save, or a torn one) raises
    FileNotFoundError."""
    with open(os.path.join(directory, _MANIFEST)) as f:
        top = json.load(f)
    metas: Dict[str, dict] = {}
    chunk_map: Dict[str, List[_Chunk]] = {}
    files = []
    try:
        for mname in top["manifests"]:
            with open(os.path.join(directory, mname)) as f:
                m = json.load(f)
            npz = np.load(os.path.join(directory, m["file"]))
            files.append(npz)
            for key, meta in m["leaves"].items():
                if meta.get("marker"):
                    metas.setdefault(key, {"marker": True})
                    continue
                metas.setdefault(key, {"shape": meta["shape"], "dtype": meta["dtype"]})
                chunk_map.setdefault(key, []).extend(
                    _Chunk(npz, c["key"], c["start"], c["stop"]) for c in meta["chunks"])

        specs: Dict[str, Any] = {}
        if isinstance(shardings, Split):
            specs = {k: shardings for k in metas}
        elif shardings is not None:
            specs = _flatten(shardings, coerce=lambda x: x)
        flat: Dict[str, Any] = {}
        for key, meta in metas.items():
            if meta.get("marker"):
                flat[key] = np.zeros(0)
                continue
            spec = WHOLE if shardings is None else specs.get(key)
            if not isinstance(spec, Split):
                raise KeyError(f"shardings tree has no leaf for saved key {key!r}")
            starts, stops = spec.box(meta["shape"])
            flat[key] = _leaf(_read_slice(meta, chunk_map.get(key, []), starts, stops),
                              meta["dtype"])
    finally:
        for npz in files:
            npz.close()
    tree = _unflatten(flat)
    if like is not None:
        tree = _rehang(like, iter(_tree_leaves(tree)))
    return tree


def make_async_sharded_writer(max_pending: int = 2):
    """Asynchronous sharded checkpoints: an ``AsyncCheckpointWriter``
    whose worker runs ``save_sharded_pytree``. ``submit(tree, directory)``
    copies each ``Shard``'s block this rank owns (and every whole leaf) to
    the host and keeps its box, so a later in-place step is safe at once;
    the write and the commit run on the writer's thread. Every rank drives
    its writer with the same submissions (the barriers are the store's,
    not collectives, so they cannot deadlock against the main thread's
    training collectives). A resave into the same directory un-commits it
    first, so alternate two directories for rolling checkpoints."""
    from .async_io import AsyncCheckpointWriter

    return AsyncCheckpointWriter(max_pending, save_fn=save_sharded_pytree)


# ------------------------------------------------------------ training state


def _axis_index(mesh, axis: str) -> int:
    if mesh is None or not mesh.distributed:
        return 0
    sub = {"data": mesh.data_axis, "model": mesh.model_axis, "spatial": mesh.spatial_axis}[axis]
    return 0 if sub is None else sub.rank


def _cuts(model: torch.nn.Module, opt_state: dict):
    """({variable key: cuts}, {state key: cuts}), each cut (axis name,
    dim, the axis's mesh) in the port's layout: a TP head's block over
    ``model`` (dim 0), then an FSDP parameter's or a ZeRO-1 leaf's shard
    over ``data`` (its ``Zero1Layout`` dimension)."""
    from ..parallel.tensor_parallel import split_leaves

    heads = split_leaves(model)
    layout = opt_state.get("zero1")
    dims = layout.dims if layout is not None else {}
    variables, state = {}, {}
    for key in model.state_dict():
        cuts = [("model", 0, heads[key])] if key in heads else []
        if opt_state.get("fsdp") and dims.get(key) is not None:
            cuts.append(("data", dims[key], layout.mesh))
        variables[key] = cuts
    split_state = set(opt_state.get("model_split", ()))
    for key in opt_state["trace"]:
        cuts = [("model", 0, heads[key])] if key in split_state else []
        if dims.get(key) is not None:
            cuts.append(("data", dims[key], layout.mesh))
        state[key] = cuts
    return variables, state


def _split(cuts) -> Split:
    return Split(*((dim, axis.rank, axis.world_size) for _, dim, axis in cuts))


def _state_layout_tree(model, opt_state, leaf_fn) -> dict:
    """``{"variables", "opt": {"count", "trace", "ema"?}}`` with each
    tensor leaf ``leaf_fn(cuts, tensor, perm)``."""
    from .convert import to_jax_tree

    var_cuts, state_cuts = _cuts(model, opt_state)
    tree = {"variables": to_jax_tree(model, None,
                                     lambda k, t, p: leaf_fn(var_cuts[k], t, p))}
    opt = {"count": np.int64(opt_state["count"])}
    for part in ("trace", "ema"):
        if part in opt_state:
            opt[part] = to_jax_tree(model, opt_state[part],
                                    lambda k, t, p: leaf_fn(state_cuts[k], t, p))
    tree["opt"] = opt
    return tree


def state_tree(model: torch.nn.Module, opt_state: dict, mesh=None) -> dict:
    """This rank's part of the training state as ``save_sharded_pytree``'s
    tree: ``{"variables": ..., "opt": {"count", "trace", "ema"?}}`` in the
    JAX package's names and layouts, each split leaf a ``Shard`` of this
    rank's block (transposed views, no copy and no gather), each other
    leaf its (transposed) tensor. ``opt_state`` is ``sgd_momentum``'s
    under any of ``parallel/sharding.py``'s factories; ``mesh`` (the
    ``core.mesh.Mesh`` they were built on; None on one device) gives the
    owner of each block."""
    coords = {a: _axis_index(mesh, a) for a in AXES}
    if mesh is None and (opt_state.get("zero1") is not None or opt_state.get("model_split")):
        raise ValueError("a sharded state's checkpoint needs its mesh")

    def leaf(cuts, t, perm):
        t = t.detach()
        if not cuts:
            return t if perm is None else t.permute(perm)
        split = _split(cuts)
        shape = split.global_shape(t.shape)
        start, _ = split.box(shape)
        owner = all(coords[a] == 0 for a in AXES if a not in {c[0] for c in cuts})
        if perm is not None:
            t, shape, start = t.permute(perm), [shape[p] for p in perm], [start[p] for p in perm]
        return Shard(t, shape, start, owner)

    return _state_layout_tree(model, opt_state, leaf)


def state_shardings(model: torch.nn.Module, opt_state: dict) -> dict:
    """The ``Split`` of every leaf of ``state_tree``'s tree that this rank
    holds in ``model`` and ``opt_state`` (any factory's, any rank count):
    the specs with which ``load_sharded_pytree`` reads its blocks."""
    tree = _state_layout_tree(model, opt_state, lambda cuts, t, p: _split(cuts).permuted(p))
    tree["opt"]["count"] = WHOLE
    return tree


def restore_state(model: torch.nn.Module, opt_state: dict, tree: dict) -> None:
    """Copy a loaded state tree (``load_sharded_pytree`` with
    ``state_shardings(model, opt_state)``, or whole on one device) into
    ``model`` and ``opt_state`` in place, each block transposed back to the
    port's layout. A missing leaf raises KeyError, a block of another
    shape ValueError."""
    from .convert import jax_path, norm_modules

    norms = norm_modules(model)

    def put(tensors: Dict[str, torch.Tensor], sub) -> None:
        flat = _flatten(sub, coerce=lambda x: x)
        for key, t in tensors.items():
            path, perm = jax_path(key, t.dim(), norms)
            block = flat["/".join(path)]
            src = block if torch.is_tensor(block) else torch.from_numpy(np.asarray(block))
            if perm is not None:
                src = src.permute([list(perm).index(j) for j in range(len(perm))])
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError(f"sharded checkpoint: {key} has a block of shape "
                                 f"{tuple(src.shape)}, the state holds {tuple(t.shape)}")
            t.copy_(src)

    with torch.no_grad():
        put(model.state_dict(), tree["variables"])
        for part in ("trace", "ema"):
            if part in opt_state:
                put(opt_state[part], tree["opt"][part])
    opt_state["count"] = int(np.asarray(tree["opt"]["count"]))


def load_state(directory: str, model: torch.nn.Module, opt_state: dict) -> None:
    """``restore_state`` of the checkpoint in ``directory``, each rank
    reading only the chunks its blocks overlap."""
    restore_state(model, opt_state,
                  load_sharded_pytree(directory, shardings=state_shardings(model, opt_state)))
