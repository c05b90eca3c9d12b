"""Rank bodies of ``tests/test_torch_sharded_checkpoint.py``: the port's
sharded checkpoints (``checkpoint/sharded_io.py``) and the loader's
multi-host stride (``data/loader.HostLoader(process_index=,
process_count=)``, ``parallel/multihost.global_batch_dict``), run by four
spawned gloo ranks on the CPU. This module imports no jax.

Meshes (every rank builds both, in this order): ``d4``, a data mesh of 4
(``create_mesh(4)``), and ``2x2``, (data 2, model 2) (``make_mesh_2d(4)``).

- ``TinyNet``: JAX's test tree (``tests/test_sharded_checkpoint.py``: a
  conv kernel HWIO (3, 3, 16, 32), an ``fc`` head (64, 8) with its bias, a
  norm scale (16,)), plus a norm's running buffers and a (64, 64) ``proj``
  layer, whose OIHW/HWIO split dimensions tie. ``PLACEMENTS`` name the
  states a rank holds: plain data parallelism, FSDP and ZeRO-1 (with an
  EMA) on ``d4``, TP heads with ZeRO-1 on ``2x2``.
- ``roundtrip``: each placement's state (the inputs' weights and a seeded
  trace) saved by the four ranks under ``out_dir/<placement>``, loaded
  into a fresh state of the same placement: every rank's tensors bit-equal.
- ``jax8``: the JAX package's 8-device FSDP save of the same tree, loaded
  into the FSDP placement: bit-equal to placing the whole tree.
- ``bf16``: a bfloat16 (16, 4) leaf split over the four ranks.
- ``handoff``: family 2 (JAX's test sizes, float64) under FSDP on ``d4``:
  a step; an asynchronous save of the state (``make_async_sharded_writer``)
  submitted just before the next step, which runs at once; the reload
  bit-equal to the host copy taken before that step; the state after it
  saved synchronously.
- ``reverse``: the test process's one-device save of family 2 after a
  step, loaded into FSDP, ZeRO-1 and TP + ZeRO-1 placements: each rank's
  blocks bit-equal to placing the whole state.
- ``stride``: each data rank of ``2x2`` draws its stride of a tiny image
  folder, ``global_batch_dict`` and ``make_sharded_train_step`` on a linear
  model (the ``fc`` head split over ``model``): losses and weights, held by
  the test process to one device on the batches concatenated in data-rank
  order (JAX ``tests/test_multihost.py:166``).
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from heuristique_style_transfer_code_tpu_torch.checkpoint.convert import (
    from_jax_tree,
    load_jax_tree,
    to_jax_tree,
)
from heuristique_style_transfer_code_tpu_torch.checkpoint.io import (
    load_pytree_npz,
    save_pytree_npz,
)
from heuristique_style_transfer_code_tpu_torch.checkpoint.sharded_io import (
    Shard,
    load_sharded_pytree,
    load_state,
    make_async_sharded_writer,
    restore_state,
    save_sharded_pytree,
    state_tree,
)
from heuristique_style_transfer_code_tpu_torch.core.mesh import create_mesh
from heuristique_style_transfer_code_tpu_torch.ops.linear import Linear
from heuristique_style_transfer_code_tpu_torch.parallel import sharding
from heuristique_style_transfer_code_tpu_torch.train.optim import sgd_momentum
from heuristique_style_transfer_code_tpu_torch.train.train_loop import make_train_step_body
from tests import torch_model_axis_ranks as MA

WORLD = 4
LR, EMA = 0.05, 0.9
B, STAGE, CROP = MA.B, MA.STAGE, MA.CROP
STRIDE_BATCH, STRIDE_CROP, STRIDE_LR, STRIDE_SEED = 2, 32, 0.05, 5
# name: (mesh, factory); the round trip's ZeRO-1 state carries an EMA
PLACEMENTS = {"dp": ("d4", "dp"), "fsdp": ("d4", "fsdp"), "zero1": ("d4", "zero1"),
              "tp_zero1": ("2x2", "zero1")}
REVERSE = ("fsdp", "zero1", "tp_zero1")


class _Weight(torch.nn.Module):
    def __init__(self, *shape):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.zeros(shape))


class _Norm(torch.nn.Module):
    """A norm's scale (the JAX tree's ``scale``) and running buffers."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.ones(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))


class TinyNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = _Weight(32, 16, 3, 3)
        self.fc = Linear(64, 8)
        self.proj = Linear(64, 64)
        self.bn = _Norm(16)


class LinNet(torch.nn.Module):
    """JAX's two-process test model: flattened images through one dense
    layer (here the ``fc`` head, split over ``model`` on ``2x2``)."""

    def __init__(self, dim: int = STRIDE_CROP * STRIDE_CROP * 3):
        super().__init__()
        self.fc = Linear(dim, 2)


def lin_forward(m, x):
    return m.fc(x.reshape(x.shape[0], -1))


def make_meshes(world: int) -> dict:
    return {"d4": create_mesh(world), "2x2": sharding.make_mesh_2d(world)}


def _noop_forward(model, images):  # the placements' steps are never run
    raise AssertionError("not run")


def place(name: str, model, mesh, forward=_noop_forward, augment=None, trace=None,
          count: int = 0, ema: bool = False):
    """``model`` and a fresh ``sgd_momentum`` state (its trace ``trace``, a
    {name: whole tensor}, where given; with ``ema`` its EMA, the
    parameters) put into placement ``name`` on ``mesh`` by the factory, in
    place. Returns (the step, the state)."""
    factory = PLACEMENTS[name][1]
    opt = sgd_momentum(LR, mesh=mesh, ema_decay=EMA if ema else None)
    state = opt[0](model)
    with torch.no_grad():
        for n, t in (trace or {}).items():
            state["trace"][n].copy_(t)
    state["count"] = count
    if factory == "dp":
        step = make_train_step_body(forward, opt, augment, mesh=mesh)
    elif factory == "fsdp":
        step, _, _ = sharding.make_fsdp_train_step(forward, opt, augment, mesh, model, state)
    else:
        step, _ = sharding.make_zero1_train_step(forward, opt, augment, mesh, model, state)
    return step, state


def local_tensors(model, state) -> dict:
    """This rank's tensors: the state dict, the trace and the EMA."""
    out = {f"variables/{k}": v for k, v in model.state_dict().items()}
    for part in ("trace", "ema"):
        out.update({f"{part}/{k}": v for k, v in state.get(part, {}).items()})
    out["count"] = torch.tensor(state["count"])
    return {k: v.detach().clone() for k, v in out.items()}


def bit_equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]) for k in a)


def tiny(inputs, dtype=torch.float32):
    """TinyNet with the inputs' weights, and its trace {name: tensor}."""
    model = load_jax_tree(TinyNet(), inputs["tiny"]).to(dtype)
    trace = {k: v.to(dtype) for k, v in from_jax_tree(inputs["tiny_trace"]).items()}
    return model, trace


def run_roundtrips(meshes, inputs, out_dir) -> dict:
    """Each placement saved and loaded into a fresh one: bit-equal."""
    out = {}
    for name, (mesh_name, _) in PLACEMENTS.items():
        mesh, ema = meshes[mesh_name], name == "zero1"
        model, trace = tiny(inputs)
        _, state = place(name, model, mesh, trace=trace, count=3, ema=ema)
        want = local_tensors(model, state)
        d = os.path.join(out_dir, name)
        save_sharded_pytree(state_tree(model, state, mesh), d)
        fresh = TinyNet()
        _, fresh_state = place(name, fresh, mesh, ema=ema)
        load_state(d, fresh, fresh_state)
        out[name] = np.bool_(bit_equal(local_tensors(fresh, fresh_state), want))
    return out


def run_jax8(meshes, inputs, in_dir) -> np.bool_:
    """JAX's 8-device FSDP save loaded into the FSDP placement of 4 ranks."""
    model, trace = tiny(inputs)
    _, state = place("fsdp", model, meshes["d4"], trace=trace, count=3)
    fresh = TinyNet()
    _, fresh_state = place("fsdp", fresh, meshes["d4"])
    load_state(os.path.join(in_dir, "jax8"), fresh, fresh_state)
    return np.bool_(bit_equal(local_tensors(fresh, fresh_state), local_tensors(model, state)))


def run_bf16(mesh, inputs, out_dir) -> None:
    """A (16, 4) bfloat16 leaf, each rank's 4 rows a Shard it owns."""
    x = torch.from_numpy(inputs["bf16_bits"].view(np.int16)).view(torch.bfloat16)
    block = x[mesh.rank * 4:(mesh.rank + 1) * 4]
    save_sharded_pytree({"x": Shard(block, x.shape, (mesh.rank * 4, 0), True)},
                        os.path.join(out_dir, "bf16"))


def f2_setup(inputs, mesh=None, placement=None):
    """Family 2 at JAX's test sizes in float64 from the inputs' tree: (the
    model, the step, the state), one device without ``placement``."""
    model = MA.port_model("f2", inputs["f2"], torch.float64)
    fwd, aug = MA.port_forward("f2"), MA._augment(CROP, torch.float64)
    if placement is None:
        opt = sgd_momentum(LR)
        return model, make_train_step_body(fwd, opt, aug), opt[0](model)
    step, state = place(placement, model, mesh, fwd, aug)
    return model, step, state


def run_handoff(mesh, inputs, out_dir) -> dict:
    """FSDP family 2: step 1; submit the asynchronous save and run step 2
    at once; the reload against the copy kept before step 2; step 2's state
    saved synchronously."""
    model, step, state = f2_setup(inputs, mesh, "fsdp")
    images, labels = inputs["f2_images"], inputs["f2_labels"]
    losses = []
    model, state, loss = step(model, state, mesh.local(images[0]), mesh.local(labels[0]))
    losses.append(float(loss))
    kept = local_tensors(model, state)
    writer = make_async_sharded_writer()
    t0 = time.perf_counter()
    writer.submit(state_tree(model, state, mesh), os.path.join(out_dir, "mid"))
    submit_s = time.perf_counter() - t0
    model, state, loss = step(model, state, mesh.local(images[1]), mesh.local(labels[1]))
    losses.append(float(loss))
    writer.close()
    save_sharded_pytree(state_tree(model, state, mesh), os.path.join(out_dir, "fin"))
    fresh, _, fresh_state = f2_setup(inputs, mesh, "fsdp")
    load_state(os.path.join(out_dir, "mid"), fresh, fresh_state)
    return {"losses": np.asarray(losses), "submit_s": np.float64(submit_s),
            "reload_equal": np.bool_(bit_equal(local_tensors(fresh, fresh_state), kept))}


def run_reverse(meshes, inputs, in_dir) -> dict:
    """The one-device save loaded into each placement, against the whole
    state restored on one device and then placed."""
    whole = load_sharded_pytree(os.path.join(in_dir, "one"))
    out = {}
    for name in REVERSE:
        mesh = meshes[PLACEMENTS[name][0]]
        model, _, state = f2_setup(inputs, mesh, name)
        load_state(os.path.join(in_dir, "one"), model, state)
        want_model, _, want_state = f2_setup(inputs)
        restore_state(want_model, want_state, whole)
        _, placed = place(name, want_model, mesh, trace=want_state["trace"],
                          count=want_state["count"])
        out[name] = np.bool_(bit_equal(local_tensors(model, state),
                                       local_tensors(want_model, placed)))
    return out


def run_stride(mesh, inputs) -> dict:
    """JAX's two-process training case on the (data 2, model 2) mesh: each
    rank's loader stride by its data index, ``global_batch_dict``, the
    sharded step. Also a mismatched row count refused on every rank."""
    from heuristique_style_transfer_code_tpu_torch.data.augment import make_augment_fn
    from heuristique_style_transfer_code_tpu_torch.data.imagefolder import ImageFolderIndex
    from heuristique_style_transfer_code_tpu_torch.data.loader import HostLoader
    from heuristique_style_transfer_code_tpu_torch.parallel.multihost import (
        global_batch_dict,
        make_global_batch,
    )
    from heuristique_style_transfer_code_tpu_torch.parallel.tensor_parallel import gather_heads

    model = load_jax_tree(LinNet(), inputs["lin"])
    opt = sgd_momentum(STRIDE_LR, mesh=mesh)
    step, _ = sharding.make_sharded_train_step(lin_forward, opt,
                                               make_augment_fn([(None, None)], STRIDE_CROP),
                                               mesh, model)
    state = opt[0](model)
    loader = HostLoader(ImageFolderIndex(str(inputs["stride_root"])).samples, STRIDE_BATCH,
                        shuffle=True, seed=STRIDE_SEED, process_index=mesh.data_index,
                        process_count=mesh.data_axis.world_size, num_workers=2)
    losses, indices, sums = [], [], []
    for batch in loader:
        g = global_batch_dict(batch, sharding.image_sharding(mesh), sharding.batch_sharding(mesh))
        sums.append(mesh.data_axis.all_reduce([g["image"].to(torch.int64).sum()])[0].item())
        model, state, loss = step(model, state, g["image"], g["label"], g["combo"])
        losses.append(float(loss))
        indices.append(batch["indices"])
    try:
        make_global_batch(np.zeros((2 + mesh.data_index, 3)), mesh)
        refused = False
    except ValueError:
        refused = True
    return {"losses": np.asarray(losses), "indices": np.stack(indices),
            "image_sums": np.asarray(sums, np.int64), "refused": np.bool_(refused),
            "fc": to_jax_tree(model, gather_heads(model))["fc"]}


def rank_main(rank: int, world: int, init_method: str, in_dir: str, out_dir: str) -> None:
    """A spawned gloo rank: every case, its results (with each case's
    seconds) in ``out_dir/rank<r>.npz``."""
    from heuristique_style_transfer_code_tpu_torch.parallel.multihost import (
        initialize_distributed,
        shutdown_distributed,
    )

    torch.set_num_threads(1)
    initialize_distributed(rank, world, init_method, backend="gloo")
    try:
        meshes = make_meshes(world)
        inputs = load_pytree_npz(os.path.join(in_dir, "inputs.npz"))
        inputs["stride_root"] = os.path.join(in_dir, "stride")
        results, seconds = {}, {}
        cases = {"roundtrip": lambda: run_roundtrips(meshes, inputs, out_dir),
                 "jax8": lambda: run_jax8(meshes, inputs, in_dir),
                 "bf16": lambda: run_bf16(meshes["d4"], inputs, out_dir),
                 "handoff": lambda: run_handoff(meshes["d4"], inputs, out_dir),
                 "reverse": lambda: run_reverse(meshes, inputs, in_dir),
                 "stride": lambda: run_stride(meshes["2x2"], inputs)}
        for name, case in cases.items():
            t0 = time.perf_counter()
            got = case()
            if got is not None:
                results[name] = got
            seconds[name] = np.float64(time.perf_counter() - t0)
        results["seconds"] = seconds
        results["data_index"] = np.int64(meshes["2x2"].data_index)
        save_pytree_npz(results, os.path.join(out_dir, f"rank{rank}.npz"))
    finally:
        shutdown_distributed()
