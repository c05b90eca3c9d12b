"""Rank bodies of ``tests/test_torch_model_axis.py``: the port's model axis
(``parallel/sharding.py``'s meshes and train-step factories,
``parallel/tensor_parallel.py``) on the CPU, run by four spawned gloo
ranks on several meshes of the one group, and, with no mesh, by the test
process as the one-device reference. This module imports no jax.

Meshes (every rank builds all of them, in this order):

- ``2x2``: ``make_mesh_2d(4)``, (data 2, model 2);
- ``3d``: ``make_mesh_3d(4)``, (data 1, model 2, spatial 2);
- ``d4``: ``create_mesh(4)``, a data mesh of 4 (FSDP);
- ``1x1x4``: ``create_mesh(4, spatial=4)``, whose bands of family 1's
  maps at a 12 px crop are one row thin or empty.

A case (``CASES``) runs ``STEPS`` train steps of one family from the
inputs' JAX-layout tree through one factory, each rank on its data rows
of the same global batches, and returns the global losses, the whole
state dict (heads gathered over the model axis, FSDP parameters gathered
over the data axis; in f32 cases also as a JAX-layout tree), this
rank's own state dict, and, under FSDP, the
bytes of the split parameters this rank stores. ``bn_bands`` runs the
train-mode batch norm alone on a band of odd heights.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from heuristique_style_transfer_code_tpu_torch.checkpoint.convert import (
    load_jax_tree,
    to_jax_tree,
)
from heuristique_style_transfer_code_tpu_torch.checkpoint.io import (
    load_pytree_npz,
    save_pytree_npz,
)
from heuristique_style_transfer_code_tpu_torch.core.mesh import activate, bands, create_mesh
from heuristique_style_transfer_code_tpu_torch.data.augment import make_augment_fn
from heuristique_style_transfer_code_tpu_torch.parallel import sharding
from heuristique_style_transfer_code_tpu_torch.parallel.tensor_parallel import gather_heads
from heuristique_style_transfer_code_tpu_torch.train.optim import full_params, sgd_momentum
from heuristique_style_transfer_code_tpu_torch.train.train_loop import make_train_step_body

WORLD = 4
B, STAGE, CROP, THIN_CROP, LR, STEPS = 8, 96, 64, 12, 0.01, 2
F1_TRUNCATE, F1_DIM = 5, 16
F2_TRUNCATE, F2_S = 5, 4
F3_PATCHES = {"small": 8, "medium": 6, "large": 6}
MESHES = ("2x2", "3d", "d4", "1x1x4")
# name: (family, mesh, factory, dtype, crop)
CASES = {
    "f1_2x2": ("f1", "2x2", "sharded", "float64", CROP),
    "f1_2x2_zero1": ("f1", "2x2", "zero1", "float64", CROP),
    "f1_3d": ("f1", "3d", "sharded", "float64", CROP),
    "f1_3d_zero1": ("f1", "3d", "zero1", "float64", CROP),
    "f1_fsdp": ("f1", "d4", "fsdp", "float64", CROP),
    "f1_thin": ("f1", "1x1x4", "sharded", "float64", THIN_CROP),
    "f2_2x2": ("f2", "2x2", "sharded", "float64", CROP),
    "f2_3d": ("f2", "3d", "sharded", "float64", CROP),
    "f3_2x2": ("f3", "2x2", "sharded", "float64", CROP),
    "f3_3d": ("f3", "3d", "sharded", "float64", CROP),
    "f1_2x2_f32": ("f1", "2x2", "sharded", "float32", CROP),
    "f1_fsdp_f32": ("f1", "d4", "fsdp", "float32", CROP),
}
# the banded batch norm alone: (mesh, height) of a (2, H, 5, 3) float64 input
BN_CASES = (("1x1x4", 7), ("1x1x4", 3), ("3d", 5))


def make_meshes(world: int) -> dict:
    return {"2x2": sharding.make_mesh_2d(world), "3d": sharding.make_mesh_3d(world),
            "d4": create_mesh(world), "1x1x4": create_mesh(world, spatial=world)}


def port_model(family: str, tree, dtype: torch.dtype) -> torch.nn.Module:
    """The port's train-mode model of ``family`` from a JAX-layout tree."""
    if family == "f1":
        from heuristique_style_transfer_code_tpu_torch.models.truncated_resnet50 import (
            truncated_resnet50_init,
        )

        model = truncated_resnet50_init(None, F1_TRUNCATE, 4, F1_DIM, device="cpu")
    elif family == "f2":
        from heuristique_style_transfer_code_tpu_torch.models.gram_attention import (
            gram_attention_init,
        )

        model = gram_attention_init(None, F2_TRUNCATE, 4, F2_S, device="cpu")
    else:
        from heuristique_style_transfer_code_tpu_torch.models.multi_patchgan import (
            multiscale_init,
        )

        model = multiscale_init(None, F3_PATCHES, ndf=8, num_classes=4, norm="batch",
                                device="cpu")
    return load_jax_tree(model, tree).to(dtype).train()


def port_forward(family: str):
    if family == "f1":
        from heuristique_style_transfer_code_tpu_torch.models.truncated_resnet50 import (
            combined_apply,
        )

        return lambda m, x: combined_apply(m.moco, m.classifier, x, F1_TRUNCATE, train=True)
    if family == "f2":
        from heuristique_style_transfer_code_tpu_torch.models.gram_attention import (
            gram_attention_apply,
        )

        def forward(m, x):
            m.train()
            return gram_attention_apply(m, x, F2_TRUNCATE, F2_S, 4)[1]

        return forward
    from heuristique_style_transfer_code_tpu_torch.models.multi_patchgan import multiscale_apply

    return lambda m, x: multiscale_apply(m, x, "batch", train=True)


def _augment(crop: int, dtype: torch.dtype):
    aug = make_augment_fn([(None, None)], crop=crop)
    return lambda u8, combos, draws: aug(u8, combos, draws).to(dtype)


def _np(tensors: dict) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in tensors.items()}


def run_case(meshes, inputs, name: str) -> dict:
    """The case ``name`` on its mesh (one device without ``meshes``)."""
    family, mesh_name, factory, dtype, crop = CASES[name]
    dt = getattr(torch, dtype)
    mesh = meshes[mesh_name] if meshes is not None else None
    model = port_model(family, inputs[family], dt)
    opt = sgd_momentum(LR, mesh=mesh)
    fwd, aug = port_forward(family), _augment(crop, dt)
    if mesh is None:
        state = opt[0](model)
        step = make_train_step_body(fwd, opt, aug)
    elif factory == "sharded":
        step, _ = sharding.make_sharded_train_step(fwd, opt, aug, mesh, model)
        state = opt[0](model)
    elif factory == "zero1":
        state = opt[0](model)
        step, _ = sharding.make_zero1_train_step(fwd, opt, aug, mesh, model, state)
    else:
        state = opt[0](model)
        step, _, _ = sharding.make_fsdp_train_step(fwd, opt, aug, mesh, model, state)
    out = {}
    if factory == "fsdp" and mesh is not None:
        layout = state["zero1"]
        params = dict(model.named_parameters())
        out["stored_split_bytes"] = np.int64(sum(params[n].numel() * params[n].element_size()
                                                 for n in layout.sharded))
        out["whole_split_bytes"] = np.int64(sum(int(np.prod(layout.shapes[n])) *
                                                params[n].element_size()
                                                for n in layout.sharded))
        out["split"] = np.asarray(sorted(layout.sharded))
    losses = []
    for i in range(STEPS):
        u8, lab = inputs["images"][i], inputs["labels"][i]
        if mesh is not None:
            u8, lab = mesh.local(u8), mesh.local(lab)
        model, state, loss = step(model, state, u8, lab)
        losses.append(float(loss))
    out["loss"] = np.asarray(losses, np.float64)
    out["local"] = _np(model.state_dict())
    whole = full_params(model, state) if mesh is not None else model
    tensors = gather_heads(whole) if mesh is not None else whole.state_dict()
    out["params"] = _np(tensors)
    if dtype == "float32":
        out["jax"] = to_jax_tree(whole, tensors)
    return out


def bn_case(meshes, mesh_name: str, h: int) -> dict:
    """The train-mode batch norm of a seeded (2, h, 5, 3) float64 input
    under ``bands`` (its band of rows on each rank) or whole (no
    ``meshes``): the output, the gradient of sum(y * w) (w seeded) with
    respect to x, scale and bias (the latter two summed over the plane),
    and the running buffers after the update."""
    from heuristique_style_transfer_code_tpu_torch.ops.norm import batch_norm
    from heuristique_style_transfer_code_tpu_torch.parallel.spatial import band_of, gather_canvas

    g = torch.Generator().manual_seed(h)
    x = torch.randn((2, h, 5, 3), generator=g, dtype=torch.float64) * 2 + 1
    w = torch.randn((2, h, 5, 3), generator=g, dtype=torch.float64)
    scale = (torch.rand(3, generator=g, dtype=torch.float64) + 0.5).requires_grad_(True)
    bias = torch.randn(3, generator=g, dtype=torch.float64).requires_grad_(True)
    mean, var = torch.zeros(3, dtype=torch.float64), torch.ones(3, dtype=torch.float64)
    mesh = meshes[mesh_name] if meshes is not None else None
    axis = mesh.spatial_axis if mesh is not None else None
    xb = (x if axis is None else band_of(x, axis)).requires_grad_(True)
    wb = w if axis is None else band_of(w, axis)
    with activate(mesh), bands(mesh):
        y = batch_norm(xb, scale, bias, mean, var, train=True)
        gx, gs, gb = torch.autograd.grad((y * wb).sum(), [xb, scale, bias])
    if mesh is not None:
        y, gx = gather_canvas(y.detach(), axis), gather_canvas(gx, axis)
        gs, gb = mesh.replica_axis.all_reduce([gs, gb])
    return _np({"out": y, "grad_x": gx, "grad_scale": gs, "grad_bias": gb, "mean": mean,
                "var": var})


def bn_key(mesh_name: str, h: int) -> str:
    return f"bn_{mesh_name}_h{h}"


def mesh_layout(meshes) -> dict:
    """Each mesh's axes at this rank: the member ranks of its data, model,
    spatial and replica axes (empty where it has none)."""
    out = {}
    for name, mesh in meshes.items():
        out[name] = {
            "shape": np.asarray([mesh.data_axis.world_size, mesh.model, mesh.spatial]),
            "data": np.asarray(mesh.data_axis.ranks),
            "model": np.asarray(mesh.model_axis.ranks if mesh.model_axis else [], np.int64),
            "spatial": np.asarray(mesh.spatial_axis.ranks if mesh.spatial_axis else [],
                                  np.int64),
            "replica": np.asarray(mesh.replica_axis.ranks)}
    return out


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
        results, seconds = {"layout": mesh_layout(meshes)}, {}
        for name in CASES:
            t0 = time.perf_counter()
            results[name] = run_case(meshes, inputs, name)
            seconds[name] = np.float64(time.perf_counter() - t0)
        for mesh_name, h in BN_CASES:
            results[bn_key(mesh_name, h)] = bn_case(meshes, mesh_name, h)
        results["seconds"] = seconds
        save_pytree_npz(results, os.path.join(out_dir, f"rank{rank}.npz"))
    finally:
        shutdown_distributed()
