"""Rank bodies of ``tests/test_torch_spatial.py``: the port's spatial
partitioning (``--shard_spatial``) on the CPU, run by four spawned gloo
ranks on two meshes of the same group, ``2x2`` (data 2 x spatial 2:
``create_mesh(spatial=2)``) and ``1x4`` (``create_mesh(spatial=4)``, whose
bands of a small map are thin or empty), and, with no mesh, by the test
process as the one-device reference. This module imports no jax.

Cases (each returns numpy arrays gathered in the one-device layout: the
bands put back together, then the data rows):

- ``ops/<name>_h<H>``: one banded op on (2, H, 9, 4) float64 inputs (odd H
  too), its output and the gradient of a fixed random weighting of it
  (replicated outputs: each rank's loss the weighting divided by the
  group's size, the convention of ``parallel/spatial.py``);
- the three loops in float64, threshold 0: family 2's texture loop
  (truncate 5 at 33 px; also under ``remat``, and in bf16 from f32
  pixels), the content+style loop (truncate 8, every stage's
  Gram, TV, at 32 px: layer4's map is one row) and family 3's loop under
  norm "instance" (33 px);
- ``jax_texture``, ``jax_content_style``: JAX's own spatial tests' loops
  (a 3x3 conv's Gram at 16 px, f32) on the JAX weights and inputs;
- ``eval_step``: ``make_spatial_eval_step`` of family 1 (truncate 5).
- The CLIs (``--shard_spatial``, each rank joining the ranks' group as
  under ``torchrun``): family 2's texture and content+style loops on 2x2,
  family 3's on 1x4 (its loader is b1, so its data axis is 1).
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from heuristique_style_transfer_code_tpu_torch.checkpoint.convert import load_jax_tree
from heuristique_style_transfer_code_tpu_torch.checkpoint.io import (
    load_pytree_npz,
    save_pytree_npz,
)
from heuristique_style_transfer_code_tpu_torch.core.mesh import bands, create_mesh, gather_valid

MESHES = {"2x2": 2, "1x4": 4}
OP_HEIGHTS = (13, 7, 3)
OP_NAMES = ("conv3x3", "conv7x7_s2", "conv4x4_s2", "conv4x4_s1", "conv1x1_s2", "conv1x1",
            "max_pool", "layer_norm", "instance_norm", "instance_norm_relu",
            "adaptive_pool", "global_pool", "gram", "pooled_gram", "total_variation")
REPLICATED = {"adaptive_pool", "global_pool", "gram", "pooled_gram", "total_variation"}
B, LR, ITERS = 2, 0.01, 3
F2_TRUNCATE, F2_S, F2_PX = 5, 4, 33
CS_PX = 32
F3_PATCHES = {"small": 8, "medium": 6, "large": 6}
F3_GDIM, F3_PX = 8, 33
EVAL_TRUNCATE, EVAL_PX, EVAL_CROP = 5, 72, 64


def op_fns():
    """Each banded op on NHWC float64 x, with seeded weights."""
    from heuristique_style_transfer_code_tpu_torch.ops import conv, gram, norm, pooling
    from heuristique_style_transfer_code_tpu_torch.tasks.style_transfer import total_variation

    g = torch.Generator().manual_seed(0)
    w = {k: torch.randn((5, 4, k, k), generator=g, dtype=torch.float64) for k in (1, 3, 4, 7)}
    b = torch.randn((5,), generator=g, dtype=torch.float64)
    return {
        "conv3x3": lambda x: conv.conv2d(x, w[3], 1, 1, b),
        "conv7x7_s2": lambda x: conv.conv2d(x, w[7], 2, 3),
        "conv4x4_s2": lambda x: conv.conv2d(x, w[4], 2, 1, b),
        "conv4x4_s1": lambda x: conv.conv2d(x, w[4], 1, 1, b),
        "conv1x1_s2": lambda x: conv.conv2d(x, w[1], 2, 0),
        "conv1x1": lambda x: conv.conv2d(x, w[1], 1, 0, b),
        "max_pool": lambda x: conv.max_pool2d(x, 3, 2, 1),
        "layer_norm": norm.layer_norm_tail,
        "instance_norm": norm.instance_norm,
        "instance_norm_relu": lambda x: norm.instance_norm(x, relu=True),
        "adaptive_pool": lambda x: pooling.adaptive_avg_pool2d(x, 4),
        "global_pool": pooling.global_avg_pool,
        "gram": gram.gram_matrix_nhwc,
        "pooled_gram": lambda x: gram.pooled_gram_nhwc(x, 3),
        "total_variation": total_variation,
    }


def op_input(h: int) -> torch.Tensor:
    return torch.randn((B, h, 9, 4), generator=torch.Generator().manual_seed(h),
                       dtype=torch.float64)


def run_op(mesh, name: str, h: int) -> dict:
    """The op's output and the gradient of sum(out * w), w seeded at the
    output's whole shape."""
    from heuristique_style_transfer_code_tpu_torch.parallel.spatial import band_of, gather_canvas

    x = op_input(h)
    axis = None if mesh is None else mesh.spatial_axis
    xb = (x if axis is None else band_of(x, axis)).requires_grad_(True)
    with bands(mesh):
        y = op_fns()[name](xb)
        whole = y.detach() if axis is None or name in REPLICATED else gather_canvas(y, axis)
        w = torch.randn(whole.shape, generator=torch.Generator().manual_seed(5),
                        dtype=whole.dtype)
        if axis is None:
            loss = (y * w).sum()
        elif name in REPLICATED:
            loss = (y * w).sum() / axis.world_size
        else:
            loss = (y * band_of(w, axis)).sum()
        (gx,) = torch.autograd.grad(loss, xb)
    grad = gx if axis is None else gather_canvas(gx, axis)
    return {"out": whole.numpy(), "grad": grad.detach().numpy()}


def f2_model(inp, truncate=F2_TRUNCATE):
    from heuristique_style_transfer_code_tpu_torch.models.gram_attention import (
        gram_attention_init,
    )

    return load_jax_tree(gram_attention_init(None, truncate, 4, F2_S, device="cpu"),
                         inp[f"f2_tree_{truncate}"]).to(torch.float64).eval()


def f3_model(inp):
    from heuristique_style_transfer_code_tpu_torch.models.multi_patchgan import (
        multiscale_test_init,
    )

    return load_jax_tree(multiscale_test_init(None, F3_PATCHES, ndf=8, num_classes=4,
                                              gram_matrix_dim=F3_GDIM, norm="instance",
                                              device="cpu"),
                         inp["f3_tree"]).to(torch.float64).eval()


def _cut(mesh, x):
    from heuristique_style_transfer_code_tpu_torch.parallel.sharding import image_sharding

    return image_sharding(mesh)(x)


def _loop_result(mesh, pixels, iters, per) -> dict:
    from heuristique_style_transfer_code_tpu_torch.parallel.spatial import gather_canvas

    if mesh is not None:
        pixels = gather_canvas(pixels, mesh.spatial_axis)
    pixels, per = gather_valid(mesh, [pixels, per])
    return {"iters": np.asarray(iters), "per": per, "pixels": pixels}


def _rows(mesh, x):
    return x if mesh is None else mesh.local(x)


def run_texture(mesh, inp, family: str, dtype=torch.float64, lr=LR, iters=ITERS,
                threshold=0.0, **options) -> dict:
    """A texture loop; ``options`` (``remat``, ``compute_dtype``) go to
    family 2's Gram program."""
    from heuristique_style_transfer_code_tpu_torch.tasks import style_transfer as pst

    if family == "f2":
        gram_fn = pst.make_gram_fn_gram_attention(f2_model(inp), F2_TRUNCATE, **options)
    elif family == "f3":
        gram_fn = pst.make_gram_fn_patches(f3_model(inp), F3_GDIM, norm="instance")
    else:  # JAX's test: one 3x3 conv's Gram
        gram_fn = jax_conv_fn(inp, with_feats=False)
    noise = torch.from_numpy(inp[f"{family}_noise"]).to(dtype)
    targets = torch.from_numpy(inp[f"{family}_targets"]).to(dtype)
    run = pst.make_style_transfer_optimizer(gram_fn, lr, iters, threshold, mesh=mesh)
    return _loop_result(mesh, *run(_cut(mesh, noise), [_rows(mesh, targets)]))


def jax_conv_fn(inp, with_feats: bool):
    """JAX's spatial tests' model: a 3x3 conv (HWIO kernel and bias from
    ``conv2d_init``) and the Gram of its map."""
    from heuristique_style_transfer_code_tpu_torch.ops.conv import conv2d, hwio_to_oihw
    from heuristique_style_transfer_code_tpu_torch.ops.gram import gram_matrix_nhwc

    weight = torch.from_numpy(hwio_to_oihw(inp["jax_kernel"]))
    bias = torch.from_numpy(inp["jax_bias"])

    def fn(imgs):
        feats = conv2d(imgs, weight.to(imgs.dtype), 1, 1, bias.to(imgs.dtype))
        return (feats, [gram_matrix_nhwc(feats)]) if with_feats else [gram_matrix_nhwc(feats)]

    return fn


def run_jax_content_style(mesh, inp) -> dict:
    """JAX's content+style spatial test: style weight 1, content 0.5, lr
    0.05, 40 iterations, threshold 1e-4, TV 0.1, f32."""
    from heuristique_style_transfer_code_tpu_torch.tasks import style_transfer as pst

    extract = jax_conv_fn(inp, with_feats=True)
    noise = torch.from_numpy(inp["jax_cs_noise"])
    run = pst.make_content_style_optimizer(extract, 1.0, 0.5, 0.05, 40, 1e-4, tv_weight=0.1,
                                           mesh=mesh)
    grams = [torch.from_numpy(inp["jax_cs_targets"])]
    feats = torch.from_numpy(inp["jax_cs_feats"])
    return _loop_result(mesh, *run(_cut(mesh, noise), [_rows(mesh, g) for g in grams],
                                   _cut(mesh, feats)))


def run_content_style(mesh, inp) -> dict:
    """Family 2's content+style loop at truncate 8, every stage's Gram and
    TV, from the content images; the content features taken from the
    bands."""
    from heuristique_style_transfer_code_tpu_torch.tasks import style_transfer as pst

    extract = pst.make_extract_fn_gram_attention(f2_model(inp, 8), 8, style_layers="all")
    content = _cut(mesh, torch.from_numpy(inp["cs_content"]))
    with torch.no_grad():
        grams = [g[0] for g in extract(torch.from_numpy(inp["cs_style"]))[1]]
        with bands(mesh):
            feats = extract(content)[0]
    run = pst.make_content_style_optimizer(extract, 1.0, 1.0, LR, ITERS, 0.0, tv_weight=0.1,
                                           mesh=mesh)
    return _loop_result(mesh, *run(content, [g.expand((content.shape[0],) + g.shape)
                                             for g in grams], feats))


def run_eval_step(mesh, inp) -> dict:
    from heuristique_style_transfer_code_tpu_torch.models.truncated_resnet50 import (
        combined_apply,
        truncated_resnet50_init,
    )
    from heuristique_style_transfer_code_tpu_torch.parallel.sharding import (
        make_spatial_eval_step,
    )

    model = load_jax_tree(truncated_resnet50_init(None, EVAL_TRUNCATE, 4, 16, device="cpu"),
                          inp["f1_tree"]).eval()
    step = make_spatial_eval_step(
        lambda m, x: combined_apply(m.moco, m.classifier, x, EVAL_TRUNCATE), mesh, EVAL_CROP)
    return {"logits": step(model, torch.from_numpy(inp["eval_u8"])).numpy()}


def _cli(module: str, mesh, inp, out: str, *argv) -> None:
    import importlib

    ckpt = {"test_gram_attention": "f2", "test_multi_patchgan": "f3"}[module]
    main = importlib.import_module(
        f"heuristique_style_transfer_code_tpu_torch.cli.{module}").main
    main(["--data", inp["_data"], "--config_path", os.path.join(inp["_in"], f"{ckpt}.json"),
          "--model_path", os.path.join(inp["_in"], f"{ckpt}.npz"), "--save_dir", out,
          "--device", "cpu", *argv])


CLI_CASES = {
    "cli_f2_texture": ("2x2", "test_gram_attention", "--mode", "style_transfer",
                       "--num_samples", "4", "--num_iterations", "2", "--layers", "5",
                       "--threshold", "0"),
    "cli_f2_content_style": ("2x2", "test_gram_attention", "--mode", "style_transfer",
                             "--style_image", "STYLE", "--style_layers", "all", "--tv_weight",
                             "0.1", "--num_samples", "4", "--num_iterations", "2",
                             "--threshold", "0"),
    "cli_f3": ("1x4", "test_multi_patchgan", "--mode", "style_transfer", "--num_samples", "2",
               "--num_iterations", "2", "--threshold", "0"),
}

LOOP_CASES = {
    "f2_texture": lambda mesh, inp: run_texture(mesh, inp, "f2"),
    "f2_texture_remat": lambda mesh, inp: run_texture(mesh, inp, "f2", remat=True),
    "f2_texture_bf16": lambda mesh, inp: run_texture(mesh, inp, "f2", torch.float32,
                                                     compute_dtype=torch.bfloat16),
    "content_style": run_content_style,
    "f3_texture": lambda mesh, inp: run_texture(mesh, inp, "f3"),
    "jax_texture": lambda mesh, inp: run_texture(mesh, inp, "jax", torch.float32, 0.05, 40, 1e-4),
    "jax_content_style": run_jax_content_style,
    "eval_step": run_eval_step,
}


def run_cases(mesh, inp, out_dir: str, mesh_name: str = "") -> dict:
    """Every op and loop case on ``mesh`` (None: one device); on a mesh, the
    CLI cases of ``mesh_name`` too (in ``out_dir/<case>``)."""
    results = {"ops": {op_key(name, h): run_op(mesh, name, h)
                       for name in OP_NAMES for h in OP_HEIGHTS}}
    for case, fn in LOOP_CASES.items():
        t0 = time.perf_counter()
        results[case] = fn(mesh, inp)
        results[case]["seconds"] = np.float64(time.perf_counter() - t0)
    for case, (on, module, *argv) in CLI_CASES.items():
        if mesh is None or on == mesh_name:
            argv = [a.replace("STYLE", inp["_style"]) for a in argv]
            if mesh is not None:
                argv += ["--shard_spatial", str(MESHES[on]), "--devices", "4"]
            t0 = time.perf_counter()
            _cli(module, mesh, inp, os.path.join(out_dir, case), *argv)
            results[case] = {"seconds": np.float64(time.perf_counter() - t0)}
    return results


def op_key(name: str, h: int) -> str:
    return f"{name}_h{h}"


def load_inputs(in_dir: str) -> dict:
    inputs = load_pytree_npz(os.path.join(in_dir, "inputs.npz"))
    with open(os.path.join(in_dir, "paths.json")) as f:
        inputs.update(json.load(f))
    return inputs


def rank_main(rank: int, world: int, init_method: str, in_dir: str, out_dir: str) -> None:
    """A spawned gloo rank: every case on both meshes, its results in
    ``out_dir/<mesh>/rank<r>.npz``."""
    from heuristique_style_transfer_code_tpu_torch.parallel.multihost import (
        INIT_METHOD_ENV,
        initialize_distributed,
        shutdown_distributed,
    )

    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank),
                       INIT_METHOD_ENV: init_method})
    torch.set_num_threads(1)
    initialize_distributed(rank, world, init_method, backend="gloo")
    try:
        inputs = load_inputs(in_dir)
        for name, spatial in MESHES.items():
            t0 = time.perf_counter()
            results = run_cases(create_mesh(spatial=spatial), inputs,
                                os.path.join(out_dir, name), name)
            results["seconds"] = np.float64(time.perf_counter() - t0)
            save_pytree_npz(results, os.path.join(out_dir, name, f"rank{rank}.npz"))
    finally:
        shutdown_distributed()
