"""Rank bodies of ``tests/test_torch_eval_devices.py``: the port's
data-parallel evaluation on the CPU, run by the spawned gloo ranks and,
with no mesh, by the test process as the one-device reference. This
module imports no jax (a spawned rank imports it, not the test module).

Two kinds of case:

- the three evaluation CLIs' ``main`` with ``--devices 2`` in a rank (it
  joins the ranks' process group, as under ``torchrun``) or ``--devices 1``
  in the test process, each writing its files under ``out/<case>``;
- the three style loops' optimisers in float64 at 32 px, on this rank's
  rows of a batch of 4 whose first two jobs (rank 0's) start near their
  target, below the case's threshold (which the test sets between the
  rows' first losses), so rank 0's rows stop at the first iteration while
  rank 1's run to the cap: the loops must end on the global
  ``any(active)``, or rank 0 reports its rows' losses before their last
  update and one iteration.

Each case returns numpy arrays (the loops: iterations, final per-image
losses and pixels, gathered in the one-device order).
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
from heuristique_style_transfer_code_tpu_torch.core.mesh import create_mesh, gather_valid

B, PX, LR, ITERS, NEAR = 4, 32, 0.01, 4, 0.01
F2_TRUNCATE, F2_S = 5, 4
F3_PATCHES = {"small": 8, "medium": 6, "large": 6}
F3_GDIM = 8


def _local(mesh, x):
    return x if mesh is None else mesh.local(x)


def _loop_result(mesh, pixels, iters, per) -> dict:
    pixels, per = gather_valid(mesh, [pixels, per])
    return {"iters": np.asarray(iters), "per": per, "pixels": pixels}


def f2_model(inp, dtype=torch.float64):
    from heuristique_style_transfer_code_tpu_torch.models.gram_attention import (
        gram_attention_init,
    )

    return load_jax_tree(gram_attention_init(None, F2_TRUNCATE, 4, F2_S, device="cpu"),
                         inp["f2_tree"]).to(dtype).eval()


def f3_model(inp, dtype=torch.float64):
    from heuristique_style_transfer_code_tpu_torch.models.multi_patchgan import (
        multiscale_test_init,
    )

    return load_jax_tree(multiscale_test_init(None, F3_PATCHES, ndf=8, num_classes=4,
                                              gram_matrix_dim=F3_GDIM, norm="instance",
                                              device="cpu"),
                         inp["f3_tree"]).to(dtype).eval()


def texture_targets(gram_fn, inp):
    """The texture loop's targets: rows 0-1 the Grams of their starting
    noise moved by ``NEAR`` (a small first loss), rows 2-3 those of the
    content images."""
    noise = torch.from_numpy(inp["noise"])
    with torch.no_grad():
        near = gram_fn(noise + NEAR * torch.from_numpy(inp["content"]))[0]
        content = gram_fn(torch.from_numpy(inp["content"]))[0]
    return torch.cat([near[:B // 2], content[B // 2:]])


def run_texture(mesh, inp, family, iters=ITERS, threshold=None):
    from heuristique_style_transfer_code_tpu_torch.tasks import style_transfer as pst

    if family == "f2":
        gram_fn = pst.make_gram_fn_gram_attention(f2_model(inp), F2_TRUNCATE)
    else:
        gram_fn = pst.make_gram_fn_patches(f3_model(inp), F3_GDIM, norm="instance")
    target = torch.from_numpy(inp[f"{family}_targets"])
    if threshold is None:
        threshold = float(inp[f"{family}_threshold"])
    run = pst.make_style_transfer_optimizer(gram_fn, LR, iters, threshold, mesh=mesh)
    pixels, iters, per = run(_local(mesh, torch.from_numpy(inp["noise"])),
                             [_local(mesh, target)])
    return _loop_result(mesh, pixels, iters, per)


def run_content_style(mesh, inp, iters=ITERS, threshold=None):
    """The content+style loop from the content images; rows 0-1 are the
    style image moved by ``NEAR``, so their first loss is small."""
    from heuristique_style_transfer_code_tpu_torch.tasks import style_transfer as pst

    extract = pst.make_extract_fn_gram_attention(f2_model(inp), F2_TRUNCATE, style_layers="all")
    content = torch.from_numpy(inp["cs_content"])
    with torch.no_grad():
        grams = [g[0] for g in extract(torch.from_numpy(inp["cs_style"]))[1]]
        feats = extract(_local(mesh, content))[0]
    local = _local(mesh, content)
    if threshold is None:
        threshold = float(inp["content_style_threshold"])
    run = pst.make_content_style_optimizer(extract, learning_rate=LR, num_iterations=iters,
                                           threshold=threshold, mesh=mesh)
    pixels, iters, per = run(local, [g.expand((local.shape[0],) + g.shape) for g in grams],
                             feats)
    return _loop_result(mesh, pixels, iters, per)


def _cli(module: str, mesh, inp, out: str, *argv) -> dict:
    import importlib

    ckpt = {"test_truncated_resnet50": "f1", "test_gram_attention": "f2",
            "test_multi_patchgan": "f3"}[module]
    main = importlib.import_module(
        f"heuristique_style_transfer_code_tpu_torch.cli.{module}").main
    main(["--data", inp["_data"], "--config_path", os.path.join(inp["_in"], f"{ckpt}.json"),
          "--model_path", os.path.join(inp["_in"], f"{ckpt}.npz"), "--save_dir", out,
          "--device", "cpu", "--devices", "1" if mesh is None else "2", *argv])
    return {}


CLI_CASES = {
    "f1_classification": ("test_truncated_resnet50", "--mode", "classification",
                          "--num_samples", "10", "--batch_size", "4", "--prob_threshold", "0",
                          "--compute_auc", "--num_workers", "2"),
    "f1_inference": ("test_truncated_resnet50", "--mode", "inference", "--inference_input",
                     "DATA/test", "--batch_size", "8", "--num_workers", "2"),
    "f1_tsne_k2": ("test_truncated_resnet50", "--mode", "tsne", "--batch_size", "4",
                   "--steps_per_dispatch", "2", "--num_workers", "2"),
    "f2_classification": ("test_gram_attention", "--mode", "classification",
                          "--num_samples", "10", "--compute_auc"),
    "f2_style_transfer": ("test_gram_attention", "--mode", "style_transfer", "--num_samples",
                          "4", "--num_iterations", "3", "--layers", "5", "--threshold", "0"),
    "f3_classification": ("test_multi_patchgan", "--mode", "classification",
                          "--num_samples", "10", "--compute_auc"),
    # int8: rank 0 fine-tunes (--qat_steps), calibrates and writes
    # --quantized_path (OUT: the case's directory); the other rank takes the
    # quantised tree and the fine-tuned weights from one broadcast
    "f1_int8_qat_classification": ("test_truncated_resnet50", "--mode", "classification",
                                   "--precision", "int8", "--qat_steps", "1",
                                   "--quantized_path", "OUT_q.npz", "--num_samples", "4",
                                   "--batch_size", "4", "--prob_threshold", "0",
                                   "--num_workers", "2"),
}

CASES = {
    "f2_texture": lambda mesh, inp, out: run_texture(mesh, inp, "f2"),
    "f3_texture": lambda mesh, inp, out: run_texture(mesh, inp, "f3"),
    "content_style": lambda mesh, inp, out: run_content_style(mesh, inp),
    **{name: (lambda spec: lambda mesh, inp, out: _cli(
        spec[0], mesh, inp, out, *(a.replace("DATA", inp["_data"]).replace("OUT", out)
                                   for a in spec[1:])))(spec)
       for name, spec in CLI_CASES.items()},
}


def flat_leaves(tree, prefix: str = ""):
    """(path, leaf) of each leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flat_leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from flat_leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree)


def load_inputs(in_dir: str) -> dict:
    inputs = load_pytree_npz(os.path.join(in_dir, "inputs.npz"))
    with open(os.path.join(in_dir, "paths.json")) as f:
        inputs.update(json.load(f))
    return inputs


def run_cases(mesh, in_dir: str, out_dir: str, cases) -> dict:
    inputs = load_inputs(in_dir)
    results = {}
    for case in cases:
        t0 = time.perf_counter()
        results[case] = CASES[case](mesh, inputs, os.path.join(out_dir, case))
        results[case]["seconds"] = np.float64(time.perf_counter() - t0)
    return results


def rank_main(rank: int, world: int, init_method: str, in_dir: str, out_dir: str,
              cases) -> None:
    """A spawned gloo rank: the launcher's environment (so a CLI joins the
    group instead of spawning), every case of ``cases`` on the CPU, its
    results in ``out_dir/rank<r>.npz``."""
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
        results = run_cases(create_mesh(world), in_dir, out_dir, cases)
        save_pytree_npz(results, os.path.join(out_dir, f"rank{rank}.npz"))
    finally:
        shutdown_distributed()
