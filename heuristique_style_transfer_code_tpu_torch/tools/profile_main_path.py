"""Where the time goes on the port's main path, on one GPU.

    python -m heuristique_style_transfer_code_tpu_torch.tools.profile_main_path

Thirteen cells, each at full model width with seeded random weights:

  classification    family 2, truncate 8, S 7, 224² crops, batch 8, f32
                    (``run_classification``'s per-batch work)
  style_transfer    the Adam-on-pixels loop, layers 5, batch 4, f32 and bf16
                    (``make_style_transfer_optimizer``'s iterations)
  fast_style_serve  the classic fast-style net (width 32, 5 residual blocks),
                    crop 224, batch 8, f32 and bf16: a served batch's work,
                    uint8 in, ``make_net_job_fn``'s forward, uint8 back
  family1_classification
                    family 1, truncate 8, dim 256, 4 classes, 224² crops of
                    256² staged uint8, batch 32, f32 and bf16 (one
                    ``evaluate_classification`` call on one batch)
  camera            family 1 at batch 1, host-downscaled 224² RGB frames,
                    f32 and bf16 (``make_camera_infer_fn``, one frame in,
                    its probabilities fetched)
  family3_classification
                    family 3 at the config defaults (patch sizes 10/70/150,
                    ndf 64, gram dim 64, norm "batch", 4 classes), 224²
                    crops of 256² staged uint8, batch 32, f32 and bf16 (one
                    ``evaluate`` call of the CLI on one batch); and the
                    same model at norm "instance", f32, whose 13 norms a
                    forward are ``instance_norm_fwd`` launches
  family3_camera    family 3 at the config defaults at batch 1, norm
                    "batch" and norm "instance", f32: the camera path
                    (``make_camera_infer_fn`` over ``multiscale_test_apply``,
                    host-downscaled 224² RGB frames, the logits fetched)
  family3_style_transfer
                    family 3's Adam-on-pixels loop at the config defaults,
                    batch 1 (the CLI's loader), 224², f32 and bf16 at norm
                    "batch", f32 at norm "instance"
                    (``make_style_transfer_optimizer`` over
                    ``make_gram_fn_patches``: 16 ``gram_fwd`` and 16
                    ``gram_bwd`` an iteration, and under "instance" 13
                    ``instance_norm_fwd`` and 13 ``instance_norm_bwd``)
  content_style     family 2's content+style loop at --layers 8
                    --style_layers all, batch 4, 224², f32 and bf16, from
                    the content images (``make_content_style_optimizer``
                    over ``make_extract_fn_gram_attention``: 4 ``gram_fwd``
                    and 4 ``gram_bwd`` an iteration, at (4,56,56,256),
                    (4,28,28,512), (4,14,14,1024) and (4,7,7,2048))

  fast_style_train  one fast-style training step: the classic net (width 32,
                    5 residual blocks), crop 224, batch 16, the family-2
                    encoder at truncate 8 with --style_layers all, f32 and
                    bf16 (``make_fast_style_train_step``: 15
                    ``instance_norm_fwd`` and 15 ``instance_norm_bwd``, 4
                    ``gram_fwd`` and 4 ``gram_bwd`` a step), with the
                    launches a step and the peak memory
  family2_train     one family-2 training step at the reference's defaults
                    (truncate 7, S 7, batch 32, 224² crops of 256² staged
                    uint8, 4 classes, the encoder trainable), f32 and bf16
                    (``setup_gram_attention``'s train step: 3
                    ``pooled_gram_fwd`` and 3 ``pooled_gram_bwd``), with
                    the launches a step and the peak memory
  family1_train     one family-1 training step at full width (truncate 8,
                    dim 256, batch 32, 224² crops of 256² staged uint8, 4
                    classes) with the identity and all 25 (geometric,
                    colour) combinations, f32 and bf16, and with the
                    identity alone in f32 (``setup_truncated_resnet50``'s
                    train step: no hand-written kernel), with the peak
                    memory
  family3_train     one family-3 training step at the config defaults
                    (patch sizes 10/70/150, ndf 64, 4 classes), batch 32,
                    224² crops, f32 and bf16 under norm "batch" and norm
                    "instance" (``setup_multi_patchgan``'s train step: 13
                    ``instance_norm_fwd`` and 13 ``instance_norm_bwd`` a
                    step under "instance"), with the launches a step and
                    the peak memory

For each: the host-clock time per step (ends in a synchronize; the median
of three timed runs, each run's time kept beside it, since host time varies
from run to run), and over a short ``torch.profiler`` window the device busy time, the idle share
(1 - busy / window) and the device time by kernel, the hand-written Gram
and instance-norm kernels first, with their share of busy. Prints one JSON
object per cell; writes them all to
``chiprun_out/profile_main_path.json`` when that directory exists.
``--cells family3_camera,family3_classification`` runs only the cells
named. ``make_gram_fn_patches`` and the content+style functions are
imported only in the cells that use them, so a copy of this file placed
in an older checkout of the port, one without them, times that
checkout's other cells: a parent and its change compared on the same
card.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..cli._common import cast_forward
from ..cli.test_multi_patchgan import evaluate
from ..config.schema import MultiPatchGANConfig
from ..core.device import resolve_device
from ..data.augment import eval_preprocess
from ..models.gram_attention import gram_attention_apply, gram_attention_init
from ..models.multi_patchgan import multiscale_test_apply, multiscale_test_init
from ..models.truncated_resnet50 import combined_apply, truncated_resnet50_init
from ..nn.transformer_net import transformer_net_init
from ..ops.kernels import build_all
from ..tasks.camera import make_camera_infer_fn
from ..tasks.classification import evaluate_classification
from ..tasks.fast_style import make_net_job_fn
from ..tasks.style_transfer import make_gram_fn_gram_attention, make_style_transfer_optimizer

GRAM_KERNELS = ("gram_fwd_kernel", "gram_fwd_wgmma_kernel", "gram_bwd_kernel",
                "gram_bwd_wgmma_kernel", "pooled_gram_kernel", "pooled_project_kernel",
                "pooled_gram_bwd_kernel")
IN_KERNELS = ("in_cluster_kernel", "in_stats_kernel", "in_finalize_kernel", "in_apply_kernel",
              "in_bwd_cluster_kernel", "in_bwd_reduce_kernel", "in_bwd_finalize_kernel",
              "in_bwd_apply_kernel")


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _profile(step, n_steps: int) -> dict:
    """Run ``step`` n_steps times under the profiler; busy, idle share,
    the top kernels by device time, and the host's events (ops and CUDA
    runtime calls) by their own time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType

    # device-side events only (kernels, copies): a CPU op's device time
    # repeats that of the kernels it launched
    rows = [(e.key, _device_us(e), e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    rows = [r for r in rows if r[1] > 0]
    # host-side events (ops and the CUDA runtime calls) by their own time
    host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count) for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU), key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows) / 1e3
    rows.sort(key=lambda r: -r[1])
    gram = {k: v / 1e3 for k, v, _ in rows if any(g in k for g in GRAM_KERNELS)}
    norm = {k: v / 1e3 for k, v, _ in rows if any(g in k for g in IN_KERNELS)}
    return {
        "window_ms": window_ms,
        "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / window_ms if busy_ms else None,
        "gram_kernels_ms": gram,
        "gram_share_of_busy": sum(gram.values()) / busy_ms if busy_ms else None,
        "instance_norm_kernels_ms": norm,
        "instance_norm_kernel_launches": {k: c for k, _, c in rows
                                          if any(g in k for g in IN_KERNELS)},
        "instance_norm_share_of_busy": sum(norm.values()) / busy_ms if busy_ms else None,
        "top_kernels": [{"name": k[:90], "ms": v / 1e3, "count": c} for k, v, c in rows[:12]],
        "host_self_ms": sum(r[1] for r in host),
        "top_host_events": [{"name": k[:60], "ms": v, "count": c} for k, v, c in host[:10]],
    }


def _timed(step, n_steps: int, runs: int = 3) -> list[float]:
    """Host-clock ms per step, for each of ``runs`` runs of ``n_steps``."""
    out = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3 / n_steps)
    return out


def _dtype_name(dtype) -> str:
    return str(dtype or torch.float32).split(".")[1]


def classification_cell(model, dev) -> dict:
    rng = np.random.RandomState(1)
    u8 = torch.from_numpy(rng.randint(0, 256, (8, 256, 256, 3)).astype(np.uint8))

    def step():
        with torch.inference_mode():
            images = eval_preprocess(u8.to(dev))
            _, logits = gram_attention_apply(model, images, 8, 7, 4)
            torch.softmax(logits.float(), dim=-1).cpu()

    step()
    runs = _timed(step, 10)
    ms = float(np.median(runs))
    return {"cell": "classification", "batch": 8, "dtype": "float32", "step_ms": ms,
            "step_ms_runs": runs, "images_per_s": 8 / ms * 1e3, **_profile(step, 3)}


def _loop_timing(run, batch: int) -> dict:
    """Iteration time (host clock, 20 iterations, three runs) and a profile
    of 5 iterations of an Adam-on-pixels loop ``run(iterations)``, with
    the device busy time an iteration."""
    run(2)
    iters = 20
    runs = [t / iters for t in _timed(lambda: run(iters), 1)]
    ms = float(np.median(runs))
    prof = _profile(lambda: run(5), 1)
    return {"iteration_ms": ms, "iteration_ms_runs": runs,
            "image_iterations_per_s": batch / ms * 1e3, **prof, "profiled_iterations": 5,
            "busy_ms_per_iteration": prof["device_busy_ms"] / 5}


def _staged_images(dev, n: int, seed: int) -> torch.Tensor:
    rng = np.random.RandomState(seed)
    return eval_preprocess(torch.from_numpy(
        rng.randint(0, 256, (n, 256, 256, 3)).astype(np.uint8)).to(dev))


def _loop_cell(gram_fn, dev, batch: int, seed: int) -> dict:
    """``_loop_timing`` of the texture loop over ``gram_fn`` from noise."""
    images = _staged_images(dev, batch, seed)
    with torch.no_grad():
        targets = gram_fn(images)
    noise0 = torch.randn(images.shape, generator=torch.Generator().manual_seed(0)).to(dev)
    return _loop_timing(
        lambda iters: make_style_transfer_optimizer(gram_fn, 0.01, iters, 0.0)(noise0, targets),
        batch)


def style_cell(model, dev, dtype) -> dict:
    gram_fn = make_gram_fn_gram_attention(model, 8, layers=5, compute_dtype=dtype)
    return {"cell": "style_transfer", "layers": 5, "batch": 4, "dtype": _dtype_name(dtype),
            **_loop_cell(gram_fn, dev, 4, 2)}


def content_style_cell(model, dev, dtype) -> dict:
    """Family 2's content+style loop at --layers 8 --style_layers all (a
    Gram at each of the four stages), b4, from the content images, toward
    one style image's Grams."""
    from ..tasks.style_transfer import (
        make_content_style_optimizer,
        make_extract_fn_gram_attention,
    )

    extract = make_extract_fn_gram_attention(model, 8, 8, dtype, "all")
    images = _staged_images(dev, 4, 8)
    with torch.no_grad():
        style = [g.expand((4,) + tuple(g.shape[1:]))
                 for g in extract(_staged_images(dev, 1, 9))[1]]
        feats = extract(images)[0].float()
    return {"cell": "content_style", "layers": 8, "style_layers": "all", "batch": 4,
            "dtype": _dtype_name(dtype),
            **_loop_timing(lambda iters: make_content_style_optimizer(
                extract, learning_rate=0.01, num_iterations=iters, threshold=0.0)(
                images, style, feats), 4)}


def family3_style_cell(model, cfg, dev, dtype) -> dict:
    from ..tasks.style_transfer import make_gram_fn_patches

    gram_fn = make_gram_fn_patches(model, cfg.gram_matrix_dim, cfg.norm, dtype)
    return {"cell": "family3_style_transfer", "norm": cfg.norm, "ndf": cfg.ndf,
            "gram_matrix_dim": cfg.gram_matrix_dim, "batch": 1, "dtype": _dtype_name(dtype),
            **_loop_cell(gram_fn, dev, 1, 7)}


def fast_style_cell(net, dtype) -> dict:
    job = make_net_job_fn(net, crop=224, compute_dtype=dtype)
    rng = np.random.RandomState(3)
    u8 = rng.randint(0, 256, (8, 224, 224, 3)).astype(np.uint8)
    w = np.ones((8, 1), np.float32)
    ids = np.arange(8, dtype=np.int32)

    def step():
        job(u8, w, ids)[0].cpu()

    step()
    runs = _timed(step, 10)
    ms = float(np.median(runs))
    return {"cell": "fast_style_serve", "width": 32, "n_res": 5, "crop": 224, "batch": 8,
            "dtype": _dtype_name(dtype), "step_ms": ms,
            "step_ms_runs": runs, "images_per_s": 8 / ms * 1e3, **_profile(step, 3),
            "profiled_steps": 3}


def fast_style_train_cell(model, net, dev, dtype) -> dict:
    """One training step of the classic net at b16 against the frozen
    family-2 encoder's four stage Grams; staged uint8 batches from the
    host, as the CLI's loader gives them."""
    from ..ops.kernels import launch_counts, reset_launch_counts
    from ..tasks.fast_style import encode_style_grams, make_fast_style_train_step
    from ..tasks.style_transfer import make_extract_fn_gram_attention

    extract = make_extract_fn_gram_attention(model, 8, None, dtype, "all")
    rng = np.random.RandomState(10)
    u8 = rng.randint(0, 256, (16, 256, 256, 3)).astype(np.uint8)
    init, train_step = make_fast_style_train_step(extract, crop=224, compute_dtype=dtype)
    opt = init(net)
    grams = encode_style_grams(extract, rng.randint(0, 256, (256, 256, 3)).astype(np.uint8),
                               224, dev)

    def step():
        train_step(net, opt, u8, grams)

    step()
    torch.cuda.synchronize()
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    runs = _timed(step, 5)
    ms = float(np.median(runs))
    return {"cell": "fast_style_train", "width": 32, "n_res": 5, "crop": 224, "batch": 16,
            "truncate": 8, "style_layers": "all", "dtype": _dtype_name(dtype), "step_ms": ms,
            "step_ms_runs": runs, "steps_per_s": 1e3 / ms, "images_per_s": 16 / ms * 1e3,
            "launches_per_step": launches, "max_memory_allocated_gib": peak / 2**30,
            **_profile(step, 3), "profiled_steps": 3}


def _train_cell(cell: str, setup, seed: int, data_seed: int, ids=None, draws=None) -> dict:
    """One training step of ``setup`` (upload, augment, forward in train
    mode, cross-entropy, backward, SGD) at b32 on staged uint8 batches: its
    launches, peak memory, host-clock time and profile."""
    from ..ops.kernels import launch_counts, reset_launch_counts

    model, opt = setup.init(torch.Generator().manual_seed(seed))
    rng = np.random.RandomState(data_seed)
    u8 = rng.randint(0, 256, (32, 256, 256, 3)).astype(np.uint8)
    labels = rng.randint(0, 4, (32,)).astype(np.int32)

    def step():
        setup.train_step(model, opt, u8, labels, ids, draws)

    step()
    torch.cuda.synchronize()
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    runs = _timed(step, 5)
    ms = float(np.median(runs))
    return {"cell": cell, "batch": 32, "crop": 224, "step_ms": ms, "step_ms_runs": runs,
            "images_per_s": 32 / ms * 1e3, "launches_per_step": launches,
            "max_memory_allocated_gib": peak / 2**30, **_profile(step, 3), "profiled_steps": 3}


def family2_train_cell(dtype) -> dict:
    """One family-2 training step at b32 (the encoder trainable)."""
    from ..config.schema import GramAttentionConfig
    from ..train.factories import setup_gram_attention

    cfg = GramAttentionConfig(batch_size=32, lr=0.01, truncate_layer=7, gram_matrix_size=7,
                              seed=0)
    setup = setup_gram_attention(cfg, 4, [(None, None)], compute_dtype=dtype, device="cuda")
    return {**_train_cell("family2_train", setup, 76, 70), "truncate": 7,
            "gram_matrix_size": 7, "dtype": _dtype_name(dtype)}


def family1_train_cell(dtype, augmented: bool = True) -> dict:
    """One family-1 training step, augmented with the identity and the 25
    (geometric, colour) combinations over the batch, or with the identity
    alone."""
    from ..config.schema import TruncatedResNetConfig
    from ..data.augment import (
        AVAILABLE_COLOR_TRANSFORMS,
        AVAILABLE_GEOM_TRANSFORMS,
        batch_draws,
    )
    from ..train.factories import setup_truncated_resnet50

    combos = [(None, None)]
    if augmented:
        combos += [(g, c) for g in AVAILABLE_GEOM_TRANSFORMS for c in AVAILABLE_COLOR_TRANSFORMS]
    cfg = TruncatedResNetConfig(batch_size=32, lr=0.01, truncate_layer=8, dim=256, seed=0)
    setup = setup_truncated_resnet50(cfg, 4, combos, compute_dtype=dtype, device="cuda")
    ids = np.arange(32) % len(combos)
    out = _train_cell("family1_train", setup, 84, 84, ids, batch_draws((84,), 32))
    return {**out, "truncate": 8, "dim": 256, "combinations": len(combos),
            "dtype": _dtype_name(dtype)}


def family3_train_cell(norm: str, dtype) -> dict:
    """One family-3 training step (the train-variant discriminators)."""
    from ..train.factories import setup_multi_patchgan

    cfg = MultiPatchGANConfig(batch_size=32, lr=0.01, norm=norm, seed=0)
    setup = setup_multi_patchgan(cfg, 4, [(None, None)], compute_dtype=dtype, device="cuda")
    return {**_train_cell("family3_train", setup, 95, 95), "norm": norm, "ndf": cfg.ndf,
            "dtype": _dtype_name(dtype)}


def _family1_forward(dtype):
    return cast_forward(lambda m, images: combined_apply(m.moco, m.classifier, images, 8), dtype)


def family1_cell(model, dtype) -> dict:
    rng = np.random.RandomState(4)
    batch = [{"image": rng.randint(0, 256, (32, 256, 256, 3)).astype(np.uint8),
              "label": rng.randint(0, 4, (32,)).astype(np.int32),
              "indices": np.arange(32), "n_valid": 32}]
    fwd = _family1_forward(dtype)

    def step():
        evaluate_classification(fwd, model, batch, 4, prob_threshold=0.0)

    step()
    runs = _timed(step, 5)
    ms = float(np.median(runs))
    return {"cell": "family1_classification", "truncate": 8, "dim": 256, "batch": 32,
            "dtype": _dtype_name(dtype), "step_ms": ms, "step_ms_runs": runs,
            "images_per_s": 32 / ms * 1e3, **_profile(step, 3), "profiled_steps": 3}


def _camera(forward, model, dtype) -> dict:
    """One host-downscaled 224² RGB frame in, its output fetched: frame
    time over 50 frames (three runs) and a profile of 10."""
    infer = make_camera_infer_fn(forward, host_downscale=True)
    frame = np.random.RandomState(5).randint(0, 256, (224, 224, 3)).astype(np.uint8)

    def step():
        infer(model, frame).cpu()

    step()
    runs = _timed(step, 50)
    ms = float(np.median(runs))
    return {"transport": "rgb", "host_downscale": True, "batch": 1,
            "dtype": _dtype_name(dtype), "frame_ms": ms, "frame_ms_runs": runs,
            "frames_per_s": 1e3 / ms, **_profile(step, 10), "profiled_steps": 10}


def camera_cell(model, dtype) -> dict:
    return {"cell": "camera", **_camera(_family1_forward(dtype), model, dtype)}


def family3_camera_cell(model, cfg) -> dict:
    forward = lambda m, x: multiscale_test_apply(m, x, cfg.gram_matrix_dim, cfg.norm)[1]  # noqa: E731
    return {"cell": "family3_camera", "norm": cfg.norm, "ndf": cfg.ndf,
            "gram_matrix_dim": cfg.gram_matrix_dim, **_camera(forward, model, None)}


def family3_cell(model, cfg, dtype) -> dict:
    rng = np.random.RandomState(6)
    batch = [{"image": rng.randint(0, 256, (32, 256, 256, 3)).astype(np.uint8),
              "label": rng.randint(0, 4, (32,)).astype(np.int32),
              "indices": np.arange(32), "n_valid": 32}]

    def step():
        evaluate(model, batch, gram_matrix_dim=cfg.gram_matrix_dim, norm=cfg.norm,
                 compute_dtype=dtype)

    step()
    runs = _timed(step, 5)
    ms = float(np.median(runs))
    return {"cell": "family3_classification", "norm": cfg.norm, "ndf": cfg.ndf,
            "gram_matrix_dim": cfg.gram_matrix_dim, "batch": 32,
            "dtype": _dtype_name(dtype), "step_ms": ms, "step_ms_runs": runs,
            "images_per_s": 32 / ms * 1e3, **_profile(step, 3), "profiled_steps": 3}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    parser.add_argument("--cells", default=None,
                        help="comma-separated cell names to run (default: all)")
    args = parser.parse_args()
    dev = resolve_device("cuda")

    def seeded(init, seed, *a, **k):
        return init(torch.Generator().manual_seed(seed), *a, device=dev, **k)

    def f32_and_bf16(cell, model, *a):
        return [cell(model, *a, None), cell(model, *a, torch.bfloat16)]

    family3 = {norm: (seeded(multiscale_test_init, 13, cfg.patch_sizes, ndf=cfg.ndf,
                             num_classes=cfg.num_classes,
                             gram_matrix_dim=cfg.gram_matrix_dim, norm=norm), cfg)
               for norm, cfg in (("batch", MultiPatchGANConfig()),
                                 ("instance", MultiPatchGANConfig(norm="instance")))}
    # each cell's models are made when it runs, so --cells makes only its own
    plan = {
        "classification": lambda: [classification_cell(seeded(gram_attention_init, 0, 8, 4, 7),
                                                        dev)],
        "style_transfer": lambda: f32_and_bf16(style_cell, seeded(gram_attention_init, 0, 8, 4, 7),
                                               dev),
        "fast_style_serve": lambda: f32_and_bf16(
            fast_style_cell, seeded(transformer_net_init, 0, width=32, n_res=5)),
        "family1_classification": lambda: f32_and_bf16(
            family1_cell, seeded(truncated_resnet50_init, 8, 8, 4, 256)),
        "camera": lambda: f32_and_bf16(camera_cell, seeded(truncated_resnet50_init, 8, 8, 4, 256)),
        "family3_classification": lambda: f32_and_bf16(family3_cell, *family3["batch"])
        + [family3_cell(*family3["instance"], None)],
        "family3_camera": lambda: [family3_camera_cell(*family3[n]) for n in ("batch", "instance")],
        "family3_style_transfer": lambda: f32_and_bf16(family3_style_cell, *family3["batch"], dev)
        + [family3_style_cell(*family3["instance"], dev, None)],
        "content_style": lambda: f32_and_bf16(content_style_cell,
                                              seeded(gram_attention_init, 0, 8, 4, 7), dev),
        "fast_style_train": lambda: [
            fast_style_train_cell(seeded(gram_attention_init, 0, 8, 4, 7),
                                  seeded(transformer_net_init, 0, width=32, n_res=5), dev, dtype)
            for dtype in (None, torch.bfloat16)],
        "family2_train": lambda: [family2_train_cell(dtype) for dtype in (None, torch.bfloat16)],
        "family1_train": lambda: [family1_train_cell(None), family1_train_cell(torch.bfloat16),
                                  family1_train_cell(None, augmented=False)],
        "family3_train": lambda: [family3_train_cell(norm, dtype) for norm in ("batch", "instance")
                                  for dtype in (None, torch.bfloat16)],
    }
    names = args.cells.split(",") if args.cells else list(plan)
    unknown = sorted(set(names) - set(plan))
    if unknown:
        parser.error(f"unknown cells {unknown}; known: {sorted(plan)}")
    build_all()
    cells = [c for name in names for c in plan[name]()]
    for c in cells:
        print(json.dumps(c))
    if os.path.isdir("chiprun_out"):
        with open(os.path.join("chiprun_out", "profile_main_path.json"), "w") as f:
            json.dump({"device": torch.cuda.get_device_name(0), "cells": cells}, f, indent=1)


if __name__ == "__main__":
    main()
