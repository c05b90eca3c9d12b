"""Where the time goes on the port's main path, on one GPU.

    python -m heuristique_style_transfer_code_tpu_torch.tools.profile_main_path

Three cells, each at full model width with seeded random weights:

  classification    family 2, truncate 8, S 7, 224² crops, batch 8, f32
                    (``run_classification``'s per-batch work)
  style_transfer    the Adam-on-pixels loop, layers 5, batch 4, f32 and bf16
                    (``make_style_transfer_optimizer``'s iterations)
  fast_style_serve  the classic fast-style net (width 32, 5 residual blocks),
                    crop 224, batch 8, f32 and bf16: a served batch's work,
                    uint8 in, ``make_net_job_fn``'s forward, uint8 back

For each: the host-clock time per step (ends in a synchronize; the median
of three timed runs, each run's time kept beside it, since host time varies
from run to run), and over a short ``torch.profiler`` window the device busy time, the idle share
(1 - busy / window) and the device time by kernel, the hand-written Gram
and instance-norm kernels first, with their share of busy. Prints one JSON
object per cell; writes them all to
``chiprun_out/profile_main_path.json`` when that directory exists.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from ..core.device import resolve_device
from ..data.augment import eval_preprocess
from ..models.gram_attention import gram_attention_apply, gram_attention_init
from ..nn.transformer_net import transformer_net_init
from ..ops.kernels import build_all
from ..tasks.fast_style import make_net_job_fn
from ..tasks.style_transfer import make_gram_fn_gram_attention, make_style_transfer_optimizer

GRAM_KERNELS = ("gram_fwd_kernel", "gram_fwd_wgmma_kernel", "gram_bwd_kernel",
                "gram_bwd_wgmma_kernel", "pooled_gram_kernel", "pooled_project_kernel")
IN_KERNELS = ("in_stats_kernel", "in_finalize_kernel", "in_apply_kernel")


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _profile(step, n_steps: int) -> dict:
    """Run ``step`` n_steps times under the profiler; busy, idle share and
    the top kernels by device time."""
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
        "instance_norm_share_of_busy": sum(norm.values()) / busy_ms if busy_ms else None,
        "top_kernels": [{"name": k[:90], "ms": v / 1e3, "count": c} for k, v, c in rows[:12]],
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


def style_cell(model, dev, dtype) -> dict:
    gram_fn = make_gram_fn_gram_attention(model, 8, layers=5, compute_dtype=dtype)
    rng = np.random.RandomState(2)
    images = eval_preprocess(torch.from_numpy(
        rng.randint(0, 256, (4, 256, 256, 3)).astype(np.uint8)).to(dev))
    with torch.no_grad():
        targets = gram_fn(images)
    noise0 = torch.randn(images.shape, generator=torch.Generator().manual_seed(0)).to(dev)

    def run(iters):
        return make_style_transfer_optimizer(gram_fn, 0.01, iters, 0.0)(noise0, targets)

    run(2)
    iters = 20
    runs = [t / iters for t in _timed(lambda: run(iters), 1)]
    ms = float(np.median(runs))
    return {"cell": "style_transfer", "layers": 5, "batch": 4,
            "dtype": str(dtype or torch.float32).split(".")[1], "iteration_ms": ms,
            "iteration_ms_runs": runs, "image_iterations_per_s": 4 / ms * 1e3,
            **{k: v for k, v in _profile(lambda: run(5), 1).items()}, "profiled_iterations": 5}


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
            "dtype": str(dtype or torch.float32).split(".")[1], "step_ms": ms,
            "step_ms_runs": runs, "images_per_s": 8 / ms * 1e3, **_profile(step, 3),
            "profiled_steps": 3}


def main() -> None:
    dev = resolve_device("cuda")
    model = gram_attention_init(torch.Generator().manual_seed(0), 8, 4, 7, device=dev)
    net = transformer_net_init(torch.Generator().manual_seed(0), width=32, n_res=5, device=dev)
    build_all()
    cells = [classification_cell(model, dev), style_cell(model, dev, None),
             style_cell(model, dev, torch.bfloat16), fast_style_cell(net, None),
             fast_style_cell(net, torch.bfloat16)]
    for c in cells:
        print(json.dumps(c))
    if os.path.isdir("chiprun_out"):
        with open(os.path.join("chiprun_out", "profile_main_path.json"), "w") as f:
            json.dump({"device": torch.cuda.get_device_name(0), "cells": cells}, f, indent=1)


if __name__ == "__main__":
    main()
