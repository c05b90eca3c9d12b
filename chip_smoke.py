#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py    # needs one H100 SXM

Phases, all run every time:
  build           csrc/gram.cu and csrc/instance_norm.cu, one nvcc each,
                  started together (sm_90a).
  kernels         hold gram_fwd, gram_bwd and pooled_gram_fwd against their
                  plain PyTorch versions at the main path's shapes in f32
                  and bf16, on non-negative inputs as the main path's
                  post-ReLU features are (gram_fwd also at two ragged
                  shapes, gram_bwd at three, each row naming its route and
                  splits, gram_bwd's also its two-call yardstick;
                  pooled_gram_fwd also at three ragged shapes and three
                  with S > 16, each row naming S, its route and splits);
                  instance_norm_fwd likewise at the fast-style net's
                  shapes (B = 8, with and without ReLU, per-image affine
                  rows that differ), at C = 48, C = 5,
                  (1,512,512,32) bf16 and on channels of mean 1e3, on signed
                  inputs as conv outputs are; time the kernel, the plain
                  version and a library call; compute each bound from the
                  shapes and the card's peak rates.
  classification  family 2 at full width (truncate 8, S 7, 4 classes, 224²
                  crops, batch 8, 16 images, seeded random weights) through
                  the npz writer, the npz reader, the weight bridge and the
                  function the CLI's ``--mode classification`` calls.
  style_transfer  the Adam-on-pixels loop through the function the CLI's
                  ``--mode style_transfer`` calls (layers 5, batch 4,
                  20 iterations, threshold 0).
  fast_style      ``serve_style --net`` through the CLI's ``start``: the
                  classic net (width 32, 5 residual blocks, crop 224, seeded
                  weights) written as style_net.npz and its hyperparameters,
                  batch sizes 4,8, 16 raw 224² POSTs from 8 threads; one
                  answer against the same net on the CPU.
  conditional     a 3-style conditional net through make_net_job_fn with
                  blended rows that differ per image, against the CPU; the
                  same net in bf16 through make_stylize_fn against f32.
  texture_serve   ``serve_style`` texture mode on the classification
                  phase's model (layers 5, 5 iterations, batch 2, 2 POSTs).

Launch counts are set to 0 just before each main-path phase and read just
after; a kernel of the phase that never launched fails the run, as does any
kernel that disagrees with its plain version beyond the stated tolerance.
Prints one JSON line of kernel records, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``. Exits non-zero, with no result,
when CUDA is absent or the port's package is not beside this script.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))
PKG = "heuristique_style_transfer_code_tpu_torch"
SOURCE = {"gram": f"{PKG}/csrc/gram.cu", "instance_norm": f"{PKG}/csrc/instance_norm.cu"}
PALLAS = "heuristique_style_transfer_code_tpu/ops/pallas/gram_kernel.py"
PALLAS_IN = "heuristique_style_transfer_code_tpu/ops/pallas/instance_norm_kernel.py"

# Dense peak rates of the H100 SXM (NVIDIA data sheet), the card whose name
# this is: bytes/s of device memory, FLOP/s of f32 outside the tensor cores
# (the kernels do not use TF32) and of bf16 on the tensor cores. Bounds on
# any other card would need its own row, so the run refuses it.
PEAKS_CARD = "H100 80GB HBM3"
PEAKS = (3.35e12, 67e12, 989e12)

# Both max|err| / max|plain| and ||err|| / ||plain|| (RMS) must stay under it.
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# instance_norm_fwd: (max, RMS) bounds of the same two relative errors
TOL_IN = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 5e-3)}

GRAM_SHAPES = [(4, 56, 56, 64), (4, 56, 56, 256), (4, 7, 7, 2048)]  # layers 4, 5, 8
# gram_fwd only: C not a multiple of 64, HW not of 64 (TMA's zero fill, the
# clipped stores, a partial diagonal tile)
RAGGED_GRAM_SHAPES = [(1, 13, 11, 200), (2, 7, 7, 48)]
POOLED_SHAPES = [(8, 56, 56, 256), (8, 28, 28, 512), (8, 14, 14, 1024), (8, 7, 7, 2048)]
POOL_S = 7
# pooled_gram_fwd only, (shape, S): C % S != 0 at odd HW; C % 4 != 0 (the
# scalar-load path) at the largest S; C < S (a channel in several bins)
RAGGED_POOLED = [((2, 13, 11, 200), 7), ((1, 9, 7, 203), 16), ((2, 5, 5, 5), 7)]
# gram_bwd only: C not a multiple of 64 at HW 143 and 49, and C % 8 != 0
# (bf16 then takes the FFMA route, f32 its scalar loads)
RAGGED_BWD_SHAPES = [(1, 13, 11, 200), (2, 7, 7, 48), (1, 9, 7, 203)]
# pooled_gram_fwd past 16 bins (the "project" route): layer4, C % S != 0 at
# odd HW, and C < S
LARGE_S_POOLED = [((8, 7, 7, 2048), 24), ((2, 13, 11, 200), 24), ((2, 5, 5, 5), 20)]
DEVICE = "cuda"
N_IMAGES, STYLE_ITERS = 16, 20
# the main-path shapes that the kernel records report
MAIN_SHAPE = {"gram_fwd": (4, 56, 56, 256), "gram_bwd": (4, 56, 56, 256),
              "pooled_gram_fwd": (8, 56, 56, 256), "instance_norm_fwd": (8, 224, 224, 32)}
# the fast-style net's norms at crop 224, width 32, batch 8: in1 and in_up2,
# in2 and in_up1, in3 and the residual blocks' 10
IN_SHAPES = [(8, 224, 224, 32), (8, 112, 112, 64), (8, 56, 56, 128)]
NORMS_PER_FORWARD = 15
N_REQUESTS, REQUEST_THREADS = 16, 8


def _require(ok: bool, what: str) -> None:
    """A failed check ends the run (unlike ``assert``, also under -O)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def _peaks(name: str):
    if PEAKS_CARD not in name:
        raise RuntimeError(f"chip_smoke knows the peak rates of the {PEAKS_CARD} only, "
                           f"not of {name!r}")
    return PEAKS


def _time_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Device time of one call of ``fn``: ``reps`` calls captured in a CUDA
    graph, replayed ``replays`` times between two events. The graph takes
    the host (Python, ctypes, allocator) out of the measurement, which
    eager back-to-back launches of a few-microsecond kernel would time
    instead."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up: library handles, the build, workspaces
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def _bound(flops: float, nbytes: float, dtype, peaks):
    import torch

    mem, f32, bf16 = peaks
    t_ops = flops / (bf16 if dtype == torch.bfloat16 else f32)
    t_bytes = nbytes / mem
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def phase_kernels(kg, peaks) -> dict:
    """Every kernel against its plain version, f32 and bf16, at the main
    path's shapes; returns {kernel: [row per shape and dtype]}."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {name: [] for name in kg.KERNELS}

    def check(got, want, dtype):
        """Max and RMS error, each relative to the plain result's own scale.
        The RMS one weighs every entry alike, so a wrong off-diagonal block
        fails it even where the diagonal dominates max|plain|."""
        torch.cuda.synchronize()
        diff = got.float() - want.float()
        err = diff.abs().max().item()
        rel = err / want.float().abs().max().item()
        rms = (diff.norm() / want.float().norm()).item()
        tol = TOL[str(dtype).split(".")[1]]
        ok = bool(torch.isfinite(got.float()).all()) and rel <= tol and rms <= tol
        return err, rel, rms, ok

    def features(shape, dtype, generator=gen):
        """Post-ReLU-like features: non-negative, so the Gram's off-diagonal
        entries are of the same order as its diagonal."""
        return torch.relu(torch.randn(shape, device=dev, generator=generator)).to(dtype)

    # the ragged shapes draw from their own generator, so the main shapes'
    # inputs stay those of the runs before they were added
    gen_ragged = torch.Generator(device=dev).manual_seed(2)
    gen_pooled_ragged = torch.Generator(device=dev).manual_seed(3)
    gen_bwd_ragged = torch.Generator(device=dev).manual_seed(4)
    gen_pooled_large_s = torch.Generator(device=dev).manual_seed(5)

    def bwd_row(f, dg, shape, dtype, dname, es):
        n, h, w, c = shape
        hw = h * w
        err, rel, rms, ok = check(kg.gram_bwd(f, dg), kg.gram_bwd_plain(f, dg), dtype)
        route, row_tile, _, k_splits, _ = kg.gram_bwd_plan_for(f, dg, torch.empty_like(f))
        bound, by = _bound(2.0 * n * hw * c * c + n * c * c,
                           (2 * n * hw * c + n * c * c) * es, dtype, peaks)
        sym, out = torch.empty_like(dg), torch.empty_like(f)

        def two_calls():  # the yardstick: symmetrise dG, then one batched product
            torch.add(dg, dg.transpose(1, 2), out=sym)
            torch.baddbmm(out, f, sym, beta=0, alpha=1.0 / hw)

        return dict(
            shape=[n, h, w, c], dtype=dname, route=route, row_tile=row_tile, k_splits=k_splits,
            max_abs_err=err, rel_err=rel, rms_err=rms, tol=TOL[dname],
            ok=ok, ms=_time_ms(lambda: kg.gram_bwd(f, dg)),
            plain_ms=_time_ms(lambda: kg.gram_bwd_plain(f, dg)),
            library_ms=None,  # no single PyTorch call symmetrises dG inside a product
            two_call_ms=_time_ms(two_calls), bound_ms=bound, bound_by=by)

    from heuristique_style_transfer_code_tpu_torch.ops.pooling import adaptive_pool_matrix

    for dtype in (torch.float32, torch.bfloat16):
        es = torch.tensor([], dtype=dtype).element_size()
        dname = str(dtype).split(".")[1]
        for (n, h, w, c) in GRAM_SHAPES + RAGGED_GRAM_SHAPES:
            hw = h * w
            main = (n, h, w, c) in GRAM_SHAPES
            f = features((n, hw, c), dtype, gen if main else gen_ragged)
            # forward
            err, rel, rms, ok = check(kg.gram_fwd(f), kg.gram_fwd_plain(f), dtype)
            out = torch.empty((n, c, c), device=dev, dtype=dtype)
            ft = f.transpose(1, 2)
            route, _, splits, _ = kg.gram_fwd_plan_for(f)
            # the work that is needed: G's C(C+1)/2 distinct entries
            bound, by = _bound(1.0 * n * hw * c * (c + 1), (n * hw * c + n * c * c) * es,
                               dtype, peaks)
            rows["gram_fwd"].append(dict(
                shape=[n, h, w, c], dtype=dname, route=route, splits=splits, max_abs_err=err,
                rel_err=rel, rms_err=rms, tol=TOL[dname],
                ok=ok, ms=_time_ms(lambda: kg.gram_fwd(f)),
                plain_ms=_time_ms(lambda: kg.gram_fwd_plain(f)),
                library_ms=_time_ms(lambda: torch.baddbmm(out, ft, f, beta=0, alpha=1.0 / hw)),
                bound_ms=bound, bound_by=by))
            if not main:
                del f, out, ft
                continue
            # the style loss's cotangent 2(G - target)/C² is signed
            dg = torch.randn((n, c, c), device=dev, generator=gen).to(dtype)
            rows["gram_bwd"].append(bwd_row(f, dg, (n, h, w, c), dtype, dname, es))
            del f, dg, out, ft
        for (n, h, w, c) in RAGGED_BWD_SHAPES:
            f = features((n, h * w, c), dtype, gen_bwd_ragged)
            dg = torch.randn((n, c, c), device=dev, generator=gen_bwd_ragged).to(dtype)
            rows["gram_bwd"].append(bwd_row(f, dg, (n, h, w, c), dtype, dname, es))
            del f, dg
        pooled_gens = {"main": gen, "ragged": gen_pooled_ragged, "large_s": gen_pooled_large_s}
        pooled_cases = ([(shape, POOL_S, "main") for shape in POOLED_SHAPES]
                        + [(shape, s, "ragged") for shape, s in RAGGED_POOLED]
                        + [(shape, s, "large_s") for shape, s in LARGE_S_POOLED])
        for (n, h, w, c), s, kind in pooled_cases:
            hw = h * w
            f = features((n, hw, c), dtype, pooled_gens[kind])
            err, rel, rms, ok = check(kg.pooled_gram_fwd(f, s),
                                      kg.pooled_gram_fwd_plain(f, s), dtype)
            route = kg.pooled_gram_route_for(f, s)
            if route == "project":  # the splits of gram_fwd on the f32 projection
                splits = kg._gram_fwd_plan(n, hw, s, kg._sm_count(dev), torch.float32)[2]
            else:
                splits, _ = kg._pooled_gram_plan(n, hw, kg._sm_count(dev))
            # one read of F, one write of G; an add per element, the bin
            # weights and the S(S+1)/2 distinct products per row
            bound, by = _bound(1.0 * n * hw * (c + s + s * (s + 1)),
                               n * hw * c * es + n * s * s * es, dtype, peaks)
            pl = adaptive_pool_matrix(c, s, dev).to(dtype)
            rows["pooled_gram_fwd"].append(dict(
                shape=[n, h, w, c], s=s, dtype=dname, route=route, splits=splits,
                max_abs_err=err,
                rel_err=rel, rms_err=rms, tol=TOL[dname], ok=ok,
                ms=_time_ms(lambda: kg.pooled_gram_fwd(f, s)),
                plain_ms=_time_ms(lambda: kg.pooled_gram_fwd_plain(f, s)),
                # one call, the same contraction without the 1/HW scale of S*S outputs
                library_ms=_time_ms(lambda: torch.einsum("nkc,oc,nkd,pd->nop", f, pl, f, pl)),
                bound_ms=bound, bound_by=by))
            del f
    for name, rs in rows.items():
        for r in rs:
            route = f" S={r['s']}" if "s" in r else ""
            route += f" route={r['route']}" if "route" in r else ""
            route += f" splits={r['splits']}" if "splits" in r else ""
            route += f" row_tile={r['row_tile']} k_splits={r['k_splits']}" if "k_splits" in r else ""
            two = f" two_call_ms={r['two_call_ms']:.4f}" if "two_call_ms" in r else ""
            print(f"[kernels] {name} {r['dtype']} {tuple(r['shape'])}{route}: max_abs_err={r['max_abs_err']:.3e} "
                  f"rel={r['rel_err']:.3e} rms={r['rms_err']:.3e} (tol {r['tol']}) ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
                  f"library_ms={r['library_ms']}{two} bound_ms={r['bound_ms']:.4f} ({r['bound_by']})")
    bad = [(name, r["dtype"], r["shape"]) for name, rs in rows.items() for r in rs if not r["ok"]]
    if bad:
        raise RuntimeError(f"kernels disagree with their plain versions: {bad}")
    return rows


def phase_in_kernels(kin, peaks) -> list:
    """instance_norm_fwd against its plain version; returns one row per
    case. Inputs are signed, like conv outputs (randn * 2 + 0.5 plus
    per-channel offsets), with per-image scale and bias rows that differ.
    The mean-1e3 case is held against the plain version run in float64 on
    the same values: in f32 the plain version's own mean rounds by about
    3e-5 at 1e3, which is 1e-5 of the output, the tolerance itself."""
    import torch
    import torch.nn.functional as F

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    cases = [(shape, dtype, relu, "signed") for shape in IN_SHAPES
             for dtype in (torch.float32, torch.bfloat16) for relu in (False, True)]
    cases += [((3, 37, 29, 48), dtype, True, "signed") for dtype in (torch.float32, torch.bfloat16)]
    cases += [((2, 13, 11, 5), dtype, True, "signed") for dtype in (torch.float32, torch.bfloat16)]
    cases += [((1, 512, 512, 32), torch.bfloat16, True, "signed"),
              ((2, 224, 224, 32), torch.float32, False, "mean 1e3")]
    rows = []
    for (b, h, w, c), dtype, relu, kind in cases:
        hw = h * w
        dname = str(dtype).split(".")[1]
        if kind == "mean 1e3":  # std 1 around 1e3: a one-pass variance fails here
            xf = torch.randn((b, hw, c), device=dev, generator=gen) + 1e3
        else:
            xf = (torch.randn((b, hw, c), device=dev, generator=gen) * 2 + 0.5
                  + torch.randn((c,), device=dev, generator=gen))
        x = xf.to(dtype)
        scale = torch.randn((b, c), device=dev, generator=gen)
        bias = torch.randn((b, c), device=dev, generator=gen)
        got = kin.instance_norm_fwd(x, scale, bias, relu=relu)
        torch.cuda.synchronize()
        ref = x.double() if kind == "mean 1e3" else x
        want = kin.instance_norm_fwd_plain(ref, scale, bias, relu=relu).double()
        diff = got.double() - want
        err = diff.abs().max().item()
        rel = err / want.abs().max().item()
        rms = (diff.norm() / want.norm()).item()
        tol_max, tol_rms = TOL_IN[dname]
        ok = bool(torch.isfinite(got.float()).all()) and rel <= tol_max and rms <= tol_rms
        extra = {}
        if kind == "mean 1e3":  # what the f32 plain version itself is off by here
            p32 = kin.instance_norm_fwd_plain(x, scale, bias, relu=relu).double()
            extra["plain_f32_rel_err"] = ((p32 - want).abs().max() / want.abs().max()).item()
        # 1 read of x, 1 write of y, the (B, C) rows; about 7 f32 operations
        # per element (shift, sums, deviation square, apply), on CUDA cores
        es = x.element_size()
        bound, by = _bound(7.0 * b * hw * c, 2 * b * hw * c * es + 2 * b * c * 4,
                           torch.float32, peaks)
        x4 = x.view(b, h, w, c).permute(0, 3, 1, 2)  # channels_last NCHW view
        s0, b0 = scale[0], bias[0]
        rows.append(dict(
            shape=[b, h, w, c], dtype=dname, relu=relu, input=kind, max_abs_err=err,
            rel_err=rel, rms_err=rms, tol=[tol_max, tol_rms], ok=ok,
            ms=_time_ms(lambda: kin.instance_norm_fwd(x, scale, bias, relu=relu)),
            plain_ms=_time_ms(lambda: kin.instance_norm_fwd_plain(x, scale, bias, relu=relu)),
            # one library call: a single (C,) affine, no ReLU
            library_ms=_time_ms(lambda: F.instance_norm(x4, weight=s0, bias=b0, eps=kin.EPS)),
            bound_ms=bound, bound_by=by, **extra))
        del x, xf, got, want, diff
    for r in rows:
        print(f"[kernels] instance_norm_fwd {r['dtype']} {tuple(r['shape'])} relu={r['relu']} "
              f"{r['input']}: max_abs_err={r['max_abs_err']:.3e} rel={r['rel_err']:.3e} "
              f"rms={r['rms_err']:.3e} (tol {r['tol']}) ms={r['ms']:.4f} "
              f"plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']})"
              + (f" plain_f32_rel_err={r['plain_f32_rel_err']:.3e}" if "plain_f32_rel_err" in r
                 else ""))
    bad = [(r["dtype"], r["shape"], r["relu"], r["input"]) for r in rows if not r["ok"]]
    if bad:
        raise RuntimeError(f"instance_norm_fwd disagrees with its plain version: {bad}")
    return rows


def _batches(n_images: int, batch: int, seed: int):
    """In-memory batches with HostLoader's contract: staged 256² uint8."""
    import numpy as np

    rng = np.random.RandomState(seed)
    out = []
    for i in range(0, n_images, batch):
        out.append({
            "image": rng.randint(0, 256, (batch, 256, 256, 3)).astype(np.uint8),
            "label": rng.randint(0, 4, (batch,)).astype(np.int32),
            "indices": np.arange(i, i + batch),
            "n_valid": batch,
        })
    return out


def phase_classification(kernels, tmp: str, timings: dict):
    import numpy as np
    import torch

    from heuristique_style_transfer_code_tpu_torch.checkpoint.convert import to_jax_tree
    from heuristique_style_transfer_code_tpu_torch.checkpoint.io import save_pytree_npz
    from heuristique_style_transfer_code_tpu_torch.cli.test_gram_attention import (
        load_gram_attention,
        run_classification,
    )
    from heuristique_style_transfer_code_tpu_torch.core.device import resolve_device
    from heuristique_style_transfer_code_tpu_torch.data.augment import eval_preprocess
    from heuristique_style_transfer_code_tpu_torch.models.gram_attention import (
        gram_attention_apply,
        gram_attention_init,
    )

    dev = resolve_device(DEVICE)
    truncate, s, classes, batch = 8, POOL_S, 4, 8
    seeded = gram_attention_init(torch.Generator().manual_seed(0), truncate, classes, s,
                                 device="cpu")
    ckpt = os.path.join(tmp, "family2.npz")
    save_pytree_npz(to_jax_tree(seeded), ckpt)
    model = load_gram_attention(ckpt, truncate, classes, s, dev)
    batches = _batches(N_IMAGES, batch, seed=1)
    out_dir = os.path.join(tmp, "classification")

    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = run_classification(model, batches, out_dir, truncate=truncate,
                                 gram_matrix_size=s, num_classes=classes)
    torch.cuda.synchronize()
    timings["classification_s"] = time.perf_counter() - t0
    launches = kernels.launch_counts()
    print(f"[classification] {json.dumps(results)} launches={launches} "
          f"seconds={timings['classification_s']:.3f}")
    _require(os.path.exists(os.path.join(out_dir, "classification_results.json")),
             "classification_results.json written")
    _require(launches["pooled_gram_fwd"] == 4 * len(batches),
             f"pooled_gram_fwd launched 4 times per batch: {launches}")
    _require(all(np.isfinite(v) for v in results.values()), f"finite metrics: {results}")

    # reference on a small input: the same weights on the CPU (plain Grams)
    with torch.inference_mode():
        x = eval_preprocess(torch.from_numpy(batches[0]["image"][:2]))
        emb_c, logits_c = gram_attention_apply(model, x.to(dev), truncate, s, classes)
        emb_r, logits_r = gram_attention_apply(seeded, x, truncate, s, classes)
    err = (logits_c.cpu() - logits_r).abs().max().item() / logits_r.abs().max().item()
    err_e = (emb_c.cpu() - emb_r).abs().max().item() / emb_r.abs().max().item()
    print(f"[classification] card vs CPU reference (2 images, f32): logits rel err {err:.3e}, "
          f"embeddings rel err {err_e:.3e} (tol 1e-3)")
    _require(logits_c.shape == (2, classes) and bool(torch.isfinite(logits_c).all()),
             f"finite logits of shape (2, {classes})")
    _require(err <= 1e-3 and err_e <= 1e-3, f"card agrees with the CPU: {err}, {err_e}")
    return model, seeded, launches


def phase_style_transfer(kernels, model, seeded, tmp: str, timings: dict):
    import torch

    from heuristique_style_transfer_code_tpu_torch.tasks.style_transfer import (
        make_gram_fn_gram_attention,
        make_style_transfer_optimizer,
        style_transfer_gram_attention,
    )

    layers, batch, iters = 5, 4, STYLE_ITERS
    batches = _batches(N_IMAGES, batch, seed=2)
    out_dir = os.path.join(tmp, "style")
    history = []

    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    saved = style_transfer_gram_attention(
        model, batches, out_dir, layers=layers, threshold=0.0, num_iterations=iters,
        truncate_layer=8, generator=torch.Generator().manual_seed(0), history=history,
        log_fn=lambda msg: None,
    )
    torch.cuda.synchronize()
    timings["style_transfer_s"] = time.perf_counter() - t0
    launches = kernels.launch_counts()
    first = [h[0].mean().item() for h in history]
    last = [h[-1].mean().item() for h in history]
    print(f"[style_transfer] {len(saved)} PNGs, iterations per batch {[len(h) for h in history]}, "
          f"mean loss it1 {first} -> it{iters} {last}, launches={launches}, "
          f"seconds={timings['style_transfer_s']:.3f}")
    _require(all(len(h) == iters for h in history), f"{iters} iterations per batch")
    _require(launches["gram_fwd"] >= iters and launches["gram_bwd"] >= iters,
             f"gram_fwd and gram_bwd launched at least {iters} times: {launches}")
    _require(all(b < a for a, b in zip(first, last)), f"mean loss fell: {first} -> {last}")
    _require(len(saved) == N_IMAGES and all(os.path.exists(p) for p in saved),
             f"{N_IMAGES} PNGs written")

    # reference on a small input: 3 iterations at 64 px, card vs CPU
    noise0 = torch.randn((2, 64, 64, 3), generator=torch.Generator().manual_seed(3))
    traj = {}
    for name, m, dev in (("card", model, DEVICE), ("cpu", seeded, "cpu")):
        gram_fn = make_gram_fn_gram_attention(m, 8, layers=layers)
        with torch.no_grad():
            targets = gram_fn(noise0.to(dev) * 0.5 + 0.1)
        run = make_style_transfer_optimizer(gram_fn, 0.01, 3, 0.0)
        h = []
        run(noise0.to(dev), targets, h)
        traj[name] = torch.stack([p.cpu() for p in h])
    err = ((traj["card"] - traj["cpu"]).abs() / traj["cpu"].abs()).max().item()
    print(f"[style_transfer] card vs CPU reference (2 images 64 px, 3 iterations): "
          f"loss trajectory rel err {err:.3e} (tol 1e-3)")
    _require(bool(torch.isfinite(traj["card"]).all()) and err <= 1e-3,
             f"card loss trajectory agrees with the CPU: {err}")
    return launches


def _serve(argv):
    """The port's serve_style as its CLI builds it: ``start(args)``, then
    the HTTP server on a thread; returns (server, service, base url)."""
    from heuristique_style_transfer_code_tpu_torch.cli.serve_style import build_parser, start

    srv, service = start(build_parser().parse_args(argv))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, service, f"http://127.0.0.1:{srv.server_address[1]}"


def _stop(srv, service) -> None:
    srv.shutdown()
    srv.server_close()
    service.stop(drain=True)


def _post_raw(url: str, img):
    req = urllib.request.Request(url + "/style", data=img.tobytes(), method="POST",
                                 headers={"X-Raw-Shape": ",".join(map(str, img.shape))})
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.status, r.read(), dict(r.headers)


def _get(url: str, path: str):
    with urllib.request.urlopen(url + path, timeout=60) as r:
        return r.status, r.read().decode()


def _u8_gap(a, b) -> int:
    import numpy as np

    return int(np.abs(np.asarray(a).astype(np.int16) - np.asarray(b).astype(np.int16)).max())


def phase_fast_style(kernels, tmp: str, timings: dict) -> dict:
    """serve_style --net at full width: 16 concurrent raw POSTs."""
    import numpy as np
    import torch

    from heuristique_style_transfer_code_tpu_torch.checkpoint.convert import to_jax_tree
    from heuristique_style_transfer_code_tpu_torch.checkpoint.io import (
        save_model_and_hyperparameters,
    )
    from heuristique_style_transfer_code_tpu_torch.nn.transformer_net import (
        count_params,
        transformer_net_init,
    )
    from heuristique_style_transfer_code_tpu_torch.tasks.fast_style import make_stylize_fn
    from heuristique_style_transfer_code_tpu_torch.utils.png import decode_png

    net_cpu = transformer_net_init(torch.Generator().manual_seed(0), width=32, n_res=5,
                                   device="cpu")
    net_path = save_model_and_hyperparameters(
        to_jax_tree(net_cpu), {"crop": 224, "style_names": ["seeded"]}, tmp, "style_net")
    t0 = time.perf_counter()
    srv, service, url = _serve(["--net", net_path, "--batch_size", "4,8", "--port", "0",
                                "--device", DEVICE])
    timings["fast_style_start_s"] = time.perf_counter() - t0
    images = np.random.RandomState(4).randint(0, 256, (N_REQUESTS, 224, 224, 3)).astype(np.uint8)
    try:
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(REQUEST_THREADS) as pool:
            answers = list(pool.map(lambda im: _post_raw(url, im), images))
        timings["fast_style_16_requests_s"] = time.perf_counter() - t0
        launches = kernels.launch_counts()
        stats = json.loads(_get(url, "/stats")[1])
        health = _get(url, "/healthz")
    finally:
        _stop(srv, service)
    print(f"[fast_style] {count_params(net_cpu)} parameters; {N_REQUESTS} requests in "
          f"{timings['fast_style_16_requests_s']:.3f} s (start {timings['fast_style_start_s']:.2f} s); "
          f"stats {json.dumps(stats)}; launches={launches}")
    outs = [decode_png(body) for _, body, _ in answers]
    _require(all(st == 200 and h.get("X-Iterations") == "1" for st, _, h in answers),
             "every answer is 200 with X-Iterations: 1")
    _require(all(o.shape == (224, 224, 3) for o in outs), "every answer is a 224x224 RGB PNG")
    _require(stats["jobs"] == N_REQUESTS, f"/stats counts {N_REQUESTS} jobs: {stats}")
    _require(health[0] == 200, f"/healthz answers 200: {health}")
    _require(launches["instance_norm_fwd"] == NORMS_PER_FORWARD * stats["batches"],
             f"instance_norm_fwd launched {NORMS_PER_FORWARD} times per batch "
             f"({stats['batches']} batches): {launches}")
    ref = make_stylize_fn(net_cpu, crop=224)(images[:1]).numpy()[0]
    gap = _u8_gap(outs[0], ref)
    print(f"[fast_style] served answer vs the same net on the CPU: max gap {gap} uint8 steps "
          f"(tol 1)")
    _require(gap <= 1, f"served answer within 1 uint8 step of the CPU: {gap}")
    return launches


def phase_conditional(kernels) -> None:
    """A 3-style conditional net with blended per-image rows, card vs CPU;
    then bf16 against f32 on the card."""
    import numpy as np
    import torch

    from heuristique_style_transfer_code_tpu_torch.nn.transformer_net import (
        InstanceNorm,
        transformer_net_init,
    )
    from heuristique_style_transfer_code_tpu_torch.tasks.fast_style import (
        make_net_job_fn,
        make_stylize_fn,
    )

    gen = torch.Generator().manual_seed(5)
    net_cpu = transformer_net_init(gen, width=32, n_res=5, n_styles=3, device="cpu")
    with torch.no_grad():  # styles that differ: init gives every style ones and zeros
        for m in net_cpu.modules():
            if isinstance(m, InstanceNorm):
                m.weight.add_(0.3 * torch.randn(m.weight.shape, generator=gen))
                m.bias.add_(0.3 * torch.randn(m.bias.shape, generator=gen))
    net = transformer_net_init(None, width=32, n_res=5, n_styles=3, device=DEVICE)
    net.load_state_dict(net_cpu.state_dict())
    images = np.random.RandomState(6).randint(0, 256, (4, 224, 224, 3)).astype(np.uint8)
    w = np.array([[1, 0, 0], [0.2, 0.5, 0.3], [0, 0.4, 0.6], [1 / 3, 1 / 3, 1 / 3]], np.float32)
    ids = np.arange(4, dtype=np.int32)
    kernels.reset_launch_counts()
    got = make_net_job_fn(net, crop=224)(images, w, ids)[0].cpu().numpy()
    launches = kernels.launch_counts()["instance_norm_fwd"]
    want = make_net_job_fn(net_cpu, crop=224)(images, w, ids)[0].numpy()
    gap = _u8_gap(got, want)
    f32 = make_stylize_fn(net, crop=224, style_weights=w)(images).cpu().numpy()
    bf16 = make_stylize_fn(net, crop=224, style_weights=w,
                           compute_dtype=torch.bfloat16)(images).cpu().numpy()
    gap16 = np.abs(f32.astype(np.float32) - bf16.astype(np.float32)).max() / 255.0
    print(f"[conditional] 3 styles, blended rows: card vs CPU max gap {gap} uint8 steps (tol 1), "
          f"instance_norm_fwd launches {launches}; bf16 vs f32 max {gap16:.4f} in [0, 1] "
          f"(tol 0.05)")
    _require(launches == NORMS_PER_FORWARD, f"{NORMS_PER_FORWARD} norms per forward: {launches}")
    _require(gap <= 1, f"conditional net on the card within 1 step of the CPU: {gap}")
    _require(gap16 <= 0.05, f"bf16 within 0.05 of f32: {gap16}")


def phase_texture_serve(kernels, tmp: str) -> dict:
    """serve_style texture mode on the classification phase's model."""
    import numpy as np
    import torch

    ckpt = os.path.join(tmp, "family2.npz")  # written by phase_classification
    cfg = os.path.join(tmp, "family2.json")
    with open(cfg, "w") as f:
        json.dump({"batch_size": 8, "truncate_layer": 8, "gram_matrix_size": POOL_S}, f)
    srv, service, url = _serve(["--config_path", cfg, "--model_path", ckpt, "--layers", "5",
                                "--num_iterations", "5", "--threshold", "0",
                                "--batch_size", "2", "--port", "0", "--device", DEVICE])
    images = np.random.RandomState(7).randint(0, 256, (2, 224, 224, 3)).astype(np.uint8)
    try:
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        with ThreadPoolExecutor(2) as pool:
            answers = list(pool.map(lambda im: _post_raw(url, im), images))
        launches = kernels.launch_counts()
        stats = json.loads(_get(url, "/stats")[1])
    finally:
        _stop(srv, service)
    iters = [h.get("X-Iterations") for _, _, h in answers]
    print(f"[texture_serve] X-Iterations {iters}, X-Final-Loss "
          f"{[h.get('X-Final-Loss') for _, _, h in answers]}, stats {json.dumps(stats)}, "
          f"launches={launches}")
    _require(all(st == 200 for st, _, _ in answers) and iters == ["5", "5"],
             f"both answers carry X-Iterations: 5: {iters}")
    _require(launches["gram_fwd"] > 0 and launches["gram_bwd"] > 0,
             f"gram_fwd and gram_bwd launched: {launches}")
    return launches


def main() -> int:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, PKG)):
        print(f"chip_smoke: the port's package {PKG}/ is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from heuristique_style_transfer_code_tpu_torch.core.device import resolve_device
    from heuristique_style_transfer_code_tpu_torch.ops import kernels
    from heuristique_style_transfer_code_tpu_torch.ops.kernels import gram as kg
    from heuristique_style_transfer_code_tpu_torch.ops.kernels import instance_norm as kin

    resolve_device("cuda")  # f32 stays f32: no TF32 in cuDNN or cuBLAS
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    peaks = _peaks(name)

    t0 = time.perf_counter()
    libs = kernels.build_all()
    print(f"[build] {', '.join(os.path.relpath(p, REPO) for p in libs)} in "
          f"{time.perf_counter() - t0:.2f} s")

    timings = {}
    rows = phase_kernels(kg, peaks)
    rows["instance_norm_fwd"] = phase_in_kernels(kin, peaks)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        model, seeded, cls_launches = phase_classification(kernels, tmp, timings)
        st_launches = phase_style_transfer(kernels, model, seeded, tmp, timings)
        fs_launches = phase_fast_style(kernels, tmp, timings)
        phase_conditional(kernels)
        phase_texture_serve(kernels, tmp)
    launches = {"pooled_gram_fwd": cls_launches["pooled_gram_fwd"],
                "gram_fwd": st_launches["gram_fwd"], "gram_bwd": st_launches["gram_bwd"],
                "instance_norm_fwd": fs_launches["instance_norm_fwd"]}
    idle = [k for k in launches if launches[k] == 0]
    _require(not idle, f"every kernel launched on the main path: {idle}")

    records = []
    replaces = {"gram_fwd": f"{PALLAS}:60", "gram_bwd": f"{PALLAS}:60",
                "pooled_gram_fwd": f"{PALLAS}:100", "instance_norm_fwd": f"{PALLAS_IN}:192"}
    sources = {"gram_fwd": SOURCE["gram"], "gram_bwd": SOURCE["gram"],
               "pooled_gram_fwd": SOURCE["gram"], "instance_norm_fwd": SOURCE["instance_norm"]}
    for kname in launches:
        # the net's first norm (in1, with its ReLU) stands for K3's record
        main_row = next(r for r in rows[kname]
                        if tuple(r["shape"]) == MAIN_SHAPE[kname] and r["dtype"] == "float32"
                        and r.get("relu", True))
        records.append({
            "name": kname, "route": "cuda", "source": sources[kname],
            "replaces": replaces[kname], "launches": launches[kname],
            "shape": list(MAIN_SHAPE[kname]), "dtype": "float32",
            **{k: main_row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")},
        })
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"device": name, "power": smi, "rows": rows, "timings": timings,
                   "records": records}, f, indent=1)
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
