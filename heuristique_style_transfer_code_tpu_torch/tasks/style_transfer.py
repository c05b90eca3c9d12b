"""Heuristic style transfer, families 2 and 3, and family 2's content+style
transfer (``tasks/style_transfer.py:44-129,167-456,459-725`` of the JAX
package).

Per batch of test images: the target Gram, then Adam on the pixels of a
noise image minimising the per-image MSE between its Gram and the target,
each image stopping once its loss falls below ``threshold``, capped at
``num_iterations``; then the [original | stylised] PNG into
``style_transfer_<date>/<label>/``.

Family 2's Gram is the truncated encoder's output's: every iteration runs
the encoder forward, the ``gram_fwd`` kernel, the encoder backward and the
``gram_bwd`` kernel (``ops/kernels/gram.py``). Family 3's is the outer
product of the three discriminators' mean embedding over its width
(``make_gram_fn_patches``); each iteration runs their forward (16
``gram_fwd`` launches and, under norm "instance", 13 ``instance_norm_fwd``)
and its backward (16 ``gram_bwd``, 13 ``instance_norm_bwd``).

Content+style (``content_style_transfer_gram_attention``): each content
image is re-rendered in one style image's style, from the content image
(or noise), by the same masked Adam on ``style_weight * sum_l
MSE(Gram_l, style Gram_l) + content_weight * MSE(feats, content feats)
[+ tv_weight * TV]``; with ``style_layers="all"`` each iteration runs a
Gram at every executed stage (four ``gram_fwd`` and four ``gram_bwd``
at truncate 8).

``compute_dtype=torch.bfloat16`` runs the model in bf16 while the pixels,
the Adam state and the loss stay f32.
"""
from __future__ import annotations

import copy
import os
import time
from datetime import datetime
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..ops.gram import gram_matrix_nhwc
from ..ops.resize import IMAGENET_MEAN, IMAGENET_STD
from ..utils.png import float_to_uint8, write_png

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def _masked_adam(per_image_loss: Callable[[torch.Tensor], torch.Tensor],
                 pixels0: torch.Tensor, learning_rate: float, num_iterations: int,
                 threshold: float, history: Optional[list] = None):
    """The batched Adam-on-pixels loop that both optimisers run:
    ``per_image_loss(pixels) -> (B,)``; returns (final_pixels,
    iterations_run, final_per_image_loss).

    Masked Adam, written out to optax's ``adam`` formulas (b1 0.9, b2 0.999,
    eps 1e-8 outside the square root, bias-corrected moments). The loss of
    an inactive image is masked out of the sum, so its gradient is zero —
    but its moments still update every step, exactly as optax's state does
    in the JAX loop; only the pixel update is masked, so a converged image
    stays bit-exactly where it froze. ``torch.optim.Adam`` would instead
    move an inactive image on its momentum. The threshold check comes after
    the step, as in the reference. The moments are updated in place (the
    JAX loop carries new arrays). ``history``, when a list, receives each
    iteration's per-image losses (device tensors; the loop syncs once per
    iteration anyway)."""
    # f32 pixels and moments whatever the model's dtype (f64 stays f64)
    pixels = pixels0.detach().to(torch.float64 if pixels0.dtype == torch.float64
                                 else torch.float32).clone()
    mu = torch.zeros_like(pixels)
    nu = torch.zeros_like(pixels)
    b = pixels.shape[0]
    active = torch.ones((b,), dtype=torch.bool, device=pixels.device)
    per = torch.full((b,), float("inf"), device=pixels.device, dtype=pixels.dtype)
    i = 0
    # One host sync per iteration for the exit test; capturing the step
    # in a CUDA graph and testing less often is the place to win it back.
    while i < num_iterations and bool(active.any()):
        x = pixels.detach().requires_grad_(True)
        per = per_image_loss(x)
        (grad,) = torch.autograd.grad((per * active.to(per.dtype)).sum(), x)
        per = per.detach()
        with torch.no_grad():
            mu.mul_(ADAM_B1).add_(grad, alpha=1 - ADAM_B1)
            nu.mul_(ADAM_B2).addcmul_(grad, grad, value=1 - ADAM_B2)
            count = i + 1
            mu_hat = mu / (1 - ADAM_B1 ** count)
            nu_hat = nu / (1 - ADAM_B2 ** count)
            update = mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS) * (-learning_rate)
            mask = active.view((b,) + (1,) * (pixels.dim() - 1))
            pixels = pixels + update * mask
            active = active & (per >= threshold)
        if history is not None:
            history.append(per)
        i += 1
    return pixels, i, per


def make_style_transfer_optimizer(
    gram_fn: Callable[[torch.Tensor], Sequence[torch.Tensor]],
    learning_rate: float = 0.01,
    num_iterations: int = 500,
    threshold: float = 1e-4,
):
    """Build the batched texture optimiser ``run(noise0, targets,
    history=None) -> (final_noise, iterations_run, final_per_image_loss)``:
    ``_masked_adam`` on the per-image sum over layers of the MSE between
    ``gram_fn(noise)`` (a list of per-image Grams, batch first) and the
    targets."""

    def per_image_loss(noise, targets):
        total = 0.0
        for g, t in zip(gram_fn(noise), targets):
            dims = tuple(range(1, g.dim()))
            total = total + torch.mean(torch.square(g.float() - t.float()), dim=dims)
        return total  # (B,)

    def run(noise0: torch.Tensor, targets: Sequence[torch.Tensor],
            history: Optional[list] = None):
        return _masked_adam(lambda x: per_image_loss(x, targets), noise0, learning_rate,
                            num_iterations, threshold, history)

    return run


def _encoder_in(model, compute_dtype: Optional[torch.dtype]):
    """The family-2 model's encoder, or a bf16 copy of it (weights and
    running statistics, as the JAX policy casts them), made once."""
    enc = model.encoder
    return copy.deepcopy(enc).to(compute_dtype) if compute_dtype is not None else enc


def make_feature_fn_gram_attention(
    model,
    truncate_layer: int = 8,
    layers: Optional[int] = None,
    compute_dtype: Optional[torch.dtype] = None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Truncated-encoder features ``images (B, H, W, 3) -> (B, h, w, C)``.
    ``layers`` truncates the encoder's child list like the reference's
    Sequential slice. In bf16 the encoder is a bf16 copy of the model's."""
    from ..nn.resnet import resnet50_apply

    truncate = min(layers if layers is not None else truncate_layer, truncate_layer, 8)
    enc = _encoder_in(model, compute_dtype)

    def feature_fn(images):
        if compute_dtype is not None:
            images = images.to(compute_dtype)
        feats, _ = resnet50_apply(enc, images, truncate=truncate)
        return feats

    return feature_fn


def make_extract_fn_gram_attention(
    model,
    truncate_layer: int = 8,
    layers: Optional[int] = None,
    compute_dtype: Optional[torch.dtype] = None,
    style_layers: str = "last",
) -> Callable[[torch.Tensor], tuple]:
    """Content+style extraction, one encoder pass: ``images (B, H, W, 3) ->
    (feats, [style Grams])``. ``style_layers="last"``: one Gram of the
    features; ``"all"``: one per executed ResNet stage, from
    ``resnet50_apply(..., collect_grams=True)`` (four at truncate 8). Every
    Gram is ``GramFunction``'s, so on the card each one launches
    ``gram_fwd`` and, under a gradient, ``gram_bwd``. In bf16 the encoder is
    a bf16 copy of the model's and the Grams come out in bf16 (f32 sums).
    The encoder is frozen: its parameters stop requiring gradients, so a
    gradient through it (the loops' pixels, the fast-style net) computes no
    weight gradient. ``extract_fn.features(images)`` gives the features
    alone, with no Gram taken."""
    from ..nn.resnet import resnet50_apply

    if style_layers not in ("last", "all"):
        raise ValueError(f"style_layers must be 'last' or 'all', got {style_layers!r}")
    truncate = min(layers if layers is not None else truncate_layer, truncate_layer, 8)
    enc = _encoder_in(model, compute_dtype).requires_grad_(False)

    def encode(images, collect_grams: bool):
        if compute_dtype is not None:
            images = images.to(compute_dtype)
        return resnet50_apply(enc, images, truncate=truncate, collect_grams=collect_grams)

    def extract_fn(images):
        feats, grams = encode(images, style_layers == "all")
        if style_layers != "all" or not grams:
            grams = [gram_matrix_nhwc(feats)]
        return feats, grams

    extract_fn.features = lambda images: encode(images, False)[0]
    return extract_fn


def make_gram_fn_gram_attention(
    model,
    truncate_layer: int = 8,
    layers: Optional[int] = None,
    compute_dtype: Optional[torch.dtype] = None,
) -> Callable[[torch.Tensor], List[torch.Tensor]]:
    """Per-image target-Gram program: truncated encoder features -> one
    (C, C) Gram per image, in the encoder's dtype."""
    feature_fn = make_feature_fn_gram_attention(model, truncate_layer, layers, compute_dtype)

    def gram_fn(images):
        return [gram_matrix_nhwc(feature_fn(images))]

    return gram_fn


def total_variation(pixels: torch.Tensor) -> torch.Tensor:
    """Per-image anisotropic total variation, ``(B, H, W, C) -> (B,)``: the
    mean squared difference of vertically adjacent pixels plus that of
    horizontally adjacent ones, in f32."""
    p = pixels.float()
    dh = torch.square(p[:, 1:, :, :] - p[:, :-1, :, :])
    dw = torch.square(p[:, :, 1:, :] - p[:, :, :-1, :])
    return dh.mean(dim=(1, 2, 3)) + dw.mean(dim=(1, 2, 3))


def make_per_image_content_style_loss(
    extract_fn: Callable,
    style_weight: float = 1.0,
    content_weight: float = 1.0,
    tv_weight: float = 0.0,
) -> Callable:
    """``loss(pixels, style_grams, content_feats) -> (B,)`` =
    ``style_weight * sum_l MSE(gram_l, style_gram_l) + content_weight *
    MSE(feats, content_feats) [+ tv_weight * TV(pixels)]``, every term in
    f32, from one ``extract_fn`` pass."""
    sw, cw, tw = float(style_weight), float(content_weight), float(tv_weight)

    def per_image_loss(pixels, style_grams, content_feats):
        feats, grams = extract_fn(pixels)
        style = 0.0
        for g, t in zip(grams, style_grams):
            style = style + torch.mean(torch.square(g.float() - t.float()),
                                       dim=tuple(range(1, g.dim())))
        content = torch.mean(torch.square(feats.float() - content_feats.float()),
                             dim=tuple(range(1, feats.dim())))
        loss = sw * style + cw * content
        if tw != 0.0:
            loss = loss + tw * total_variation(pixels)
        return loss

    return per_image_loss


def make_content_style_optimizer(
    extract_fn: Callable,
    style_weight: float = 1.0,
    content_weight: float = 1.0,
    learning_rate: float = 0.01,
    num_iterations: int = 500,
    threshold: float = 1e-4,
    tv_weight: float = 0.0,
):
    """Classic content+style transfer (Gatys et al.), batched like the
    texture loop: ``run(pixels0, style_grams, content_feats, history=None)
    -> (pixels, iterations_run, final_per_image_loss)``, ``_masked_adam`` on
    ``make_per_image_content_style_loss``'s loss, so the same per-image
    early stop, iteration cap and frozen converged images."""
    per_image_loss = make_per_image_content_style_loss(extract_fn, style_weight,
                                                       content_weight, tv_weight)

    def run(pixels0: torch.Tensor, style_grams: Sequence[torch.Tensor],
            content_feats: torch.Tensor, history: Optional[list] = None):
        return _masked_adam(lambda p: per_image_loss(p, style_grams, content_feats), pixels0,
                            learning_rate, num_iterations, threshold, history)

    return run


def make_gram_fn_patches(
    model,
    gram_matrix_dim: int,
    norm: str = "batch",
    compute_dtype: Optional[torch.dtype] = None,
) -> Callable[[torch.Tensor], List[torch.Tensor]]:
    """Family-3 per-image target-Gram program: the embedding e (B, ndf) of
    ``multiscale_test_apply``, then outer(e, e) / ndf per image as one f32
    (B, ndf, ndf) Gram. The product is a plain one outside any kernel; it
    accumulates in f32 for f32 operands and rounds to the embedding's dtype
    for bf16 ones, as the JAX einsum's preferred type does. In bf16 the
    discriminators are a bf16 copy of the model's (weights and running
    statistics, as the JAX policy casts them), made once."""
    from ..models.multi_patchgan import multiscale_test_apply

    if compute_dtype is not None:
        model = copy.deepcopy(model).to(compute_dtype)

    def gram_fn(images):
        if compute_dtype is not None:
            images = images.to(compute_dtype)
        emb, _, _ = multiscale_test_apply(model, images, gram_matrix_dim, norm)
        g = torch.einsum("bi,bj->bij", emb, emb)
        return [g.float() / emb.shape[-1]]

    return gram_fn


def denormalize_to_uint8(img_nhwc: np.ndarray) -> np.ndarray:
    """Invert the ImageNet normalisation and clamp to [0, 1] (a float image,
    despite the reference's name)."""
    img = np.asarray(img_nhwc, dtype=np.float32) * IMAGENET_STD + IMAGENET_MEAN
    return np.clip(img, 0.0, 1.0)


def _save_side_by_side(original: np.ndarray, stylised: np.ndarray, path: str) -> None:
    """[original | stylised] as RGBA with an opaque alpha, the file that
    matplotlib's ``imsave`` writes for a float RGB image."""
    rgb = float_to_uint8(np.hstack((original, stylised)))
    write_png(path, np.concatenate([rgb, np.full(rgb.shape[:2] + (1,), 255, np.uint8)], axis=-1))


def style_transfer_gram_attention(
    model,
    loader,
    save_dir: str,
    *,
    layers: Optional[int] = None,
    threshold: float = 1e-4,
    num_iterations: int = 500,
    learning_rate: float = 0.01,
    truncate_layer: int = 8,
    generator: Optional[torch.Generator] = None,
    log_fn=print,
    compute_dtype: Optional[torch.dtype] = None,
    history: Optional[list] = None,
) -> List[str]:
    """Family-2 style transfer over any iterable of ``HostLoader`` batches;
    returns the saved paths. Noise comes from ``generator`` (a CPU
    ``torch.Generator``; JAX's ``jax.random`` noise cannot be reproduced).
    ``history``, when a list, receives one list of per-iteration losses per
    batch."""
    from ..data.augment import eval_preprocess

    device = next(model.parameters()).device
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    gram_fn = make_gram_fn_gram_attention(model, truncate_layer, layers, compute_dtype)
    optimise = make_style_transfer_optimizer(gram_fn, learning_rate, num_iterations, threshold)

    out_dir = os.path.join(save_dir, f"style_transfer_{datetime.now().strftime('%Y-%m-%d')}")
    os.makedirs(out_dir, exist_ok=True)

    saved = []
    img_counter = 0
    for batch in loader:
        n = batch["n_valid"]
        images = eval_preprocess(torch.from_numpy(np.asarray(batch["image"])).to(device))
        with torch.no_grad():
            targets = gram_fn(images)
        noise0 = torch.randn(images.shape, generator=generator, dtype=torch.float32)
        trace = [] if history is not None else None
        noise, iters, per_loss = optimise(noise0.to(device), targets, trace)
        if history is not None:
            history.append(trace)
        log_fn(
            f"Batch optimised in {iters} iterations, "
            f"final losses: {per_loss.cpu().numpy()[:n].round(6).tolist()}"
        )
        noise = noise.cpu().numpy()
        originals = images.cpu().numpy()
        for j in range(n):
            label = int(batch["label"][j])
            path = os.path.join(out_dir, str(label), f"style_transfer_{img_counter}.png")
            _save_side_by_side(denormalize_to_uint8(originals[j]),
                               denormalize_to_uint8(noise[j]), path)
            saved.append(path)
            log_fn(f"Style transferred for image {img_counter}, saved to {path}")
            img_counter += 1
    return saved


def content_style_transfer_gram_attention(
    model,
    loader,
    style_image_u8: np.ndarray,
    save_dir: str,
    *,
    layers: Optional[int] = None,
    truncate_layer: int = 8,
    style_weight: float = 1.0,
    content_weight: float = 1.0,
    tv_weight: float = 0.0,
    style_layers: str = "last",
    threshold: float = 1e-4,
    num_iterations: int = 500,
    learning_rate: float = 0.01,
    init: str = "content",
    generator: Optional[torch.Generator] = None,
    log_fn=print,
    compute_dtype: Optional[torch.dtype] = None,
    history: Optional[list] = None,
) -> List[str]:
    """Content+style transfer over any iterable of ``HostLoader`` batches:
    every content image re-rendered in the style of the one staged uint8
    ``style_image_u8``. ``init="content"`` starts the pixels at the content
    image; ``"noise"`` from normal noise drawn from ``generator`` (a CPU
    ``torch.Generator``; JAX's ``jax.random`` noise cannot be reproduced).
    Writes [content | stylised] RGBA PNGs as
    ``style_transfer_<date>/<label>/content_style_<i>.png`` and returns
    their paths; ``history``, when a list, receives one list of
    per-iteration losses per batch."""
    from ..data.augment import eval_preprocess

    if init not in ("content", "noise"):
        raise ValueError(f"init must be 'content' or 'noise', got {init!r}")
    device = next(model.parameters()).device
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    extract_fn = make_extract_fn_gram_attention(model, truncate_layer, layers, compute_dtype,
                                                style_layers)
    optimise = make_content_style_optimizer(extract_fn, style_weight, content_weight,
                                            learning_rate, num_iterations, threshold,
                                            tv_weight=tv_weight)
    with torch.no_grad():
        style_pre = eval_preprocess(torch.tensor(np.asarray(style_image_u8))[None].to(device))
        style_grams = [g[0] for g in extract_fn(style_pre)[1]]

    out_dir = os.path.join(save_dir, f"style_transfer_{datetime.now().strftime('%Y-%m-%d')}")
    os.makedirs(out_dir, exist_ok=True)

    saved = []
    img_counter = 0
    for batch in loader:
        n = batch["n_valid"]
        images = eval_preprocess(torch.from_numpy(np.asarray(batch["image"])).to(device))
        with torch.no_grad():
            content_feats = extract_fn(images)[0].float()
        grams = [g.expand((images.shape[0],) + tuple(g.shape)) for g in style_grams]
        if init == "content":
            pixels0 = images.float()
        else:
            pixels0 = torch.randn(images.shape, generator=generator,
                                  dtype=torch.float32).to(device)
        trace = [] if history is not None else None
        pixels, iters, per_loss = optimise(pixels0, grams, content_feats, trace)
        if history is not None:
            history.append(trace)
        log_fn(
            f"Batch optimised in {iters} iterations, "
            f"final losses: {per_loss.cpu().numpy()[:n].round(6).tolist()}"
        )
        pixels = pixels.cpu().numpy()
        originals = images.cpu().numpy()
        for j in range(n):
            label = int(batch["label"][j])
            path = os.path.join(out_dir, str(label), f"content_style_{img_counter}.png")
            _save_side_by_side(denormalize_to_uint8(originals[j]),
                               denormalize_to_uint8(pixels[j]), path)
            saved.append(path)
            log_fn(f"Content+style transferred for image {img_counter}, saved to {path}")
            img_counter += 1
    return saved


def style_transfer_patches(
    model,
    loader,
    save_dir: str,
    *,
    gram_matrix_dim: int,
    norm: str = "batch",
    layers: Optional[int] = None,
    threshold: float = 1e-4,
    num_iterations: int = 500,
    learning_rate: float = 0.01,
    max_images: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    log_fn=print,
    compute_dtype: Optional[torch.dtype] = None,
    history: Optional[list] = None,
) -> List[str]:
    """Family-3 style transfer over the embedding's outer-product Grams
    (the reference's ``functions_Multi_PatchGAN.py:211-306``, its working
    ``layers=None`` path; its layers slicing crashes upstream and is
    rejected). Noise comes from ``generator`` (a CPU ``torch.Generator``;
    JAX's ``jax.random`` noise cannot be reproduced). ``history``, when a
    list, receives one list of per-iteration losses per batch. Returns the
    saved paths, ``style_transfer_<date>/<label>/style_transfer_<label>_<n>_<ms>.png``."""
    from ..data.augment import eval_preprocess

    if layers is not None:
        raise ValueError(
            "The reference's --layers truncation for PatchGAN style transfer is "
            "non-functional upstream (nn.Sequential over a ModuleDict, "
            "functions_Multi_PatchGAN.py:242); run without --layers."
        )
    device = next(model.parameters()).device
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    gram_fn = make_gram_fn_patches(model, gram_matrix_dim, norm, compute_dtype)
    optimise = make_style_transfer_optimizer(gram_fn, learning_rate, num_iterations, threshold)

    out_dir = os.path.join(save_dir, f"style_transfer_{datetime.now().strftime('%Y-%m-%d')}")
    os.makedirs(out_dir, exist_ok=True)

    saved = []
    img_counter = 0
    for batch in loader:
        n = batch["n_valid"]
        if max_images is not None:
            n = min(n, max_images - img_counter)
            if n <= 0:
                log_fn(f"Maximum number of images ({max_images}) reached.")
                return saved
        images = eval_preprocess(torch.from_numpy(np.asarray(batch["image"])).to(device))
        with torch.no_grad():
            targets = gram_fn(images)
        noise0 = torch.randn(images.shape, generator=generator, dtype=torch.float32)
        trace = [] if history is not None else None
        noise, _, _ = optimise(noise0.to(device), targets, trace)
        if history is not None:
            history.append(trace)
        noise = noise.cpu().numpy()
        originals = images.cpu().numpy()
        for j in range(n):
            label = int(batch["label"][j])
            timestamp = int(time.time() * 1000)
            path = os.path.join(out_dir, str(label),
                                f"style_transfer_{label}_{img_counter}_{timestamp}.png")
            _save_side_by_side(denormalize_to_uint8(originals[j]),
                               denormalize_to_uint8(noise[j]), path)
            saved.append(path)
            img_counter += 1
        if max_images is not None and img_counter >= max_images:
            log_fn(f"Maximum number of images ({max_images}) reached.")
            return saved
    return saved
