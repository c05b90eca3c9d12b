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

``mesh=`` (``--devices N``): each rank optimises its rows of every batch
(its loader's ``rows``) from its rows of the global batch's noise, and the
loop ends on the global ``any(active)`` (``Mesh.any``, one tiny collective
beside the host sync each iteration has), as JAX's ``while_loop`` over the
sharded batch does: an image that stopped keeps its pixels either way, but
its reported loss is read again at them while any image of the batch, on
any rank, is active. Rank 0 gathers the pixels and writes the PNGs.
"""
from __future__ import annotations

import copy
import functools
import os
import time
from datetime import datetime
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.functional import call_with
from ..ops.gram import gram_matrix_nhwc
from ..ops.resize import IMAGENET_MEAN, IMAGENET_STD
from ..utils.debug import check_nan
from ..utils.png import float_to_uint8, write_png

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def bias_corrections(count: int, dtype: torch.dtype = torch.float32
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Adam's bias corrections at step ``count``, ``1 - b1 ** count`` and
    ``1 - b2 ** count`` in double, as 0-d CPU tensors of the pixels'
    ``dtype``: an op takes a CPU scalar tensor as it takes a Python float,
    so the step divides as it always has, and an exported step takes them
    as inputs."""
    return (torch.tensor(1 - ADAM_B1 ** count, dtype=dtype),
            torch.tensor(1 - ADAM_B2 ** count, dtype=dtype))


def masked_adam_step(per_image_loss: Callable[..., torch.Tensor], learning_rate: float,
                     threshold: float, pixels: torch.Tensor, mu: torch.Tensor,
                     nu: torch.Tensor, active: torch.Tensor, bc1: torch.Tensor,
                     bc2: torch.Tensor, *loss_args: torch.Tensor):
    """One iteration of the masked Adam loop (``drive_masked_adam``) on
    ``per_image_loss(pixels, *loss_args) -> (B,)``: returns (pixels, mu,
    nu, active, per-image loss), all new tensors. Bound to its first three
    arguments (``functools.partial``) it is the loop's step. The loss's
    gradient is ``torch.autograd.grad`` of the active images' sum,
    so an exported step (``deploy/artifact.py``) holds the backward too.
    Written out to optax's ``adam`` formulas (b1 0.9, b2 0.999, eps 1e-8
    outside the square root, moments divided by the bias corrections
    ``bc1``, ``bc2``). The loss of an inactive image is masked out of the
    sum, so its gradient is zero, but its moments still update, exactly as
    optax's state does in the JAX loop; only the pixel update is masked,
    so a converged image stays bit-exactly where it froze
    (``torch.optim.Adam`` would move it on its momentum). The threshold
    check comes after the step, as in the reference."""
    b = pixels.shape[0]
    with torch.enable_grad():
        x = pixels.detach().requires_grad_(True)
        per = per_image_loss(x, *loss_args)
        (grad,) = torch.autograd.grad((per * active.to(per.dtype)).sum(), x)
    per = per.detach()
    mu = mu.mul(ADAM_B1).add(grad, alpha=1 - ADAM_B1)
    nu = nu.mul(ADAM_B2).addcmul(grad, grad, value=1 - ADAM_B2)
    update = (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS) * (-learning_rate)
    mask = active.view((b,) + (1,) * (pixels.dim() - 1))
    return pixels + update * mask, mu, nu, active & (per >= threshold), per


def drive_masked_adam(step: Callable, pixels0: torch.Tensor, num_iterations: int,
                      history: Optional[list] = None, mesh=None):
    """The batched Adam-on-pixels loop: ``step(pixels, mu, nu, active, bc1,
    bc2) -> (pixels, mu, nu, active, per)`` (``masked_adam_step`` bound to
    its loss, or an exported step) while fewer than ``num_iterations``
    iterations ran and an image is active; returns (final_pixels,
    iterations_run, final_per_image_loss). Pixels and moments are f32
    whatever the model's dtype (f64 stays f64). ``history``, when a list,
    receives each iteration's per-image losses (device tensors). On a
    data-parallel ``mesh`` ``pixels0`` is this rank's rows and an image is
    active if any rank's is (``Mesh.any``)."""
    (pixels,), i, (per,) = drive_masked_adam_blocks(
        [step], [pixels0], num_iterations, history, mesh)
    return pixels, i, per


def drive_masked_adam_blocks(steps: Sequence[Callable], pixels0: Sequence[torch.Tensor],
                             num_iterations: int, history: Optional[list] = None, mesh=None):
    """``drive_masked_adam`` over blocks of one batch, each with its own
    step (a server's replicas, ``core.mesh.DeviceGroup``, a block a
    device): every iteration steps each block, and the loop goes on while
    an image of any block (on a data-parallel ``mesh``, of any rank) is
    active, so each block runs the batch's iteration count. Returns
    ([final pixels a block], iterations_run, [final per-image loss a
    block]); ``history`` receives each iteration's losses of the first
    block."""
    from ..core.mesh import data_parallel

    dp = data_parallel(mesh)
    state = []
    for p0 in pixels0:
        pixels = p0.detach().to(torch.float64 if p0.dtype == torch.float64
                                else torch.float32).clone()
        b = pixels.shape[0]
        state.append([pixels, torch.zeros_like(pixels), torch.zeros_like(pixels),
                      torch.ones((b,), dtype=torch.bool, device=pixels.device),
                      torch.full((b,), float("inf"), device=pixels.device,
                                 dtype=pixels.dtype)])

    def any_active() -> bool:
        local = any(bool(s[3].any()) for s in state)
        return dp.any(local) if dp is not None else local

    i = 0
    # One host sync per iteration for the exit test; capturing the step
    # in a CUDA graph and testing less often is the place to win it back.
    while i < num_iterations and any_active():
        for step, s in zip(steps, state):
            s[:] = step(*s[:4], *bias_corrections(i + 1, s[0].dtype))
            check_nan("the style loop's loss", s[4])  # reads it under --debug_nans only
        if history is not None:
            history.append(state[0][4])
        i += 1
    return [s[0] for s in state], i, [s[4] for s in state]


def make_style_transfer_optimizer(
    gram_fn: Callable[[torch.Tensor], Sequence[torch.Tensor]],
    learning_rate: float = 0.01,
    num_iterations: int = 500,
    threshold: float = 1e-4,
    mesh=None,
):
    """Build the batched texture optimiser ``run(noise0, targets,
    history=None) -> (final_noise, iterations_run, final_per_image_loss)``:
    the masked Adam loop on ``make_per_image_gram_loss``'s loss. On a
    data-parallel ``mesh`` each rank runs its rows and the loop ends on the
    global ``any(active)``."""
    per_image_loss = make_per_image_gram_loss(gram_fn)

    def run(noise0: torch.Tensor, targets: Sequence[torch.Tensor],
            history: Optional[list] = None):
        return drive_masked_adam(
            functools.partial(masked_adam_step, lambda x: per_image_loss(x, *targets),
                              learning_rate, threshold), noise0, num_iterations, history,
            mesh)

    return run


def make_per_image_gram_loss(gram_fn: Callable[[torch.Tensor], Sequence[torch.Tensor]]):
    """The texture loss ``loss(noise, *targets) -> (B,)``: per image, the
    sum over layers of the MSE between ``gram_fn(noise)`` (a list of
    per-image Grams, batch first) and the targets."""

    def per_image_loss(noise, *targets):
        total = 0.0
        for g, t in zip(gram_fn(noise), targets):
            dims = tuple(range(1, g.dim()))
            total = total + torch.mean(torch.square(g.float() - t.float()), dim=dims)
        return total  # (B,)

    return per_image_loss


def _encoder_in(model, compute_dtype: Optional[torch.dtype]):
    """The family-2 model's encoder, or a bf16 copy of it (weights and
    running statistics, as the JAX policy casts them), made once."""
    enc = model.encoder
    return copy.deepcopy(enc).to(compute_dtype) if compute_dtype is not None else enc


def _int8_encoder(enc, compute_dtype: Optional[torch.dtype], truncate: int):
    """``weights_int8`` (JAX ``_quantize_conv_kernels``,
    ``_dequantize_conv_kernels``, ``:132-165``): each 4-D conv weight of
    ``enc`` (already in the compute dtype, as JAX quantises the cast tree)
    quantised by ``nn/resnet_int8._quantize_kernel`` on its HWIO view, so
    the int8 values and per-output-channel f32 scales are JAX's. Returns
    ``(stored, quantised, dequantise)``: a copy of ``enc`` whose conv
    weights are empty placeholders (batch-norm and 1-D leaves kept), the
    ``{name: (int8 OIHW, scale)}`` weights, and ``dequantise()`` the conv
    weights of the children that ``truncate`` runs (the ones XLA keeps of
    JAX's dequantised tree), int8 * scale in the compute dtype, made anew
    at each call and handed to ``core.functional.call_with``: no
    dequantised copy is kept."""
    from ..nn.resnet import _STAGES
    from ..nn.resnet_int8 import _quantize_kernel

    run = {"conv1"} | {name for i, (name, _, _, _) in enumerate(_STAGES) if truncate > 4 + i}

    quantised, memo = {}, {}
    for name, w in enc.named_parameters():
        if w.dim() != 4:
            continue
        hwio = w.detach().float().cpu().numpy().transpose(2, 3, 1, 0)
        q, scale = _quantize_kernel(hwio)
        quantised[name] = (  # OIHW stored channels_last, as the port's conv weights are
            torch.from_numpy(q.transpose(3, 2, 0, 1)).to(w.device).contiguous(
                memory_format=torch.channels_last),
            torch.from_numpy(scale).to(w.device))
        memo[id(w)] = torch.nn.Parameter(w.new_empty(0), requires_grad=False)
    stored = copy.deepcopy(enc, memo).requires_grad_(False)

    def dequantise():
        out = {}
        for name, (q, scale) in quantised.items():
            if name.split(".")[0] not in run:
                continue
            k = q.float() * scale[:, None, None, None]
            out[name] = k.to(compute_dtype) if compute_dtype is not None else k
        return out

    return stored, quantised, dequantise


def _encoder_runner(model, truncate: int, compute_dtype: Optional[torch.dtype], remat: bool,
                    weights_int8: bool, frozen: bool = False):
    """``run(images, collect_grams) -> (feats, grams)`` over the family-2
    encoder (a bf16 copy in bf16), or over its ``weights_int8`` form."""
    from ..nn.resnet import resnet50_apply

    enc = _encoder_in(model, compute_dtype)
    if frozen:
        enc = enc.requires_grad_(False)

    def cast(images):
        return images.to(compute_dtype) if compute_dtype is not None else images

    if not weights_int8:
        def run(images, collect_grams: bool):
            return resnet50_apply(enc, cast(images), truncate=truncate,
                                  collect_grams=collect_grams, remat=remat)

        return run
    stored, quantised, dequantise = _int8_encoder(enc, compute_dtype, truncate)

    def run_int8(images, collect_grams: bool):
        return call_with(stored, dequantise(), resnet50_apply, cast(images), truncate,
                         collect_grams, None, remat)

    run_int8.quantised = quantised
    return run_int8


def make_feature_fn_gram_attention(
    model,
    truncate_layer: int = 8,
    layers: Optional[int] = None,
    compute_dtype: Optional[torch.dtype] = None,
    remat: bool = False,
    weights_int8: bool = False,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Truncated-encoder features ``images (B, H, W, 3) -> (B, h, w, C)``.
    ``layers`` truncates the encoder's child list like the reference's
    Sequential slice. In bf16 the encoder is a bf16 copy of the model's.
    ``remat`` checkpoints each bottleneck: the loop's backward recomputes
    the blocks' insides instead of keeping them (JAX ``:165-211``).

    ``weights_int8`` (JAX ``:167-211``): the conv weights are stored as
    per-output-channel int8 and an f32 scale and dequantised inside each
    call (``_int8_encoder``). The loop optimises pixels only, so the
    dequantised convs pass exact pixel gradients; the features move by the
    weights' rounding (about 1e-3 relative), so a quantised loop runs
    against its own targets. ``feature_fn.quantised`` holds the
    ``{name: (int8 OIHW, scale)}`` weights. No CLI reaches it, as in JAX."""
    truncate = min(layers if layers is not None else truncate_layer, truncate_layer, 8)
    run = _encoder_runner(model, truncate, compute_dtype, remat, weights_int8)

    def feature_fn(images):
        return run(images, False)[0]

    feature_fn.quantised = getattr(run, "quantised", None)
    return feature_fn


def make_extract_fn_gram_attention(
    model,
    truncate_layer: int = 8,
    layers: Optional[int] = None,
    compute_dtype: Optional[torch.dtype] = None,
    style_layers: str = "last",
    remat: bool = False,
    weights_int8: bool = False,
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
    alone, with no Gram taken. ``remat`` checkpoints each bottleneck;
    ``weights_int8`` as in ``make_feature_fn_gram_attention``."""
    if style_layers not in ("last", "all"):
        raise ValueError(f"style_layers must be 'last' or 'all', got {style_layers!r}")
    truncate = min(layers if layers is not None else truncate_layer, truncate_layer, 8)
    encode = _encoder_runner(model, truncate, compute_dtype, remat, weights_int8, frozen=True)

    def extract_fn(images):
        feats, grams = encode(images, style_layers == "all")
        if style_layers != "all" or not grams:
            grams = [gram_matrix_nhwc(feats)]
        return feats, grams

    extract_fn.features = lambda images: encode(images, False)[0]
    extract_fn.quantised = getattr(encode, "quantised", None)
    return extract_fn


def make_gram_fn_gram_attention(
    model,
    truncate_layer: int = 8,
    layers: Optional[int] = None,
    compute_dtype: Optional[torch.dtype] = None,
    remat: bool = False,
    weights_int8: bool = False,
) -> Callable[[torch.Tensor], List[torch.Tensor]]:
    """Per-image target-Gram program: truncated encoder features -> one
    (C, C) Gram per image, in the encoder's dtype; ``remat`` checkpoints
    each bottleneck; ``weights_int8`` as in
    ``make_feature_fn_gram_attention``."""
    feature_fn = make_feature_fn_gram_attention(model, truncate_layer, layers, compute_dtype,
                                                remat, weights_int8)

    def gram_fn(images):
        return [gram_matrix_nhwc(feature_fn(images))]

    gram_fn.quantised = feature_fn.quantised
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
    mesh=None,
):
    """Classic content+style transfer (Gatys et al.), batched like the
    texture loop: ``run(pixels0, style_grams, content_feats, history=None)
    -> (pixels, iterations_run, final_per_image_loss)``, the masked Adam
    loop on ``make_per_image_content_style_loss``'s loss, so the same
    per-image early stop, iteration cap and frozen converged images (and
    the same ``mesh=``)."""
    per_image_loss = make_per_image_content_style_loss(extract_fn, style_weight,
                                                       content_weight, tv_weight)

    def run(pixels0: torch.Tensor, style_grams: Sequence[torch.Tensor],
            content_feats: torch.Tensor, history: Optional[list] = None):
        return drive_masked_adam(
            functools.partial(masked_adam_step,
                              lambda p: per_image_loss(p, style_grams, content_feats),
                              learning_rate, threshold), pixels0, num_iterations, history,
            mesh)

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


def _batch_noise(generator: torch.Generator, images: torch.Tensor, mesh) -> torch.Tensor:
    """The batch's starting noise: drawn at the global batch's shape (the
    one-device draw), and on a data-parallel ``mesh`` cut to this rank's
    rows of it."""
    from ..core.mesh import data_parallel

    dp = data_parallel(mesh)
    shape = (images.shape[0] * (dp.world_size if dp is not None else 1),) + tuple(images.shape[1:])
    noise = torch.randn(shape, generator=generator, dtype=torch.float32)
    return noise if dp is None else dp.local(noise)


def _valid_rows(mesh, batch: dict, *parts) -> list:
    """The batch's valid rows of each part, then of its labels, as numpy:
    on a data-parallel ``mesh`` every rank's rows, gathered in the
    one-device order (``core.mesh.gather_valid``)."""
    from ..core.mesh import gather_valid

    return gather_valid(mesh, list(parts) + [np.asarray(batch["label"])], batch["n_valid"])


def _out_dir(save_dir: str, main: bool) -> str:
    out_dir = os.path.join(save_dir, f"style_transfer_{datetime.now().strftime('%Y-%m-%d')}")
    if main:
        os.makedirs(out_dir, exist_ok=True)
    return out_dir


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
    remat: bool = False,
    mesh=None,
) -> List[str]:
    """Family-2 style transfer over any iterable of ``HostLoader`` batches;
    returns the saved paths. Noise comes from ``generator`` (a CPU
    ``torch.Generator``; JAX's ``jax.random`` noise cannot be reproduced).
    ``history``, when a list, receives one list of per-iteration losses per
    batch. ``remat`` checkpoints each bottleneck of the encoder. On a
    data-parallel ``mesh`` the loader holds this rank's rows (module
    docstring); every rank returns the paths rank 0 wrote."""
    from ..data.augment import eval_preprocess

    device = next(model.parameters()).device
    main = mesh is None or mesh.is_main
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    gram_fn = make_gram_fn_gram_attention(model, truncate_layer, layers, compute_dtype, remat)
    optimise = make_style_transfer_optimizer(gram_fn, learning_rate, num_iterations, threshold,
                                             mesh=mesh)
    out_dir = _out_dir(save_dir, main)

    saved = []
    img_counter = 0
    for batch in loader:
        n = batch["n_valid"]
        images = eval_preprocess(torch.from_numpy(np.asarray(batch["image"])).to(device))
        with torch.no_grad():
            targets = gram_fn(images)
        noise0 = _batch_noise(generator, images, mesh)
        trace = [] if history is not None else None
        noise, iters, per_loss = optimise(noise0.to(device), targets, trace)
        if history is not None:
            history.append(trace)
        noise, originals, per_loss, labels = _valid_rows(mesh, batch, noise, images, per_loss)
        log_fn(
            f"Batch optimised in {iters} iterations, "
            f"final losses: {per_loss.round(6).tolist()}"
        )
        for j in range(n):
            label = int(labels[j])
            path = os.path.join(out_dir, str(label), f"style_transfer_{img_counter}.png")
            if main:
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
    remat: bool = False,
    mesh=None,
) -> List[str]:
    """Content+style transfer over any iterable of ``HostLoader`` batches:
    every content image re-rendered in the style of the one staged uint8
    ``style_image_u8``. ``init="content"`` starts the pixels at the content
    image; ``"noise"`` from normal noise drawn from ``generator`` (a CPU
    ``torch.Generator``; JAX's ``jax.random`` noise cannot be reproduced).
    Writes [content | stylised] RGBA PNGs as
    ``style_transfer_<date>/<label>/content_style_<i>.png`` and returns
    their paths; ``history``, when a list, receives one list of
    per-iteration losses per batch. ``remat`` checkpoints each bottleneck
    of the encoder. ``mesh`` as in ``style_transfer_gram_attention``."""
    from ..data.augment import eval_preprocess

    if init not in ("content", "noise"):
        raise ValueError(f"init must be 'content' or 'noise', got {init!r}")
    device = next(model.parameters()).device
    main = mesh is None or mesh.is_main
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    extract_fn = make_extract_fn_gram_attention(model, truncate_layer, layers, compute_dtype,
                                                style_layers, remat)
    optimise = make_content_style_optimizer(extract_fn, style_weight, content_weight,
                                            learning_rate, num_iterations, threshold,
                                            tv_weight=tv_weight, mesh=mesh)
    with torch.no_grad():
        style_pre = eval_preprocess(torch.tensor(np.asarray(style_image_u8))[None].to(device))
        style_grams = [g[0] for g in extract_fn(style_pre)[1]]

    out_dir = _out_dir(save_dir, main)

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
            pixels0 = _batch_noise(generator, images, mesh).to(device)
        trace = [] if history is not None else None
        pixels, iters, per_loss = optimise(pixels0, grams, content_feats, trace)
        if history is not None:
            history.append(trace)
        pixels, originals, per_loss, labels = _valid_rows(mesh, batch, pixels, images, per_loss)
        log_fn(
            f"Batch optimised in {iters} iterations, "
            f"final losses: {per_loss.round(6).tolist()}"
        )
        for j in range(n):
            label = int(labels[j])
            path = os.path.join(out_dir, str(label), f"content_style_{img_counter}.png")
            if main:
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
    mesh=None,
) -> List[str]:
    """Family-3 style transfer over the embedding's outer-product Grams
    (the reference's ``functions_Multi_PatchGAN.py:211-306``, its working
    ``layers=None`` path; its layers slicing crashes upstream and is
    rejected). Noise comes from ``generator`` (a CPU ``torch.Generator``;
    JAX's ``jax.random`` noise cannot be reproduced). ``history``, when a
    list, receives one list of per-iteration losses per batch. Returns the
    saved paths, ``style_transfer_<date>/<label>/style_transfer_<label>_<n>_<ms>.png``.
    ``mesh`` as in ``style_transfer_gram_attention`` (the CLI's loader is
    b1, which no mesh splits: it runs one device there, as JAX's clamp
    does)."""
    from ..data.augment import eval_preprocess

    if layers is not None:
        raise ValueError(
            "The reference's --layers truncation for PatchGAN style transfer is "
            "non-functional upstream (nn.Sequential over a ModuleDict, "
            "functions_Multi_PatchGAN.py:242); run without --layers."
        )
    device = next(model.parameters()).device
    main = mesh is None or mesh.is_main
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    gram_fn = make_gram_fn_patches(model, gram_matrix_dim, norm, compute_dtype)
    optimise = make_style_transfer_optimizer(gram_fn, learning_rate, num_iterations, threshold,
                                             mesh=mesh)
    out_dir = _out_dir(save_dir, main)

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
        noise0 = _batch_noise(generator, images, mesh)
        trace = [] if history is not None else None
        noise, _, _ = optimise(noise0.to(device), targets, trace)
        if history is not None:
            history.append(trace)
        noise, originals, labels = _valid_rows(mesh, batch, noise, images)
        for j in range(n):
            label = int(labels[j])
            timestamp = int(time.time() * 1000)
            path = os.path.join(out_dir, str(label),
                                f"style_transfer_{label}_{img_counter}_{timestamp}.png")
            if main:
                _save_side_by_side(denormalize_to_uint8(originals[j]),
                                   denormalize_to_uint8(noise[j]), path)
            saved.append(path)
            img_counter += 1
        if max_images is not None and img_counter >= max_images:
            log_fn(f"Maximum number of images ({max_images}) reached.")
            return saved
    return saved
