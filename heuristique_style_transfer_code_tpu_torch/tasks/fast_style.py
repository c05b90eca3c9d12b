"""Fast (feed-forward) style transfer, serving half (``tasks/fast_style.py:
594-636,798-828`` of the JAX package): one net forward per image.

``make_stylize_fn`` is the serving program ``uint8 (B, H, W, 3) -> stylised
uint8``; ``make_net_job_fn`` adapts it to ``StyleTransferService``'s job
contract. On the card every instance norm of the forward is the
hand-written ``instance_norm_fwd`` kernel; there is no backend option.
Training the net (``make_fast_style_train_step``, ``train_fast_style``,
``train_multi_style``) is not ported yet and raises.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from ..checkpoint.convert import load_jax_tree
from ..data.augment import eval_preprocess
from ..nn.transformer_net import (
    TransformerNet,
    net_n_styles,
    transformer_net_apply,
    transformer_net_init,
)
from ..ops.resize import IMAGENET_MEAN, IMAGENET_STD


def net_from_tree(tree: Any, device) -> TransformerNet:
    """A JAX-layout net tree (``style_net.npz``) -> the port's net on
    ``device``; width, depth and style count come from the tree's shapes."""
    scale = np.asarray(tree["in1"]["scale"])
    net = transformer_net_init(
        None, width=int(np.shape(tree["conv1"]["kernel"])[-1]), n_res=len(tree["res"]),
        n_styles=int(scale.shape[0]) if scale.ndim == 2 else None, device=device,
    )
    return load_jax_tree(net, tree)


def _stylize_body(net: TransformerNet, images_u8: torch.Tensor, crop: int,
                  compute_dtype: Optional[torch.dtype], style_weights=None) -> torch.Tensor:
    """uint8 staged crops -> stylised uint8 (round half to even, as
    ``jnp.round``)."""
    mean = torch.as_tensor(IMAGENET_MEAN, device=images_u8.device)
    std = torch.as_tensor(IMAGENET_STD, device=images_u8.device)
    images = eval_preprocess(images_u8, crop)
    out = transformer_net_apply(net, images, compute_dtype, style_weights)
    canvas = torch.clamp(out.float() * std + mean, 0.0, 1.0)
    return torch.round(canvas * 255.0).to(torch.uint8)


def make_stylize_fn(
    net: TransformerNet,
    *,
    crop: int = 224,
    compute_dtype: Optional[torch.dtype] = None,
    style_weights=None,
) -> Callable:
    """``images_u8 (B, H, W, 3) -> stylised uint8`` on the net's device,
    one forward under ``torch.inference_mode`` (entered in the calling
    thread). The result is returned without a sync. For a conditional net
    ``style_weights`` ((S,) or (B, S)) fixes the style mix."""
    device = next(net.parameters()).device

    def stylize(images_u8):
        with torch.inference_mode():
            return _stylize_body(net, torch.as_tensor(images_u8).to(device), crop,
                                 compute_dtype, style_weights)

    return stylize


def make_net_job_fn(
    net: TransformerNet, *, crop: int = 224, compute_dtype: Optional[torch.dtype] = None,
) -> Callable:
    """The forward under ``StyleTransferService``'s job contract
    ``(images_u8, style_w, job_ids) -> (u8, iters, per_loss)``: iters is 1,
    the per-image loss 0. On a conditional net the per-job ``style_w`` rows
    drive the conditional instance-norm affines."""
    n_styles = net_n_styles(net)
    device = next(net.parameters()).device

    def job(images_u8, style_w, job_ids):
        del job_ids
        with torch.inference_mode():
            sw = None
            if n_styles is not None:
                sw = torch.as_tensor(style_w).to(device).float()
                if sw.shape[-1] != n_styles:
                    raise ValueError(f"service gallery width {sw.shape[-1]} != the "
                                     f"net's {n_styles} styles")
            out = _stylize_body(net, torch.as_tensor(images_u8).to(device), crop,
                                compute_dtype, sw)
            return out, 1, torch.zeros((out.shape[0],), dtype=torch.float32, device=device)

    return job


def _not_ported(name: str):
    def raiser(*args, **kwargs):
        raise NotImplementedError(f"{name} (fast-style training) is not ported yet")

    raiser.__name__ = name
    return raiser


make_fast_style_train_step = _not_ported("make_fast_style_train_step")
train_fast_style = _not_ported("train_fast_style")
train_multi_style = _not_ported("train_multi_style")
