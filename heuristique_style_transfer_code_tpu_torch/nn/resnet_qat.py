"""Quantization-aware training forward of the int8 ResNet50 path
(``nn/resnet_qat.py`` of the JAX package).

A fake-quant twin of ``resnet_int8.resnet50_apply_int8`` over the float
encoder, node for node: each batch norm folded on the fly from the current
parameters and the running statistics (detached: frozen during the
fine-tune), each folded kernel fake-quantised per output channel with a
detached maxabs/127 scale (the export's derivation), each activation
fake-quantised with its fixed calibrated scale, and the rounding bridged
by the clipped straight-through estimator. Export after QAT is
``quantize_resnet50`` of the same encoder. The convolutions are float
ones (cuDNN on the card), in f32, or float64 for a float64 model.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from ..ops.conv import conv2d, max_pool2d
from ..ops.norm import EPS
from .resnet import _STAGES


def fake_quant(x: torch.Tensor, scale) -> torch.Tensor:
    """Clipped-STE symmetric int8 fake quantisation: forward
    ``round(clamp(x / s, -127, 127)) * s``, the value the int8 graph
    dequantises to; backward the identity where |x / s| <= 127 and zero
    outside, and half of it where x / s is exactly ±127 (JAX's clip is a
    max and a min, whose gradients split at a tie, as ``torch.maximum``'s
    and ``torch.minimum``'s do; ``torch.clamp`` would pass it whole: the
    largest weight of each output channel sits on that tie). ``scale`` is
    a float or a tensor broadcasting against x."""
    y = x / scale
    bound = torch.full((), 127.0, dtype=y.dtype, device=y.device)
    y = torch.minimum(torch.maximum(y, -bound), bound)
    yq = y + (torch.round(y) - y).detach()
    return yq * scale


def _fold_bn(conv, bn):
    """(OIHW kernel, bias) of a conv and its eval batch norm, differentiable
    in the kernel and the norm's scale and bias; the running statistics
    detached."""
    inv = bn.weight / torch.sqrt(bn.running_var.detach() + EPS)
    k = conv.weight * inv[:, None, None, None]
    b = bn.bias - bn.running_mean.detach() * inv
    return k, b


def _fq_weight(k: torch.Tensor) -> torch.Tensor:
    """Per-output-channel weight fake quantisation; the scale
    (maxabs/127) detached."""
    maxabs = k.detach().abs().amax(dim=(1, 2, 3))
    s = torch.where(maxabs > 0, maxabs / 127.0, torch.ones_like(maxabs))
    return fake_quant(k, s[:, None, None, None])


def _conv_fq(x: torch.Tensor, conv, bn, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """Fake-quant twin of ``resnet_int8._conv_i8``: the fake-quantised
    folded kernel on an already fake-quantised input, plus the folded
    bias."""
    k, b = _fold_bn(conv, bn)
    return conv2d(x, _fq_weight(k).to(x.dtype), stride, padding) + b.to(x.dtype)


def qat_resnet50_apply(encoder, act_scales: Dict[str, Any], x: torch.Tensor, truncate: int,
                       collect_grams: bool = False,
                       gram_pool_size: Optional[int] = None) -> Any:
    """The fake-quant forward of ``encoder`` (a ``ResNet50Encoder``; its
    batch-norm modules' running statistics, whatever its mode): x
    normalised NHWC (float64 stays float64, anything else runs in f32),
    ``act_scales`` from ``calibrate_activation_scales``, truncate in
    [4, 8]. ``collect_grams``: also one Gram a stage, pooled to (S, S)
    with ``gram_pool_size``; returns (features, grams) then."""
    from ..ops.gram import gram_matrix_nhwc, pooled_gram_nhwc

    if not 4 <= truncate <= 8:
        raise ValueError("QAT path supports truncate in [4, 8]")
    ctype = torch.float64 if x.dtype == torch.float64 else torch.float32
    grams: List[torch.Tensor] = []
    h = fake_quant(x.to(ctype).contiguous(), act_scales["input"])
    h = _conv_fq(h, encoder.conv1, encoder.bn1, stride=2, padding=3)
    h = fake_quant(torch.relu(h), act_scales["stem"])
    # max-pooling commutes with the monotone fake quantisation
    h = max_pool2d(h, 3, 2, 1)
    for si, (name, _, _, stride) in enumerate(_STAGES):
        if truncate <= 4 + si:
            break
        for b, block in enumerate(getattr(encoder, name)):
            st = stride if b == 0 else 1
            sc = act_scales[name][b]
            a = fake_quant(torch.relu(_conv_fq(h, block.conv1, block.bn1)), sc["h1"])
            bq = fake_quant(torch.relu(_conv_fq(a, block.conv2, block.bn2, st, 1)), sc["h2"])
            y = _conv_fq(bq, block.conv3, block.bn3)
            if block.downsample is not None:
                identity = _conv_fq(h, block.downsample.conv, block.downsample.bn, st)
            else:
                identity = h
            h = fake_quant(torch.relu(y + identity), sc["out"])
        if collect_grams:
            grams.append(pooled_gram_nhwc(h, gram_pool_size) if gram_pool_size is not None
                         else gram_matrix_nhwc(h))
    if collect_grams:
        return h, grams
    return h
