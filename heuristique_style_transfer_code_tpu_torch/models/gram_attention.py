"""Model family 2: truncated ResNet50 + per-stage pooled Grams + attention
(``models/gram_attention.py`` of the JAX package), eval and train.

Forward: the stem, then at every executed stage (layer1..layer4 up to
``truncate``) the (S, S) pooled Gram — the ``pooled_gram_fwd`` kernel on the
card, differentiated by ``pooled_gram_bwd`` where a gradient flows —
stacked into a sequence, one-head self-attention over it, a mean over the
sequence and Linear(S², num_classes). Under ``.train()`` the encoder's batch
norms take the batch's statistics and update their running buffers in
place, which is the JAX train forward (``:43-70``) with its new encoder
tree merged back. ``gram_attention_apply_int8`` takes the Grams of the
post-training quantised encoder's dequantised stage maps (still through
``pooled_gram_fwd``) and ``gram_attention_apply_qat`` of its fake-quant
twin, under the float head (JAX ``:100-140``).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from ..core.device import resolve_device
from ..nn.resnet import ResNet50Encoder, resnet50_apply
from ..ops.attention import multihead_attention
from ..ops.linear import Linear


class MultiheadAttention(nn.Module):
    """Packed in-projection MHA parameters under the JAX tree's leaf names;
    torch's init (xavier on the packed (3E, E) weight, zero biases)."""

    def __init__(self, embed_dim: int, num_heads: int = 1, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        e = embed_dim
        self.num_heads = num_heads
        b_in = (6.0 / (e + 3 * e)) ** 0.5
        b_out = 1.0 / e ** 0.5

        def uniform(shape, bound):
            t = torch.rand(shape, generator=generator, dtype=dtype) * 2 - 1
            return nn.Parameter(t.mul_(bound).to(device))

        self.in_proj_weight = uniform((3 * e, e), b_in)
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * e, device=device, dtype=dtype))
        self.out_proj_weight = uniform((e, e), b_out)
        self.out_proj_bias = nn.Parameter(torch.zeros(e, device=device, dtype=dtype))

    def forward(self, x):
        return multihead_attention(x, self.in_proj_weight, self.in_proj_bias,
                                   self.out_proj_weight, self.out_proj_bias,
                                   self.num_heads)


class GramAttention(nn.Module):
    def __init__(self, truncate_layer: int, num_classes: int, gram_matrix_size: int,
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        s2 = gram_matrix_size ** 2
        self.truncate = truncate_layer
        self.gram_matrix_size = gram_matrix_size
        self.num_classes = num_classes
        self.encoder = ResNet50Encoder(min(truncate_layer, 9), generator, device, dtype)
        self.classifier = Linear(s2, num_classes, generator, device, dtype)
        self.attention = MultiheadAttention(s2, 1, generator, device, dtype)

    def forward(self, x):
        return gram_attention_apply(self, x, self.truncate, self.gram_matrix_size,
                                    self.num_classes)


def gram_attention_init(
    generator: Optional[torch.Generator],
    truncate_layer: int,
    num_classes: int,
    gram_matrix_size: int,
    device="cuda",
    dtype=torch.float32,
) -> GramAttention:
    """A family-2 model in eval mode on ``device`` (``cuda`` unless the
    caller asks for ``cpu``), its random weights drawn from ``generator``
    (a CPU ``torch.Generator``; None = the global one). A fold of training
    starts from it with ``.train()`` (``train/factories.py``)."""
    return GramAttention(truncate_layer, num_classes, gram_matrix_size,
                         generator, resolve_device(device), dtype).eval()


def gram_attention_apply(
    model: GramAttention,
    x: torch.Tensor,
    truncate: int,
    gram_matrix_size: int,
    num_classes: int,
    remat: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (N, H, W, 3) -> (embeddings (N, S²), logits (N, classes)), in
    the model's mode: eval, or train with the batch norms' running
    buffers updated in place. ``remat`` checkpoints each bottleneck."""
    _, grams = resnet50_apply(model.encoder, x, truncate=min(truncate, 8),
                              collect_grams=True, gram_pool_size=gram_matrix_size, remat=remat)
    return _gram_head(model, grams, x, gram_matrix_size, num_classes)


def _gram_head(model: GramAttention, grams: List[torch.Tensor], x: torch.Tensor,
               s: int, num_classes: int):
    """Stage Grams -> attention sequence -> mean-pooled embedding -> logits;
    zeros when no Grams were collected (truncate <= 4), as the reference
    does (``models/gram_attention.py:72-85``)."""
    n = x.shape[0]
    if not grams:
        return (torch.zeros((n, s * s), dtype=x.dtype, device=x.device),
                torch.zeros((n, num_classes), dtype=x.dtype, device=x.device))
    seq = torch.stack([g.reshape(g.shape[0], s * s) for g in grams], dim=0)  # (L, N, S²)
    emb = model.attention(seq).mean(dim=0)
    return emb, model.classifier(emb)


def prepare_gram_attention_int8(model: GramAttention, truncate: int, calibration_batches):
    """PTQ of the encoder at ``min(truncate, 8)``; Grams, attention and
    classifier stay float. Returns the quantised encoder for
    ``gram_attention_apply_int8``."""
    from ..nn.resnet_int8 import prepare_int8_resnet

    return prepare_int8_resnet(model.encoder, calibration_batches, min(truncate, 8))


def gram_attention_apply_int8(q_encoder, model: GramAttention, x: torch.Tensor,
                              gram_matrix_size: int, num_classes: int):
    """The int8 inference forward: the quantised encoder, each stage's
    pooled Gram of its dequantised output, the float attention and
    classifier; (embeddings, logits), as the eval
    ``gram_attention_apply``."""
    from ..nn.resnet_int8 import resnet50_apply_int8

    _, grams = resnet50_apply_int8(q_encoder, x, collect_grams=True,
                                   gram_pool_size=gram_matrix_size)
    return _gram_head(model, grams, x, gram_matrix_size, num_classes)


def gram_attention_apply_qat(model: GramAttention, act_scales, x: torch.Tensor,
                             truncate: int, gram_matrix_size: int, num_classes: int):
    """The QAT fine-tune forward: the fake-quant encoder, the pooled Grams
    of its fake-quantised stage outputs and the float head, the
    differentiable twin of ``gram_attention_apply_int8``; (embeddings,
    logits)."""
    from ..nn.resnet_qat import qat_resnet50_apply

    _, grams = qat_resnet50_apply(model.encoder, act_scales, x, min(truncate, 8),
                                  collect_grams=True, gram_pool_size=gram_matrix_size)
    return _gram_head(model, grams, x, gram_matrix_size, num_classes)
