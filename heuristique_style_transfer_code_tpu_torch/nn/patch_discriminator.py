"""The family-3 patch discriminators (``nn/patch_discriminator.py`` of the
JAX package: ``:41`` ``discriminator_layer_plan``; the train variant
``:77`` init, ``:112`` apply; the test variant ``:138`` init, ``:171``
apply).

The train variant, which training fits: per strided conv of the layer
plan a 4x4 conv (stride 2, padding 1), its norm and LeakyReLU(0.2); the
final 4x4 conv (stride 1, padding 1), its norm and LeakyReLU; the out conv
(4x4, stride 1, padding 1) to the classes, and the spatial mean of its map
in f32 as the logits. The norm is a batch norm (train mode in training,
its running buffers updated in place) or the non-affine instance norm,
which on the card is ``instance_norm_fwd`` and, where a gradient flows,
``instance_norm_bwd`` (``InstanceNormFunction``); the LeakyReLU stays a
separate op. Its tree is ``{convs[i].{conv, norm}, final.{conv, norm},
out_conv}``, a None norm under "instance".

The test variant, eval only, per discriminator, on NHWC activations:
- 4x4 convs with padding 1: stride 2 on the strided ones that the layer
  plan derives from the patch size, stride 1 on ``final_conv`` and
  ``final_conv_ndf``;
- a 1x1 projection to ``gram_matrix_dim`` channels that taps each conv's
  output before its norm, then ``layer_norm_tail``;
- eval batch norm or non-affine instance norm, then ReLU, on every conv
  but ``final_conv_ndf`` (the instance norm is the K3 kernel on the card,
  its ReLU fused);
- per projection: a 4x4 adaptive average pool, ``layer_norm_tail``, the
  Gram of the 16 pooled positions divided by 16 + 1e-6 (the K1 kernel
  ``gram_fwd`` on the card) and its Frobenius norm, then
  ``feature_projection`` of the flattened Gram;
- two stacked 8-head self-attentions over the per-layer sequence, the
  mean over layers, the classifier.

The module tree mirrors the JAX tree (``features[i].{conv, norm}``,
``projections``, ``attention_per_layer``, ``attention_per_patch``,
``classifier``, ``feature_projection``), so the weight bridge
(``checkpoint/convert.py``) is a renaming. A norm without parameters (the
instance norm, and ``final_conv_ndf``'s absent one) is None in the JAX
tree and no module here; ``FeatureLayer.none_leaves`` tells the bridge to
write it back as None.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.mesh import active_bands, replicated
from ..core.remat import remat_call
from ..models.gram_attention import MultiheadAttention
from ..ops.conv import conv2d
from ..ops.gram import gram_matrix_ncl
from ..ops.linear import Linear
from ..ops.norm import batch_norm, instance_norm, layer_norm_tail
from ..ops.pooling import adaptive_avg_pool2d
from .resnet import BatchNorm
from .transformer_net import Conv2d

# patch-size validity ranges per scale (the reference's Models_Multi_PatchGAN.py:11-15)
PATCH_TYPES = {"small": (4, 30), "medium": (31, 80), "large": (81, 150)}

GRAM_EPS = 1e-6
POOL = 4  # the pooled map's side: Grams over 16 positions
NUM_HEADS = 8


def discriminator_layer_plan(patch_size: int, ndf: int = 64, input_nc: int = 3):
    """The reference's depth loop ``while receptive_field > 4 and
    num_filters <= 512`` unrolled: (strided (cin, cout) list, final_in,
    final_out)."""
    strided: List[Tuple[int, int]] = []
    num_filters = ndf
    cin = input_nc
    receptive = float(patch_size)
    while receptive > 4 and num_filters <= 512:
        strided.append((cin, num_filters))
        cin = num_filters
        num_filters *= 2
        receptive /= 2.0
    return strided, cin, num_filters


class FeatureLayer(nn.Module):
    """One conv of the stack and its norm (a ``BatchNorm``, or None for
    the instance norm and for ``final_conv_ndf``)."""

    none_leaves = ("norm",)  # children that, when None, are None leaves of the JAX tree

    def __init__(self, cin: int, cout: int, norm: Optional[str], generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.conv = Conv2d(cin, cout, 4, generator, device, dtype)
        self.norm = BatchNorm(cout, device, dtype) if norm == "batch" else None


class PatchDiscriminator(nn.Module):
    """The train variant: ``convs`` (one ``FeatureLayer`` a strided conv),
    ``final`` and ``out_conv``."""

    def __init__(self, patch_size: int = 70, ndf: int = 64, input_nc: int = 3,
                 num_classes: int = 10, norm: str = "instance",
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        if norm not in ("batch", "instance"):
            raise ValueError(f"norm must be 'batch' or 'instance', got {norm!r}")
        strided, final_in, final_out = discriminator_layer_plan(patch_size, ndf, input_nc)
        args = (generator, device, dtype)
        self.convs = nn.ModuleList([FeatureLayer(cin, cout, norm, *args)
                                    for cin, cout in strided])
        self.final = FeatureLayer(final_in, final_out, norm, *args)
        self.out_conv = Conv2d(final_out, num_classes, 4, *args)
        self.norm = norm

    def forward(self, x):
        return patch_discriminator_apply(self, x, self.norm)


def _conv_norm_lrelu(layer: FeatureLayer, x: torch.Tensor, stride: int, norm: str):
    x = conv2d(x, layer.conv.weight, stride, 1, layer.conv.bias)
    x = layer.norm(x) if norm == "batch" else instance_norm(x)
    return F.leaky_relu(x, 0.2)


def patch_discriminator_apply(model: PatchDiscriminator, x: torch.Tensor,
                              norm: str = "instance", remat: bool = False) -> torch.Tensor:
    """x: (N, H, W, 3) -> logits (N, num_classes) in x's dtype, the spatial
    mean of the out conv's map taken in f32, in the module's mode: in train
    mode the batch norms normalise by the batch and update their running
    buffers in place. ``remat`` checkpoints each strided unit (JAX
    ``:109-120``; the early full-resolution units hold most of the
    activations), so its conv, norm and LeakyReLU run again in the
    backward."""
    for layer in model.convs:
        if remat:
            x = remat_call(_conv_norm_lrelu, layer, x, 2, norm)
        else:
            x = _conv_norm_lrelu(layer, x, 2, norm)
    x = _conv_norm_lrelu(model.final, x, 1, norm)
    x = conv2d(x, model.out_conv.weight, 1, 1, model.out_conv.bias)
    axis = active_bands()
    if axis is not None:  # the map's f32 mean as one device takes it
        from ..parallel.spatial import whole_rows

        x = whole_rows(x, axis)
    return x.float().mean(dim=(1, 2)).to(x.dtype)


class PatchDiscriminatorTest(nn.Module):
    def __init__(self, patch_size: int = 70, ndf: int = 64, input_nc: int = 3,
                 num_classes: int = 10, gram_matrix_dim: int = 64, norm: str = "instance",
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        if norm not in ("batch", "instance"):
            raise ValueError(f"norm must be 'batch' or 'instance', got {norm!r}")
        strided, final_in, final_out = discriminator_layer_plan(patch_size, ndf, input_nc)
        conv_outs = [cout for _, cout in strided] + [final_out, ndf]
        args = (generator, device, dtype)
        layers = [FeatureLayer(cin, cout, norm, *args) for cin, cout in strided]
        layers.append(FeatureLayer(final_in, final_out, norm, *args))
        layers.append(FeatureLayer(final_out, ndf, None, *args))
        self.features = nn.ModuleList(layers)
        self.projections = nn.ModuleList(
            [Conv2d(c, gram_matrix_dim, 1, *args) for c in conv_outs])
        self.attention_per_layer = MultiheadAttention(ndf, NUM_HEADS, *args)
        self.attention_per_patch = MultiheadAttention(ndf, NUM_HEADS, *args)
        self.classifier = Linear(ndf, num_classes, *args)
        self.feature_projection = Linear(gram_matrix_dim * gram_matrix_dim, ndf, *args)
        self.gram_matrix_dim = gram_matrix_dim
        self.norm = norm

    def forward(self, x):
        return patch_discriminator_test_apply(self, x, self.gram_matrix_dim, self.norm)


def patch_discriminator_test_apply(
    model: PatchDiscriminatorTest,
    x: torch.Tensor,
    gram_matrix_dim: int,
    norm: str = "instance",
) -> Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor]]:
    """x: (N, H, W, 3) -> (embeddings (N, ndf), logits (N, classes), one
    (N,) Gram norm per conv), all in x's dtype."""
    n = x.shape[0]
    last = len(model.features) - 1
    maps = []
    for i, layer in enumerate(model.features):
        stride = 2 if i < last - 1 else 1
        x = conv2d(x, layer.conv.weight, stride, 1, layer.conv.bias)
        proj = model.projections[i]
        maps.append(layer_norm_tail(conv2d(x, proj.weight, bias=proj.bias)))
        if i == last:  # final_conv_ndf: no norm, no ReLU
            continue
        if norm == "batch":
            bn = layer.norm
            x = torch.relu(batch_norm(x, bn.weight, bn.bias, bn.running_mean, bn.running_var))
        else:
            x = instance_norm(x, relu=True)

    per_layer, gram_norms = [], []
    length = POOL * POOL
    # under core.mesh.bands the maps are row bands; the adaptive pool sums
    # the bands' parts of each bin, and every map from it on is whole and
    # the same on each rank
    pooled_maps = [adaptive_avg_pool2d(fm, POOL) for fm in maps]
    with replicated():
        for pooled in pooled_maps:
            pooled = layer_norm_tail(pooled).contiguous()
            f = pooled.reshape(n, length, gram_matrix_dim).transpose(1, 2)  # (N, C, L) view
            g = gram_matrix_ncl(f, length + GRAM_EPS)
            gram_norms.append(torch.linalg.vector_norm(g.float(), dim=(1, 2)).to(g.dtype))
            per_layer.append(model.feature_projection(g.reshape(n, -1).to(x.dtype)))

        att = model.attention_per_layer(torch.stack(per_layer, dim=0))  # (L, N, ndf)
        att = model.attention_per_patch(att)
        embeddings = att.mean(dim=0)
        return embeddings, model.classifier(embeddings), gram_norms
