"""ResNet50 (bottleneck v1) encoder, truncatable at a torchvision
"child" boundary (``nn/resnet.py`` of the JAX package).

Child index map (torchvision resnet50.children() order):
    0 conv1   1 bn1   2 relu   3 maxpool
    4 layer1  5 layer2  6 layer3  7 layer4   8 avgpool   9 fc

The module tree mirrors the JAX parameter tree, so the weight bridge
(``checkpoint/convert.py``) is a renaming: ``layer2.1.conv3.weight`` is
``params["layer2"][1]["conv3"]["kernel"]``. Only the children a truncation
uses exist (``_prune_encoder``); the fc child only in the whole network
(truncate 10), as in the JAX ``resnet50_init`` tree. Activations are NHWC
tensors whose storage is ``channels_last`` (``ops/conv.py``), which is what
lets the Gram kernels read each stage output with no copy. ``remat``
recomputes each bottleneck in the backward (``core/remat.py``).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..core.remat import remat_call
from ..ops.conv import conv2d, max_pool2d
from ..ops.gram import gram_matrix_nhwc, pooled_gram_nhwc
from ..ops.linear import Linear
from ..ops.norm import batch_norm
from ..ops.pooling import global_avg_pool

RESNET50_CHILDREN = (
    "conv1", "bn1", "relu", "maxpool",
    "layer1", "layer2", "layer3", "layer4",
    "avgpool", "fc",
)

# (name, num_blocks, bottleneck width, first-block stride) per stage
_STAGES = (("layer1", 3, 64, 1), ("layer2", 4, 128, 2),
           ("layer3", 6, 256, 2), ("layer4", 3, 512, 2))

EXPANSION = 4


def _prune_encoder(full: Dict[str, object], truncate: int) -> Dict[str, object]:
    """Keep only the children the truncation uses
    (``models/truncated_resnet50.py:29-36``)."""
    return {
        name: full[name]
        for name in RESNET50_CHILDREN[: min(truncate, 8)]
        if name in full
    }


def truncated_feature_channels(truncate: int) -> int:
    """Channels of the truncated encoder's output (``nn/resnet.py:48-57``):
    3 for no child, 64 through the stem, the last executed stage's width
    times 4 after it."""
    if truncate <= 0:
        return 3
    c = 64
    for i, (_, _, width, _) in enumerate(_STAGES):
        if truncate > 4 + i:
            c = width * EXPANSION
    return c


class Conv2d(nn.Module):
    """Bias-free conv, OIHW weight kept channels_last; torchvision's
    kaiming_normal(fan_out, relu) init from an explicit generator."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, padding: int = 0,
                 generator: Optional[torch.Generator] = None,
                 device=None, dtype=torch.float32):
        super().__init__()
        std = (2.0 / (k * k * cout)) ** 0.5
        w = torch.randn((cout, cin, k, k), generator=generator, dtype=dtype) * std
        self.weight = nn.Parameter(
            w.to(device).contiguous(memory_format=torch.channels_last)
        )
        self.stride = stride
        self.padding = padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(x, self.weight, self.stride, self.padding)


class BatchNorm(nn.Module):
    """BatchNorm2d on NHWC: running statistics in eval; under ``.train()``
    the batch's statistics, with the running buffers updated in place (the
    JAX train loop's ``_merge_bn_stats``)."""

    def __init__(self, c: int, device=None, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(c, device=device, dtype=dtype))
        self.register_buffer("running_mean", torch.zeros(c, device=device, dtype=dtype))
        self.register_buffer("running_var", torch.ones(c, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return batch_norm(x, self.weight, self.bias, self.running_mean, self.running_var,
                          train=self.training)


class Downsample(nn.Module):
    def __init__(self, cin, cout, stride, generator=None, device=None, dtype=torch.float32):
        super().__init__()
        self.conv = Conv2d(cin, cout, 1, stride, 0, generator, device, dtype)
        self.bn = BatchNorm(cout, device, dtype)

    def forward(self, x):
        return self.bn(self.conv(x))


class Bottleneck(nn.Module):
    def __init__(self, cin: int, width: int, stride: int, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        cout = width * EXPANSION
        self.conv1 = Conv2d(cin, width, 1, 1, 0, generator, device, dtype)
        self.bn1 = BatchNorm(width, device, dtype)
        self.conv2 = Conv2d(width, width, 3, stride, 1, generator, device, dtype)
        self.bn2 = BatchNorm(width, device, dtype)
        self.conv3 = Conv2d(width, cout, 1, 1, 0, generator, device, dtype)
        self.bn3 = BatchNorm(cout, device, dtype)
        self.downsample = (
            Downsample(cin, cout, stride, generator, device, dtype)
            if stride != 1 or cin != cout else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.bn1(self.conv1(x)))
        h = torch.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        identity = self.downsample(x) if self.downsample is not None else x
        return torch.relu(h + identity)


class ResNet50Encoder(nn.Module):
    """The children [0:truncate] of ResNet50 (truncate 0..10); the avgpool
    child (9) holds no parameters, the fc child (10: the whole network)
    maps the pooled 2048 features to ``num_classes``. Its batch norms
    follow the module's ``.train()``/``.eval()`` mode."""

    def __init__(self, truncate_layer: int, generator: Optional[torch.Generator] = None,
                 device=None, dtype=torch.float32, num_classes: int = 1000):
        super().__init__()
        self.truncate = min(truncate_layer, 10)
        builders = {
            "conv1": lambda: Conv2d(3, 64, 7, 2, 3, generator, device, dtype),
            "bn1": lambda: BatchNorm(64, device, dtype),
        }
        cin = 64
        for name, blocks, width, stride in _STAGES:
            builders[name] = (
                lambda cin=cin, blocks=blocks, width=width, stride=stride: nn.ModuleList(
                    Bottleneck(cin if b == 0 else width * EXPANSION, width,
                               stride if b == 0 else 1, generator, device, dtype)
                    for b in range(blocks)
                )
            )
            cin = width * EXPANSION
        for name, build in _prune_encoder(builders, self.truncate).items():
            self.add_module(name, build())
        if self.truncate >= 10:
            self.fc = Linear(cin, num_classes, generator, device, dtype)

    def forward(self, x, collect_grams: bool = False, gram_pool_size: Optional[int] = None):
        return resnet50_apply(self, x, self.truncate, collect_grams, gram_pool_size)


def resnet50_apply(
    encoder: ResNet50Encoder,
    x: torch.Tensor,
    truncate: int = 8,
    collect_grams: bool = False,
    gram_pool_size: Optional[int] = None,
    remat: bool = False,
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Run children [0:truncate] on x (N, H, W, 3).

    Returns (features, grams): NHWC features, (N, 2048) at truncate 9,
    whose avgpool child is the global average pool, or the fc child's
    (N, num_classes) at truncate 10 (an encoder built with truncate 10).
    ``collect_grams``: one Gram per executed stage (layer1..layer4);
    ``gram_pool_size``: the (S, S) pooled Gram instead of the (C, C) one.
    Both Grams are differentiable. In train mode (``encoder.train()``) the
    batch norms normalise by the batch and update their running buffers in
    place (``nn/resnet.py:162-224``). ``remat`` checkpoints each bottleneck
    (JAX ``:135-139``): the stage outputs, where the Grams are taken, are
    block boundaries and are kept either way."""
    grams: List[torch.Tensor] = []
    if truncate >= 10 and not hasattr(encoder, "fc"):
        raise ValueError("truncate 10 runs the fc child: build the encoder with "
                         "truncate_layer 10")
    if truncate < 1:
        return x, grams
    # a contiguous NHWC input is the channels_last layout the convs run in
    h = encoder.conv1(x.contiguous())
    if truncate >= 2:
        h = encoder.bn1(h)
    if truncate >= 3:
        h = torch.relu(h)
    if truncate >= 4:
        h = max_pool2d(h, 3, 2, 1)
    for i, (name, _, _, _) in enumerate(_STAGES):
        if truncate <= 4 + i:
            break
        for block in getattr(encoder, name):
            h = remat_call(block, h) if remat else block(h)
        if collect_grams:
            if gram_pool_size is not None:
                grams.append(pooled_gram_nhwc(h, gram_pool_size))
            else:
                grams.append(gram_matrix_nhwc(h))
    if truncate >= 9:
        h = global_avg_pool(h)
    if truncate >= 10:
        h = encoder.fc(h)
    return h, grams
