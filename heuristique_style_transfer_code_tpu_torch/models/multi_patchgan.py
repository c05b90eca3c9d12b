"""Model family 3: the multi-scale PatchGAN discriminators
(``models/multi_patchgan.py`` of the JAX package).

Train variant (``:29-58``), which training fits: three patch
discriminators (``small``, ``medium``, ``large`` patch sizes); the input
is downsampled by AvgPool2d(3, 2, 1, count_include_pad=False) between
scales, and the logits are the mean over the scales.

Test variant (``:61-99``): three test discriminators see the *same* input
(the reference's MultiScaleDiscriminator_test does not downsample between
scales, and the port keeps that quirk). Embeddings and logits are the mean
over the scales; the Gram norms are concatenated.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..core.device import resolve_device
from ..nn.patch_discriminator import (
    PatchDiscriminator,
    PatchDiscriminatorTest,
    patch_discriminator_apply,
    patch_discriminator_test_apply,
)
from ..ops.conv import avg_pool2d

SCALES = ("small", "medium", "large")


class MultiScaleDiscriminator(nn.Module):
    """The train variant's ``{small, medium, large}`` tree."""

    def __init__(self, patch_sizes: Dict[str, int], ndf: int = 64, input_nc: int = 3,
                 num_classes: int = 10, norm: str = "batch",
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        for scale in SCALES:
            self.add_module(scale, PatchDiscriminator(
                patch_sizes.get(scale, 70), ndf, input_nc, num_classes, norm, generator, device,
                dtype))
        self.norm = norm

    def forward(self, x):
        return multiscale_apply(self, x, self.norm)


def multiscale_init(
    generator: Optional[torch.Generator],
    patch_sizes: Dict[str, int],
    ndf: int = 64,
    input_nc: int = 3,
    num_classes: int = 10,
    norm: str = "batch",
    device="cuda",
    dtype=torch.float32,
) -> MultiScaleDiscriminator:
    """The family-3 train-variant model in eval mode on ``device`` (``cuda``
    unless the caller asks for ``cpu``), its random weights drawn from
    ``generator`` (a CPU ``torch.Generator``; None = the global one). A
    fold of training starts from it with ``.train()``."""
    return MultiScaleDiscriminator(patch_sizes, ndf, input_nc, num_classes, norm, generator,
                                   resolve_device(device), dtype).eval()


def multiscale_apply(model: MultiScaleDiscriminator, x: torch.Tensor, norm: str = "batch",
                     train: Optional[bool] = None, remat: bool = False) -> torch.Tensor:
    """x: (N, H, W, 3) -> logits (N, classes), the mean of the three
    scales', each scale on x downsampled once more than the one before.
    ``train`` sets the model's mode first (None keeps it); ``remat``
    checkpoints each strided unit (JAX ``:47-52``)."""
    if train is not None:
        model.train(train)
    outs = []
    for i, scale in enumerate(SCALES):
        if i:
            x = avg_pool2d(x, 3, 2, 1, count_include_pad=False)
        outs.append(patch_discriminator_apply(getattr(model, scale), x, norm, remat))
    return torch.stack(outs).mean(dim=0)


class MultiScaleDiscriminatorTest(nn.Module):
    """The ``{small, medium, large}`` tree of the JAX checkpoint."""

    def __init__(self, patch_sizes: Dict[str, int], ndf: int = 64, input_nc: int = 3,
                 num_classes: int = 10, gram_matrix_dim: int = 64, norm: str = "batch",
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        for scale in SCALES:
            self.add_module(scale, PatchDiscriminatorTest(
                patch_sizes.get(scale, 70), ndf, input_nc, num_classes, gram_matrix_dim, norm,
                generator, device, dtype))
        self.gram_matrix_dim = gram_matrix_dim
        self.norm = norm

    def forward(self, x):
        return multiscale_test_apply(self, x, self.gram_matrix_dim, self.norm)


def multiscale_test_init(
    generator: Optional[torch.Generator],
    patch_sizes: Dict[str, int],
    ndf: int = 64,
    input_nc: int = 3,
    num_classes: int = 10,
    gram_matrix_dim: int = 64,
    norm: str = "batch",
    device="cuda",
    dtype=torch.float32,
) -> MultiScaleDiscriminatorTest:
    """The family-3 test model in eval mode on ``device`` (``cuda`` unless
    the caller asks for ``cpu``), its random weights drawn from
    ``generator`` (a CPU ``torch.Generator``; None = the global one)."""
    return MultiScaleDiscriminatorTest(patch_sizes, ndf, input_nc, num_classes,
                                       gram_matrix_dim, norm, generator,
                                       resolve_device(device), dtype).eval()


def multiscale_test_apply(
    model: MultiScaleDiscriminatorTest, x: torch.Tensor, gram_matrix_dim: int,
    norm: str = "batch",
) -> Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor]]:
    """x: (N, H, W, 3) -> (embeddings (N, ndf), logits (N, classes), the
    Gram norms of every scale in order); all scales see the same x."""
    embs, outs, norms = [], [], []
    for scale in SCALES:
        e, o, gn = patch_discriminator_test_apply(getattr(model, scale), x, gram_matrix_dim,
                                                  norm)
        embs.append(e)
        outs.append(o)
        norms.extend(gn)
    return torch.stack(embs).mean(dim=0), torch.stack(outs).mean(dim=0), norms
