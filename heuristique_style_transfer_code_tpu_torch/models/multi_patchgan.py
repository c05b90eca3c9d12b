"""Model family 3: the multi-scale PatchGAN discriminators
(``models/multi_patchgan.py`` of the JAX package), test variant, eval only.

Three test discriminators (``small``, ``medium``, ``large`` patch sizes)
see the *same* input: the reference's MultiScaleDiscriminator_test does
not downsample between scales, and the port keeps that quirk. Embeddings
and logits are the mean over the scales; the Gram norms are concatenated.
The train variant (AvgPool2d between scales) comes with training.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..core.device import resolve_device
from ..nn.patch_discriminator import PatchDiscriminatorTest, patch_discriminator_test_apply

SCALES = ("small", "medium", "large")


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
