"""Mixup and CutMix batch mixing (``train/mixing.py`` of the JAX package):
``--mixup`` and ``--cutmix`` on the train CLIs.

timm's Mixup in its batch mode: one lambda ~ Beta(alpha, alpha) a batch;
the partner of each image is the batch rolled by a shift in
[1, max(B, 2)), the labels rolled the same way, so the partner labels are
the batch's own multiset and both cross-entropy terms share one valid
count; CutMix pastes the partner's box of side ratio sqrt(1 - lambda),
centred uniformly and clipped to the image, and corrects lambda to the
clipped box's pixel share; with both flags on, a fair coin a batch picks
one. The loss is ``lam * CE(y) + (1 - lam) * CE(y_partner)``.

Deviation from the JAX package: its draws come from ``jax.random``, which
cannot be reproduced here. Each batch's 5 numbers (the coin, lambda, the
shift and the box centre) come from a numpy generator seeded by the
batch's key (the run's seed, the fold, the epoch, the batch's index) and
``MIX_TAG``, the tag JAX folds into the step key: the augmentation's own
draws (``data/augment.batch_draws``) do not change when mixing is on. The
device side is ``torch.roll``, a blend and an iota box mask: nothing is
read back to the host.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

MIX_TAG = 0x6D6978  # "mix", the JAX package's _MIX_TAG


def mix_draws(key: Sequence[int], batch: int, h: int, w: int, use_mixup: bool,
              use_cutmix: bool, mixup_alpha: Optional[float], cutmix_alpha: Optional[float],
              switch_prob: float = 0.5) -> Tuple[bool, float, int, int, int]:
    """(cutmix?, lambda, shift, cy, cx) of the batch whose key is ``key``:
    the coin (drawn only when both are on), lambda ~ Beta(alpha, alpha) of
    the chosen mode, the roll in [1, max(batch, 2)) and the box centre in
    [0, h) x [0, w)."""
    rng = np.random.default_rng(np.random.SeedSequence([int(k) for k in key] + [MIX_TAG]))
    cut = use_cutmix and (not use_mixup or bool(rng.random() < switch_prob))
    alpha = cutmix_alpha if cut else mixup_alpha
    lam = float(rng.beta(alpha, alpha))
    shift = int(rng.integers(1, max(batch, 2)))
    cy, cx = int(rng.integers(0, h)), int(rng.integers(0, w))
    return cut, lam, shift, cy, cx


def roll_partner(images: torch.Tensor, labels: torch.Tensor, shift: int):
    """The partner batch and its labels: both rolled by ``shift`` along the
    batch axis."""
    return torch.roll(images, shift, 0), torch.roll(labels, shift, 0)


def mixup_images(images: torch.Tensor, partner: torch.Tensor, lam: float) -> torch.Tensor:
    """``lam * images + (1 - lam) * partner`` in the images' dtype, lambda
    rounded to float32 first (JAX ``_mixup_images``)."""
    lam32 = np.float32(lam)
    return images * float(lam32) + partner * float(np.float32(1.0) - lam32)


def cutmix_box(cy: int, cx: int, h: int, w: int, lam: float):
    """timm's ``rand_bbox`` about the centre (cy, cx), in float32 as the
    JAX ``cutmix_box``: ((y1, x1, y2, x2), the corrected lambda = 1 -
    box area / (h * w))."""
    ratio = np.sqrt(np.float32(1.0) - np.float32(lam))
    rh = int(np.floor(np.float32(h) * ratio))
    rw = int(np.floor(np.float32(w) * ratio))
    y1, y2 = min(max(cy - rh // 2, 0), h), min(max(cy + rh // 2, 0), h)
    x1, x2 = min(max(cx - rw // 2, 0), w), min(max(cx + rw // 2, 0), w)
    lam_adj = np.float32(1.0) - np.float32((y2 - y1) * (x2 - x1)) / np.float32(h * w)
    return (y1, x1, y2, x2), float(lam_adj)


def cutmix_images(images: torch.Tensor, partner: torch.Tensor, box) -> torch.Tensor:
    """The partner's box pasted into each image: an iota mask and
    ``torch.where`` (JAX ``_cutmix_images``)."""
    y1, x1, y2, x2 = box
    h, w = images.shape[1], images.shape[2]
    rows = torch.arange(h, device=images.device)[:, None]
    cols = torch.arange(w, device=images.device)[None, :]
    inbox = (rows >= y1) & (rows < y2) & (cols >= x1) & (cols < x2)
    return torch.where(inbox[None, :, :, None], partner, images)


def make_mix_fn(mixup_alpha: Optional[float] = None, cutmix_alpha: Optional[float] = None,
                switch_prob: float = 0.5) -> Optional[Callable]:
    """``mix(images, labels, key) -> (images, labels_a, labels_b, lam)``
    on the augmented float batch, ``key`` the batch's (seed, fold, epoch,
    batch index); None when both alphas are off (the step is then the
    unmixed one)."""
    use_mixup = mixup_alpha is not None and mixup_alpha > 0
    use_cutmix = cutmix_alpha is not None and cutmix_alpha > 0
    if not (use_mixup or use_cutmix):
        return None

    def mix(images: torch.Tensor, labels: torch.Tensor, key: Sequence[int]):
        b, h, w = images.shape[0], images.shape[1], images.shape[2]
        cut, lam, shift, cy, cx = mix_draws(key, b, h, w, use_mixup, use_cutmix,
                                            mixup_alpha, cutmix_alpha, switch_prob)
        partner, labels_b = roll_partner(images, labels, shift)
        if cut:
            box, lam = cutmix_box(cy, cx, h, w, lam)
            return cutmix_images(images, partner, box), labels, labels_b, lam
        return mixup_images(images, partner, lam), labels, labels_b, float(np.float32(lam))

    return mix
