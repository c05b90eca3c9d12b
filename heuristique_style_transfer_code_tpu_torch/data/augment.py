"""Device-side preprocessing (``data/augment.py`` of the JAX package): the
eval path (``:323-327``) and the train step's augmentation function
(``make_augment_fn``, ``:285-320``) for the identity combination
``[(None, None)]`` that family 2 trains with. The random transforms
(flips, rotation, affine, resized crop, colour jitter, grayscale) are not
ported yet: they come with family-1 training."""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from ..ops.resize import center_crop, normalize_imagenet


def eval_preprocess(images_u8: torch.Tensor, crop: int = 224) -> torch.Tensor:
    """Staged uint8 (N, H, W, 3) -> /255 -> center crop -> ImageNet
    normalisation, float32 NHWC, contiguous."""
    img = images_u8.to(torch.float32) / 255.0
    return normalize_imagenet(center_crop(img, crop)).contiguous()


def make_augment_fn(combos: Sequence[Tuple[Optional[str], Optional[str]]],
                    crop: int = 224) -> Callable:
    """``augment(images_u8, combo_ids=None) -> float32 (B, crop, crop, 3)``
    for the train step. With the identity combination every image is /255,
    centre crop and ImageNet normalisation: ``eval_preprocess``, as the JAX
    function's one identity branch computes it. Any other transform
    raises "not ported yet"."""
    combos = list(combos)
    if not combos:
        raise ValueError("make_augment_fn needs at least one (geom, color) combination")
    for geom, color in combos:
        if geom is not None or color is not None:
            raise NotImplementedError(
                f"augmentation {(geom, color)} is not ported yet (only the identity "
                "combination [(None, None)], which family 2 trains with)")

    def augment(images_u8: torch.Tensor, combo_ids=None) -> torch.Tensor:
        return eval_preprocess(images_u8, crop)

    return augment
