"""Eval preprocessing on the device (``data/augment.py:323-327``); the
training augmentations are not ported yet."""
from __future__ import annotations

import torch

from ..ops.resize import center_crop, normalize_imagenet


def eval_preprocess(images_u8: torch.Tensor, crop: int = 224) -> torch.Tensor:
    """Staged uint8 (N, H, W, 3) -> /255 -> center crop -> ImageNet
    normalisation, float32 NHWC, contiguous."""
    img = images_u8.to(torch.float32) / 255.0
    return normalize_imagenet(center_crop(img, crop)).contiguous()
