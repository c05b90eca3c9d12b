"""Center crop and ImageNet normalisation on NHWC tensors (the eval half of
``heuristique_style_transfer_code_tpu/ops/resize.py``; the on-device resize
is not ported yet)."""
from __future__ import annotations

import numpy as np
import torch

from ..core.geometry import center_crop_offsets

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def center_crop(img: torch.Tensor, size: int = 224) -> torch.Tensor:
    """(..., H, W, C) -> (..., size, size, C), torchvision's offset rule."""
    h, w = img.shape[-3], img.shape[-2]
    top, left = center_crop_offsets(h, w, size)
    return img[..., top : top + size, left : left + size, :]


def normalize_imagenet(img: torch.Tensor) -> torch.Tensor:
    """float [0, 1] HWC/NHWC -> ImageNet-normalised."""
    mean = torch.as_tensor(IMAGENET_MEAN, device=img.device)
    std = torch.as_tensor(IMAGENET_STD, device=img.device)
    return (img - mean) / std
