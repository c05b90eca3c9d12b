"""On-device preprocessing on NHWC tensors (``ops/resize.py`` of the JAX
package): PIL-parity bilinear resize, center crop and ImageNet
normalisation.

PIL's antialiased bilinear filter is separable and fixed for a given
(in, out) size, so a resize is two products with constant matrices,
``A_h @ img @ A_w^T``, in f32. Each matrix is built once in numpy (the same
values as the JAX package's) and kept on its device after its first use
there: a fresh host copy per frame would stall the stream.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.geometry import center_crop_offsets, resize_target

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


@functools.lru_cache(maxsize=None)
def _resize_matrix_np(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) row-stochastic matrix of PIL BILINEAR+antialias weights."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale  # triangle filter support
    M = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        center = (i + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        js = np.arange(xmin, xmax)
        w = (js + 0.5 - center) / filterscale
        w = np.clip(1.0 - np.abs(w), 0.0, None)  # triangle
        s = w.sum()
        if s > 0:
            M[i, xmin:xmax] = w / s
    return M.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _resize_matrix_on(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_resize_matrix_np(in_size, out_size), device=device)


def resize_matrix(in_size: int, out_size: int,
                  device: torch.device = torch.device("cpu")) -> torch.Tensor:
    """(out, in) float32 resize matrix on ``device``."""
    return _resize_matrix_on(in_size, out_size, torch.device(device))


def resize_image(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """img: (..., H, W, C) -> (..., out_h, out_w, C) float32."""
    h, w = img.shape[-3], img.shape[-2]
    ah = resize_matrix(h, out_h, img.device)
    aw = resize_matrix(w, out_w, img.device)
    y = torch.einsum("...hwc,oh->...owc", img.to(torch.float32), ah)
    return torch.einsum("...hwc,pw->...hpc", y, aw)


def resize_shorter_side(img: torch.Tensor, shorter: int = 256) -> torch.Tensor:
    """img: (H, W, C) or (N, H, W, C); the shorter side becomes ``shorter``."""
    h, w = img.shape[-3], img.shape[-2]
    th, tw = resize_target(h, w, shorter)
    return resize_image(img, th, tw)


def center_crop(img: torch.Tensor, size: int = 224) -> torch.Tensor:
    """(..., H, W, C) -> (..., size, size, C), torchvision's offset rule."""
    h, w = img.shape[-3], img.shape[-2]
    top, left = center_crop_offsets(h, w, size)
    return img[..., top : top + size, left : left + size, :]


@functools.lru_cache(maxsize=8)
def _imagenet_on(device: torch.device):
    return (torch.as_tensor(IMAGENET_MEAN, device=device),
            torch.as_tensor(IMAGENET_STD, device=device))


def normalize_imagenet(img: torch.Tensor) -> torch.Tensor:
    """float [0, 1] HWC/NHWC -> ImageNet-normalised."""
    mean, std = _imagenet_on(img.device)
    return (img - mean) / std


def preprocess(img_u8: torch.Tensor, crop: int = 224, shorter: int = 256) -> torch.Tensor:
    """The canonical transform on the device: uint8 (H, W, C) or
    (N, H, W, C) -> /255 -> shorter side ``shorter`` -> center crop
    ``crop`` -> ImageNet-normalised float32."""
    x = img_u8.to(torch.float32) / 255.0
    x = resize_shorter_side(x, shorter)
    x = center_crop(x, crop)
    return normalize_imagenet(x)
