"""NHWC convolution and max pooling.

The JAX package keeps activations NHWC and kernels HWIO. Here the public
functions take and return NHWC tensors too, but the work runs on the
(N, C, H, W) view ``x.permute(0, 3, 1, 2)``: for a contiguous NHWC tensor
that view is ``channels_last``, so cuDNN runs its NHWC kernels and the
output, permuted back, is a contiguous NHWC tensor again — no copies. Weights
are OIHW (converted from HWIO once, at load) and stored ``channels_last``.
Cross-correlation, output in x's dtype, as ``ops/conv.py:60-80``.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

IntPair = Union[int, Tuple[int, int]]


def hwio_to_oihw(kernel: np.ndarray) -> np.ndarray:
    """JAX (kh, kw, in, out) -> torch (out, in, kh, kw)."""
    return np.ascontiguousarray(np.transpose(kernel, (3, 2, 0, 1)))


def oihw_to_hwio(weight: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(weight, (2, 3, 1, 0)))


def conv2d(
    x: torch.Tensor,
    weight: torch.Tensor,
    stride: IntPair = 1,
    padding: IntPair = 0,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """x: (N, H, W, C), weight (O, C, kh, kw), optional bias (O,) ->
    (N, H', W', O) in x's dtype. The bias goes into the convolution call
    (cuDNN adds it in its epilogue); in bf16 JAX adds the f32 bias before
    the one rounding, so the two may differ by a bf16 step."""
    b = bias.to(x.dtype) if bias is not None else None
    y = F.conv2d(x.permute(0, 3, 1, 2), weight.to(x.dtype), b, stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def max_pool2d(
    x: torch.Tensor,
    kernel_size: IntPair,
    stride: IntPair,
    padding: IntPair = 0,
) -> torch.Tensor:
    """x: (N, H, W, C) -> (N, H', W', C); padding counts as -inf."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), kernel_size, stride, padding)
    return y.permute(0, 2, 3, 1)
