"""NHWC convolution, max pooling and average pooling.

The JAX package keeps activations NHWC and kernels HWIO. Here the public
functions take and return NHWC tensors too, but the work runs on the
(N, C, H, W) view ``x.permute(0, 3, 1, 2)``: for a contiguous NHWC tensor
that view is ``channels_last``, so cuDNN runs its NHWC kernels and the
output, permuted back, is a contiguous NHWC tensor again — no copies. Weights
are OIHW (converted from HWIO once, at load) and stored ``channels_last``.
Cross-correlation, output in x's dtype, as ``ops/conv.py:60-80``.

Under ``core.mesh.bands`` (``--shard_spatial``) x is this rank's band of
rows of its images, and ``conv2d`` and ``max_pool2d`` fetch their halo
rows first (``parallel/spatial.py``).
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..core.mesh import active_bands

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
    the one rounding, so the two may differ by a bf16 step. Under
    ``core.mesh.bands``: x and the output are this rank's bands."""
    axis = active_bands()
    if axis is not None:
        from ..parallel import spatial

        return spatial.conv2d(x, weight, stride, padding, bias, axis)
    b = bias.to(x.dtype) if bias is not None else None
    y = F.conv2d(x.permute(0, 3, 1, 2), weight.to(x.dtype), b, stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def max_pool2d(
    x: torch.Tensor,
    kernel_size: IntPair,
    stride: IntPair,
    padding: IntPair = 0,
) -> torch.Tensor:
    """x: (N, H, W, C) -> (N, H', W', C); padding counts as -inf. Under
    ``core.mesh.bands``: x and the output are this rank's bands."""
    axis = active_bands()
    if axis is not None:
        from ..parallel import spatial

        return spatial.max_pool2d(x, kernel_size, stride, padding, axis)
    y = F.max_pool2d(x.permute(0, 3, 1, 2), kernel_size, stride, padding)
    return y.permute(0, 2, 3, 1)


def avg_pool2d(
    x: torch.Tensor,
    kernel_size: IntPair,
    stride: IntPair,
    padding: IntPair = 0,
    count_include_pad: bool = True,
) -> torch.Tensor:
    """x: (N, H, W, C) -> (N, H', W', C), torch's ``F.avg_pool2d``
    (``ops/conv.py:211-244`` of the JAX package): window sums in f32 over
    the count of taps, the padding counted or not, x's dtype back. The
    multi-scale discriminator's downsampler (3, 2, 1,
    ``count_include_pad=False``), the train variant's. Under
    ``core.mesh.bands`` x is this rank's band (``parallel.spatial.avg_pool2d``)."""
    axis = active_bands()
    if axis is not None:
        from ..parallel import spatial

        return spatial.avg_pool2d(x, kernel_size, stride, padding, count_include_pad, axis)
    y = F.avg_pool2d(x.permute(0, 3, 1, 2).float(), kernel_size, stride, padding,
                     count_include_pad=count_include_pad)
    return y.permute(0, 2, 3, 1).to(x.dtype)
