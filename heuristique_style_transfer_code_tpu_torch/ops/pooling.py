"""Adaptive average pooling as a constant averaging matrix
(``ops/pooling.py:21-33``), the adaptive average pool of NHWC maps
(``ops/pooling.py:35``), and the global average pool of the avgpool child
(``ops/pooling.py:46-54``).

torch's adaptive bins are start = floor(i*In/Out), end = ceil((i+1)*In/Out);
when Out does not divide In the bins overlap (C=256, S=7 is such a case), so
the pooled-Gram kernel takes this exact matrix rather than assuming disjoint
equal bins.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..core.mesh import active_bands


@functools.lru_cache(maxsize=None)
def _pool_matrix_np(in_size: int, out_size: int) -> np.ndarray:
    P = np.zeros((out_size, in_size), dtype=np.float32)
    for i in range(out_size):
        start = (i * in_size) // out_size
        end = -((-(i + 1) * in_size) // out_size)  # ceil
        P[i, start:end] = 1.0 / (end - start)
    return P


@functools.lru_cache(maxsize=64)
def _pool_matrix_on(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_pool_matrix_np(in_size, out_size), device=device)


def adaptive_pool_matrix(
    in_size: int, out_size: int, device: torch.device = torch.device("cpu")
) -> torch.Tensor:
    """(out, in) float32 averaging matrix, kept on ``device`` after its first
    use there (the forward takes it at every stage; a fresh host copy each
    time would stall the stream)."""
    return _pool_matrix_on(in_size, out_size, torch.device(device))


def adaptive_avg_pool2d(x: torch.Tensor, output_size) -> torch.Tensor:
    """NHWC (N, H, W, C) -> (N, oh, ow, C), ``F.adaptive_avg_pool2d``'s
    bins (those of ``adaptive_pool_matrix``). The JAX package computes it
    as two XLA products with the averaging matrices, not as a kernel, so
    PyTorch's op runs here, on the channels_last view of x. Under
    ``core.mesh.bands`` x is this rank's band and the pooled map, summed
    over the ranks, is whole on each (``parallel/spatial.py``)."""
    axis = active_bands()
    if axis is not None:
        from ..parallel import spatial

        return spatial.adaptive_avg_pool2d(x, output_size, axis)
    y = F.adaptive_avg_pool2d(x.permute(0, 3, 1, 2), output_size)
    return y.permute(0, 2, 3, 1)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """NHWC (N, H, W, C) -> (N, C): AdaptiveAvgPool2d((1, 1)) + Flatten.
    Reduces in f32 for f32 and bf16 inputs (f64 stays f64); returns x's
    dtype. Under ``core.mesh.bands``: the whole map's mean from this
    rank's band."""
    axis = active_bands()
    if axis is not None:
        from ..parallel import spatial

        return spatial.global_avg_pool(x, axis)
    ctype = torch.float64 if x.dtype == torch.float64 else torch.float32
    return x.to(ctype).mean(dim=(1, 2)).to(x.dtype)
