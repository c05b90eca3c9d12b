"""Gram matrices of NHWC activations — the namesake op.

Reference semantics (``ops/gram.py``): f = x.reshape(N, HW, C),
G = fᵀf / HW, and the family-2 head's adaptive_avg_pool2d(G, (S, S)) taken
through the exact identity P G Pᵀ = (fPᵀ)ᵀ(fPᵀ) with the bin-averaging
matrix P (``ops/pooling.py``); the kernel computes P's bins from (C, S)
and never reads P.

Both functions hand the (N, HW, C) view to ``ops/kernels/gram.py``: on a
CUDA tensor that launches the hand-written kernel, on a CPU tensor it takes
the kernel's plain PyTorch version. There is no backend switch: on the card
it is always the kernel. Activations stay ``channels_last``, so the NHWC
tensor is contiguous and the view costs nothing; on the card a tensor that
is not raises rather than being copied behind the caller's back.
"""
from __future__ import annotations

import torch

from .kernels import gram as gram_kernels


def _flat(x: torch.Tensor) -> torch.Tensor:
    n, h, w, c = x.shape
    if x.device.type == "cuda" and not x.is_contiguous():
        raise ValueError(
            f"Gram input (N, H, W, C)={tuple(x.shape)} is not contiguous "
            f"(strides {x.stride()}); keep activations in channels_last"
        )
    return x.reshape(n, h * w, c)


def gram_matrix_nhwc(x: torch.Tensor) -> torch.Tensor:
    """x: (N, H, W, C) -> (N, C, C), differentiable (the style loop's
    Gram; its backward is the ``gram_bwd`` kernel)."""
    return gram_kernels.GramFunction.apply(_flat(x))


def pooled_gram_nhwc(x: torch.Tensor, out_size: int) -> torch.Tensor:
    """x: (N, H, W, C) -> (N, S, S) = adaptive_avg_pool2d(gram(x), S).
    Forward only (the family-2 classifier in eval)."""
    return gram_kernels.pooled_gram_fwd(_flat(x), out_size)
