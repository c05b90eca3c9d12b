"""Gram matrices of NHWC activations — the namesake op.

Reference semantics (``ops/gram.py``): f = x.reshape(N, HW, C),
G = fᵀf / HW, and the family-2 head's adaptive_avg_pool2d(G, (S, S)) taken
through the exact identity P G Pᵀ = (fPᵀ)ᵀ(fPᵀ) with the bin-averaging
matrix P (``ops/pooling.py``); the kernel computes P's bins from (C, S)
and never reads P. The family-3 discriminator's Gram of its pooled maps
(``gram_matrix_ncl``) divides by L + eps.

Both functions hand the (N, HW, C) view to ``ops/kernels/gram.py``: on a
CUDA tensor that launches the hand-written kernel, on a CPU tensor it takes
the kernel's plain PyTorch version. There is no backend switch: on the card
it is always the kernel. Activations stay ``channels_last``, so the NHWC
tensor is contiguous and the view costs nothing; on the card a tensor that
is not raises rather than being copied behind the caller's back.

Under ``core.mesh.bands`` (``--shard_spatial``) the NHWC Grams are the
whole image's, from the kernels on this rank's band
(``parallel.spatial.gram``).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.device import traced, transformed
from ..core.mesh import active_bands
from .kernels import gram as gram_kernels


def _flat(x: torch.Tensor) -> torch.Tensor:
    n, h, w, c = x.shape
    if (x.device.type == "cuda" and not x.is_contiguous() and not traced(x)
            and not transformed(x)):
        raise ValueError(
            f"Gram input (N, H, W, C)={tuple(x.shape)} is not contiguous "
            f"(strides {x.stride()}); keep activations in channels_last"
        )
    return x.reshape(n, h * w, c)


def gram_matrix_nhwc(x: torch.Tensor) -> torch.Tensor:
    """x: (N, H, W, C) -> (N, C, C), differentiable (the style loop's
    Gram; its backward is the ``gram_bwd`` kernel)."""
    axis = active_bands()
    if axis is not None:
        from ..parallel import spatial

        return spatial.gram(gram_kernels.GramFunction, _flat(x), axis)
    return gram_kernels.GramFunction.apply(_flat(x))


def pooled_gram_nhwc(x: torch.Tensor, out_size: int) -> torch.Tensor:
    """x: (N, H, W, C) -> (N, S, S) = adaptive_avg_pool2d(gram(x), S),
    differentiable: always ``PooledGramFunction``, whose forward is the
    ``pooled_gram_fwd`` kernel and whose backward, where a gradient flows
    (family-2 training with the encoder trainable), ``pooled_gram_bwd``.
    Evaluation and a frozen encoder launch the forward alone."""
    axis = active_bands()
    if axis is not None:
        from ..parallel import spatial

        return spatial.gram(gram_kernels.PooledGramFunction, _flat(x), axis, int(out_size))
    return gram_kernels.PooledGramFunction.apply(_flat(x), out_size)


def gram_matrix_ncl(f: torch.Tensor, denom: Optional[float] = None) -> torch.Tensor:
    """f: (N, C, L) -> (N, C, C) = f fᵀ / denom (default L), in f's dtype
    (``ops/gram.py:34``; the family-3 discriminator passes L + 1e-6),
    differentiable: ``GramFunction`` takes fᵀ, the (N, L, C) view (f32 sums
    of f fᵀ / L, cast once; backward ``gram_bwd``); a ``denom`` other than
    L then rescales by L / denom in f32. The discriminator's f is the
    transpose of its pooled NHWC map (N, L, C), so on the card fᵀ is
    contiguous; any other layout raises there."""
    g = gram_kernels.GramFunction.apply(f.transpose(1, 2))
    length = f.shape[-1]
    if denom is None or denom == length:
        return g
    return (g.float() * (length / denom)).to(f.dtype)
