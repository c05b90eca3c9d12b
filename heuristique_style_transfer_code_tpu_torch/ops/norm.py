"""Eval-mode batch norm on NHWC tensors (``ops/norm.py:29-47``): statistics
and arithmetic in f32 (f64 stays f64), one cast back to x's dtype. Train
mode, with its running-stat updates, comes with training."""
from __future__ import annotations

import torch

EPS = 1e-5


def batch_norm(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    mean: torch.Tensor,
    var: torch.Tensor,
    eps: float = EPS,
) -> torch.Tensor:
    """x: (N, H, W, C); per-channel (C,) scale/bias and running mean/var."""
    ctype = torch.float64 if x.dtype == torch.float64 else torch.float32
    inv = scale.to(ctype) * torch.rsqrt(var.to(ctype) + eps)
    shift = bias.to(ctype) - mean.to(ctype) * inv
    return (x.to(ctype) * inv + shift).to(x.dtype)
