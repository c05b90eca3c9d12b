"""Dense layer. The JAX package stores the kernel (in, out); the port keeps
torch's (out, in) and the weight bridge (``checkpoint/convert.py``)
transposes. Output in x's dtype (``ops/linear.py:24-29``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """x (..., in), weight (out, in), bias (out,) -> (..., out)."""
    return F.linear(x, weight.to(x.dtype), bias.to(x.dtype))
