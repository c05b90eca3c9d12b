"""Dense layer. The JAX package stores the kernel (in, out); the port keeps
torch's (out, in) and the weight bridge (``checkpoint/convert.py``)
transposes. Output in x's dtype (``ops/linear.py:24-29``). A head that
``parallel.tensor_parallel.shard_heads`` split over a mesh's model axis
holds its block of rows and runs ``column_linear``."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """x (..., in), weight (out, in), bias (out,) -> (..., out)."""
    return F.linear(x, weight.to(x.dtype), bias.to(x.dtype))


class Linear(nn.Module):
    """torch (out, in) weight; U(-1/sqrt(in), 1/sqrt(in)) init.
    ``column_split`` is (model axis, bias split) on a split head, else
    None."""

    column_split = None

    def __init__(self, cin: int, cout: int, generator=None, device=None, dtype=torch.float32):
        super().__init__()
        bound = 1.0 / cin ** 0.5
        self.weight = nn.Parameter(
            (torch.rand((cout, cin), generator=generator, dtype=dtype) * 2 - 1).mul_(bound).to(device)
        )
        self.bias = nn.Parameter(
            (torch.rand((cout,), generator=generator, dtype=dtype) * 2 - 1).mul_(bound).to(device)
        )

    def forward(self, x):
        if self.column_split is not None:
            from ..parallel.tensor_parallel import column_linear

            return column_linear(x, self.weight, self.bias, *self.column_split)
        return linear(x, self.weight, self.bias)
