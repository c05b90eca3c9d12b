"""``torch.func.functional_call`` over a function of a module: the port's
forwards are functions ``fn(model, *args)`` (``forward_train``,
``resnet50_apply``), not the modules' own ``forward``."""
from __future__ import annotations

from typing import Callable, Mapping

import torch


class _Bound(torch.nn.Module):
    def __init__(self, module: torch.nn.Module, fn: Callable):
        super().__init__()
        self.module = module
        self._fn = fn

    def forward(self, *args):
        return self._fn(self.module, *args)


def call_with(module: torch.nn.Module, tensors: Mapping[str, torch.Tensor], fn: Callable,
              *args):
    """``fn(module, *args)`` with ``module``'s parameters and buffers named
    in ``tensors`` (by their ``named_parameters`` names) swapped for those
    tensors for the call (``torch.func.functional_call``: under ``vmap``
    and ``grad`` too); the others stay the module's own."""
    return torch.func.functional_call(
        _Bound(module, fn), {"module." + n: t for n, t in tensors.items()}, args)
