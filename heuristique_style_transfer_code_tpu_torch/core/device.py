"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for ``cpu``; a request
for CUDA on a host without it raises instead of falling back. On the card,
float32 stays float32: cuDNN would otherwise run f32 convolutions in TF32
(about three decimal digits) and parity with the JAX f32 path is lost.
"""
from __future__ import annotations

from typing import Union

import torch
from torch._subclasses.fake_tensor import FakeTensor


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available on this host; pass --device cpu "
                "(device='cpu') to run on the CPU"
            )
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return dev


def traced(t: torch.Tensor) -> bool:
    """Whether ``t`` is a tracer's fake tensor (``torch.export``,
    ``make_fx``). Its strides are the tracer's own guess: on CUDA it takes
    cuDNN's channels_last conv output for a contiguous NCHW one, so a
    layout check waits for the real tensor, which the kernel's wrapper
    checks when the traced program runs."""
    return isinstance(t, FakeTensor)


def transformed(t: torch.Tensor) -> bool:
    """Whether ``t`` is a ``torch.func`` transform's tensor (``vmap``,
    ``grad``: ``--parallel_folds``). Its layout is one fold's view of the
    stacked tensor; the ops' vmap rules hand the kernels dense copies."""
    return torch._C._functorch.is_functorch_wrapped_tensor(t)


def device_of(module: torch.nn.Module) -> torch.device:
    """The device of a model's parameters (where its inputs must go)."""
    return next(module.parameters()).device
