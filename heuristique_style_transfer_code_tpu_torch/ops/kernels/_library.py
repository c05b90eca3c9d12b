"""The ``hst`` operator namespace: each kernel wrapper registered as a
``torch.library`` op, so that ``torch.export`` traces it as one node (a
``ctypes`` call cannot be traced) and an exported program runs the kernel.

An op is defined by its schema, and has three implementations: on CPU and
CUDA tensors the wrapper itself (the plain version on a CPU tensor, the
kernel on a CUDA one), and a fake one giving the wrapper's output shapes
and dtypes. Its Autograd kernel is written here by hand, as lean as the
``torch.autograd.Function`` the wrappers were called from before: where a
gradient flows it runs the op inside a ``torch.autograd.Function`` whose
backward calls the backward op (so a traced backward holds ``hst::*_bwd``
nodes); otherwise it goes on below autograd. Below autograd, where the
backend is all that is left of the dispatch keys (eager tensors), it calls
the implementation itself, as the dispatcher would next; a tracer's fake
tensors or a dispatch mode are redispatched. ``torch.library``'s
``custom_op`` cost a family-3 style iteration a fifth more host time on
the card than the ``autograd.Function``s (PERF.md).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

LIB = torch.library.Library("hst", "DEF")
_BELOW_AUTOGRAD = torch._C._after_autograd_keyset
_BACKENDS = (torch._C.DispatchKey.CPU, torch._C.DispatchKey.CUDA)
_IMPLS = {}  # op -> its implementation on CPU and CUDA tensors
_EAGER = {}  # a key set's raw bits -> whether a backend is its first key


def _eager(keyset) -> bool:
    """Whether the dispatcher's next stop for ``keyset`` is a backend
    kernel: no tracer, mode or tensor subclass is left to see the op."""
    raw = keyset.raw_repr()
    eager = _EAGER.get(raw)
    if eager is None:
        eager = _EAGER[raw] = keyset.highestPriorityTypeId() in _BACKENDS
    return eager


def _below_autograd(op, impl: Callable, keyset, args):
    """``op`` on ``args`` below autograd (``keyset`` has no autograd key)."""
    if _eager(keyset):
        return impl(*args)
    with torch._C._AutoDispatchBelowAutograd():
        return op.redispatch(keyset, *args)


def _differentiable(op, impl: Callable, setup: Callable, grad: Callable) -> type:
    """The ``torch.autograd.Function`` of ``op``: ``apply(keyset, *args)``
    runs the op below autograd, ``setup(ctx, args, output)`` saves what
    ``grad(ctx, *output_grads)`` needs to return the inputs' gradients."""

    class Function(torch.autograd.Function):
        @staticmethod
        def forward(ctx, keyset, *args):
            out = _below_autograd(op, impl, keyset, args)
            ctx.keyset = keyset
            setup(ctx, args, out)
            return out

        @staticmethod
        def backward(ctx, *grads):
            return (None, *grad(ctx, *grads))

    Function.__name__ = f"{op._opname}_function"
    return Function


def backward_op(ctx, op, *args):
    """The backward op ``op`` on ``args`` from a gradient's ``grad``. As
    the dispatcher would: where the forward ran on eager tensors and no
    gradient of the gradient is asked for, its implementation; otherwise
    through the dispatcher (a tracer records the op; a double backward is
    refused by its Autograd kernel)."""
    if not torch.is_grad_enabled() and _eager(ctx.keyset):
        return _IMPLS[op](*args)
    return op(*args)


def define(schema: str, impl: Callable, fake: Callable, setup: Optional[Callable] = None,
           grad: Optional[Callable] = None):
    """Register ``hst::<schema>`` and return its ``OpOverload``. With
    ``setup`` and ``grad`` it is differentiable; without, an input that
    needs a gradient raises (the backward ops are not differentiated)."""
    name = schema.split("(", 1)[0]
    LIB.define(schema)
    LIB.impl(name, impl, "CPU")
    LIB.impl(name, impl, "CUDA")
    torch.library.register_fake(f"hst::{name}", fake, lib=LIB)
    op = getattr(torch.ops.hst, name).default
    _IMPLS[op] = impl
    function = _differentiable(op, impl, setup, grad) if grad is not None else None

    def autograd_kernel(keyset, *args):
        keyset = keyset & _BELOW_AUTOGRAD
        if torch.is_grad_enabled() and torch._C._any_requires_grad(*args):
            if function is None:
                raise RuntimeError(f"hst::{name} has no gradient")
            return function.apply(keyset, *args)
        return _below_autograd(op, impl, keyset, args)

    LIB.impl(name, autograd_kernel, "Autograd", with_keyset=True)
    return op
