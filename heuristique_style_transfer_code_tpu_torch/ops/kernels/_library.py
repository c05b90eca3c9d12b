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

The ops run under ``torch.func`` transforms (``--parallel_folds`` takes
``vmap(grad(...))`` of a fold's step, ``parallel/foldparallel.py``). A
transform must meet an ``autograd.Function`` before the dispatcher, so
``call`` (the shims' entry) applies an op's ``_transformable`` Function
itself while a transform is active (the eager path keeps the lean one
above). Every op has a vmap rule (``fold_rule``) that folds the vmapped
axis into the image axis, so K folds are one launch of the kernel. A
backward op has no gradient; under a transform (whose ``grad`` always
builds the graph of its gradient) it raises only where a gradient of it
is taken.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

LIB = torch.library.Library("hst", "DEF")
_BELOW_AUTOGRAD = torch._C._after_autograd_keyset
_BACKENDS = (torch._C.DispatchKey.CPU, torch._C.DispatchKey.CUDA)
_IMPLS = {}  # op -> its implementation on CPU and CUDA tensors
_FUNCTIONS = {}  # op -> its Function under transforms (a backward op's refuses a gradient)
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


def _transformable(op, setup: Callable, grad: Callable) -> type:
    """``op``'s ``torch.autograd.Function`` for ``torch.func`` transforms
    (``call``): ``apply(*args)``, in the ``forward``/``setup_context``
    form they need, its forward the op itself (the transform hands it the
    tensors of the level below, and ``vmap`` reaches the op's rule), its
    vmap generated from it. Kept apart from ``_differentiable``'s, whose
    ``apply`` does not bind its arguments to a signature on every eager
    call, as this form's does."""

    class Function(torch.autograd.Function):
        generate_vmap_rule = True

        @staticmethod
        def forward(*args):
            return op(*args)

        @staticmethod
        def setup_context(ctx, inputs, output):
            ctx.keyset = None
            setup(ctx, inputs, output)

        @staticmethod
        def backward(ctx, *grads):
            return grad(ctx, *grads)

    Function.__name__ = f"{op._opname}_transform_function"
    return Function


def _no_setup(ctx, inputs, output):
    pass


def fold_rule(op) -> Callable:
    """The vmap rule of ``op``, whose every tensor argument and output
    leads with the image axis N: each vmapped argument's axis is folded
    into it ((K, N, ...) -> (K·N, ...)), an unvmapped tensor argument
    broadcast to the K folds (an expanded view, which the fold copies only
    because the kernels read dense operands), one call of ``op``, and each
    output cut back to (K, N, ...). Unvmapped arguments alone: one call,
    unvmapped outputs."""

    def rule(info, in_dims, *args):
        k = info.batch_size
        if all(d is None for d in in_dims):
            out = op(*args)
            return out, (tuple(None for _ in out) if isinstance(out, tuple) else None)
        folded = []
        for a, d in zip(args, in_dims):
            if isinstance(a, torch.Tensor):
                a = a.movedim(d, 0) if d is not None else a.expand(k, *a.shape)
                a = a.reshape(k * a.shape[1], *a.shape[2:]).contiguous()
            folded.append(a)
        out = op(*folded)
        if isinstance(out, tuple):
            return tuple(o.unflatten(0, (k, -1)) for o in out), tuple(0 for _ in out)
        return out.unflatten(0, (k, -1)), 0

    return rule


def call(op, *args):
    """``op`` on ``args`` from Python (the shims and ``backward_op``): the
    operator itself; under a ``torch.func`` transform its
    ``_transformable`` Function, which the transform must see before the
    dispatcher does."""
    if torch._C._are_functorch_transforms_active():
        return _FUNCTIONS[op].apply(*args)
    return op._op(*args)


def backward_op(ctx, op, *args):
    """The backward op ``op`` on ``args`` from a gradient's ``grad``. As
    the dispatcher would: where the forward ran on eager tensors and no
    gradient of the gradient is asked for, its implementation; otherwise
    through the dispatcher (a tracer records the op; a double backward is
    refused by its Autograd kernel), or under a ``torch.func`` transform
    through ``call``."""
    if ctx.keyset is None or torch._C._are_functorch_transforms_active():
        return call(op, *args)
    if not torch.is_grad_enabled() and _eager(ctx.keyset):
        return _IMPLS[op](*args)
    return op(*args)


def define(schema: str, impl: Callable, fake: Callable, setup: Optional[Callable] = None,
           grad: Optional[Callable] = None):
    """Register ``hst::<schema>`` and return its ``OpOverload``. With
    ``setup`` and ``grad`` it is differentiable; without, an input that
    needs a gradient raises (the backward ops are not differentiated;
    under a ``torch.func`` transform, through ``call``, only where that
    gradient is taken). Every op gets ``fold_rule`` as its vmap rule."""
    name = schema.split("(", 1)[0]
    LIB.define(schema)
    LIB.impl(name, impl, "CPU")
    LIB.impl(name, impl, "CUDA")
    torch.library.register_fake(f"hst::{name}", fake, lib=LIB)
    op = getattr(torch.ops.hst, name).default
    _IMPLS[op] = impl
    torch.library.register_vmap(op, fold_rule(op), lib=LIB)
    function = _differentiable(op, impl, setup, grad) if grad is not None else None
    if function is None:
        def refuse(ctx, *grads):
            raise RuntimeError(f"hst::{name} has no gradient")

        _FUNCTIONS[op] = _transformable(op, _no_setup, refuse)
    else:
        _FUNCTIONS[op] = _transformable(op, setup, grad)

    def autograd_kernel(keyset, *args):
        keyset = keyset & _BELOW_AUTOGRAD
        if torch.is_grad_enabled() and torch._C._any_requires_grad(*args):
            if function is None:
                raise RuntimeError(f"hst::{name} has no gradient")
            return function.apply(keyset, *args)
        return _below_autograd(op, impl, keyset, args)

    LIB.impl(name, autograd_kernel, "Autograd", with_keyset=True)
    return op
