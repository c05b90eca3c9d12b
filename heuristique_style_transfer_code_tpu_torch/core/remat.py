"""Rematerialisation (``--remat``): the counterpart of the JAX package's
``jax.checkpoint`` around each bottleneck (``nn/resnet.py:135-139``) and
each strided discriminator unit (``nn/patch_discriminator.py:109-120``).

``remat_call(fn, *args)`` runs ``fn`` under
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``: the
forward keeps only the block's inputs for the backward, which runs the
block again to rebuild what it needs. JAX's remat is functional, so a
train-mode batch norm inside the block updates its running statistics
once; here ``F.batch_norm`` updates them in place, so the recompute would
apply the momentum a second time. The recompute therefore runs with
``recomputing()`` true, and ``ops/norm.batch_norm`` then updates copies of
the buffers: the same ops, the same saved tensors, and the running
statistics those of one forward.
"""
from __future__ import annotations

import contextlib
import threading

import torch
from torch.utils.checkpoint import checkpoint

_STATE = threading.local()  # the recompute runs on the backward's thread


def recomputing() -> bool:
    """True while a remat block is being recomputed for its backward."""
    return getattr(_STATE, "on", False)


@contextlib.contextmanager
def _recompute_context():
    previous = recomputing()
    _STATE.on = True
    try:
        yield
    finally:
        _STATE.on = previous


def _contexts():
    return contextlib.nullcontext(), _recompute_context()


def remat_call(fn, *args):
    """``fn(*args)``, its intermediates recomputed in the backward instead
    of kept. Without a gradient to take (evaluation) it is a plain call."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False, context_fn=_contexts)
