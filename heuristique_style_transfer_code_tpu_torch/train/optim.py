"""SGD with momentum and the trainability mask (``train/optim.py`` of the
JAX package: ``label_tree`` ``:38-55``, ``sgd_momentum`` ``:132-150``).

The reference trains with ``optim.SGD(params, lr, momentum=0.9)`` over the
parameters that require a gradient. The JAX package writes that as
``optax.sgd`` inside ``optax.multi_transform``, with the batch-norm running
statistics and any user-frozen subtree (``--freeze_layers``) labelled
"freeze". Here the same update is written out to optax's formulas, on the
module's parameters in place: the trace m <- g + 0.9 m, then p <- p - lr m,
with a schedule evaluated at the update count before its increment, and
``clip_by_global_norm`` over the trainable parameters only.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

BN_STAT_KEYS = ("running_mean", "running_var")  # the JAX tree's "mean" and "var"
MOMENTUM = 0.9


def label_tree(model: torch.nn.Module,
               frozen_fn: Optional[Callable[[str], bool]] = None) -> Dict[str, str]:
    """{state-dict key: "train" | "freeze"} over the model's parameters and
    buffers. The batch norms' running statistics are always frozen (the
    forward updates them); ``frozen_fn`` gets each parameter's dotted path,
    whose module part is the JAX tree's path (the module tree mirrors it),
    and freezes those it returns True for."""
    labels = {}
    for key in model.state_dict():
        if key.split(".")[-1] in BN_STAT_KEYS:
            labels[key] = "freeze"
        elif frozen_fn is not None and frozen_fn(key):
            labels[key] = "freeze"
        else:
            labels[key] = "train"
    return labels


def sgd_momentum(learning_rate, momentum: float = MOMENTUM,
                 frozen_fn: Optional[Callable[[str], bool]] = None,
                 clip_norm: Optional[float] = None,
                 ema_decay: Optional[float] = None) -> Tuple[Callable, Callable]:
    """``torch.optim.SGD(momentum=0.9, dampening=0, nesterov=False)`` over
    the trainable parameters, as the JAX ``sgd_momentum``.

    Returns ``(init, update)``: ``init(model)`` the state ``{"count": 0,
    "trace": {name: zeros}}`` over the parameters ``label_tree`` labels
    "train" (the mask), ``update(model, grads, state)`` (grads by name) one
    update of those parameters and the state, in place. ``learning_rate``
    is a float or a schedule (``train/schedules.py``) of the update count.
    ``clip_norm`` scales the gradients by ``clip_norm / norm`` where their
    global norm exceeds it, as ``optax.clip_by_global_norm`` does.
    ``ema_decay`` is not ported yet."""
    if ema_decay is not None:
        raise NotImplementedError("--ema_decay (the parameter EMA) is not ported yet")
    schedule = learning_rate if callable(learning_rate) else None

    def init(model: torch.nn.Module) -> dict:
        labels = label_tree(model, frozen_fn)
        return {"count": 0, "trace": {n: torch.zeros_like(p) for n, p in model.named_parameters()
                                      if labels[n] == "train"}}

    def update(model: torch.nn.Module, grads: Dict[str, torch.Tensor], state: dict) -> None:
        params = dict(model.named_parameters())
        names = list(state["trace"])
        count = state["count"]
        lr = schedule(count) if schedule is not None else learning_rate
        with torch.no_grad():
            gs = [grads[n] for n in names]
            if clip_norm is not None:
                norm = torch.sqrt(sum(torch.sum(g * g) for g in gs))
                gs = [torch.where(norm < clip_norm, g, g / norm * clip_norm) for g in gs]
            for n, g in zip(names, gs):
                trace = state["trace"][n]
                trace.mul_(momentum).add_(g)
                params[n].add_(trace * -lr)
        state["count"] = count + 1

    return init, update
