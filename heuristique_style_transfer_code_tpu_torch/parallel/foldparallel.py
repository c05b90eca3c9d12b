"""Fold-parallel k-fold cross-validation on one card (``--parallel_folds``;
``parallel/foldparallel.py`` of the JAX package).

The K folds share no state, only the card. As in JAX, the fold index
becomes a batch axis: the K folds' parameters, batch-norm buffers and
optimiser states are stacked on a leading fold axis, one fold's loss and
gradients (``torch.func.functional_call`` and ``torch.func.grad``) are
``torch.func.vmap``-ed over it, and the SGD-momentum update, each fold's
global-norm clip and the EMA run over the stacked tensors
(``train/optim.py``'s ``update.folds``). Each ``hst`` kernel on the path
takes the K folds as one launch (its vmap rule folds the fold axis into
the image axis, ``ops/kernels/_library.py``); convolutions with per-fold
weights become grouped ones.

Each fold's trajectory is the sequential loop's: the same init (seed +
fold), the same loader (its own shuffle, augmentation draws and mixing
key) and the same formulas. The augmentation and the mixing run per fold
before the vmapped body: they hold no parameter, and the draws are the
loader's. Folds whose epoch ends early go inactive: their parameters,
buffers and optimiser state pass through ``torch.where`` unchanged, since
a zero-gradient step would still move their momentum and running
statistics.

The JAX package shards the fold axis over a device mesh; here every fold
shares the one card (several cards are not ported yet), so the gain is
what one program of K folds saves over K programs (PERF.md).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.functional import call_with
from ..train.train_loop import _labels_on, _mixed, masked_cross_entropy
from ..utils.debug import check_nan


def stack_fold_states(states: Sequence[Tuple[torch.nn.Module, dict]]) -> dict:
    """The K folds' ``(model, opt_state)`` stacked on a leading fold axis:
    ``{"params", "buffers", "trace"[, "ema"]}`` by name, ``"count"``, the
    K update counts, and ``"model"``, fold 0's model as the architecture
    (``functional_call`` swaps its tensors for each fold's)."""
    models = [m for m, _ in states]
    opts = [o for _, o in states]
    with torch.no_grad():
        out = {
            "params": {n: torch.stack([dict(m.named_parameters())[n].detach() for m in models])
                       for n, _ in models[0].named_parameters()},
            "buffers": {n: torch.stack([dict(m.named_buffers())[n] for m in models])
                        for n, _ in models[0].named_buffers()},
        }
        for part in ("trace", "ema"):
            if part in opts[0]:
                out[part] = {n: torch.stack([o[part][n] for o in opts]) for n in opts[0][part]}
    out["count"] = [int(o["count"]) for o in opts]
    out["model"] = models[0]
    return out


def unstack_fold_state(stacked: dict, states: Sequence[Tuple[torch.nn.Module, dict]]
                       ) -> List[Tuple[torch.nn.Module, dict]]:
    """Fold k's slice of ``stacked`` written back into ``states[k]``'s model
    and optimiser state, in place; returns ``states``."""
    with torch.no_grad():
        for k, (model, opt) in enumerate(states):
            for part, tensors in (("params", dict(model.named_parameters())),
                                  ("buffers", dict(model.named_buffers())),
                                  ("trace", opt.get("trace", {})), ("ema", opt.get("ema", {}))):
                for n, t in tensors.items():
                    t.copy_(stacked[part][n][k])
            opt["count"] = stacked["count"][k]
    return list(states)


def make_foldwise_train_step(forward_train: Callable, optimizer, augment_fn: Callable,
                             label_smoothing: float = 0.0,
                             mix_fn: Optional[Callable] = None) -> Callable:
    """``step(stacked, batches, active) -> losses (K,)``: one train step of
    every fold in one vmapped program (the JAX ``make_foldwise_train_step``).

    ``stacked`` is ``stack_fold_states``'s, updated in place; ``batches``
    the K folds' loader batches (an inactive fold's is any batch of the
    same shape); ``active`` (K,) bools. ``forward_train``, ``optimizer``
    (``train/optim.sgd_momentum``), ``augment_fn``, ``label_smoothing`` and
    ``mix_fn`` are the sequential step's (``train_loop.make_train_step_body``)."""
    _, update = optimizer

    def fold_loss(model, train, fixed, buffers, images, labels_a, labels_b, lam, lam_b):
        logits = call_with(model, {**train, **fixed, **buffers}, forward_train, images)
        loss = masked_cross_entropy(logits, labels_a, label_smoothing)
        if lam is not None:
            loss = lam * loss + lam_b * masked_cross_entropy(logits, labels_b, label_smoothing)
        return loss, loss

    grads_of = torch.func.grad(fold_loss, argnums=1, has_aux=True)

    def step(stacked: dict, batches: Sequence[dict], active: Sequence[bool]) -> torch.Tensor:
        names = list(stacked["trace"])
        device = stacked["trace"][names[0]].device
        train = {n: stacked["params"][n] for n in names}
        fixed = {n: t for n, t in stacked["params"].items() if n not in train}
        images, labels_a, labels_b, lams = [], [], [], []
        for b in batches:
            x = augment_fn(torch.as_tensor(b["image"]).to(device), b.get("combo"), b.get("draws"))
            x, la, lb, lam = _mixed(mix_fn, x, _labels_on(b["label"], device), b.get("mix_key"))
            images.append(x)
            labels_a.append(la)
            labels_b.append(lb)
            lams.append(lam)
        masked = not all(active)
        old = {n: t.clone() for n, t in stacked["buffers"].items()} if masked else None
        if mix_fn is None:
            lam = lam_b = None
            in_dims = (None, 0, 0, 0, 0, 0, 0, None, None)
        else:
            lam = torch.tensor([float(v) for v in lams], device=device)
            lam_b = torch.tensor([1.0 - float(v) for v in lams], device=device)
            in_dims = (None,) + (0,) * 8
        grads, losses = torch.func.vmap(grads_of, in_dims=in_dims)(
            stacked["model"], train, fixed, stacked["buffers"],
            torch.stack(images), torch.stack(labels_a), torch.stack(labels_b), lam, lam_b)
        if masked:  # the forward moved every fold's running statistics
            on = torch.tensor(list(active), device=device)
            with torch.no_grad():
                for n, t in stacked["buffers"].items():
                    t.copy_(torch.where(on.reshape(-1, *([1] * (t.dim() - 1))), t, old[n]))
        update.folds(stacked["params"], grads, stacked, active)
        return losses.detach()

    return step


def train_folds_parallel(step: Callable, states: Sequence[Tuple[torch.nn.Module, dict]],
                         loaders: Sequence, num_epochs: int,
                         log_fn: Callable[[str], None] = print, verbose_batches: bool = True,
                         writer=None) -> List[Tuple[torch.nn.Module, dict]]:
    """The host's lockstep loop over ``make_foldwise_train_step`` (the JAX
    ``train_folds_parallel``): each round takes every fold's next batch,
    an exhausted fold goes inactive, and the round ends the epoch when
    none is left. The reference's per-batch and per-epoch loss lines of
    each fold, interleaved in fold order, and each fold's TensorBoard
    train-loss scalar. Returns ``states`` with the trained folds written
    back (``unstack_fold_state``)."""
    k_folds = len(loaders)
    if len(states) != k_folds:
        raise ValueError(f"{len(states)} fold states for {k_folds} loaders")
    stacked = stack_fold_states(states)
    n_batches = [len(loader) for loader in loaders]
    for epoch in range(num_epochs):
        iters = [iter(loader) for loader in loaders]
        batch_idx = [0] * k_folds
        running = [0.0] * k_folds
        seen = [0] * k_folds
        while True:
            raw = [next(it, None) for it in iters]
            active = [b is not None for b in raw]
            if not any(active):
                break
            first = next(b for b in raw if b is not None)
            dummy = dict(first, label=np.full_like(first["label"], -1), n_valid=0)
            losses = step(stacked, [b if b is not None else dummy for b in raw], active)
            losses = losses.cpu().tolist()
            for k in range(k_folds):
                if not active[k]:
                    continue
                check_nan("the training loss", losses[k])
                n = raw[k]["n_valid"]
                running[k] += losses[k] * n
                seen[k] += n
                if verbose_batches:
                    log_fn(f"Fold {k}, Epoch [{epoch + 1}/{num_epochs}], "
                           f"Batch [{batch_idx[k] + 1}/{n_batches[k]}], Loss: {losses[k]:.4f}")
                batch_idx[k] += 1
        for k in range(k_folds):
            epoch_loss = running[k] / max(seen[k], 1)
            log_fn(f"Fold {k}, Epoch [{epoch + 1}/{num_epochs}], Loss: {epoch_loss:.4f}")
            if writer is not None:
                writer.add_scalar(f"Fold_{k}/Train/Loss", epoch_loss, epoch)
    return unstack_fold_state(stacked, states)

