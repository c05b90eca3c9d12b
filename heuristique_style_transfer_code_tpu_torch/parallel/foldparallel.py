"""Fold-parallel k-fold cross-validation (``--parallel_folds``;
``parallel/foldparallel.py`` of the JAX package).

The K folds share no state, only the hardware. As in JAX, the fold index
becomes a batch axis: the folds' parameters, batch-norm buffers and
optimiser states are stacked on a leading fold axis, one fold's loss and
gradients (``torch.func.functional_call`` and ``torch.func.grad``) are
``torch.func.vmap``-ed over it, and the SGD-momentum update, each fold's
global-norm clip and the EMA run over the stacked tensors
(``train/optim.py``'s ``update.folds``). Each ``hst`` kernel on the path
takes a rank's folds as one launch (its vmap rule folds the fold axis into
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

Over several ranks (``--devices N``) the folds go over the JAX
``make_fold_mesh``'s (fold, data) mesh, one process a device
(``core.mesh.FoldMesh``): fold group f holds folds ``[f K/F, (f+1) K/F)``
and its D ranks each hold their rows of every one of its folds' batches.
JAX shards the fold axis through ``shard_map`` and leaves the data axis to
GSPMD; here every collective of the data axis is written out, and all but
the batch norms' run outside the transform:

- each fold's global valid count, from its labels before the step (one
  all-reduce of the rank's K/F counts);
- the loss, this rank's masked NLL over the global count, whose gradients
  summed over the ranks are the global batch's;
- the stacked gradients and NLL sums, one bucketed all-reduce before the
  update, so each fold's clip sees its global gradient and the printed
  loss is the global one;
- inside the vmapped body the batch norms' statistics
  (``ops/norm.GlobalBatchNorm``'s vmap rules: the (K/F, C) sums of all the
  rank's folds in one collective, two forward, one backward), and the
  mixing's partner roll over the fold group's data axis.

``train_folds_parallel`` runs the rounds in lockstep on every rank (the
longest fold's batch count), gathers each round's losses on rank 0, which
prints them in fold order, and after training sends each fold's state from
its group's first rank to every rank, where ``train/kfold.py`` evaluates
it over the evaluation mesh.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.functional import call_with
from ..core.mesh import activate
from ..train.train_loop import _labels_on, _masked_nll_parts, _mixed
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
                             mix_fn: Optional[Callable] = None, mesh=None) -> Callable:
    """``step(stacked, batches, active) -> losses (K,)``: one train step of
    every fold in one vmapped program (the JAX ``make_foldwise_train_step``).

    ``stacked`` is ``stack_fold_states``'s, updated in place; ``batches``
    the K folds' loader batches (an inactive fold's is any batch of the
    same shape); ``active`` (K,) bools. ``forward_train``, ``optimizer``
    (``train/optim.sgd_momentum``), ``augment_fn``, ``label_smoothing`` and
    ``mix_fn`` are the sequential step's (``train_loop.make_train_step_body``).
    ``mesh``: the data axis of this rank's fold group
    (``core.mesh.FoldMesh.data_axis``); with more than one rank the K are
    this rank's folds, each batch its rows, and the losses the global ones
    (module docstring)."""
    _, update = optimizer
    dp = mesh if mesh is not None and mesh.distributed and mesh.world_size > 1 else None

    def fold_loss(model, train, fixed, buffers, images, labels_a, labels_b, lam, lam_b, count):
        logits = call_with(model, {**train, **fixed, **buffers}, forward_train, images)
        nll, _ = _masked_nll_parts(logits, labels_a, label_smoothing)
        if lam is not None:
            nll = lam * nll + lam_b * _masked_nll_parts(logits, labels_b, label_smoothing)[0]
        return nll / count.to(nll.dtype), nll

    grads_of = torch.func.grad(fold_loss, argnums=1, has_aux=True)

    def step(stacked: dict, batches: Sequence[dict], active: Sequence[bool]) -> torch.Tensor:
        names = list(stacked["trace"])
        device = stacked["trace"][names[0]].device
        train = {n: stacked["params"][n] for n in names}
        fixed = {n: t for n, t in stacked["params"].items() if n not in train}
        masked = not all(active)
        old = {n: t.clone() for n, t in stacked["buffers"].items()} if masked else None
        with activate(dp):
            images, labels_a, labels_b, lams = [], [], [], []
            for b in batches:
                x = augment_fn(torch.as_tensor(b["image"]).to(device), b.get("combo"),
                               b.get("draws"))
                x, la, lb, lam = _mixed(mix_fn, x, _labels_on(b["label"], device),
                                        b.get("mix_key"))
                images.append(x)
                labels_a.append(la)
                labels_b.append(lb)
                lams.append(lam)
            counts = torch.stack([(la >= 0).sum() for la in labels_a])
            if dp is not None:
                (counts,) = dp.all_reduce([counts])
            counts = counts.clamp_min(1)
            if mix_fn is None:
                lam = lam_b = None
                in_dims = (None, 0, 0, 0, 0, 0, 0, None, None, 0)
            else:
                lam = torch.tensor([float(v) for v in lams], device=device)
                lam_b = torch.tensor([1.0 - float(v) for v in lams], device=device)
                in_dims = (None,) + (0,) * 9
            grads, nll = torch.func.vmap(grads_of, in_dims=in_dims)(
                stacked["model"], train, fixed, stacked["buffers"], torch.stack(images),
                torch.stack(labels_a), torch.stack(labels_b), lam, lam_b, counts)
        if dp is not None:  # the gradients and NLL sums in one bucket
            reduced = dp.all_reduce(list(grads.values()) + [nll])
            grads, nll = dict(zip(grads, reduced[:-1])), reduced[-1]
        if masked:  # the forward moved every fold's running statistics
            on = torch.tensor(list(active), device=device)
            with torch.no_grad():
                for n, t in stacked["buffers"].items():
                    t.copy_(torch.where(on.reshape(-1, *([1] * (t.dim() - 1))), t, old[n]))
        update.folds(stacked["params"], grads, stacked, active)
        return (nll / counts.to(nll.dtype)).detach()

    return step


def _round_record(fold_mesh, record: List[Tuple[float, bool, int]]):
    """Every fold's (loss, active, valid count) of a round, in fold order,
    on the rank that prints (rank 0): one all-gather over the first ranks
    of the fold groups (the fold axis of data rank 0), whose losses are
    already their groups' global ones; None on every other rank."""
    if fold_mesh is None:
        return record
    if fold_mesh.index is None or fold_mesh.data_axis.rank != 0:
        return None
    t = torch.tensor(record, dtype=torch.float64, device=fold_mesh.world.device)
    parts = fold_mesh.fold_axis.all_gather(t)
    if not fold_mesh.world.is_main:
        return None
    return [(loss, bool(on), int(n)) for part in parts for loss, on, n in part.cpu().tolist()]


def broadcast_fold_states(fold_mesh, states: Sequence[Tuple[torch.nn.Module, dict]]) -> None:
    """Each fold group's trained folds from its first rank to every rank of
    the world, in place: parameters, buffers, trace, EMA and update count,
    one broadcast a dtype per group."""
    for f in range(fold_mesh.fold):
        tensors, opts = [], [states[k][1] for k in fold_mesh.folds(f)]
        for k in fold_mesh.folds(f):
            model, opt = states[k]
            tensors += [t for _, t in model.named_parameters()]
            tensors += [t for _, t in model.named_buffers()]
            tensors += [t for part in ("trace", "ema") for t in opt.get(part, {}).values()]
        counts = torch.tensor([int(o["count"]) for o in opts], dtype=torch.int64,
                              device=fold_mesh.world.device)
        # from the group's first rank, f D
        fold_mesh.world.broadcast_tensors(tensors + [counts], f * fold_mesh.data)
        for o, c in zip(opts, counts.tolist()):
            o["count"] = int(c)


def train_folds_parallel(step: Callable, states: Sequence[Tuple[torch.nn.Module, dict]],
                         loaders: Sequence, num_epochs: int,
                         log_fn: Callable[[str], None] = print, verbose_batches: bool = True,
                         writer=None, fold_mesh=None) -> List[Tuple[torch.nn.Module, dict]]:
    """The lockstep loop over ``make_foldwise_train_step`` (the JAX
    ``train_folds_parallel``): each round takes every fold's next batch, an
    exhausted fold goes inactive, and an epoch has as many rounds as its
    longest fold has batches. The reference's per-batch and per-epoch loss
    lines of each fold, interleaved in fold order, and each fold's
    TensorBoard train-loss scalar. ``states`` and ``loaders`` are the K
    folds'; on a ``fold_mesh`` (``core.mesh.FoldMesh``) this rank steps its
    group's folds alone (a rank that holds none, or whose folds are all
    inactive, passes the round through), rank 0 prints every fold's lines
    (``_round_record``; the epoch loss over each batch's global valid count)
    and the trained folds then reach every rank (``broadcast_fold_states``).
    Returns ``states`` with the trained folds written back
    (``unstack_fold_state``)."""
    k_folds = len(loaders)
    if len(states) != k_folds:
        raise ValueError(f"{len(states)} fold states for {k_folds} loaders")
    local = list(fold_mesh.folds()) if fold_mesh is not None else list(range(k_folds))
    stacked = stack_fold_states([states[k] for k in local]) if local else None
    n_batches = [len(loader) for loader in loaders]
    for epoch in range(num_epochs if local else 0):
        iters = [iter(loaders[k]) for k in local]
        batch_idx = [0] * k_folds
        running = [0.0] * k_folds
        seen = [0] * k_folds
        for _ in range(max(n_batches)):
            raw = [next(it, None) for it in iters]
            active = [b is not None for b in raw]
            losses = [0.0] * len(local)
            if any(active):
                first = next(b for b in raw if b is not None)
                dummy = dict(first, label=np.full_like(first["label"], -1), n_valid=0)
                losses = step(stacked, [b if b is not None else dummy for b in raw],
                              active).cpu().tolist()
            record = _round_record(fold_mesh, [(loss, on, b["n_valid"] if on else 0)
                                               for loss, on, b in zip(losses, active, raw)])
            for k, (loss, on, n) in enumerate(record or ()):
                if not on:
                    continue
                check_nan("the training loss", loss)
                running[k] += loss * n
                seen[k] += n
                if verbose_batches:
                    log_fn(f"Fold {k}, Epoch [{epoch + 1}/{num_epochs}], "
                           f"Batch [{batch_idx[k] + 1}/{n_batches[k]}], Loss: {loss:.4f}")
                batch_idx[k] += 1
        if fold_mesh is not None and not fold_mesh.world.is_main:
            continue
        for k in range(k_folds):
            epoch_loss = running[k] / max(seen[k], 1)
            log_fn(f"Fold {k}, Epoch [{epoch + 1}/{num_epochs}], Loss: {epoch_loss:.4f}")
            if writer is not None:
                writer.add_scalar(f"Fold_{k}/Train/Loss", epoch_loss, epoch)
    if local:
        unstack_fold_state(stacked, [states[k] for k in local])
    if fold_mesh is not None:
        broadcast_fold_states(fold_mesh, states)
    return list(states)
