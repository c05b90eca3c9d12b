"""Train and eval steps and the epoch loops (``train/train_loop.py`` of the
JAX package, single device).

One train step: the staged uint8 batch to the device, the augmentation
(each image's combination and host-drawn parameters, ``data/augment.py``),
the forward in train mode (the batch norms update their running buffers in
place: the JAX step's ``_merge_bn_stats``), the masked cross-entropy, the
gradients of the trainable parameters and the optimiser's update in place.
Pad entries of a short batch carry label -1 and are masked out of the loss
and the metrics. The step returns the loss as a device tensor, without a
sync; ``train_epochs`` fetches it for the per-batch print, as the JAX loop
does, or, with ``steps_per_dispatch`` K > 1, fetches K steps' losses at
once. ``make_train_step_accum`` is ``--grad_accum``'s step. With a
``mix_fn`` (``train/mixing.make_mix_fn``: ``--mixup``, ``--cutmix``) the
augmented batch is mixed with its rolled partner before the forward and
the loss is ``lam * CE(y) + (1 - lam) * CE(y_partner)``, label smoothing
applying to both terms; the batch's mixing key is the loader's
``"mix_key"``.

Data parallelism (``mesh``, a ``core.mesh.Mesh`` of more than one rank,
the JAX ``mesh=`` whose collectives GSPMD inserts): each rank runs the step
on its rows of the global batch (the loader gives them) under
``core.mesh.activate``, so the batch norms take the global batch's
statistics and the mixing rolls the global batch. The loss is the global
masked NLL sum over the global valid count (one all-reduce of the two
after the forward), not a mean of per-rank means; a rank whose rows are
all padding contributes nothing. The optimiser's ``update`` reduces the
gradients (``train/optim.py``): one reduction a step, also under
``--grad_accum``. The model is not wrapped in DDP: the loss's global
count and the hand-written optimiser need the reduction written out.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..core.mesh import activate, data_parallel, gather_valid
from ..data.augment import eval_preprocess
from ..utils.debug import check_nan


def _labels_on(labels, device) -> torch.Tensor:
    """A batch's labels (numpy, or a tensor already on the card) on
    ``device``."""
    return (labels if torch.is_tensor(labels) else torch.as_tensor(np.asarray(labels))).to(device)


def _masked_nll_parts(logits: torch.Tensor, labels: torch.Tensor,
                      label_smoothing: float = 0.0):
    """(masked NLL sum, valid count), in f32 (f64 stays f64): the entries
    with label >= 0 only. ``label_smoothing`` follows
    ``F.cross_entropy``: (1 - eps) (-log p[y]) + eps mean_c(-log p[c])."""
    ctype = torch.float64 if logits.dtype == torch.float64 else torch.float32
    valid = (labels >= 0).to(ctype)
    logp = torch.log_softmax(logits.to(ctype), dim=-1)
    safe = labels.clamp(0, logits.shape[-1] - 1).long()
    ll = logp.gather(1, safe[:, None])[:, 0]
    if label_smoothing:
        eps = float(label_smoothing)
        ll = (1.0 - eps) * ll + eps * logp.mean(dim=-1)
    return -(ll * valid).sum(), valid.sum()


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean cross-entropy over the entries with label >= 0 (pads are -1)."""
    nll, cnt = _masked_nll_parts(logits, labels, label_smoothing)
    return nll / cnt.clamp_min(1.0)


def _mixed(mix_fn, images, labels, mix_key):
    """(images, labels_a, labels_b, lam) of the mixed batch; lam None
    without ``mix_fn``."""
    if mix_fn is None:
        return images, labels, labels, None
    if mix_key is None:
        raise ValueError("batch mixing needs the batch's mix_key (the loader's draw_key)")
    return mix_fn(images, labels, mix_key)


def _global_loss(dp, nll: torch.Tensor, cnt: torch.Tensor):
    """(this rank's share of the global loss, for its gradients; the
    global loss): its NLL sum and the global one over the global valid
    count."""
    g_nll, g_cnt = dp.all_reduce([nll.detach(), cnt])
    denom = g_cnt.clamp_min(1.0)
    return nll / denom, g_nll / denom


def _mixed_nll(logits, labels_a, labels_b, lam, label_smoothing):
    """(masked NLL sum, valid count) of the mixed loss: ``lam * nll(y) +
    (1 - lam) * nll(y_partner)`` over the one count of ``labels_a``."""
    nll, cnt = _masked_nll_parts(logits, labels_a, label_smoothing)
    if lam is not None:
        nll_b, _ = _masked_nll_parts(logits, labels_b, label_smoothing)
        nll = lam * nll + (1.0 - lam) * nll_b
    return nll, cnt


def make_train_step_body(forward_train: Callable, optimizer, augment_fn: Callable,
                         label_smoothing: float = 0.0,
                         mix_fn: Optional[Callable] = None, mesh=None) -> Callable:
    """``step(model, opt_state, images_u8, labels, combos=None, draws=None,
    mix_key=None) -> (model, opt_state, loss)``, the JAX
    ``make_train_step_body`` (``:69-115``). ``optimizer`` is ``train/optim.sgd_momentum``'s
    ``(init, update)``; the gradients are those of the parameters its state
    holds a trace for (the trainable ones). ``forward_train(model, images)
    -> logits`` runs the model in train mode. ``augment_fn(images_u8,
    combos, draws)`` gets the batch's combination ids and augmentation
    draws (the loader's ``"combo"`` and ``"draws"``; the JAX step draws
    from its key instead). ``images_u8`` and ``labels`` are numpy arrays
    or tensors. ``mix_fn`` mixes the augmented batch (the JAX ``:86-103``)
    with the draws of ``mix_key``. On a ``mesh`` of several ranks the
    arguments are this rank's rows and the loss is the global one (module
    docstring)."""
    _, update = optimizer
    dp = data_parallel(mesh)

    def step(model, opt_state, images_u8, labels, combos=None, draws=None, mix_key=None):
        params = dict(model.named_parameters())
        names = list(opt_state["trace"])
        device = params[names[0]].device
        with activate(dp):
            images = augment_fn(torch.as_tensor(images_u8).to(device), combos, draws)
            images, labels_a, labels_b, lam = _mixed(mix_fn, images, _labels_on(labels, device),
                                                     mix_key)
            logits = forward_train(model, images)
            if dp is None:
                loss = masked_cross_entropy(logits, labels_a, label_smoothing)
                if lam is not None:
                    loss = lam * loss + (1.0 - lam) * masked_cross_entropy(logits, labels_b,
                                                                           label_smoothing)
                mine = loss
            else:
                nll, cnt = _mixed_nll(logits, labels_a, labels_b, lam, label_smoothing)
                mine, loss = _global_loss(dp, nll, cnt)
            grads = torch.autograd.grad(mine, [params[n] for n in names])
        update(model, dict(zip(names, grads)), opt_state)
        return model, opt_state, loss.detach()

    return step


def make_train_step_accum(forward_train: Callable, optimizer, augment_fn: Callable,
                          n_accum: int, label_smoothing: float = 0.0,
                          mix_fn: Optional[Callable] = None, mesh=None) -> Callable:
    """``--grad_accum``: ``step`` as ``make_train_step_body``'s, with one
    optimiser update from ``n_accum`` micro-batches run one after the
    other (JAX ``make_train_step_accum``, ``:153-271``):

    - the full batch is augmented first, with the plain step's draws, so
      the model sees the plain step's pixels;
    - it is cut into ``n_accum`` micro-batches of B / ``n_accum`` (B not a
      multiple raises JAX's ValueError);
    - the gradients of each micro-batch's unnormalised masked NLL and the
      valid counts are summed, then divided once by the total count, so
      loss and gradients are the full batch's masked mean (equal up to f32
      reassociation where no batch statistics are taken);
    - batch norms normalise each micro-batch by its own statistics (ghost
      BN) and update their running buffers micro-batch after micro-batch,
      in order (``F.batch_norm`` in place: the JAX scan's chained stats);
    - with ``mix_fn`` the full batch is mixed before it is cut (JAX
      ``:190-200``, ``:233-235``), and each micro-batch's NLL is
      ``lam * nll(y) + (1 - lam) * nll(y_partner)`` over the one valid
      count of its own labels: the rolled labels are the batch's multiset.

    On a ``mesh`` each rank holds its block of every micro-batch
    (``core.mesh.local_rows``), so a micro-batch's statistics are the
    single-device micro-batch's; the NLL sums and counts are all-reduced
    once after the last micro-batch, and the optimiser reduces the summed
    gradients once.
    """
    _, update = optimizer
    n_accum = int(n_accum)
    dp = data_parallel(mesh)

    def step(model, opt_state, images_u8, labels, combos=None, draws=None, mix_key=None):
        params = dict(model.named_parameters())
        names = list(opt_state["trace"])
        device = params[names[0]].device
        with activate(dp, n_accum):
            images = augment_fn(torch.as_tensor(images_u8).to(device), combos, draws)
            images, labels_t, labels_b, lam = _mixed(mix_fn, images,
                                                     _labels_on(labels, device), mix_key)
            b = images.shape[0]
            if b % n_accum:
                raise ValueError(f"batch {b} not divisible by n_accum {n_accum}")
            mb = b // n_accum
            g_sum, nll_sum, cnt_sum = None, 0.0, 0.0
            for i in range(n_accum):
                part = slice(i * mb, (i + 1) * mb)
                logits = forward_train(model, images[part])
                nll, cnt = _mixed_nll(logits, labels_t[part], labels_b[part], lam,
                                      label_smoothing)
                grads = torch.autograd.grad(nll, [params[n] for n in names])
                g_sum = list(grads) if g_sum is None else [a + g for a, g in zip(g_sum, grads)]
                nll_sum = nll_sum + nll.detach()
                cnt_sum = cnt_sum + cnt
        if dp is not None:
            nll_sum, cnt_sum = dp.all_reduce([nll_sum, cnt_sum])
        denom = cnt_sum.clamp_min(1.0)
        update(model, {n: g / denom for n, g in zip(names, g_sum)}, opt_state)
        return model, opt_state, nll_sum / denom

    return step


def make_eval_step(forward_eval: Callable, crop: int = 224) -> Callable:
    """``step(model, images_u8, labels) -> (per-example loss, probs,
    preds)`` (``:325-351``): eval preprocessing, the forward in eval mode
    with no graph, the unsmoothed cross-entropy of each entry in f32."""

    def step(model, images_u8, labels):
        device = next(model.parameters()).device
        with torch.no_grad():
            images = eval_preprocess(torch.as_tensor(images_u8).to(device), crop)
            logits = forward_eval(model, images)
            logp = torch.log_softmax(logits.float(), dim=-1)
            safe = torch.as_tensor(np.asarray(labels)).to(device).clamp(
                0, logits.shape[-1] - 1).long()
            loss = -logp.gather(1, safe[:, None])[:, 0]
            return loss, torch.exp(logp), torch.argmax(logits, dim=-1)

    return step


def train_epochs(
    train_step: Callable,
    model,
    opt_state,
    loader,
    num_epochs: int,
    fold: int = 0,
    writer=None,
    steps_per_dispatch: int = 1,
    start_epoch: int = 0,
    on_epoch_end: Optional[Callable] = None,
    preemptible: bool = False,
    mesh=None,
):
    """The reference loop (``:378-482``): a print per batch, the epoch's
    mean loss (weighted by each batch's valid entries) and its TensorBoard
    scalar. ``start_epoch`` skips completed epochs (the caller restored the
    state and set the loader's epoch). ``on_epoch_end(epoch, model,
    opt_state)`` runs after every epoch; a true return stops the loop.
    With ``preemptible`` a SIGTERM raises ``PreemptedError`` before the
    next step (or chunk): the last completed epoch is on disk.

    ``steps_per_dispatch`` K > 1 (the JAX ``make_train_step_multi`` and
    ``_dispatch_chunk``): the loader's batches go in chunks of K (an
    epoch's tail chunk shorter), each chunk's images and labels uploaded
    at once, its K steps launched back to back with no host read between
    them, and their K losses fetched together. Each step is the K = 1
    step on the same batch and draws, so the prints, the epoch mean and
    the weights are K = 1's.

    On a data-parallel ``mesh`` the losses are the global ones, each
    batch's ``n_valid`` is the global batch's, and the ranks agree on a
    preemption before each step (an all-reduce of the flag), so all stop
    at the same step."""
    from .preemption import PreemptedError, preemption_agreed

    n_batches = len(loader)
    k = max(1, int(steps_per_dispatch))
    device = next(model.parameters()).device
    for epoch in range(start_epoch, num_epochs):
        running, seen = 0.0, 0

        def emit(batch_idx, loss_f, n):
            nonlocal running, seen
            check_nan("the training loss", loss_f)
            running += loss_f * n
            seen += n
            print(f"Fold {fold}, Epoch [{epoch + 1}/{num_epochs}], "
                  f"Batch [{batch_idx + 1}/{n_batches}], Loss: {loss_f:.4f}")

        def dispatch(chunk, first_idx):
            nonlocal model, opt_state
            if preemptible and preemption_agreed(mesh):
                raise PreemptedError(fold, epoch)
            if len(chunk) == 1:
                b = chunk[0]
                model, opt_state, loss = train_step(model, opt_state, b["image"], b["label"],
                                                    b.get("combo"), b.get("draws"),
                                                    mix_key=b.get("mix_key"))
                emit(first_idx, float(loss), b["n_valid"])
                return
            images = torch.as_tensor(np.stack([b["image"] for b in chunk])).to(device)
            labels = torch.as_tensor(np.stack([np.asarray(b["label"]) for b in chunk])).to(device)
            losses = []
            for i, b in enumerate(chunk):
                model, opt_state, loss = train_step(model, opt_state, images[i], labels[i],
                                                    b.get("combo"), b.get("draws"),
                                                    mix_key=b.get("mix_key"))
                losses.append(loss)
            for i, (b, loss_f) in enumerate(zip(chunk, torch.stack(losses).cpu().tolist())):
                emit(first_idx + i, loss_f, b["n_valid"])

        chunk, batch_idx = [], -1
        for batch_idx, batch in enumerate(loader):
            chunk.append(batch)
            if len(chunk) == k:
                dispatch(chunk, batch_idx + 1 - k)
                chunk = []
        if chunk:
            dispatch(chunk, batch_idx + 1 - len(chunk))
        epoch_loss = running / max(seen, 1)
        print(f"Fold {fold}, Epoch [{epoch + 1}/{num_epochs}], Loss: {epoch_loss:.4f}")
        if writer is not None:
            writer.add_scalar(f"Fold_{fold}/Train/Loss", epoch_loss, epoch)
        if on_epoch_end is not None and on_epoch_end(epoch, model, opt_state):
            break
    return model, opt_state


def evaluate(eval_step: Callable, model, loader, num_classes: int, fold: int = 0,
             writer=None, step: int = 0, mesh=None) -> Dict[str, float]:
    """The reference eval loop (``:508-556``): the valid entries' mean loss,
    accuracy and weighted precision, recall and F1, one print line, and the
    five TensorBoard scalars at ``step``. On a data-parallel ``mesh`` each
    rank evaluates its rows and the losses, predictions and labels are
    gathered, so every rank gets the single-device metrics."""
    from ..metrics.classification import classification_metrics

    losses, all_preds, all_labels = [], [], []
    for batch in loader:
        loss, _, preds = eval_step(model, batch["image"], batch["label"])
        loss, preds, labels = gather_valid(mesh, [loss, preds, batch["label"]],
                                           batch["n_valid"])
        losses.append(loss)
        all_preds.append(preds)
        all_labels.append(labels)
    losses = np.concatenate(losses)
    preds = np.concatenate(all_preds)
    labels = np.concatenate(all_labels)
    m = classification_metrics(labels, preds, num_classes)
    out = {
        "val_loss": float(losses.mean()),
        "val_accuracy": float((preds == labels).mean()),
        "val_precision": float(m["precision"]),
        "val_recall": float(m["recall"]),
        "val_f1": float(m["f1"]),
    }
    print(
        f"Fold {fold}, Validation Loss: {out['val_loss']:.4f}, "
        f"Accuracy: {out['val_accuracy']:.4f}, Precision: {out['val_precision']:.4f}, "
        f"Recall: {out['val_recall']:.4f}, F1 Score: {out['val_f1']:.4f}"
    )
    if writer is not None:
        for tag, key in (("Loss", "val_loss"), ("Accuracy", "val_accuracy"),
                         ("Precision", "val_precision"), ("Recall", "val_recall"),
                         ("F1", "val_f1")):
            writer.add_scalar(f"Fold_{fold}/Validation/{tag}", out[key], step)
    return out
