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
does.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..data.augment import eval_preprocess


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


def make_train_step_body(forward_train: Callable, optimizer, augment_fn: Callable,
                         label_smoothing: float = 0.0) -> Callable:
    """``step(model, opt_state, images_u8, labels, combos=None, draws=None)
    -> (model, opt_state, loss)``, the JAX ``make_train_step_body``
    (``:69-115``). ``optimizer`` is ``train/optim.sgd_momentum``'s
    ``(init, update)``; the gradients are those of the parameters its state
    holds a trace for (the trainable ones). ``forward_train(model, images)
    -> logits`` runs the model in train mode. ``augment_fn(images_u8,
    combos, draws)`` gets the batch's combination ids and augmentation
    draws (the loader's ``"combo"`` and ``"draws"``; the JAX step draws
    from its key instead). ``images_u8`` and ``labels`` are numpy arrays
    or tensors."""
    _, update = optimizer

    def step(model, opt_state, images_u8, labels, combos=None, draws=None):
        params = dict(model.named_parameters())
        names = list(opt_state["trace"])
        device = params[names[0]].device
        images = augment_fn(torch.as_tensor(images_u8).to(device), combos, draws)
        labels_t = torch.as_tensor(np.asarray(labels)).to(device)
        logits = forward_train(model, images)
        loss = masked_cross_entropy(logits, labels_t, label_smoothing)
        grads = torch.autograd.grad(loss, [params[n] for n in names])
        update(model, dict(zip(names, grads)), opt_state)
        return model, opt_state, loss.detach()

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
):
    """The reference loop (``:378-482``): a print per batch, the epoch's
    mean loss (weighted by each batch's valid entries) and its TensorBoard
    scalar. ``start_epoch`` skips completed epochs (the caller restored the
    state and set the loader's epoch). ``on_epoch_end(epoch, model,
    opt_state)`` runs after every epoch; a true return stops the loop.
    With ``preemptible`` a SIGTERM raises ``PreemptedError`` before the
    next step: the last completed epoch is on disk. ``steps_per_dispatch``
    above 1 is not ported yet."""
    if steps_per_dispatch > 1:
        raise NotImplementedError("--steps_per_dispatch > 1 is not ported yet")
    from .preemption import PreemptedError, preemption_requested

    n_batches = len(loader)
    for epoch in range(start_epoch, num_epochs):
        running, seen = 0.0, 0
        for batch_idx, batch in enumerate(loader):
            if preemptible and preemption_requested():
                raise PreemptedError(fold, epoch)
            model, opt_state, loss = train_step(model, opt_state, batch["image"],
                                                batch["label"], batch.get("combo"),
                                                batch.get("draws"))
            loss_f, n = float(loss), batch["n_valid"]
            running += loss_f * n
            seen += n
            print(f"Fold {fold}, Epoch [{epoch + 1}/{num_epochs}], "
                  f"Batch [{batch_idx + 1}/{n_batches}], Loss: {loss_f:.4f}")
        epoch_loss = running / max(seen, 1)
        print(f"Fold {fold}, Epoch [{epoch + 1}/{num_epochs}], Loss: {epoch_loss:.4f}")
        if writer is not None:
            writer.add_scalar(f"Fold_{fold}/Train/Loss", epoch_loss, epoch)
        if on_epoch_end is not None and on_epoch_end(epoch, model, opt_state):
            break
    return model, opt_state


def evaluate(eval_step: Callable, model, loader, num_classes: int, fold: int = 0,
             writer=None, step: int = 0) -> Dict[str, float]:
    """The reference eval loop (``:508-556``): the valid entries' mean loss,
    accuracy and weighted precision, recall and F1, one print line, and the
    five TensorBoard scalars at ``step``."""
    from ..metrics.classification import classification_metrics

    losses, all_preds, all_labels = [], [], []
    for batch in loader:
        loss, _, preds = eval_step(model, batch["image"], batch["label"])
        n = batch["n_valid"]
        losses.append(loss.cpu().numpy()[:n])
        all_preds.append(preds.cpu().numpy()[:n])
        all_labels.append(np.asarray(batch["label"])[:n])
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
