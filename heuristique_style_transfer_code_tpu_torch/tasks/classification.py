"""The family-1 classification test (``tasks/classification.py`` of the JAX
package): batched eval with the probability threshold (below it a
prediction is "Unknown", -1), weighted metrics, the confusion matrix and an
optional weighted one-vs-rest AUC, written as the reference's artifacts:
metrics.txt (its French line labels, in its order), auc_score.txt,
times_test.json, confusion_matrix.png and the per-class PNG tree of
``--save_test_images``, with each saved image's Grad-CAM overlay and
TensorBoard records where asked for.

The work is split so that a host without matplotlib or OpenCV can run the
device loop and the text artifacts: ``evaluate_classification`` (device
loop), ``write_metrics_text`` and ``write_auc_and_times`` (text), and the
PNG writers ``write_test_images`` (cv2) and
``plot_and_save_confusion_matrix`` (matplotlib). ``run_classification_test``
calls them all in the JAX order.

On a data-parallel mesh (``--devices N``) each rank runs the device loop on
its rows of every batch and gathers the losses, probabilities, labels and
sample indices (``core/dispatch.py``), so every rank holds the one-device
results; rank 0 alone writes the artifacts and runs Grad-CAM and
TensorBoard, one saved image at a time on its own device.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..core.device import device_of
from ..core.dispatch import dispatched_eval_iter
from ..data.augment import eval_preprocess
from ..metrics.classification import Timer, classification_metrics, weighted_auc_ovr


def plot_and_save_confusion_matrix(cm, class_names, save_dir, filename="confusion_matrix.png"):
    """The reference's renderer; imports matplotlib."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    cm = np.asarray(cm)
    plt.figure(figsize=(10, 8))
    plt.imshow(cm, interpolation="nearest", cmap=plt.cm.Blues)
    plt.title("Confusion Matrix")
    plt.colorbar()
    ticks = np.arange(len(class_names))
    plt.xticks(ticks, class_names, rotation=45)
    plt.yticks(ticks, class_names)
    with np.errstate(invalid="ignore", divide="ignore"):
        cm_norm = cm.astype("float") / cm.sum(axis=1)[:, np.newaxis]
    thresh = cm.max() / 2.0 if cm.max() > 0 else 0.5
    for i, j in np.ndindex(cm.shape):
        val = cm_norm[i, j] if np.isfinite(cm_norm[i, j]) else 0.0
        plt.text(j, i, f"{cm[i, j]} ({val:.2f})", horizontalalignment="center",
                 color="white" if cm[i, j] > thresh else "black")
    plt.tight_layout()
    plt.ylabel("True label")
    plt.xlabel("Predicted label")
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, filename)
    plt.savefig(path)
    plt.close()
    print(f"Confusion matrix saved to: {path}")
    return path


def evaluate_classification(
    forward_eval: Callable,
    model,
    loader,
    num_classes: int,
    *,
    prob_threshold: float = 0.5,
    measure_time: bool = False,
    compute_auc: bool = False,
    steps_per_dispatch: int = 1,
    mesh=None,
) -> Dict:
    """The device loop over ``HostLoader`` batches (on a data-parallel
    ``mesh``, this rank's rows of each, the results gathered). Per batch: staged uint8
    to the device, ``eval_preprocess``, ``forward_eval(model, images)``,
    log-softmax in f32, the loss of each row at its label (clipped into
    range: pad rows carry -1), the probabilities; loss and probabilities
    come back in one fetch. The loss is the mean over a batch's valid rows,
    then over batches. With ``measure_time`` one span a batch, from the
    upload to the (gathered) fetch; otherwise ``steps_per_dispatch``
    batches go up and come back together (``core/dispatch.py``), with the
    same values.

    Returns accuracy, loss, precision, recall, f1, confusion_matrix, auc,
    preds (thresholded), targets, probs, the ``timer``, and ``rows``:
    (batch, row, sample index) of every valid entry, for
    ``write_test_images``."""
    device = device_of(model)
    timer = Timer()
    total = correct = n_batches = 0
    total_loss = 0.0
    preds_all, targets_all, probs_all, rows = [], [], [], []

    def step(images_u8, labels_d):
        logits = forward_eval(model, eval_preprocess(images_u8))
        logp = torch.log_softmax(logits.float(), dim=-1)
        safe = labels_d.long().clamp(0, logits.shape[-1] - 1)
        loss = -torch.gather(logp, 1, safe[:, None])
        return torch.cat([loss, torch.exp(logp)], dim=1)

    with torch.inference_mode():
        outputs = dispatched_eval_iter(
            step, loader, device, input_keys=("image", "label"),
            steps_per_dispatch=1 if measure_time else steps_per_dispatch, mesh=mesh,
            on_span=(lambda seconds, batch: timer.times.append(seconds)) if measure_time
            else None)
        for bi, (batch, packed) in enumerate(outputs):
            n = batch["n_valid"]
            labels = np.asarray(batch["label"])[:n]
            probs = packed[:n, 1:]
            preds = probs.argmax(axis=1)
            preds_thresh = np.where(probs.max(axis=1) < prob_threshold, -1, preds)
            total += n
            correct += int((preds_thresh == labels).sum())
            total_loss += float(packed[:n, 0].mean())
            n_batches += 1
            targets_all.extend(labels.tolist())
            probs_all.extend(probs.tolist())
            preds_all.extend(preds_thresh.tolist())
            rows.extend((bi, j, int(batch["indices"][j])) for j in range(n))

    targets, preds, probs = np.array(targets_all), np.array(preds_all), np.array(probs_all)
    m = classification_metrics(targets, preds, num_classes)
    return {
        "accuracy": 100.0 * correct / max(total, 1),
        "loss": total_loss / max(n_batches, 1),
        "precision": m["precision"],
        "recall": m["recall"],
        "f1": m["f1"],
        "confusion_matrix": m["confusion_matrix"],
        "auc": weighted_auc_ovr(targets, probs, num_classes) if compute_auc else None,
        "preds": preds,
        "targets": targets,
        "probs": probs,
        "timer": timer,
        "rows": rows,
    }


def write_metrics_text(res: Dict, save_dir: str, log_fn=print) -> str:
    """metrics.txt with the reference's line labels, then its console
    lines (metrics, then the AUC)."""
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, "metrics.txt")
    with open(path, "w") as f:
        f.write(f"Précision du test: {res['accuracy']}\n")
        f.write(f"Perte du test: {res['loss']}\n")
        f.write(f"Précision: {res['precision']}\n")
        f.write(f"Rappel: {res['recall']}\n")
        f.write(f"Score F1: {res['f1']}\n")
        if res["auc"] is not None:
            f.write(f"Score AUC: {res['auc']}\n")
        f.write(f"Matrice de confusion:\n{res['confusion_matrix']}\n")
    log_fn(
        f"Précision du test: {res['accuracy']}, Perte du test: {res['loss']}, "
        f"Précision: {res['precision']}, Rappel: {res['recall']}, Score F1: {res['f1']}"
    )
    if res["auc"] is not None:
        log_fn(f"Score AUC: {res['auc']}")
    return path


def write_auc_and_times(res: Dict, save_dir: str, *, compute_auc: bool, measure_time: bool,
                        log_fn=print) -> None:
    """auc_score.txt (when the AUC was asked for and exists) and
    times_test.json (one span a batch, with ``measure_time``)."""
    if compute_auc and res["auc"] is not None:
        with open(os.path.join(save_dir, "auc_score.txt"), "w") as f:
            f.write(f"AUC Score: {res['auc']}\n")
        log_fn("AUC Score sauvegardé dans 'auc_score.txt'")
    if measure_time:
        times = res["timer"].times
        res["timer"].dump(os.path.join(save_dir, "times_test.json"))
        log_fn(f"Temps moyen de traitement par image: {np.mean(times)} secondes")
        log_fn(f"Temps total de traitement: {np.sum(times)} secondes")


def write_test_images(res: Dict, samples, class_names: List[str], save_dir: str, *,
                      model=None, gradcam_fn: Optional[Callable] = None,
                      save_gradcam_images: bool = False, colormap: str = "hot",
                      writer=None) -> None:
    """``--save_test_images``: each valid entry's original image with its
    label, prediction and top probability drawn on it, as
    ``save_dir/<label>/<batch>_<row>.png``. Imports OpenCV and Pillow.

    For each such image, as the JAX loop does: with a ``writer``, the image
    (CHW RGB) as ``Test/Images/<batch>_<row>`` and the drawn text as
    ``Test/Prédictions/<batch>_<row>``, at step <batch>; with a
    ``gradcam_fn``, ``gradcam_fn(model, staged_u8, label, path,
    overlay_path or None, colormap=...)`` on the staged uint8 image, which
    ``load_image_staged`` gives again byte for byte (the loader's own
    decode), the overlay going to ``save_dir/GradCAM_<label>/gradcam_<batch>_<row>.png``
    with ``save_gradcam_images``."""
    import cv2
    from PIL import Image

    from ..data.loader import load_image_staged

    probs, preds, targets = res["probs"], res["preds"], res["targets"]
    for k, (bi, j, sample) in enumerate(res["rows"]):
        img_path = samples[sample][0]
        img = cv2.cvtColor(np.array(Image.open(img_path).convert("RGB")), cv2.COLOR_RGB2BGR)
        label_name = class_names[int(targets[k])]
        pred_name = "Unknown" if preds[k] == -1 else class_names[int(preds[k])]
        text = f"Label: {label_name}, Pred: {pred_name}, Prob: {probs[k].max():.4f}"
        cv2.putText(img, text, (10, 25), cv2.FONT_HERSHEY_SIMPLEX, 0.5, (0, 255, 0), 1)
        cv2.imwrite(os.path.join(save_dir, label_name, f"{bi}_{j}.png"), img)
        if writer is not None:
            writer.add_image(f"Test/Images/{bi}_{j}",
                             cv2.cvtColor(img, cv2.COLOR_BGR2RGB).transpose(2, 0, 1),
                             global_step=bi)
            writer.add_text(f"Test/Prédictions/{bi}_{j}", text, global_step=bi)
        if gradcam_fn is not None:
            overlay_path = os.path.join(save_dir, f"GradCAM_{label_name}", f"gradcam_{bi}_{j}.png")
            gradcam_fn(model, load_image_staged(img_path), int(targets[k]), img_path,
                       overlay_path if save_gradcam_images else None, colormap=colormap)


def run_classification_test(
    forward_eval: Callable,
    model,
    loader,
    samples,
    class_names: List[str],
    save_dir: str,
    *,
    prob_threshold: float = 0.5,
    measure_time: bool = False,
    save_test_images: bool = False,
    compute_auc: bool = False,
    gradcam_fn: Optional[Callable] = None,
    save_gradcam_images: bool = False,
    colormap: str = "hot",
    writer=None,
    log_fn=print,
    mesh=None,
    steps_per_dispatch: int = 1,
) -> Dict:
    """``--mode classification``: the device loop, then the artifacts in
    the JAX order (the PNG tree, metrics.txt and its console lines,
    confusion_matrix.png, auc_score.txt, times_test.json). ``gradcam_fn``
    and ``writer`` act only under ``save_test_images``, once per saved
    image (``write_test_images``), after the device loop has left
    ``torch.inference_mode``. ``steps_per_dispatch`` K: K batches a
    device round trip, the same results (exclusive with ``measure_time``,
    JAX's ValueError). On a data-parallel ``mesh`` every rank returns the
    one-device dict and rank 0 alone writes. Returns the JAX function's
    dict (``loss`` formatted "%.4f")."""
    main = mesh is None or mesh.is_main
    steps_per_dispatch = max(1, int(steps_per_dispatch))
    if steps_per_dispatch > 1 and measure_time:
        raise ValueError(
            "steps_per_dispatch > 1 dispatches K batches at a time, so the "
            "per-batch times_test.json cannot be measured; use "
            "steps_per_dispatch=1 with measure_time"
        )
    if main:
        os.makedirs(save_dir, exist_ok=True)
        for cls in class_names:
            os.makedirs(os.path.join(save_dir, cls), exist_ok=True)

    res = evaluate_classification(forward_eval, model, loader, len(class_names),
                                  prob_threshold=prob_threshold, measure_time=measure_time,
                                  compute_auc=compute_auc,
                                  steps_per_dispatch=steps_per_dispatch, mesh=mesh)
    if main:
        if save_test_images:
            write_test_images(res, samples, class_names, save_dir, model=model,
                              gradcam_fn=gradcam_fn, save_gradcam_images=save_gradcam_images,
                              colormap=colormap, writer=writer)
        write_metrics_text(res, save_dir, log_fn)
        plot_and_save_confusion_matrix(res["confusion_matrix"], class_names, save_dir)
        write_auc_and_times(res, save_dir, compute_auc=compute_auc, measure_time=measure_time,
                            log_fn=log_fn)
    return {
        "accuracy": res["accuracy"],
        "loss": f"{res['loss']:.4f}",
        "precision": res["precision"],
        "recall": res["recall"],
        "f1": res["f1"],
        "confusion_matrix": res["confusion_matrix"],
        "auc": res["auc"],
        "features": None,
        "preds": res["preds"],
        "targets": res["targets"],
    }
