"""Classification metrics and timers (``metrics/classification.py`` of the
JAX package). Weighted precision, recall and F1 and the confusion matrix
are numpy, with scikit-learn's definitions (``average="weighted"``,
``zero_division=0``), so the classification path needs no scikit-learn;
only ``weighted_auc_ovr`` imports it.

Per label of the sorted union of true and predicted labels:
precision = tp / predicted, recall = tp / true, F1 = 2 tp / (true +
predicted), each 0 where its denominator is 0; averaged with the true
counts (the support) as weights, by ``np.average`` as scikit-learn does.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np


def _divide(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    out = np.zeros(num.shape, dtype=np.float64)
    np.divide(num, den, out=out, where=den != 0)
    return out


def weighted_precision_recall_f1(labels: Sequence[int], preds: Sequence[int]) -> Dict[str, float]:
    y = np.asarray(labels)
    p = np.asarray(preds)
    classes = np.union1d(y, p)
    tp = np.array([np.sum((y == c) & (p == c)) for c in classes], dtype=np.float64)
    true = np.array([np.sum(y == c) for c in classes], dtype=np.float64)
    pred = np.array([np.sum(p == c) for c in classes], dtype=np.float64)
    scores = {
        "precision": _divide(tp, pred),
        "recall": _divide(tp, true),
        "f1_score": _divide(2 * tp, true + pred),
    }
    if true.sum() == 0:
        return {k: 0.0 for k in scores}
    return {k: float(np.average(v, weights=true)) for k, v in scores.items()}



def confusion_matrix_np(targets, preds, num_classes: int) -> np.ndarray:
    """(num_classes, num_classes) int64 counts, rows true, columns
    predicted. Pairs where either index is outside [0, num_classes) are
    skipped: -1 "Unknown" predictions and -1 padded targets."""
    t = np.asarray(targets).astype(np.int64).ravel()
    p = np.asarray(preds).astype(np.int64).ravel()
    ok = (t >= 0) & (t < num_classes) & (p >= 0) & (p < num_classes)
    flat = np.bincount(t[ok] * num_classes + p[ok], minlength=num_classes * num_classes)
    return flat.reshape(num_classes, num_classes).astype(np.int64)


def classification_metrics(targets, preds, num_classes: int) -> Dict[str, object]:
    """Weighted P/R/F1 and the confusion matrix over the non-Unknown
    entries (``preds != -1``); 0 and a zero matrix when every prediction
    is Unknown, as the reference's threshold handling gives."""
    targets = np.asarray(targets)
    preds = np.asarray(preds)
    known = preds != -1
    if not known.any():
        return {"precision": 0, "recall": 0, "f1": 0,
                "confusion_matrix": np.zeros((num_classes, num_classes), dtype=np.int64)}
    prf = weighted_precision_recall_f1(targets[known], preds[known])
    return {"precision": prf["precision"], "recall": prf["recall"], "f1": prf["f1_score"],
            "confusion_matrix": confusion_matrix_np(targets[known], preds[known], num_classes)}


def weighted_auc_ovr(targets, probs, num_classes: int) -> Optional[float]:
    """Weighted one-vs-rest AUC (``--compute_auc``); None where
    scikit-learn cannot compute it. Rows are renormalised first: a bf16
    softmax can sum to 1 +- 1e-3, which scikit-learn's multiclass check
    rejects. Imports scikit-learn."""
    from sklearn.metrics import roc_auc_score

    try:
        if num_classes > 2:
            probs = np.asarray(probs, dtype=np.float64)
            probs = probs / np.maximum(probs.sum(axis=1, keepdims=True), 1e-12)
            return float(roc_auc_score(targets, probs, multi_class="ovr", average="weighted"))
        return float(roc_auc_score(targets, np.asarray(probs)[:, 1]))
    except ValueError:
        return None


class Timer:
    """Per-item wall-clock spans, dumped as the reference's times_*.json
    (a bare JSON list of seconds). The caller ends each span with its
    result on the host, so the span covers the device work."""

    def __init__(self):
        self.times: List[float] = []
        self._start = None

    def start(self):
        self._start = time.perf_counter()

    def stop(self):
        if self._start is None:
            raise RuntimeError("Timer.stop() before start()")
        self.times.append(time.perf_counter() - self._start)

    def dump(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.times, f, indent=4)
