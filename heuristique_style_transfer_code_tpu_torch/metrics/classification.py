"""Weighted precision, recall and F1 in numpy, with scikit-learn's
definitions (``average="weighted"``, ``zero_division=0``), so the
classification path needs no scikit-learn.

Per label of the sorted union of true and predicted labels:
precision = tp / predicted, recall = tp / true, F1 = 2 tp / (true +
predicted), each 0 where its denominator is 0; averaged with the true
counts (the support) as weights, by ``np.average`` as scikit-learn does.
"""
from __future__ import annotations

from typing import Dict, Sequence

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

