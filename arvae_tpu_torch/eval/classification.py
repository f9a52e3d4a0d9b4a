"""Classification scores in numpy: the macro precision, recall and F1 and
the accuracy that the judge's CLI prints each epoch.

Counterparts of ``sklearn.metrics``' ``precision_score``,
``recall_score``, ``f1_score`` (``average='macro', zero_division=0``)
and ``accuracy_score``, computed as scikit-learn 1.9 computes them:
over the sorted union of the true and predicted labels, each class's
precision ``tp / predicted``, recall ``tp / true`` and F1
``2·tp / (true + predicted)``, a zero denominator scoring 0, then the
plain mean over the classes.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def precision_recall_f1(y_true, y_pred) -> Dict[str, float]:
    """{"precision", "recall", "f1"}: macro averages, 0 where a class is
    never predicted (precision), never true (recall) or neither (F1)."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    labels = np.union1d(y_true, y_pred)
    true_sum = (y_true[:, None] == labels).sum(axis=0)
    pred_sum = (y_pred[:, None] == labels).sum(axis=0)
    tp_sum = ((y_true == y_pred)[:, None] & (y_true[:, None] == labels)).sum(axis=0)

    def divide(num, den):
        return np.where(den == 0, 0.0, num / np.where(den == 0, 1, den).astype(np.float64))

    return {
        "precision": float(np.mean(divide(tp_sum, pred_sum))),
        "recall": float(np.mean(divide(tp_sum, true_sum))),
        "f1": float(np.mean(divide(2.0 * tp_sum, true_sum + pred_sum))),
    }


def accuracy(y_true, y_pred) -> float:
    """The share of exact matches."""
    return float(np.mean(np.asarray(y_true) == np.asarray(y_pred)))
