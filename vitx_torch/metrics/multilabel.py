"""Multi-label evaluation metrics on the host.

The counterpart of ``vitx/metrics/multilabel.py``: ranking metrics
(average precision) need the full score array sorted per class, so
multi-label evaluation gathers (scores, targets) to the host per batch;
the training loss stays on the device. numpy only, scikit-learn's
semantics, as vitx's.
"""

from __future__ import annotations

import numpy as np


def _average_precision(scores, targets) -> float:
    """One class's AP, scikit-learn's ``average_precision_score``: the sum
    of P(k) over the positives' ranks over the positives (no
    interpolation); NaN for a class with no positive."""
    order = np.argsort(-scores, kind="stable")
    t = targets[order]
    tp = np.cumsum(t)
    precision = tp / np.arange(1, len(t) + 1)
    n_pos = t.sum()
    if n_pos == 0:
        return float("nan")
    return float(np.sum(precision * t) / n_pos)


def multilabel_metrics(scores, targets, threshold: float = 0.0) -> dict:
    """scores: (N, C) logits (threshold 0 is probability 0.5); targets:
    (N, C) multi-hot. -> micro and macro F1 at the threshold, the
    per-class F1, mAP (the mean over the classes with a positive), the
    per-class AP (NaN where a class has none), the element accuracy and
    the example count."""
    scores = np.asarray(scores, np.float32)
    targets = np.asarray(targets) > 0.5
    pred = scores > threshold

    tp = (pred & targets).sum(axis=0).astype(np.float64)
    fp = (pred & ~targets).sum(axis=0).astype(np.float64)
    fn = (~pred & targets).sum(axis=0).astype(np.float64)

    def f1(tp, fp, fn):
        denom = 2 * tp + fp + fn
        return np.where(denom > 0, 2 * tp / np.maximum(denom, 1e-12), 0.0)

    f1_per_class = f1(tp, fp, fn)
    aps = np.array([_average_precision(scores[:, c], targets[:, c])
                    for c in range(scores.shape[1])])
    have_pos = ~np.isnan(aps)
    return {
        "f1_micro": float(f1(tp.sum(), fp.sum(), fn.sum())),
        "f1_macro": float(f1_per_class.mean()),
        "f1_per_class": f1_per_class,
        "mAP": float(aps[have_pos].mean()) if have_pos.any() else 0.0,
        "average_precision_per_class": aps,
        "accuracy": float((pred == targets).mean()),
        "num_examples": int(scores.shape[0]),
    }
