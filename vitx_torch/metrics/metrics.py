"""Classification metrics from one confusion matrix.

The counterpart of ``vitx/metrics/metrics.py``: the eval loop accumulates
one (C, C) int32 confusion matrix on the device and every metric derives
from it, in fp32, with sklearn's semantics (``average='weighted',
zero_division=0``). Each function takes and returns tensors on the
matrix's device.
"""

from __future__ import annotations

import torch


def confusion_matrix(preds, labels, num_classes: int):
    """(B,) integer predictions and labels -> (C, C) int32 counts on their
    device, rows = true class."""
    idx = labels.long() * num_classes + preds.long()
    counts = torch.bincount(idx, minlength=num_classes * num_classes)
    return counts.reshape(num_classes, num_classes).to(torch.int32)


def _parts(cm):
    """(support, predicted counts, diagonal) as fp32."""
    return (cm.sum(dim=1).float(), cm.sum(dim=0).float(),
            cm.diagonal().float())


def _safe_div(num, den):
    return torch.where(den > 0, num / torch.clamp_min(den, 1.0),
                       torch.zeros_like(num))


def accuracy(cm):
    """Overall accuracy; 0 for an empty matrix."""
    total = cm.sum()
    return torch.where(total > 0, cm.trace() / total,
                       torch.zeros((), device=cm.device))


def per_class_accuracy(cm):
    """Recall per class; 0 where a class is absent."""
    support, _, diag = _parts(cm)
    return _safe_div(diag, support)


def weighted_precision(cm):
    """sklearn ``precision_score(average='weighted', zero_division=0)``."""
    support, pred_count, diag = _parts(cm)
    total = support.sum()
    return _safe_div((_safe_div(diag, pred_count) * support).sum(), total)


def weighted_recall(cm):
    """sklearn ``recall_score(average='weighted', zero_division=0)``."""
    support, _, diag = _parts(cm)
    total = support.sum()
    return _safe_div((_safe_div(diag, support) * support).sum(), total)


def per_class_f1(cm):
    """sklearn ``f1_score(average=None, zero_division=0)``."""
    support, pred_count, diag = _parts(cm)
    prec = _safe_div(diag, pred_count)
    rec = _safe_div(diag, support)
    pr = prec + rec
    return torch.where(pr > 0, 2.0 * prec * rec / torch.clamp_min(pr, 1e-12),
                       torch.zeros_like(pr))


def macro_f1(cm):
    """sklearn ``f1_score(average='macro', zero_division=0)``."""
    return per_class_f1(cm).mean()


def confusion_to_metrics(cm) -> dict:
    """Confusion matrix -> the scalar metrics and per-class vectors."""
    return {
        "accuracy": accuracy(cm),
        "precision_weighted": weighted_precision(cm),
        "recall_weighted": weighted_recall(cm),
        "per_class_accuracy": per_class_accuracy(cm),
        "per_class_f1": per_class_f1(cm),
        "f1_macro": macro_f1(cm),
    }
