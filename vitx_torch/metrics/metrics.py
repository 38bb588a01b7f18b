"""Confusion matrix: the counterpart of ``vitx/metrics/metrics.py::
confusion_matrix``. The metrics derived from it (accuracy, F1, ...) come
with the training driver (ROADMAP A8)."""

from __future__ import annotations

import torch


def confusion_matrix(preds, labels, num_classes: int):
    """(B,) integer predictions and labels -> (C, C) int32 counts on their
    device, rows = true class."""
    idx = labels.long() * num_classes + preds.long()
    counts = torch.bincount(idx, minlength=num_classes * num_classes)
    return counts.reshape(num_classes, num_classes).to(torch.int32)
