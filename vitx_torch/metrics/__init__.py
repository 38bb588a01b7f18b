"""Evaluation metrics of the port (what ``eval_step`` needs so far)."""

from vitx_torch.metrics.metrics import confusion_matrix

__all__ = ["confusion_matrix"]
