"""Evaluation metrics of the port: the counterpart of ``vitx.metrics``."""

from vitx_torch.metrics.calibration import (calibration_report,
                                            expected_calibration_error,
                                            fit_temperature)
from vitx_torch.metrics.metrics import (accuracy, confusion_matrix,
                                        confusion_to_metrics, macro_f1,
                                        per_class_accuracy, per_class_f1,
                                        weighted_precision, weighted_recall)
from vitx_torch.metrics.multilabel import multilabel_metrics

__all__ = [
    "accuracy",
    "calibration_report",
    "confusion_matrix",
    "confusion_to_metrics",
    "expected_calibration_error",
    "fit_temperature",
    "macro_f1",
    "multilabel_metrics",
    "per_class_accuracy",
    "per_class_f1",
    "weighted_precision",
    "weighted_recall",
]
