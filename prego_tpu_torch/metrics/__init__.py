from prego_tpu_torch.metrics.mistake import get_metrics
from prego_tpu_torch.metrics.perframe import (
    average_precision,
    calibrated_average_precision_score,
    perframe_average_precision,
    perstage_average_precision,
)

__all__ = [
    "get_metrics",
    "average_precision",
    "calibrated_average_precision_score",
    "perframe_average_precision",
    "perstage_average_precision",
]
