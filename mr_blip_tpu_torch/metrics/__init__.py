"""Moment-retrieval, detection and grounded-QA metrics (numpy, host side)."""

from mr_blip_tpu_torch.metrics.grounded_qa import eval_ground, get_tIoU
from mr_blip_tpu_torch.metrics.moment_retrieval import (
    compute_mr_ap,
    compute_mr_r1,
    eval_highlight,
    eval_moment_retrieval,
    eval_submission,
)
from mr_blip_tpu_torch.metrics.span_ops import (
    average_precision_detection,
    binary_average_precision,
    compute_topkx_recall_detection,
    interpolated_precision_recall,
    precision_recall_curve,
    temporal_iou_cross,
    temporal_iou_paired,
)

__all__ = [
    "temporal_iou_paired",
    "temporal_iou_cross",
    "interpolated_precision_recall",
    "average_precision_detection",
    "binary_average_precision",
    "compute_topkx_recall_detection",
    "precision_recall_curve",
    "compute_mr_ap",
    "compute_mr_r1",
    "eval_moment_retrieval",
    "eval_highlight",
    "eval_submission",
    "get_tIoU",
    "eval_ground",
]
