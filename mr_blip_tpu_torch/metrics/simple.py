"""Index-paired R1/mIoU variant (reference ``lavis/tasks/metrics_own.py:9-98``;
the port's copy of ``mr_blip_tpu/metrics/simple.py``).

Superseded by the QVH-style ``eval_submission`` in the moment-retrieval
task, but kept for parity: the i-th predicted window is paired with the
i-th ground-truth window (no best-match search), missing predictions score
IoU 0, and per-video R1 is averaged over its windows before averaging over
videos.
"""

from __future__ import annotations

import logging


def compute_IoU(pred, target):
    """Scalar temporal IoU between two [start, end] windows (true union)."""
    inter_left = max(pred[0], target[0])
    inter_right = min(pred[1], target[1])
    inter = max(0.0, inter_right - inter_left)
    union = (pred[1] - pred[0]) + (target[1] - target[0]) - inter
    return inter / union if union > 0 else 0.0


def r1_and_mIoU(submission, iou_thresholds=(0.3, 0.5, 0.7)):
    """Returns (r1 dict, r1_avg, mIoU, invalid_pred_num)."""
    total_num = len(submission)
    r1 = {t: 0 for t in iou_thresholds}
    iou_list = []
    invalid_pred_num = 0

    for r in submission:
        predictions, targets = r["pred_relevant_windows"], r["relevant_windows"]

        if predictions == [[-1, -1]]:
            invalid_pred_num += 1
            continue

        _iou = []
        for i in range(len(targets)):
            if i >= len(predictions):
                _iou.extend([0] * (len(targets) - i))
                break
            try:
                _iou.append(compute_IoU(predictions[i], targets[i]))
            except Exception:
                logging.warning(
                    "Error when computing IoU between pred: %s and target: %s",
                    predictions[i], targets[i],
                )
                _iou.append(0)

        if _iou:
            iou_list.extend(_iou)
            for t in iou_thresholds:
                hits = sum(1 for iou in _iou if iou >= t)
                r1[t] += hits / len(_iou)

    mIoU = sum(iou_list) / len(iou_list) if iou_list else 0
    r1 = {str(k): v / total_num for k, v in r1.items()}
    r1_avg = sum(r1.values()) / len(r1)
    return r1, r1_avg, mIoU, invalid_pred_num
