"""Temporal-span scoring primitives (pure numpy, host-side; the port's copy
of ``mr_blip_tpu/metrics/span_ops.py``, with a numpy ``precision_recall_curve``
of its own in place of scikit-learn's).

These pin the scoring contract for every benchmark the framework reports
(R1@IoU, mIoU, mAP@IoU, highlight AP).  Numeric behavior matches the
reference implementation bit-for-bit (see the reference repo's
``standalone_eval/utils.py:15-209`` and ``lavis/tasks/mr_utils.py:16-221``),
including its quirks:

* the *paired* IoU uses the hull (max end - min start) as the "union";
* the detection AP uses VOC-2011 interpolated precision/recall with greedy
  per-threshold ground-truth locking;
* ``binary_average_precision`` interpolates precision monotonically and
  averages precision at every additionally-recalled sample.
"""

from __future__ import annotations

import numpy as np

IOU_THDS_DEFAULT = np.linspace(0.5, 0.95, 10)


def temporal_iou_paired(pred_windows: np.ndarray, gt_windows: np.ndarray) -> np.ndarray:
    """Row-wise temporal IoU between two (N, 2) span arrays.

    Matches reference ``compute_temporal_iou_batch_paired``
    (standalone_eval/utils.py:15-31): the denominator is the *hull*
    ``max(ends) - min(starts)``, not the true union, and a zero hull
    yields IoU 0.
    """
    pred_windows = np.asarray(pred_windows, dtype=float)
    gt_windows = np.asarray(gt_windows, dtype=float)
    intersection = np.maximum(
        0,
        np.minimum(pred_windows[:, 1], gt_windows[:, 1])
        - np.maximum(pred_windows[:, 0], gt_windows[:, 0]),
    )
    hull = np.maximum(pred_windows[:, 1], gt_windows[:, 1]) - np.minimum(
        pred_windows[:, 0], gt_windows[:, 0]
    )
    return np.divide(intersection, hull, out=np.zeros_like(intersection), where=hull != 0)


def temporal_iou_cross(spans1: np.ndarray, spans2: np.ndarray):
    """All-pairs temporal IoU between (N, 2) and (M, 2) span arrays.

    Returns ``(iou, union)`` both of shape (N, M).  Matches reference
    ``compute_temporal_iou_batch_cross`` (standalone_eval/utils.py:34-61),
    including the true union denominator and potential 0/0 -> nan when two
    degenerate spans coincide.
    """
    spans1 = np.asarray(spans1, dtype=float)
    spans2 = np.asarray(spans2, dtype=float)
    areas1 = spans1[:, 1] - spans1[:, 0]
    areas2 = spans2[:, 1] - spans2[:, 0]
    left = np.maximum(spans1[:, None, 0], spans2[None, :, 0])
    right = np.minimum(spans1[:, None, 1], spans2[None, :, 1])
    inter = np.clip(right - left, 0, None)
    union = areas1[:, None] + areas2[None, :] - inter
    iou = inter / union
    return iou, union


def interpolated_precision_recall(precision: np.ndarray, recall: np.ndarray) -> float:
    """VOC-2011 interpolated average precision.

    Matches reference ``interpolated_precision_recall``
    (standalone_eval/utils.py:64-80).
    """
    mprecision = np.hstack([[0], precision, [0]])
    mrecall = np.hstack([[0], recall, [1]])
    # Monotone non-increasing envelope, right to left.
    mprecision = np.maximum.accumulate(mprecision[::-1])[::-1]
    idx = np.where(mrecall[1:] != mrecall[:-1])[0] + 1
    return float(np.sum((mrecall[idx] - mrecall[idx - 1]) * mprecision[idx]))


def average_precision_detection(
    ground_truth: list,
    prediction: list,
    tiou_thresholds: np.ndarray = IOU_THDS_DEFAULT,
    sort_by_score: bool = False,
) -> np.ndarray:
    """Detection AP with greedy TP assignment and per-threshold GT locking.

    Matches reference ``compute_average_precision_detection``: the scored
    variant (standalone_eval/utils.py:83-166, ``sort_by_score=True``) sorts
    predictions by decreasing ``score`` first; the in-train variant
    (lavis/tasks/mr_utils.py:89-171, ``sort_by_score=False``) evaluates
    predictions in submission order.

    Each element of ``ground_truth`` / ``prediction`` is a dict with
    ``video-id``, ``t-start``, ``t-end`` (and ``score`` for predictions in
    the scored variant).
    """
    num_thresholds = len(tiou_thresholds)
    num_gts = len(ground_truth)
    num_preds = len(prediction)
    ap = np.zeros(num_thresholds)
    if num_preds == 0:
        return ap

    num_positive = float(num_gts)
    lock_gt = np.full((num_thresholds, num_gts), -1.0)
    if sort_by_score:
        prediction = sorted(prediction, key=lambda x: -x["score"])
    tp = np.zeros((num_thresholds, num_preds))
    fp = np.zeros((num_thresholds, num_preds))

    gt_by_vid: dict = {}
    for i, item in enumerate(ground_truth):
        gt_by_vid.setdefault(item["video-id"], []).append((i, item))

    for idx, pred in enumerate(prediction):
        gts = gt_by_vid.get(pred["video-id"])
        if gts is None:
            fp[:, idx] = 1
            continue

        _pred = np.array([[pred["t-start"], pred["t-end"]]])
        _gt = np.array([[gt["t-start"], gt["t-end"]] for _, gt in gts])
        tiou_arr = temporal_iou_cross(_pred, _gt)[0].reshape(-1)
        # Visit candidate GTs from highest IoU down.
        tiou_sorted_idx = tiou_arr.argsort()[::-1]
        for t_idx, tiou_threshold in enumerate(tiou_thresholds):
            for j_idx in tiou_sorted_idx:
                if tiou_arr[j_idx] < tiou_threshold:
                    fp[t_idx, idx] = 1
                    break
                gt_index = gts[j_idx][0]
                if lock_gt[t_idx, gt_index] >= 0:
                    continue
                tp[t_idx, idx] = 1
                lock_gt[t_idx, gt_index] = idx
                break
            if fp[t_idx, idx] == 0 and tp[t_idx, idx] == 0:
                fp[t_idx, idx] = 1

    tp_cumsum = np.cumsum(tp, axis=1).astype(float)
    fp_cumsum = np.cumsum(fp, axis=1).astype(float)
    recall_cumsum = tp_cumsum / num_positive
    precision_cumsum = tp_cumsum / (tp_cumsum + fp_cumsum)

    for t_idx in range(num_thresholds):
        ap[t_idx] = interpolated_precision_recall(
            precision_cumsum[t_idx, :], recall_cumsum[t_idx, :]
        )
    return ap


def precision_recall_curve(y_true, y_score):
    """Precision and recall at every distinct score threshold of a binary
    label vector: scikit-learn's ``precision_recall_curve(y_true, y_score)``
    (positive label 1, no weights, ``drop_intermediate=False``) in numpy.
    Returns (precision, recall, thresholds) with thresholds increasing,
    precision ending in 1 and recall in 0."""
    y_true = np.ravel(y_true) == 1
    y_score = np.ravel(y_score)
    order = np.argsort(y_score, kind="mergesort")[::-1]
    y_score, y_true = y_score[order], y_true[order]
    distinct = np.where(np.diff(y_score))[0]
    threshold_idxs = np.r_[distinct, y_true.size - 1]
    tps = np.cumsum(y_true * 1.0, dtype=np.float64)[threshold_idxs]
    fps = 1 + threshold_idxs - tps
    predicted = tps + fps
    precision = np.zeros_like(tps)
    np.divide(tps, predicted, out=precision, where=predicted != 0)
    recall = np.ones_like(tps) if tps[-1] == 0 else tps / tps[-1]
    return (np.hstack((precision[::-1], 1)), np.hstack((recall[::-1], 0)),
            y_score[threshold_idxs][::-1])


def binary_average_precision(
    y_true, y_predict, interpolate: bool = True, point_11: bool = False
):
    """AP over a binary relevance vector with per-element scores.

    Matches reference ``get_ap`` (standalone_eval/utils.py:169-209):
    degenerate all-zero labels return 0, all-one labels return 1; otherwise
    precision is (optionally) interpolated and averaged either at the 11
    standard recall points or at every additionally-recalled sample.
    """
    assert len(y_true) == len(y_predict), (
        "Prediction and ground truth need to be of the same length"
    )
    if len(set(y_true)) == 1:
        return 0 if y_true[0] == 0 else 1
    assert sorted(set(y_true)) == [0, 1], "Ground truth can only contain elements {0,1}"

    precision, recall, _ = precision_recall_curve(y_true, y_predict)
    recall = recall.astype(np.float32)

    if interpolate:
        for i in range(1, len(precision)):
            precision[i] = max(precision[i - 1], precision[i])

    if point_11:
        precision_11 = [
            precision[np.where(recall >= t)[0][-1]] for t in np.arange(0, 1.01, 0.1)
        ]
        return np.mean(precision_11)
    indices = np.where(np.diff(recall))
    return np.mean(precision[indices])
