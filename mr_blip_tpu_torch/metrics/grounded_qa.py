"""Grounded VideoQA metrics (NExT-GQA style): Acc@GQA, mIoP/TIoP, mIoU/TIoU
(the port's copy of ``mr_blip_tpu/metrics/grounded_qa.py``).

Matches the reference ``lavis/tasks/vqa.py:768-860`` (``get_tIoU`` /
``eval_ground``), including the degenerate-span convention: a point
prediction inside the GT window scores IoP 1 / IoU 0.
"""

from __future__ import annotations


def get_tIoU(loc, span):
    """Temporal IoU and IoP between one GT window ``loc`` and prediction ``span``."""
    if span[0] == span[-1]:
        if loc[0] <= span[0] and span[0] <= loc[1]:
            return 0, 1
        return 0, 0

    span_u = (min(loc[0], span[0]), max(loc[-1], span[-1]))
    span_i = (max(loc[0], span[0]), min(loc[-1], span[-1]))
    dis_i = span_i[1] - span_i[0]
    IoU = dis_i / (span_u[1] - span_u[0]) if span_u[1] > span_u[0] else 0.0
    IoP = dis_i / (span[-1] - span[0]) if span[-1] > span[0] else 0.0
    return IoU, IoP


def eval_ground(results, pred_qa=True):
    """Score grounded-QA results.

    Each record carries ``relevant_moments`` (a single predicted window,
    wrapped in a list), ``relevant_moments_gt`` (list of GT windows), and
    when ``pred_qa`` the answer ``prediction`` / ``target`` pair.  Acc@GQA
    counts answers that are both correct and grounded at IoP >= 0.5.
    """
    mIoU, mIoP = 0, 0
    cnt, cqt = 0, 0
    crt3, crt5 = 0, 0
    crtp3, crtp5 = 0, 0
    for r in results:
        loc_pred = r["relevant_moments"][0]
        loc_gt = r["relevant_moments_gt"]
        qa_pred = r["prediction"]
        qa_gt = r["target"]

        max_tIoU, max_tIoP = 0, 0
        for gt_window in loc_gt:
            tIoU, tIoP = get_tIoU(gt_window, loc_pred)
            max_tIoU = max(max_tIoU, tIoU)
            max_tIoP = max(max_tIoP, tIoP)

        if max_tIoP >= 0.3:
            crtp3 += 1
            if max_tIoP >= 0.5:
                crtp5 += 1
                if pred_qa and qa_pred == qa_gt:
                    cqt += 1

        if max_tIoU >= 0.3:
            crt3 += 1
            if max_tIoU >= 0.5:
                crt5 += 1

        cnt += 1
        mIoU += max_tIoU
        mIoP += max_tIoP

    mIoU = mIoU / cnt * 100
    mIoP = mIoP / cnt * 100
    return {
        "Acc@GQA": cqt * 1.0 / cnt * 100,
        "mIoP": mIoP,
        "TIoP@0.3": crtp3 * 1.0 / cnt * 100,
        "TIoP@0.5": crtp5 * 1.0 / cnt * 100,
        "mIoU": mIoU,
        "TIoU@0.3": crt3 * 1.0 / cnt * 100,
        "TIoU@0.5": crt5 * 1.0 / cnt * 100,
    }
