"""Moment-retrieval and highlight-detection metrics (pure CPU, host-side;
the port's copy of ``mr_blip_tpu/metrics/moment_retrieval.py``).

Two scoring modes share one implementation:

* ``mode="qvh"`` — the offline QVHighlights scorer.  Predictions carry
  confidence scores (``pred_relevant_windows`` rows are ``[st, ed, score]``),
  AP sorts by score, results are additionally broken out by GT window length
  (short/middle/long/full).  Matches the reference
  ``standalone_eval/eval.py:19-320`` bit-for-bit on its golden fixture.

* ``mode="intrain"`` — the in-training-loop scorer used by the
  moment_retrieval task.  Predictions are unscored span lists; ground truth
  is taken from the same record (``relevant_windows``); all four range names
  alias the full set; R1 additionally reports the R1 average, mIoU, and the
  invalid-prediction count.  Matches the reference
  ``lavis/tasks/mr_eval.py:26-416``.
"""

from __future__ import annotations

import atexit
import copy
import json
import multiprocessing as mp
from collections import OrderedDict, defaultdict
from functools import partial

import numpy as np

# Forking a process whose runtime holds threads (CUDA, the loader's decode
# pool) can deadlock the child, so workers are spawned: they re-import
# cleanly but pay a multi-second startup, so one pool is created lazily and
# reused for the whole process.
_POOL = None


def _get_pool(num_workers):
    global _POOL
    if _POOL is None:
        _POOL = mp.get_context("spawn").Pool(num_workers)
        atexit.register(_POOL.terminate)
    return _POOL

from mr_blip_tpu_torch.metrics.span_ops import (
    IOU_THDS_DEFAULT,
    average_precision_detection,
    binary_average_precision,
    temporal_iou_cross,
    temporal_iou_paired,
)


def load_jsonl(filename):
    with open(filename, "r") as f:
        return [json.loads(line.strip("\n")) for line in f.readlines()]


def _ap_for_query(input_triple, tiou_thresholds, sort_by_score):
    qid, ground_truth, prediction = input_triple
    scores = average_precision_detection(
        ground_truth, prediction, tiou_thresholds=tiou_thresholds,
        sort_by_score=sort_by_score,
    )
    return qid, scores


def compute_mr_ap(
    submission,
    ground_truth,
    iou_thds=IOU_THDS_DEFAULT,
    max_gt_windows=None,
    max_pred_windows=None,
    num_workers=8,
    chunksize=50,
    scored=False,
):
    """mAP over IoU thresholds .5:.05:.95, averaged over queries.

    ``scored=True`` reproduces the offline scorer (standalone_eval/eval.py:19-69):
    window rows are ``[st, ed, score]`` and AP ranks by score.
    ``scored=False`` reproduces the in-train scorer (lavis/tasks/mr_eval.py:26-96):
    ground truth comes from the submission records themselves.
    """
    iou_thds = [float(f"{e:.2f}") for e in iou_thds]
    pred_qid2data = defaultdict(list)
    gt_qid2data = defaultdict(list)

    for d in submission:
        qid = d["qid"]
        pred_windows = (
            d["pred_relevant_windows"][:max_pred_windows]
            if max_pred_windows is not None
            else d["pred_relevant_windows"]
        )
        for w in pred_windows:
            entry = {"video-id": qid, "t-start": w[0], "t-end": w[1]}
            if scored:
                entry["score"] = w[2]
            pred_qid2data[qid].append(entry)

    gt_source = ground_truth if scored else submission
    for d in gt_source:
        qid = d["qid"]
        gt_windows = (
            d["relevant_windows"][:max_gt_windows]
            if max_gt_windows is not None
            else d["relevant_windows"]
        )
        for w in gt_windows:
            gt_qid2data[qid].append({"video-id": qid, "t-start": w[0], "t-end": w[1]})

    data_triples = [[qid, gt_qid2data[qid], pred_qid2data[qid]] for qid in pred_qid2data]
    compute_ap_from_triple = partial(
        _ap_for_query, tiou_thresholds=iou_thds, sort_by_score=scored
    )

    qid2ap_list = {}
    if num_workers > 1 and len(data_triples) > 64:
        pool = _get_pool(num_workers)
        for qid, scores in pool.imap_unordered(
            compute_ap_from_triple, data_triples, chunksize=chunksize
        ):
            qid2ap_list[qid] = scores
    else:
        for data_triple in data_triples:
            qid, scores = compute_ap_from_triple(data_triple)
            qid2ap_list[qid] = scores

    if not qid2ap_list:
        # Empty range slice: the reference crashes here (zip over a scalar
        # nan); we report zeros instead. Non-empty slices are unaffected.
        ap_thds = np.zeros(len(iou_thds))
    else:
        ap_array = np.array(list(qid2ap_list.values()))  # (#queries, #thds)
        ap_thds = ap_array.mean(0)
    iou_thd2ap = dict(zip([str(e) for e in iou_thds], ap_thds))
    iou_thd2ap["average"] = np.mean(ap_thds)
    return {k: float(f"{100 * v:.2f}") for k, v in iou_thd2ap.items()}


def compute_mr_r1(submission, ground_truth, iou_thds=IOU_THDS_DEFAULT, extended=False):
    """Recall@1 at IoU thresholds against the best-matching GT window.

    ``extended=True`` additionally returns ``(r1_dict, r1_avg, mIoU,
    invalid_pred_num)`` like the in-train scorer (lavis/tasks/mr_eval.py:99-140);
    otherwise returns just the R1 dict (standalone_eval/eval.py:72-96).
    """
    iou_thds = [float(f"{e:.2f}") for e in iou_thds]
    pred_qid2window = {d["qid"]: d["pred_relevant_windows"][0][:2] for d in submission}

    gt_qid2window = {}
    for d in ground_truth:
        cur_gt_windows = d["relevant_windows"]
        cur_qid = d["qid"]
        cur_max_iou_idx = 0
        if len(cur_gt_windows) > 0:
            cur_ious = temporal_iou_cross(
                np.array([pred_qid2window[cur_qid]]), np.array(d["relevant_windows"])
            )[0]
            cur_max_iou_idx = np.argmax(cur_ious)
        gt_qid2window[cur_qid] = cur_gt_windows[cur_max_iou_idx]

    qids = list(pred_qid2window.keys())
    if not qids:
        # Empty slice (reference crashes on the (0, 2) reshape); report zeros.
        zeros = {str(thd): 0.0 for thd in iou_thds}
        if not extended:
            return zeros
        return zeros, 0.0, 0.0, 0
    pred_windows = np.array([pred_qid2window[k] for k in qids]).astype(float)
    gt_windows = np.array([gt_qid2window[k] for k in qids]).astype(float)
    pred_gt_iou = temporal_iou_paired(pred_windows, gt_windows)
    iou_thd2recall_at_one = {}
    for thd in iou_thds:
        iou_thd2recall_at_one[str(thd)] = float(f"{np.mean(pred_gt_iou >= thd) * 100:.2f}")

    if not extended:
        return iou_thd2recall_at_one

    invalid_pred_num = int(sum(1 for pred in pred_windows if -1 in pred))
    r1_avg = np.mean(list(iou_thd2recall_at_one.values()))
    mIoU = np.mean(pred_gt_iou)
    return iou_thd2recall_at_one, r1_avg, mIoU, invalid_pred_num


def get_window_len(window):
    return window[1] - window[0]


def get_data_by_range(submission, ground_truth, len_range):
    """Keep queries whose GT window length falls in ``(min_l, max_l]``.

    Matches standalone_eval/eval.py:103-133.
    """
    min_l, max_l = len_range
    if min_l == 0 and max_l == 150:  # min and max l in the QVH dataset
        return submission, ground_truth

    ground_truth_in_range = []
    gt_qids_in_range = set()
    for d in ground_truth:
        rel_windows_in_range = [
            w for w in d["relevant_windows"] if min_l < get_window_len(w) <= max_l
        ]
        if len(rel_windows_in_range) > 0:
            d = copy.deepcopy(d)
            d["relevant_windows"] = rel_windows_in_range
            ground_truth_in_range.append(d)
            gt_qids_in_range.add(d["qid"])

    submission_in_range = [
        copy.deepcopy(d) for d in submission if d["qid"] in gt_qids_in_range
    ]
    return submission_in_range, ground_truth_in_range


def eval_moment_retrieval(submission, ground_truth, verbose=True, mode="qvh"):
    """Range-broken-out MR metrics.

    ``mode="qvh"`` slices by GT window length (standalone_eval/eval.py:136-152);
    ``mode="intrain"`` keeps the four range names but scores the full set each
    time and adds R1-avg / mIoU / invalid counts (lavis/tasks/mr_eval.py:181-218).
    """
    length_ranges = [[0, 10], [10, 30], [30, 150], [0, 150]]
    range_names = ["short", "middle", "long", "full"]

    ret_metrics = {}
    for l_range, name in zip(length_ranges, range_names):
        if mode == "qvh":
            _submission, _ground_truth = get_data_by_range(
                submission, ground_truth, l_range
            )
            if verbose:
                print(
                    f"{name}: {l_range}, {len(_ground_truth)}/{len(ground_truth)}="
                    f"{100 * len(_ground_truth) / len(ground_truth):.2f} examples."
                )
            iou_thd2ap = compute_mr_ap(
                _submission, _ground_truth, num_workers=8, chunksize=50,
                max_pred_windows=10, scored=True,
            )
            iou_thd2r1 = compute_mr_r1(_submission, _ground_truth)
            ret_metrics[name] = {"MR-mAP": iou_thd2ap, "MR-R1": iou_thd2r1}
        else:
            # In-train scoring runs inside a multithreaded process: fork-based
            # pools risk deadlock there, so score serially.
            iou_thd2ap = compute_mr_ap(
                submission, ground_truth, num_workers=1, scored=False
            )
            iou_thd2r1, r1_avg, mIoU, invalid_pred_num = compute_mr_r1(
                submission, ground_truth, extended=True
            )
            ret_metrics[name] = {
                "MR-mAP": iou_thd2ap,
                "MR-R1": iou_thd2r1,
                "MR-R1-avg": r1_avg,
                "MR-mIoU": mIoU,
                "MR-invalid_pred_num": invalid_pred_num,
            }
    return ret_metrics


def compute_hl_hit1(qid2preds, qid2gt_scores_binary):
    """Highlight Hit@1 (standalone_eval/eval.py:155-167)."""
    qid2max_scored_clip_idx = {
        k: np.argmax(v["pred_saliency_scores"]) for k, v in qid2preds.items()
    }
    hit_scores = np.zeros((len(qid2preds), 3))
    for idx, qid in enumerate(qid2preds):
        pred_clip_idx = qid2max_scored_clip_idx[qid]
        gt_scores_binary = qid2gt_scores_binary[qid]  # (#clips, 3)
        if pred_clip_idx < len(gt_scores_binary):
            hit_scores[idx] = gt_scores_binary[pred_clip_idx]
    # Max over the 3 annotators, then mean over queries.
    return float(f"{100 * np.mean(np.max(hit_scores, 1)):.2f}")


def _hl_ap_for_tuple(input_tuple):
    idx, w_idx, y_true, y_predict = input_tuple
    if len(y_true) < len(y_predict):
        y_predict = y_predict[: len(y_true)]
    elif len(y_true) > len(y_predict):
        _y_predict = np.zeros(len(y_true))
        _y_predict[: len(y_predict)] = y_predict
        y_predict = _y_predict
    return idx, w_idx, binary_average_precision(y_true, y_predict)


def compute_hl_ap(qid2preds, qid2gt_scores_binary, num_workers=8, chunksize=50):
    """Highlight mAP over the 3 annotators (standalone_eval/eval.py:170-194)."""
    qid2pred_scores = {k: v["pred_saliency_scores"] for k, v in qid2preds.items()}
    ap_scores = np.zeros((len(qid2preds), 3))
    input_tuples = []
    for idx, qid in enumerate(qid2preds):
        for w_idx in range(3):
            y_true = qid2gt_scores_binary[qid][:, w_idx]
            y_predict = np.array(qid2pred_scores[qid])
            input_tuples.append((idx, w_idx, y_true, y_predict))

    if num_workers > 1 and len(input_tuples) > 64:
        pool = _get_pool(num_workers)
        for idx, w_idx, score in pool.imap_unordered(
            _hl_ap_for_tuple, input_tuples, chunksize=chunksize
        ):
            ap_scores[idx, w_idx] = score
    else:
        for input_tuple in input_tuples:
            idx, w_idx, score = _hl_ap_for_tuple(input_tuple)
            ap_scores[idx, w_idx] = score

    return float(f"{100 * np.mean(ap_scores):.2f}")


def mk_gt_scores(gt_data, clip_length=2):
    """Expand sparse relevant-clip saliency scores to the full clip grid."""
    num_clips = int(gt_data["duration"] / clip_length)
    saliency_scores_full_video = np.zeros((num_clips, 3))
    relevant_clip_ids = np.array(gt_data["relevant_clip_ids"])
    saliency_scores_relevant_clips = np.array(gt_data["saliency_scores"])
    saliency_scores_full_video[relevant_clip_ids] = saliency_scores_relevant_clips
    return saliency_scores_full_video  # (#clips, 3), scores in [0, 4]


def eval_highlight(submission, ground_truth, verbose=True):
    """Highlight detection metrics at Fair/Good/VeryGood saliency cutoffs."""
    qid2preds = {d["qid"]: d for d in submission}
    qid2gt_scores_full_range = {d["qid"]: mk_gt_scores(d) for d in ground_truth}
    gt_saliency_score_min_list = [2, 3, 4]
    saliency_score_names = ["Fair", "Good", "VeryGood"]
    highlight_det_metrics = {}
    for gt_saliency_score_min, score_name in zip(
        gt_saliency_score_min_list, saliency_score_names
    ):
        qid2gt_scores_binary = {
            k: (v >= gt_saliency_score_min).astype(float)
            for k, v in qid2gt_scores_full_range.items()
        }
        hit_at_one = compute_hl_hit1(qid2preds, qid2gt_scores_binary)
        mean_ap = compute_hl_ap(qid2preds, qid2gt_scores_binary)
        highlight_det_metrics[f"HL-min-{score_name}"] = {
            "HL-mAP": mean_ap,
            "HL-Hit1": hit_at_one,
        }
    return highlight_det_metrics


def eval_submission(submission, ground_truth, verbose=True, match_number=True, mode="qvh"):
    """Top-level scorer assembling the ``brief``/``full`` metric dicts.

    ``mode="qvh"`` matches standalone_eval/eval.py:249-320 (used by the
    offline scorer CLI); ``mode="intrain"`` matches lavis/tasks/mr_eval.py:330-416
    (used by the moment_retrieval task, which passes the merged eval results as
    both submission and ground truth).
    """
    pred_qids = set([e["qid"] for e in submission])
    gt_qids = set([e["qid"] for e in ground_truth])
    if match_number:
        assert pred_qids == gt_qids, (
            "qids in ground_truth and submission must match. "
            "use `match_number=False` if you wish to disable this check"
        )
    else:
        shared_qids = pred_qids.intersection(gt_qids)
        submission = [e for e in submission if e["qid"] in shared_qids]
        ground_truth = [e for e in ground_truth if e["qid"] in shared_qids]

    eval_metrics = {}
    eval_metrics_brief = OrderedDict()
    if "pred_relevant_windows" in submission[0]:
        if mode == "qvh":
            moment_ret_scores = eval_moment_retrieval(
                submission, ground_truth, verbose=verbose, mode=mode
            )
        else:
            # The in-train scorer reads GT windows from the submission records.
            moment_ret_scores = eval_moment_retrieval(
                submission, submission, verbose=verbose, mode=mode
            )
        eval_metrics.update(moment_ret_scores)
        moment_ret_scores_brief = {
            "MR-full-mAP": moment_ret_scores["full"]["MR-mAP"]["average"],
            "MR-full-mAP@0.5": moment_ret_scores["full"]["MR-mAP"]["0.5"],
            "MR-full-mAP@0.75": moment_ret_scores["full"]["MR-mAP"]["0.75"],
            "MR-short-mAP": moment_ret_scores["short"]["MR-mAP"]["average"],
            "MR-middle-mAP": moment_ret_scores["middle"]["MR-mAP"]["average"],
            "MR-long-mAP": moment_ret_scores["long"]["MR-mAP"]["average"],
            "MR-full-R1@0.5": moment_ret_scores["full"]["MR-R1"]["0.5"],
            "MR-full-R1@0.7": moment_ret_scores["full"]["MR-R1"]["0.7"],
        }
        if mode == "intrain":
            moment_ret_scores_brief.update(
                {
                    "MR-full-R1-avg": moment_ret_scores["full"]["MR-R1-avg"],
                    "MR-full-mIoU": moment_ret_scores["full"]["MR-mIoU"],
                    "MR-full-invalid_pred_num": moment_ret_scores["full"][
                        "MR-invalid_pred_num"
                    ],
                }
            )
        eval_metrics_brief.update(
            sorted([(k, v) for k, v in moment_ret_scores_brief.items()], key=lambda x: x[0])
        )

    if "pred_saliency_scores" in submission[0]:
        highlight_det_scores = eval_highlight(submission, ground_truth, verbose=verbose)
        eval_metrics.update(highlight_det_scores)
        highlight_det_scores_brief = dict(
            [
                (f"{k}-{sub_k.split('-')[1]}", v[sub_k])
                for k, v in highlight_det_scores.items()
                for sub_k in v
            ]
        )
        eval_metrics_brief.update(highlight_det_scores_brief)

    final_eval_metrics = OrderedDict()
    final_eval_metrics["brief"] = eval_metrics_brief
    final_eval_metrics.update(
        sorted([(k, v) for k, v in eval_metrics.items()], key=lambda x: x[0])
    )
    return final_eval_metrics
