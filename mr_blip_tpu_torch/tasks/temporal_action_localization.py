"""Temporal action localization task, ANet-style detection (the port's
counterpart of ``mr_blip_tpu/tasks/temporal_action_localization.py``).

Counterpart of the reference ``lavis/tasks/temporal_action_localization.py``
+ ``tal_eval.py`` (ANETdetection): the model generates
``[[start, end, "label"], ...]`` strings; evaluation validates predicted
labels against the class table, computes per-class detection AP over IoU
thresholds .5:.05:.95 (greedy GT locking) and per-class top-1x recall, and
reports the reference's metric dict
(``temporal_action_localization.py:136-216``):
``agg_metrics``=average mAP, ``r1``/``mAP`` per-threshold dicts,
``invalid_predictions`` fraction and ``class_label_mismatch`` count
(raw count, matching the reference dict).

Class table: the reference reads ``lavis/tasks/ANet_classes.txt``, a file
it does not ship. The path comes from ``run.tal_classes_path``; when the
file is missing, label validation is off and a warning is logged.
Training takes the moment-retrieval span step (``BaseTask.train_step``):
the TAL target string goes to ``prepare_mr_batch`` as it is.
"""

from __future__ import annotations

import json
import logging
import os
from collections import defaultdict

import numpy as np

from mr_blip_tpu_torch.common import dist as dist_utils
from mr_blip_tpu_torch.common.registry import registry
from mr_blip_tpu_torch.metrics.span_ops import (
    average_precision_detection,
    compute_topkx_recall_detection,
)
from mr_blip_tpu_torch.tasks.base_task import BaseTask
from mr_blip_tpu_torch.tasks.moment_retrieval import MomentRetrievalTask
from mr_blip_tpu_torch.text.span_grammar import tal_str_to_list

MISMATCH_LABEL = "Error: class label mismatch!"  # reference literal (:171)


def anet_detection_eval(targets, preds, tiou_thresholds=None, top_k=(1, 5)):
    """ANETdetection protocol (tal_eval.py:117-320) over parsed segments.

    ``targets``/``preds``: lists of dicts with video-id/t-start/t-end/label
    (+score for preds). Classes come from the ground truth (activity_index);
    predictions with labels absent from GT contribute nothing (reference
    prints a warning and uses an empty frame). Returns (mAP per threshold,
    average mAP, recall (thresholds, top_k)).
    """
    if tiou_thresholds is None:
        tiou_thresholds = np.linspace(0.5, 0.95, 10)
    gt_by_class = defaultdict(list)
    pred_by_class = defaultdict(list)
    for g in targets:
        gt_by_class[str(g["label"])].append(g)
    for p in preds:
        pred_by_class[str(p["label"])].append(p)

    classes = sorted(gt_by_class)  # activity_index (tal_eval.py:163-166)
    n_thd = len(tiou_thresholds)
    if not classes:
        zeros = np.zeros(n_thd)
        return zeros, 0.0, np.zeros((n_thd, len(top_k)))

    ap = np.zeros((n_thd, len(classes)))
    recall = np.zeros((n_thd, len(top_k), len(classes)))
    for ci, c in enumerate(classes):
        ap[:, ci] = average_precision_detection(
            gt_by_class[c], pred_by_class.get(c, []),
            tiou_thresholds=tiou_thresholds, sort_by_score=True,
        )
        recall[..., ci] = compute_topkx_recall_detection(
            gt_by_class[c], pred_by_class.get(c, []),
            tiou_thresholds=tiou_thresholds, top_k=top_k,
        )
    mAP = ap.mean(axis=1)
    mRecall = recall.mean(axis=2)
    return mAP, float(mAP.mean()), mRecall


@registry.register_task("temporal_action_localization")
class TALTask(BaseTask):
    def __init__(self, classes_path: str | None = None):
        super().__init__()
        self.classes = None
        if classes_path and os.path.isfile(classes_path):
            with open(classes_path) as f:
                self.classes = f.read().splitlines()
        elif classes_path:
            logging.warning("TAL classes file %s not found; label validation "
                            "disabled", classes_path)

    @classmethod
    def setup_task(cls, cfg=None, **kwargs):
        run_cfg = cfg.run_cfg if cfg is not None else {}
        return cls(classes_path=run_cfg.get("tal_classes_path"))

    def valid_step(self, model, samples):
        """The moment-retrieval task's rows: {qid_i, raw_prediction,
        prediction, target, duration}."""
        return MomentRetrievalTask._rows_from_outputs(model.generate(samples))

    def after_evaluation(self, val_result, split_name, epoch, **kwargs):
        eval_result_file = self.save_result(
            result=val_result,
            result_dir=registry.get_path("result_dir"),
            filename="{}_epoch{}".format(split_name, epoch),
        )
        return self._report_metrics(
            eval_result_file=eval_result_file, split_name=split_name
        )

    @dist_utils.main_process
    def _report_metrics(self, eval_result_file, split_name):
        """Reference parse+validate+score flow
        (temporal_action_localization.py:118-216); appends ``{split:
        metrics}`` to ``<output_dir>/evaluate.txt``."""
        with open(eval_result_file) as f:
            results = json.load(f)
        total_num = max(len(results), 1)
        invalid_pred_num = 0
        class_label_mismatch = 0

        targets, preds = [], []
        for r in results:
            for t in tal_str_to_list(r["target"]):
                targets.append({"video-id": r["qid"], "t-start": t[0],
                                "t-end": t[1], "label": t[2]})
            preds_interpreted = tal_str_to_list(r["prediction"])
            for pred in preds_interpreted:
                if preds_interpreted == [[-1, -1, -1]]:
                    invalid_pred_num += 1
                    break
                if len(pred) != 3:
                    invalid_pred_num += 1
                    continue
                label = pred[2]
                if self.classes is not None and label not in self.classes:
                    label = MISMATCH_LABEL
                    class_label_mismatch += 1
                preds.append({"video-id": r["qid"], "t-start": pred[0],
                              "t-end": pred[1], "label": label, "score": 1})

        thresholds = np.linspace(0.5, 0.95, 10)
        mAP, average_mAP, mRecall = anet_detection_eval(
            targets, preds, tiou_thresholds=thresholds
        )
        r1 = mRecall[:, 0]  # recall@1x (reference :190-192)
        metrics = {
            "agg_metrics": float(average_mAP),
            "r1": {str(round(t, 2)): float(r) for t, r in zip(thresholds, r1)},
            "mAP": {str(round(t, 2)): float(a) for t, a in zip(thresholds, mAP)},
            "mIoU": 0,
            "invalid_predictions": invalid_pred_num / total_num,
            "class_label_mismatch": class_label_mismatch,
            "total": len(results),
        }
        with open(os.path.join(registry.get_path("output_dir"), "evaluate.txt"),
                  "a") as f:
            f.write(json.dumps({split_name: metrics}) + "\n")
        logging.info(metrics)
        return metrics
