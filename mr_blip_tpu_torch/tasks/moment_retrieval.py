"""Moment-retrieval task: the train step with its periodic sample table, span
generation eval + R1/mAP/mIoU reporting (the port's counterpart of
``mr_blip_tpu/tasks/moment_retrieval.py``).

Matches the reference ``lavis/tasks/moment_retrieval.py:28-257``: valid_step
collects {qid, raw_prediction, prediction, target, duration}; after
evaluation the merged results are scored with the in-train eval_submission
and ``agg_metrics`` is the R1 average over IoU .5:.05:.95.
"""

from __future__ import annotations

import json
import logging

from mr_blip_tpu_torch.common import dist as dist_utils
from mr_blip_tpu_torch.common import tracking
from mr_blip_tpu_torch.common.logger import MetricLogger
from mr_blip_tpu_torch.common.registry import registry
from mr_blip_tpu_torch.metrics.moment_retrieval import eval_submission
from mr_blip_tpu_torch.tasks.base_task import BaseTask
from mr_blip_tpu_torch.text.span_grammar import moment_str_to_list


@registry.register_task("moment_retrieval")
class MomentRetrievalTask(BaseTask):
    def __init__(self, log_samples_every_n: int = 3000):
        super().__init__()
        self.moment_str_to_list = moment_str_to_list
        self.log_samples_every_n = log_samples_every_n

    @classmethod
    def setup_task(cls, cfg=None, **kwargs):
        run_cfg = cfg.run_cfg if cfg is not None else {}
        return cls(log_samples_every_n=run_cfg.get("log_samples_every_n", 3000))

    def train_step(self, train_ctx, samples):
        loss = super().train_step(train_ctx, samples)
        # Periodic sample table (reference logs frames/query/pred/answer to
        # W&B every N iters, blip2_mr.py:546-567).
        i = samples.get("iters", 0)
        if self.log_samples_every_n and i and i % self.log_samples_every_n == 0:
            tracker = tracking.get()
            if tracker is not None:
                out = train_ctx.model.generate(samples)
                rows = [
                    [str(q), rp, p, str(a), float(d)]
                    for q, rp, p, a, d in zip(
                        out["qid"], out["raw_prediction"], out["prediction"],
                        out["answer"], out["duration"],
                    )
                ]
                tracker.log_table(
                    "Samples_during_training",
                    ["qid", "pred", "processed_pred", "answer", "duration"],
                    rows,
                )
        return loss

    def evaluation(self, model, data_loader, **kwargs):
        """One-deep pipelined eval: batch i+1's host prep (tokenization,
        interleave plan) and its device work are issued before batch i's
        beams are copied back and post-processed (the model's
        dispatch/collect split)."""
        if not hasattr(model, "generate_dispatch"):
            return super().evaluation(model, data_loader, **kwargs)
        metric_logger = MetricLogger(delimiter="  ")
        results, pending = [], None
        for i, samples in enumerate(
            metric_logger.log_every(data_loader, 10, "Evaluation")
        ):
            samples = dict(samples)
            samples.update({"iters": i})
            handle = model.generate_dispatch(samples)
            if pending is not None:
                results.extend(self._rows_from_outputs(model.generate_collect(pending)))
            pending = handle
        if pending is not None:
            results.extend(self._rows_from_outputs(model.generate_collect(pending)))
        dist_utils.barrier()
        return results

    def valid_step(self, model, samples):
        return self._rows_from_outputs(model.generate(samples))

    @staticmethod
    def _rows_from_outputs(outputs):
        results = []
        answer = outputs["answer"]
        qid = outputs["qid"]
        pred = outputs["prediction"]
        raw_pred = outputs["raw_prediction"]
        duration = outputs["duration"]
        assert len(qid) == len(answer)
        assert len(qid) == len(pred)

        for i, (a, q, p, rp, d) in enumerate(zip(answer, qid, pred, raw_pred, duration)):
            results.append(
                {
                    "qid": str(q) + "_" + str(i),
                    "raw_prediction": rp,
                    "prediction": p,
                    "target": a,
                    "duration": d,
                }
            )
        return results

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
        results = json.load(open(eval_result_file))
        total_num = len(results)

        results_interpreted = [
            {
                "qid": r["qid"],
                "pred_relevant_windows": self.moment_str_to_list(r["prediction"]),
                "relevant_windows": self.moment_str_to_list(r["target"]),
            }
            for r in results
        ]

        all_metrics = eval_submission(
            results_interpreted, results_interpreted, verbose=False, mode="intrain"
        )

        metrics = {
            "agg_metrics": all_metrics["brief"]["MR-full-R1-avg"],
            "r1": all_metrics["full"]["MR-R1"],
            "mAP": all_metrics["full"]["MR-mAP"],
            "mIoU": all_metrics["brief"]["MR-full-mIoU"],
            "invalid_predictions": (
                all_metrics["brief"]["MR-full-invalid_pred_num"] / total_num
            ),
            "total": total_num,
        }
        logging.info(metrics)
        return metrics
