"""VideoQA / grounded VideoGQA / FrameQA tasks (the port's counterpart of the
Mr. BLIP tasks of ``mr_blip_tpu/tasks/vqa.py``; the LAVIS-zoo VQA tasks of
that file are not ported).

Matches the reference ``lavis/tasks/vqa.py:436-860``: multiple-choice
accuracy with per-question-type breakdown (qid prefixes; STAR group
average), and for NExT-GQA the grounding metrics (Acc@GQA, mIoP/TIoP,
mIoU/TIoU) via :func:`mr_blip_tpu_torch.metrics.grounded_qa.eval_ground`.
The evaluation is pipelined one batch deep: batch i's window re-decode and
answerer overlap batch i+1's localizer.
"""

from __future__ import annotations

import json
import logging
import os

import numpy as np

from mr_blip_tpu_torch.common import dist as dist_utils
from mr_blip_tpu_torch.common.logger import MetricLogger
from mr_blip_tpu_torch.common.registry import registry
from mr_blip_tpu_torch.metrics.grounded_qa import eval_ground
from mr_blip_tpu_torch.tasks.base_task import BaseTask

ANS_MAPPING = {"A": 0, "B": 1, "C": 2, "D": 3, "E": 4}


@registry.register_task("videoqa")
class VideoQA(BaseTask):
    def __init__(self):
        super().__init__()
        self.ANS_MAPPING = ANS_MAPPING

    def valid_step(self, model, samples):
        return self._rows_from_outputs(model.videoQA_generate(samples), samples)

    def _rows_from_outputs(self, outputs, samples):
        results = []
        answer = outputs["answer"]
        qid = outputs["qid"]
        output_text = outputs["output_text"]
        frame_idx = outputs.get("frame_idx", [0] * len(qid))
        assert len(qid) == len(output_text) == len(answer)

        for a, q, o, f in zip(answer, qid, output_text, frame_idx):
            results.append(
                {
                    "qid": q,
                    "prediction": o,
                    "target": self.ANS_MAPPING[a[-1]],
                    "frame_idx": f,
                }
            )
        return results

    def evaluation(self, model, data_loader, **kwargs):
        """One-deep pipelined two-stage eval: batch i's window re-decode (the
        native decode pool) and answerer overlap batch i+1's localizer on the
        device, through the model's videoQA dispatch/redecode/collect split
        (the reference re-decodes mid-model, blocking the GPU,
        blip2_mr.py:1167-1230)."""
        if not hasattr(model, "videoQA_dispatch"):
            return super().evaluation(model, data_loader, **kwargs)
        metric_logger = MetricLogger(delimiter="  ")
        results, pending = [], None
        for i, samples in enumerate(
            metric_logger.log_every(data_loader, 10, "Evaluation")
        ):
            samples = dict(samples)
            samples.update({"iters": i})
            handle = model.videoQA_dispatch(samples)
            if pending is not None:
                h = model.videoQA_redecode(pending)
                results.extend(self._rows_from_outputs(
                    model.videoQA_collect(h), h["samples"]))
            pending = handle
        if pending is not None:
            h = model.videoQA_redecode(pending)
            results.extend(self._rows_from_outputs(
                model.videoQA_collect(h), h["samples"]))
        dist_utils.barrier()
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

    @staticmethod
    def _accuracy_breakdown(results):
        total_num = len(results)
        acc = 0
        qtype_correct, qtype_total = {}, {}
        for r in results:
            qtype = str(r["qid"]).split("_")[0]
            qtype_total[qtype] = qtype_total.get(qtype, 0) + 1
            if r["prediction"] == r["target"]:
                acc += 1
                qtype_correct[qtype] = qtype_correct.get(qtype, 0) + 1
        metrics = {}
        for qtype in qtype_total:
            metrics[qtype] = qtype_correct.get(qtype, 0) / qtype_total[qtype] * 100
        metrics["agg_metrics"] = acc / total_num
        metrics["total"] = total_num
        # STAR reports the mean over its four question groups.
        star_groups = ("Interaction", "Sequence", "Prediction", "Feasibility")
        if all(g in metrics for g in star_groups):
            metrics["agg_metrics"] = sum(metrics[g] for g in star_groups) / 4
        return metrics

    @staticmethod
    def _write_metrics(metrics, split_name):
        """Append ``{split: metrics}`` to ``<output_dir>/evaluate.txt`` and
        log it."""
        log_stats = {split_name: dict(metrics)}
        out_dir = registry.get_path("output_dir")
        if out_dir:
            with open(os.path.join(out_dir, "evaluate.txt"), "a") as f:
                f.write(json.dumps(log_stats) + "\n")
        logging.info(metrics)
        return metrics

    @dist_utils.main_process
    def _report_metrics(self, eval_result_file, split_name):
        with open(eval_result_file) as f:
            results = json.load(f)
        return self._write_metrics(self._accuracy_breakdown(results), split_name)


@registry.register_task("videogqa")
class VideoGQA(VideoQA):
    def _rows_from_outputs(self, outputs, samples):
        results = []
        answer = outputs["answer"]
        qid = outputs["qid"]
        output_text = outputs["output_text"]
        relevant_moments = outputs["relevant_moments"]
        relevant_moments_gt = np.asarray(outputs["relevant_moments_gt"]).tolist()
        duration = samples["duration"]
        frame_idx = outputs.get("frame_idx", [0] * len(qid))
        assert len(qid) == len(output_text) == len(answer)

        # relevant_moments comes batched in a single-element list
        moments = relevant_moments[0] if len(relevant_moments) == 1 else relevant_moments

        for a, q, o, f, d, m, mgt in zip(
            answer, qid, output_text, frame_idx, duration, moments,
            relevant_moments_gt,
        ):
            results.append(
                {
                    "qid": q,
                    "prediction": o,
                    "target": self.ANS_MAPPING[a[-1]],
                    "frame_idx": f,
                    "relevant_moments": [m],
                    "relevant_moments_gt": mgt,
                    "duration": float(d),
                }
            )
        return results

    @dist_utils.main_process
    def _report_metrics(self, eval_result_file, split_name):
        with open(eval_result_file) as f:
            results = json.load(f)
        metrics = self._accuracy_breakdown(results)
        agg, total = metrics.pop("agg_metrics"), metrics.pop("total")
        metrics.update(eval_ground(results))
        metrics.update({"agg_metrics": agg, "total": total})
        return self._write_metrics(metrics, split_name)


@registry.register_task("frameqa")
class FrameQA(VideoQA):
    """Single-frame QA ablation (reference vqa.py:333-433): same contract as
    videoqa; the model's localizer variant decides frame selection."""
