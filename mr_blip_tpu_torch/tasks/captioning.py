"""Captioning task (the port's counterpart of ``mr_blip_tpu/tasks/captioning.py``,
reference ``lavis/tasks/captioning.py``).

``valid_step`` expects ``model.generate(samples) -> {"captions": [...]}``
with ``samples["image_id"]``; reporting computes corpus BLEU-4 and CIDEr-D
against the ground-truth caption lists (``metrics/caption_metrics.py``, pure
python, where the reference shells out to pycocoevalcap). The
multimodal classification task waits for ALBEF NLVR (ROADMAP Queue 1).
"""

from __future__ import annotations

import json
import logging

from mr_blip_tpu_torch.common import dist as dist_utils
from mr_blip_tpu_torch.common.registry import registry
from mr_blip_tpu_torch.metrics.caption_metrics import cider_d, corpus_bleu
from mr_blip_tpu_torch.tasks.base_task import BaseTask


def _tokenizer_is_fallback(model) -> bool:
    """True when the model's text side runs on the offline hash-bucket
    WordTokenizer (collisions by construction): text metrics computed
    through it are pipeline smoke values, and the metric dicts say so."""
    return bool(getattr(getattr(model, "tokenizer", None), "is_fallback", False))


@registry.register_task("captioning")
class CaptionTask(BaseTask):
    def __init__(self, num_beams=3, max_len=30, min_len=5, evaluate=False):
        super().__init__()
        self.num_beams = num_beams
        self.max_len = max_len
        self.min_len = min_len
        self.evaluate = evaluate

    @classmethod
    def setup_task(cls, cfg=None, **kwargs):
        run_cfg = cfg.run_cfg if cfg is not None else {}
        return cls(
            num_beams=run_cfg.get("num_beams", 3),
            max_len=run_cfg.get("max_len", 30),
            min_len=run_cfg.get("min_len", 5),
            evaluate=run_cfg.get("evaluate", False),
        )

    def valid_step(self, model, samples):
        self._tokenizer_fallback = _tokenizer_is_fallback(model)
        try:
            out = model.generate(
                samples, max_length=self.max_len, num_beams=self.num_beams,
                min_length=self.min_len,
            )
        except TypeError:  # models with a bare generate(samples) surface
            out = model.generate(samples)
        captions = out["captions"] if isinstance(out, dict) else out
        return [
            {"image_id": img_id, "caption": cap,
             "gt_captions": gts}
            for img_id, cap, gts in zip(
                samples["image_id"], captions,
                samples.get("gt_captions", [[]] * len(captions)),
            )
        ]

    def after_evaluation(self, val_result, split_name, epoch, **kwargs):
        eval_result_file = self.save_result(
            result=val_result,
            result_dir=registry.get_path("result_dir"),
            filename="{}_epoch{}".format(split_name, epoch),
            remove_duplicate="image_id",
        )
        return self._report_metrics(eval_result_file, split_name)

    @dist_utils.main_process
    def _report_metrics(self, eval_result_file, split_name):
        with open(eval_result_file) as f:
            results = json.load(f)
        preds = [r["caption"] for r in results]
        refs = [r.get("gt_captions") or [""] for r in results]
        metrics = {
            "Bleu_4": corpus_bleu(preds, refs),
            "CIDEr": cider_d(preds, refs),
            "total": len(results),
        }
        metrics["agg_metrics"] = metrics["CIDEr"] + metrics["Bleu_4"]
        if getattr(self, "_tokenizer_fallback", False):
            # hash-bucket offline tokenizer: scores are smoke values only
            metrics["tokenizer_fallback"] = True
        logging.info(metrics)
        return metrics
