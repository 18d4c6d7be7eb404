"""Image-text retrieval task (the port's counterpart of
``mr_blip_tpu/tasks/retrieval.py``, reference ``lavis/tasks/retrieval.py``).

The two-stage LAVIS protocol: rank by the contrastive similarity matrix,
then rerank the top-k candidates with the ITM head (the model's
``compute_sim_matrix``). Reports R@1/5/10 and the median rank in both
directions against the dataset's ``i2t_gt`` (an image's caption rows).

The loader the runner hands over wraps the dataset loader (the port's
``PrefetchLoader``); the ground truth is read through it. The JAX runner's
loader exposes no ``dataset``, so the JAX task falls back to the identity
ground truth (image i <-> text i), which raises for a gallery with more
captions than images (ROADMAP Queue 3).
"""

from __future__ import annotations

import logging

import numpy as np

from mr_blip_tpu_torch.common import dist as dist_utils
from mr_blip_tpu_torch.common.registry import registry
from mr_blip_tpu_torch.metrics.caption_metrics import retrieval_metrics
from mr_blip_tpu_torch.tasks.base_task import BaseTask
from mr_blip_tpu_torch.tasks.captioning import _tokenizer_is_fallback


def _dataset_of(loader):
    """The dataset behind ``loader`` (through a ``PrefetchLoader``), or None."""
    while loader is not None and not hasattr(loader, "dataset"):
        loader = getattr(loader, "loader", None)
    return None if loader is None else loader.dataset


@registry.register_task("retrieval")
class RetrievalTask(BaseTask):
    def __init__(self, k_test: int = 128):
        super().__init__()
        self.k_test = k_test

    @classmethod
    def setup_task(cls, cfg=None, **kwargs):
        run_cfg = cfg.run_cfg if cfg is not None else {}
        return cls(k_test=run_cfg.get("k_test", 128))

    def evaluation(self, model, data_loader, **kwargs):
        """Score the full gallery: the model's ``compute_sim_matrix(
        data_loader, k_test)`` returns one (N_img, N_txt) matrix or an
        (i2t, t2i) pair of reranked matrices (the ITM-rerank protocol)."""
        self._tokenizer_fallback = _tokenizer_is_fallback(model)
        sims = model.compute_sim_matrix(data_loader, k_test=self.k_test)
        i2t_gt = getattr(_dataset_of(data_loader), "i2t_gt", None)
        if isinstance(sims, tuple):
            i2t, t2i = sims
            return {"sims": np.asarray(i2t), "sims_t2i": np.asarray(t2i),
                    "i2t_gt": i2t_gt}
        return {"sims": np.asarray(sims), "i2t_gt": i2t_gt}

    def after_evaluation(self, val_result, split_name, epoch, **kwargs):
        return self._report_metrics(val_result, split_name)

    @dist_utils.main_process
    def _report_metrics(self, val_result, split_name):
        metrics = retrieval_metrics(
            val_result["sims"], val_result.get("i2t_gt"),
            score_matrix_t2i=val_result.get("sims_t2i"),
        )
        metrics["agg_metrics"] = metrics["r_mean"]
        if getattr(self, "_tokenizer_fallback", False):
            # hash-bucket offline tokenizer: scores are smoke values only
            metrics["tokenizer_fallback"] = True
        logging.info(metrics)
        return metrics
