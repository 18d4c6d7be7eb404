"""BaseTask: model/dataset construction, evaluation and result files (the
port's counterpart of ``mr_blip_tpu/tasks/base_task.py``, reference
``lavis/tasks/base_task.py:24-288``). The train loop is not ported yet
(ROADMAP Queue 1 item 1).
"""

from __future__ import annotations

import json
import logging
import os

from mr_blip_tpu_torch.common import dist as dist_utils
from mr_blip_tpu_torch.common.logger import MetricLogger
from mr_blip_tpu_torch.common.registry import registry


class BaseTask:
    def __init__(self, **kwargs):
        self.inst_id_key = "instance_id"

    @classmethod
    def setup_task(cls, **kwargs):
        return cls()

    def build_model(self, cfg):
        """The registered model's ``from_config`` on ``cfg.model_cfg``, on
        ``run.device`` (the card unless the config asks for the CPU)."""
        model_config = cfg.model_cfg
        model_cls = registry.get_model_class(model_config.arch)
        assert model_cls is not None, f"unknown model {model_config.arch!r}"
        return model_cls.from_config(model_config,
                                     device=cfg.run_cfg.get("device", "cuda"))

    def build_datasets(self, cfg):
        """name -> {split: dataset} for every entry in datasets_cfg."""
        datasets = {}
        datasets_config = cfg.datasets_cfg
        assert len(datasets_config) > 0, "At least one dataset has to be specified."
        for name in datasets_config:
            builder_cls = registry.get_builder_class(name)
            assert builder_cls is not None, f"unknown dataset builder {name!r}"
            builder = builder_cls(datasets_config[name])
            datasets[name] = builder.build_datasets()
        return datasets

    def valid_step(self, model, samples):
        raise NotImplementedError

    def before_evaluation(self, model, dataset, **kwargs):
        pass

    def after_evaluation(self, **kwargs):
        pass

    def evaluation(self, model, data_loader, **kwargs):
        metric_logger = MetricLogger(delimiter="  ")
        header = "Evaluation"
        print_freq = 10

        results = []
        for i, samples in enumerate(
            metric_logger.log_every(data_loader, print_freq, header)
        ):
            samples = dict(samples)
            samples.update({"iters": i})
            results.extend(self.valid_step(model=model, samples=samples))
        dist_utils.barrier()
        return results

    # --------------------------------------------------------------- results
    @staticmethod
    def save_result(result, result_dir, filename, remove_duplicate=""):
        """Per-process result JSON + process-0 merge (base_task.py:250-288)."""
        os.makedirs(result_dir, exist_ok=True)
        result_file = os.path.join(
            result_dir, "%s_rank%d.json" % (filename, dist_utils.get_rank())
        )
        final_result_file = os.path.join(result_dir, "%s.json" % filename)
        with open(result_file, "w") as f:
            json.dump(result, f, default=float)

        dist_utils.barrier()

        if dist_utils.is_main_process():
            logging.info("rank %d starts merging results." % dist_utils.get_rank())
            merged = []
            for rank in range(dist_utils.get_world_size()):
                result_file = os.path.join(
                    result_dir, "%s_rank%d.json" % (filename, rank)
                )
                with open(result_file, "r") as f:
                    merged += json.load(f)

            if remove_duplicate:
                seen, deduped = set(), []
                for res in merged:
                    if res[remove_duplicate] not in seen:
                        seen.add(res[remove_duplicate])
                        deduped.append(res)
                merged = deduped

            with open(final_result_file, "w") as f:
                json.dump(merged, f, default=float)
            logging.info("result file saved to %s" % final_result_file)

        dist_utils.barrier()
        return final_result_file
