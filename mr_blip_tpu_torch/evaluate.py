"""Evaluation entry point of the port (the counterpart of the repo's
``evaluate.py``, reference ``evaluate.py:66-120``).

    python -m mr_blip_tpu_torch.evaluate --cfg-path configs/projects/eval/qvh.yaml \
        --options datasets.qvh.build_info.annotations.test.storage=/data/qvh/test.json

Config (the YAML read without pyyaml), task, datasets, ``BLIP2_MR.
from_config``, then ``RunnerBase.evaluate(skip_reload=True)``: the test
splits' result rows under ``run.output_dir/<job id>/result/`` and their
metrics in the log. The model runs on ``run.device``, the card unless the
options say ``run.device=cpu``. ``main(argv)`` returns the runner's test
logs ({split: metrics}).

Several processes (``run.distributed: True``), as the reference evaluates::

    python -m torch.distributed.run --nproc_per_node=8 -m mr_blip_tpu_torch.evaluate \
        --cfg-path configs/projects/eval/qvh.yaml --options ...

Each rank generates its share of every split's rows on its own card and
rank 0 merges the per-rank result files and computes the metrics.
"""

from __future__ import annotations

import argparse
import logging
import random

import numpy as np
import torch


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Evaluation")
    parser.add_argument("--cfg-path", required=True, help="path to configuration file.")
    parser.add_argument(
        "--options",
        nargs="+",
        help="override settings, key=value or key value pairs (dot-separated keys)",
    )
    return parser.parse_args(argv)


def main(argv=None):
    import mr_blip_tpu_torch  # noqa: F401  (registers everything)
    from mr_blip_tpu_torch import tasks
    from mr_blip_tpu_torch.common import dist as dist_utils
    from mr_blip_tpu_torch.common.config import Config
    from mr_blip_tpu_torch.common.logger import setup_logger
    from mr_blip_tpu_torch.common.registry import registry
    from mr_blip_tpu_torch.common.utils import now

    job_id = now()
    args = parse_args(argv)
    cfg = Config(args)

    if cfg.run_cfg.get("validate_config", False):
        from mr_blip_tpu_torch.common.config_validator import (
            create_runner_config_validator,
        )

        create_runner_config_validator().validate(dict(cfg.run_cfg))
    dist_utils.init_distributed_mode(cfg.run_cfg)
    job_id = dist_utils.broadcast_object(job_id)  # one output directory
    seed = int(cfg.run_cfg.get("seed", 42)) + dist_utils.dp_rank()
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    setup_logger()
    cfg.pretty_print()

    task = tasks.setup_task(cfg)
    datasets = task.build_datasets(cfg)
    model = task.build_model(cfg)

    runner_cls = registry.get_runner_class(cfg.run_cfg.get("runner", "runner_base"))
    runner = runner_cls(
        cfg=cfg, job_id=job_id, task=task, model=model, datasets=datasets
    )
    test_logs = runner.evaluate(skip_reload=True)
    logging.info("test logs: %s", test_logs)
    dist_utils.destroy()
    return test_logs


if __name__ == "__main__":
    main()
