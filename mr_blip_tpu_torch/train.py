"""Training entry point of the port (the counterpart of the repo's
``train.py``, reference ``train.py:77-130``).

    python -m mr_blip_tpu_torch.train --cfg-path configs/projects/train/qvh.yaml \
        --options datasets.qvh.build_info.annotations.train.storage=/data/qvh/train.json ...

Config (the YAML read without pyyaml), seeds, task, datasets,
``BLIP2_MR.from_config``, the runner named by ``run.runner``; with
``run.resume_ckpt_path`` the runner first loads that resume state. Then
``runner.train()``: the epochs, validation and the best checkpoint, and the
test splits evaluated at the end, under ``run.output_dir/<job id>/``. The
model runs on ``run.device``, the card unless the options say
``run.device=cpu``.

Several processes, as the reference launches its training (data
parallelism; ``run.distributed: True``, ``nccl`` on the cards by default)::

    python -m torch.distributed.run --nproc_per_node=8 -m mr_blip_tpu_torch.train \
        --cfg-path configs/projects/train/qvh.yaml --options ...

Each rank takes ``batch_size_train`` rows per micro-batch on its own card
(``cuda:LOCAL_RANK``) and the update is the one of the global batch. On the
host: ``run.device=cpu`` (``gloo``); two ranks on one card:
``run.dist_backend=gloo``. ``model.sequence_parallel=True`` shares each
video's frames out over the ranks instead of the rows.

SIGTERM (a preemption, a maintenance drain) finishes the current step,
writes ``resume_state.pth`` and exits with code 143 (every rank at the same
step); run again with
``run.resume_ckpt_path=<output dir>/<job id>/resume_state.pth`` to re-run
the interrupted epoch and go on. ``main(argv)`` returns the runner's test
logs ({split: metrics}).
"""

from __future__ import annotations

import argparse
import logging
import random
import sys

import numpy as np
import torch


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Training")
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
    from mr_blip_tpu_torch.common import preempt
    from mr_blip_tpu_torch.common.config import Config
    from mr_blip_tpu_torch.common.logger import setup_logger
    from mr_blip_tpu_torch.common.registry import registry
    from mr_blip_tpu_torch.common.utils import now

    job_id = now()
    args = parse_args(argv)
    cfg = Config(args)

    if cfg.run_cfg.get("validate_config", False):
        # Enforce the run-config vocabulary (the reference ships the same
        # validator but never calls it, lavis/common/config.py:261-468).
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
    resume_path = cfg.run_cfg.get("resume_ckpt_path")
    if resume_path:
        runner.load_checkpoint(resume_path)

    # SIGTERM -> finish the current step, write the resume state, exit 143
    preempt.install_guard(sync_every=int(cfg.run_cfg.get("preempt_sync_every", 8)))
    try:
        test_logs = runner.train()
    except preempt.TrainingPreempted as e:
        logging.warning("%s — exiting for restart", e)
        dist_utils.destroy()
        sys.exit(143)
    finally:
        preempt.uninstall_guard()
    runner.finalize_checkpoints()
    logging.info("test logs: %s", test_logs)
    dist_utils.destroy()
    return test_logs


if __name__ == "__main__":
    main()
