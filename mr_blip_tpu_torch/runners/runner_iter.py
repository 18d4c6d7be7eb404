"""Iteration-based runner (the port's counterpart of
``mr_blip_tpu/runners/runner_iter.py``, reference
``lavis/runners/runner_iter.py:25-153``).

Training is split into inner epochs of ``iters_per_inner_epoch`` steps;
validation, best-model selection, and checkpoints are keyed by the global
iteration count (``checkpoint_<iters>.pth``, ``best_iters`` in the val
log) rather than epoch numbers. Unlike the reference — whose ``range``
silently truncates a ``max_iters`` that is not a multiple of
``iters_per_inner_epoch`` — construction rejects non-divisible configs.
"""

from __future__ import annotations

import datetime
import logging
import time

from mr_blip_tpu_torch.common import dist as dist_utils
from mr_blip_tpu_torch.common.registry import registry
from mr_blip_tpu_torch.runners.runner_base import RunnerBase


@registry.register_runner("runner_iter")
class RunnerIter(RunnerBase):
    def __init__(self, cfg, task, model, datasets, job_id):
        super().__init__(cfg, task, model, datasets, job_id)
        self.start_iters = 0
        self.max_iters = int(self.run_cfg.get("max_iters", -1))
        assert self.max_iters > 0, "max_iters must be provided for runner_iter."
        self.iters_per_inner_epoch = int(
            self.run_cfg.get("iters_per_inner_epoch", -1)
        )
        assert self.iters_per_inner_epoch > 0, (
            "iters_per_inner_epoch must be provided for runner_iter."
        )
        if self.max_iters % self.iters_per_inner_epoch:
            raise ValueError(
                f"max_iters={self.max_iters} is not a multiple of "
                f"iters_per_inner_epoch={self.iters_per_inner_epoch}; the "
                f"last {self.max_iters % self.iters_per_inner_epoch} iters "
                "would silently never run"
            )

    @property
    def max_epoch(self):
        return int(self.max_iters / self.iters_per_inner_epoch)

    @property
    def cur_epoch(self):
        try:
            return self.train_loader.epoch
        except AttributeError:
            # streaming pipelines have no epoch concept (reference :64-66)
            return 0

    def _progress(self, cur_iters):
        return "{}_iters={}".format(self.cur_epoch, cur_iters)

    def train(self):
        """Inner-epoch loop keyed by iterations (reference :71-131)."""
        start_time = time.time()
        best_agg_metric = 0
        best_iters = 0
        self.log_config()
        self._init_tracking()
        # resume (train.py restores start_epoch from the checkpoint's key;
        # for iter-runners the checkpoint key IS the iteration count)
        if self.start_epoch:
            self.start_iters = self.start_epoch * self.iters_per_inner_epoch

        for start_iters in range(
            self.start_iters, self.max_iters, self.iters_per_inner_epoch
        ):
            end_iters = start_iters + self.iters_per_inner_epoch
            if not self.evaluate_only:
                logging.info(
                    "Start training, max_iters=%d, in total %d inner epochs.",
                    self.max_iters, self.max_epoch,
                )
                train_stats = self.train_iters(self.cur_epoch, start_iters)
                self.log_stats(split_name="train", stats=train_stats)

            if len(self.valid_splits) > 0 and not self.evaluate_only:
                for split_name in self.valid_splits:
                    logging.info("Evaluating on %s.", split_name)
                    val_log = self.eval_epoch(
                        split_name=split_name,
                        cur_epoch=self._progress(end_iters),
                    )
                    is_best = False
                    if val_log is not None and dist_utils.is_main_process():
                        assert "agg_metrics" in val_log, (
                            "No agg_metrics found in validation log."
                        )
                        agg_metrics = val_log["agg_metrics"]
                        if agg_metrics > best_agg_metric and split_name == "val":
                            best_iters, best_agg_metric = end_iters, agg_metrics
                            is_best = True
                        val_log.update({"best_iters": best_iters})
                        self.log_stats(val_log, split_name)
                    # rank 0 decides; every rank takes part in the save
                    if dist_utils.broadcast_object(is_best):
                        self._save_checkpoint(end_iters, is_best=True)
            elif not self.evaluate_only:
                self._save_checkpoint(end_iters, is_best=False)

            if self.evaluate_only:
                break
            dist_utils.barrier()

        test_logs = self.evaluate(cur_epoch=self.cur_epoch,
                                  skip_reload=self.evaluate_only)
        total_time = time.time() - start_time
        logging.info(
            "Training time %s", str(datetime.timedelta(seconds=int(total_time)))
        )
        return test_logs

    def train_iters(self, epoch, start_iters):
        return self.task.train_iters(
            epoch=epoch,
            start_iters=start_iters,
            iters_per_inner_epoch=self.iters_per_inner_epoch,
            model=self.model,
            data_loader=self.train_loader,
            train_ctx=self.train_ctx,
            lr_scheduler=self.lr_scheduler,
            log_freq=self.log_freq,
            accum_grad_iters=int(self.run_cfg.get("accum_grad_iters", 1)),
        )

    def train_epoch(self, epoch):
        """Kept for API parity with RunnerBase callers."""
        return self.train_iters(epoch, epoch * self.iters_per_inner_epoch)
