"""BaseTask: model/dataset construction, the training loop, evaluation and
result files (the port's counterpart of ``mr_blip_tpu/tasks/base_task.py``,
reference ``lavis/tasks/base_task.py:24-288``).

The runner owns the ``TrainCtx`` (AdamW, accumulation, the dropout stream,
the NaN guard); the task drives iteration order, the lr per (inner epoch,
step), the meters and the tracker's ``train/loss`` / ``train/lr``, and
checks the preemption guard at every step boundary.
``MRBLIP_PROFILE_STEPS=n`` records steps 1..n of epoch 0 with
``torch.profiler`` (a Chrome trace under ``<output_dir>/profile``).
"""

from __future__ import annotations

import json
import logging
import os

import torch

from mr_blip_tpu_torch.common import dist as dist_utils
from mr_blip_tpu_torch.common import preempt, tracking
from mr_blip_tpu_torch.common.logger import MetricLogger, SmoothedValue
from mr_blip_tpu_torch.common.registry import registry


class BaseTask:
    def __init__(self, **kwargs):
        self.inst_id_key = "instance_id"

    @classmethod
    def setup_task(cls, **kwargs):
        return cls()

    def build_model(self, cfg):
        """The registered model's ``from_config`` on ``cfg.model_cfg``, on
        ``run.device`` (the card unless the config asks for the CPU; under
        ``torchrun`` this rank's card)."""
        model_config = cfg.model_cfg
        model_cls = registry.get_model_class(model_config.arch)
        assert model_cls is not None, f"unknown model {model_config.arch!r}"
        return model_cls.from_config(
            model_config,
            device=dist_utils.local_device(cfg.run_cfg.get("device", "cuda")))

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

    # ------------------------------------------------------------- training
    def train_step(self, train_ctx, samples):
        """One micro-batch through ``TrainCtx.step``; returns the loss (host
        float)."""
        return train_ctx.step(train_ctx.model.prepare_mr_batch(samples))

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

    def train_epoch(self, epoch, model, data_loader, train_ctx, lr_scheduler,
                    log_freq=50, accum_grad_iters=1):
        return self._train_inner_loop(
            epoch=epoch, iters_per_epoch=len(data_loader), model=model,
            data_loader=data_loader, train_ctx=train_ctx,
            lr_scheduler=lr_scheduler, log_freq=log_freq,
            accum_grad_iters=accum_grad_iters)

    def train_iters(self, epoch, start_iters, iters_per_inner_epoch, model,
                    data_loader, train_ctx, lr_scheduler, log_freq=50,
                    accum_grad_iters=1):
        return self._train_inner_loop(
            epoch=epoch, start_iters=start_iters,
            iters_per_epoch=iters_per_inner_epoch, model=model,
            data_loader=data_loader, train_ctx=train_ctx,
            lr_scheduler=lr_scheduler, log_freq=log_freq,
            accum_grad_iters=accum_grad_iters)

    def _train_inner_loop(self, epoch, iters_per_epoch, model, data_loader,
                          train_ctx, lr_scheduler, start_iters=None, log_freq=50,
                          accum_grad_iters=1):
        """The training hot loop (reference base_task.py:157-248). Gradient
        accumulation over ``accum_grad_iters`` micro-batches is the
        ``TrainCtx``'s own."""
        if not hasattr(data_loader, "__next__"):
            data_loader = iter(data_loader)

        metric_logger = MetricLogger(delimiter="  ")
        metric_logger.add_meter("lr", SmoothedValue(window_size=50, fmt="{value:.6f}"))
        metric_logger.add_meter("loss", SmoothedValue(window_size=50, fmt="{value:.4f}"))

        if start_iters is None:
            inner_epoch = epoch
            header = f"Train: data epoch: [{inner_epoch}]"
        else:
            inner_epoch = start_iters // iters_per_epoch
            header = f"Train: data epoch: [{epoch}]; inner epoch [{inner_epoch}]"

        tracker = tracking.get()
        profile_steps = int(os.environ.get("MRBLIP_PROFILE_STEPS", 0))
        profiler = None

        for i in metric_logger.log_every(range(iters_per_epoch), log_freq, header):
            if i >= iters_per_epoch:
                break
            if profile_steps and epoch == 0 and i == 1:
                profiler = _start_profile()
            samples = dict(next(data_loader))
            samples.update(
                {"epoch": inner_epoch, "num_iters_per_epoch": iters_per_epoch,
                 "iters": i})

            lr = lr_scheduler.step(cur_epoch=inner_epoch, cur_step=i)
            train_ctx.set_lr(lr)
            loss = self.train_step(train_ctx, samples)  # NaN raises in the step
            metric_logger.update(loss=float(loss))

            # Preemption (SIGTERM) check at the step boundary: the weights,
            # moments and accumulated gradients are whole-step consistent
            # here; the runner turns the raise into a resume state.
            guard = preempt.get_guard()
            if guard is not None and guard.should_stop(i, last=i == iters_per_epoch - 1):
                raise preempt.TrainingPreempted(inner_epoch, i)
            metric_logger.update(lr=float(lr))
            if tracker is not None:
                tracker.log({"train/loss": float(loss), "train/lr": float(lr)})
            if profiler is not None and i == profile_steps:
                _stop_profile(profiler)
                profiler = None
        if profiler is not None:
            _stop_profile(profiler)

        metric_logger.synchronize_between_processes()
        logging.info("Averaged stats: " + str(metric_logger.global_avg()))
        return {
            k: "{:.3f}".format(meter.global_avg)
            for k, meter in metric_logger.meters.items()
        }

    # --------------------------------------------------------------- results
    @staticmethod
    def save_result(result, result_dir, filename, remove_duplicate=""):
        """Per-process result JSON + process-0 merge (base_task.py:250-288).
        Under tensor parallelism only tp rank 0 of each group writes (its
        peers ran the same rows), as ``<filename>_rank<dp rank>.json``."""
        os.makedirs(result_dir, exist_ok=True)
        result_file = os.path.join(
            result_dir, "%s_rank%d.json" % (filename, dist_utils.dp_rank())
        )
        final_result_file = os.path.join(result_dir, "%s.json" % filename)
        if dist_utils.tp_rank() == 0:
            with open(result_file, "w") as f:
                json.dump(result, f, default=float)

        dist_utils.barrier()

        if dist_utils.is_main_process():
            logging.info("rank %d starts merging results." % dist_utils.get_rank())
            merged = []
            for rank in range(dist_utils.dp_size()):
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


def _start_profile():
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=activities)
    profiler.start()
    return profiler


def _stop_profile(profiler):
    """Stop ``profiler`` and write its Chrome trace under
    ``<output_dir>/profile``."""
    profiler.stop()
    out = os.path.join(registry.get_path("output_dir") or ".", "profile")
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, f"trace_rank{dist_utils.get_rank()}.json")
    profiler.export_chrome_trace(path)
    logging.info("profile of the train steps written to %s", path)
