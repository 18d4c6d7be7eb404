"""RunnerBase: epoch-driven training and evaluation (the port's counterpart of
``mr_blip_tpu/runners/runner_base.py``, reference
``lavis/runners/runner_base.py:38-658``).

Lazily built ``TrainCtx`` (AdamW, accumulation, dropout stream), LR
scheduler and per-split loaders; the epoch loop with per-split validation
and the best checkpoint by ``agg_metrics`` on ``val`` (a checkpoint per epoch
when there is no validation split); the final evaluation of the test splits
with the best checkpoint. The train loader's frames move to ``run.device``
in the step, evaluation loaders copy theirs one batch ahead
(``PrefetchLoader``).

Under a process group (``torchrun``; ``common/dist.py``) every rank holds
the whole model on its own card (``cuda:LOCAL_RANK``), the ranks' trainable
tensors are checked bit-equal after the build, and ``TrainCtx`` sums the
gradients over the ranks once per update (data parallelism). The train
loader gives each rank ``order[rank::world]`` of the whole global batches,
so every rank takes as many steps; an evaluation loader gives each rank its
share, uneven when the split does not divide, and rank 0 merges the
per-rank result files. With ``model.sequence_parallel`` the loaders give
every rank the same rows (the frames are shared out inside the model) and
only rank 0's rows are kept. ``run.tp`` = t > 1 (tensor parallelism, the
JAX runner's (dp, tp) mesh): the world is dp x t ranks
(``common/dist.py::init_model_parallel``), each rank holds its shard of the
language model (``BLIP2_MR.set_tensor_parallel``), the loaders give the t
ranks of a tensor-parallel group the rows of their dp rank, and only the
group's tp rank 0 keeps its evaluation rows.

Checkpoints are ``torch.save`` files in the job's output directory:
``checkpoint_{best,<epoch>}.pth`` holds ``{"model": the trainable tensors
only, "config", "epoch"}``; ``resume_state.pth`` holds what a resume needs,
as the JAX package's ``resume_state`` does: every weight, the ``TrainCtx``
state (AdamW moments and step, the call and update counters, the gradients
accumulated in the current window), the epoch and whether it completed.
``load_checkpoint`` maps it (``mmap=True``) rather than reading it into host
memory. Under a process group rank 0 writes both, after every rank reached
the write (the trainable tensors checked bit-equal across the ranks); the
resume state then holds every rank's gradients of the current window
(``TrainCtx.shared_state_dict``), and each rank loads its own. Under tensor
parallelism the files hold whole tensors (gathered over the group) and
loading cuts them to the rank's shards, so a file loads under any ``tp``;
a resume state's window of gradients resumes under the same world. Orbax, the
JAX package's other format, is a JAX library: the port refuses
``run.use_orbax``.
"""

from __future__ import annotations

import datetime
import json
import logging
import os
import time
from pathlib import Path

import torch

from mr_blip_tpu_torch.common import dist as dist_utils
from mr_blip_tpu_torch.common import tracking
from mr_blip_tpu_torch.common.preempt import TrainingPreempted
from mr_blip_tpu_torch.common.registry import registry
from mr_blip_tpu_torch.datasets.base_dataset import ConcatDataset
from mr_blip_tpu_torch.datasets.loader import (
    DataLoader,
    IterLoader,
    MultiIterLoader,
    PrefetchLoader,
)
from mr_blip_tpu_torch.parallel import tensor as tensor_parallel
from mr_blip_tpu_torch.parallel.mesh import assert_replicated
from mr_blip_tpu_torch.runners.train_state import TrainCtx


@registry.register_runner("runner_base")
class RunnerBase:
    def __init__(self, cfg, task, model, datasets, job_id):
        self.config = cfg
        self.job_id = job_id
        self.task = task
        self.datasets = datasets
        self.model = model

        self._train_ctx = None
        self._dataloaders = None
        self._lr_sched = None
        self.start_epoch = 0
        if self.run_cfg.get("use_orbax", False):
            raise ValueError(
                "run.use_orbax=True: orbax is a JAX checkpoint library; the port "
                "writes torch.save files (checkpoint_<epoch>.pth, resume_state.pth)")
        tp = int(self.run_cfg.get("tp", 1))
        if tp > 1:
            if dist_utils.tp_size() != tp:
                raise ValueError(
                    f"run.tp={tp}: the process group was built for tp="
                    f"{dist_utils.tp_size()} (init_distributed_mode reads run.tp)")
            model.set_tensor_parallel(dist_utils.tp_group())
        if dist_utils.get_world_size() > 1:
            mask = model.trainable_mask()
            assert_replicated(
                {n: p for n, p in model.module.named_parameters() if mask[n]},
                "the trainable tensors as built")

        self.setup_output_dir()

    # ----------------------------------------------------------- properties
    @property
    def run_cfg(self):
        return self.config.run_cfg

    @property
    def device(self):
        """``run.device``; ``cuda`` is this rank's card under ``torchrun``."""
        return dist_utils.local_device(self.run_cfg.get("device", "cuda"))

    @property
    def rows_replicated(self) -> bool:
        """Whether every rank runs the same rows (sequence parallelism)."""
        return bool(getattr(self.model, "sequence_parallel", False))

    @property
    def use_dist_eval_sampler(self):
        return self.run_cfg.get("use_dist_eval_sampler", True)

    @property
    def train_ctx(self) -> TrainCtx:
        if self._train_ctx is None:
            run = self.run_cfg
            self._train_ctx = TrainCtx(
                self.model,
                weight_decay=float(run.get("weight_decay", 0.05)),
                beta1=float(run.get("beta1", 0.9)),
                beta2=float(run.get("beta2", 0.999)),
                accum_grad_iters=int(run.get("accum_grad_iters", 1)),
                max_grad_norm=run.get("max_grad_norm"),
                seed=int(run.get("seed", 42)),
            )
            trainable, total = self.model.trainable_param_count()
            logging.info("trainable params: %.2fM / %.2fM total",
                         trainable / 1e6, total / 1e6)
        return self._train_ctx

    @property
    def lr_scheduler(self):
        if self._lr_sched is None:
            lr_sched_cls = registry.get_lr_scheduler_class(self.run_cfg.lr_sched)
            self._lr_sched = lr_sched_cls(
                max_epoch=self.max_epoch,
                min_lr=float(self.run_cfg.get("min_lr", 0)),
                init_lr=float(self.run_cfg.init_lr),
                decay_rate=self.run_cfg.get("lr_decay_rate", 1),
                warmup_start_lr=float(self.run_cfg.get("warmup_lr", -1)),
                warmup_steps=int(self.run_cfg.get("warmup_steps", 0)),
            )
        return self._lr_sched

    @property
    def max_epoch(self):
        return int(self.run_cfg.max_epoch)

    @property
    def log_freq(self):
        return int(self.run_cfg.get("log_freq", 50))

    @property
    def valid_splits(self):
        return self.run_cfg.get("valid_splits", [])

    @property
    def test_splits(self):
        return self.run_cfg.get("test_splits", [])

    @property
    def train_splits(self):
        return self.run_cfg.get("train_splits", [])

    @property
    def evaluate_only(self):
        return bool(self.run_cfg.get("evaluate", False))

    @property
    def dataloaders(self):
        if self._dataloaders is None:
            self._dataloaders = self.create_loaders()
        return self._dataloaders

    @property
    def train_loader(self):
        return self.dataloaders["train"]

    def setup_output_dir(self):
        output_dir = Path(self.run_cfg.get("output_dir", "output")) / self.job_id
        result_dir = output_dir / "result"
        output_dir.mkdir(parents=True, exist_ok=True)
        result_dir.mkdir(parents=True, exist_ok=True)
        registry.register_path("result_dir", str(result_dir))
        registry.register_path("output_dir", str(output_dir))
        self.result_dir = result_dir
        self.output_dir = output_dir

    # ------------------------------------------------------------- loaders
    def create_loaders(self):
        """Flatten {dataset: {split: ds}} into per-split loaders.

        Multiple train datasets become a MultiIterLoader with
        ``train_dataset_ratios``; eval splits shard across processes like
        DistributedSampler (runner_base.py:176-277,491-570). Under sequence
        parallelism no loader is sharded.
        """
        run = self.run_cfg
        rank, world = dist_utils.dp_rank(), dist_utils.dp_size()
        if self.rows_replicated:
            rank, world = 0, 1
        num_workers = int(run.get("num_workers", 2))

        split_datasets = {}
        for ds_name, splits in self.datasets.items():
            for split, ds in splits.items():
                split_datasets.setdefault(split, []).append(ds)

        loaders = {}
        for split, ds_list in split_datasets.items():
            is_train = split in self.train_splits or split == "train"
            bsz = int(
                run.get("batch_size_train" if is_train else "batch_size_eval", 1)
            )
            if is_train:
                sub_loaders = [
                    IterLoader(
                        DataLoader(
                            ds, batch_size=bsz, shuffle=True, drop_last=True,
                            num_workers=num_workers, rank=rank, world_size=world,
                            seed=int(run.get("seed", 42)),
                        )
                    )
                    for ds in ds_list
                ]
                if len(sub_loaders) == 1:
                    loaders[split] = sub_loaders[0]
                else:
                    ratios = run.get("train_dataset_ratios")
                    loaders[split] = MultiIterLoader(sub_loaders, ratios)
            else:
                ds = ds_list[0] if len(ds_list) == 1 else ConcatDataset(ds_list)
                loaders[split] = PrefetchLoader(
                    DataLoader(
                        ds, batch_size=bsz, shuffle=False, drop_last=False,
                        num_workers=num_workers,
                        rank=rank if self.use_dist_eval_sampler else 0,
                        world_size=world if self.use_dist_eval_sampler else 1,
                    ),
                    device=self.device,
                )
        return loaders

    @property
    def iters_per_epoch(self):
        cfg_val = self.run_cfg.get("iters_per_epoch")
        if cfg_val:
            return int(cfg_val)
        try:
            return len(self.train_loader)
        except TypeError:
            raise ValueError(
                "iters_per_epoch must be set when the train loader has no length"
            )

    # -------------------------------------------------------------- train
    def _init_tracking(self):
        tracking.init(
            project=self.run_cfg.get("wandb_project", "mr_blip_tpu"),
            name=self.run_cfg.get("wandb_name", self.job_id),
            config=self.config.to_dict(),
            out_dir=str(self.output_dir),
            enabled=bool(self.run_cfg.get("wandb", True)),
        )

    def train(self):
        start_time = time.time()
        best_agg_metric = 0
        best_epoch = 0
        cur_epoch = self.start_epoch
        self.log_config()
        self._init_tracking()

        for cur_epoch in range(self.start_epoch, self.max_epoch):
            if not self.evaluate_only:
                logging.info("Start training epoch %d", cur_epoch)
                try:
                    train_stats = self.train_epoch(cur_epoch)
                except TrainingPreempted:
                    # the state is whole-step consistent (the guard fires
                    # only at step boundaries): save it for resume and
                    # re-raise for the entry point to exit
                    self.save_preemption_checkpoint(cur_epoch)
                    raise
                self.log_stats(split_name="train", stats=train_stats)

            if len(self.valid_splits) > 0 and not self.evaluate_only:
                for split_name in self.valid_splits:
                    logging.info("Evaluating on %s.", split_name)
                    val_log = self.eval_epoch(
                        split_name=split_name, cur_epoch=cur_epoch
                    )
                    is_best = False
                    if val_log is not None and dist_utils.is_main_process():
                        tracker = tracking.get()
                        if tracker is not None:
                            tracker.log(
                                {f"eval/{k}": v for k, v in val_log.items()
                                 if isinstance(v, (int, float))}
                            )
                        assert "agg_metrics" in val_log, (
                            "No agg_metrics found in validation log."
                        )
                        agg_metrics = val_log["agg_metrics"]
                        if agg_metrics > best_agg_metric and split_name == "val":
                            best_epoch, best_agg_metric = cur_epoch, agg_metrics
                            is_best = True
                        val_log.update({"best_epoch": best_epoch})
                        self.log_stats(val_log, split_name)
                    # rank 0 decides; every rank takes part in the save
                    if dist_utils.broadcast_object(is_best):
                        self._save_checkpoint(cur_epoch, is_best=True)
            elif not self.evaluate_only:
                self._save_checkpoint(cur_epoch, is_best=False)

            if self.evaluate_only:
                break
            dist_utils.barrier()

        # final test with the best checkpoint
        test_epoch = "best" if len(self.valid_splits) > 0 else cur_epoch
        test_logs = self.evaluate(cur_epoch=test_epoch, skip_reload=self.evaluate_only)

        total_time = time.time() - start_time
        logging.info(
            "Training time %s", str(datetime.timedelta(seconds=int(total_time)))
        )
        return test_logs

    def train_epoch(self, epoch):
        loader = self.train_loader
        if hasattr(loader, "set_epoch"):
            loader.set_epoch(epoch)
        return self.task.train_epoch(
            epoch=epoch,
            model=self.model,
            data_loader=loader,
            train_ctx=self.train_ctx,
            lr_scheduler=self.lr_scheduler,
            log_freq=self.log_freq,
            accum_grad_iters=int(self.run_cfg.get("accum_grad_iters", 1)),
        )

    # ------------------------------------------------------------ evaluate
    def evaluate(self, cur_epoch="best", skip_reload=False):
        test_logs = {}
        if len(self.test_splits) > 0:
            for split_name in self.test_splits:
                test_logs[split_name] = self.eval_epoch(
                    split_name=split_name, cur_epoch=cur_epoch,
                    skip_reload=skip_reload,
                )
            return test_logs

    def eval_epoch(self, split_name, cur_epoch, skip_reload=False):
        data_loader = self.dataloaders.get(split_name)
        assert data_loader is not None, f"no loader for split {split_name}"

        if not skip_reload and cur_epoch == "best":
            self._reload_best_model()

        self.task.before_evaluation(model=self.model, dataset=None)
        results = self.task.evaluation(self.model, data_loader)
        if results is not None and (
                (self.rows_replicated and not dist_utils.is_main_process())
                or dist_utils.tp_rank() != 0):
            results = []  # the rows of another rank: keep one copy
        if results is not None:
            return self.task.after_evaluation(
                val_result=results, split_name=split_name, epoch=cur_epoch
            )

    # -------------------------------------------------------- checkpointing
    def _trainable_only(self):
        """The trainable tensors by name, on the host (the reference keeps
        only requires_grad=True, runner_base.py:572-600)."""
        mask = self.model.trainable_mask()
        return {name: p.detach().cpu()
                for name, p in self.model.module.named_parameters() if mask[name]}

    def _save_checkpoint(self, cur_epoch, is_best=False):
        """The trainable tensors (rank 0 writes) and the resume state. Every
        rank calls it."""
        self._check_replicated("checkpoint")
        if dist_utils.is_main_process():
            save_obj = {
                "model": self._trainable_only(),
                "config": self.config.to_dict(),
                "epoch": cur_epoch,
            }
            name = "checkpoint_{}.pth".format("best" if is_best else cur_epoch)
            path = os.path.join(self.output_dir, name)
            logging.info("Saving checkpoint at epoch %s to %s.", cur_epoch, path)
            _save(save_obj, path)
        self._write_resume_state(cur_epoch)

    def _check_replicated(self, what):
        """Under a process group: raise unless every rank's trainable tensors
        are bit-equal (a collective; a barrier too)."""
        if dist_utils.get_world_size() > 1:
            assert_replicated(dict(self.train_ctx.named_params),
                              f"the trainable tensors at the {what}")

    def _write_resume_state(self, cur_epoch, epoch_complete=True):
        """Full state for resume: every weight, the ``TrainCtx`` state and
        the epoch, matching the reference's model+optimizer+scaler+epoch
        resume (reference runner_base.py:622-644): dropping the AdamW state
        would re-run warmup on a resumed schedule. ``epoch_complete=False``
        (preemption mid-epoch) makes resume re-run ``cur_epoch`` instead of
        starting at ``cur_epoch + 1``. Every rank calls it (the ranks'
        partial gradients are gathered); rank 0 writes, and no rank returns
        before the file is whole."""
        resume_path = os.path.join(self.output_dir, "resume_state.pth")
        train_ctx = self.train_ctx.shared_state_dict()
        # Whole tensors at rank 0: a collective of the first tensor-parallel
        # group alone (the other groups hold the same weights).
        params = self.model.full_state_dict() if dist_utils.dp_rank() == 0 else None
        if dist_utils.is_main_process():
            resume_obj = {
                "params": params,
                "train_ctx": train_ctx,
                "epoch": cur_epoch,
                "epoch_complete": epoch_complete,
            }
            _save(resume_obj, resume_path)
        dist_utils.barrier()
        return resume_path

    def save_preemption_checkpoint(self, cur_epoch):
        """Resume state at the preemption step boundary (rank 0 writes).

        Resume semantics (epoch granularity, like the reference's
        runner_base.py:622-644 resume): the interrupted epoch RE-RUNS from
        its first batch. The LR schedule does NOT drift — lr is computed
        from (cur_epoch, inner_step) (common/optims.py), so every batch
        re-trains at the lr it would have had. What the re-run does cost:
        the first K batches' updates are applied twice (with AdamW moments
        warm from the preempted pass), and the step count keeps increasing,
        which only affects AdamW's bias correction (negligible outside the
        first ~100 steps). Exact-batch resume would need the loader's
        iterator state checkpointed too; documented trade-off. Every rank
        calls it: the guard stops them all at the same step boundary.
        """
        self._check_replicated("preemption")
        path = self._write_resume_state(cur_epoch, epoch_complete=False)
        if dist_utils.is_main_process():
            logging.warning(
                "preemption checkpoint written to %s (resume with "
                "run.resume_ckpt_path to re-run epoch %d)", path, cur_epoch,
            )
        self.finalize_checkpoints()
        return path

    def finalize_checkpoints(self):
        """Call before process exit. ``torch.save`` writes synchronously, so
        no write is pending (the JAX package drains orbax's async saves
        here)."""

    def _restore_trainable(self, saved):
        """Copy the tensors of ``saved`` whose names the model has into the
        model's tensors (in their dtype; whole tensors cut to the rank's
        shards)."""
        saved = tensor_parallel.local_state_dict(self.model.module, saved)
        params = dict(self.model.module.named_parameters())
        restored = 0
        with torch.no_grad():
            for key, val in saved.items():
                if key in params:
                    params[key].copy_(val)
                    restored += 1
        self.model.clear_bias_cache()
        logging.info("restored %d trainable tensors", restored)

    def _reload_best_model(self):
        path = os.path.join(self.output_dir, "checkpoint_best.pth")
        if not os.path.exists(path):
            logging.warning("no best checkpoint found at %s", path)
            return
        obj = torch.load(path, map_location="cpu", weights_only=True)
        self._restore_trainable(obj["model"])

    def load_checkpoint(self, path):
        """Resume: restores every weight, the ``TrainCtx`` state (AdamW
        moments and step, counters, accumulated gradients) and start_epoch
        (reference runner_base.py:622-644 restores model+optimizer+scaler+
        epoch). A trainable-only checkpoint restores its tensors. The file
        is mapped, not read: host memory never holds a second copy of the
        weights."""
        obj = torch.load(path, map_location="cpu", mmap=True, weights_only=True)
        if "params" in obj:
            if not self.evaluate_only:
                _ = self.train_ctx  # fp32 masters before the weights land
            self.model.load_state_dict(obj["params"])
        elif "model" in obj:
            self._restore_trainable(obj["model"])
        if "train_ctx" in obj and not self.evaluate_only:
            self.train_ctx.load_state_dict(obj["train_ctx"])
        # epoch_complete=False (preemption mid-epoch): re-run that epoch
        self.start_epoch = int(obj.get("epoch", -1)) + int(
            bool(obj.get("epoch_complete", True))
        )
        logging.info("Resume checkpoint loaded from %s (epoch %d)", path,
                     self.start_epoch)

    # -------------------------------------------------------------- logging
    @dist_utils.main_process
    def log_stats(self, stats, split_name):
        if isinstance(stats, dict):
            log_stats = {**{f"{split_name}_{k}": v for k, v in stats.items()}}
            with open(os.path.join(self.output_dir, "log.txt"), "a") as f:
                f.write(json.dumps(log_stats, default=float) + "\n")

    @dist_utils.main_process
    def log_config(self):
        with open(os.path.join(self.output_dir, "log.txt"), "a") as f:
            f.write(json.dumps(self.config.to_dict(), indent=4, default=str) + "\n")


def _save(obj, path):
    """``torch.save`` through a temporary file renamed over ``path``: a
    write cut short (the process killed in the grace window) leaves the
    previous file whole."""
    tmp = f"{path}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)
