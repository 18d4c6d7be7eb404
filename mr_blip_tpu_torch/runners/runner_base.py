"""RunnerBase, the evaluation half (the port's counterpart of
``mr_blip_tpu/runners/runner_base.py``, reference
``lavis/runners/runner_base.py:38-658``).

Construction (the output and result directories, registered as paths),
per-split loaders (``create_loaders``), ``evaluate`` over the test splits,
``eval_epoch`` and ``log_stats``. The epoch loop, checkpoints, resume and
preemption are not ported yet (ROADMAP Queue 1 item 1), so a reload of the
best checkpoint raises; ``evaluate(skip_reload=True)``, what the evaluation
entry point calls, needs none. One process, no mesh: evaluation loaders
copy their frames to ``run.device`` one batch ahead (``PrefetchLoader``).
"""

from __future__ import annotations

import json
import os
from pathlib import Path

from mr_blip_tpu_torch.common import dist as dist_utils
from mr_blip_tpu_torch.common.registry import registry
from mr_blip_tpu_torch.datasets.base_dataset import ConcatDataset
from mr_blip_tpu_torch.datasets.loader import (
    DataLoader,
    IterLoader,
    MultiIterLoader,
    PrefetchLoader,
)


@registry.register_runner("runner_base")
class RunnerBase:
    def __init__(self, cfg, task, model, datasets, job_id):
        self.config = cfg
        self.job_id = job_id
        self.task = task
        self.datasets = datasets
        self.model = model

        self._dataloaders = None

        self.setup_output_dir()

    # ----------------------------------------------------------- properties
    @property
    def run_cfg(self):
        return self.config.run_cfg

    @property
    def device(self):
        return self.run_cfg.get("device", "cuda")

    @property
    def use_dist_eval_sampler(self):
        return self.run_cfg.get("use_dist_eval_sampler", True)

    @property
    def test_splits(self):
        return self.run_cfg.get("test_splits", [])

    @property
    def train_splits(self):
        return self.run_cfg.get("train_splits", [])

    @property
    def dataloaders(self):
        if self._dataloaders is None:
            self._dataloaders = self.create_loaders()
        return self._dataloaders

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
        DistributedSampler (runner_base.py:176-277,491-570).
        """
        run = self.run_cfg
        rank, world = dist_utils.get_rank(), dist_utils.get_world_size()
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
        if results is not None:
            return self.task.after_evaluation(
                val_result=results, split_name=split_name, epoch=cur_epoch
            )

    def _reload_best_model(self):
        raise NotImplementedError(
            "reloading the best checkpoint needs the runner's checkpoints, which "
            "are not ported yet (ROADMAP Queue 1 item 1): evaluate with "
            "skip_reload=True")

    # -------------------------------------------------------------- logging
    @dist_utils.main_process
    def log_stats(self, stats, split_name):
        if isinstance(stats, dict):
            log_stats = {**{f"{split_name}_{k}": v for k, v in stats.items()}}
            with open(os.path.join(self.output_dir, "log.txt"), "a") as f:
                f.write(json.dumps(log_stats, default=float) + "\n")
