"""Run-config validation: the canonical flag vocabulary (the port's copy of
``mr_blip_tpu/common/config_validator.py``, which the port may not import).

Counterpart of the reference ``ConfigValidator`` /
``create_runner_config_validator`` (lavis/common/config.py:168-468): every
recognized ``run:`` key with its expected type and, where applicable, the
registry-derived set of valid choices.  Unknown keys warn (the reference
validator is permissive and largely dormant); type/choice violations raise.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Callable, Optional


@dataclass
class Argument:
    name: str
    type: Optional[type] = None
    choices: Optional[Callable[[], list]] = None
    help: str = ""


class ConfigValidator:
    def __init__(self, description: str):
        self.description = description
        self.arguments: dict[str, Argument] = {}

    def add_argument(self, name, type=None, choices=None, help=""):
        self.arguments[name] = Argument(name, type, choices, help)

    def validate(self, config: dict) -> dict:
        for key, value in config.items():
            arg = self.arguments.get(key)
            if arg is None:
                logging.warning(
                    "Unknown run-config key %r (known keys: see "
                    "config_validator.py)", key,
                )
                continue
            if arg.type is not None and value is not None:
                if arg.type is float and isinstance(value, int):
                    value = float(value)
                if not isinstance(value, arg.type):
                    raise ValueError(
                        f"run.{key} expects {arg.type.__name__}, got "
                        f"{type(value).__name__} ({value!r})"
                    )
            if arg.choices is not None and value is not None:
                valid = arg.choices()
                if value not in valid:
                    raise ValueError(
                        f"run.{key}={value!r} not in valid choices {valid}"
                    )
        return config


def create_runner_config_validator() -> ConfigValidator:
    from mr_blip_tpu_torch.common.registry import registry

    v = ConfigValidator(description="Runner configurations")
    v.add_argument("runner", type=str, choices=registry.list_runners,
                   help="runner class name")
    v.add_argument("task", type=str, choices=registry.list_tasks)
    v.add_argument("lr_sched", type=str, choices=registry.list_lr_schedulers)

    # optimization
    for key in ("init_lr", "min_lr", "warmup_lr", "weight_decay",
                "lr_decay_rate", "max_grad_norm"):
        v.add_argument(key, type=float)
    for key in ("warmup_steps", "max_epoch", "max_iters",
                "iters_per_inner_epoch", "iters_per_epoch",
                "accum_grad_iters", "batch_size_train", "batch_size_eval",
                "num_workers", "seed", "log_freq", "max_len", "min_len",
                "num_beams", "tp"):
        v.add_argument(key, type=int)
    for key in ("beta1", "beta2"):
        v.add_argument(key, type=float)

    # control flow
    for key in ("evaluate", "amp", "distributed", "use_dist_eval_sampler",
                "wandb", "find_unused_parameters"):
        v.add_argument(key, type=bool)
    for key in ("train_splits", "valid_splits", "test_splits",
                "train_dataset_ratios"):
        v.add_argument(key, type=list)
    for key in ("output_dir", "resume_ckpt_path", "wandb_project",
                "wandb_name", "device", "dist_url"):
        v.add_argument(key, type=str)
    v.add_argument("dist_backend", type=str, choices=lambda: ["nccl", "gloo"],
                   help="torch.distributed backend (default: nccl on the card, "
                        "gloo for run.device=cpu)")
    v.add_argument("dist_timeout_s", type=float,
                   help="seconds a collective may wait before it raises")
    v.add_argument("world_size", type=int)
    # framework extensions beyond the reference vocabulary
    for key in ("validate_config", "use_orbax", "orbax_async", "sequence_parallel"):
        v.add_argument(key, type=bool)
    v.add_argument("tal_classes_path", type=str,
                   help="TAL class table (ANet_classes.txt)")
    for key in ("k_test", "log_samples_every_n", "preempt_sync_every"):
        v.add_argument(key, type=int)
    return v
