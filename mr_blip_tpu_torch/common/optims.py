"""Learning-rate schedules (a copy of ``mr_blip_tpu/common/optims.py``,
which the port may not import).

Functional (epoch, step) -> lr schedules matching the reference semantics
(``lavis/common/optims.py:13-126``): step-resolution linear warmup across
epoch boundaries, then epoch-resolution cosine (or exponential-step) decay.
The caller computes the lr on the host and hands it to
``TrainCtx.set_lr`` before each step.
"""

from __future__ import annotations

import math

from mr_blip_tpu_torch.common.registry import registry


def cosine_lr(epoch, max_epoch, init_lr, min_lr):
    return (init_lr - min_lr) * 0.5 * (1.0 + math.cos(math.pi * epoch / max_epoch)) + min_lr


def warmup_lr(step, max_step, init_lr, max_lr):
    return min(max_lr, init_lr + (max_lr - init_lr) * step / max(max_step, 1))


def step_lr(epoch, init_lr, min_lr, decay_rate):
    return max(min_lr, init_lr * (decay_rate**epoch))


@registry.register_lr_scheduler("linear_warmup_cosine_lr")
class LinearWarmupCosineLRScheduler:
    """Linear warmup for ``warmup_steps`` global steps, then per-epoch cosine.

    Like the reference, the scheduler learns ``iters_per_epoch`` implicitly
    from the largest step index it sees, so warmup may span epochs.
    """

    def __init__(
        self,
        max_epoch,
        min_lr,
        init_lr,
        warmup_steps=0,
        warmup_start_lr=-1,
        **kwargs,
    ):
        self.max_epoch = max_epoch
        self.min_lr = min_lr
        self.init_lr = init_lr
        self.warmup_steps = warmup_steps
        self.warmup_start_lr = warmup_start_lr if warmup_start_lr >= 0 else init_lr
        self.max_iters_per_epoch = 0

    def __call__(self, cur_epoch, cur_step) -> float:
        if cur_step > self.max_iters_per_epoch:
            self.max_iters_per_epoch = cur_step

        global_step = cur_epoch * self.max_iters_per_epoch + cur_step
        if global_step < self.warmup_steps:
            return warmup_lr(
                step=global_step,
                max_step=self.warmup_steps,
                init_lr=self.warmup_start_lr,
                max_lr=self.init_lr,
            )
        return cosine_lr(
            epoch=cur_epoch,
            max_epoch=self.max_epoch,
            init_lr=self.init_lr,
            min_lr=self.min_lr,
        )

    step = __call__


@registry.register_lr_scheduler("linear_warmup_step_lr")
class LinearWarmupStepLRScheduler:
    """Linear warmup inside epoch 0, then exponential decay per epoch."""

    def __init__(
        self,
        max_epoch,
        min_lr,
        init_lr,
        decay_rate=1,
        warmup_start_lr=-1,
        warmup_steps=0,
        **kwargs,
    ):
        self.max_epoch = max_epoch
        self.min_lr = min_lr
        self.decay_rate = decay_rate
        self.init_lr = init_lr
        self.warmup_steps = warmup_steps
        self.warmup_start_lr = warmup_start_lr if warmup_start_lr >= 0 else init_lr

    def __call__(self, cur_epoch, cur_step) -> float:
        if cur_epoch == 0:
            return warmup_lr(
                step=cur_step,
                max_step=self.warmup_steps,
                init_lr=self.warmup_start_lr,
                max_lr=self.init_lr,
            )
        return step_lr(
            epoch=cur_epoch,
            init_lr=self.init_lr,
            min_lr=self.min_lr,
            decay_rate=self.decay_rate,
        )

    step = __call__


@registry.register_lr_scheduler("constant_lr")
class ConstantLRScheduler:
    def __init__(self, init_lr, **kwargs):
        self.init_lr = init_lr

    def __call__(self, cur_epoch, cur_step) -> float:
        return self.init_lr

    step = __call__


# The schedulers by their config names (``run.lr_sched``).
LR_SCHEDULERS = {
    "linear_warmup_cosine_lr": LinearWarmupCosineLRScheduler,
    "linear_warmup_step_lr": LinearWarmupStepLRScheduler,
    "constant_lr": ConstantLRScheduler,
}
