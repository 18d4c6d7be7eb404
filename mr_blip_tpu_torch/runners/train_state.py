"""Optimizer and train step (counterpart of ``mr_blip_tpu/runners/
train_state.py`` and ``runner_base.py::TrainCtx``).

The JAX package's semantics, in PyTorch:

* AdamW over the trainable parameters only, so frozen ones get no state
  (JAX: ``optax.multi_transform`` with ``set_to_zero``), in two groups:
  weight decay on tensors of rank >= 2, none below (``wd_mask_fn``).
* Optional global-norm clipping of the gradient (``max_grad_norm``), on
  the averaged gradient, as ``optax.clip_by_global_norm`` inside the
  accumulation.
* ``accum_grad_iters`` = k with ``optax.MultiSteps`` semantics: each call
  adds its micro-batch gradient / k, and every k-th call applies one update
  with the mean, at the lr set for that call.
* Dropout draws from a ``torch.Generator`` on the model's device, reseeded
  from (run seed, call index) at every call, as JAX folds the step into
  its key; a NaN loss raises before the update (``base_task.py`` guard).
* Trainable parameters are fp32 master weights (``BLIP2_MR.set_trainable``).
* ``state_dict`` / ``load_state_dict`` carry what a resume needs: the fp32
  masters, the AdamW moments and step, the call and update counters (the
  call index seeds the dropout stream) and the gradients accumulated so far
  in the current window (JAX: ``optax.MultiSteps``' ``acc_grads``), so that
  a resume between two micro-batches of one window takes the next step the
  uninterrupted run takes.
"""

from __future__ import annotations

import copy
from typing import Iterable, Optional

import torch

from mr_blip_tpu_torch.models.layers import set_dropout_generator


def make_optimizer(named_params: Iterable, weight_decay: float = 0.05,
                   beta1: float = 0.9, beta2: float = 0.999,
                   eps: float = 1e-8) -> torch.optim.AdamW:
    """AdamW over the parameters that require grad: decay on rank >= 2
    tensors, none on biases and norm scales. The lr is set per step."""
    decay, no_decay = [], []
    for _, p in named_params:
        if p.requires_grad:
            (decay if p.ndim >= 2 else no_decay).append(p)
    groups = [{"params": decay, "weight_decay": weight_decay},
              {"params": no_decay, "weight_decay": 0.0}]
    return torch.optim.AdamW([g for g in groups if g["params"]], lr=0.0,
                             betas=(beta1, beta2), eps=eps)


def clip_by_global_norm(params, max_norm: float):
    """``optax.clip_by_global_norm``: scale every gradient by
    max_norm / norm when the global norm exceeds ``max_norm``."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = float(torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads])))
    if norm >= max_norm:
        for g in grads:
            g.mul_(max_norm / norm)


class TrainCtx:
    """The train step of a ``BLIP2_MR`` or ``BLIP2_MR_OPT``: ``set_lr(lr)``
    then ``step(batch) -> float loss`` per micro-batch, ``batch`` from
    ``model.prepare_mr_batch(samples)``."""

    def __init__(self, model, weight_decay: float = 0.05, beta1: float = 0.9,
                 beta2: float = 0.999, eps: float = 1e-8,
                 accum_grad_iters: int = 1,
                 max_grad_norm: Optional[float] = None, seed: int = 42):
        if accum_grad_iters < 1:
            raise ValueError(f"accum_grad_iters={accum_grad_iters} < 1")
        self.model = model
        model.set_trainable()
        self.named_params = {n: p for n, p in model.module.named_parameters()
                             if p.requires_grad}
        self.params = list(self.named_params.values())
        self.optimizer = make_optimizer(model.module.named_parameters(),
                                        weight_decay, beta1, beta2, eps)
        self.accum_grad_iters = accum_grad_iters
        self.max_grad_norm = max_grad_norm
        self.seed = seed
        self.generator = torch.Generator(device=model.device)
        set_dropout_generator(model.module, self.generator)
        self.calls = 0
        self.updates = 0
        self._lr = 0.0

    def set_lr(self, lr: float):
        self._lr = float(lr)

    def state_dict(self) -> dict:
        """The trainable fp32 masters, their accumulated gradients (None
        where a window has not started), the AdamW state and the counters;
        tensors as they are (on the model's device)."""
        return {
            "params": {n: p.detach() for n, p in self.named_params.items()},
            "grads": {n: None if p.grad is None else p.grad.detach()
                      for n, p in self.named_params.items()},
            "optimizer": self.optimizer.state_dict(),
            "calls": self.calls,
            "updates": self.updates,
        }

    @torch.no_grad()
    def load_state_dict(self, state: dict):
        """Copy ``state_dict()``'s values in (any device, e.g. a file mapped
        to host memory); a trainable tensor missing from it raises."""
        params, grads = state["params"], state["grads"]
        missing = sorted(set(self.named_params) - set(params))
        if missing:
            raise KeyError(f"train state lacks {len(missing)} trainable tensors, "
                           f"e.g. {missing[:3]}")
        for name, p in self.named_params.items():
            p.copy_(params[name])
            grad = grads.get(name)
            p.grad = None if grad is None else grad.to(p.device, p.dtype, copy=True)
        # A copy: the optimizer keeps tensors already on its device and dtype
        # as they are, and must not share them with the caller's state.
        self.optimizer.load_state_dict(copy.deepcopy(state["optimizer"]))
        self.calls = int(state["calls"])
        self.updates = int(state["updates"])
        if self.model.trains_cached_bias():
            self.model.clear_bias_cache()

    @property
    def lr(self) -> float:
        return self._lr

    def step(self, batch) -> float:
        """Forward and backward of one micro-batch in train mode; every
        ``accum_grad_iters``-th call also updates the weights."""
        self.generator.manual_seed((self.seed << 32) + self.calls)
        self.model.train()
        loss = self.model.loss(batch)
        value = float(loss.detach())
        if not value == value:  # NaN guard: fail before the update
            raise FloatingPointError(
                f"NaN loss at call {self.calls} (lr={self._lr:.3g}); aborting "
                "before corrupting the optimizer state")
        (loss / self.accum_grad_iters).backward()
        self.calls += 1
        if self.calls % self.accum_grad_iters == 0:
            if self.max_grad_norm:
                clip_by_global_norm(self.params, self.max_grad_norm)
            for group in self.optimizer.param_groups:
                group["lr"] = self._lr
            self.optimizer.step()
            self.optimizer.zero_grad(set_to_none=True)
            self.updates += 1
            if self.model.trains_cached_bias():
                self.model.clear_bias_cache()
        return value
