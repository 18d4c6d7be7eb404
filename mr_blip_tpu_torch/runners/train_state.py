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
  its key, and under data parallelism from the rank too, so that the ranks
  draw different masks for their different rows (under sequence
  parallelism every rank runs the same rows and draws the same masks); a
  NaN loss raises before the update (``base_task.py`` guard).
* Data parallelism (a process group, ``torchrun``): the step is the JAX
  package's step on a dp mesh over the union of the ranks' rows. The loss
  is the mean over every target token of the global micro-batch, so each
  rank divides its token-loss sum by the token count summed over the ranks
  (not a mean of per-rank means); the gradients are summed over the ranks
  once per update, after the ``accum_grad_iters``-th backward (no
  collective on the other micro-batches' gradients), and clipped after
  that sum. ``shared_state_dict`` gathers every rank's partial window of
  gradients for a resume state.
* Tensor parallelism (``run.tp``; ``parallel/tensor.py``): the ranks of a
  tensor-parallel group run the same rows, draw the same dropout masks (the
  stream folds in the dp rank) and compute the same loss, so the loss terms
  and the gradients are summed over the dp group only. Once per update, in
  this order: the partial gradients of the replicated tensors used in
  slices (LoRA of a sharded layer) summed over the tp group, then every
  gradient summed over the dp group, then the clip. No sharded weight
  trains (only replicated tensors do; a trainable shard raises), so after
  the tp sum every gradient is whole and the plain global norm is one
  process's. The trainable tensors then stay bit-equal over the world.
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

from mr_blip_tpu_torch.common import dist as dist_utils
from mr_blip_tpu_torch.models.layers import set_dropout_generator, stream_seed
from mr_blip_tpu_torch.parallel import mesh
from mr_blip_tpu_torch.parallel import tensor as tensor_parallel


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
        sharded = [n for n, p in self.named_params.items() if hasattr(p, "tp_dim")]
        if sharded:
            raise ValueError(
                f"training a tensor-parallel shard ({sharded[0]}): only replicated "
                "tensors train under run.tp")
        self.optimizer = make_optimizer(model.module.named_parameters(),
                                        weight_decay, beta1, beta2, eps)
        self.accum_grad_iters = accum_grad_iters
        self.max_grad_norm = max_grad_norm
        self.seed = seed
        self.generator = torch.Generator(device=model.device)
        set_dropout_generator(model.module, self.generator)
        self.distributed = dist_utils.is_dist_avail_and_initialized()
        self.rank, self.world = dist_utils.get_rank(), dist_utils.get_world_size()
        self.tp_group = getattr(model, "tp_group", None)
        # The dropout stream's rank: the dp rank (the ranks of a tensor-
        # parallel group run the same rows); 0 under sequence parallelism,
        # where every rank runs the same rows.
        self.stream = (0 if getattr(model, "sequence_parallel", False)
                       else dist_utils.dp_rank())
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

    def shared_state_dict(self) -> dict:
        """``state_dict()`` for a resume state that rank 0 writes (a
        collective: every rank calls it). Under a process group the
        gradients of the current window differ between the ranks, so
        ``grads`` is replaced by ``rank_grads``, every rank's on the host in
        rank order; ``load_state_dict`` gives each rank its own back."""
        state = self.state_dict()
        if self.distributed:
            own = {n: None if g is None else g.cpu() for n, g in state.pop("grads").items()}
            state["rank_grads"] = dist_utils.all_gather_object(own)
        return state

    @torch.no_grad()
    def load_state_dict(self, state: dict):
        """Copy ``state_dict()``'s values in (any device, e.g. a file mapped
        to host memory); a trainable tensor missing from it raises. Under a
        process group each rank takes its own ``rank_grads``; the gradients
        of a one-process state go to rank 0 alone, since the update sums the
        ranks'."""
        params = state["params"]
        grads = state["grads"] if "rank_grads" not in state else None
        if grads is not None and self.distributed and self.rank:
            grads = {}
        elif grads is None:
            rank_grads = state["rank_grads"]
            if len(rank_grads) != self.world:
                raise ValueError(
                    f"the train state holds the partial gradients of "
                    f"{len(rank_grads)} ranks; resume it with as many, not {self.world}")
            grads = rank_grads[self.rank]
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
        ``accum_grad_iters``-th call also updates the weights. Returns the
        micro-batch's loss, over every rank's rows under a process group."""
        self.generator.manual_seed(stream_seed(self.seed, self.stream, self.calls))
        self.model.train()
        loss_sum, count = self.model.loss_terms(batch)
        if self.distributed:
            # this micro-batch's loss sum and target tokens over the ranks:
            # the token count divides, the sum gives the global mean
            totals = mesh.global_sum(torch.stack([loss_sum.detach().float(),
                                                  count.float()]))
            loss = loss_sum / totals[1].clamp_min(1.0)
            value = float(totals[0] / totals[1].clamp_min(1.0))
        else:
            loss = loss_sum / count.clamp_min(1.0)
            value = float(loss.detach())
        if not value == value:  # NaN guard: fail before the update
            raise FloatingPointError(
                f"NaN loss at call {self.calls} (lr={self._lr:.3g}); aborting "
                "before corrupting the optimizer state")
        (loss / self.accum_grad_iters).backward()
        self.calls += 1
        if self.calls % self.accum_grad_iters == 0:
            if self.tp_group is not None:
                tensor_parallel.reduce_partial_grads(self.params, self.tp_group)
            if self.distributed:
                mesh.all_reduce_grads(self.params)
            if self.max_grad_norm:
                # Whole gradients here (the tp sum above): one process's norm.
                clip_by_global_norm(self.params, self.max_grad_norm)
            for group in self.optimizer.param_groups:
                group["lr"] = self._lr
            self.optimizer.step()
            self.optimizer.zero_grad(set_to_none=True)
            self.updates += 1
            if self.model.trains_cached_bias():
                self.model.clear_bias_cache()
        return value
