"""Pipeline parallelism: the GPipe microbatch schedule over a process group
(the port's counterpart of ``mr_blip_tpu/parallel/pipeline.py``).

In the JAX package the stages are devices of one program along a ``pp``
mesh axis and activations move by ``ppermute``; here they are processes, one
rank a stage in ``group`` (stage s is the group's rank s), as tensor
parallelism's shards are. A rank holds only its own stage's parameters.
The schedule is the same: microbatch m is on stage s at step t = m + s over
S + M - 1 steps, stage 0 reads microbatch m of the input, every other stage
receives it from its left neighbour (``send``/``recv``), and the last stage's
outputs go to every rank at the end (a broadcast: the JAX ``psum`` of the
one-hot contribution), so that the result is replicated.

Gradients go through the schedule with an explicit backward rather than
autograd's order across ranks: the forward keeps each microbatch's local
graph (its inputs made leaves), and the backward walks the microbatches in
reverse, the last stage taking its gradient from the broadcast output once
(every rank computes the same loss from the same outputs: the broadcast's
gradient is one rank's, not the sum of S), every stage sending its input
gradient to the left. Stage 0's input gradient is then broadcast (the input
is replicated, so is what computed it), and the gradients of ``extras``
(shared by every stage, such as the T5 rel-pos bias) are summed over the
group once. The stage's parameters (those of an ``nn.Module`` stage that
require grad) are inputs of the schedule's autograd node, so that their
gradients reach ``.grad`` (or ``torch.autograd.grad``) as any other
tensor's; every rank must run the backward (the same loss on every rank).

On ``gloo`` every tensor crosses through host memory (gloo's point-to-point
ops take host tensors; two ranks on one card can only use gloo, since NCCL
refuses them), bf16 and bool as their bytes; on ``nccl`` device
tensors go directly. Every send and receive is blocking; the group's timeout
(``run.dist_timeout_s``, ``common/dist.py``) bounds each.

    stage = stack_stage_params(per_stage, group)      # this rank's slice
    y = pipeline_apply(block_fn, stage, {"h": x}, group, num_microbatches=M)
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Sequence

import torch
import torch.distributed as tdist

# dtypes gloo carries as they are; the others cross as their bytes
_GLOO_DTYPES = (torch.float32, torch.float64, torch.float16, torch.int32, torch.int64,
                torch.uint8, torch.int8)


def stack_stage_params(per_stage_params: Sequence, group=None):
    """[stage_0, ..., stage_{S-1}] -> this rank's stage (the JAX version
    stacks them on a leading axis that its mesh shards; a process keeps only
    its own slice)."""
    n_stages = tdist.get_world_size(group)
    if len(per_stage_params) != n_stages:
        raise ValueError(f"{len(per_stage_params)} stages for a group of {n_stages}")
    return per_stage_params[tdist.get_rank(group)]


def sequential_reference(stage_fn: Callable, per_stage_params: Sequence, x, extras=()):
    """Ground truth: the stages back to back in one process."""
    for p in per_stage_params:
        x = stage_fn(p, x, *extras)
    return x


class _Wire:
    """Point-to-point and broadcast within ``group`` in global ranks, through
    host memory on gloo; optional timings of every transfer."""

    def __init__(self, group, timings):
        self.group = group
        self.gloo = tdist.get_backend(group) == "gloo"
        self.timings = timings

    def rank_of(self, stage: int) -> int:
        return stage if self.group is None else tdist.get_global_rank(self.group, stage)

    def _to_wire(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as gloo carries it: on the host, contiguous, and as flat
        bytes when gloo lacks its dtype (bf16, bool)."""
        wire = t.detach().cpu().contiguous()
        return wire if t.dtype in _GLOO_DTYPES else wire.view(-1).view(torch.uint8)

    @staticmethod
    def _wire_buffer(like: torch.Tensor) -> torch.Tensor:
        if like.dtype in _GLOO_DTYPES:
            return torch.empty(like.shape, dtype=like.dtype)
        return torch.empty(like.numel() * like.element_size(), dtype=torch.uint8)

    @staticmethod
    def _from_wire(buf: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        if buf.dtype != like.dtype:
            buf = buf.view(like.dtype).view(like.shape)
        return buf.to(like.device)

    def _timed(self, kind, fn, tensor, microbatch):
        if self.timings is None:
            return fn()
        if tensor.is_cuda:
            torch.cuda.synchronize(tensor.device)
        start = time.perf_counter()
        out = fn()
        if tensor.is_cuda:
            torch.cuda.synchronize(tensor.device)
        self.timings.append({"kind": kind, "microbatch": microbatch,
                             "bytes": tensor.numel() * tensor.element_size(),
                             "ms": 1e3 * (time.perf_counter() - start)})
        return out

    def send(self, t: torch.Tensor, stage: int, microbatch: int = -1):
        """Blocking send to ``stage`` (timed with the host staging)."""
        def go():
            wire = self._to_wire(t) if self.gloo else t.detach().contiguous()
            tdist.send(wire, self.rank_of(stage), group=self.group)

        self._timed("send", go, t, microbatch)

    def recv(self, like: torch.Tensor, stage: int, microbatch: int = -1) -> torch.Tensor:
        """Blocking receive from ``stage`` of a tensor shaped and typed as
        ``like``, on ``like``'s device (timed with the host staging)."""
        def go():
            if not self.gloo:
                buf = torch.empty_like(like, memory_format=torch.contiguous_format)
                tdist.recv(buf, self.rank_of(stage), group=self.group)
                return buf
            buf = self._wire_buffer(like)
            tdist.recv(buf, self.rank_of(stage), group=self.group)
            return self._from_wire(buf, like)

        return self._timed("recv", go, like, microbatch)

    def broadcast(self, t: torch.Tensor, stage: int) -> torch.Tensor:
        """Stage ``stage``'s ``t`` (every rank passes a tensor of its shape and
        dtype) on every rank."""
        if not self.gloo:
            t = t.contiguous()
            tdist.broadcast(t, self.rank_of(stage), group=self.group)
            return t
        wire = self._to_wire(t)
        tdist.broadcast(wire, self.rank_of(stage), group=self.group)
        return self._from_wire(wire, t)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the group (a float summed in fp32 on gloo, which
        has no bf16)."""
        if not self.gloo:
            tdist.all_reduce(t, group=self.group)
            return t
        wire = t.detach().cpu()
        if t.is_floating_point():
            wire = wire.float()
        tdist.all_reduce(wire, group=self.group)
        return wire.to(device=t.device, dtype=t.dtype)


def _split(leaves: List[torch.Tensor], m: int) -> List[List[torch.Tensor]]:
    """[leaf (B, ...)] -> per microbatch [leaf (B/M, ...)]."""
    chunks = [leaf.chunk(m, dim=0) for leaf in leaves]
    return [[c[i] for c in chunks] for i in range(m)]


def _leaf(t: torch.Tensor, grad: bool) -> torch.Tensor:
    t = t.detach()
    return t.requires_grad_() if grad and t.is_floating_point() else t


class _Schedule:
    """One pipelined call: the forward over every microbatch, then (under
    autograd) the backward in reverse."""

    def __init__(self, stage_fn, stage_params, keys, group, m, timings):
        self.stage_fn, self.stage_params, self.keys = stage_fn, stage_params, keys
        self.wire = _Wire(group, timings)
        self.n_stages = tdist.get_world_size(group)
        self.stage = tdist.get_rank(group)
        self.m = m

    def _call(self, leaves, extras):
        out = self.stage_fn(self.stage_params, dict(zip(self.keys, leaves)), *extras)
        if set(out) != set(self.keys):
            raise ValueError(f"a stage returned keys {sorted(out)}, not {self.keys}")
        outs = [out[k] for k in self.keys]
        for k, a, b in zip(self.keys, leaves, outs):
            if a.shape != b.shape or a.dtype != b.dtype:
                raise ValueError(f"stage output {k!r} is {tuple(b.shape)} {b.dtype}, its "
                                 f"input {tuple(a.shape)} {a.dtype}: a stage keeps them")
        return outs

    def forward(self, x_leaves, extras, record: bool):
        """Runs the schedule; returns the last stage's outputs (B, ...) on
        every rank. ``record``: keep each microbatch's graph for ``backward``."""
        s, last, wire = self.stage, self.n_stages - 1, self.wire
        micro = _split(x_leaves, self.m)
        self.graphs = []
        banked = []
        for i, mb in enumerate(micro):  # stage s runs microbatch i at step i + s
            if s == 0:
                inputs = [_leaf(t, record and t.requires_grad) for t in mb]
            else:
                inputs = [_leaf(wire.recv(t, s - 1, i), record) for t in mb]
            if record:
                with torch.enable_grad():
                    outs = self._call(inputs, extras)
                self.graphs.append((inputs, outs))
            else:
                outs = self._call(inputs, extras)
            if s < last:
                for t in outs:
                    wire.send(t, s + 1, i)
            else:
                banked.append([t.detach() for t in outs])
        if s == last:
            full = [torch.cat([b[j] for b in banked]) for j in range(len(self.keys))]
        else:
            full = [torch.empty_like(t) for t in x_leaves]
        return [wire.broadcast(t, last) for t in full]

    def backward(self, grads_out, x_leaves, extra_leaves, params):
        """Walks the microbatches in reverse; returns (input gradients,
        extras gradients, parameter gradients): the first two replicated
        over the group, the last this stage's."""
        s, last, wire = self.stage, self.n_stages - 1, self.wire
        floating = [t.is_floating_point() for t in x_leaves]
        if s == last:
            grads_out = [torch.zeros_like(t) if g is None else g
                         for g, t in zip(grads_out, x_leaves)]
            grad_micro = _split(grads_out, self.m)
        wanted = [e for e in extra_leaves if e.requires_grad] + list(params)
        sums = [None] * len(wanted)
        input_grads = [None] * self.m
        for i in reversed(range(self.m)):
            inputs, outs = self.graphs[i]
            if s == last:
                g_outs = grad_micro[i]
            else:
                g_outs = [wire.recv(o, s + 1, i) if f else None
                          for o, f in zip(outs, floating)]
            pairs = [(o, g) for o, g in zip(outs, g_outs)
                     if g is not None and o.requires_grad]
            grad_in = [t for t in inputs if t.requires_grad]
            got = torch.autograd.grad(
                [o for o, _ in pairs], grad_in + wanted,
                [g.to(o.dtype) for o, g in pairs], allow_unused=True) if pairs else (
                [None] * (len(grad_in) + len(wanted)))
            by_input = dict(zip(map(id, grad_in), got[:len(grad_in)]))
            for j, g in enumerate(got[len(grad_in):]):
                if g is not None:
                    sums[j] = g if sums[j] is None else sums[j] + g
            g_in = [None if not f else (by_input.get(id(t)) if by_input.get(id(t)) is not None
                                        else torch.zeros_like(t))
                    for t, f in zip(inputs, floating)]
            if s > 0:
                for g in g_in:
                    if g is not None:
                        wire.send(g, s - 1, i)
            else:
                input_grads[i] = g_in
        self.graphs = []
        x_grads = []
        for j, (t, f) in enumerate(zip(x_leaves, floating)):
            if not (f and t.requires_grad):
                x_grads.append(None)
                continue
            local = (torch.cat([input_grads[i][j] for i in range(self.m)]) if s == 0
                     else torch.empty_like(t))
            x_grads.append(wire.broadcast(local, 0))
        extra_grads, k = [], 0
        for e in extra_leaves:
            if not e.requires_grad:
                extra_grads.append(None)
                continue
            g = torch.zeros_like(e) if sums[k] is None else sums[k]
            extra_grads.append(wire.all_reduce(g.clone()))
            k += 1
        return x_grads, extra_grads, sums[k:]


class _PipelineFunction(torch.autograd.Function):
    """The schedule as one autograd node: its inputs are the activation
    leaves, the extras and the stage's parameters (so that the outputs
    depend on the parameters even when nothing else trains)."""

    @staticmethod
    def forward(ctx, schedule, n_x, n_extras, *tensors):
        x_leaves = list(tensors[:n_x])
        extras = tensors[n_x:n_x + n_extras]
        params = tensors[n_x + n_extras:]
        extra_leaves = [_leaf(e, e.requires_grad) for e in extras]
        outs = schedule.forward(x_leaves, extra_leaves, record=True)
        ctx.schedule, ctx.n_x = schedule, n_x
        ctx.x_meta = [t.detach() for t in x_leaves]
        ctx.extra_leaves, ctx.params = extra_leaves, params
        for t, o in zip(x_leaves, outs):
            if not t.is_floating_point():
                ctx.mark_non_differentiable(o)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads_out):
        x_meta = ctx.x_meta
        for t, need in zip(x_meta, ctx.needs_input_grad[3:3 + ctx.n_x]):
            t.requires_grad_(bool(need) and t.is_floating_point())
        x_grads, extra_grads, param_grads = ctx.schedule.backward(
            list(grads_out), x_meta, ctx.extra_leaves, ctx.params)
        return (None, None, None, *x_grads, *extra_grads, *param_grads)


def _needs_grad(params, leaves, wire) -> bool:
    """Whether any rank's stage (or the inputs) wants gradients: every rank
    must agree, or the backward's transfers would not match."""
    if not torch.is_grad_enabled():
        return False
    local = bool(params) or any(t.requires_grad for t in leaves)
    flag = torch.tensor([int(local)], device=leaves[0].device)
    return bool(wire.all_reduce(flag).item())


def pipeline_apply(stage_fn: Callable, stage_params, x: Dict[str, torch.Tensor], group=None,
                   num_microbatches: int | None = None, extras=(),
                   timings: list | None = None) -> Dict[str, torch.Tensor]:
    """Run ``stage_fn`` as a pipeline over the ranks of ``group`` (None: the
    world).

    Args:
        stage_fn: ``(stage_params, activations, *extras) -> activations`` for
            one stage; the activations keep their keys, shapes and dtypes
            from stage to stage.
        stage_params: this rank's stage (``stack_stage_params``), an
            ``nn.Module`` or anything ``stage_fn`` takes.
        x: {name: (B, ...) tensor}, the same on every rank; every leaf is
            microbatched on its leading axis and flows stage to stage
            (activations plus per-row aux such as masks or encoder states).
        num_microbatches: M; defaults to S. B must divide by M.
        extras: tensors shared by every microbatch and stage (the T5 rel-pos
            bias), passed to ``stage_fn`` as they are; their gradients are
            summed over the group.
        timings: a list that gets one entry per send and receive
            ({"kind", "microbatch", "bytes", "ms"}, with a synchronize around
            each); None times nothing.

    Returns:
        {name: (B, ...)} after all S stages, on every rank.
    """
    keys = list(x)
    leaves = [x[k] for k in keys]
    b = leaves[0].shape[0]
    if any(t.shape[0] != b for t in leaves):
        raise ValueError("inconsistent leading axes")
    n_stages = tdist.get_world_size(group)
    m = num_microbatches or n_stages
    if b % m:
        raise ValueError(f"batch {b} must divide into {m} microbatches")
    schedule = _Schedule(stage_fn, stage_params, keys, group, m, timings)
    extras = tuple(extras)
    params = ([p for p in stage_params.parameters() if p.requires_grad]
              if isinstance(stage_params, torch.nn.Module) else [])
    if _needs_grad(params, leaves + list(extras), schedule.wire):
        outs = _PipelineFunction.apply(schedule, len(leaves), len(extras), *leaves, *extras,
                                       *params)
    else:
        with torch.no_grad():
            outs = schedule.forward(leaves, extras, record=False)
    return dict(zip(keys, outs))
