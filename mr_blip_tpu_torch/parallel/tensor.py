"""Tensor parallelism over ``torch.distributed`` (the port's counterpart of
``mr_blip_tpu/parallel/sharding_rules.py``).

The JAX package shards parameters by path and lets GSPMD place the
collectives. The port applies the same rules to its modules by name and
places the Megatron collectives itself:

* **Column-parallel** (the output features sharded): ``q``, ``k``, ``v``,
  ``wi``, ``wi_0``, ``wi_1``, ``lm_head``, ``q_proj``, ``k_proj``,
  ``v_proj``, ``fc1``. A rank holds rows ``lo:hi`` of the (out, in) weight
  and computes its slice of the output; before such a group the input
  passes :func:`copy_to_tp` (identity forward, all-reduce backward). The
  LM head all-gathers its slices (:func:`gather_from_tp`: the backward
  takes the rank's slice of the gradient, not a sum, since every rank
  computes the same loss).
* **Row-parallel** (the input features sharded): ``o``, ``wo``,
  ``out_proj``, ``fc2``. A rank holds columns ``lo:hi`` and its partial
  product is summed over the group (:func:`reduce_from_tp`: all-reduce
  forward, identity backward); the bias is added once, after the sum.
* **Replicated**: everything else (the ViT, the Q-Former, ``t5_proj`` and
  ``opt_proj``, the norms, the embeddings, the tied heads and every LoRA
  tensor). The JAX rules also match the ViT MLP's ``fc1`` / ``fc2`` by
  name; the port keeps the frozen ViT whole on its fused kernels.

A dimension that does not divide ``tp`` stays whole, as ``shard_params``
keeps it; in the port a block whose weights stay whole runs whole on every
rank. Attention is sharded by heads (``num_heads`` must divide), its KV
caches hold the rank's heads and the rel-pos bias is the rank's columns of
the table. int8 weights (``kernel_q``, which the rules do not match) stay
whole. The activations' and gradients' collectives run on fp32 buffers.

Replicated tensors that a rank uses only in slices (the LoRA ``lora_a`` /
``lora_b`` of a sharded layer, the bias of a column-parallel layer, the
rel-pos table of a sharded stack) get a partial gradient on each rank:
``tp_partial`` marks them and :func:`reduce_partial_grads` sums their
gradients over the group before the data-parallel all-reduce. A sharded
weight carries ``tp_dim``, the dimension of the (out, in) layout it is cut
along; :func:`full_state_dict` gathers such tensors whole to the group's
rank 0 (checkpoints hold whole tensors) and :func:`local_state_dict` cuts
whole tensors to a rank's shards, so a checkpoint loads under any ``tp``. Dropout on a sharded
activation draws the mask one process would draw over the whole tensor
and keeps the rank's slice (``layers.Dropout.tp_slice``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable

import torch
import torch.distributed as tdist
from torch import nn

@dataclasses.dataclass
class TPShard:
    """A ``Dense``'s place in its tensor-parallel group: ``mode`` "column"
    or "row" and the rank's slice ``lo:hi`` of the sharded dimension. ``copy_input``: the column layer passes its input
    through :func:`copy_to_tp` itself (False where its module does it once
    for a group of layers); ``gather_output``: the column layer returns the
    whole output."""

    mode: str
    group: Any
    lo: int
    hi: int
    copy_input: bool = True
    gather_output: bool = False


def _size_rank(group):
    return tdist.get_world_size(group), tdist.get_rank(group)


def shard_range(full: int, group) -> tuple[int, int]:
    """The rank's slice of a dimension of ``full`` (which ``tp`` divides)."""
    size, rank = _size_rank(group)
    step = full // size
    return rank * step, (rank + 1) * step


class _CopyToTP(torch.autograd.Function):
    """Identity forward; the gradient summed over the group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        total = grad.to(torch.float32, copy=True)
        tdist.all_reduce(total, group=ctx.group)
        return total.to(grad.dtype), None


class _ReduceFromTP(torch.autograd.Function):
    """The partial products summed over the group forward (in fp32, cast
    back once); identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        total = x.to(torch.float32, copy=True)
        tdist.all_reduce(total, group=group)
        return total.to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromTP(torch.autograd.Function):
    """Every rank's slice of the last axis, concatenated in rank order
    forward; the rank's slice of the gradient backward."""

    @staticmethod
    def forward(ctx, x, group):
        size, rank = _size_rank(group)
        part = x.to(torch.float32).contiguous()
        parts = [torch.empty_like(part) for _ in range(size)]
        tdist.all_gather(parts, part, group=group)
        width = x.shape[-1]
        ctx.bounds = (rank * width, (rank + 1) * width)
        return torch.cat(parts, dim=-1).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        lo, hi = ctx.bounds
        return grad[..., lo:hi].contiguous(), None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFromTP.apply(x, group)


def gather_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _GatherFromTP.apply(x, group)


# ------------------------------------------------------------------ sharding
def _mark_partial(*params):
    for p in params:
        if p is not None:
            p.tp_partial = True


def _cut(param: nn.Parameter, dim: int, lo: int, hi: int) -> nn.Parameter:
    part = nn.Parameter(param.detach().narrow(dim, lo, hi - lo).contiguous(),
                        requires_grad=param.requires_grad)
    part.tp_dim = dim
    return part


def shard_dense(dense, mode: str, group, copy_input: bool = True,
                gather_output: bool = False) -> bool:
    """Keep only the rank's shard of a float ``layers.Dense`` (``mode``
    "column" or "row"); False, and the layer left whole, for an int8 layer
    or a dimension ``tp`` does not divide."""
    size, _ = _size_rank(group)
    full = dense.out_features if mode == "column" else dense.in_features
    if dense.quantize or full % size:
        return False
    lo, hi = shard_range(full, group)
    dim = 0 if mode == "column" else 1
    dense.weight = _cut(dense.weight, dim, lo, hi)
    dense.tp = TPShard(mode, group, lo, hi, copy_input, gather_output)
    if mode == "column":
        _mark_partial(dense.bias)
    if dense.lora_rank:
        _mark_partial(dense.lora_a, dense.lora_b)
        if mode == "row":
            dense.lora_dropout.tp_slice = (-1, lo, hi, full)
    return True


def _float_dense(*denses) -> bool:
    return all(d is not None and not getattr(d, "quantize", True) for d in denses)


def _shard_t5(t5, group) -> None:
    from mr_blip_tpu_torch.models.t5 import T5Attention, T5FeedForward

    cfg = t5.cfg
    size, _ = _size_rank(group)
    for stack in (t5.encoder, t5.decoder):
        for module in stack.modules():
            if isinstance(module, T5Attention):
                if (not module.w8a8 and cfg.num_heads % size == 0
                        and _float_dense(module.q, module.k, module.v, module.o)):
                    for name in ("q", "k", "v"):
                        shard_dense(getattr(module, name), "column", group,
                                    copy_input=False)
                    shard_dense(module.o, "row", group)
                    lo, hi = shard_range(cfg.num_heads, group)
                    module.set_heads(group, lo, hi)
            elif isinstance(module, T5FeedForward):
                ins = ([module.wi_0, module.wi_1] if cfg.is_gated_act
                       else [getattr(module, "wi", None)])
                if cfg.d_ff % size == 0 and _float_dense(*ins, module.wo):
                    for dense in ins:
                        shard_dense(dense, "column", group, copy_input=False)
                    shard_dense(module.wo, "row", group)
                    module.tp_group = group
                    module.dropout.tp_slice = (-1, *shard_range(cfg.d_ff, group),
                                               cfg.d_ff)
        first = stack.block[0].self_attention
        if first.tp_group is not None:
            stack.rel_bias.heads = (first.head_lo, first.head_hi)
            _mark_partial(stack.rel_bias.rel_embedding)
    head = getattr(t5, "lm_head", None)
    if head is not None and _float_dense(head):
        shard_dense(head, "column", group, gather_output=True)


def _shard_opt(opt, group) -> None:
    cfg = opt.cfg
    size, _ = _size_rank(group)
    for layer in opt.layers:
        attn = layer.self_attn
        if (cfg.num_heads % size == 0 and cfg.hidden_size % size == 0
                and _float_dense(attn.q_proj, attn.k_proj, attn.v_proj, attn.out_proj)):
            for name in ("q_proj", "k_proj", "v_proj"):
                shard_dense(getattr(attn, name), "column", group, copy_input=False)
            shard_dense(attn.out_proj, "row", group)
            attn.set_heads(group, *shard_range(cfg.num_heads, group))
        if cfg.ffn_dim % size == 0 and _float_dense(layer.fc1, layer.fc2):
            shard_dense(layer.fc1, "column", group)
            shard_dense(layer.fc2, "row", group)


def shard_module(module: nn.Module, group) -> Dict[str, str]:
    """Shard every T5 and OPT language model under ``module`` over the
    tensor-parallel ``group`` in place, by the rules of the module doc;
    returns :func:`describe_sharding`. Call once, after the weights are
    loaded and the int8 conversions made."""
    from mr_blip_tpu_torch.models.opt import OPTForCausalLM
    from mr_blip_tpu_torch.models.t5 import T5ForConditionalGeneration

    if any(getattr(m, "tp", None) is not None for m in module.modules()):
        raise RuntimeError("the module is already sharded")
    for sub in list(module.modules()):
        if isinstance(sub, T5ForConditionalGeneration):
            _shard_t5(sub, group)
        elif isinstance(sub, OPTForCausalLM):
            _shard_opt(sub, group)
    return describe_sharding(module)


def describe_sharding(module: nn.Module) -> Dict[str, str]:
    """{parameter name: "column" | "row" | "partial"} of the sharded
    weights and the replicated tensors used in slices, for logs."""
    out = {}
    for name, p in module.named_parameters():
        if hasattr(p, "tp_dim"):
            out[name] = "column" if p.tp_dim == 0 else "row"
        elif getattr(p, "tp_partial", False):
            out[name] = "partial"
    return out


# ------------------------------------------------------------ gradients
def reduce_partial_grads(params: Iterable[torch.Tensor], group) -> None:
    """Sum the gradients of the ``tp_partial`` tensors among ``params``
    over ``group``, in place, in one flat fp32 all-reduce."""
    grads = [p.grad for p in params
             if getattr(p, "tp_partial", False) and p.grad is not None]
    if group is None or not grads:
        return
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    tdist.all_reduce(flat, group=group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


# ----------------------------------------------------------- checkpoints
def _sharded(module: nn.Module):
    group = None
    for m in module.modules():
        tp = getattr(m, "tp", None)
        if tp is not None:
            group = tp.group
            break
    return group, {n: p for n, p in module.named_parameters() if hasattr(p, "tp_dim")}


def full_state_dict(module: nn.Module):
    """``module.state_dict()`` with every sharded weight whole, on the host,
    at the group's rank 0; ``None`` on its other ranks. A collective of the
    group: the shards are gathered to rank 0 one tensor at a time, as their
    stored bytes, so no rank holds more than one whole tensor on its card."""
    state = module.state_dict()
    group, sharded = _sharded(module)
    if not sharded:
        return state
    size, rank = _size_rank(group)
    dst = tdist.get_global_rank(group, 0)
    for name, p in sharded.items():
        part = p.detach().contiguous().view(torch.uint8)  # (out, in * itemsize)
        parts = [torch.empty_like(part) for _ in range(size)] if rank == 0 else None
        tdist.gather(part, parts, dst=dst, group=group)
        if rank == 0:
            state[name] = torch.cat(parts, dim=p.tp_dim).view(p.dtype).cpu()
    return state if rank == 0 else None


def local_state_dict(module: nn.Module, state_dict) -> Dict[str, torch.Tensor]:
    """``state_dict`` (whole tensors, e.g. a checkpoint) with the tensors of
    ``module``'s sharded weights cut to the rank's shards; a tensor that is
    already a shard's size is taken as it is."""
    group, sharded = _sharded(module)
    if not sharded:
        return state_dict
    out = dict(state_dict)
    for name, p in sharded.items():
        if name in out and out[name].shape != p.shape:
            full = out[name]
            lo, hi = shard_range(full.shape[p.tp_dim], group)
            out[name] = full.narrow(p.tp_dim, lo, hi - lo)
    return out
