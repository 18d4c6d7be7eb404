"""Shared building blocks with an explicit precision policy (counterpart of
``mr_blip_tpu/models/layers.py``).

Policy: matmuls run in the module's compute dtype (bf16 on the card), every
weight is cast to it at use, LayerNorm and RMSNorm reduce in fp32 whatever
the input dtype, and every norm keeps fp32 parameters. Weights are built in
the compute dtype; training turns the trainable ones to fp32 master copies
(``BLIP2_MR.set_trainable``), as the JAX package keeps fp32 params.

``Dense(quantize=True)`` stores its weight as int8 with one fp32 scale per
output channel (weight-only int8: the int8 decoder of inference and the
frozen base of QLoRA-style training); ``QDenseParams`` holds the same
layout for the modules that hand it to the W8A8 kernels of
``ops/int8_matmul.py``. ``models/quantize.py`` converts float weights.

Dropout draws its keep masks from an explicit ``torch.Generator``, set on
every dropout module of a tree by ``set_dropout_generator``; it is active
in train mode only. Under tensor parallelism (``parallel/tensor.py``) a
``Dense`` holds one shard of its weight (``tp``: column or row mode) and a
dropout on a sharded activation draws the whole mask and keeps the rank's
slice (``tp_slice``), so that the masks are one process's. ``remat`` runs
a block under gradient checkpointing with those generators replayed in the
recompute.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from mr_blip_tpu_torch.ops.layer_norm import _ln_reference, fused_layer_norm
from mr_blip_tpu_torch.parallel.tensor import copy_to_tp, gather_from_tp, reduce_from_tp


class Dropout(nn.Module):
    """Inverted dropout (``flax.linen.Dropout``): keep with probability
    1 - rate and scale by 1 / (1 - rate). Identity in eval mode or at
    rate 0. ``rate`` is the attention-probability rate for the callers that
    pass it to ``dot_product_attention`` (read ``active_rate``).

    ``tp_slice`` = (dim, lo, hi, full): ``x`` is the slice ``lo:hi`` along
    ``dim`` of a tensor ``full`` wide there (a tensor-parallel shard); the
    mask is drawn over the whole tensor and sliced."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator: torch.Generator | None = None
        self.tp_slice: tuple | None = None

    @property
    def active_rate(self) -> float:
        return self.rate if self.training else 0.0

    def keep_mask(self, shape, device) -> torch.Tensor:
        """The keep mask of a tensor of ``shape`` (its ``tp_slice`` of the
        whole tensor's)."""
        if self.tp_slice is None:
            return torch.rand(shape, generator=self.generator,
                              device=device) < 1.0 - self.rate
        dim, lo, hi, full = self.tp_slice
        whole = list(shape)
        whole[dim] = full
        keep = torch.rand(whole, generator=self.generator,
                          device=device) < 1.0 - self.rate
        return keep.narrow(dim, lo, hi - lo)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        rate = self.active_rate
        if rate == 0.0:
            return x
        keep = self.keep_mask(x.shape, x.device)
        return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class DropPath(Dropout):
    """Stochastic depth (timm ``drop_path``): drops a whole residual branch
    per sample (one draw for each index of the leading axis, the flat
    ``B·T`` frame axis in the ViT) with probability ``rate``, survivors
    scaled by 1/(1-rate). Identity in eval mode or at rate 0."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        rate = self.active_rate
        if rate == 0.0:
            return x
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        keep = torch.rand(shape, generator=self.generator,
                          device=x.device) < 1.0 - rate
        return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


_MASK64 = (1 << 64) - 1


def stream_seed(*parts: int) -> int:
    """A generator seed from integer parts (splitmix64 over each), in which
    every part reaches the low 32 bits: a CPU ``torch.Generator`` seeds from
    those alone, a CUDA one from all 64."""
    x = 0
    for part in parts:
        x = (x + part + 0x9E3779B97F4A7C15) & _MASK64
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
        x ^= x >> 31
    return x


def set_dropout_generator(root: nn.Module, generator: torch.Generator | None):
    """Make every dropout module under ``root`` draw from ``generator``."""
    for module in root.modules():
        if isinstance(module, Dropout):
            module.generator = generator


def remat(module: nn.Module, *args, **kwargs):
    """``module(*args, **kwargs)`` under ``torch.utils.checkpoint`` (non-
    reentrant): its activations are dropped after the forward and recomputed
    in the backward (JAX: ``nn.remat``). ``checkpoint`` restores only the
    default CPU and CUDA generators before the recompute, so the generators
    the module's dropouts draw from are saved at entry, set back to that
    state for the recompute, and returned to where they stood after it: the
    recompute draws the forward's masks, and the gradients are those of the
    forward."""
    generators = list({id(m.generator): m.generator for m in module.modules()
                       if isinstance(m, Dropout) and m.generator is not None
                       and m.active_rate > 0.0}.values())
    saved = []

    @contextlib.contextmanager
    def forward_context():
        saved[:] = [g.get_state() for g in generators]
        yield

    @contextlib.contextmanager
    def recompute_context():
        current = [g.get_state() for g in generators]
        for g, state in zip(generators, saved):
            g.set_state(state)
        try:
            yield
        finally:
            for g, state in zip(generators, current):
                g.set_state(state)

    return checkpoint(module, *args, use_reentrant=False,
                      context_fn=lambda: (forward_context(), recompute_context()),
                      **kwargs)


def _int8_weight_buffers(module: nn.Module, in_features: int, out_features: int,
                         device):
    """``kernel_q`` int8 of shape (in, out), as in JAX, stored with the input
    axis contiguous (the layout the W8A8 kernels read), and ``kernel_scale``
    fp32 (out,). Buffers, not parameters: they never train."""
    module.register_buffer("kernel_q", torch.zeros(
        out_features, in_features, dtype=torch.int8, device=device).t())
    module.register_buffer("kernel_scale", torch.ones(out_features, device=device))


class _Int8WeightProduct(torch.autograd.Function):
    """``x @ dequantize(kernel_q, kernel_scale)`` of a frozen weight-only int8
    weight: the product of ``x`` and the int8 values accumulated in fp32,
    scaled per output channel in fp32, cast to ``x``'s dtype. The backward
    keeps the int8 weight and its scales, never an fp32 copy of the weight
    (which autograd would keep for ``x.float() @ kernel_q.float()``), and
    dequantizes when it runs; the weight gets no gradient."""

    @staticmethod
    def forward(ctx, x, kernel_q, kernel_scale):
        ctx.save_for_backward(kernel_q, kernel_scale)
        # bf16 x int8 products are exact in fp32, so the fp32 matmul is the
        # fp32-accumulated product of the compute-dtype operands.
        return ((x.float() @ kernel_q.float()) * kernel_scale).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        kernel_q, kernel_scale = ctx.saved_tensors
        grad_x = (grad.float() * kernel_scale) @ kernel_q.float().t()
        return grad_x.to(grad.dtype), None, None


class _RowProduct(torch.autograd.Function):
    """``x @ w.T`` accumulated in fp32 and returned in fp32: a row-parallel
    shard's partial product, summed over its group before the one rounding
    to the compute dtype that one process's product gets (bf16 operands on
    the card: ``torch.mm`` with ``out_dtype``). The backward in ``x``'s
    dtype, as ``F.linear``'s."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        flat = x.reshape(-1, x.shape[-1])
        if x.is_cuda and x.dtype != torch.float32:
            y = torch.mm(flat, w.t(), out_dtype=torch.float32)
        else:
            y = flat.float() @ w.float().t()
        return y.reshape(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        grad = grad.to(x.dtype)
        grad_x = grad @ w if ctx.needs_input_grad[0] else None
        grad_w = (grad.reshape(-1, grad.shape[-1]).t() @ x.reshape(-1, x.shape[-1])
                  if ctx.needs_input_grad[1] else None)
        return grad_x, grad_w


class Dense(nn.Linear):
    """``nn.Linear`` computing in ``dtype`` whatever its weights are stored
    in (bf16 frozen weights, fp32 trainable ones), with an optional LoRA
    delta.

    With ``lora_rank > 0`` the layer adds ``dropout(x) @ lora_a @ lora_b *
    (alpha / rank)`` (JAX layout: ``lora_a`` is (in, r), ``lora_b`` (r,
    out)), as the reference applies LoRA r=8, alpha=8 to every T5 Linear;
    the LoRA dropout (``lora_dropout``) acts in train mode only.

    With ``quantize`` the weight is int8 (``kernel_q`` (in, out) and
    ``kernel_scale`` (out,), no ``weight``): the product of the activations
    and the int8 values is accumulated in fp32, scaled per output channel in
    fp32, and only then cast to the compute dtype; bias and the LoRA delta
    (which stays float) follow. Under autograd the product saves only the
    int8 weight and its scales for the backward (``_Int8WeightProduct``).

    ``tp`` (``parallel/tensor.py::shard_dense``; float layers only): the
    layer holds rows ``lo:hi`` of its weight (column mode: the rank's
    output features, the bias and ``lora_b`` read in that slice; the input
    through ``copy_to_tp`` unless its module passed it already; with
    ``gather_output`` the slices all-gathered) or columns ``lo:hi`` (row
    mode: its input is the rank's slice, ``lora_a`` read in it; the partial
    products, kept in fp32, summed over the group and rounded to the compute
    dtype once, then the bias added once).
    """

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 lora_rank: int = 0, lora_alpha: float = 8.0,
                 lora_dropout: float = 0.0, quantize: bool = False,
                 device=None, dtype=None):
        if quantize:
            nn.Module.__init__(self)
            self.in_features, self.out_features = in_features, out_features
            self.compute_dtype = dtype or torch.get_default_dtype()
            _int8_weight_buffers(self, in_features, out_features, device)
            self.register_parameter("bias", nn.Parameter(torch.zeros(
                out_features, device=device, dtype=dtype)) if bias else None)
        else:
            super().__init__(in_features, out_features, bias=bias, device=device,
                             dtype=dtype)
            self.compute_dtype = self.weight.dtype
        self.quantize = quantize
        self.tp = None
        self.lora_rank = lora_rank
        self.lora_scaling = lora_alpha / lora_rank if lora_rank else 0.0
        if lora_rank:
            self.lora_a = nn.Parameter(torch.zeros(in_features, lora_rank,
                                                   device=device, dtype=dtype))
            self.lora_b = nn.Parameter(torch.zeros(lora_rank, out_features,
                                                   device=device, dtype=dtype))
            self.lora_dropout = Dropout(lora_dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cdt = self.compute_dtype
        x = x.to(cdt)
        tp = self.tp
        if tp is not None:
            return self._forward_tp(x, tp)
        if self.quantize:
            y = _Int8WeightProduct.apply(x, self.kernel_q, self.kernel_scale)
            if self.bias is not None:
                y = y + self.bias.to(cdt)
        else:
            y = F.linear(x, self.weight.to(cdt),
                         None if self.bias is None else self.bias.to(cdt))
        if self.lora_rank:
            h = self.lora_dropout(x)
            y = y + (h @ self.lora_a.to(cdt)) @ self.lora_b.to(cdt) * self.lora_scaling
        return y

    def _forward_tp(self, x: torch.Tensor, tp) -> torch.Tensor:
        cdt = self.compute_dtype
        column = tp.mode == "column"
        if column and tp.copy_input:
            x = copy_to_tp(x, tp.group)
        if column:
            bias = None if self.bias is None else self.bias[tp.lo:tp.hi].to(cdt)
            y = F.linear(x, self.weight.to(cdt), bias)
        else:
            y = _RowProduct.apply(x, self.weight.to(cdt))
        if self.lora_rank:
            a, b = self.lora_a, self.lora_b
            if column:
                b = b[:, tp.lo:tp.hi]
            else:
                a = a[tp.lo:tp.hi]
            delta = (self.lora_dropout(x) @ a.to(cdt)) @ b.to(cdt) * self.lora_scaling
            y = y + delta.to(y.dtype)
        if column:
            return gather_from_tp(y, tp.group) if tp.gather_output else y
        y = reduce_from_tp(y, tp.group).to(cdt)
        return y if self.bias is None else y + self.bias.to(cdt)


class QDenseParams(nn.Module):
    """Parameter holder in the ``Dense(quantize=True)`` layout (``kernel_q``,
    ``kernel_scale`` and an optional fp32 ``bias``) for the modules that feed
    the W8A8 kernels directly; calling it returns the three."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 device=None):
        super().__init__()
        _int8_weight_buffers(self, in_features, features, device)
        self.register_buffer(
            "bias", torch.zeros(features, device=device) if use_bias else None)

    def forward(self):
        return self.kernel_q, self.kernel_scale, self.bias


class LayerNormFP32(nn.Module):
    """LayerNorm in fp32, cast back to the input dtype.

    bf16 inputs go through ``fused_layer_norm`` (the kernel on the card);
    other dtypes take the plain version, as the JAX package routes only
    16-bit inputs to its Pallas kernel."""

    def __init__(self, features: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.bfloat16 or not x.is_cuda:
            return fused_layer_norm(x, self.weight, self.bias, self.eps)
        d = x.shape[-1]
        return _ln_reference(x.reshape(-1, d), self.weight, self.bias,
                             self.eps).reshape(x.shape)


class RMSNormFP32(nn.Module):
    """T5-style RMSNorm (no mean subtraction, no bias), fp32 accumulation."""

    def __init__(self, features: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        var = (x32 * x32).mean(dim=-1, keepdim=True)
        y = x32 * torch.reciprocal(torch.sqrt(var + self.eps))
        return (y * self.weight.float()).to(x.dtype)


class Mlp(nn.Module):
    """Two-layer GELU MLP, ViT style: exact (erf) GELU, or with
    ``approximate="tanh"`` the tanh approximation."""

    def __init__(self, in_features: int, hidden_features: int, device=None,
                 dtype=None, approximate: str = "none"):
        super().__init__()
        self.fc1 = Dense(in_features, hidden_features, device=device, dtype=dtype)
        self.fc2 = Dense(hidden_features, in_features, device=device, dtype=dtype)
        self.approximate = approximate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate=self.approximate))
