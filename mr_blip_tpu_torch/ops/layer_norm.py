"""LayerNorm with fp32 statistics (counterpart of ``mr_blip_tpu/ops/layer_norm.py``).

``fused_layer_norm`` is the wrapper: a CPU tensor takes the plain version
``_ln_reference``; a CUDA tensor launches the hand-written kernel
``csrc/layer_norm.cu`` (bf16 in and out, fp32 weight and bias) or raises.
``_ln_plan`` names the kernel by width and alignment: the register-resident
kernels of the widths 1,408 and 768, the generic 16-byte kernel, the scalar
kernel.
When a gradient is needed the launch goes through ``_FusedLayerNorm``, whose
backward is the plain version recomputed, as the JAX custom VJP's is.
"""

from __future__ import annotations

import torch

from mr_blip_tpu_torch.ops import _cuda


def _ln_reference(x2d: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """fp32 two-pass mean and centred variance, output in the input dtype."""
    x = x2d.float()
    mu = x.mean(dim=-1, keepdim=True)
    xc = x - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    y = y * weight.float() + bias.float()
    return y.to(x2d.dtype)


# C kernel ids of csrc/layer_norm.cu.
_LN_KERNELS = {"row1408": 0, "row768": 1, "vec8": 2, "scalar": 3}


def _ln_plan(d: int, x_ptr: int, out_ptr: int, weight_ptr: int, bias_ptr: int) -> str:
    """The kernel for a row width and the tensors' addresses: the register
    kernel of the width when everything is 16-byte aligned, the generic
    16-byte kernel for other widths that are a multiple of 8 with aligned
    rows, the scalar kernel otherwise."""
    rows_aligned = x_ptr % 16 == 0 and out_ptr % 16 == 0
    params_aligned = weight_ptr % 16 == 0 and bias_ptr % 16 == 0
    if f"row{d}" in _LN_KERNELS and rows_aligned and params_aligned:
        return f"row{d}"
    if d % 8 == 0 and rows_aligned:
        return "vec8"
    return "scalar"


def _layer_norm_cuda(x2d, weight, bias, eps):
    """The kernel launcher: checks, allocates, launches, counts."""
    rows, d = x2d.shape
    if x2d.dtype != torch.bfloat16:
        raise TypeError(f"layer_norm kernel takes bfloat16, got {x2d.dtype}")
    for name, t in (("weight", weight), ("bias", bias)):
        if t.dtype != torch.float32 or t.shape != (d,) or not t.is_contiguous():
            raise ValueError(f"layer_norm kernel: {name} must be contiguous "
                             f"float32 of shape ({d},), got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != x2d.device:
            raise ValueError(f"layer_norm kernel: {name} on {t.device}, "
                             f"x on {x2d.device}")
    if not x2d.is_contiguous():
        raise ValueError("layer_norm kernel needs a contiguous input")
    out = torch.empty_like(x2d)
    if rows == 0:
        return out
    kernel = _ln_plan(d, x2d.data_ptr(), out.data_ptr(), weight.data_ptr(),
                      bias.data_ptr())
    lib = _cuda.library()
    err = lib.mrb_layer_norm_bf16(
        x2d.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
        rows, d, float(eps), _LN_KERNELS[kernel], _cuda.stream_ptr(x2d.device))
    _cuda.check(err, "mrb_layer_norm_bf16")
    fused_layer_norm.launches += 1
    return out


class _FusedLayerNorm(torch.autograd.Function):
    """Forward through ``launch`` (the kernel launcher; tests pass a CPU
    stand-in), backward through the plain version recomputed."""

    @staticmethod
    def forward(ctx, x2d, weight, bias, eps, launch):
        ctx.save_for_backward(x2d, weight, bias)
        ctx.eps = eps
        return launch(x2d, weight, bias, eps)

    @staticmethod
    def backward(ctx, grad):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            y = _ln_reference(*inputs, ctx.eps)
        grads = torch.autograd.grad(y, inputs, grad)
        return (*grads, None, None)


def fused_layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis with fp32 statistics."""
    d = x.shape[-1]
    x2d = x.reshape(-1, d)
    if not x.is_cuda:
        return _ln_reference(x2d, weight, bias, eps).reshape(x.shape)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, weight, bias)):
        out = _FusedLayerNorm.apply(x2d, weight, bias, eps, _layer_norm_cuda)
    else:
        out = _layer_norm_cuda(x2d, weight, bias, eps)
    return out.reshape(x.shape)


fused_layer_norm.launches = 0
