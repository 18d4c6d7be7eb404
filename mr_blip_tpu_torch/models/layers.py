"""Shared building blocks with an explicit precision policy (counterpart of
``mr_blip_tpu/models/layers.py``).

Policy: matmuls run in the module's compute dtype (bf16 on the card),
LayerNorm and RMSNorm reduce in fp32 whatever the input dtype, and every
norm keeps fp32 parameters.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mr_blip_tpu_torch.ops.layer_norm import _ln_reference, fused_layer_norm


class Dense(nn.Linear):
    """``nn.Linear`` computing in its weight's dtype, with an optional LoRA
    delta. The weight is stored in the compute dtype (bf16 on the card), so
    the JAX package's cast of fp32 params at every use is done once, at load.

    With ``lora_rank > 0`` the layer adds ``x @ lora_a @ lora_b *
    (alpha / rank)`` (JAX layout: ``lora_a`` is (in, r), ``lora_b`` (r, out)),
    as the reference applies LoRA r=8, alpha=8 to every T5 Linear.
    Inference only: LoRA dropout is not applied.
    """

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 lora_rank: int = 0, lora_alpha: float = 8.0,
                 device=None, dtype=None):
        super().__init__(in_features, out_features, bias=bias, device=device,
                         dtype=dtype)
        self.lora_rank = lora_rank
        self.lora_scaling = lora_alpha / lora_rank if lora_rank else 0.0
        if lora_rank:
            self.lora_a = nn.Parameter(torch.zeros(in_features, lora_rank,
                                                   device=device, dtype=dtype))
            self.lora_b = nn.Parameter(torch.zeros(lora_rank, out_features,
                                                   device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.weight.dtype)
        y = F.linear(x, self.weight, self.bias)
        if self.lora_rank:
            y = y + (x @ self.lora_a) @ self.lora_b * self.lora_scaling
        return y


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
    """Two-layer exact (erf) GELU MLP, ViT style."""

    def __init__(self, in_features: int, hidden_features: int, device=None,
                 dtype=None):
        super().__init__()
        self.fc1 = Dense(in_features, hidden_features, device=device, dtype=dtype)
        self.fc2 = Dense(hidden_features, in_features, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))
