"""EVA ViT-g/14 frame encoder, float and int8 paths (counterpart of
``mr_blip_tpu/models/eva_vit.py``).

39 pre-norm blocks, d=1408, 16 heads of 88, MLP hidden 6144, patch 14,
absolute position embeddings, fused QKV with q and v bias only (the k bias
is identically zero), erf-GELU MLP (tanh GELU with ``ViTConfig.fast_gelu``)
and no final norm: all 257 tokens are returned for the Q-Former.

Training the ViT (``freeze_vit: False``): block i drops its two residual
branches per frame with probability ``drop_path_rate * i / max(depth - 1,
1)`` (stochastic depth, ``layers.DropPath``; train mode only), and with
``use_checkpoint`` every block runs under ``layers.remat``. The weights may
be fp32 masters: every one of them, the patch conv, ``cls_token`` and
``pos_embed`` included, is cast at use to the compute dtype the ViT was
built with, so the bf16 kernels see bf16 whatever the stored dtype.

With ``ViTConfig.int8_matmul`` (inference only) every block runs on the W8A8
kernels of ``ops/int8_matmul.py``: norm1, the qkv product, the attention,
the proj product and the skip add are one ``w8a8_attn_block`` (three calls
above the packed-QKV bound, see ``ViTAttention``); norm2, the tanh-GELU MLP
and its skip add one ``w8a8_mlp``. The norms keep their
parameters at ``norm1``/``norm2`` and are computed inside the kernels (eps
1e-6). The token axis is not padded: ragged row counts are exact in the
kernels. The blocks emit bf16 whatever the compute dtype. Convert float
weights with ``models/quantize.py::quantize_vit_params``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from mr_blip_tpu_torch.models.layers import (
    Dense,
    DropPath,
    LayerNormFP32,
    Mlp,
    QDenseParams,
    remat,
)
from mr_blip_tpu_torch.ops.attention import dot_product_attention
from mr_blip_tpu_torch.ops.flash_attention import flash_attention_qkv_packed
from mr_blip_tpu_torch.ops.int8_matmul import w8a8_attn_block, w8a8_linear, w8a8_mlp

_INT8_NORM_EPS = 1e-6  # the eps of norm1/norm2, folded into the int8 kernels
# Largest packed bf16 QKV row block, n * 3 * embed_dim * 2 bytes, that the
# packed-QKV kernel and the fused int8 attention block take, as in the JAX
# package: 257 tokens (224 pixels) pass, 677 tokens (364 pixels) do not.
_PACKED_QKV_MAX_BYTES = 4 * 1024 * 1024


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    img_size: int = 224
    patch_size: int = 14
    in_chans: int = 3
    embed_dim: int = 1408
    depth: int = 39
    num_heads: int = 16
    mlp_hidden_dim: int = 6144
    # W8A8 int8 matmuls (qkv, proj, fc1, fc2) with per-token activation
    # quantization inside the kernels; the weights use the quantized layout.
    int8_matmul: bool = False
    # The float MLP's GELU as the tanh approximation (the int8 MLP's is
    # tanh whatever this says).
    fast_gelu: bool = False
    # Stochastic depth: the rate of the last block (a linear ramp from 0 at
    # block 0); sampled in train mode only.
    drop_path_rate: float = 0.0
    # Every block under gradient checkpointing.
    use_checkpoint: bool = False

    @property
    def num_patches(self) -> int:
        return (self.img_size // self.patch_size) ** 2


def eva_vit_g_config(img_size: int = 224, int8_matmul: bool = False,
                     fast_gelu: bool = False, drop_path_rate: float = 0.0,
                     use_checkpoint: bool = False) -> ViTConfig:
    return ViTConfig(img_size=img_size, int8_matmul=int8_matmul, fast_gelu=fast_gelu,
                     drop_path_rate=drop_path_rate, use_checkpoint=use_checkpoint)


def drop_path_rates(cfg: ViTConfig) -> list[float]:
    """Each block's stochastic-depth rate: ``drop_path_rate`` ramped
    linearly from 0 at the first block to the full rate at the last."""
    return [cfg.drop_path_rate * i / max(cfg.depth - 1, 1) for i in range(cfg.depth)]


def vit_tiny_config(img_size: int = 28) -> ViTConfig:
    """Tiny config for tests: 2 blocks, d=32."""
    return ViTConfig(img_size=img_size, patch_size=14, embed_dim=32, depth=2,
                     num_heads=2, mlp_hidden_dim=64)


class Int8Mlp(nn.Module):
    """Fused W8A8 tanh-GELU MLP (one ``w8a8_mlp``) with an optional fused
    pre-LayerNorm and skip add."""

    def __init__(self, in_features: int, hidden_features: int, device=None):
        super().__init__()
        self.fc1 = QDenseParams(in_features, hidden_features, device=device)
        self.fc2 = QDenseParams(hidden_features, in_features, device=device)

    def forward(self, x, norm=None, residual=None):
        d = x.shape[-1]
        if residual is not None:
            residual = residual.reshape(-1, d)
        y = w8a8_mlp(x.reshape(-1, d), *self.fc1(), *self.fc2(), norm=norm,
                     residual=residual)
        return y.reshape(x.shape)


def _packed_kernel_takes(qkv: torch.Tensor) -> bool:
    """The packed-QKV kernel runs on the card, in bf16."""
    return qkv.is_cuda and qkv.dtype == torch.bfloat16


class ViTAttention(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dim
        self.q_bias = nn.Parameter(torch.zeros(d, device=device, dtype=dtype))
        self.v_bias = nn.Parameter(torch.zeros(d, device=device, dtype=dtype))
        if cfg.int8_matmul:
            self.qkv = QDenseParams(d, 3 * d, use_bias=False, device=device)
            self.proj = QDenseParams(d, d, device=device)
        else:
            self.qkv = Dense(d, 3 * d, bias=False, device=device, dtype=dtype)
            self.proj = Dense(d, d, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor, norm=None, n_valid: int = 0) -> torch.Tensor:
        """Float: the attention of the (already normed) ``x``. int8: the whole
        block ``x + proj(attn(qkv(LN(x))))`` with ``norm`` the LayerNorm to
        fold in and keys >= ``n_valid`` masked.

        Up to ``_PACKED_QKV_MAX_BYTES`` of packed QKV per image the float path
        takes the packed-QKV kernel (bf16 on the card) and the int8 path the
        fused block. Above it (677 tokens at 364 pixels), as in the JAX
        package, the q/k/v views of the packed projection go through
        ``dot_product_attention``, between two ``w8a8_linear`` calls on the
        int8 path. The JAX int8 ViT pads 677 tokens to 680 there and so masks
        the pad keys, which sends its attention to ``xla_attention``; this
        port pads nothing, so its attention has no mask and reaches
        ``flash_attention`` on the card: the same function of the 677 real
        tokens."""
        cfg = self.cfg
        b, n, c = x.shape
        fits = n * 3 * cfg.embed_dim * 2 <= _PACKED_QKV_MAX_BYTES
        # EVA quirk: bias on q and v only; the k bias is identically zero.
        qkv_bias = torch.cat([self.q_bias, torch.zeros_like(self.q_bias),
                              self.v_bias])
        if cfg.int8_matmul:
            wq, sw, _ = self.qkv()
            wp, sp, pbias = self.proj()
            if fits:
                return w8a8_attn_block(x, wq, sw, qkv_bias.float(), wp, sp, pbias,
                                       norm=norm, num_heads=cfg.num_heads,
                                       n_valid=n_valid)
            if n_valid and n_valid != n:
                raise NotImplementedError(
                    "the split int8 attention route takes no padded tokens")
            qkv = w8a8_linear(x.reshape(b * n, c), wq, sw, qkv_bias.float(),
                              norm=norm).reshape(b, n, 3 * c)
        else:
            qkv = self.qkv(x)
            qkv = qkv + qkv_bias.to(qkv.dtype)
        if fits and _packed_kernel_takes(qkv):
            # Packed-QKV kernel: attention straight off the projection output,
            # no q/k/v split or head transpose in device memory.
            out = flash_attention_qkv_packed(qkv, cfg.num_heads)
        else:
            qkv = qkv.reshape(b, n, 3, cfg.num_heads, c // cfg.num_heads)
            out = dot_product_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
            out = out.reshape(b, n, c)
        if cfg.int8_matmul:
            return w8a8_linear(out.reshape(b * n, c), wp, sp, pbias,
                               residual=x.reshape(b * n, c)).reshape(b, n, c)
        return self.proj(out)


class ViTBlock(nn.Module):
    def __init__(self, cfg: ViTConfig, drop_path: float = 0.0, device=None, dtype=None):
        super().__init__()
        self.drop_path = DropPath(drop_path)
        self.norm1 = LayerNormFP32(cfg.embed_dim, 1e-6, device=device)
        self.attn = ViTAttention(cfg, device=device, dtype=dtype)
        self.norm2 = LayerNormFP32(cfg.embed_dim, 1e-6, device=device)
        self.int8 = cfg.int8_matmul
        if self.int8:
            self.mlp = Int8Mlp(cfg.embed_dim, cfg.mlp_hidden_dim, device=device)
        else:
            self.mlp = Mlp(cfg.embed_dim, cfg.mlp_hidden_dim, device=device,
                           dtype=dtype, approximate="tanh" if cfg.fast_gelu else "none")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.int8:
            if self.drop_path.active_rate:
                raise ValueError("the int8 ViT has no stochastic depth (drop_path); "
                                 "train an unfrozen ViT with float weights")
            # Both pre-norms fold into the kernels' quantization step and both
            # skip adds ride their epilogues; norm1/norm2 only hold the
            # parameters.
            x = self.attn(x, norm=("ln", self.norm1.weight, self.norm1.bias,
                                   _INT8_NORM_EPS))
            return self.mlp(x, norm=("ln", self.norm2.weight, self.norm2.bias,
                                     _INT8_NORM_EPS), residual=x)
        x = x + self.drop_path(self.attn(self.norm1(x)))
        return x + self.drop_path(self.mlp(self.norm2(x)))


class EvaViT(nn.Module):
    """(B, H, W, C) NHWC images -> (B, 1 + num_patches, embed_dim) tokens,
    computed in ``dtype`` (the compute dtype) whatever the weights are
    stored in."""

    def __init__(self, cfg: ViTConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = dtype or torch.get_default_dtype()
        d = cfg.embed_dim
        self.patch_embed = nn.Conv2d(cfg.in_chans, d, cfg.patch_size,
                                     stride=cfg.patch_size, device=device,
                                     dtype=dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d, device=device, dtype=dtype))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, cfg.num_patches + 1, d, device=device, dtype=dtype))
        self.blocks = nn.ModuleList(
            [ViTBlock(cfg, rate, device=device, dtype=dtype)
             for rate in drop_path_rates(cfg)])

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        dtype = self.compute_dtype
        conv = self.patch_embed
        x = F.conv2d(images.to(dtype).permute(0, 3, 1, 2), conv.weight.to(dtype),
                     conv.bias.to(dtype), stride=conv.stride)
        b = x.shape[0]
        x = x.flatten(2).transpose(1, 2)  # (B, P, D), row-major over the grid
        x = torch.cat([self.cls_token.to(dtype).expand(b, -1, -1), x], dim=1)
        x = x + self.pos_embed.to(dtype)
        checkpointed = self.cfg.use_checkpoint and torch.is_grad_enabled()
        for blk in self.blocks:
            x = remat(blk, x) if checkpointed else blk(x)
        return x
