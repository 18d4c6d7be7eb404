"""EVA ViT-g/14 frame encoder, float path (counterpart of
``mr_blip_tpu/models/eva_vit.py``).

39 pre-norm blocks, d=1408, 16 heads of 88, MLP hidden 6144, patch 14,
absolute position embeddings, fused QKV with q and v bias only (the k bias
is identically zero), erf-GELU MLP and no final norm: all 257 tokens are
returned for the Q-Former.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from mr_blip_tpu_torch.models.layers import Dense, LayerNormFP32, Mlp
from mr_blip_tpu_torch.ops.attention import dot_product_attention
from mr_blip_tpu_torch.ops.flash_attention import flash_attention_qkv_packed


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    img_size: int = 224
    patch_size: int = 14
    in_chans: int = 3
    embed_dim: int = 1408
    depth: int = 39
    num_heads: int = 16
    mlp_hidden_dim: int = 6144

    @property
    def num_patches(self) -> int:
        return (self.img_size // self.patch_size) ** 2


def eva_vit_g_config(img_size: int = 224) -> ViTConfig:
    return ViTConfig(img_size=img_size)


def vit_tiny_config(img_size: int = 28) -> ViTConfig:
    """Tiny config for tests: 2 blocks, d=32."""
    return ViTConfig(img_size=img_size, patch_size=14, embed_dim=32, depth=2,
                     num_heads=2, mlp_hidden_dim=64)


class ViTAttention(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dim
        self.q_bias = nn.Parameter(torch.zeros(d, device=device, dtype=dtype))
        self.v_bias = nn.Parameter(torch.zeros(d, device=device, dtype=dtype))
        self.qkv = Dense(d, 3 * d, bias=False, device=device, dtype=dtype)
        self.proj = Dense(d, d, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, n, c = x.shape
        qkv = self.qkv(x)
        # EVA quirk: bias on q and v only; the k bias is identically zero.
        qkv_bias = torch.cat([self.q_bias, torch.zeros_like(self.q_bias),
                              self.v_bias])
        qkv = qkv + qkv_bias.to(qkv.dtype)
        if qkv.is_cuda and qkv.dtype == torch.bfloat16:
            # Packed-QKV kernel: attention straight off the projection output,
            # no q/k/v split or head transpose in device memory.
            out = flash_attention_qkv_packed(qkv, cfg.num_heads)
        else:
            qkv = qkv.reshape(b, n, 3, cfg.num_heads, c // cfg.num_heads)
            out = dot_product_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
            out = out.reshape(b, n, c)
        return self.proj(out)


class ViTBlock(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None, dtype=None):
        super().__init__()
        self.norm1 = LayerNormFP32(cfg.embed_dim, 1e-6, device=device)
        self.attn = ViTAttention(cfg, device=device, dtype=dtype)
        self.norm2 = LayerNormFP32(cfg.embed_dim, 1e-6, device=device)
        self.mlp = Mlp(cfg.embed_dim, cfg.mlp_hidden_dim, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class EvaViT(nn.Module):
    """(B, H, W, C) NHWC images -> (B, 1 + num_patches, embed_dim) tokens."""

    def __init__(self, cfg: ViTConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dim
        self.patch_embed = nn.Conv2d(cfg.in_chans, d, cfg.patch_size,
                                     stride=cfg.patch_size, device=device,
                                     dtype=dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d, device=device, dtype=dtype))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, cfg.num_patches + 1, d, device=device, dtype=dtype))
        self.blocks = nn.ModuleList(
            [ViTBlock(cfg, device=device, dtype=dtype) for _ in range(cfg.depth)])

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        dtype = self.patch_embed.weight.dtype
        x = self.patch_embed(images.to(dtype).permute(0, 3, 1, 2))
        b = x.shape[0]
        x = x.flatten(2).transpose(1, 2)  # (B, P, D), row-major over the grid
        x = torch.cat([self.cls_token.to(dtype).expand(b, -1, -1), x], dim=1)
        x = x + self.pos_embed.to(dtype)
        for blk in self.blocks:
            x = blk(x)
        return x
