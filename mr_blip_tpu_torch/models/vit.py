"""Generic pre-norm Vision Transformer (the port's counterpart of
``mr_blip_tpu/models/vit.py``).

The reference base ViT (``lavis/models/vit.py:1-527``, timm-style) of the
ALBEF/BLIP-v1 families: fused QKV with biases on q, k and v (unlike EVA's
zero k bias), an exact-GELU MLP (``quick_gelu`` for the OpenAI CLIP towers),
a learned cls token and absolute position embedding, optional ``pre_norm``
(CLIP's ``ln_pre``), a final LayerNorm (eps ``norm_eps``, 1e-6) and an
optional classification head. Stochastic depth ramps linearly over the
blocks (``drop_path_rate``), active in train mode.

Images come in channels-last, (B, H, W, C), as the JAX module takes them.
The attention goes through ``ops/attention.py::dot_product_attention`` with
the JAX dispatch rules: ViT-B/16 at 224² has 197 tokens, under the 256 of
``_FLASH_MIN_SEQ``, so it stays on the plain path in both packages.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from mr_blip_tpu_torch.models.layers import Dense, DropPath, LayerNormFP32
from mr_blip_tpu_torch.ops.attention import dot_product_attention


@dataclasses.dataclass(frozen=True)
class BaseViTConfig:
    img_size: int = 224
    patch_size: int = 16
    in_chans: int = 3
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    num_classes: int = 0
    drop_rate: float = 0.0
    # stochastic depth, linear per-block ramp (reference vit.py drop_path)
    drop_path_rate: float = 0.0
    act: str = "gelu"  # "gelu" | "quick_gelu" (OpenAI CLIP towers)
    pre_norm: bool = False  # CLIP's ln_pre before the blocks
    norm_eps: float = 1e-6  # CLIP towers use torch's 1e-5 default

    @property
    def num_patches(self) -> int:
        return (self.img_size // self.patch_size) ** 2

    @property
    def mlp_hidden_dim(self) -> int:
        return int(self.embed_dim * self.mlp_ratio)


def vit_base_config(**kw) -> BaseViTConfig:
    return BaseViTConfig(**kw)


def vit_large_config(**kw) -> BaseViTConfig:
    return BaseViTConfig(embed_dim=1024, depth=24, num_heads=16, **kw)


class _Attention(nn.Module):
    def __init__(self, cfg: BaseViTConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.qkv = Dense(cfg.embed_dim, 3 * cfg.embed_dim, device=device, dtype=dtype)
        self.proj = Dense(cfg.embed_dim, cfg.embed_dim, device=device, dtype=dtype)

    def forward(self, x):
        cfg = self.cfg
        b, n, _ = x.shape
        head_dim = cfg.embed_dim // cfg.num_heads
        qkv = self.qkv(x).reshape(b, n, 3, cfg.num_heads, head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        out = dot_product_attention(q, k, v).reshape(b, n, cfg.embed_dim)
        return self.proj(out)


class _Mlp(nn.Module):
    """fc1 -> exact GELU (or quick GELU, x·sigmoid(1.702x)) -> fc2 -> dropout."""

    def __init__(self, cfg: BaseViTConfig, device=None, dtype=None):
        super().__init__()
        if cfg.act not in ("gelu", "quick_gelu"):
            raise ValueError(f"act={cfg.act!r}: gelu or quick_gelu")
        self.act = cfg.act
        self.fc1 = Dense(cfg.embed_dim, cfg.mlp_hidden_dim, device=device, dtype=dtype)
        self.fc2 = Dense(cfg.mlp_hidden_dim, cfg.embed_dim, device=device, dtype=dtype)
        self.dropout = nn.Dropout(cfg.drop_rate)

    def forward(self, x):
        x = self.fc1(x)
        x = x * torch.sigmoid(1.702 * x) if self.act == "quick_gelu" else F.gelu(x)
        return self.dropout(self.fc2(x))


class _Block(nn.Module):
    def __init__(self, cfg: BaseViTConfig, drop_path: float, device=None, dtype=None):
        super().__init__()
        self.norm1 = LayerNormFP32(cfg.embed_dim, cfg.norm_eps, device=device)
        self.attn = _Attention(cfg, device=device, dtype=dtype)
        self.norm2 = LayerNormFP32(cfg.embed_dim, cfg.norm_eps, device=device)
        self.mlp = _Mlp(cfg, device=device, dtype=dtype)
        self.drop_path = DropPath(drop_path)

    def forward(self, x):
        x = x + self.drop_path(self.attn(self.norm1(x)))
        return x + self.drop_path(self.mlp(self.norm2(x)))


class VisionTransformer(nn.Module):
    def __init__(self, cfg: BaseViTConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = dtype or torch.get_default_dtype()
        d = cfg.embed_dim
        self.patch_embed = nn.Conv2d(cfg.in_chans, d, cfg.patch_size, stride=cfg.patch_size,
                                     device=device, dtype=torch.float32)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d, device=device))
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.num_patches + 1, d, device=device))
        if cfg.pre_norm:  # CLIP's ln_pre
            self.ln_pre = LayerNormFP32(d, cfg.norm_eps, device=device)
        self.blocks = nn.ModuleList([
            _Block(cfg, cfg.drop_path_rate * i / max(cfg.depth - 1, 1)
                   if cfg.drop_path_rate else 0.0, device=device, dtype=dtype)
            for i in range(cfg.depth)])
        self.norm = LayerNormFP32(d, cfg.norm_eps, device=device)
        if cfg.num_classes > 0:
            self.head = Dense(d, cfg.num_classes, device=device, dtype=dtype)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images: (B, H, W, C) -> (B, 1+P, D) tokens (final-normed), or
        (B, num_classes) logits when a head is configured."""
        cfg, dtype = self.cfg, self.compute_dtype
        b = images.shape[0]
        x = F.conv2d(images.permute(0, 3, 1, 2).to(dtype), self.patch_embed.weight.to(dtype),
                     self.patch_embed.bias.to(dtype), stride=cfg.patch_size)
        x = x.flatten(2).transpose(1, 2)
        cls = self.cls_token.to(dtype).expand(b, 1, cfg.embed_dim)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(dtype)
        if cfg.pre_norm:
            x = self.ln_pre(x)
        for blk in self.blocks:
            x = blk(x)
        x = self.norm(x)
        if cfg.num_classes > 0:
            return self.head(x[:, 0])
        return x
