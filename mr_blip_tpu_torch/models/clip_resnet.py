"""CLIP ModifiedResNet visual tower (the port's counterpart of
``mr_blip_tpu/models/clip_resnet.py``).

The reference's anti-aliased ResNet CLIP tower (``lavis/models/clip_models/
model.py:50-244``): a 3-conv stem with an average pool instead of a max
pool, bottleneck blocks whose strided convolutions are a stride-1 conv and
a prepended average pool (anti-aliasing), and a QKV attention pool in place
of global average pooling. It covers the RN50/RN101/RN50x4/RN50x16 OpenAI
checkpoints (``clip_models/pretrained.py:17-48``).

Images come in channels-last, (B, H, W, 3), as the JAX tower takes them;
the tower permutes them to NCHW once and runs ``F.conv2d`` there, with
torch's symmetric padding (the JAX convs pad symmetrically too) and
``F.avg_pool2d``'s valid windows (flax ``avg_pool``'s). The attention pool
computes only the mean token's query: the output at position 0 depends on
row 0 of Q alone (``model.py:123-153`` computes all rows and keeps the
first).

BatchNorm: the running statistics are buffers (``mean``, ``var``) beside the
folded affine's ``weight`` and ``bias`` (the JAX tree keeps all four as
params; ``models/convert.py`` fills the buffers from them). In eval (the
default, ``deterministic=True``) the running statistics normalize; with
``deterministic=False`` the batch's biased statistics do, and the running
ones are never updated, as in JAX (the reference's fine-tuning locks the
tower and freezes its BN statistics). ``nn.BatchNorm2d`` would update them
in train mode and keep the unbiased variance: it is not used.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mr_blip_tpu_torch.models.layers import Dense


@dataclasses.dataclass(frozen=True)
class ResNetVisionConfig:
    layers: Tuple[int, int, int, int] = (3, 4, 6, 3)
    output_dim: int = 1024
    image_size: int = 224
    width: int = 64

    @property
    def heads(self) -> int:
        # reference: vision_heads = width * 32 // 64 (model.py:457)
        return self.width * 32 // 64

    @property
    def embed_dim(self) -> int:
        return self.width * 32  # final ResNet feature dim (model.py:190)


class BatchNorm2d(nn.Module):
    """BatchNorm over NCHW with torch's eps 1e-5: fp32 statistics, the
    folded affine ``x * inv + (bias - mean * inv)``, the output in the
    compute dtype (see the module doc for the two modes)."""

    def __init__(self, features: int, dtype=None, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.compute_dtype = dtype or torch.get_default_dtype()
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))

    def forward(self, x: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        xf = x.float()
        mean, var = self.mean, self.var
        if not deterministic:
            mean = xf.mean(dim=(0, 2, 3))
            var = xf.var(dim=(0, 2, 3), unbiased=False)
        inv = self.weight / torch.sqrt(var + self.eps)
        out = xf * inv[:, None, None] + (self.bias - mean * inv)[:, None, None]
        return out.to(self.compute_dtype)


class Conv2d(nn.Module):
    """Bias-free conv with an fp32 (out, in, kh, kw) weight, computed in the
    compute dtype (inputs and weight cast at use, as flax ``nn.Conv`` with
    ``dtype`` does)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 padding: int = 0, dtype=None, device=None):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.compute_dtype = dtype or torch.get_default_dtype()
        self.weight = nn.Parameter(torch.zeros(out_ch, in_ch, kernel, kernel, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.conv2d(x.to(dt), self.weight.to(dt), None, self.stride, self.padding)


class Bottleneck(nn.Module):
    """Anti-aliased bottleneck (reference ``model.py:50-106``): every conv
    has stride 1; with ``stride > 1`` an average pool follows conv2 and
    precedes the 1x1 downsample projection."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 use_downsample: bool = False, dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        out = planes * self.expansion
        self.stride = stride
        self.conv1 = Conv2d(inplanes, planes, 1, **kw)
        self.bn1 = BatchNorm2d(planes, **kw)
        self.conv2 = Conv2d(planes, planes, 3, padding=1, **kw)
        self.bn2 = BatchNorm2d(planes, **kw)
        self.conv3 = Conv2d(planes, out, 1, **kw)
        self.bn3 = BatchNorm2d(out, **kw)
        self.use_downsample = use_downsample
        if use_downsample:
            self.ds_conv = Conv2d(inplanes, out, 1, **kw)
            self.ds_bn = BatchNorm2d(out, **kw)

    def forward(self, x: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x), deterministic))
        out = F.relu(self.bn2(self.conv2(out), deterministic))
        if self.stride > 1:
            out = F.avg_pool2d(out, self.stride, self.stride)
        out = self.bn3(self.conv3(out), deterministic)
        identity = x
        if self.use_downsample:
            if self.stride > 1:
                identity = F.avg_pool2d(identity, self.stride, self.stride)
            identity = self.ds_bn(self.ds_conv(identity), deterministic)
        return F.relu(out + identity)


class AttentionPool2d(nn.Module):
    """QKV attention pool (reference ``model.py:109-153``): the mean token
    prepended, a learned position embedding, multi-head attention whose
    output is taken at the mean token: a single-query attention."""

    def __init__(self, spacial_dim: int, embed_dim: int, num_heads: int, output_dim: int,
                 dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.pos_embed = nn.Parameter(torch.zeros(spacial_dim ** 2 + 1, embed_dim,
                                                  device=device))
        self.q_proj = Dense(embed_dim, embed_dim, **kw)
        self.k_proj = Dense(embed_dim, embed_dim, **kw)
        self.v_proj = Dense(embed_dim, embed_dim, **kw)
        self.c_proj = Dense(embed_dim, output_dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, C, H, W) -> (B, output_dim)."""
        b = x.shape[0]
        x = x.flatten(2).transpose(1, 2)  # (B, HW, C), row-major over (h, w)
        x = torch.cat([x.mean(dim=1, keepdim=True), x], dim=1)
        x = x + self.pos_embed.to(x.dtype)
        n, heads = x.shape[1], self.num_heads
        hd = self.embed_dim // heads
        q = self.q_proj(x[:, :1]).reshape(b, 1, heads, hd).transpose(1, 2)
        k = self.k_proj(x).reshape(b, n, heads, hd).transpose(1, 2)
        v = self.v_proj(x).reshape(b, n, heads, hd).transpose(1, 2)
        logits = torch.einsum("bhqd,bhkd->bhqk", q, k).float()
        attn = torch.softmax(logits * hd ** -0.5, dim=-1).to(v.dtype)
        out = torch.einsum("bhqk,bhkd->bhqd", attn, v)
        return self.c_proj(out.transpose(1, 2).reshape(b, 1, self.embed_dim))[:, 0]


class ModifiedResNet(nn.Module):
    """The whole tower (reference ``model.py:156-244``): (B, H, W, 3) images
    -> (B, output_dim) features."""

    def __init__(self, cfg: ResNetVisionConfig, dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.cfg = cfg
        self.compute_dtype = dtype or torch.get_default_dtype()
        w = cfg.width
        self.conv1 = Conv2d(3, w // 2, 3, stride=2, padding=1, **kw)
        self.bn1 = BatchNorm2d(w // 2, **kw)
        self.conv2 = Conv2d(w // 2, w // 2, 3, padding=1, **kw)
        self.bn2 = BatchNorm2d(w // 2, **kw)
        self.conv3 = Conv2d(w // 2, w, 3, padding=1, **kw)
        self.bn3 = BatchNorm2d(w, **kw)
        self.block_names = []
        inplanes = w
        for li, (planes_mult, blocks) in enumerate(zip((1, 2, 4, 8), cfg.layers)):
            planes = w * planes_mult
            for bi in range(blocks):
                s = (1 if li == 0 else 2) if bi == 0 else 1
                needs_ds = s > 1 or inplanes != planes * Bottleneck.expansion
                name = f"layer{li + 1}_block{bi}"
                self.add_module(name, Bottleneck(inplanes, planes, s, needs_ds, **kw))
                self.block_names.append(name)
                inplanes = planes * Bottleneck.expansion
        self.attnpool = AttentionPool2d(cfg.image_size // 32, cfg.embed_dim, cfg.heads,
                                        cfg.output_dim, **kw)

    def forward(self, images: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        x = images.permute(0, 3, 1, 2).to(self.compute_dtype)
        x = F.relu(self.bn1(self.conv1(x), deterministic))
        x = F.relu(self.bn2(self.conv2(x), deterministic))
        x = F.relu(self.bn3(self.conv3(x), deterministic))
        x = F.avg_pool2d(x, 2, 2)
        for name in self.block_names:
            x = getattr(self, name)(x, deterministic)
        return self.attnpool(x)
