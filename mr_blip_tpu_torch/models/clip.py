"""CLIP dual encoder (the port's counterpart of ``mr_blip_tpu/models/clip.py``).

The reference CLIP family (``lavis/models/clip_models/model.py:1-1254``): a
visual tower (the pre-norm ViT of ``models/vit.py``, or the anti-aliased
``ModifiedResNet`` of ``models/clip_resnet.py``) and a causal text
transformer, projection heads to a shared embedding space, a learned logit
scale, and the symmetric contrastive (InfoNCE) objective. Across processes
the features are gathered with ``all_gather_features`` before the loss (the
reference's ``all_gather_with_grad``, base_model.py:203-240).

The module computes in ``dtype`` (bf16 by default, as the JAX module): every
``LayerNormFP32`` then takes kernel 1 on the card, and the ViT's mask-free
attention takes kernel 4 from 256 tokens on (ViT-L/14's 257, ViT-L/14-336's
577). The causal text attention has a mask and stays plain, as in JAX. The
zoo wrapper (``zoo_wrappers.ClipModel``) runs it in fp32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mr_blip_tpu_torch.common.registry import registry
from mr_blip_tpu_torch.models.clip_resnet import ModifiedResNet, ResNetVisionConfig
from mr_blip_tpu_torch.models.layers import Dense, LayerNormFP32, Mlp
from mr_blip_tpu_torch.models.vit import BaseViTConfig, VisionTransformer
from mr_blip_tpu_torch.ops.attention import dot_product_attention


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    embed_dim: int = 512
    vision: BaseViTConfig = dataclasses.field(
        default_factory=lambda: BaseViTConfig(
            img_size=224, patch_size=16, embed_dim=768, depth=12, num_heads=12,
            pre_norm=True, norm_eps=1e-5,
        )
    )
    # When set, the visual tower is the anti-aliased ModifiedResNet
    # (reference model.py:456-464 chooses it when vision layers is a tuple)
    # and ``vision`` is ignored; the tower projects to embed_dim itself.
    resnet: Optional[ResNetVisionConfig] = None
    vocab_size: int = 49408
    context_length: int = 77
    text_width: int = 512
    text_heads: int = 8
    text_layers: int = 12
    quick_gelu: bool = False  # OpenAI-checkpoint nonlinearity (both towers)
    norm_eps: float = 1e-5  # torch nn.LayerNorm default (reference model.py)


# OpenCLIP model zoo: geometry of the reference's JSON configs
# (lavis/configs/models/clip/*.json; ViT vision heads = width // head_width).
CLIP_MODEL_ZOO = {
    # name: (embed, img, patch, v_width, v_layers, v_head_width, v_mlp_ratio,
    #        t_width, t_heads, t_layers, quick_gelu)
    "ViT-B-32":           (512, 224, 32, 768, 12, 64, 4.0, 512, 8, 12, False),
    "ViT-B-32-quickgelu": (512, 224, 32, 768, 12, 64, 4.0, 512, 8, 12, True),
    "ViT-B-16":           (512, 224, 16, 768, 12, 64, 4.0, 512, 8, 12, False),
    "ViT-B-16-plus-240":  (640, 240, 16, 896, 12, 64, 4.0, 640, 10, 12, False),
    "ViT-L-14":           (768, 224, 14, 1024, 24, 64, 4.0, 768, 12, 12, False),
    "ViT-L-14-336":       (768, 336, 14, 1024, 24, 64, 4.0, 768, 12, 12, False),
    "ViT-H-14":           (1024, 224, 14, 1280, 32, 80, 4.0, 1024, 16, 24, False),
    "ViT-g-14":           (1024, 224, 14, 1408, 40, 88, 4.3637, 1024, 16, 24, False),
}

# ResNet tower zoo (reference configs/models/clip/RN*.json):
# name: (embed, img, width, layers, t_width, t_heads, t_layers, quick_gelu)
CLIP_RESNET_ZOO = {
    "RN50":            (1024, 224, 64, (3, 4, 6, 3), 512, 8, 12, False),
    "RN50-quickgelu":  (1024, 224, 64, (3, 4, 6, 3), 512, 8, 12, True),
    "RN101":           (512, 224, 64, (3, 4, 23, 3), 512, 8, 12, False),
    "RN101-quickgelu": (512, 224, 64, (3, 4, 23, 3), 512, 8, 12, True),
    "RN50x4":          (640, 288, 80, (4, 6, 10, 6), 640, 10, 12, False),
    "RN50x16":         (768, 384, 96, (6, 8, 18, 8), 768, 12, 12, False),
}


def clip_config_from_name(name: str) -> CLIPConfig:
    """CLIPConfig for an OpenCLIP zoo name (``CLIP_MODEL_ZOO`` /
    ``CLIP_RESNET_ZOO``)."""
    if name in CLIP_RESNET_ZOO:
        embed, img, w, layers, tw, th, tl, qg = CLIP_RESNET_ZOO[name]
        return CLIPConfig(
            embed_dim=embed,
            resnet=ResNetVisionConfig(layers=layers, output_dim=embed, image_size=img,
                                      width=w),
            text_width=tw, text_heads=th, text_layers=tl, quick_gelu=qg,
        )
    embed, img, patch, vw, vl, vhw, vmr, tw, th, tl, qg = CLIP_MODEL_ZOO[name]
    return CLIPConfig(
        embed_dim=embed,
        vision=BaseViTConfig(
            img_size=img, patch_size=patch, embed_dim=vw, depth=vl,
            num_heads=vw // vhw, mlp_ratio=vmr,
            act="quick_gelu" if qg else "gelu",
            pre_norm=True, norm_eps=1e-5,  # CLIP's ln_pre + torch eps
        ),
        text_width=tw, text_heads=th, text_layers=tl, quick_gelu=qg,
    )


def clip_vit_b16_config() -> CLIPConfig:
    return clip_config_from_name("ViT-B-16")


def clip_tiny_config() -> CLIPConfig:
    return CLIPConfig(
        embed_dim=16,
        vision=BaseViTConfig(img_size=28, patch_size=14, embed_dim=32, depth=2,
                             num_heads=2, pre_norm=True, norm_eps=1e-5),
        vocab_size=100, context_length=12, text_width=32, text_heads=2,
        text_layers=2,
    )


class _TextBlock(nn.Module):
    """Pre-LN residual block: causal self-attention off one packed QKV
    projection, then the MLP (quick GELU on the OpenAI geometries)."""

    def __init__(self, width: int, heads: int, quick_gelu: bool, eps: float,
                 dtype=None, device=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.width, self.heads = width, heads
        self.ln_1 = LayerNormFP32(width, eps, device=device)
        self.attn_qkv = Dense(width, 3 * width, **kw)
        self.attn_out = Dense(width, width, **kw)
        self.ln_2 = LayerNormFP32(width, eps, device=device)
        self.mlp = Mlp(width, 4 * width, quick_gelu=quick_gelu, **kw)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        qkv = self.attn_qkv(self.ln_1(x)).reshape(b, n, 3, self.heads, -1)
        attn = dot_product_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], mask=mask)
        x = x + self.attn_out(attn.reshape(b, n, self.width))
        return x + self.mlp(self.ln_2(x))


def _l2(f: torch.Tensor) -> torch.Tensor:
    return f / torch.linalg.vector_norm(f.float(), dim=-1, keepdim=True)


@registry.register_model("clip_feature_extractor")
class CLIP(nn.Module):
    def __init__(self, config: CLIPConfig, device=None, dtype=torch.bfloat16):
        super().__init__()
        cfg = self.config = config
        self.compute_dtype = dtype
        kw = dict(device=device, dtype=dtype)
        if cfg.resnet is not None:
            # the attention pool's c_proj already maps to embed_dim
            self.visual = ModifiedResNet(cfg.resnet, **kw)
        else:
            self.visual = VisionTransformer(cfg.vision, **kw)
            self.visual_proj = Dense(cfg.vision.embed_dim, cfg.embed_dim, bias=False, **kw)
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.text_width, device=device)
        self.text_block = nn.ModuleList([
            _TextBlock(cfg.text_width, cfg.text_heads, cfg.quick_gelu, cfg.norm_eps, **kw)
            for _ in range(cfg.text_layers)])
        self.ln_final = LayerNormFP32(cfg.text_width, cfg.norm_eps, device=device)
        self.text_proj = Dense(cfg.text_width, cfg.embed_dim, bias=False, **kw)
        self.positional_embedding = nn.Parameter(
            torch.zeros(cfg.context_length, cfg.text_width, device=device))
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1.0 / 0.07), device=device))

    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) -> (B, embed_dim) unnormalized image features."""
        if self.config.resnet is not None:
            return self.visual(images)  # the tower pools and projects
        return self.visual_proj(self.visual(images)[:, 0])

    def encode_text(self, text_ids: torch.Tensor) -> torch.Tensor:
        """(B, N) ids -> (B, embed_dim) features at the EOT position (the
        highest id of a row, its first occurrence: CLIP's convention)."""
        n = text_ids.shape[1]
        x = self.token_embedding.weight[text_ids.long()].to(self.compute_dtype)
        x = x + self.positional_embedding[:n].to(x.dtype)
        causal = torch.tril(torch.ones(n, n, dtype=torch.bool, device=x.device))[None, None]
        for block in self.text_block:
            x = block(x, causal)
        x = self.ln_final(x)
        eot = torch.argmax(text_ids, dim=-1)
        return self.text_proj(x[torch.arange(x.shape[0], device=x.device), eot])

    def forward(self, images, text_ids):
        """Returns (logits_per_image, logits_per_text), fp32."""
        img = _l2(self.encode_image(images))
        txt = _l2(self.encode_text(text_ids))
        logits_per_image = torch.exp(self.logit_scale) * img @ txt.T
        return logits_per_image, logits_per_image.T


def clip_contrastive_loss(logits_per_image: torch.Tensor) -> torch.Tensor:
    """Symmetric InfoNCE over an (N, N) similarity matrix; across processes
    the matrix spans the features ``all_gather_features`` gathered."""
    labels = torch.arange(logits_per_image.shape[0], device=logits_per_image.device)
    return (F.cross_entropy(logits_per_image, labels)
            + F.cross_entropy(logits_per_image.T, labels)) / 2


class _AllGather(torch.autograd.Function):
    """All-gather along dim 0 whose backward sums the gradients of every
    rank's copy and keeps this rank's rows (the transpose of the gather:
    JAX's psum-scatter, the reference's GatherLayer)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        ctx.group, ctx.rank, ctx.rows = group, dist.get_rank(group), x.shape[0]
        return torch.cat(parts, dim=0)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        lo = ctx.rank * ctx.rows
        return grad[lo:lo + ctx.rows], None


def all_gather_features(x: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable all-gather over a ``torch.distributed`` group (every
    rank the same number of rows), tiled along dim 0 in rank order
    (reference ``all_gather_with_grad``); ``torch.distributed.all_gather``
    itself carries no gradient."""
    return _AllGather.apply(x, group)
