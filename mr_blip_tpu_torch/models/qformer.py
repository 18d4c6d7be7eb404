"""BLIP-2 Q-Former, query path only (counterpart of
``mr_blip_tpu/models/qformer.py``).

BERT-base geometry: 12 post-LN layers, d=768, 12 heads, LN eps 1e-12,
cross-attention to the 1408-d ViT tokens in every second layer (0, 2, ...),
and only the query FFN. The 32 query tokens pass the embeddings LayerNorm
(and dropout) before the stack. In train mode, ``dropout`` acts on the
embeddings, the attention probabilities, and each attention and FFN output
before its residual LayerNorm, as in the reference, even with the Q-Former
frozen.

With ``QFormerConfig.int8_cross`` (inference only) each cross-attention
layer computes K and V with one ``w8a8_linear`` over the frame tokens from a
packed int8 ``kv_packed`` weight; convert float weights with
``models/quantize.py::quantize_qformer_cross_params``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from mr_blip_tpu_torch.models.layers import Dense, Dropout, LayerNormFP32, QDenseParams
from mr_blip_tpu_torch.ops.attention import dot_product_attention
from mr_blip_tpu_torch.ops.int8_matmul import w8a8_linear


@dataclasses.dataclass(frozen=True)
class QFormerConfig:
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    encoder_width: int = 1408
    cross_attention_freq: int = 2
    num_query_tokens: int = 32
    layer_norm_eps: float = 1e-12
    dropout: float = 0.1
    # W8A8 int8 cross-attention K/V projections, packed into one weight.
    int8_cross: bool = False


def qformer_base_config(encoder_width: int = 1408, num_query_tokens: int = 32):
    return QFormerConfig(encoder_width=encoder_width, num_query_tokens=num_query_tokens)


def qformer_tiny_config(encoder_width: int = 32):
    return QFormerConfig(hidden_size=32, num_layers=2, num_heads=2,
                         intermediate_size=64, encoder_width=encoder_width,
                         num_query_tokens=4)


class QFormerAttention(nn.Module):
    """Post-LN BERT attention; cross-attention K/V come from ``kv_states``."""

    def __init__(self, cfg: QFormerConfig, kv_width: int, packed_kv: bool = False,
                 device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.query = Dense(h, h, device=device, dtype=dtype)
        self.packed_kv = packed_kv
        if packed_kv:
            self.kv_packed = QDenseParams(kv_width, 2 * h, device=device)
        else:
            self.key = Dense(kv_width, h, device=device, dtype=dtype)
            self.value = Dense(kv_width, h, device=device, dtype=dtype)
        self.output = Dense(h, h, device=device, dtype=dtype)
        self.output_norm = LayerNormFP32(h, cfg.layer_norm_eps, device=device)
        self.attn_dropout = Dropout(cfg.dropout)
        self.dropout = Dropout(cfg.dropout)

    def forward(self, x, kv_states=None):
        cfg = self.cfg
        kv = x if kv_states is None else kv_states
        q = self.query(x)
        if self.packed_kv:
            # K and V of every frame token in one int8 product.
            kv2 = w8a8_linear(kv.reshape(-1, kv.shape[-1]), *self.kv_packed())
            kv2 = kv2.reshape(kv.shape[0], kv.shape[1], 2 * cfg.hidden_size)
            k, v = kv2[..., :cfg.hidden_size], kv2[..., cfg.hidden_size:]
        else:
            k, v = self.key(kv), self.value(kv)
        b, n, _ = q.shape
        m = k.shape[1]
        hd = cfg.hidden_size // cfg.num_heads
        out = dot_product_attention(q.reshape(b, n, cfg.num_heads, hd),
                                    k.reshape(b, m, cfg.num_heads, hd),
                                    v.reshape(b, m, cfg.num_heads, hd),
                                    dropout_rate=self.attn_dropout.active_rate,
                                    generator=self.attn_dropout.generator)
        out = self.dropout(self.output(out.reshape(b, n, cfg.hidden_size)))
        return self.output_norm(x + out)


class QFormerLayer(nn.Module):
    def __init__(self, cfg: QFormerConfig, has_cross_attention: bool,
                 device=None, dtype=None):
        super().__init__()
        h = cfg.hidden_size
        self.self_attention = QFormerAttention(cfg, h, device=device, dtype=dtype)
        self.cross_attention = (
            QFormerAttention(cfg, cfg.encoder_width, packed_kv=cfg.int8_cross,
                             device=device, dtype=dtype)
            if has_cross_attention else None)
        self.intermediate_query = Dense(h, cfg.intermediate_size, device=device,
                                        dtype=dtype)
        self.output_query = Dense(cfg.intermediate_size, h, device=device,
                                  dtype=dtype)
        self.output_query_norm = LayerNormFP32(h, cfg.layer_norm_eps, device=device)
        self.dropout = Dropout(cfg.dropout)

    def forward(self, x, encoder_states):
        x = self.self_attention(x)
        if self.cross_attention is not None:
            x = self.cross_attention(x, kv_states=encoder_states)
        y = self.dropout(self.output_query(F.gelu(self.intermediate_query(x))))
        return self.output_query_norm(x + y)


class QFormer(nn.Module):
    """(B, M, encoder_width) frame tokens -> (B, num_query_tokens, hidden)."""

    def __init__(self, cfg: QFormerConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = dtype or torch.get_default_dtype()
        self.query_tokens = nn.Parameter(
            torch.zeros(1, cfg.num_query_tokens, cfg.hidden_size, device=device,
                        dtype=dtype))
        self.embeddings_norm = LayerNormFP32(cfg.hidden_size, cfg.layer_norm_eps,
                                             device=device)
        self.dropout = Dropout(cfg.dropout)
        self.layer = nn.ModuleList([
            QFormerLayer(cfg, i % cfg.cross_attention_freq == 0, device=device,
                         dtype=dtype)
            for i in range(cfg.num_layers)
        ])

    def forward(self, encoder_states):
        b = encoder_states.shape[0]
        # The query stream runs in the compute dtype whatever the frame
        # tokens' dtype (the int8 ViT emits bf16 under any compute dtype).
        x = self.query_tokens.expand(b, -1, -1).to(self.compute_dtype)
        x = self.dropout(self.embeddings_norm(x))
        for layer in self.layer:
            x = layer(x, encoder_states)
        return x
