"""OPT decoder-only causal LM (counterpart of ``mr_blip_tpu/models/opt.py``).

The reference's vendored HF OPT (``lavis/models/blip2_models/
modeling_opt.py:1-1131``) as the ``blip2_opt_mr`` variant uses it: a pre-LN
transformer decoder, learned positional embeddings with the OPT offset of 2,
a ReLU FFN, a final LayerNorm and an LM head tied to the token table. The
prompt enters as embeddings. A static KV cache (``init_cache``) lets one
block-causal pass write the whole prompt (query j at position p + j sees
the slots <= p + j), then one step per generated token.

Positions are ``position + arange(n)``, not HF's cumsum of the mask, as in
the JAX package. A position past ``max_position_embeddings`` raises
``ValueError``: the JAX package's table lookup fills such a row with NaN,
and the causal product then spreads NaN to every logit.

Every attention mask has a query axis, so ``dot_product_attention`` takes
its plain path on every device, as the JAX package takes ``xla_attention``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from mr_blip_tpu_torch.models.layers import Dense, Dropout, LayerNormFP32
from mr_blip_tpu_torch.ops.attention import dot_product_attention


@dataclasses.dataclass(frozen=True)
class OPTConfig:
    vocab_size: int = 50272
    hidden_size: int = 2560
    num_layers: int = 32
    num_heads: int = 32
    ffn_dim: int = 10240
    max_position_embeddings: int = 2048
    dropout: float = 0.1
    layer_norm_eps: float = 1e-5
    pad_token_id: int = 1
    bos_token_id: int = 2
    eos_token_id: int = 2
    position_offset: int = 2  # OPT quirk: positions start at offset 2
    activation: str = "relu"  # "relu" (OPT) | "gelu" (tanh, GPT-2 reuse)
    tie_head: bool = True
    lora_rank: int = 0
    lora_alpha: float = 8.0
    lora_dropout: float = 0.05


def opt_2_7b_config(**kw) -> OPTConfig:
    return OPTConfig(**kw)


def opt_6_7b_config(**kw) -> OPTConfig:
    return OPTConfig(hidden_size=4096, num_layers=32, num_heads=32,
                     ffn_dim=16384, **kw)


def opt_tiny_config(**kw) -> OPTConfig:
    defaults = dict(vocab_size=256, hidden_size=32, num_layers=2, num_heads=4,
                    ffn_dim=64, max_position_embeddings=128, dropout=0.0)
    defaults.update(kw)
    return OPTConfig(**defaults)


class OPTAttention(nn.Module):
    """Self-attention with LoRA on q/k/v/out; attention-weight dropout
    (HF OPTAttention) in train mode."""

    def __init__(self, cfg: OPTConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(lora_rank=cfg.lora_rank, lora_alpha=cfg.lora_alpha,
                  lora_dropout=cfg.lora_dropout, device=device, dtype=dtype)
        d = cfg.hidden_size
        self.q_proj = Dense(d, d, **kw)
        self.k_proj = Dense(d, d, **kw)
        self.v_proj = Dense(d, d, **kw)
        self.out_proj = Dense(d, d, **kw)
        self.attn_dropout = Dropout(cfg.dropout)

    def forward(self, x, key_mask=None, cache=None, position: int = 0):
        """``key_mask``: (B, K) nonzero = attend, K the keys' length (the
        cache's with a cache). ``cache``: this layer's (K, V), each (B,
        cache_len, hidden), written in place at ``position``."""
        cfg = self.cfg
        b, n, _ = x.shape
        heads = (b, -1, cfg.num_heads, cfg.hidden_size // cfg.num_heads)
        q = self.q_proj(x)
        k = self.k_proj(x)
        v = self.v_proj(x)
        if cache is not None:
            cache_k, cache_v = cache
            end = position + n
            cache_k[:, position:end] = k
            cache_v[:, position:end] = v
            # The slots past ``end`` are masked for every query: leave them out.
            k, v = cache_k[:, :end], cache_v[:, :end]
        m = k.shape[1]
        q_pos = torch.arange(m - n, m, device=x.device)[:, None]
        mask = (torch.arange(m, device=x.device)[None, :] <= q_pos)[None, None]
        if key_mask is not None:
            mask = mask & (key_mask[:, :m] != 0)[:, None, None, :]
        out = dot_product_attention(
            q.reshape(heads), k.reshape(heads), v.reshape(heads), mask=mask,
            dropout_rate=self.attn_dropout.active_rate,
            generator=self.attn_dropout.generator)
        return self.out_proj(out.reshape(b, n, cfg.hidden_size))


class OPTDecoderLayer(nn.Module):
    def __init__(self, cfg: OPTConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.self_attn_norm = LayerNormFP32(d, cfg.layer_norm_eps, device=device)
        self.self_attn = OPTAttention(cfg, device=device, dtype=dtype)
        self.final_norm = LayerNormFP32(d, cfg.layer_norm_eps, device=device)
        self.fc1 = Dense(d, cfg.ffn_dim, lora_rank=cfg.lora_rank, device=device,
                         dtype=dtype)
        self.fc2 = Dense(cfg.ffn_dim, d, lora_rank=cfg.lora_rank, device=device,
                         dtype=dtype)

    def forward(self, x, key_mask=None, cache=None, position: int = 0):
        x = x + self.self_attn(self.self_attn_norm(x), key_mask, cache, position)
        h = self.fc1(self.final_norm(x))
        h = F.relu(h) if self.cfg.activation == "relu" else F.gelu(h, approximate="tanh")
        return x + self.fc2(h)


class OPTForCausalLM(nn.Module):
    """The token and position tables are fp32 (the JAX parameters'
    dtype); the head is the token table, applied in fp32."""

    def __init__(self, cfg: OPTConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = dtype or torch.get_default_dtype()
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                         device=device, dtype=torch.float32)
        self.embed_positions = nn.Embedding(
            cfg.max_position_embeddings + cfg.position_offset, cfg.hidden_size,
            device=device, dtype=torch.float32)
        self.layers = nn.ModuleList(OPTDecoderLayer(cfg, device=device, dtype=dtype)
                                    for _ in range(cfg.num_layers))
        self.final_norm = LayerNormFP32(cfg.hidden_size, cfg.layer_norm_eps,
                                        device=device)

    def init_cache(self, rows: int, cache_len: int, device):
        """Zeroed (K, V) caches of every layer, (rows, cache_len, hidden)."""
        shape = (rows, cache_len, self.cfg.hidden_size)
        return [(torch.zeros(shape, dtype=self.compute_dtype, device=device),
                 torch.zeros(shape, dtype=self.compute_dtype, device=device))
                for _ in self.layers]

    def forward(self, inputs_embeds, attention_mask=None, cache=None,
                position: int = 0, return_logits: bool = True):
        """(B, N, hidden) embeddings at positions ``position`` .. ``position
        + N - 1`` -> fp32 logits (B, N, vocab), or with ``return_logits``
        False the final-norm states. ``attention_mask``: (B, K) over the
        keys (the cache's length with a cache), nonzero = attend."""
        cfg = self.cfg
        n = inputs_embeds.shape[1]
        if position + n > cfg.max_position_embeddings:
            raise ValueError(
                f"OPT positions {position}..{position + n - 1} pass the "
                f"{cfg.max_position_embeddings} of max_position_embeddings "
                f"({position + n} positions needed)")
        positions = torch.arange(position, position + n,
                                 device=inputs_embeds.device) + cfg.position_offset
        cdt = self.compute_dtype
        x = inputs_embeds.to(cdt) + self.embed_positions(positions).to(cdt)
        for i, layer in enumerate(self.layers):
            x = layer(x, attention_mask, None if cache is None else cache[i], position)
        x = self.final_norm(x)
        return self.head(x) if return_logits else x

    def head(self, states: torch.Tensor) -> torch.Tensor:
        """Final-norm states -> fp32 logits through the tied token table."""
        return states.float() @ self.embed_tokens.weight.float().T
