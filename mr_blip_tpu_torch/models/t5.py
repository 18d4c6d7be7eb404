"""T5 encoder-decoder, float and int8 inference paths (counterpart of
``mr_blip_tpu/models/t5.py``).

Flan-T5 geometry: relative-position-bucket attention bias (computed by the
first layer's table and shared by every layer), RMSNorm, gated exact-GELU
FFN, untied LM head with fp32 logits, LoRA deltas on every Linear. T5 applies
no 1/sqrt(d) scale, so q is multiplied by sqrt(d_kv) before the attention
core, which divides it back out. The other T5 layouts of HF's config, as
the JAX package has them: ``dense_act_fn`` ("gelu" exact, "gelu_new" tanh,
"relu"), ``is_gated_act`` (``wi_0``/``wi_1`` or one ``wi``) and
``tie_word_embeddings`` (no ``lm_head``: the logits are ``x * d_model**-0.5``
against ``shared.weight``, in fp32).

Decoding keeps a static self-attention cache per layer, (B*K, max_len,
H*D) for K and for V, written in place at the step's position, and the
cross-attention K/V once per batch row (B, M, H*D): the K beams of a row
share them, folded into the query length at attention time.

Training uses the teacher-forced, uncached decoder (``decode``), with
dropout at the JAX package's places in train mode: the encoder and decoder
inputs and final outputs, every residual branch, the FFN hidden state and
the LoRA inputs (attention weights too with ``attn_weight_dropout``).
``use_remat`` checkpoints every block of the uncached forward (the
``encoder`` / ``decoder`` modules' ``use_remat``), as the JAX package wraps
them in ``nn.remat``.
When the encoder's rel-pos table trains, its bias is computed in the graph
and the biased flash kernel's backward emits dbias for it.

Long context (``relpos_in_kernel``): the encoder hands its layers the
(H, num_buckets) table instead of a (1, H, N, N) bias, and the attention
core (``ops/attention.py::relpos_attention``) looks the bias up inside the
rel-pos flash kernels, in the float and the W8A8 encoder alike; a trained
table gets its gradient from their backward. The decoder is untouched.

int8 inference modes (``models/quantize.py`` converts the weights):
``int8_encoder`` runs every encoder block on the W8A8 kernels of
``ops/int8_matmul.py`` (packed q/k/v with the RMS pre-norm folded in, ``o``
with the skip add, the gated FFN in one call; LoRA merged into the weights;
the attention itself stays the biased flash kernel in bf16);
``int8_decode`` stores every decoder Dense and the LM head weight-only int8;
``int8_cross_cache`` keeps the decode-time cross-attention K/V int8 with one
scale per (batch row, channel).

QLoRA-style training (``int8_base``): every encoder and decoder Dense and the
LM head are weight-only int8 and frozen, the LoRA deltas float and trained;
the backward of an int8 product keeps only the int8 weight and its scales
(``layers.Dense``).

Tensor parallelism (``parallel/tensor.py::shard_module``): an attention
module runs the rank's heads ``head_lo:head_hi`` (``set_heads``; its KV
caches and ``project_kv`` hold those heads only), its stack's rel-pos bias
is built from the table's columns of those heads (``T5RelativeBias.heads``),
the FFN runs the rank's slice of ``d_ff``; the input of each column group
passes ``copy_to_tp`` once, the ``o`` / ``wo`` partial products are summed
in their ``Dense``, and the LM head gathers its logits.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from mr_blip_tpu_torch.models.layers import (
    Dense,
    Dropout,
    QDenseParams,
    RMSNormFP32,
    remat,
)
from mr_blip_tpu_torch.ops.attention import dot_product_attention, relpos_attention
from mr_blip_tpu_torch.ops.int8_matmul import div_exact, w8a8_linear, w8a8_mlp_gated
from mr_blip_tpu_torch.ops.relpos import materialize_relpos_bias
from mr_blip_tpu_torch.parallel.tensor import copy_to_tp


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 2048
    d_kv: int = 64
    d_ff: int = 5120
    num_layers: int = 24
    num_decoder_layers: int = 24
    num_heads: int = 32
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    dropout_rate: float = 0.1
    layer_norm_epsilon: float = 1e-6
    dense_act_fn: str = "gelu"  # exact GELU (the reference's override)
    is_gated_act: bool = True
    tie_word_embeddings: bool = False
    pad_token_id: int = 0
    eos_token_id: int = 1
    decoder_start_token_id: int = 0
    lora_rank: int = 0
    lora_alpha: float = 8.0
    lora_dropout: float = 0.05
    # HF T5 also drops the attention weights in training; off by default in
    # the JAX package (it forces the plain attention path).
    attn_weight_dropout: bool = False
    # Gradient checkpointing: every encoder and decoder block of the uncached
    # forward keeps only its input and recomputes the rest in the backward
    # (``layers.remat``); the cached decode step never.
    use_remat: bool = False
    # Inference only. Weight-only int8 decoder blocks and LM head:
    int8_decode: bool = False
    # the decode-time cross-attention K/V cache int8, quantized when it is
    # built, with per-(batch row, channel) scales over the length axis:
    int8_cross_cache: bool = False
    # every encoder block on the W8A8 kernels (LoRA merged into the weights):
    int8_encoder: bool = False
    # Training (QLoRA-style): every encoder and decoder block Dense and the LM
    # head weight-only int8, frozen, under float trainable LoRA deltas.
    int8_base: bool = False
    # Long context: the encoder's rel-pos bias is computed inside the flash
    # kernels from the table (O(N) memory) instead of being materialized as
    # (1, H, N, N). Changes no parameter.
    relpos_in_kernel: bool = False


def t5_flan_xl_config(**kw) -> T5Config:
    return T5Config(**kw)


def t5_flan_xxl_config(**kw) -> T5Config:
    return T5Config(d_model=4096, d_ff=10240, num_heads=64, **kw)


def t5_tiny_config(**kw) -> T5Config:
    defaults = dict(vocab_size=256, d_model=32, d_kv=8, d_ff=64, num_layers=2,
                    num_decoder_layers=2, num_heads=4, dropout_rate=0.0)
    defaults.update(kw)
    return T5Config(**defaults)


def materialize_encoder_relpos_bias(table: torch.Tensor, length: int,
                                    num_buckets: int = 32,
                                    max_distance: int = 128) -> torch.Tensor:
    """(1, H, N, N) bidirectional bias from the (num_buckets, H) table."""
    positions = torch.arange(length, device=table.device)
    return materialize_relpos_bias(table, positions, positions, True,
                                   num_buckets, max_distance)


class T5RelativeBias(nn.Module):
    """Relative position bias table (fp32), (num_buckets, H). ``heads`` =
    (lo, hi) under tensor parallelism: the bias of heads ``lo:hi`` only."""

    def __init__(self, cfg: T5Config, bidirectional: bool, device=None):
        super().__init__()
        self.cfg = cfg
        self.bidirectional = bidirectional
        self.rel_embedding = nn.Parameter(torch.zeros(
            cfg.relative_attention_num_buckets, cfg.num_heads, device=device))
        self.heads: tuple | None = None

    def local_table(self) -> torch.Tensor:
        """(num_buckets, heads of this rank) columns of the table."""
        if self.heads is None:
            return self.rel_embedding
        return self.rel_embedding[:, self.heads[0]:self.heads[1]]

    def forward(self, q_pos: torch.Tensor, k_pos: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        return materialize_relpos_bias(
            self.local_table(), q_pos, k_pos, self.bidirectional,
            cfg.relative_attention_num_buckets, cfg.relative_attention_max_distance)

    def head_major_table(self) -> torch.Tensor:
        """(H, num_buckets) table for the in-kernel rel-pos path (a rank's
        heads under tensor parallelism, copied contiguous: the kernels read
        it so)."""
        if self.heads is None:
            return self.rel_embedding.T
        return self.local_table().T.contiguous()


def _quantize_cache(t: torch.Tensor):
    """(B, M, C) -> int8 values and (B, 1, C) fp32 scales: symmetric, per
    (batch row, channel) over the length axis."""
    tf = t.float()
    scale = div_exact(tf.abs().amax(dim=1, keepdim=True).clamp_min(1e-6), 127.0)
    return torch.clamp(torch.round(tf / scale), -127, 127).to(torch.int8), scale


class T5Attention(nn.Module):
    """``quantize_dense``: weight-only int8 projections (decoder inference).
    ``w8a8``: the encoder's W8A8 projections, ``qkv_packed`` and ``o``."""

    def __init__(self, cfg: T5Config, quantize_dense: bool = False,
                 w8a8: bool = False, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.w8a8 = w8a8
        inner = cfg.num_heads * cfg.d_kv
        if w8a8:
            self.qkv_packed = QDenseParams(cfg.d_model, 3 * inner, use_bias=False,
                                           device=device)
            self.o = QDenseParams(inner, cfg.d_model, use_bias=False, device=device)
        else:
            kw = dict(bias=False, lora_rank=cfg.lora_rank, lora_alpha=cfg.lora_alpha,
                      lora_dropout=cfg.lora_dropout, quantize=quantize_dense,
                      device=device, dtype=dtype)
            self.q = Dense(cfg.d_model, inner, **kw)
            self.k = Dense(cfg.d_model, inner, **kw)
            self.v = Dense(cfg.d_model, inner, **kw)
            self.o = Dense(inner, cfg.d_model, **kw)
        self.attn_dropout = Dropout(cfg.dropout_rate if cfg.attn_weight_dropout
                                    else 0.0)
        self.heads = cfg.num_heads
        self.head_lo, self.head_hi = 0, cfg.num_heads
        self.tp_group = None

    def set_heads(self, group, lo: int, hi: int):
        """Run heads ``lo:hi`` of the tensor-parallel ``group`` (the q, k, v
        and o weights already cut to them)."""
        self.tp_group, self.head_lo, self.head_hi = group, lo, hi
        self.heads = hi - lo

    def _heads(self, t: torch.Tensor) -> torch.Tensor:
        return t.reshape(t.shape[0], t.shape[1], self.heads, self.cfg.d_kv)

    def _attend(self, q, k, v, bias, mask, relpos_table=None):
        # Cancel the D^-1/2 inside the attention core: T5 has no scale.
        cfg = self.cfg
        q = q * (cfg.d_kv ** 0.5)
        drop = dict(dropout_rate=self.attn_dropout.active_rate,
                    generator=self.attn_dropout.generator)
        if self.tp_group is not None:
            drop["dropout_heads"] = (self.head_lo, self.head_hi, cfg.num_heads)
        if relpos_table is not None:
            out = relpos_attention(
                q, k, v, relpos_table,
                kv_mask=None if mask is None else mask[:, 0, 0, :],
                num_buckets=cfg.relative_attention_num_buckets,
                max_distance=cfg.relative_attention_max_distance, **drop)
        else:
            out = dot_product_attention(q, k, v, bias=bias, mask=mask, **drop)
        return out.reshape(out.shape[0], out.shape[1], -1)

    def forward(self, x, mask=None, position_bias=None, kv_states=None,
                relpos_table=None):
        """Uncached attention: self-attention, or cross-attention over
        ``kv_states``. ``relpos_table`` (encoder self-attention only): the
        (H, num_buckets) table in place of ``position_bias``."""
        x = copy_to_tp(x, self.tp_group)
        kv = x if kv_states is None else copy_to_tp(kv_states, self.tp_group)
        out = self._attend(self._heads(self.q(x)), self._heads(self.k(kv)),
                           self._heads(self.v(kv)), position_bias, mask,
                           relpos_table)
        return self.o(out)

    def forward_w8a8(self, x, mask, position_bias, norm_scale, residual,
                     relpos_table=None):
        """Encoder self-attention on the W8A8 kernels: q, k and v from one
        packed int8 product with the RMS pre-norm (``norm_scale``) folded in,
        the biased attention in bf16 (the bias from ``position_bias`` or, in
        the kernel, from ``relpos_table``), and ``o`` with the block's skip
        add (``residual``) in its epilogue. LoRA is merged into the weights."""
        cfg = self.cfg
        b, n, d = x.shape
        inner = cfg.num_heads * cfg.d_kv
        wq3, sw3, _ = self.qkv_packed()
        qkv = w8a8_linear(x.reshape(-1, d), wq3, sw3,
                          norm=("rms", norm_scale, None, cfg.layer_norm_epsilon))
        q, k, v = (qkv[:, i * inner:(i + 1) * inner]
                   .reshape(b, n, cfg.num_heads, cfg.d_kv) for i in range(3))
        # The flash kernel reads contiguous k and v (q is copied by its scale).
        out = self._attend(q, k.contiguous(), v.contiguous(), position_bias, mask,
                           relpos_table)
        wo, so, _ = self.o()
        y = w8a8_linear(out.reshape(-1, inner), wo, so,
                        residual=residual.reshape(-1, d))
        return y.reshape(b, n, d)

    def project_kv(self, kv_states):
        """Cross-attention K and V, (B, M, H*D) each, computed once; with
        ``int8_cross_cache`` as (K int8, V int8, K scale, V scale)."""
        kv_states = copy_to_tp(kv_states, self.tp_group)
        k, v = self.k(kv_states), self.v(kv_states)
        if self.cfg.int8_cross_cache:
            (k, k_scale), (v, v_scale) = _quantize_cache(k), _quantize_cache(v)
            return k, v, k_scale, v_scale
        return k, v

    def decode_self(self, x, cache, position: int, position_bias):
        """One cached step: write this step's K/V at ``position`` of the
        (B*K, max_len, H*D) cache in place and attend over the written slots."""
        cache_k, cache_v = cache
        x = copy_to_tp(x, self.tp_group)
        n = x.shape[1]
        cache_k[:, position:position + n] = self.k(x)
        cache_v[:, position:position + n] = self.v(x)
        max_len = cache_k.shape[1]
        valid = (torch.arange(max_len, device=x.device) < position + n)
        out = self._attend(self._heads(self.q(x)), self._heads(cache_k),
                           self._heads(cache_v), position_bias,
                           valid[None, None, None, :])
        return self.o(out)

    def decode_cross(self, x, kv, mask):
        """Cross-attention with K/V and ``mask`` at the encoder batch size:
        beam-expanded query rows are folded into the query length (the K
        beams of one row share its K/V), keeping the sqrt(d_kv) pre-scale."""
        k_flat, v_flat = kv[:2]
        x = copy_to_tp(x, self.tp_group)
        b, n, _ = x.shape
        b_enc = k_flat.shape[0]
        beams = b // b_enc
        heads, d_kv = self.heads, self.cfg.d_kv
        q = self.q(x).reshape(b_enc, beams * n, heads, d_kv)
        if len(kv) == 4:
            # int8 K/V feed the products directly: the per-channel K scale
            # folds into q (it is constant over the contraction) and the V
            # scale applies after p·v. No 1/sqrt(d) scale (T5 has none).
            k_scale, v_scale = (s.reshape(b_enc, 1, heads, d_kv) for s in kv[2:])
            qk = (q.float() * k_scale).to(q.dtype)
            logits = torch.einsum("bnhd,bmhd->bhnm", qk.float(),
                                  self._heads(k_flat).float())
            if mask is not None:
                logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
            p = torch.softmax(logits, dim=-1).to(q.dtype)
            ctx = torch.einsum("bhnm,bmhd->bnhd", p.float(),
                               self._heads(v_flat).float())
            out = (ctx * v_scale).to(q.dtype)
        else:
            out = self._attend(q, self._heads(k_flat), self._heads(v_flat), None, mask)
        return self.o(out.reshape(b, n, -1))


_ACTIVATIONS = {"gelu": F.gelu,
                "gelu_new": lambda y: F.gelu(y, approximate="tanh"),
                "relu": F.relu}


def check_w8a8_ffn(cfg: T5Config) -> None:
    """The W8A8 FFN kernel computes the gated GELU FFN only (tanh inside)."""
    if not (cfg.is_gated_act and cfg.dense_act_fn.startswith("gelu")):
        raise ValueError(
            f"the W8A8 T5 FFN takes a gated GELU, not dense_act_fn="
            f"{cfg.dense_act_fn!r} with is_gated_act={cfg.is_gated_act}")


class T5FeedForward(nn.Module):
    """Gated FFN wo(dropout(act(wi_0 x) * wi_1 x)), or with ``is_gated_act``
    off wo(dropout(act(wi x))); ``act`` by ``dense_act_fn``."""

    def __init__(self, cfg: T5Config, quantize_dense: bool = False,
                 w8a8: bool = False, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        if cfg.dense_act_fn not in _ACTIVATIONS:
            raise ValueError(f"dense_act_fn={cfg.dense_act_fn!r}")
        self.act = _ACTIVATIONS[cfg.dense_act_fn]
        if w8a8:
            check_w8a8_ffn(cfg)
            kw = dict(use_bias=False, device=device)
            self.wi_0 = QDenseParams(cfg.d_model, cfg.d_ff, **kw)
            self.wi_1 = QDenseParams(cfg.d_model, cfg.d_ff, **kw)
            self.wo = QDenseParams(cfg.d_ff, cfg.d_model, **kw)
        else:
            kw = dict(bias=False, lora_rank=cfg.lora_rank, lora_alpha=cfg.lora_alpha,
                      lora_dropout=cfg.lora_dropout, quantize=quantize_dense,
                      device=device, dtype=dtype)
            if cfg.is_gated_act:
                self.wi_0 = Dense(cfg.d_model, cfg.d_ff, **kw)
                self.wi_1 = Dense(cfg.d_model, cfg.d_ff, **kw)
            else:
                self.wi = Dense(cfg.d_model, cfg.d_ff, **kw)
            self.wo = Dense(cfg.d_ff, cfg.d_model, **kw)
        self.dropout = Dropout(cfg.dropout_rate)
        self.tp_group = None  # set when the FFN runs a slice of d_ff

    def forward(self, x):
        x = copy_to_tp(x, self.tp_group)
        if self.cfg.is_gated_act:
            h = self.act(self.wi_0(x)) * self.wi_1(x)
        else:
            h = self.act(self.wi(x))
        return self.wo(self.dropout(h))

    def forward_w8a8(self, x, norm_scale, residual):
        """The whole FFN in one ``w8a8_mlp_gated`` (tanh-GELU inside), with
        the RMS pre-norm and the skip add folded in."""
        d = x.shape[-1]
        (w0, s0, _), (w1, s1, _), (wo, so, _) = self.wi_0(), self.wi_1(), self.wo()
        y = w8a8_mlp_gated(
            x.reshape(-1, d), w0, s0, w1, s1, wo, so,
            norm=("rms", norm_scale, None, self.cfg.layer_norm_epsilon),
            residual=residual.reshape(-1, d))
        return y.reshape(x.shape)


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, has_cross_attention: bool,
                 quantize_dense: bool = False, w8a8: bool = False, device=None,
                 dtype=None):
        super().__init__()
        eps = cfg.layer_norm_epsilon
        kw = dict(quantize_dense=quantize_dense, device=device, dtype=dtype)
        self.w8a8 = w8a8
        self.self_attn_norm = RMSNormFP32(cfg.d_model, eps, device=device)
        self.self_attention = T5Attention(cfg, w8a8=w8a8, **kw)
        if has_cross_attention:
            self.cross_attn_norm = RMSNormFP32(cfg.d_model, eps, device=device)
            self.cross_attention = T5Attention(cfg, **kw)
        self.ff_norm = RMSNormFP32(cfg.d_model, eps, device=device)
        self.ff = T5FeedForward(cfg, w8a8=w8a8, **kw)
        self.dropout = Dropout(cfg.dropout_rate)

    def forward(self, x, mask, position_bias, encoder_states=None,
                cross_mask=None, relpos_table=None):
        """Uncached block: encoder, or teacher-forced decoder when
        ``encoder_states`` is given. ``relpos_table`` takes the place of
        ``position_bias`` in the self-attention (long-context encoder)."""
        if self.w8a8:
            # Inference only: both pre-norms fold into the int8 kernels and
            # both skip adds ride their epilogues; the norm modules only hold
            # the scales.
            if self.training:
                raise RuntimeError("the W8A8 encoder is an inference mode")
            x = self.self_attention.forward_w8a8(
                x, mask, position_bias, self.self_attn_norm.weight, residual=x,
                relpos_table=relpos_table)
            return self.ff.forward_w8a8(x, self.ff_norm.weight, residual=x)
        x = x + self.dropout(self.self_attention(
            self.self_attn_norm(x), mask, position_bias,
            relpos_table=relpos_table))
        if encoder_states is not None:
            x = x + self.dropout(self.cross_attention(
                self.cross_attn_norm(x), cross_mask, kv_states=encoder_states))
        return x + self.dropout(self.ff(self.ff_norm(x)))

    def decode(self, x, self_cache, position, position_bias, cross_kv, cross_mask):
        """Decoder block, one cached step (inference: no dropout)."""
        x = x + self.self_attention.decode_self(self.self_attn_norm(x), self_cache,
                                                position, position_bias)
        x = x + self.cross_attention.decode_cross(self.cross_attn_norm(x),
                                                  cross_kv, cross_mask)
        return x + self.ff(self.ff_norm(x))


def _call(module, *args, **kwargs):
    return module(*args, **kwargs)


class T5Encoder(nn.Module):
    def __init__(self, cfg: T5Config, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = dtype or torch.get_default_dtype()
        self.rel_bias = T5RelativeBias(cfg, bidirectional=True, device=device)
        self.block = nn.ModuleList([T5Block(cfg, False, quantize_dense=cfg.int8_base,
                                            w8a8=cfg.int8_encoder, device=device,
                                            dtype=dtype)
                                    for _ in range(cfg.num_layers)])
        self.final_norm = RMSNormFP32(cfg.d_model, cfg.layer_norm_epsilon,
                                      device=device)
        self.dropout = Dropout(cfg.dropout_rate)
        self.use_remat = cfg.use_remat

    def forward(self, inputs_embeds, mask=None, position_bias=None):
        """``position_bias`` handed in: used as it is. None: under
        ``relpos_in_kernel`` no bias is built and every layer gets the
        (H, num_buckets) table; otherwise the bias is computed here from the
        table. Either way in the graph, so a trained table gets its
        gradient."""
        dtype = self.compute_dtype
        n = inputs_embeds.shape[1]
        relpos_table = None
        if position_bias is None and self.cfg.relpos_in_kernel:
            relpos_table = self.rel_bias.head_major_table()
        else:
            if position_bias is None:
                pos = torch.arange(n, device=inputs_embeds.device)
                position_bias = self.rel_bias(pos, pos)
            if position_bias.shape[-1] != n:
                raise ValueError(f"bias length {position_bias.shape[-1]} != {n}")
            position_bias = position_bias.to(dtype)
        attn_mask = None if mask is None else mask.bool()[:, None, None, :]
        x = self.dropout(inputs_embeds.to(dtype))
        call = remat if self.use_remat and torch.is_grad_enabled() else _call
        for blk in self.block:
            x = call(blk, x, attn_mask, position_bias, relpos_table=relpos_table)
        return self.dropout(self.final_norm(x))


class T5Decoder(nn.Module):
    def __init__(self, cfg: T5Config, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.rel_bias = T5RelativeBias(cfg, bidirectional=False, device=device)
        self.block = nn.ModuleList([T5Block(cfg, True,
                                            quantize_dense=cfg.int8_decode or cfg.int8_base,
                                            device=device, dtype=dtype)
                                    for _ in range(cfg.num_decoder_layers)])
        self.final_norm = RMSNormFP32(cfg.d_model, cfg.layer_norm_epsilon,
                                      device=device)
        self.dropout = Dropout(cfg.dropout_rate)
        self.use_remat = cfg.use_remat

    def forward(self, inputs_embeds, encoder_states, decoder_mask=None,
                encoder_mask=None):
        """Teacher-forced, uncached: causal self-attention with the
        unidirectional rel-pos bias and ``decoder_mask`` over the keys, then
        cross-attention over ``encoder_states`` masked by ``encoder_mask``."""
        dtype = self.block[0].ff.wo.compute_dtype
        n = inputs_embeds.shape[1]
        pos = torch.arange(n, device=inputs_embeds.device)
        position_bias = self.rel_bias(pos, pos).to(dtype)
        self_mask = torch.tril(torch.ones(n, n, dtype=torch.bool,
                                          device=pos.device))[None, None]
        if decoder_mask is not None:
            self_mask = self_mask & decoder_mask.bool()[:, None, None, :]
        cross_mask = (None if encoder_mask is None
                      else encoder_mask.bool()[:, None, None, :])
        x = self.dropout(inputs_embeds.to(dtype))
        call = remat if self.use_remat and torch.is_grad_enabled() else _call
        for blk in self.block:
            x = call(blk, x, self_mask, position_bias, encoder_states, cross_mask)
        return self.dropout(self.final_norm(x))

    def cross_kv(self, encoder_states):
        """Every layer's cross-attention (K, V) at the encoder batch size
        (int8 with their scales under ``int8_cross_cache``)."""
        return [blk.cross_attention.project_kv(encoder_states) for blk in self.block]

    def init_cache(self, rows: int, max_len: int, dtype, device):
        """Zeroed self-attention (K, V) caches, (rows, max_len, H*D) each (the
        rank's heads under tensor parallelism)."""
        caches = []
        for blk in self.block:
            inner = blk.self_attention.heads * self.cfg.d_kv
            caches.append((torch.zeros(rows, max_len, inner, dtype=dtype, device=device),
                           torch.zeros(rows, max_len, inner, dtype=dtype, device=device)))
        return caches

    def decode_step(self, x, position: int, cache, cross_kv, encoder_mask):
        dtype = self.block[0].ff.wo.compute_dtype
        max_len = cache[0][0].shape[1]
        q_pos = torch.arange(position, position + x.shape[1], device=x.device)
        k_pos = torch.arange(max_len, device=x.device)
        position_bias = self.rel_bias(q_pos, k_pos).to(dtype)
        cross_mask = (None if encoder_mask is None
                      else encoder_mask.bool()[:, None, None, :])
        x = x.to(dtype)
        for blk, self_cache, kv in zip(self.block, cache, cross_kv):
            x = blk.decode(x, self_cache, position, position_bias, kv, cross_mask)
        return self.final_norm(x)


class T5ForConditionalGeneration(nn.Module):
    """Encoder-decoder with a shared token embedding and an untied LM head
    (``tie_word_embeddings``: the embedding is the head)."""

    def __init__(self, cfg: T5Config, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model, device=device,
                                   dtype=dtype)
        self.encoder = T5Encoder(cfg, device=device, dtype=dtype)
        self.decoder = T5Decoder(cfg, device=device, dtype=dtype)
        if not cfg.tie_word_embeddings:
            self.lm_head = Dense(cfg.d_model, cfg.vocab_size, bias=False,
                                 lora_rank=cfg.lora_rank, lora_alpha=cfg.lora_alpha,
                                 lora_dropout=cfg.lora_dropout,
                                 quantize=cfg.int8_decode or cfg.int8_base,
                                 device=device, dtype=dtype)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """Decoder states -> fp32 logits."""
        if self.cfg.tie_word_embeddings:
            x = (x * self.cfg.d_model ** -0.5).float()
            return x @ self.shared.weight.float().t()
        return self.lm_head(x).float()

    def encode(self, inputs_embeds, mask=None, position_bias=None):
        return self.encoder(inputs_embeds, mask=mask, position_bias=position_bias)

    def decode(self, decoder_input_ids, encoder_states, decoder_mask=None,
               encoder_mask=None):
        """Teacher-forced decoder -> (B, n, vocab) fp32 logits."""
        x = self.decoder(self.shared(decoder_input_ids), encoder_states,
                         decoder_mask=decoder_mask, encoder_mask=encoder_mask)
        return self.logits(x)

    def decode_step(self, tokens, position: int, cache, cross_kv, encoder_mask):
        """(rows, n) token ids -> (rows, n, vocab) fp32 logits; writes the
        self-attention caches in place."""
        x = self.decoder.decode_step(self.shared(tokens), position, cache,
                                     cross_kv, encoder_mask)
        return self.logits(x)


def shift_right(labels: torch.Tensor, decoder_start_token_id: int = 0,
                pad_token_id: int = 0) -> torch.Tensor:
    """Teacher-forcing decoder inputs: prepend the start token, drop the
    last label, and turn -100 into the pad id."""
    shifted = torch.roll(labels, 1, dims=-1)
    shifted[:, 0] = decoder_start_token_id
    return torch.where(shifted == -100, torch.full_like(shifted, pad_token_id),
                       shifted)


def cross_entropy_lm_loss_terms(logits: torch.Tensor, labels: torch.Tensor,
                                label_mask: torch.Tensor):
    """(sum of the token-level cross entropy, number of tokens) over the
    unmasked label positions, both fp32 scalars: a data-parallel step
    divides the sum by the count over every rank's rows."""
    labels_clipped = torch.where(labels == -100, torch.zeros_like(labels), labels)
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    token_ll = log_probs.gather(-1, labels_clipped[..., None].long())[..., 0]
    mask = label_mask.float() * (labels != -100).float()
    return -(token_ll * mask).sum(), mask.sum()


def cross_entropy_lm_loss(logits: torch.Tensor, labels: torch.Tensor,
                          label_mask: torch.Tensor) -> torch.Tensor:
    """Mean token-level cross entropy over unmasked label positions."""
    total, count = cross_entropy_lm_loss_terms(logits, labels, label_mask)
    return total / count.clamp_min(1.0)
