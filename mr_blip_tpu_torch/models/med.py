"""MED: the BERT-based Multimodal Encoder-Decoder (the port's counterpart of
``mr_blip_tpu/models/med.py``).

Reference ``lavis/models/blip_models/med.py:1-1416`` (BLIP's text backbone)
and the ALBEF text encoder: a post-LN BERT stack with word and position
embeddings that runs in four modes:

* ``"text"``: unimodal text encoder, layers [0, fusion_layer), no
  cross-attention
* ``"multimodal"``: cross-attention to the image tokens in every layer
* ``"decoder"``: causal self-attention + cross-attention (BLIP's caption
  decoder; ``MedLMHead`` gives its logits)
* ``"fusion"``: layers [fusion_layer, num_layers) over the text-mode hidden
  states (ALBEF/ALPRO split the stack)

LayerNorm eps is 1e-12 (``layer_norm_eps``), the FFN and the LM head use the
exact (erf) GELU. Dropout (hidden states and attention probabilities, rate
``dropout``) acts in train mode only; the zoo wrappers run the module in
eval mode, as the JAX wrappers apply it deterministic. A layer holds its
cross-attention when it can run one: every layer when ``fusion_layer`` is
None (BLIP), the layers from ``fusion_layer`` on otherwise.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from mr_blip_tpu_torch.models.layers import Dense, Dropout, LayerNormFP32
from mr_blip_tpu_torch.ops.attention import dot_product_attention


@dataclasses.dataclass(frozen=True)
class MedConfig:
    vocab_size: int = 30524  # bert-base + [DEC]/[ENC] tokens
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    encoder_width: int = 768  # image token width for cross-attention
    max_position_embeddings: int = 512
    layer_norm_eps: float = 1e-12
    dropout: float = 0.1
    # ALBEF/ALPRO split the stack: layers [0, fusion_layer) are the text
    # encoder (mode="text"), layers [fusion_layer, num_layers) the
    # multimodal fusion encoder (mode="fusion"); None = num_layers = the
    # BLIP behavior where "multimodal" cross-attends in every layer
    # (reference med.py BertEncoder:540-558, med_config_albef.json:21).
    fusion_layer: int | None = None


def med_base_config(**kw) -> MedConfig:
    return MedConfig(**kw)


def med_tiny_config(**kw) -> MedConfig:
    defaults = dict(vocab_size=120, hidden_size=32, num_layers=2, num_heads=2,
                    intermediate_size=64, encoder_width=32, dropout=0.0)
    defaults.update(kw)
    return MedConfig(**defaults)


class _BertAttention(nn.Module):
    """q from ``x``, k and v from ``kv_states`` (or ``x``), the output
    projection, dropout, then LayerNorm over the residual sum (post-LN).
    Cross-attention's k and v read ``encoder_width``-wide image tokens."""

    def __init__(self, cfg: MedConfig, kv_width: int, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.query = Dense(h, h, device=device, dtype=dtype)
        self.key = Dense(kv_width, h, device=device, dtype=dtype)
        self.value = Dense(kv_width, h, device=device, dtype=dtype)
        self.output = Dense(h, h, device=device, dtype=dtype)
        self.output_norm = LayerNormFP32(h, cfg.layer_norm_eps, device=device)
        self.attn_dropout = Dropout(cfg.dropout)
        self.dropout = Dropout(cfg.dropout)

    def forward(self, x, kv_states=None, kv_mask=None, causal=False):
        cfg = self.cfg
        head_dim = cfg.hidden_size // cfg.num_heads
        kv = kv_states if kv_states is not None else x
        b, n, _ = x.shape
        m = kv.shape[1]
        q = self.query(x).reshape(b, n, cfg.num_heads, head_dim)
        k = self.key(kv).reshape(b, m, cfg.num_heads, head_dim)
        v = self.value(kv).reshape(b, m, cfg.num_heads, head_dim)
        mask = None
        if kv_mask is not None:
            mask = kv_mask.bool()[:, None, None, :]
        if causal:
            tri = torch.tril(torch.ones(n, m, dtype=torch.bool, device=x.device))[None, None]
            mask = tri if mask is None else mask & tri
        out = dot_product_attention(q, k, v, mask=mask,
                                    dropout_rate=self.attn_dropout.active_rate,
                                    generator=self.attn_dropout.generator)
        out = self.dropout(self.output(out.reshape(b, n, cfg.hidden_size)))
        return self.output_norm(x + out)


class _BertLayer(nn.Module):
    def __init__(self, cfg: MedConfig, cross: bool, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.attention = _BertAttention(cfg, cfg.hidden_size, **kw)
        if cross:
            self.crossattention = _BertAttention(cfg, cfg.encoder_width, **kw)
        self.intermediate = Dense(cfg.hidden_size, cfg.intermediate_size, **kw)
        self.output = Dense(cfg.intermediate_size, cfg.hidden_size, **kw)
        self.ffn_norm = LayerNormFP32(cfg.hidden_size, cfg.layer_norm_eps, device=device)
        self.dropout = Dropout(cfg.dropout)

    def forward(self, x, text_mask=None, image_states=None, image_mask=None, causal=False):
        x = self.attention(x, kv_mask=text_mask, causal=causal)
        if image_states is not None:
            x = self.crossattention(x, kv_states=image_states, kv_mask=image_mask)
        h = self.output(F.gelu(self.intermediate(x)))
        return self.ffn_norm(x + self.dropout(h))


class _Embed(nn.Module):
    """A (rows, width) fp32 table read in the compute dtype."""

    def __init__(self, rows: int, width: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(rows, width, device=device))

    def forward(self, ids):
        return self.weight[ids]


class MedModel(nn.Module):
    """BERT stack; returns all hidden states (B, N, H)."""

    def __init__(self, cfg: MedConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = dtype or torch.get_default_dtype()
        self.word_embeddings = _Embed(cfg.vocab_size, cfg.hidden_size, device=device)
        self.position_embeddings = _Embed(cfg.max_position_embeddings, cfg.hidden_size,
                                          device=device)
        self.embeddings_norm = LayerNormFP32(cfg.hidden_size, cfg.layer_norm_eps,
                                             device=device)
        self.dropout = Dropout(cfg.dropout)
        first_cross = cfg.fusion_layer or 0
        self.layer = nn.ModuleList([_BertLayer(cfg, i >= first_cross, device=device,
                                               dtype=dtype)
                                    for i in range(cfg.num_layers)])

    def forward(self, text_ids, text_mask=None, image_states=None, image_mask=None,
                mode="text", input_embeds=None):
        """``mode``: "text" runs layers [0, fusion_layer); "fusion" runs
        [fusion_layer, num_layers) over ``input_embeds`` (the text-mode
        output: ALBEF continues the same BERT stack) with cross-attention;
        "multimodal" / "decoder" run the whole stack. ``image_states`` may
        be a (states0, states1) pair (NLVR): the memory alternates by layer
        parity."""
        cfg = self.cfg
        assert mode in ("text", "multimodal", "decoder", "fusion")
        fusion = cfg.fusion_layer if cfg.fusion_layer is not None else cfg.num_layers
        if mode == "fusion":
            assert input_embeds is not None, ("fusion mode continues from the text-mode "
                                              "hidden states")
            x = input_embeds.to(self.compute_dtype)
            start_layer, end_layer = fusion, cfg.num_layers
        else:
            pos = torch.arange(text_ids.shape[1], device=text_ids.device)
            x = (self.word_embeddings(text_ids.long()) + self.position_embeddings(pos))
            x = self.dropout(self.embeddings_norm(x.to(self.compute_dtype)))
            start_layer = 0
            end_layer = fusion if mode == "text" else cfg.num_layers
        use_image = mode in ("multimodal", "decoder", "fusion") and image_states is not None
        paired = use_image and isinstance(image_states, (tuple, list))
        for i in range(start_layer, end_layer):
            if paired:
                states_i = image_states[i % 2]
                mask_i = (image_mask[i % 2] if isinstance(image_mask, (tuple, list))
                          else image_mask)
            else:
                states_i = image_states if use_image else None
                mask_i = image_mask
            x = self.layer[i](x, text_mask=text_mask, image_states=states_i,
                              image_mask=mask_i, causal=mode == "decoder")
        return x


class MedLMHead(nn.Module):
    """BERT LM prediction head (dense -> exact GELU -> LayerNorm -> vocab
    logits, fp32)."""

    def __init__(self, cfg: MedConfig, device=None, dtype=None):
        super().__init__()
        self.transform = Dense(cfg.hidden_size, cfg.hidden_size, device=device, dtype=dtype)
        self.transform_norm = LayerNormFP32(cfg.hidden_size, cfg.layer_norm_eps,
                                            device=device)
        self.decoder = Dense(cfg.hidden_size, cfg.vocab_size, device=device, dtype=dtype)

    def forward(self, hidden):
        h = self.transform_norm(F.gelu(self.transform(hidden)))
        return self.decoder(h).float()
