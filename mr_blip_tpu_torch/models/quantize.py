"""int8 quantization of float weights for inference (counterpart of
``mr_blip_tpu/models/quantize.py``).

Every function takes the ``state_dict`` of a float module and returns the
``state_dict`` of the same module built with its int8 flag set
(``ViTConfig.int8_matmul``, ``QFormerConfig.int8_cross``,
``T5Config.int8_encoder`` / ``int8_decode`` / ``int8_base``); the input is
not modified.
Symmetric, round half to even, one scale per output channel, computed in
fp32 from the stored weight (frozen weights are stored in bf16 on the card):

    scale[o] = max(max_i |w[i, o]|, 1e-8) / 127      wq = round(w / scale)

A quantized weight is ``kernel_q`` int8 of shape (in, out), as in JAX, stored
with the input axis contiguous (the layout the W8A8 kernels read), beside
``kernel_scale`` fp32 (out,). LoRA deltas stay float beside a weight-only
int8 ``Dense`` and are merged into the weight where a W8A8 kernel takes the
whole weight (the T5 encoder). Norms, embeddings, biases and the rel-pos
tables stay float.
"""

from __future__ import annotations

import re
from typing import Dict

import torch

from mr_blip_tpu_torch.ops.int8_matmul import div_exact, k_major

StateDict = Dict[str, torch.Tensor]


def _quantize_in_out(w: torch.Tensor):
    """fp32 (in, out) -> (kernel_q, kernel_scale)."""
    scale = div_exact(w.abs().amax(dim=0).clamp_min(1e-8), 127.0)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return k_major(q), scale


def _merged_float_kernel(sd: StateDict, prefix: str, lora_alpha: float) -> torch.Tensor:
    """The (in, out) fp32 weight of the Dense at ``prefix`` with its LoRA
    delta merged: ``w + lora_a @ lora_b * (alpha / rank)``."""
    w = sd[prefix + "weight"].float().t()
    if prefix + "lora_a" in sd:
        a, b = sd[prefix + "lora_a"].float(), sd[prefix + "lora_b"].float()
        w = w + (a @ b) * (lora_alpha / a.shape[-1])
    return w


def quantize_dense(sd: StateDict, prefix: str, bias_fp32: bool = False) -> None:
    """In ``sd``, replace ``<prefix>weight`` (out, in) by ``kernel_q`` and
    ``kernel_scale``; the bias and the LoRA tensors stay (``bias_fp32``: the
    bias is upcast for a W8A8 kernel, which adds it in fp32)."""
    q, scale = _quantize_in_out(sd.pop(prefix + "weight").float().t())
    sd[prefix + "kernel_q"], sd[prefix + "kernel_scale"] = q, scale
    if bias_fp32 and prefix + "bias" in sd:
        sd[prefix + "bias"] = sd[prefix + "bias"].float()


def merge_quantize_dense(sd: StateDict, prefix: str, lora_alpha: float = 8.0) -> None:
    """As ``quantize_dense`` with the LoRA delta merged into the quantized
    weight and its tensors dropped (the same function as base + delta)."""
    q, scale = _quantize_in_out(_merged_float_kernel(sd, prefix, lora_alpha))
    for leaf in ("weight", "lora_a", "lora_b"):
        sd.pop(prefix + leaf, None)
    sd[prefix + "kernel_q"], sd[prefix + "kernel_scale"] = q, scale
    if prefix + "bias" in sd:
        sd[prefix + "bias"] = sd[prefix + "bias"].float()


def _dense_prefixes(sd: StateDict, pattern: str):
    """Prefixes (with the trailing dot) of the Dense layers whose weight key
    matches ``pattern``."""
    rx = re.compile(pattern + r"weight$")
    return [key[:-len("weight")] for key in list(sd) if rx.match(key)]


def quantize_vit_params(vit_sd: StateDict) -> StateDict:
    """Float ``EvaViT`` weights -> those of ``ViTConfig(int8_matmul=True)``:
    every block's qkv, proj, fc1 and fc2 int8 (W8A8: the activations are
    quantized per token inside the kernels). patch_embed, cls_token,
    pos_embed, the LayerNorms and the q/v biases stay float."""
    out = dict(vit_sd)
    for prefix in _dense_prefixes(out, r"blocks\.\d+\.(attn\.(qkv|proj)|mlp\.fc[12])\."):
        quantize_dense(out, prefix, bias_fp32=True)
    return out


_T5_DENSE = r"(self_attention|cross_attention)\.[qkvo]\.|ff\.(wi|wi_0|wi_1|wo)\."


def quantize_t5_decoder_params(t5_sd: StateDict) -> StateDict:
    """Float T5 weights -> those of ``T5Config(int8_decode=True)``: every
    decoder-block Dense and the LM head weight-only int8 (their LoRA deltas
    stay float); encoder, embedding, norms and rel-pos tables untouched."""
    out = dict(t5_sd)
    for prefix in _dense_prefixes(out, r"decoder\.block\.\d+\.(" + _T5_DENSE + ")"):
        quantize_dense(out, prefix)
    if "lm_head.weight" in out:
        quantize_dense(out, "lm_head.")
    return out


def quantize_t5_params(t5_sd: StateDict) -> StateDict:
    """Float T5 weights -> those of ``T5Config(int8_base=True)``, the
    QLoRA-style training layout (a frozen int8 base under float LoRA): every
    encoder- and decoder-block Dense and the LM head weight-only int8; the
    LoRA deltas, the shared embedding, the norms and the rel-pos tables
    untouched."""
    out = dict(t5_sd)
    for prefix in _dense_prefixes(out, r"(en|de)coder\.block\.\d+\.(" + _T5_DENSE + ")"):
        quantize_dense(out, prefix)
    if "lm_head.weight" in out:
        quantize_dense(out, "lm_head.")
    return out


def quantize_t5_encoder_params(t5_sd: StateDict, lora_alpha: float = 8.0) -> StateDict:
    """Float T5 weights -> those of ``T5Config(int8_encoder=True)``: every
    encoder-block projection and gated-FFN weight int8 with the LoRA delta
    merged in (W8A8). q, k and v are concatenated into one (d, 3 * inner)
    ``qkv_packed`` weight: the scales are per output channel, so
    concatenate-then-quantize equals quantize-then-concatenate."""
    out = dict(t5_sd)
    blocks = sorted({m.group(0) for key in out
                     if (m := re.match(r"encoder\.block\.\d+\.", key))})
    for block in blocks:
        attn = block + "self_attention."
        w = torch.cat([_merged_float_kernel(out, attn + f"{d}.", lora_alpha)
                       for d in "qkv"], dim=1)
        for d in "qkv":
            for leaf in ("weight", "lora_a", "lora_b"):
                out.pop(attn + f"{d}.{leaf}", None)
        out[attn + "qkv_packed.kernel_q"], out[attn + "qkv_packed.kernel_scale"] = (
            _quantize_in_out(w))
        merge_quantize_dense(out, attn + "o.", lora_alpha)
        for prefix in _dense_prefixes(out, re.escape(block) + r"ff\.(wi|wi_0|wi_1|wo)\."):
            merge_quantize_dense(out, prefix, lora_alpha)
    return out


def quantize_qformer_cross_params(qf_sd: StateDict) -> StateDict:
    """Float ``QFormer`` weights -> those of ``QFormerConfig(int8_cross=
    True)``: each cross-attention layer's key and value Dense packed into one
    int8 ``kv_packed`` weight with the concatenated fp32 bias. Everything
    else stays float."""
    out = dict(qf_sd)
    for prefix in _dense_prefixes(out, r"layer\.\d+\.cross_attention\.key\."):
        cross = prefix[:-len("key.")]
        w = torch.cat([out.pop(cross + f"{d}.weight").float().t()
                       for d in ("key", "value")], dim=1)
        bias = torch.cat([out.pop(cross + f"{d}.bias").float()
                          for d in ("key", "value")])
        q, scale = _quantize_in_out(w)
        out[cross + "kv_packed.kernel_q"] = q
        out[cross + "kv_packed.kernel_scale"] = scale
        out[cross + "kv_packed.bias"] = bias
    return out
