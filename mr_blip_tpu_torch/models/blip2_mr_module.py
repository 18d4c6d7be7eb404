"""Device-side BLIP2-MR graph (counterpart of
``mr_blip_tpu/models/blip2_mr_module.py``).

Frozen EVA ViT over every frame, fp32 vision LayerNorm, Q-Former (32 query
tokens per frame), the Q-Former->T5 projection, the interleaved prompt
gather, and the T5 encoder-decoder. String work happens in the host
wrapper (:mod:`mr_blip_tpu_torch.models.blip2_mr`).

Under a QA task the module holds a second T5, ``answerer_t5``: the JAX
package keeps a second parameter tree for the answerer and reads only its
``t5`` subtree (vision and Q-Former come from the main tree), so here it is
a second ``T5ForConditionalGeneration`` beside ``t5`` (the localizer's).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mr_blip_tpu_torch.models.eva_vit import EvaViT, ViTConfig
from mr_blip_tpu_torch.models.layers import Dense, LayerNormFP32
from mr_blip_tpu_torch.models.prompt_assembly import interleave_on_device
from mr_blip_tpu_torch.models.qformer import QFormer, QFormerConfig
from mr_blip_tpu_torch.models.t5 import (
    T5Config,
    T5ForConditionalGeneration,
    cross_entropy_lm_loss,
    shift_right,
)

# CLIP normalization of the reference processors (mr_blip_tpu's
# processors/video_processors.py).
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def clip_normalize(frames: torch.Tensor, dtype) -> torch.Tensor:
    """uint8 frames -> CLIP-normalized in ``dtype`` on their device, as the
    JAX package does on device; float frames (already normalized by the
    processor) are returned as they are."""
    if frames.dtype != torch.uint8:
        return frames
    mean = torch.tensor(CLIP_MEAN, dtype=dtype, device=frames.device) * 255.0
    std = torch.tensor(CLIP_STD, dtype=dtype, device=frames.device) * 255.0
    return (frames.to(dtype) - mean) / std


def _pad_seq_to_sublane(inputs_embeds, attn, mult: int = 8):
    """Right-pad the assembled encoder sequence to a multiple of ``mult``.

    The padded positions carry ``attn == 0``, so they are masked out of
    encoder self-attention and decoder cross-attention. Kept from the JAX
    package so the two produce sequences of the same length, which the
    per-length encoder bias cache keys on."""
    pad = (-inputs_embeds.shape[1]) % mult
    if pad:
        inputs_embeds = F.pad(inputs_embeds, (0, 0, 0, pad))
        attn = F.pad(attn, (0, pad))
    return inputs_embeds, attn


class Blip2MRModule(nn.Module):
    def __init__(self, vit_config: ViTConfig, qformer_config: QFormerConfig,
                 t5_config: T5Config, compute_dtype=torch.bfloat16, device=None,
                 with_answerer: bool = False):
        super().__init__()
        self.vit_config = vit_config
        self.qformer_config = qformer_config
        self.t5_config = t5_config
        self.compute_dtype = compute_dtype
        kw = dict(device=device, dtype=compute_dtype)
        self.visual_encoder = EvaViT(vit_config, **kw)
        # torch nn.LayerNorm default eps (the reference's LayerNorm subclass).
        self.ln_vision = LayerNormFP32(vit_config.embed_dim, 1e-5, device=device)
        self.qformer = QFormer(qformer_config, **kw)
        self.t5_proj = Dense(qformer_config.hidden_size, t5_config.d_model, **kw)
        self.t5 = T5ForConditionalGeneration(t5_config, **kw)
        if with_answerer:
            self.answerer_t5 = T5ForConditionalGeneration(t5_config, **kw)

    def rebuild_submodule(self, name: str, config, state_dict) -> None:
        """Replace ``visual_encoder``, ``qformer``, ``t5`` or ``answerer_t5``
        by one built from ``config`` (the same config with an int8 flag set)
        holding ``state_dict`` (the converted weights), frozen and in eval
        mode. The old submodule is dropped before the new one is built, so
        the weights it alone held (those ``state_dict`` replaced) are freed
        first."""
        cls, cfg_attr = {"visual_encoder": (EvaViT, "vit_config"),
                         "qformer": (QFormer, "qformer_config"),
                         "t5": (T5ForConditionalGeneration, "t5_config"),
                         "answerer_t5": (T5ForConditionalGeneration, "t5_config"),
                         }[name]
        device = next(getattr(self, name).parameters()).device
        setattr(self, name, None)
        new = cls(config, device=device, dtype=self.compute_dtype)
        new.load_state_dict(state_dict, strict=True)
        new.requires_grad_(False)
        setattr(self, name, new.train(self.training))
        setattr(self, cfg_attr, config)

    @property
    def tokens_per_frame(self) -> int:
        return self.qformer_config.num_query_tokens

    def encode_frames(self, frames: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, C) frames -> (B, T*n, d_model) T5 tokens.

        uint8 frames are CLIP-normalized here, in the compute dtype, as the
        JAX package does on device. The ViT is frozen and runs without
        building a graph (the JAX package's stop-gradient on its output)."""
        b, t = frames.shape[:2]
        frames = clip_normalize(frames, self.compute_dtype)
        flat = frames.reshape((b * t,) + frames.shape[2:])
        with torch.no_grad():
            image_embeds = self.visual_encoder(flat)
        image_embeds = self.ln_vision(image_embeds)
        q = self.t5_proj(self.qformer(image_embeds))
        return q.reshape(b, t * q.shape[1], self.t5_config.d_model)

    def assemble_encoder_input(self, frames_for_t5, time_ids, src_type, src_idx,
                               int_mask, end_ids, end_mask, text_ids, text_mask):
        """[interleaved video prompt | video_prompt_end | query+task prompt]."""
        embed = self.t5.shared
        dtype = frames_for_t5.dtype
        pad_id = torch.tensor(self.t5_config.pad_token_id, device=time_ids.device)
        inter = interleave_on_device(frames_for_t5, embed(time_ids).to(dtype),
                                     src_type, src_idx, embed(pad_id))
        inputs_embeds = torch.cat(
            [inter, embed(end_ids).to(dtype), embed(text_ids).to(dtype)], dim=1)
        attn = torch.cat([int_mask, end_mask, text_mask], dim=1)
        return _pad_seq_to_sublane(inputs_embeds, attn)

    def qa_encoder_input(self, frames_for_t5, text_ids, text_mask, t5=None):
        """The answerer's layout: [frame tokens | question + options], the
        text embedded by ``t5`` (default: ``self.t5``)."""
        embed = (t5 or self.t5).shared
        text_embs = embed(text_ids).to(frames_for_t5.dtype)
        frames_mask = torch.ones(frames_for_t5.shape[:2], dtype=text_mask.dtype,
                                 device=text_mask.device)
        inputs_embeds = torch.cat([frames_for_t5, text_embs], dim=1)
        attn = torch.cat([frames_mask, text_mask], dim=1)
        return _pad_seq_to_sublane(inputs_embeds, attn)

    def encode(self, inputs_embeds, attn_mask, position_bias=None, t5=None):
        return (t5 or self.t5).encode(inputs_embeds, mask=attn_mask,
                                      position_bias=position_bias)

    def loss_from_encoder_input(self, inputs_embeds, attn_mask, target_ids,
                                target_mask, position_bias=None, t5=None):
        """Teacher-forced span LM loss -> (loss, fp32 logits): pad targets
        become -100 labels, the decoder input is the labels shifted right.
        ``t5``: the stack to run (default: ``self.t5``)."""
        t5 = t5 or self.t5
        cfg = self.t5_config
        labels = torch.where(target_ids == cfg.pad_token_id,
                             torch.full_like(target_ids, -100), target_ids)
        decoder_input_ids = shift_right(labels, cfg.decoder_start_token_id,
                                        cfg.pad_token_id)
        enc = t5.encode(inputs_embeds, mask=attn_mask,
                        position_bias=position_bias)
        logits = t5.decode(decoder_input_ids, enc, decoder_mask=target_mask,
                           encoder_mask=attn_mask)
        return cross_entropy_lm_loss(logits, labels, target_mask), logits
