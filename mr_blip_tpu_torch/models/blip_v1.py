"""BLIP v1: captioning, retrieval, VQA and NLVR over the MED backbone (the
port's counterpart of ``mr_blip_tpu/models/blip_v1.py``).

The reference BLIP-v1 family (``lavis/models/blip_models/``): a ViT image
encoder with the MED text stack in its modes,

* retrieval: ITC features + the ITM head (shared with ALBEF's recipe)
* captioning: the causal MED decoder with its LM head
* VQA: the question encoded multimodally, the answer decoded over it
* NLVR: two images' tokens concatenated for the cross-attention.

One module, the whole method surface of the JAX one; the zoo wrappers
(``models/zoo_wrappers.py``) and the later BLIP families call it. The
decoding drivers live in the wrappers (MED has no KV cache: a decode step
reruns the decoder over the short caption buffer).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from mr_blip_tpu_torch.models.layers import Dense
from mr_blip_tpu_torch.models.med import MedConfig, MedLMHead, MedModel, med_tiny_config
from mr_blip_tpu_torch.models.t5 import cross_entropy_lm_loss
from mr_blip_tpu_torch.models.vit import BaseViTConfig, VisionTransformer


@dataclasses.dataclass(frozen=True)
class BLIPConfig:
    embed_dim: int = 256
    vision: BaseViTConfig = dataclasses.field(default_factory=BaseViTConfig)
    text: MedConfig = dataclasses.field(default_factory=MedConfig)
    temp: float = 0.07
    # >0 adds a classification head over the fused cls (reference
    # blip_classification.py cls_head; SNLI-VE uses 3)
    num_classes: int = 0


def blip_base_config() -> BLIPConfig:
    return BLIPConfig()


def blip_tiny_config() -> BLIPConfig:
    return BLIPConfig(
        embed_dim=16,
        vision=BaseViTConfig(img_size=28, patch_size=14, embed_dim=32, depth=2,
                             num_heads=2),
        text=med_tiny_config(encoder_width=32),
    )


def _l2(f: torch.Tensor) -> torch.Tensor:
    return f / torch.linalg.vector_norm(f.float(), dim=-1, keepdim=True)


class BLIPv1(nn.Module):
    def __init__(self, cfg: BLIPConfig, device=None, dtype=None):
        super().__init__()
        self.config = cfg
        kw = dict(device=device, dtype=dtype)
        self.visual_encoder = VisionTransformer(cfg.vision, **kw)
        self.text_encoder = MedModel(cfg.text, **kw)
        self.text_decoder = MedModel(cfg.text, **kw)
        self.lm_head = MedLMHead(cfg.text, **kw)
        self.vision_proj = Dense(cfg.vision.embed_dim, cfg.embed_dim, **kw)
        self.text_proj = Dense(cfg.text.hidden_size, cfg.embed_dim, **kw)
        self.itm_head = Dense(cfg.text.hidden_size, 2, **kw)
        if cfg.num_classes > 0:
            self.cls_head = Dense(cfg.text.hidden_size, cfg.num_classes, **kw)

    def classify(self, images, text_ids, text_mask=None):
        """Fused-cls classification (reference blip_classification.py)."""
        assert self.config.num_classes > 0
        fused = self.question_states(images, text_ids, text_mask)
        return self.cls_head(fused[:, 0]).float()

    # ------------------------------------------------------ tower pieces
    def encode_image(self, images):
        """All visual tokens (B, N, H): computed once, reused by the beam
        decode loop and the ITM reranking."""
        return self.visual_encoder(images)

    def image_feat(self, images):
        """L2-normalized ITC image feature (B, embed_dim)."""
        return self.image_feat_from_states(self.visual_encoder(images))

    def image_feat_from_states(self, image_states):
        """``image_feat`` over precomputed visual tokens."""
        return _l2(self.vision_proj(image_states[:, 0]))

    def text_feat(self, text_ids, text_mask=None):
        """L2-normalized ITC text feature (B, embed_dim)."""
        return _l2(self.text_proj(
            self.text_encoder(text_ids, text_mask=text_mask, mode="text")[:, 0]))

    def itm_logits_from_states(self, image_states, text_ids, text_mask=None):
        """ITM head over precomputed visual tokens (the rerank stage: one
        image's tokens score many candidate texts without rerunning the ViT)."""
        fused = self.text_encoder(text_ids, text_mask=text_mask, image_states=image_states,
                                  mode="multimodal")
        return self.itm_head(fused[:, 0])

    # ---------------------------------------------------------- retrieval
    def itc_features(self, images, text_ids, text_mask=None):
        return self.image_feat(images), self.text_feat(text_ids, text_mask)

    def itm_logits(self, images, text_ids, text_mask=None):
        return self.itm_logits_from_states(self.visual_encoder(images), text_ids, text_mask)

    # --------------------------------------------------------- captioning
    def caption_loss(self, images, caption_ids, caption_mask):
        """Teacher-forced LM loss; token 0 is the [DEC] prompt token."""
        image_states = self.visual_encoder(images)
        hidden = self.text_decoder(caption_ids[:, :-1], text_mask=caption_mask[:, :-1],
                                   image_states=image_states, mode="decoder")
        logits = self.lm_head(hidden)
        labels = torch.where(caption_mask[:, 1:] == 1, caption_ids[:, 1:],
                             torch.full_like(caption_ids[:, 1:], -100))
        return cross_entropy_lm_loss(logits, labels, caption_mask[:, 1:])

    def caption_step_logits(self, images, prefix_ids):
        """Logits of the next token after ``prefix_ids``."""
        image_states = self.visual_encoder(images)
        hidden = self.text_decoder(prefix_ids, image_states=image_states, mode="decoder")
        return self.lm_head(hidden)[:, -1]

    def caption_step_logits_at(self, images, buffer_ids, pos: int):
        """Next-token logits at ``pos`` of a fixed-size buffer (the causal
        mask ignores the tail not yet written)."""
        return self.caption_logits_from_states(self.visual_encoder(images), buffer_ids, pos)

    def caption_logits_from_states(self, image_states, buffer_ids, pos: int):
        """``caption_step_logits_at`` over precomputed visual tokens (the
        beam-search decode step: the ViT runs once, the beams share the
        expanded states)."""
        hidden = self.text_decoder(buffer_ids, image_states=image_states, mode="decoder")
        return self.lm_head(hidden[:, pos])

    # ---------------------------------------------------------------- VQA
    def vqa_answer_loss(self, images, question_ids, question_mask, answer_ids,
                        answer_mask):
        q_states = self.question_states(images, question_ids, question_mask)
        hidden = self.text_decoder(answer_ids[:, :-1], text_mask=answer_mask[:, :-1],
                                   image_states=q_states, image_mask=question_mask,
                                   mode="decoder")
        logits = self.lm_head(hidden)
        labels = torch.where(answer_mask[:, 1:] == 1, answer_ids[:, 1:],
                             torch.full_like(answer_ids[:, 1:], -100))
        return cross_entropy_lm_loss(logits, labels, answer_mask[:, 1:])

    def extract_features(self, images=None, text_ids=None, text_mask=None,
                         mode="multimodal"):
        """Reference ``blip_feature_extractor.extract_features``: "image" ->
        {image_embeds, image_embeds_proj}; "text" -> {text_embeds,
        text_embeds_proj}; "multimodal" -> {multimodal_embeds}; the
        projected features are L2-normalized ITC vectors."""
        assert mode in ("image", "text", "multimodal")
        out = {}
        if mode == "image":
            states = self.visual_encoder(images)
            out["image_embeds"] = states
            out["image_embeds_proj"] = self.image_feat_from_states(states)
        elif mode == "text":
            states = self.text_encoder(text_ids, text_mask=text_mask, mode="text")
            out["text_embeds"] = states
            out["text_embeds_proj"] = _l2(self.text_proj(states[:, 0]))
        else:
            out["multimodal_embeds"] = self.text_encoder(
                text_ids, text_mask=text_mask, image_states=self.visual_encoder(images),
                mode="multimodal")
        return out

    def pretrain_states(self, images, text_ids, text_mask=None):
        """(image_states, img_feat, txt_feat): the shared encoder pass of the
        pretraining objective (ALBEF's surface)."""
        image_states = self.visual_encoder(images)
        return (image_states, self.image_feat_from_states(image_states),
                self.text_feat(text_ids, text_mask))

    def itm_logits_with_states(self, image_states, text_ids, text_mask=None):
        """ALBEF's name for ``itm_logits_from_states``."""
        return self.itm_logits_from_states(image_states, text_ids, text_mask)

    def question_states(self, images, question_ids, question_mask=None):
        """Fused question representation (the surface the two-stage VQA
        answer ranking reads)."""
        return self.text_encoder(question_ids, text_mask=question_mask,
                                 image_states=self.visual_encoder(images), mode="multimodal")

    def answer_logits(self, q_states, q_mask, answer_ids, answer_mask=None):
        hidden = self.text_decoder(answer_ids, text_mask=answer_mask, image_states=q_states,
                                   image_mask=q_mask, mode="decoder")
        return self.lm_head(hidden)

    # --------------------------------------------------------------- NLVR
    def nlvr_logits(self, images_a, images_b, text_ids, text_mask=None):
        """Two-image reasoning: cross-attend to both images' tokens."""
        states = torch.cat([self.visual_encoder(images_a), self.visual_encoder(images_b)],
                           dim=1)
        return self.itm_logits_from_states(states, text_ids, text_mask)

    def forward(self, images, text_ids, text_mask=None):
        img_f, txt_f = self.itc_features(images, text_ids, text_mask)
        sims = img_f @ txt_f.T / self.config.temp
        itc = itc_loss(sims)
        lm = self.caption_loss(images, text_ids, text_mask if text_mask is not None
                               else torch.ones_like(text_ids))
        return {"itc_loss": itc, "lm_loss": lm,
                "itm_logits": self.itm_logits(images, text_ids, text_mask)}


def itc_loss(sims: torch.Tensor) -> torch.Tensor:
    """Symmetric in-batch contrastive loss of an (N, N) similarity matrix."""
    labels = torch.arange(sims.shape[0], device=sims.device)
    return (torch.nn.functional.cross_entropy(sims, labels)
            + torch.nn.functional.cross_entropy(sims.T, labels)) / 2
