"""ALBEF: the align-before-fuse image-text model (the port's counterpart of
``mr_blip_tpu/models/albef.py``).

The reference ALBEF family (``lavis/models/albef_models/``): the ViT of
``models/vit.py`` and the BERT text encoder of ``models/med.py`` with
cross-attention fusion, trained with the ALBEF objectives:

* ITC: image-text contrastive over the projected cls features, with
  momentum distillation and feature queues (``albef_pretrain_losses``,
  albef_pretrain.py:105-310); ``forward`` keeps the in-batch form of the
  evaluation paths;
* ITM: the image-text matching head on the fused cls token, with
  hard-negative mining in the pretraining objective;
* MLM is the MED LM head's.

The heads for NLVR (``AlbefNLVR``, also SNLI-VE's single-image classifier)
and VQA (``AlbefVQA``, with ``rank_answers``) follow. The modules compute
in ``dtype`` (bf16 by default, as the JAX modules: ``LayerNormFP32`` then
takes kernel 1 on the card); the zoo wrappers run them in fp32.

Random draws: JAX draws the queues and the hard negatives from its keys;
here they come from an explicit ``torch.Generator`` (``init_momentum_state``,
``albef_pretrain_losses``), so the two packages draw different values from
the same seed. ``albef_pretrain_losses`` takes the negatives' indices as an
argument too (``neg_idx``), and a converted JAX state carries JAX's queues.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mr_blip_tpu_torch.common.registry import registry
from mr_blip_tpu_torch.models.layers import Dense
from mr_blip_tpu_torch.models.med import MedConfig, MedLMHead, MedModel, med_tiny_config
from mr_blip_tpu_torch.models.t5 import cross_entropy_lm_loss
from mr_blip_tpu_torch.models.vit import BaseViTConfig, VisionTransformer


@dataclasses.dataclass(frozen=True)
class ALBEFConfig:
    embed_dim: int = 256
    vision: BaseViTConfig = dataclasses.field(default_factory=BaseViTConfig)
    text: MedConfig = dataclasses.field(default_factory=MedConfig)
    temp: float = 0.07


def albef_base_config() -> ALBEFConfig:
    # med_config_albef.json: 12 layers split at fusion_layer 6: layers 0-5
    # are the text encoder, 6-11 the multimodal fusion encoder
    return ALBEFConfig(text=MedConfig(vocab_size=30522, fusion_layer=6))


def albef_tiny_config() -> ALBEFConfig:
    return ALBEFConfig(
        embed_dim=16,
        vision=BaseViTConfig(img_size=28, patch_size=14, embed_dim=32, depth=2,
                             num_heads=2),
        text=med_tiny_config(encoder_width=32),
    )


def _every_layer_cross(text: MedConfig) -> MedConfig:
    """The MED config of a stack that only runs "multimodal" or "decoder"
    (NLVR, VQA): every layer cross-attends whatever ``fusion_layer`` says,
    as the JAX stacks create a cross-attention in each layer that runs one."""
    return dataclasses.replace(text, fusion_layer=None)


def _l2(f: torch.Tensor) -> torch.Tensor:
    return f / torch.linalg.vector_norm(f.float(), dim=-1, keepdim=True)


@registry.register_model("albef_feature_extractor")
class ALBEF(nn.Module):
    def __init__(self, config: ALBEFConfig, device=None, dtype=torch.bfloat16):
        super().__init__()
        cfg = self.config = config
        kw = dict(device=device, dtype=dtype)
        self.visual_encoder = VisionTransformer(cfg.vision, **kw)
        self.text_encoder = MedModel(cfg.text, **kw)
        self.vision_proj = Dense(cfg.vision.embed_dim, cfg.embed_dim, **kw)
        self.text_proj = Dense(cfg.text.hidden_size, cfg.embed_dim, **kw)
        self.itm_head = Dense(cfg.text.hidden_size, 2, **kw)

    def encode_image(self, images):
        return self.visual_encoder(images)  # (B, 1+P, D)

    def encode_text(self, text_ids, text_mask=None):
        return self.text_encoder(text_ids, text_mask=text_mask, mode="text")

    def itc_features(self, images, text_ids, text_mask=None):
        """L2-normalized contrastive features for both modalities."""
        return self.image_feat(images), self.text_feat(text_ids, text_mask)

    def image_feat(self, images):
        """L2-normalized ITC image feature (the retrieval wrapper's surface)."""
        return self.image_feat_from_states(self.encode_image(images))

    def image_feat_from_states(self, image_states):
        return _l2(self.vision_proj(image_states[:, 0]))

    def text_feat(self, text_ids, text_mask=None):
        return _l2(self.text_proj(self.encode_text(text_ids, text_mask)[:, 0]))

    def itm_logits_from_states(self, image_states, text_ids, text_mask=None):
        """The BLIP retrieval wrapper's name for ``itm_logits_with_states``."""
        return self.itm_logits_with_states(image_states, text_ids, text_mask)

    def itm_logits(self, images, text_ids, text_mask=None):
        """Image-text matching logits from the fused cls token."""
        return self.itm_logits_with_states(self.encode_image(images), text_ids, text_mask)

    def fused_states(self, image_states, text_ids, text_mask=None):
        """Multimodal hidden states. With ``fusion_layer`` set (ALBEF: 6)
        the reference's two-stage pass: text layers [0, 6), then fusion
        layers [6, 12) cross-attending from the text output
        (albef_pretrain.py mode="text" + mode="fusion"); otherwise every
        layer cross-attends (BLIP's behaviour)."""
        if self.config.text.fusion_layer is not None:
            h = self.text_encoder(text_ids, text_mask=text_mask, mode="text")
            return self.text_encoder(text_ids, text_mask=text_mask, image_states=image_states,
                                     mode="fusion", input_embeds=h)
        return self.text_encoder(text_ids, text_mask=text_mask, image_states=image_states,
                                 mode="multimodal")

    def itm_logits_with_states(self, image_states, text_ids, text_mask=None):
        """ITM over precomputed image states (the hard-negative pairing
        reuses gathered image token sets, albef_pretrain.py:236-274)."""
        return self.itm_head(self.fused_states(image_states, text_ids, text_mask)[:, 0])

    def pretrain_states(self, images, text_ids, text_mask=None):
        """(image_states, img_feat, txt_feat): one encoder pass shared by the
        ITC and ITM objectives."""
        image_states = self.encode_image(images)
        return (image_states, self.image_feat_from_states(image_states),
                self.text_feat(text_ids, text_mask))

    def extract_features(self, images=None, text_ids=None, text_mask=None,
                         mode="multimodal"):
        """The reference ``albef_feature_extractor`` surface (BLIP's
        contract): "image" / "text" return the raw states and the
        L2-normalized projected features; "multimodal" the fused hidden
        states, through the fusion_layer split when configured."""
        assert mode in ("image", "text", "multimodal")
        out = {}
        if mode == "image":
            states = self.encode_image(images)
            out["image_embeds"] = states
            out["image_embeds_proj"] = self.image_feat_from_states(states)
        elif mode == "text":
            states = self.encode_text(text_ids, text_mask)
            out["text_embeds"] = states
            out["text_embeds_proj"] = _l2(self.text_proj(states[:, 0]))
        else:
            out["multimodal_embeds"] = self.fused_states(self.encode_image(images), text_ids,
                                                         text_mask)
        return out

    def forward(self, images, text_ids, text_mask=None):
        """The evaluation objectives: the in-batch ITC loss and ITM logits."""
        img_f, txt_f = self.itc_features(images, text_ids, text_mask)
        sims = img_f @ txt_f.T / self.config.temp
        labels = torch.arange(sims.shape[0], device=sims.device)
        itc = (F.cross_entropy(sims, labels) + F.cross_entropy(sims.T, labels)) / 2
        return {"itc_loss": itc, "itm_logits": self.itm_logits(images, text_ids, text_mask),
                "sims": sims}


# ----------------------------------------------------------------------------
# ALBEF pretraining with momentum distillation and feature queues (reference
# albef_pretrain.py:105-310), as functions over an explicit momentum state:
# the EMA copy of the four subtrees' tensors by state_dict name, the two
# queues and the ring pointer.
# ----------------------------------------------------------------------------

MOMENTUM_SUBTREES = ("visual_encoder", "text_encoder", "vision_proj", "text_proj")


def _subtree_state(module: nn.Module, subtrees=MOMENTUM_SUBTREES) -> Dict[str, torch.Tensor]:
    return {k: v for k, v in module.state_dict(keep_vars=True).items()
            if subtrees is None or k.split(".")[0] in subtrees}


def init_momentum_state(module: nn.Module, embed_dim: int, queue_size: int = 1024,
                        generator: torch.Generator | None = None) -> Dict:
    """The EMA copy of the momentum subtrees, L2-normalized random feature
    queues (drawn from ``generator``) and the ring pointer."""
    dev = next(module.parameters()).device
    iq = torch.randn((queue_size, embed_dim), generator=generator, device=dev)
    tq = torch.randn((queue_size, embed_dim), generator=generator, device=dev)
    return {"m_params": {k: v.detach().float().clone()
                         for k, v in _subtree_state(module).items()},
            "image_queue": iq / torch.linalg.vector_norm(iq, dim=-1, keepdim=True),
            "text_queue": tq / torch.linalg.vector_norm(tq, dim=-1, keepdim=True),
            "queue_ptr": 0}


@torch.no_grad()
def _ema(m_tree: Dict[str, torch.Tensor], tree: Dict[str, torch.Tensor], momentum: float):
    return {k: m * momentum + tree[k].detach().to(m.dtype) * (1.0 - momentum)
            for k, m in m_tree.items()}


class _Method(nn.Module):
    """``module.<name>`` as a forward, so that ``torch.func.functional_call``
    can run it on other weights (the momentum copy)."""

    def __init__(self, module: nn.Module, name: str):
        super().__init__()
        self.module, self.name = module, name

    def forward(self, *args):
        return getattr(self.module, self.name)(*args)


@torch.no_grad()
def _call_with(module: nn.Module, weights: Dict[str, torch.Tensor], name: str, *args):
    """``module.<name>(*args)`` with ``weights`` (by state_dict name) in
    place of the module's own, which stay as they are."""
    own = module.state_dict()
    return torch.func.functional_call(
        _Method(module, name), {f"module.{k}": v.to(own[k].dtype) for k, v in weights.items()},
        args)


def _soft_ce(logits, targets):
    return -(targets * torch.log_softmax(logits, dim=-1)).sum(-1).mean()


def albef_pretrain_losses(module, state, images, text_ids, text_mask=None,
                          generator: torch.Generator | None = None, alpha: float = 0.4,
                          momentum: float = 0.995, neg_idx=None):
    """One evaluation of the ALBEF pretraining objective; returns (losses,
    new momentum state). As the reference:

    * the EMA momentum encoders refresh first (albef_pretrain.py:167);
    * ITC scores the batch against [momentum batch ‖ queue] features with
      targets alpha * softmax(momentum sims) + (1 - alpha) * one-hot;
    * hard-negative ITM: one negative text per image and one negative image
      per text, drawn (from ``generator``) from the in-batch similarity
      softmax with the diagonal masked (albef_pretrain.py:223-280), or
      given as ``neg_idx`` = (negative text per image, negative image per
      text); labels [1_B, 0_2B];
    * the queues ring-enqueue the momentum features (queue_size % B == 0).

    ``alpha`` carries the caller's ramp-up (``rampup_factor``). ``module``
    is an ``ALBEF`` or a ``BLIPv1`` (the same surface)."""
    b = images.shape[0]
    temp = module.config.temp
    new_m = _ema(state["m_params"], _subtree_state(module), momentum)
    image_states, img_f, txt_f = module.pretrain_states(images, text_ids, text_mask)
    _, img_f_m, txt_f_m = _call_with(module, new_m, "pretrain_states", images, text_ids,
                                     text_mask)
    img_f_m, txt_f_m = img_f_m.float(), txt_f_m.float()

    image_feat_all = torch.cat([img_f_m, state["image_queue"]], dim=0)
    text_feat_all = torch.cat([txt_f_m, state["text_queue"]], dim=0)
    sim_i2t = img_f.float() @ text_feat_all.T / temp  # (B, B + Q)
    sim_t2i = txt_f.float() @ image_feat_all.T / temp
    sim_i2t_m = img_f_m @ text_feat_all.T / temp
    sim_t2i_m = txt_f_m @ image_feat_all.T / temp
    onehot = F.one_hot(torch.arange(b, device=sim_i2t.device), sim_i2t.shape[1]).float()
    t_i2t = alpha * torch.softmax(sim_i2t_m, -1) + (1 - alpha) * onehot
    t_t2i = alpha * torch.softmax(sim_t2i_m, -1) + (1 - alpha) * onehot
    loss_itc = (_soft_ce(sim_i2t, t_i2t) + _soft_ce(sim_t2i, t_t2i)) / 2

    if neg_idx is None:  # hard negatives from the in-batch block, diagonal masked
        with torch.no_grad():
            eye = torch.eye(b, dtype=torch.bool, device=sim_i2t.device)
            neg_inf = torch.finfo(torch.float32).min
            w_i2t = torch.softmax(sim_i2t[:, :b].masked_fill(eye, neg_inf), -1)
            w_t2i = torch.softmax(sim_t2i[:, :b].masked_fill(eye, neg_inf), -1)
            neg_idx = (torch.multinomial(w_i2t, 1, generator=generator)[:, 0],
                       torch.multinomial(w_t2i, 1, generator=generator)[:, 0])
    neg_text_idx, neg_image_idx = (torch.as_tensor(np.array(i), device=images.device).long()
                                   for i in neg_idx)
    if text_mask is None:
        text_mask = torch.ones_like(text_ids)
    itm_logits = torch.cat([
        module.itm_logits_with_states(image_states, text_ids, text_mask),
        module.itm_logits_with_states(image_states, text_ids[neg_text_idx],
                                      text_mask[neg_text_idx]),
        module.itm_logits_with_states(image_states[neg_image_idx], text_ids, text_mask)])
    itm_labels = torch.cat([torch.ones(b, dtype=torch.long, device=images.device),
                            torch.zeros(2 * b, dtype=torch.long, device=images.device)])
    loss_itm = F.cross_entropy(itm_logits.float(), itm_labels)

    q = state["image_queue"].shape[0]
    ptr = int(state["queue_ptr"])
    image_queue, text_queue = state["image_queue"].clone(), state["text_queue"].clone()
    image_queue[ptr:ptr + b] = img_f_m
    text_queue[ptr:ptr + b] = txt_f_m
    new_state = {"m_params": new_m, "image_queue": image_queue, "text_queue": text_queue,
                 "queue_ptr": (ptr + b) % q}
    losses = {"loss_itc": loss_itc, "loss_itm": loss_itm, "loss": loss_itc + loss_itm}
    return losses, new_state


def rampup_factor(epoch, iters, num_iters_per_epoch):
    """The reference's alpha warmup: linear over the first epoch
    (albef_pretrain.py _rampup_factor)."""
    return min(1.0, (epoch * num_iters_per_epoch + iters) / num_iters_per_epoch)


@registry.register_model("albef_nlvr")
class AlbefNLVR(nn.Module):
    """ALBEF NLVR2 head (reference ``albef_models/albef_nlvr.py:24-220``):
    both images through the shared ViT; the text encoder cross-attends
    image 0 and image 1 in alternate layers (MED's pair mode, the
    functional equivalent of the reference's paired layers with shared
    k/v), in "multimodal" mode at every layer (no fusion split); a
    two-layer head scores the fused cls token."""

    def __init__(self, config: ALBEFConfig, device=None, dtype=torch.bfloat16,
                 num_classes: int = 2):
        super().__init__()
        cfg = self.config = config
        kw = dict(device=device, dtype=dtype)
        self.num_classes = num_classes  # NLVR true/false; SNLI-VE 3
        self.visual_encoder = VisionTransformer(cfg.vision, **kw)
        self.text_encoder = MedModel(_every_layer_cross(cfg.text), **kw)
        self.cls_hidden = Dense(cfg.text.hidden_size, cfg.text.hidden_size, **kw)
        self.cls_out = Dense(cfg.text.hidden_size, num_classes, **kw)

    def _head(self, fused):
        return self.cls_out(F.relu(self.cls_hidden(fused[:, 0]))).float()

    def forward(self, images0, images1, text_ids, text_mask=None):
        s0, s1 = self.visual_encoder(images0), self.visual_encoder(images1)
        return self._head(self.text_encoder(text_ids, text_mask=text_mask,
                                            image_states=(s0, s1), mode="multimodal"))

    def classify_single(self, images, text_ids, text_mask=None):
        """The single-image entailment head: SNLI-VE, the classification
        flavour (reference albef_classification.py)."""
        return self._head(self.text_encoder(text_ids, text_mask=text_mask,
                                            image_states=self.visual_encoder(images),
                                            mode="multimodal"))

    def loss(self, images0, images1, text_ids, targets, text_mask=None):
        return F.cross_entropy(self(images0, images1, text_ids, text_mask), targets.long())


def albef_nlvr_distill_loss(module, m_params, images0, images1, text_ids, targets,
                            text_mask=None, alpha: float = 0.4, momentum: float = 0.995):
    """The reference AlbefNLVR objective with momentum distillation
    (albef_nlvr.py:79-170, use_distill=True):

        loss = (1 - alpha) * CE(logits, targets)
               - alpha * sum(log_softmax(logits) * softmax(logits_m))

    with ``logits_m`` from the EMA copy ``m_params`` (every tensor, by
    state_dict name), refreshed first. Returns (loss, new m_params)."""
    new_m = _ema(m_params, _subtree_state(module, None), momentum)
    logits = module(images0, images1, text_ids, text_mask)
    logits_m = _call_with(module, new_m, "forward", images0, images1, text_ids, text_mask)
    logp = torch.log_softmax(logits.float(), dim=-1)
    ce = -logp.gather(1, targets.long()[:, None]).mean()
    kl = -(logp * torch.softmax(logits_m.float(), -1)).sum(-1).mean()
    return (1.0 - alpha) * ce + alpha * kl, new_m


@registry.register_model("albef_vqa")
class AlbefVQA(nn.Module):
    """ALBEF open-ended VQA (reference ``albef_models/albef_vqa.py``): the
    question fused with the image multimodally, answers decoded by the MED
    causal decoder over the question states; inference ranks a candidate
    list (``rank_answers``)."""

    def __init__(self, config: ALBEFConfig, device=None, dtype=torch.bfloat16):
        super().__init__()
        cfg = self.config = config
        kw = dict(device=device, dtype=dtype)
        text = _every_layer_cross(cfg.text)
        self.visual_encoder = VisionTransformer(cfg.vision, **kw)
        self.text_encoder = MedModel(text, **kw)
        self.text_decoder = MedModel(text, **kw)
        self.lm_head = MedLMHead(text, **kw)

    def question_states(self, images, question_ids, question_mask=None):
        return self.text_encoder(question_ids, text_mask=question_mask,
                                 image_states=self.visual_encoder(images), mode="multimodal")

    def answer_logits(self, q_states, q_mask, answer_ids, answer_mask=None):
        """(B, L, V) teacher-forced logits of the answers over the fused
        question states (answers start with the [DEC] / bos token)."""
        hidden = self.text_decoder(answer_ids, text_mask=answer_mask, image_states=q_states,
                                   image_mask=q_mask, mode="decoder")
        return self.lm_head(hidden)

    def answer_loss(self, images, question_ids, question_mask, answer_ids, answer_mask):
        q = self.question_states(images, question_ids, question_mask)
        logits = self.answer_logits(q, question_mask, answer_ids[:, :-1], answer_mask[:, :-1])
        labels = torch.where(answer_mask[:, 1:] == 1, answer_ids[:, 1:],
                             torch.full_like(answer_ids[:, 1:], -100))
        return cross_entropy_lm_loss(logits, labels, answer_mask[:, 1:])


@torch.no_grad()
def rank_answers(module, images, question_ids, question_mask, answer_ids, answer_mask,
                 k: int = 8) -> np.ndarray:
    """The reference's two-stage answer ranking (albef_vqa.py:269-; BLIP
    uses the same recipe): score every candidate's first content token from
    one decoder step, keep the top k a question, then take the candidate of
    least teacher-forced LM loss among them. ``answer_ids``: (A, L) with
    [:, 0] the bos / [DEC] token. Returns (B,) indices into the candidates.

    Ties keep the lower index first, as ``jax.lax.top_k`` orders them (a
    stable descending sort; ``torch.topk`` promises no order), and the
    argmin takes the first least loss."""
    a = answer_ids.shape[0]
    k = min(k, a)
    q_states = module.question_states(images, question_ids, question_mask)
    b = q_states.shape[0]
    start = answer_ids[:1, :1].expand(b, 1)
    first_logits = module.answer_logits(q_states, question_mask, start, None)[:, 0]
    first_logp = torch.log_softmax(first_logits.float(), -1)
    cand_scores = first_logp[:, answer_ids[:, 1]]  # (B, A)
    topk = torch.sort(cand_scores, dim=1, descending=True, stable=True)[1][:, :k]

    flat = topk.reshape(-1)
    q_rep = torch.repeat_interleave(q_states, k, dim=0)
    qm_rep = (torch.repeat_interleave(question_mask, k, dim=0)
              if question_mask is not None else None)
    ans, ans_m = answer_ids[flat], answer_mask[flat]
    logits = module.answer_logits(q_rep, qm_rep, ans[:, :-1], ans_m[:, :-1])
    labels = torch.where(ans_m[:, 1:] == 1, ans[:, 1:], torch.full_like(ans[:, 1:], -100))
    logp = torch.log_softmax(logits.float(), dim=-1)
    tok_ll = logp.gather(-1, torch.where(labels == -100, 0, labels)[..., None].long())[..., 0]
    mask = (labels != -100).float()
    per_pair = -(tok_ll * mask).sum(-1) / mask.sum(-1).clamp_min(1.0)
    best = torch.argmin(per_pair.reshape(b, k), dim=1)
    return topk.gather(1, best[:, None])[:, 0].cpu().numpy()
