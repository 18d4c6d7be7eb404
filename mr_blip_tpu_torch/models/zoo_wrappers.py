"""Task-facing wrappers of the BLIP-v1, CLIP and ALBEF zoo models (the
port's counterpart of their part of ``mr_blip_tpu/models/zoo_wrappers.py``).

The modules are pure compute graphs; these wrappers give them the reference
model API the tasks drive, mirroring ``lavis/models/blip_models/``,
``clip_models/model.py`` and ``albef_models/`` at the interface level:
``from_config(cfg, device=...)``, ``model(samples) -> {"loss"}``,
``generate(samples)``, ``predict(samples)``, ``predict_answers``,
``extract_features``, ``itm`` and ``compute_sim_matrix(loader)``. They run
the module in fp32 and in eval mode (no dropout), as the JAX wrappers apply
theirs deterministic, on ``device`` (the card unless the caller asks for the
CPU), with random weights from ``seed`` by the JAX initializers' rules;
images arrive as numpy (B, H, W, C) and text as strings.

Text: the real BERT WordPiece when a vocabulary is given
(``MRBLIP_BERT_VOCAB``, ``text/wordpiece.py``) and fits the embedding
table, CLIP's byte-level BPE when a merge table is; a deterministic
hash-bucket word tokenizer otherwise, whose metrics the tasks flag with
``tokenizer_fallback``. The GPT dialogue, BLIP-2, ALPRO and PNP-VQA
wrappers wait for their families (ROADMAP Queue 1).
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
from typing import Any, Dict, List

import numpy as np
import torch

from mr_blip_tpu_torch.common.registry import registry
from mr_blip_tpu_torch.models.base import BaseModel


class WordTokenizer:
    """Deterministic hash-bucketed word tokenizer (offline zoo default).

    ids: 0 pad, 1 bos ([DEC]), 2 eos, 3 unk, 4.. hash buckets. Decoding uses
    the reverse map accumulated during encoding (sufficient for round-trip
    caption evaluation in one process).
    """

    pad_token_id, bos_token_id, eos_token_id, unk_token_id = 0, 1, 2, 3
    # Hash buckets collide by construction: text metrics computed through
    # this tokenizer are pipeline smoke values, not comparable numbers.
    # Tasks surface this via ``tokenizer_fallback`` in their metric dicts.
    is_fallback = True

    def __init__(self, vocab_size: int = 992):
        self.vocab_size = vocab_size
        self._rev: Dict[int, str] = {}

    def _wid(self, w: str) -> int:
        h = int(hashlib.md5(w.encode()).hexdigest()[:8], 16)
        i = 4 + h % (self.vocab_size - 4)
        self._rev.setdefault(i, w)
        return i

    def encode(self, text: str, max_len: int = 25) -> List[int]:
        ids = [self.bos_token_id]
        ids += [self._wid(w) for w in text.lower().split()][: max_len - 2]
        return ids + [self.eos_token_id]

    def __call__(self, texts, max_len: int = 25):
        rows = [self.encode(t, max_len) for t in texts]
        n = max(len(r) for r in rows)
        ids = np.zeros((len(rows), n), np.int32)
        mask = np.zeros((len(rows), n), np.int32)
        for i, r in enumerate(rows):
            ids[i, : len(r)] = r
            mask[i, : len(r)] = 1
        return ids, mask

    def decode(self, ids) -> str:
        out = []
        for i in ids:
            i = int(i)
            if i == self.eos_token_id:
                break
            if i >= 4:
                out.append(self._rev.get(i, "<unk>"))
        return " ".join(out)


def _zoo_tokenizer(vocab_size: int):
    """Real BERT WordPiece when a vocab asset is supplied (MRBLIP_BERT_VOCAB,
    mirroring the reference's bert-base-uncased tokenizer) and it fits the
    model's embedding table; deterministic word-hash tokenizer otherwise
    (offline default)."""
    from mr_blip_tpu_torch.text.wordpiece import BertWordPieceTokenizer

    tok = BertWordPieceTokenizer.from_env()
    if tok is not None and tok.vocab_size <= vocab_size:
        return tok
    logging.warning(
        "no tokenizer asset (MRBLIP_BERT_VOCAB unset or vocab too large): "
        "using the hash-bucket WordTokenizer — text metrics will be smoke "
        "values only, and task metric dicts will carry tokenizer_fallback"
    )
    return WordTokenizer(vocab_size=vocab_size)


def _stack_images(samples, device, key: str = "image") -> torch.Tensor:
    imgs = samples[key]
    if isinstance(imgs, torch.Tensor):
        return imgs.to(device=device, dtype=torch.float32)
    if isinstance(imgs, (list, tuple)):
        imgs = np.stack([np.asarray(i) for i in imgs])
    return torch.from_numpy(np.asarray(imgs, np.float32)).to(device)


def init_blip_weights_(module: torch.nn.Module, seed: int = 0, stds=None,
                       consts=None) -> None:
    """Random weights from ``seed`` with the JAX modules' initializers: a
    Dense (and a conv) lecun-normal with zero bias, the embeddings, cls token
    and position embedding N(0, 0.02), LayerNorm and BatchNorm 1 and 0.
    ``stds`` (name -> std: a normal draw) and ``consts`` (name -> value)
    override the rule of a parameter by its full name."""
    from mr_blip_tpu_torch.models.clip_resnet import BatchNorm2d
    from mr_blip_tpu_torch.models.layers import LayerNormFP32

    stds, consts = stds or {}, consts or {}
    dev = next(module.parameters()).device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            owner = module.get_submodule(name.rpartition(".")[0]) if "." in name else module
            leaf = name.rpartition(".")[2]
            if name in consts:
                p.fill_(consts[name])
            elif name in stds:
                p.copy_(torch.randn(p.shape, generator=gen, device=dev) * stds[name])
            elif isinstance(owner, (LayerNormFP32, BatchNorm2d)):
                p.fill_(1.0 if leaf == "weight" else 0.0)
            elif leaf == "bias":
                p.zero_()
            elif leaf in ("cls_token", "pos_embed") or "embeddings" in name:
                p.copy_(torch.randn(p.shape, generator=gen, device=dev) * 0.02)
            else:  # (out, in[, kh, kw]): fan-in is everything but the first axis
                fan_in = p[0].numel()
                p.copy_(torch.randn(p.shape, generator=gen, device=dev) * fan_in ** -0.5)


def init_clip_weights_(module: torch.nn.Module, seed: int = 0) -> None:
    """``init_blip_weights_`` with CLIP's own rules (JAX ``clip.py:160-182``,
    ``clip_resnet.py:66-74``, ``:152-156``): the token embedding N(0, 0.02),
    the text position embedding N(0, 0.01), the attention pool's position
    embedding N(0, embed_dim^-0.5), and the logit scale the constant
    log(1 / 0.07), not a draw. BatchNorm: scale 1, bias 0, mean 0, var 1."""
    cfg = module.config
    stds = {"token_embedding.weight": 0.02, "positional_embedding": 0.01}
    if cfg.resnet is not None:
        stds["visual.attnpool.pos_embed"] = cfg.resnet.embed_dim ** -0.5
    init_blip_weights_(module, seed, stds=stds,
                       consts={"logit_scale": float(np.log(1.0 / 0.07))})


def _blip_config(model_size: str):
    from mr_blip_tpu_torch.models.blip_v1 import blip_base_config, blip_tiny_config

    return blip_tiny_config() if model_size == "tiny" else blip_base_config()


class _BlipWrapper(BaseModel):
    """The shared part: the module ``_make_module`` builds (BLIPv1; ALBEF's
    wrappers build theirs) on ``device`` in fp32 and eval mode, its random
    weights from ``seed``, its tokenizer."""

    def __init__(self, model_size: str, max_txt_len: int, device, seed: int):
        self.model_size = model_size
        self.max_txt_len = max_txt_len
        self.device = torch.device(device)
        self.config, module = self._make_module(model_size, self.device)
        self.tokenizer = _zoo_tokenizer(self.config.text.vocab_size)
        self.module = module.eval()
        init_blip_weights_(self.module, seed)

    def _make_module(self, model_size: str, device):
        from mr_blip_tpu_torch.models.blip_v1 import BLIPv1

        cfg = _blip_config(model_size)
        return cfg, BLIPv1(cfg, device=device, dtype=torch.float32)

    @property
    def img_size(self) -> int:
        return self.config.vision.img_size

    def state_dict(self):
        return self.module.state_dict()

    def load_state_dict(self, state_dict, strict: bool = True):
        return self.module.load_state_dict(state_dict, strict=strict)

    def _text(self, texts):
        ids, mask = self.tokenizer(texts, self.max_txt_len)
        return (torch.from_numpy(np.asarray(ids)).long().to(self.device),
                torch.from_numpy(np.asarray(mask)).long().to(self.device))

    def _labels(self, samples) -> torch.Tensor:
        return torch.as_tensor(np.asarray(samples["label"], np.int64), device=self.device)


@registry.register_model("blip_caption")
class BlipCaptionModel(_BlipWrapper):
    """BLIP-v1 captioner (reference ``blip_caption``): the LM loss, greedy
    and HF-rule beam decoding through the MED causal decoder."""

    PRETRAINED_MODEL_CONFIG_DICT = {
        "tiny": None,
        "base_coco": "configs/models/blip/blip_caption_base_coco.yaml",
    }

    def __init__(self, model_size: str = "tiny", max_txt_len: int = 25, prompt: str = "",
                 device="cuda", seed: int = 0):
        super().__init__(model_size, max_txt_len, device, seed)
        self.prompt = prompt

    @classmethod
    def from_config(cls, cfg, device="cuda"):
        return cls(model_size=cfg.get("model_size", "tiny"),
                   max_txt_len=cfg.get("max_txt_len", 25), prompt=cfg.get("prompt", ""),
                   device=device)

    def forward(self, samples) -> Dict[str, Any]:
        ids, mask = self._text([self.prompt + t for t in samples["text_input"]])
        return {"loss": self.module.caption_loss(_stack_images(samples, self.device),
                                                 ids, mask)}

    __call__ = forward

    @torch.no_grad()
    def generate(self, samples, max_length: int = 12, num_beams: int = 1,
                 min_length: int = 0, length_penalty: float = 1.0) -> Dict[str, Any]:
        ims = _stack_images(samples, self.device)
        if num_beams > 1:
            seqs = self._beam(ims, max_length, num_beams, min_length, length_penalty)
            captions = [self.tokenizer.decode(row) for row in seqs.cpu().numpy()]
        else:
            buf = self._greedy(ims, max_length)
            captions = [self.tokenizer.decode(row[1:]) for row in buf.cpu().numpy()]
        return {"captions": captions}

    def _greedy(self, ims, max_len: int) -> torch.Tensor:
        """(B, max_len) token buffer: [DEC], then argmax tokens."""
        states = self.module.encode_image(ims)
        buf = torch.zeros((ims.shape[0], max_len), dtype=torch.long, device=self.device)
        buf[:, 0] = self.tokenizer.bos_token_id
        for t in range(max_len - 1):
            logits = self.module.caption_logits_from_states(states, buf, t)
            buf[:, t + 1] = torch.argmax(logits, dim=-1)
        return buf

    def _beam(self, ims, max_len: int, num_beams: int, min_len: int,
              length_penalty: float) -> torch.Tensor:
        """HF-rule beam search (``models/generation.py``) with the token
        buffer carried in the cache (MED has no KV cache: the decoder reruns
        over the short caption buffer, the ViT runs once): reference
        blip_caption.py generate(num_beams=3)."""
        from mr_blip_tpu_torch.models.generation import beam_search, expand_to_beams

        b = ims.shape[0]
        states = expand_to_beams(self.module.encode_image(ims), num_beams)
        buf = torch.zeros((b * num_beams, max_len + 1), dtype=torch.long, device=self.device)

        def decode_step(cache, cur_tokens, cur_len):
            buf, states = cache
            buf = buf.clone()
            buf[:, cur_len:cur_len + 1] = cur_tokens
            logits = self.module.caption_logits_from_states(states, buf, cur_len)
            return logits, (buf, states)

        seqs, _ = beam_search(
            decode_step, (buf, states), b, num_beams=num_beams, max_length=max_len,
            min_new_tokens=min_len, eos_token_id=self.tokenizer.eos_token_id,
            pad_token_id=self.tokenizer.pad_token_id,
            decoder_start_token_id=self.tokenizer.bos_token_id,
            length_penalty=length_penalty, device=self.device)
        return seqs


@registry.register_model("blip_retrieval")
class BlipRetrievalModel(_BlipWrapper):
    """BLIP-v1 retrieval (reference ``blip_models/blip_retrieval.py``):
    train = in-batch ITC + hard-negative ITM; eval = the two-stage LAVIS
    protocol: rank by the ITC cosine matrix, then rerank each row's top-k
    candidates with the ITM head (``score[i, topk] = sim +
    softmax(itm_logits)[:, 1]``, the rest -100)."""

    PRETRAINED_MODEL_CONFIG_DICT = {
        "tiny": None,
        "coco": "configs/models/blip/blip_retrieval_coco.yaml",
        "flickr": "configs/models/blip/blip_retrieval_flickr.yaml",
    }

    def __init__(self, model_size: str = "tiny", max_txt_len: int = 25, device="cuda",
                 seed: int = 0):
        super().__init__(model_size, max_txt_len, device, seed)

    @classmethod
    def from_config(cls, cfg, device="cuda"):
        return cls(model_size=cfg.get("model_size", "tiny"),
                   max_txt_len=cfg.get("max_txt_len", 25), device=device)

    def loss(self, images, ids, mask) -> torch.Tensor:
        """ITC + hard-negative ITM: for every image the most similar
        non-matching text and for every text the most similar non-matching
        image (the argmax, the deterministic counterpart of the reference's
        sampling from the softmax)."""
        from mr_blip_tpu_torch.models.blip_v1 import itc_loss

        m = self.module
        sims = m.image_feat(images) @ m.text_feat(ids, mask).T / self.config.temp
        n = sims.shape[0]
        itc = itc_loss(sims)
        neg_inf = torch.finfo(sims.dtype).min
        off_diag = sims + torch.where(torch.eye(n, dtype=torch.bool, device=sims.device),
                                      neg_inf, 0.0)
        hard_txt = torch.argmax(off_diag, dim=1)  # per image
        hard_img = torch.argmax(off_diag, dim=0)  # per text
        states = m.encode_image(images)
        logits = torch.cat([
            m.itm_logits_from_states(states, ids, mask),
            m.itm_logits_from_states(states, ids[hard_txt], mask[hard_txt]),
            m.itm_logits_from_states(states[hard_img], ids, mask)])
        labels = torch.cat([torch.ones(n, dtype=torch.long, device=sims.device),
                            torch.zeros(2 * n, dtype=torch.long, device=sims.device)])
        return itc + torch.nn.functional.cross_entropy(logits.float(), labels)

    def forward(self, samples) -> Dict[str, Any]:
        ids, mask = self._text(samples["text_input"])
        return {"loss": self.loss(_stack_images(samples, self.device), ids, mask)}

    __call__ = forward

    @torch.no_grad()
    def compute_sim_matrix(self, data_loader, k_test: int = 128):
        """Two-stage scoring. Returns ``(score_i2t, score_t2i)``: (N_img,
        N_txt) and (N_txt, N_img) reranked matrices; the entries outside
        each row's top-k stay at -100 (the reference protocol). Each
        image's ViT states are computed once and reused by its feature and
        every rerank that reads it (the JAX wrapper recomputes them)."""
        gallery = self.gallery(data_loader)
        n_img, n_txt = gallery["sims"].shape
        score_i2t = np.stack([self.rerank_i2t(gallery, i, k_test) for i in range(n_img)])
        score_t2i = np.stack([self.rerank_t2i(gallery, t, k_test) for t in range(n_txt)])
        return score_i2t, score_t2i

    @torch.no_grad()
    def gallery(self, data_loader) -> Dict[str, Any]:
        """The first stage over ``data_loader``: every text's ids, mask and
        ITC feature (batch by batch), every new image's ViT states and ITC
        feature (one image at a time), and the (N_img, N_txt) cosine matrix."""
        m = self.module
        img_feats, img_states, txt_feats, txt_ids, txt_masks = [], [], [], [], []
        seen = set()
        for batch in data_loader:
            ids, mask = self.tokenizer(batch["text_input"], self.max_txt_len)
            txt_ids.append(np.asarray(ids))
            txt_masks.append(np.asarray(mask))
            ids_t, mask_t = (torch.from_numpy(np.asarray(a)).long().to(self.device)
                             for a in (ids, mask))
            txt_feats.append(m.text_feat(ids_t, mask_t).cpu().numpy())
            imgs = _stack_images(batch, self.device)
            for j, img_id in enumerate(batch["image_id"]):
                if img_id not in seen:
                    seen.add(img_id)
                    states = m.encode_image(imgs[j:j + 1])
                    img_states.append(states[0])
                    img_feats.append(m.image_feat_from_states(states).cpu().numpy()[0])
        # ragged text batches: pad to one width before concatenating
        width = max(a.shape[1] for a in txt_ids)
        txt_ids = np.concatenate([np.pad(a, ((0, 0), (0, width - a.shape[1])))
                                  for a in txt_ids])
        txt_masks = np.concatenate([np.pad(a, ((0, 0), (0, width - a.shape[1])))
                                    for a in txt_masks])
        return {"sims": np.stack(img_feats) @ np.concatenate(txt_feats).T,
                "states": torch.stack(img_states),
                "ids": torch.from_numpy(txt_ids).long().to(self.device),
                "masks": torch.from_numpy(txt_masks).long().to(self.device)}

    def _itm_probs(self, states, ids, mask) -> np.ndarray:
        logits = self.module.itm_logits_from_states(states, ids, mask).cpu().numpy()
        return np.exp(logits[:, 1]) / np.exp(logits).sum(-1)

    @torch.no_grad()
    def rerank_i2t(self, gallery, i: int, k_test: int = 128) -> np.ndarray:
        """Row ``i`` of ``score_i2t``: image i's top-k texts by cosine,
        reranked by the ITM head."""
        sims = gallery["sims"]
        k = min(k_test, sims.shape[1])
        topk = np.argsort(-sims[i])[:k]
        sel = torch.from_numpy(topk).to(self.device)
        states = gallery["states"]
        row = np.full(sims.shape[1], -100.0, np.float32)
        row[topk] = self._itm_probs(states[i:i + 1].expand((k,) + states.shape[1:]),
                                    gallery["ids"][sel], gallery["masks"][sel]) + sims[i, topk]
        return row

    @torch.no_grad()
    def rerank_t2i(self, gallery, t: int, k_test: int = 128) -> np.ndarray:
        """Row ``t`` of ``score_t2i``: text t's top-k images by cosine,
        reranked by the ITM head."""
        sims = gallery["sims"]
        k = min(k_test, sims.shape[0])
        topk = np.argsort(-sims[:, t])[:k]
        sel = torch.from_numpy(topk).to(self.device)
        row = np.full(sims.shape[0], -100.0, np.float32)
        row[topk] = self._itm_probs(gallery["states"][sel],
                                    gallery["ids"][t:t + 1].expand(k, -1),
                                    gallery["masks"][t:t + 1].expand(k, -1)) + sims[topk, t]
        return row


@registry.register_model("clip")
class ClipModel(BaseModel):
    """CLIP towers, the contrastive loss and gallery scoring (reference
    ``clip_models/model.py``: encode_image / encode_text / forward, and the
    retrieval task's ``compute_sim_matrix``), fp32 and in eval mode.

    Text: CLIP's byte-level BPE when a merge table is given (``bpe_path`` /
    ``MR_BLIP_CLIP_BPE``; the vocabulary grows to the table's size), else
    the hash-bucket ``WordTokenizer`` with its EOS remapped to the highest id
    (``encode_text`` pools there) and rows padded to ``context_length``."""

    # every OpenCLIP geometry the reference ships JSONs for
    # (lavis/configs/models/clip/*.json) and the tiny test size; the RN*
    # names select the ModifiedResNet tower (models/clip_resnet.py)
    PRETRAINED_MODEL_CONFIG_DICT = {
        "tiny": None, "ViT-B-32": None, "ViT-B-32-quickgelu": None,
        "ViT-B-16": None, "ViT-B-16-plus-240": None, "ViT-L-14": None,
        "ViT-L-14-336": None, "ViT-H-14": None, "ViT-g-14": None,
        "RN50": None, "RN50-quickgelu": None, "RN101": None,
        "RN101-quickgelu": None, "RN50x4": None, "RN50x16": None,
    }

    def __init__(self, model_size: str = "tiny", bpe_path: str | None = None,
                 device="cuda", seed: int = 0):
        from mr_blip_tpu_torch.models.clip import (
            CLIP,
            CLIP_MODEL_ZOO,
            CLIP_RESNET_ZOO,
            clip_config_from_name,
            clip_tiny_config,
            clip_vit_b16_config,
        )
        from mr_blip_tpu_torch.text.clip_bpe import ClipBPETokenizer

        if model_size == "tiny":
            cfg = clip_tiny_config()
        elif model_size in CLIP_MODEL_ZOO or model_size in CLIP_RESNET_ZOO:
            cfg = clip_config_from_name(model_size)
        else:
            cfg = clip_vit_b16_config()
        try:
            self.tokenizer = ClipBPETokenizer(bpe_path, context_length=cfg.context_length)
            if self.tokenizer.vocab_size > cfg.vocab_size:
                cfg = dataclasses.replace(cfg, vocab_size=self.tokenizer.vocab_size)
        except FileNotFoundError:
            self.tokenizer = None  # the word fallback
        self.config = cfg
        self.model_size = model_size
        self.device = torch.device(device)
        self._word_tok = WordTokenizer(vocab_size=cfg.vocab_size)
        self.module = CLIP(cfg, device=self.device, dtype=torch.float32).eval()
        init_clip_weights_(self.module, seed)

    @classmethod
    def from_config(cls, cfg, device="cuda"):
        return cls(model_size=cfg.get("model_size", "tiny"), bpe_path=cfg.get("bpe_path"),
                   device=device)

    @property
    def img_size(self) -> int:
        cfg = self.config
        return cfg.resnet.image_size if cfg.resnet is not None else cfg.vision.img_size

    def state_dict(self):
        return self.module.state_dict()

    def load_state_dict(self, state_dict, strict: bool = True):
        return self.module.load_state_dict(state_dict, strict=strict)

    def tokenize(self, texts) -> torch.Tensor:
        """(B, context_length) ids on the wrapper's device."""
        if self.tokenizer is not None:
            ids = self.tokenizer(texts)
        else:
            ids, _ = self._word_tok(texts, self.config.context_length)
            ids = np.where(ids == self._word_tok.eos_token_id, self.config.vocab_size - 1, ids)
            if ids.shape[1] < self.config.context_length:
                ids = np.pad(ids, ((0, 0), (0, self.config.context_length - ids.shape[1])))
        return torch.from_numpy(np.asarray(ids)).long().to(self.device)

    def forward(self, samples) -> Dict[str, Any]:
        from mr_blip_tpu_torch.models.clip import clip_contrastive_loss

        logits_per_image, _ = self.module(_stack_images(samples, self.device),
                                          self.tokenize(samples["text_input"]))
        return {"loss": clip_contrastive_loss(logits_per_image)}

    __call__ = forward

    @torch.no_grad()
    def compute_sim_matrix(self, data_loader, k_test: int = 128):
        """The full gallery's (N_img, N_txt) cosine matrix (the RetrievalTask
        protocol; features L2-normalized, as the reference's CLIP protocol):
        every caption is encoded batch by batch, every image once, at its
        first ``image_id``, in first-seen order. A batch's new images are
        encoded together (the JAX wrapper encodes them one at a time)."""
        img_feats, txt_feats = [], []
        seen = set()
        for batch in data_loader:
            txt_feats.append(self.module.encode_text(
                self.tokenize(batch["text_input"])).float().cpu().numpy())
            new = []
            for j, img_id in enumerate(batch["image_id"]):
                if img_id not in seen:
                    seen.add(img_id)
                    new.append(j)
            if new:
                imgs = _stack_images(batch, self.device)[torch.tensor(new)]
                img_feats.append(self.module.encode_image(imgs).float().cpu().numpy())
        img, txt = np.concatenate(img_feats), np.concatenate(txt_feats)
        img = img / np.linalg.norm(img, axis=-1, keepdims=True)
        txt = txt / np.linalg.norm(txt, axis=-1, keepdims=True)
        return img @ txt.T


# ------------------------------------------------------------------ ALBEF
def _albef_config(model_size: str):
    from mr_blip_tpu_torch.models.albef import albef_base_config, albef_tiny_config

    return albef_tiny_config() if model_size == "tiny" else albef_base_config()


class _ClassificationWrapper(_BlipWrapper):
    """The classification heads' forward (cross entropy against
    ``samples["label"]``) and ``predict`` (class indices and targets: the
    multimodal classification task's surface) over ``_logits(samples)``."""

    def _images(self, samples, key="image"):
        return _stack_images(samples, self.device, key)

    def forward(self, samples) -> Dict[str, Any]:
        return {"loss": torch.nn.functional.cross_entropy(self._logits(samples).float(),
                                                          self._labels(samples))}

    __call__ = forward

    @torch.no_grad()
    def predict(self, samples) -> Dict[str, Any]:
        logits = self._logits(samples).cpu().numpy()
        return {"predictions": logits.argmax(-1).tolist(),
                "targets": list(np.asarray(samples["label"], np.int64))}


@registry.register_model("albef_nlvr_model")
class AlbefNLVRModel(_ClassificationWrapper):
    """The task-facing ALBEF NLVR2 wrapper (reference ``albef_nlvr.py``): it
    drives the multimodal classification task over {image, image2,
    text_input, label}."""

    PRETRAINED_MODEL_CONFIG_DICT = {"nlvr": None, "tiny": None}

    def __init__(self, model_size: str = "tiny", max_txt_len: int = 25, device="cuda",
                 seed: int = 0):
        super().__init__(model_size, max_txt_len, device, seed)

    def _make_module(self, model_size, device):
        from mr_blip_tpu_torch.models.albef import AlbefNLVR

        cfg = _albef_config(model_size)
        return cfg, AlbefNLVR(cfg, device=device, dtype=torch.float32)

    @classmethod
    def from_config(cls, cfg, device="cuda"):
        return cls(model_size=cfg.get("model_size", "tiny"),
                   max_txt_len=cfg.get("max_txt_len", 25), device=device)

    def _logits(self, samples):
        return self.module(self._images(samples), self._images(samples, "image2"),
                           *self._text(samples["text_input"]))


@registry.register_model("albef_retrieval")
class AlbefRetrievalModel(BlipRetrievalModel):
    """ALBEF retrieval: the same two-stage ITC + ITM-rerank protocol over the
    ALBEF towers (reference ``albef_models/albef_retrieval.py``; ITM passes
    through the fusion_layer split when configured)."""

    PRETRAINED_MODEL_CONFIG_DICT = {
        "tiny": None,
        "coco": "configs/models/albef/albef_retrieval_coco.yaml",
        "flickr": "configs/models/albef/albef_retrieval_flickr.yaml",
    }

    def _make_module(self, model_size, device):
        from mr_blip_tpu_torch.models.albef import ALBEF

        cfg = _albef_config(model_size)
        return cfg, ALBEF(cfg, device=device, dtype=torch.float32)


class _PretrainWrapper(_BlipWrapper):
    """The momentum-distillation objective with the EMA state carried inside
    the wrapper: the queues from ``seed``, the hard negatives from a
    generator seeded ``seed + 1`` (JAX draws both from its keys)."""

    def __init__(self, model_size, max_txt_len, queue_size, alpha, device, seed):
        from mr_blip_tpu_torch.models.albef import init_momentum_state

        super().__init__(model_size, max_txt_len, device, seed)
        self.alpha = alpha
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.momentum_state = init_momentum_state(self.module, self.config.embed_dim,
                                                  queue_size=queue_size, generator=gen)
        self._gen = torch.Generator(device=self.device).manual_seed(seed + 1)

    @classmethod
    def from_config(cls, cfg, device="cuda"):
        return cls(model_size=cfg.get("model_size", "tiny"),
                   queue_size=cfg.get("queue_size", 64), alpha=cfg.get("alpha", 0.4),
                   device=device)

    def _losses(self, images, ids, mask, neg_idx):
        from mr_blip_tpu_torch.models.albef import albef_pretrain_losses

        losses, self.momentum_state = albef_pretrain_losses(
            self.module, self.momentum_state, images, ids, mask, generator=self._gen,
            alpha=self.alpha, neg_idx=neg_idx)
        return losses


@registry.register_model("albef_pretrain")
class AlbefPretrainModel(_PretrainWrapper):
    """ALBEF pretraining (reference ``albef_pretrain.py``): momentum
    distillation, the feature queues and hard-negative ITM. ``forward``
    takes the negatives' indices as ``neg_idx`` too (``albef_pretrain_losses``)."""

    PRETRAINED_MODEL_CONFIG_DICT = {
        "tiny": None,
        "base": "configs/models/albef/albef_pretrain_base.yaml",
    }

    def __init__(self, model_size: str = "tiny", max_txt_len: int = 25,
                 queue_size: int = 64, alpha: float = 0.4, device="cuda", seed: int = 0):
        super().__init__(model_size, max_txt_len, queue_size, alpha, device, seed)

    def _make_module(self, model_size, device):
        from mr_blip_tpu_torch.models.albef import ALBEF

        cfg = _albef_config(model_size)
        return cfg, ALBEF(cfg, device=device, dtype=torch.float32)

    def forward(self, samples, neg_idx=None) -> Dict[str, Any]:
        ids, mask = self._text(samples["text_input"])
        losses = self._losses(_stack_images(samples, self.device), ids, mask, neg_idx)
        return {"loss": losses["loss"], **losses}

    __call__ = forward


@registry.register_model("blip_pretrain")
class BlipPretrainModel(_PretrainWrapper):
    """BLIP-v1 pretraining (reference ``blip_pretrain.py``): ALBEF's
    momentum-distillation ITC, queues and hard-negative ITM (the shared
    ``albef_pretrain_losses``) plus the text decoder's caption LM loss."""

    PRETRAINED_MODEL_CONFIG_DICT = {
        "tiny": None,
        "base": "configs/models/blip/blip_pretrain_base.yaml",
    }

    def __init__(self, model_size: str = "tiny", max_txt_len: int = 25,
                 queue_size: int = 64, alpha: float = 0.4, device="cuda", seed: int = 0):
        super().__init__(model_size, max_txt_len, queue_size, alpha, device, seed)

    def forward(self, samples, neg_idx=None) -> Dict[str, Any]:
        ids, mask = self._text(samples["text_input"])
        images = _stack_images(samples, self.device)
        losses = self._losses(images, ids, mask, neg_idx)
        lm = self.module.caption_loss(images, ids, mask)
        return {"loss": losses["loss"] + lm, "loss_lm": lm, **losses}

    __call__ = forward


@registry.register_model("albef_classification")
class AlbefClassificationModel(_ClassificationWrapper):
    """Single-image entailment classification (reference
    ``albef_classification.py``; SNLI-VE has 3 classes)."""

    PRETRAINED_MODEL_CONFIG_DICT = {
        "tiny": None,
        "ve": "configs/models/albef/albef_classification_ve.yaml",
    }

    def __init__(self, model_size: str = "tiny", num_classes: int = 3, max_txt_len: int = 25,
                 device="cuda", seed: int = 0):
        self.num_classes = num_classes
        super().__init__(model_size, max_txt_len, device, seed)

    def _make_module(self, model_size, device):
        from mr_blip_tpu_torch.models.albef import AlbefNLVR

        cfg = _albef_config(model_size)
        return cfg, AlbefNLVR(cfg, device=device, dtype=torch.float32,
                              num_classes=self.num_classes)

    @classmethod
    def from_config(cls, cfg, device="cuda"):
        return cls(model_size=cfg.get("model_size", "tiny"),
                   num_classes=cfg.get("num_classes", 3), device=device)

    def _logits(self, samples):
        return self.module.classify_single(self._images(samples),
                                           *self._text(samples["text_input"]))


@registry.register_model("blip_classification")
class BlipClassificationModel(_ClassificationWrapper):
    """BLIP single-image classification (reference
    ``blip_classification.py``): a head over the fused cls token."""

    PRETRAINED_MODEL_CONFIG_DICT = {
        "tiny": None,
        "base": "configs/models/blip/blip_classification_base.yaml",
    }

    def __init__(self, model_size: str = "tiny", num_classes: int = 3, max_txt_len: int = 25,
                 device="cuda", seed: int = 0):
        self.num_classes = num_classes
        super().__init__(model_size, max_txt_len, device, seed)

    def _make_module(self, model_size, device):
        from mr_blip_tpu_torch.models.blip_v1 import BLIPv1

        cfg = dataclasses.replace(_blip_config(model_size), num_classes=self.num_classes)
        return cfg, BLIPv1(cfg, device=device, dtype=torch.float32)

    @classmethod
    def from_config(cls, cfg, device="cuda"):
        return cls(model_size=cfg.get("model_size", "tiny"),
                   num_classes=cfg.get("num_classes", 3), device=device)

    def _logits(self, samples):
        return self.module.classify(self._images(samples), *self._text(samples["text_input"]))


@registry.register_model("blip_nlvr")
class BlipNLVRModel(_ClassificationWrapper):
    """BLIP NLVR2 (reference ``blip_nlvr.py`` and nlvr_encoder.py's merged
    two-image cross-attention): the ITM head over both images' tokens."""

    PRETRAINED_MODEL_CONFIG_DICT = {
        "tiny": None,
        "nlvr": "configs/models/blip/blip_nlvr.yaml",
    }

    def __init__(self, model_size: str = "tiny", max_txt_len: int = 25, device="cuda",
                 seed: int = 0):
        super().__init__(model_size, max_txt_len, device, seed)

    @classmethod
    def from_config(cls, cfg, device="cuda"):
        return cls(model_size=cfg.get("model_size", "tiny"), device=device)

    def _logits(self, samples):
        return self.module.nlvr_logits(self._images(samples), self._images(samples, "image2"),
                                       *self._text(samples["text_input"]))


@registry.register_model("blip_vqa")
class BlipVQAModel(_BlipWrapper):
    """BLIP open-ended VQA (reference ``blip_vqa.py``): the question encoded
    multimodally, the answer decoded over it; inference ranks a candidate
    answer list with the shared two-stage ranker (``albef.rank_answers``)."""

    PRETRAINED_MODEL_CONFIG_DICT = {
        "tiny": None,
        "vqav2": "configs/models/blip/blip_vqav2.yaml",
    }

    def __init__(self, model_size: str = "tiny", max_txt_len: int = 25, answer_list=None,
                 device="cuda", seed: int = 0):
        super().__init__(model_size, max_txt_len, device, seed)
        self.answer_list = answer_list or ["yes", "no"]

    @classmethod
    def from_config(cls, cfg, device="cuda"):
        return cls(model_size=cfg.get("model_size", "tiny"),
                   answer_list=cfg.get("answer_list"), device=device)

    def forward(self, samples) -> Dict[str, Any]:
        q_ids, q_mask = self._text(samples["text_input"])
        a_ids, a_mask = self._text([a[0] if isinstance(a, (list, tuple)) else a
                                    for a in samples["answers"]])
        return {"loss": self.module.vqa_answer_loss(_stack_images(samples, self.device),
                                                    q_ids, q_mask, a_ids, a_mask)}

    __call__ = forward

    def predict_answers(self, samples, num_ans_candidates: int = 8) -> List[str]:
        from mr_blip_tpu_torch.models.albef import rank_answers

        q_ids, q_mask = self._text(samples["text_input"])
        a_ids, a_mask = self._text(self.answer_list)
        picks = rank_answers(self.module, _stack_images(samples, self.device), q_ids, q_mask,
                             a_ids, a_mask, k=num_ans_candidates)
        return [self.answer_list[int(i)] for i in picks]


@registry.register_model("blip_feature_extractor")
class BlipFeatureExtractorModel(_BlipWrapper):
    """The reference ``blip_feature_extractor``: ``extract_features(samples,
    mode)`` over the BLIP towers."""

    PRETRAINED_MODEL_CONFIG_DICT = {
        "tiny": None,
        "base": "configs/models/blip/blip_feature_extractor_base.yaml",
    }

    def __init__(self, model_size: str = "tiny", max_txt_len: int = 25, device="cuda",
                 seed: int = 0):
        super().__init__(model_size, max_txt_len, device, seed)

    @classmethod
    def from_config(cls, cfg, device="cuda"):
        return cls(model_size=cfg.get("model_size", "tiny"), device=device)

    @torch.no_grad()
    def extract_features(self, samples, mode="multimodal"):
        kwargs = {"mode": mode}
        if mode in ("image", "multimodal"):
            kwargs["images"] = _stack_images(samples, self.device)
        if mode in ("text", "multimodal"):
            kwargs["text_ids"], kwargs["text_mask"] = self._text(samples["text_input"])
        return self.module.extract_features(**kwargs)


@registry.register_model("blip_image_text_matching")
class BlipITMModel(BlipFeatureExtractorModel):
    """The reference ``blip_image_text_matching``: ``itm(samples,
    match_head="itm" | "itc")`` scores."""

    PRETRAINED_MODEL_CONFIG_DICT = {
        "tiny": None,
        "base": "configs/models/blip/blip_itm_base.yaml",
        "large": "configs/models/blip/blip_itm_large.yaml",
    }

    @torch.no_grad()
    def itm(self, samples, match_head: str = "itm") -> np.ndarray:
        ids, mask = self._text(samples["text_input"])
        ims = _stack_images(samples, self.device)
        if match_head == "itm":
            return self.module.itm_logits(ims, ids, mask).cpu().numpy()
        img_f, txt_f = self.module.itc_features(ims, ids, mask)
        return (img_f * txt_f).sum(-1).cpu().numpy()
