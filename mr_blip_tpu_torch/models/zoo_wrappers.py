"""Task-facing wrappers of the BLIP-v1 zoo models (the port's counterpart of
the BLIP caption and retrieval part of ``mr_blip_tpu/models/zoo_wrappers.py``).

The modules are pure compute graphs; these wrappers give them the reference
model API the tasks drive, mirroring ``lavis/models/blip_models/
blip_caption.py`` and ``blip_retrieval.py`` at the interface level:
``from_config(cfg, device=...)``, ``model(samples) -> {"loss"}``,
``generate(samples)`` and ``compute_sim_matrix(loader)``. They run the
module in fp32 and in eval mode (no dropout), as the JAX wrappers apply
theirs deterministic, on ``device`` (the card unless the caller asks for the
CPU); images arrive as numpy (B, H, W, C) and text as strings.

Text: the real BERT WordPiece when a vocabulary is given
(``MRBLIP_BERT_VOCAB``, ``text/wordpiece.py``) and fits the embedding
table; a deterministic hash-bucket word tokenizer otherwise, whose metrics
the tasks flag with ``tokenizer_fallback``. The CLIP, ALBEF, GPT dialogue
and later wrappers wait for their families (ROADMAP Queue 1).
"""

from __future__ import annotations

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


def _stack_images(samples, device) -> torch.Tensor:
    imgs = samples["image"]
    if isinstance(imgs, torch.Tensor):
        return imgs.to(device=device, dtype=torch.float32)
    if isinstance(imgs, (list, tuple)):
        imgs = np.stack([np.asarray(i) for i in imgs])
    return torch.from_numpy(np.asarray(imgs, np.float32)).to(device)


def init_blip_weights_(module: torch.nn.Module, seed: int = 0) -> None:
    """Random weights from ``seed`` with the JAX modules' initializers: a
    Dense (and the patch conv) lecun-normal with zero bias, the embeddings,
    cls token and position embedding N(0, 0.02), LayerNorm 1 and 0."""
    from mr_blip_tpu_torch.models.layers import LayerNormFP32

    dev = next(module.parameters()).device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            owner = module.get_submodule(name.rpartition(".")[0]) if "." in name else module
            leaf = name.rpartition(".")[2]
            if isinstance(owner, LayerNormFP32):
                p.fill_(1.0 if leaf == "weight" else 0.0)
            elif leaf == "bias":
                p.zero_()
            elif leaf in ("cls_token", "pos_embed") or "embeddings" in name:
                p.copy_(torch.randn(p.shape, generator=gen, device=dev) * 0.02)
            else:  # (out, in[, kh, kw]): fan-in is everything but the first axis
                fan_in = p[0].numel()
                p.copy_(torch.randn(p.shape, generator=gen, device=dev) * fan_in ** -0.5)


class _BlipWrapper(BaseModel):
    """The shared part: the BLIPv1 module on ``device``, its tokenizer."""

    def __init__(self, model_size: str, max_txt_len: int, device, seed: int):
        from mr_blip_tpu_torch.models.blip_v1 import (
            BLIPv1,
            blip_base_config,
            blip_tiny_config,
        )

        cfg = blip_tiny_config() if model_size == "tiny" else blip_base_config()
        self.config = cfg
        self.model_size = model_size
        self.max_txt_len = max_txt_len
        self.device = torch.device(device)
        self.tokenizer = _zoo_tokenizer(cfg.text.vocab_size)
        self.module = BLIPv1(cfg, device=self.device, dtype=torch.float32).eval()
        init_blip_weights_(self.module, seed)

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
