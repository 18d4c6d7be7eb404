"""BLIP2-MR-OPT: the decoder-only variant, registered ``blip2_opt_mr``
(counterpart of ``mr_blip_tpu/models/blip2_mr_opt.py``).

Counterpart of the reference ``lavis/models/blip2_mr_models/blip2_mr_opt.py``
(class at :33): the same ViT -> Q-Former -> projection front end feeds an
OPT causal LM with a non-interleaved prompt layout

    [video-prompt text | frame tokens | </vid> | query + task prompt | answer]

Training computes the LM loss on the answer region only; generation writes
the prompt but its last token into the KV cache in one block-causal pass,
then beam-searches the continuation seeded with each row's last prompt
token.

With ``freeze_vit=False`` the ViT trains too, as in ``BLIP2_MR``, but
without stochastic depth: the JAX module calls its ViT deterministic, so
its drop-path rate is never sampled.

uint8 frames are CLIP-normalized on the device, as ``BLIP2_MR`` does. The
JAX package's ``prepare_opt_batch`` casts every frame array to float32, so
uint8 frames reach its ViT unnormalized (its module's uint8 branch never
runs); the port keeps them uint8 (ROADMAP Queue 3, known differences).
"""

from __future__ import annotations

import contextlib
import logging
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from mr_blip_tpu_torch.common.registry import registry
from mr_blip_tpu_torch.models.blip2_mr import BLIP2_MR, _bucket, _pad_to
from mr_blip_tpu_torch.models.blip2_mr_module import clip_normalize, vit_trains
from mr_blip_tpu_torch.models.eva_vit import EvaViT
from mr_blip_tpu_torch.models.generation import beam_search
from mr_blip_tpu_torch.models.layers import Dense, LayerNormFP32
from mr_blip_tpu_torch.models.opt import (
    OPTForCausalLM,
    opt_2_7b_config,
    opt_6_7b_config,
    opt_tiny_config,
)
from mr_blip_tpu_torch.models.qformer import QFormer
from mr_blip_tpu_torch.metrics.simple import compute_IoU as _compute_iou
from mr_blip_tpu_torch.text.span_grammar import moment_str_to_list, post_process
from mr_blip_tpu_torch.text.timestamps import format_timestamps


class Blip2OPTModule(nn.Module):
    def __init__(self, vit_config, qformer_config, opt_config,
                 compute_dtype=torch.bfloat16, device=None):
        super().__init__()
        self.vit_config = vit_config
        self.qformer_config = qformer_config
        self.opt_config = opt_config
        self.compute_dtype = compute_dtype
        kw = dict(device=device, dtype=compute_dtype)
        self.visual_encoder = EvaViT(vit_config, **kw)
        # The JAX OPT module's ln_vision keeps LayerNormFP32's eps, 1e-6
        # (the T5 variant's is 1e-5).
        self.ln_vision = LayerNormFP32(vit_config.embed_dim, 1e-6, device=device)
        self.qformer = QFormer(qformer_config, **kw)
        self.opt_proj = Dense(qformer_config.hidden_size, opt_config.hidden_size, **kw)
        self.opt = OPTForCausalLM(opt_config, **kw)

    @property
    def tokens_per_frame(self) -> int:
        return self.qformer_config.num_query_tokens

    def encode_frames(self, frames: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, C) frames -> (B, T*n, hidden) OPT tokens; a frozen
        ViT runs without building a graph."""
        b, t = frames.shape[:2]
        frames = clip_normalize(frames, self.compute_dtype)
        with contextlib.nullcontext() if vit_trains(self) else torch.no_grad():
            image_embeds = self.visual_encoder(frames.reshape((b * t,) + frames.shape[2:]))
        q = self.opt_proj(self.qformer(self.ln_vision(image_embeds)))
        return q.reshape(b, t * q.shape[1], self.opt_config.hidden_size)

    def _embed(self, ids, dtype):
        return self.opt.embed_tokens(ids).to(dtype)

    def assemble(self, frames_for_opt, vid_ids, vid_mask, end_ids, end_mask,
                 text_ids, text_mask):
        """[video prompt | frame tokens | end | text] -> (embeds, mask)."""
        dtype = frames_for_opt.dtype
        frames_mask = torch.ones(frames_for_opt.shape[:2], dtype=vid_mask.dtype,
                                 device=vid_mask.device)
        embeds = torch.cat([self._embed(vid_ids, dtype), frames_for_opt,
                            self._embed(end_ids, dtype), self._embed(text_ids, dtype)],
                           dim=1)
        mask = torch.cat([vid_mask, frames_mask, end_mask, text_mask], dim=1)
        return embeds, mask

    def prefill(self, frames, vid_ids, vid_mask, end_ids, end_mask, text_ids,
                text_mask):
        """The assembled prompt for cached generation -> (embeds, mask)."""
        return self.assemble(self.encode_frames(frames), vid_ids, vid_mask,
                             end_ids, end_mask, text_ids, text_mask)

    def loss_terms(self, frames, vid_ids, vid_mask, end_ids, end_mask, text_ids,
                   text_mask, answer_ids, answer_mask):
        """Causal LM loss on the answer region only, as (token-loss sum,
        answer-token count): the logits at position p predict token p + 1,
        and answer token j sits at prompt_len + j."""
        prompt_embeds, prompt_mask = self.prefill(
            frames, vid_ids, vid_mask, end_ids, end_mask, text_ids, text_mask)
        embeds = torch.cat([prompt_embeds,
                            self._embed(answer_ids, prompt_embeds.dtype)], dim=1)
        mask = torch.cat([prompt_mask, answer_mask], dim=1)
        states = self.opt(embeds, attention_mask=mask, return_logits=False)
        p_len = prompt_embeds.shape[1]
        logits = self.opt.head(states[:, p_len - 1:-1])
        log_probs = torch.log_softmax(logits, dim=-1)
        token_ll = log_probs.gather(-1, answer_ids[..., None].long())[..., 0]
        w = answer_mask.float()
        return -(token_ll * w).sum(), w.sum()

    def decode_step(self, tokens, full_mask, cache, position: int):
        """(rows, n) token ids at ``position`` -> (rows, n, vocab) fp32
        logits; writes the caches in place."""
        return self.opt(self._embed(tokens, self.compute_dtype),
                        attention_mask=full_mask, cache=cache, position=position)


@registry.register_model("blip2_opt_mr")
class BLIP2_MR_OPT(BLIP2_MR):
    """Decoder-only Mr. BLIP variant; reuses the BLIP2_MR host machinery
    (weights, ``set_trainable``, ``generate_collect``, ``train``/``eval``)."""

    PRETRAINED_MODEL_CONFIG_DICT = {
        "pretrain_opt2.7b": "configs/models/blip2/blip2_pretrain_opt2.7b.yaml",
        "tiny": "configs/models/blip2/blip2_tiny.yaml",
    }
    OPT_CONFIGS = {
        "opt-2.7b": opt_2_7b_config,
        "opt-6.7b": opt_6_7b_config,
        "tiny": opt_tiny_config,
    }
    # The keys ``mr_blip_tpu/models/blip2_mr_opt.py::from_config`` reads.
    SUPPORTED_CONFIG = (
        "arch", "model_type", "opt_model", "image_size", "vit_model",
        "tokenizer_path", "num_query_token", "num_beams", "min_len",
        "min_new_tokens", "max_len", "max_new_tokens", "input_time_format", "task",
        "freeze_vit", "compute_dtype")

    def __init__(
        self,
        opt_model: str = "opt-2.7b",
        img_size: int = 224,
        vit_model: str = "eva_vit_g",
        tokenizer_path: str | None = None,
        num_query_token: int = 32,
        num_beams: int = 5,
        min_new_tokens: int = 0,
        max_txt_len: int = 200,
        max_new_tokens: int = 50,
        input_time_format: str = "seconds_integers",
        task: str = "lora",
        compute_dtype: str = "bfloat16",
        seed: int = 42,
        init_params: bool = True,
        device: str | torch.device = "cuda",
        freeze_vit: bool = True,
    ):
        """LoRA r=8 on every OPT linear under a ``lora`` task; the
        vocabulary is the tokenizer's when ``tokenizer_path`` is None;
        ``freeze_vit=False`` trains the ViT too."""
        self._init_host(
            img_size=img_size, vit_model=vit_model, tokenizer_path=tokenizer_path,
            num_query_token=num_query_token, num_beams=num_beams,
            min_new_tokens=min_new_tokens, max_txt_len=max_txt_len,
            max_new_tokens=max_new_tokens, input_time_format=input_time_format,
            task=task, compute_dtype=compute_dtype, device=device)
        self.freeze_vit = freeze_vit
        opt_kw = dict(lora_rank=8 if self.use_lora else 0)
        if tokenizer_path is None:
            opt_kw["vocab_size"] = self.tokenizer.vocab_size
        self.opt_config = self.OPT_CONFIGS[opt_model](**opt_kw)
        self.module = Blip2OPTModule(self.vit_config, self.qformer_config,
                                     self.opt_config, compute_dtype=self.compute_dtype,
                                     device=self.device).eval()
        self.module.requires_grad_(False)
        if init_params:
            self.init_params(seed)

    @classmethod
    def from_config(cls, cfg, device="cuda"):
        """The keys the JAX package's ``from_config`` reads, with its
        defaults; it loads no checkpoint, so ``pretrained``, ``finetuned``
        and ``load_finetuned`` are logged as unread with every other key.
        ``sequence_parallel: True`` raises ``ValueError``."""
        if cfg.get("sequence_parallel", False):
            raise ValueError("model.sequence_parallel=True: the OPT variant has no "
                             "sequence parallelism (nor has the JAX package's)")
        unread = sorted(set(cfg) - set(cls.SUPPORTED_CONFIG))
        if unread:
            logging.warning("BLIP2_MR_OPT.from_config does not read model.%s",
                            ", model.".join(unread))
        return cls(
            opt_model=cfg.get("opt_model", "opt-2.7b"),
            img_size=cfg.get("image_size", 224),
            vit_model=cfg.get("vit_model", "eva_vit_g"),
            tokenizer_path=cfg.get("tokenizer_path"),
            num_query_token=cfg.get("num_query_token", 32),
            num_beams=cfg.get("num_beams", 5),
            min_new_tokens=cfg.get("min_len", cfg.get("min_new_tokens", 0)),
            max_txt_len=cfg.get("max_len", 200),
            max_new_tokens=cfg.get("max_new_tokens", 50),
            input_time_format=cfg.get("input_time_format", "seconds_integers"),
            task=cfg.get("task", "qformer_freeze_lora"),
            compute_dtype=cfg.get("compute_dtype", "bfloat16"),
            freeze_vit=cfg.get("freeze_vit", True),
            device=device,
        )

    def trainable_mask(self) -> Dict[str, bool]:
        """Parameter name -> trains, by the JAX package's mask: the ViT
        unless ``freeze_vit``; in the OPT only ``lora_a``/``lora_b``, and
        only under a ``lora`` task; the Q-Former, ``opt_proj`` and
        ``ln_vision`` unless the task has ``qformer_freeze``."""
        qformer_frozen = "qformer_freeze" in self.task

        def trains(name: str) -> bool:
            top = name.split(".")[0]
            if top == "visual_encoder":
                return not self.freeze_vit
            if top == "opt":
                return self.use_lora and "lora_" in name
            if top in ("qformer", "opt_proj", "ln_vision"):
                return not qformer_frozen
            return False

        return {name: trains(name) for name, _ in self.module.named_parameters()}

    def trains_cached_bias(self) -> bool:
        return False  # no cached tensor derives from a weight

    # ------------------------------------------------------------ host prep
    def prepare_opt_batch(self, samples: Dict[str, Any],
                          need_targets: bool = True) -> Dict[str, Any]:
        """Strings + sampling metadata -> padded numpy arrays: the video
        prompt (the non-interleaved timestamp string), its end, the query
        and task prompt (bucketed by 16) and, with ``need_targets``, the
        answers with ``"</s>"`` appended (bucketed by 8)."""
        video = samples["video"]
        if isinstance(video, torch.Tensor):  # frames the loader put on the card
            if video.dtype != torch.uint8:
                video = video.float()
        else:
            video = np.asarray(video)
            if video.dtype != np.uint8:
                video = video.astype(np.float32)
        b = video.shape[0]
        timestamps = np.asarray(samples["timestamps"], np.float64)
        durations = np.asarray(samples["duration"], np.float64)
        video_prompt_end = list(samples["video_prompt_end"])
        query_prompt = list(samples["query_prompt"])
        task_prompt = list(samples["task_prompt"])

        if "only_frames" in self.task:
            video_prompts = ["<vid>" for _ in range(b)]
            video_prompt_end = ["<extra_id_0>\n" for _ in video_prompt_end]
        else:
            # The OPT path remaps only through the annoying-number dict for
            # seconds_integers (reference blip2_mr_opt.py:653-685).
            _, _, video_prompts = format_timestamps(
                self.input_time_format, timestamps, durations,
                self.annoying_numbers_replacement_dict)

        if "no_task_prompt" in self.task:
            text_prompt = query_prompt
        else:
            text_prompt = [q + tp for q, tp in zip(query_prompt, task_prompt)]

        tok = self.tokenizer
        kw = dict(add_special_tokens=False, truncation=True, max_length=self.max_txt_len)
        vid_enc = tok(video_prompts, **kw)
        end_enc = tok(video_prompt_end, **kw)
        text_enc = tok(text_prompt, **kw)
        text_len = _bucket(text_enc.input_ids.shape[1])
        batch = {
            "frames": video,
            "vid_ids": vid_enc.input_ids, "vid_mask": vid_enc.attention_mask,
            "end_ids": end_enc.input_ids, "end_mask": end_enc.attention_mask,
            "text_ids": _pad_to(text_enc.input_ids, text_len),
            "text_mask": _pad_to(text_enc.attention_mask, text_len),
        }
        if need_targets and "relevant_windows" in samples:
            # Answers carry an explicit EOS (reference blip2_mr_opt.py:227-236).
            ans_enc = tok([a + "</s>" for a in samples["relevant_windows"]], **kw)
            ans_len = _bucket(ans_enc.input_ids.shape[1], 8)
            batch["answer_ids"] = _pad_to(ans_enc.input_ids, ans_len)
            batch["answer_mask"] = _pad_to(ans_enc.attention_mask, ans_len)
        return batch

    def prepare_mr_batch(self, samples, need_targets: bool = True):
        """The task layer's name for ``prepare_opt_batch``."""
        return self.prepare_opt_batch(samples, need_targets=need_targets)

    _PROMPT_KEYS = ("vid_ids", "vid_mask", "end_ids", "end_mask", "text_ids",
                    "text_mask")

    def loss_terms(self, batch: Dict[str, Any]):
        """(token-loss sum, answer-token count) of a ``prepare_opt_batch``
        batch; ``loss`` (inherited) is their quotient."""
        t = self._to_device(batch)
        return self.module.loss_terms(t["frames"], *(t[k] for k in self._PROMPT_KEYS),
                                      t["answer_ids"], t["answer_mask"])

    def forward(self, samples) -> Dict[str, Any]:
        return {"loss": self.loss(self.prepare_opt_batch(samples))}

    __call__ = forward

    # ------------------------------------------------------------- generate
    def _generate_batch(self, samples) -> Dict[str, Any]:
        """The host prep of the inherited ``generate_dispatch``: each row's
        text block right-aligned so that its last prompt token, the seed of
        the search (``start_tokens``), is real."""
        batch = self.prepare_opt_batch(samples, need_targets=False)
        text_ids, text_mask = batch["text_ids"], batch["text_mask"]
        last_real = text_mask.sum(axis=1) - 1
        start_tokens = np.take_along_axis(text_ids, last_real[:, None], axis=1)[:, 0]
        width = text_ids.shape[1]
        shifted_ids, shifted_mask = np.zeros_like(text_ids), np.zeros_like(text_mask)
        for i in range(text_ids.shape[0]):
            n = int(text_mask[i].sum())
            shifted_ids[i, width - n:] = text_ids[i, :n]
            shifted_mask[i, width - n:] = 1
        batch["text_ids"], batch["text_mask"] = shifted_ids, shifted_mask
        batch["start_tokens"] = start_tokens.astype(np.int64)
        return batch

    def _generate_prepared(self, batch):
        """(seqs, scores) of a ``_generate_batch`` batch, in eval mode."""
        tensors = self._to_device(batch)
        training = self.module.training
        self.module.eval()
        try:
            return self._search(tensors, tensors["start_tokens"])
        finally:
            self.module.train(training)

    def _search(self, tensors, start_tokens):
        """Prefill the prompt but its last token at B rows, copy the cache
        to the beams, and beam-search ``max_new_tokens`` steps."""
        module = self.module
        embeds, mask = module.prefill(tensors["frames"],
                                      *(tensors[k] for k in self._PROMPT_KEYS))
        b, prompt_len = mask.shape
        k, max_new = self.num_beams, self.max_new_tokens
        embeds, mask = embeds[:, :-1], mask[:, :-1]
        # The cache spans the prefilled prompt plus every generated position.
        full_mask = torch.cat(
            [mask, torch.ones((b, max_new + 1), dtype=mask.dtype, device=mask.device)],
            dim=1)
        cache = module.opt.init_cache(b, prompt_len + max_new, self.device)
        module.opt(embeds, attention_mask=full_mask, cache=cache, position=0,
                   return_logits=False)
        cache = [(ck.repeat_interleave(k, 0), cv.repeat_interleave(k, 0))
                 for ck, cv in cache]
        full_mask = full_mask.repeat_interleave(k, 0)

        def decode_step(cache, tokens, position):
            logits = module.decode_step(tokens, full_mask, cache,
                                        position + prompt_len - 1)
            return logits[:, 0], cache

        return beam_search(
            decode_step, cache, batch_size=b, num_beams=k, max_length=max_new,
            min_new_tokens=self.min_new_tokens,
            eos_token_id=self.tokenizer.eos_token_id,
            pad_token_id=self.tokenizer.pad_token_id,
            decoder_start_token_id=start_tokens, device=self.device)

    # ------------------------------------------------------------- readouts
    def logits_to_moments(self, logits):
        """Teacher-forced logit readout -> per-sample moment lists.

        The reference's ``blip2_mr_opt.py:964-978``: argmax over the vocab,
        decode, keep the text between the first and second ``</s>`` (the
        prompt echo comes before the first), then the shared span grammar
        (``text/span_grammar.py``). Two divergences, as in the JAX package:
        (a) a decode with no ``</s>`` maps to ``[[-1, -1]]`` where the
        reference raises IndexError (its own TODO); (b) the reference's
        class-local grammar copies carry two typos (``isinstance(i, int)``
        at :1086 zeroes every window; the split's ``(?=\\])`` lookahead at
        :1011 never splits); the shared ``utils.py`` semantics are kept.

        Args: ``logits`` (B, T, vocab), a numpy array or a tensor.
        Returns: a list of per-sample moment lists, e.g. ``[[[0.0, 1.5]]]``.
        """
        if isinstance(logits, torch.Tensor):
            logits = logits.detach().float().cpu().numpy()
        ids = np.argmax(np.asarray(logits), axis=2)
        moments = []
        for s in self.tokenizer.batch_decode(ids):
            parts = s.split("</s>")
            moments.append(moment_str_to_list(post_process(
                parts[1] if len(parts) > 1 else "")))
        return moments

    @staticmethod
    def compute_IoU(pred, target):
        """Single-window IoU with the reference's conventions
        (``blip2_mr_opt.py:1094-1131``): disjoint windows give 0."""
        return _compute_iou(pred, target)
