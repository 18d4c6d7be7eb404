"""BLIP2-MR host wrapper, generate and train paths (counterpart of
``mr_blip_tpu/models/blip2_mr.py``).

``BLIP2_MR(...).generate(samples)`` takes uint8 (or float) video plus query
strings and returns prediction / raw_prediction / answer / qid / duration,
as the JAX package's wrapper does. ``model(samples)`` returns ``{"loss"}``,
the teacher-forced span loss against ``samples["relevant_windows"]``;
``runners/train_state.py::TrainCtx`` drives training steps. Strings,
tokenization, timestamp formatting and the interleave plan run on the host;
every tensor op runs in PyTorch on ``device``.

Task-string flags supported here: ``lora`` (LoRA r=8 on every T5 Linear),
``qformer_freeze``, ``add_duration``, ``no_task_prompt``, ``QA`` (adds the
answerer T5) and ``with_localizer`` / ``oracle_localizer`` (where the QA
stage-1 moments come from). The non-interleaved prompt is not ported yet.
``train()``/``eval()`` switch every dropout (eval is the default).

Grounded QA: ``videoQA_generate(samples)`` runs the two-stage pipeline, the
localizer's ``generate`` -> frames cropped to the predicted window ->
``videoQA_answer`` (the answerer T5 over [frame tokens | question + options],
the answer read off the A-E logits of the second decoding step);
``videoQA_dispatch`` / ``videoQA_redecode`` / ``videoQA_collect`` are its
three steps. ``model(samples)`` under a QA task is the answerer's
teacher-forced loss (``forward_QA``). With ``resample_frames=True`` (the
published NExT-GQA and NExT-QA eval configs) the answerer's frames are not
cropped from the localizer's frames but re-decoded from the video file,
``num_frames_for_answer`` of them sampled uniformly inside the predicted
window (``submit_window_redecodes``: every window of a batch submitted to the
reader's decode pool before any is awaited).

int8 inference: ``model.quantize_for_inference().generate(samples)`` converts
the loaded float weights (W8A8 ViT, Q-Former cross K/V and T5 encoder on the
kernels of ``ops/int8_matmul.py``; weight-only int8 decoder and LM head; int8
cross-attention cache) and generates as before. Inference only.

QLoRA-style training: ``model.quantize_base_for_train()`` (``model.int8_base``
in a config) stores the frozen T5 base weight-only int8 under the float LoRA
deltas; ``TrainCtx`` then trains the LoRA tensors as before.

Long context: ``BLIP2_MR(relpos_in_kernel=True)`` (120/240-frame videos) has
the T5 encoder look its rel-pos bias up inside the flash kernels, in
``generate`` (bf16 and int8) and in ``loss``; no (1, H, L, L) bias is built
or cached.

The model lives on ``device``, the card by default; pass ``device="cpu"``
to run the kernels' plain versions on the host.

Registered as ``blip2_mr``: ``BLIP2_MR.from_config(cfg)`` builds it from the
``model:`` section of a project config (``configs/projects/eval/qvh.yaml``
layered over ``configs/models/blip2/*.yaml``), loads its checkpoints and
quantizes it, as the JAX package's ``from_config`` does; the keys whose
setting the port cannot compute yet raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict

import numpy as np
import torch

from mr_blip_tpu_torch.common.registry import registry
from mr_blip_tpu_torch.models.base import BaseModel
from mr_blip_tpu_torch.models.blip2_mr_module import Blip2MRModule
from mr_blip_tpu_torch.models.eva_vit import eva_vit_g_config, vit_tiny_config
from mr_blip_tpu_torch.models.generation import beam_search, greedy_decode_with_scores
from mr_blip_tpu_torch.models.prompt_assembly import build_interleave_plan
from mr_blip_tpu_torch.models.qformer import qformer_base_config, qformer_tiny_config
from mr_blip_tpu_torch.models.quantize import (
    quantize_qformer_cross_params,
    quantize_t5_decoder_params,
    quantize_t5_encoder_params,
    quantize_t5_params,
    quantize_vit_params,
)
from mr_blip_tpu_torch.models.t5 import (
    materialize_encoder_relpos_bias,
    t5_flan_xl_config,
    t5_flan_xxl_config,
    t5_tiny_config,
)
from mr_blip_tpu_torch.text.span_grammar import (
    convert_to_absolute_time,
    moment_str_to_list,
    post_process,
)
from mr_blip_tpu_torch.text.timestamps import (
    find_annoying_numbers,
    find_annoying_numbers_replacement_dict,
    format_timestamps,
)
from mr_blip_tpu_torch.text.tokenizer import load_tokenizer

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# Encoder rel-pos biases kept per sequence length (~270 MB each in bf16 at
# the flagship length 2056).
_BIAS_CACHE_ENTRIES = 3
# Standard deviation of the random weights (``scale`` of init_params_fast).
_INIT_STD = 0.02
# EOS is banned for this many steps of the answerer's greedy decode, so that
# the second step's logits score an answer letter.
_QA_MIN_NEW_TOKENS = 8


def _pad_to(arr: np.ndarray, length: int, axis: int = 1, value=0) -> np.ndarray:
    pad = length - arr.shape[axis]
    if pad <= 0:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, pad)
    return np.pad(arr, widths, constant_values=value)


def _moments_from_strings(strings, durations, whole_end):
    """The localizer's moment strings -> one [start, end] each: ``[[-1,
    -1]]`` (no valid span) becomes ``[0, whole_end(duration)]``, and an end
    past the duration is cut to ``round(duration)``."""
    moments = []
    for string, duration in zip(strings, np.asarray(durations, np.float64)):
        m = moment_str_to_list(string)
        m = [0, whole_end(float(duration))] if m == [[-1, -1]] else m[0]
        if m[1] > duration:
            m[1] = round(float(duration))
        moments.append(m)
    return moments


def _bucket(n: int, multiple: int = 16) -> int:
    return ((n + multiple - 1) // multiple) * multiple


@registry.register_model("blip2_mr")
class BLIP2_MR(BaseModel):
    PRETRAINED_MODEL_CONFIG_DICT = {
        "pretrain_flant5xl": "configs/models/blip2/blip2_pretrain_flant5xl.yaml",
        "pretrain_flant5xxl": "configs/models/blip2/blip2_pretrain_flant5xxl.yaml",
        "tiny": "configs/models/blip2/blip2_tiny.yaml",
    }
    VIT_CONFIGS = {"eva_vit_g": eva_vit_g_config, "tiny": vit_tiny_config}
    T5_CONFIGS = {"flan-t5-xl": t5_flan_xl_config, "flan-t5-xxl": t5_flan_xxl_config,
                  "tiny": t5_tiny_config}

    def __init__(
        self,
        img_size: int = 224,
        vit_model: str = "eva_vit_g",
        t5_model: str = "flan-t5-xl",
        tokenizer_path: str | None = None,
        num_query_token: int = 32,
        num_beams: int = 5,
        min_new_tokens: int = 0,
        max_txt_len: int = 200,
        max_new_tokens: int = 50,
        input_time_format: str = "seconds_integers",
        task: str = "lora",
        num_frames_for_answer: int = 4,
        resample_frames: bool = False,
        compute_dtype: str = "bfloat16",
        seed: int = 42,
        init_params: bool = True,
        vocab_size: int | None = None,
        device: str | torch.device = "cuda",
        relpos_in_kernel: bool = False,
        use_grad_checkpoint: bool = False,
    ):
        """``init_params`` draws random weights on ``device`` from ``seed``.
        ``relpos_in_kernel`` is the long-context mode (120/240-frame
        videos): the T5 encoder's rel-pos bias is computed inside its flash
        kernels and no (1, H, L, L) bias is ever built.
        ``use_grad_checkpoint`` recomputes every T5 block in the backward
        (``T5Config.use_remat``) instead of keeping its activations.
        ``num_frames_for_answer``: frames the QA answerer sees, cropped from
        the localizer's window, or with ``resample_frames=True`` re-decoded
        from the video file inside that window (``samples["video_path"]``).
        The ViT is frozen (``freeze_vit: True`` in every published config).
        Without a card, the default ``device`` raises: ask for the CPU."""
        if "only_frames" in task:
            raise NotImplementedError(f"task {task!r}: the non-interleaved "
                                      "prompt is not ported")
        self._init_host(
            img_size=img_size, vit_model=vit_model, tokenizer_path=tokenizer_path,
            num_query_token=num_query_token, num_beams=num_beams,
            min_new_tokens=min_new_tokens, max_txt_len=max_txt_len,
            max_new_tokens=max_new_tokens, input_time_format=input_time_format,
            task=task, compute_dtype=compute_dtype, device=device)
        self.num_frames_for_answer = num_frames_for_answer
        self.resample_frames = resample_frames
        vit_cfg, qf_cfg = self.vit_config, self.qformer_config
        t5_kw = dict(lora_rank=8 if self.use_lora else 0,
                     relpos_in_kernel=relpos_in_kernel,
                     use_remat=use_grad_checkpoint)
        if vocab_size is not None:
            t5_kw["vocab_size"] = int(vocab_size)
        elif tokenizer_path is None:
            t5_kw["vocab_size"] = self.tokenizer.vocab_size
        else:
            default_vocab = self.T5_CONFIGS[t5_model]().vocab_size
            padded = -(-self.tokenizer.vocab_size // 128) * 128
            t5_kw["vocab_size"] = max(default_vocab, padded)
        t5_cfg = self.T5_CONFIGS[t5_model](**t5_kw)
        self.t5_config = t5_cfg
        self.module = Blip2MRModule(vit_cfg, qf_cfg, t5_cfg,
                                    compute_dtype=self.compute_dtype,
                                    device=self.device,
                                    with_answerer=self.is_qa).eval()
        self.module.requires_grad_(False)
        if init_params:
            self.init_params(seed)

    def _init_host(self, img_size, vit_model, tokenizer_path, num_query_token,
                   num_beams, min_new_tokens, max_txt_len, max_new_tokens,
                   input_time_format, task, compute_dtype, device):
        """The settings, tokenizer and vision configs that every variant
        shares; the language model and ``module`` are the variant's."""
        self.task = task
        self.use_lora = "lora" in task
        self.use_localizer = "with_localizer" in task
        self.use_oracle_localizer = "oracle_localizer" in task
        self.is_qa = "QA" in task
        self.input_time_format = input_time_format
        self.max_txt_len = max_txt_len
        self.max_new_tokens = max_new_tokens
        self.min_new_tokens = min_new_tokens
        self.num_beams = num_beams
        self.img_size = img_size
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"{type(self).__name__}(device={str(device)!r}): no CUDA "
                "device; pass device='cpu' to run on the host")
        self.compute_dtype = _DTYPES[compute_dtype]

        self.tokenizer = load_tokenizer(tokenizer_path)
        annoying, _ = find_annoying_numbers(self.tokenizer, 200)
        self.annoying_numbers_replacement_dict = (
            find_annoying_numbers_replacement_dict(annoying))
        # Token ids that score A..E at the answerer's second decoding step.
        self.answer_ids = [
            self.tokenizer.encode(letter, add_special_tokens=False)[-1]
            for letter in "ABCDE"]

        vit_cfg = self.VIT_CONFIGS[vit_model](img_size=img_size)
        self.vit_config = vit_cfg
        self.qformer_config = (qformer_base_config(vit_cfg.embed_dim, num_query_token)
                               if vit_model == "eva_vit_g"
                               else qformer_tiny_config(vit_cfg.embed_dim))
        # Keyed by the length (the localizer's T5) or ("answerer_t5", length).
        self._enc_bias_cache: Dict[Any, torch.Tensor] = {}

    # ------------------------------------------------------------ weights
    @torch.no_grad()
    def init_params(self, seed: int):
        """Random weights drawn on the device from a seeded generator, as
        the JAX wrapper's ``init_params_fast(mode="random")`` draws them:
        every 1-D tensor (norm scales and biases, linear biases) is one,
        every other tensor N(0, 0.02)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        for p in self.module.parameters():
            if p.ndim == 1:
                p.fill_(1.0)
            else:
                p.copy_(torch.randn(p.shape, generator=gen, device=self.device)
                        * _INIT_STD)
        self._enc_bias_cache.clear()

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return self.module.state_dict()

    def load_state_dict(self, state_dict, strict: bool = True):
        """Load weights (e.g. from ``models/convert.py::state_dict_from_jax``)
        into the tensors as they are stored (fp32 trainable, compute-dtype
        frozen); clears the per-length encoder bias cache."""
        self._enc_bias_cache.clear()
        return self.module.load_state_dict(state_dict, strict=strict)

    def clear_bias_cache(self):
        """Drop the cached encoder biases (after the rel-pos table changed)."""
        self._enc_bias_cache.clear()

    def trains_cached_bias(self) -> bool:
        """Whether a train step changes a tensor that ``_enc_bias_cache``
        was computed from (the T5 encoder's rel-pos table), so that an
        update must clear the cache."""
        return self.module.t5.encoder.rel_bias.rel_embedding.requires_grad

    def trainable_mask(self) -> Dict[str, bool]:
        """Parameter name -> trains, by the JAX package's policy with the
        ViT frozen, whatever the task: in the main T5 only ``lora_a``/
        ``lora_b`` train, and only under a ``lora`` task; the Q-Former,
        ``t5_proj`` and ``ln_vision`` train unless the task has
        ``qformer_freeze``. A QA model's ``answerer_t5`` never trains: the
        JAX package keeps its tree out of every train state."""
        qformer_frozen = "qformer_freeze" in self.task

        def trains(name: str) -> bool:
            top = name.split(".")[0]
            if top == "t5":
                return self.use_lora and "lora_" in name
            if top in ("qformer", "t5_proj", "ln_vision"):
                return not qformer_frozen
            return False

        return {name: trains(name) for name, _ in self.module.named_parameters()}

    def set_trainable(self):
        """``requires_grad`` by ``trainable_mask``; trainable tensors become
        fp32 master weights (cast to the compute dtype at use), frozen ones
        stay as stored."""
        mask = self.trainable_mask()
        for name, p in self.module.named_parameters():
            if mask[name] and p.is_floating_point():
                p.data = p.data.float()
            p.requires_grad_(mask[name])

    def trainable_param_count(self) -> tuple[int, int]:
        """(trainable, total) parameter counts; the total counts the int8
        weights and their scales (buffers here, parameters in JAX) too."""
        mask = self.trainable_mask()
        params = dict(self.module.named_parameters())
        total = sum(t.numel() for t in (*params.values(), *self.module.buffers()))
        return sum(params[n].numel() for n, m in mask.items() if m), total

    # ------------------------------------------------------- int8 inference
    def quantize_vit(self):
        """Convert the float ViT to the W8A8 int8 layout and rebuild it with
        ``int8_matmul=True`` (the activations are quantized per token inside
        the kernels: no calibration pass). Inference only; call after
        loading float weights."""
        if self.vit_config.int8_matmul:
            raise RuntimeError("the ViT is already quantized")
        self.vit_config = dataclasses.replace(self.vit_config, int8_matmul=True)
        self.module.rebuild_submodule(
            "visual_encoder", self.vit_config,
            quantize_vit_params(self.module.visual_encoder.state_dict()))
        return self

    def quantize_qformer(self):
        """Pack the Q-Former's cross-attention key and value projections into
        W8A8 int8 ``kv_packed`` weights (``int8_cross=True``); the other
        projections and the FFNs stay float. Inference only."""
        if self.qformer_config.int8_cross:
            raise RuntimeError("the Q-Former is already quantized")
        self.qformer_config = dataclasses.replace(self.qformer_config,
                                                  int8_cross=True)
        self.module.rebuild_submodule(
            "qformer", self.qformer_config,
            quantize_qformer_cross_params(self.module.qformer.state_dict()))
        return self

    def _rebuild_t5(self, convert, **flags):
        """Both T5 stacks of a QA model are converted, as in JAX."""
        self.t5_config = dataclasses.replace(self.t5_config, **flags)
        for name in ("t5", "answerer_t5") if self.is_qa else ("t5",):
            self.module.rebuild_submodule(
                name, self.t5_config,
                convert(getattr(self.module, name).state_dict()))
        return self

    def quantize_encoder(self):
        """Convert the float T5 encoder to the W8A8 int8 layout
        (``int8_encoder=True``), the LoRA deltas merged into the quantized
        weights (the same function as base + delta). The rel-pos table is
        untouched, so the cached encoder biases stay. Inference only."""
        if self.t5_config.int8_encoder:
            raise RuntimeError("the T5 encoder is already quantized")
        alpha = self.t5_config.lora_alpha
        return self._rebuild_t5(
            lambda sd: quantize_t5_encoder_params(sd, lora_alpha=alpha),
            int8_encoder=True)

    def quantize_for_decode(self):
        """Store the T5 decoder blocks and the LM head weight-only int8
        (``int8_decode=True``; their LoRA deltas stay float) and keep the
        decode-time cross-attention K/V cache int8 (``int8_cross_cache``,
        quantized when the cache is built). Inference only."""
        if self.t5_config.int8_decode:
            raise RuntimeError("the T5 decoder is already quantized")
        return self._rebuild_t5(quantize_t5_decoder_params, int8_decode=True,
                                int8_cross_cache=True)

    def quantize_for_inference(self):
        """The int8 inference mode in one call: W8A8 ViT, W8A8 Q-Former
        cross K/V, W8A8 T5 encoder, weight-only int8 decoder and LM head."""
        return (self.quantize_vit().quantize_qformer().quantize_encoder()
                .quantize_for_decode())

    def quantize_base_for_train(self):
        """QLoRA-style training layout (``int8_base=True``): the whole frozen
        T5 base, every encoder and decoder block Dense and the LM head, stored
        weight-only int8; the LoRA deltas stay float and train. Both T5 stacks
        of a QA model. Call after loading float weights and before building
        ``TrainCtx``. Raises without LoRA or on a T5 already quantized."""
        if not self.use_lora:
            raise ValueError(f"task {self.task!r}: int8 base training needs LoRA "
                             "(a frozen base)")
        cfg = self.t5_config
        if cfg.int8_base or cfg.int8_encoder or cfg.int8_decode:
            raise RuntimeError("the T5 is already quantized")
        return self._rebuild_t5(quantize_t5_params, int8_base=True)

    # --------------------------------------------------------------- config
    # ``from_config`` keys (those ``mr_blip_tpu/models/blip2_mr.py::from_config``
    # reads) whose settings the port cannot compute yet: key -> (the settings
    # it can compute, what is missing and the title of its ROADMAP Queue 1
    # item).
    UNSUPPORTED_CONFIG = {
        "interleave_data": ((True,), "the non-interleaved prompt",
                            "Variants of BLIP2_MR"),
        "frame_token_aggregation": ((False, None), "frame-token aggregation",
                                    "Variants of BLIP2_MR"),
        "freeze_vit": ((True,), "the unfrozen-ViT train path",
                       "The unfrozen-ViT train path"),
        "fast_gelu": ((False,), "the tanh-GELU ViT", "Variants of BLIP2_MR"),
        "sequence_parallel": ((False,), "sequence-parallel frames", "Parallelism"),
    }
    # Read and without effect in the port: layouts of the TPU program
    # (scan_layers, remat_policy); the ViT's stochastic depth, which a frozen
    # ViT never samples; the seed of the JAX package's zero init.
    IGNORED_CONFIG = ("scan_layers", "remat_policy", "drop_path_rate", "seed")
    # The keys it computes (``arch`` and ``model_type`` are the Config's).
    SUPPORTED_CONFIG = (
        "arch", "model_type", "image_size", "vit_model", "t5_model",
        "tokenizer_path", "num_query_token", "num_beams", "min_len",
        "min_new_tokens", "max_len", "max_new_tokens", "input_time_format", "task",
        "num_frames_for_answer", "resample_frames", "relpos_in_kernel", "compute_dtype",
        "vocab_size", "params_dtype", "pretrained", "finetuned", "load_finetuned",
        "int8_inference", "int8_decode", "int8_vit", "int8_qformer", "int8_encoder",
        "int8_base", "use_grad_checkpoint")

    @classmethod
    def from_config(cls, cfg, device="cuda"):
        """The model of a config's ``model:`` section on ``device``: the keys
        the JAX package's ``from_config`` reads, with its defaults; random
        weights from the constructor's seed unless ``params_dtype`` is set
        (then zeros, ones for 1-D tensors, and the checkpoint must cover every
        tensor; the tensors keep the port's storage dtypes); then
        ``pretrained`` and, under ``load_finetuned``, ``finetuned`` loaded
        non-strict (a missing file logs a warning); then the int8
        conversions in the JAX order, ``int8_base`` last. A key the port
        cannot compute raises ``NotImplementedError``; a key ``from_config``
        does not read is logged."""
        for key, (computable, what, item) in cls.UNSUPPORTED_CONFIG.items():
            if key in cfg and cfg[key] not in computable:
                raise NotImplementedError(
                    f"model.{key}={cfg[key]!r}: {what} is not ported yet "
                    f"(ROADMAP Queue 1, \"{item}\")")
        unread = sorted(set(cfg) - set(cls.UNSUPPORTED_CONFIG)
                        - set(cls.IGNORED_CONFIG) - set(cls.SUPPORTED_CONFIG))
        if unread:
            logging.warning("BLIP2_MR.from_config does not read model.%s",
                            ", model.".join(unread))
        ignored = [k for k in cls.IGNORED_CONFIG if cfg.get(k) is not None]
        if ignored:
            logging.info("BLIP2_MR.from_config: model.%s read, no effect in the port",
                         ", model.".join(ignored))
        params_dtype = cfg.get("params_dtype")
        if params_dtype not in (None, "bfloat16", "float32"):
            raise ValueError(f"model.params_dtype={params_dtype!r}")
        model = cls(
            img_size=cfg.get("image_size", 224),
            vit_model=cfg.get("vit_model", "eva_vit_g"),
            t5_model=cfg.get("t5_model", "flan-t5-xl"),
            tokenizer_path=cfg.get("tokenizer_path"),
            num_query_token=cfg.get("num_query_token", 32),
            num_beams=cfg.get("num_beams", 5),
            min_new_tokens=cfg.get("min_len", cfg.get("min_new_tokens", 0)),
            max_txt_len=cfg.get("max_len", 200),
            max_new_tokens=cfg.get("max_new_tokens", 50),
            input_time_format=cfg.get("input_time_format", "seconds_integers"),
            task=cfg.get("task", "qformer_freeze_lora"),
            num_frames_for_answer=cfg.get("num_frames_for_answer", 4),
            resample_frames=cfg.get("resample_frames", False),
            relpos_in_kernel=cfg.get("relpos_in_kernel", False),
            use_grad_checkpoint=cfg.get("use_grad_checkpoint", False),
            compute_dtype=cfg.get("compute_dtype", "bfloat16"),
            init_params=params_dtype is None,
            vocab_size=cfg.get("vocab_size"),
            device=device,
        )
        if params_dtype is not None:
            logging.info("params_dtype=%s: zero init; checkpoint load must cover "
                         "every tensor", params_dtype)
            with torch.no_grad():
                for p in model.module.parameters():
                    p.fill_(1.0 if p.ndim == 1 else 0.0)
        finetuned = cfg.get("finetuned")
        pretrained = cfg.get("pretrained")
        for path, kind in ((pretrained, "pretrained"),
                           (finetuned if cfg.get("load_finetuned", False) else None,
                            "finetuned")):
            if not path:
                continue
            try:
                model.load_state_dict(
                    cls.load_params_nonstrict(model.state_dict(), path))
                logging.info("loaded %s weights from %s", kind, path)
            except FileNotFoundError:
                logging.warning("%s checkpoint %s not found", kind, path)
        # Quantize after the float checkpoints are loaded (the converters
        # read float weights).
        if cfg.get("int8_inference", False):
            model.quantize_for_inference()
        else:
            if cfg.get("int8_decode", False):
                model.quantize_for_decode()
            if cfg.get("int8_vit", False):
                model.quantize_vit()
            if cfg.get("int8_qformer", False):
                model.quantize_qformer()
            if cfg.get("int8_encoder", False):
                model.quantize_encoder()
        if cfg.get("int8_base", False):
            model.quantize_base_for_train()
        return model

    def train(self, mode: bool = True):
        """Train mode turns every dropout on; ``eval()`` off."""
        self.module.train(mode)
        return self

    def eval(self):
        return self.train(False)

    # ------------------------------------------------------ host batch prep
    def prepare_mr_batch(self, samples: Dict[str, Any],
                         need_targets: bool = True) -> Dict[str, Any]:
        """Strings + sampling metadata -> padded numpy arrays + gather plan;
        with ``need_targets`` and ``relevant_windows`` in the samples, also
        the target ids and mask, padded to a multiple of 8."""
        video = samples["video"]
        if isinstance(video, torch.Tensor):  # frames the loader put on the card
            if video.dtype != torch.uint8:
                video = video.float()
        else:
            video = np.asarray(video)
            if video.dtype != np.uint8:
                video = video.astype(np.float32)
        timestamps = np.asarray(samples["timestamps"], np.float64)
        durations = np.asarray(samples["duration"], np.float64)
        video_prompt_end = list(samples["video_prompt_end"])
        if "add_duration" in self.task:
            video_prompt_end = [">{}<extra_id_0>\n".format(round(float(d), 2))
                                for d in durations]
        fmt_ts, fmt_dur, _ = format_timestamps(
            self.input_time_format, timestamps, durations,
            self.annoying_numbers_replacement_dict)
        query_prompt = list(samples["query_prompt"])
        if "no_task_prompt" in self.task:
            text_prompt = query_prompt
        else:
            text_prompt = [q + tp for q, tp in zip(query_prompt, samples["task_prompt"])]

        tok = self.tokenizer
        end_enc = tok(video_prompt_end, add_special_tokens=False,
                      truncation=True, max_length=self.max_txt_len)
        text_enc = tok(text_prompt, truncation=True, max_length=self.max_txt_len)
        text_len = _bucket(text_enc.input_ids.shape[1])
        plan = build_interleave_plan(tok, fmt_ts, fmt_dur,
                                     self.module.tokens_per_frame)
        batch = {
            "frames": video,
            "end_ids": end_enc.input_ids,
            "end_mask": end_enc.attention_mask,
            "text_ids": _pad_to(text_enc.input_ids, text_len),
            "text_mask": _pad_to(text_enc.attention_mask, text_len),
            "time_ids": plan.time_ids,
            "src_type": plan.src_type,
            "src_idx": plan.src_idx,
            "int_mask": plan.attn_mask,
        }
        if need_targets and "relevant_windows" in samples:
            target = tok(list(samples["relevant_windows"]), truncation=True,
                         max_length=self.max_txt_len)
            target_len = _bucket(target.input_ids.shape[1], 8)
            batch["target_ids"] = _pad_to(target.input_ids, target_len)
            batch["target_mask"] = _pad_to(target.attention_mask, target_len)
        return batch

    def _to_device(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """numpy arrays copied to ``device``; a tensor already there (the
        frames a ``PrefetchLoader`` copied ahead) is taken as it is."""
        return {k: (v if isinstance(v, torch.Tensor)
                    else torch.from_numpy(np.ascontiguousarray(v))).to(self.device)
                for k, v in batch.items()}

    def _encoder_bias(self, length: int, t5_name: str = "t5") -> torch.Tensor | None:
        """Per-length cached (1, H, L, L) encoder rel-pos bias of the
        ``t5_name`` stack in the compute dtype: it depends only on the length
        and the (frozen) table. None under ``relpos_in_kernel``: the kernels
        compute the bias. ``length`` is rounded up to a multiple of 8, as
        the assembled sequence is padded."""
        cfg = self.t5_config
        if cfg.relpos_in_kernel:
            return None
        length = -(-length // 8) * 8
        key = length if t5_name == "t5" else (t5_name, length)
        cache = self._enc_bias_cache
        if key not in cache:
            if len(cache) >= _BIAS_CACHE_ENTRIES:
                cache.pop(next(iter(cache)))
            table = getattr(self.module, t5_name).encoder.rel_bias.rel_embedding
            # Never an inference tensor, though generate fills the cache
            # under inference mode: a train step saves it for its backward.
            with torch.inference_mode(False), torch.no_grad():
                cache[key] = materialize_encoder_relpos_bias(
                    table, length, cfg.relative_attention_num_buckets,
                    cfg.relative_attention_max_distance,
                ).to(self.compute_dtype).contiguous()
        return cache[key]

    def _encoder_bias_for(self, batch: Dict[str, Any]) -> torch.Tensor | None:
        """The cached bias for a ``prepare_mr_batch`` batch's length."""
        return self._encoder_bias(
            batch["int_mask"].shape[1] + batch["end_ids"].shape[1]
            + batch["text_ids"].shape[1])

    # --------------------------------------------------------- device path
    def frames_to_t5(self, tensors):
        """Stage 1: frames -> ViT -> ln_vision -> Q-Former -> t5_proj."""
        return self.module.encode_frames(tensors["frames"])

    def encode_t5(self, tensors, frames_for_t5, enc_bias):
        """Stage 2: interleave + T5 encoder -> (encoder states, mask)."""
        embeds, attn = self.module.assemble_encoder_input(
            frames_for_t5, tensors["time_ids"], tensors["src_type"],
            tensors["src_idx"], tensors["int_mask"], tensors["end_ids"],
            tensors["end_mask"], tensors["text_ids"], tensors["text_mask"])
        return self.module.encode(embeds, attn, position_bias=enc_bias), attn

    def _decode_step_fn(self, t5, enc, attn):
        """The generation loops' callback over ``t5``'s cached decoder."""
        cross_kv = t5.decoder.cross_kv(enc)

        def decode_step(cache, tokens, position):
            logits = t5.decode_step(tokens, position, cache, cross_kv, attn)
            return logits[:, 0], cache

        return decode_step

    def decode(self, enc, attn):
        """Stage 3: beam search over the cached decoder."""
        cfg = self.t5_config
        b = enc.shape[0]
        t5 = self.module.t5
        decode_step = self._decode_step_fn(t5, enc, attn)
        cache = t5.decoder.init_cache(b * self.num_beams, self.max_new_tokens,
                                      enc.dtype, enc.device)

        return beam_search(
            decode_step, cache, batch_size=b, num_beams=self.num_beams,
            max_length=self.max_new_tokens, min_new_tokens=self.min_new_tokens,
            eos_token_id=cfg.eos_token_id, pad_token_id=cfg.pad_token_id,
            decoder_start_token_id=cfg.decoder_start_token_id, device=enc.device)

    def loss(self, batch: Dict[str, Any]) -> torch.Tensor:
        """Teacher-forced span loss of a ``prepare_mr_batch`` batch (the
        JAX ``_loss_fn``). The encoder bias comes from the per-length cache
        while the rel-pos table is frozen, and is computed in the graph from
        the table when it trains."""
        tensors = self._to_device(batch)
        table = self.module.t5.encoder.rel_bias.rel_embedding
        enc_bias = None if table.requires_grad else self._encoder_bias_for(batch)
        embeds, attn = self.module.assemble_encoder_input(
            self.frames_to_t5(tensors), tensors["time_ids"], tensors["src_type"],
            tensors["src_idx"], tensors["int_mask"], tensors["end_ids"],
            tensors["end_mask"], tensors["text_ids"], tensors["text_mask"])
        loss, _ = self.module.loss_from_encoder_input(
            embeds, attn, tensors["target_ids"], tensors["target_mask"],
            position_bias=enc_bias)
        return loss

    # ------------------------------------------------------------- task API
    def forward(self, samples) -> Dict[str, Any]:
        """``{"loss": scalar tensor}``: the span loss on the samples'
        relevant_windows, or under a QA task the answerer's loss."""
        if self.is_qa:
            return self.forward_QA(samples)
        return {"loss": self.loss(self.prepare_mr_batch(samples))}

    __call__ = forward

    @torch.inference_mode()
    def generate_dispatch(self, samples) -> Dict[str, Any]:
        """Host prep + device work; pair with ``generate_collect``. Runs in
        eval mode (every dropout off, as the JAX generate is
        deterministic) and restores the module's mode after."""
        batch = self.prepare_mr_batch(samples, need_targets=False)
        tensors = self._to_device(batch)
        enc_bias = self._encoder_bias_for(batch)
        training = self.module.training
        self.module.eval()
        try:
            enc, attn = self.encode_t5(tensors, self.frames_to_t5(tensors), enc_bias)
            seqs, scores = self.decode(enc, attn)
        finally:
            self.module.train(training)
        return {"seqs": seqs, "scores": scores, "samples": samples}

    def generate_collect(self, handle) -> Dict[str, Any]:
        """Copy the beams to the host and post-process them."""
        samples = handle["samples"]
        seqs = handle["seqs"].cpu().numpy()
        pred_ans = self.tokenizer.batch_decode(seqs, skip_special_tokens=True)
        out: Dict[str, Any] = {}
        out["duration"] = [float(d) for d in np.asarray(samples["duration"])]
        prediction = [post_process(p) for p in pred_ans]
        if self.input_time_format in ("relative_integers", "relative_floats"):
            prediction = convert_to_absolute_time(prediction, out["duration"],
                                                  self.input_time_format)
        out["prediction"] = prediction
        out["raw_prediction"] = pred_ans
        out["answer"] = samples.get("relevant_windows")
        out["qid"] = samples.get("query_id")
        return out

    def generate(self, samples) -> Dict[str, Any]:
        """Span generation: beam search -> decode -> grammar repair."""
        return self.generate_collect(self.generate_dispatch(samples))

    # --------------------------------------------------------- QA two-stage
    def get_relevant_frames(self, samples, relevant_moments_out, n_frames):
        """Crop the already-decoded frames to the predicted windows ->
        (moments, frames). ``[[-1, -1]]`` (no valid span) means the whole
        video; an end past the duration is cut to it."""
        relevant_moments = _moments_from_strings(
            relevant_moments_out, samples["duration"], float)
        frames = self.extract_frames(samples, relevant_moments, n_frames)
        return relevant_moments, frames

    def extract_frames(self, samples, relevant_moments, n_frames):
        """``n_frames`` frames of each video between the frames nearest to
        its moment's start and end: the last one repeated when there are
        fewer, evenly spaced picks when there are more. uint8 stays uint8
        (the answerer normalizes on the device by dtype). Frames a loader put
        on the device are cropped there and stay there."""
        video = samples["video"]
        if isinstance(video, torch.Tensor):
            if video.dtype != torch.uint8:
                video = video.float()
            stack = torch.stack
        else:
            video = np.asarray(video)
            if video.dtype != np.uint8:
                video = video.astype(np.float32)
            stack = np.stack
        timestamps = np.asarray(samples["timestamps"], np.float64)
        durations = np.asarray(samples["duration"], np.float64)
        out = []
        for i, (start, end) in enumerate(relevant_moments):
            if start >= end:
                end = float(durations[i])
            start_idx = int(np.argmin(np.abs(timestamps[i] - start)))
            end_idx = int(np.argmin(np.abs(timestamps[i] - end)))
            count = end_idx + 1 - start_idx
            if count <= 0:
                raise ValueError("no frames found for the relevant moment "
                                 f"{[start, end]} of video {i}")
            if count < n_frames:
                idxs = np.minimum(np.arange(n_frames), count - 1)
            else:
                idxs = np.linspace(0, count - 1, n_frames).astype(int)
            out.append(video[i, (start_idx + idxs).tolist()])
        return stack(out)

    def submit_window_redecodes(self, samples, relevant_moments, n_frames):
        """Submit every sample's predicted-window re-decode to the video
        reader's decode pool, without waiting -> (moments, pending);
        ``collect_window_redecodes(pending)`` waits for the frames. The
        moments are the localizer's strings (``[[-1, -1]]``, no valid span,
        becomes ``[0, round(duration)]``; an end past the duration is cut to
        ``round(duration)``) or windows as they are (the oracle's). A window
        with ``start >= end`` ends at the duration. Each window's
        ``n_frames`` frames are the eval processor's uniform picks inside it
        (``clip_proposal``), decoded at ``img_size`` x ``img_size`` and kept
        uint8 (the answerer normalizes on the device)."""
        from mr_blip_tpu_torch.datasets.sampling import sample_frame_indices
        from mr_blip_tpu_torch.datasets.video_reader import VideoReader
        from mr_blip_tpu_torch.processors.video_processors import BlipVideoEvalProcessor

        durations = np.asarray(samples["duration"], np.float64)
        if relevant_moments and isinstance(relevant_moments[0], str):
            moments = _moments_from_strings(relevant_moments, durations, round)
        else:
            moments = [list(m) for m in relevant_moments]

        processor = BlipVideoEvalProcessor(
            image_size=self.img_size, n_frms=n_frames, normalize=False)
        readers, tickets = [], []
        for i, (start, end) in enumerate(moments):
            if start >= end:
                end = float(durations[i])
            vr = VideoReader(samples["video_path"][i],
                             width=self.img_size, height=self.img_size)
            indices = sample_frame_indices(
                vlen=len(vr), fps=vr.get_avg_fps(), n_frms=n_frames,
                sampling="uniform", clip_proposal=[start, end])
            readers.append(vr)
            tickets.append(vr.get_batch_async(indices))
        return moments, (readers, tickets, processor)

    def collect_window_redecodes(self, pending):
        """Wait for ``submit_window_redecodes``' frames -> (B, n, H, W, 3)."""
        readers, tickets, processor = pending
        frames = []
        for vr, ticket in zip(readers, tickets):
            frames.append(processor._finish(ticket.result()))
            vr.close()
        return np.stack(frames)

    def get_relevant_frames_resampled(self, samples, relevant_moments, n_frames):
        """Re-decode each predicted window from its video file
        (blip2_mr.py:1167-1230) -> (moments, frames)."""
        moments, pending = self.submit_window_redecodes(
            samples, relevant_moments, n_frames)
        return moments, self.collect_window_redecodes(pending)

    @property
    def answerer(self):
        """The T5 that answers: ``answerer_t5`` under a QA task."""
        return self.module.answerer_t5 if self.is_qa else self.module.t5

    def _qa_tensors(self, samples, with_targets: bool = False):
        frames = samples["relevant_frames"]  # uint8 is normalized on the device
        if isinstance(frames, torch.Tensor):
            if frames.dtype != torch.uint8:
                frames = frames.float()
        else:
            frames = np.asarray(frames)
            if frames.dtype != np.uint8:
                frames = frames.astype(np.float32)
        tok = self.tokenizer
        enc = tok(list(samples["qa_input"]), truncation=True,
                  max_length=self.max_txt_len)
        batch = {"frames": frames, "text_ids": enc.input_ids,
                 "text_mask": enc.attention_mask}
        if with_targets:
            target = tok(list(samples["qa_output"]), truncation=True,
                         max_length=self.max_txt_len)
            batch["target_ids"] = target.input_ids
            batch["target_mask"] = target.attention_mask
        return self._to_device(batch)

    def _qa_encoder_input(self, tensors):
        """(embeds, mask, cached encoder bias or None) of the answerer."""
        name = "answerer_t5" if self.is_qa else "t5"
        embeds, attn = self.module.qa_encoder_input(
            self.frames_to_t5(tensors), tensors["text_ids"],
            tensors["text_mask"], t5=self.answerer)
        table = self.answerer.encoder.rel_bias.rel_embedding
        bias = (None if table.requires_grad
                else self._encoder_bias(embeds.shape[1], name))
        return embeds, attn, bias

    @torch.inference_mode()
    def _qa_answer_scores(self, samples):
        """The answerer's greedy decode over ``samples["relevant_frames"]``
        and ``samples["qa_input"]`` -> (sequences (B, max_new_tokens), scores
        (max_new_tokens, B, V) fp32), in eval mode."""
        tensors = self._qa_tensors(samples)
        t5 = self.answerer
        cfg = self.t5_config
        training = self.module.training
        self.module.eval()
        try:
            embeds, attn, bias = self._qa_encoder_input(tensors)
            enc = self.module.encode(embeds, attn, position_bias=bias, t5=t5)
            cache = t5.decoder.init_cache(enc.shape[0], self.max_new_tokens,
                                          enc.dtype, enc.device)
            return greedy_decode_with_scores(
                self._decode_step_fn(t5, enc, attn), cache,
                batch_size=enc.shape[0], max_length=self.max_new_tokens,
                min_new_tokens=_QA_MIN_NEW_TOKENS,
                eos_token_id=cfg.eos_token_id, pad_token_id=cfg.pad_token_id,
                decoder_start_token_id=cfg.decoder_start_token_id,
                device=enc.device)
        finally:
            self.module.train(training)

    def videoQA_answer(self, samples) -> Dict[str, Any]:
        """Answerer: the option whose letter scores highest at the second
        decoding step."""
        _, scores = self._qa_answer_scores(samples)
        step1 = scores[1][:, self.answer_ids].cpu().numpy()  # (B, 5)
        return {
            "output_text": np.argmax(step1, axis=-1).tolist(),
            "answer": samples["qa_output"],
            "qid": samples.get("question_id"),
            "relevant_moments_gt": samples.get("relevant_windows"),
        }

    # Three steps, so that an evaluation loop can put the next batch's
    # localizer on the device before it collects this batch's answer.
    def videoQA_dispatch(self, samples) -> Dict[str, Any]:
        """Stage 1: the localizer's generate, enqueued."""
        samples = dict(samples)
        if "relevant_windows" not in samples:
            samples["relevant_windows"] = [[0, 0]]
        samples["query_id"] = samples["question_id"]
        handle: Dict[str, Any] = {"samples": samples}
        if self.use_localizer:
            handle["loc"] = self.generate_dispatch(samples)
        return handle

    def videoQA_redecode(self, handle) -> Dict[str, Any]:
        """The moments (the localizer's, the whole video, or under
        ``oracle_localizer`` the ground truth's first window) and the frames
        cropped to them; under ``resample_frames`` the localizer's and the
        oracle's windows are submitted for re-decoding instead, and
        ``handle["pending"]`` holds them until ``videoQA_collect``."""
        samples = handle["samples"]
        durations = np.asarray(samples["duration"], np.float64)
        n = self.num_frames_for_answer
        if self.use_localizer:
            out_mr = self.generate_collect(handle.pop("loc"))
            if self.resample_frames:
                moments, handle["pending"] = self.submit_window_redecodes(
                    samples, out_mr["prediction"], n)
            else:
                moments, handle["frames"] = self.get_relevant_frames(
                    samples, out_mr["prediction"], n)
        elif not self.use_oracle_localizer:
            moments = [[0, float(d)] for d in durations]
            handle["frames"] = self.extract_frames(samples, moments, n)
        else:
            moments = [list(m[0]) for m in np.asarray(samples["relevant_windows"])]
            if self.resample_frames:
                moments, handle["pending"] = self.submit_window_redecodes(
                    samples, moments, n)
            else:
                handle["frames"] = self.extract_frames(samples, moments, n)
        handle["moments"] = moments
        return handle

    def videoQA_collect(self, handle) -> Dict[str, Any]:
        """Stage 2: the answerer over the cropped or re-decoded frames."""
        samples = handle["samples"]
        frames = handle.get("frames")
        if frames is None:
            frames = handle["frames"] = self.collect_window_redecodes(handle["pending"])
        samples["relevant_frames"] = frames
        out_ans = self.videoQA_answer(samples)
        out_ans["relevant_moments"] = [handle["moments"]]
        return out_ans

    def videoQA_generate(self, samples) -> Dict[str, Any]:
        return self.videoQA_collect(self.videoQA_redecode(
            self.videoQA_dispatch(samples)))

    def forward_QA(self, samples) -> Dict[str, Any]:
        """``{"loss"}``: the answerer's teacher-forced loss on
        ``samples["qa_output"]`` over the frames of the localizer's window
        (``with_localizer``) or of the whole video."""
        samples = dict(samples)
        samples["relevant_windows"] = samples.get("relevant_windows", [[0, 0]])
        samples["query_id"] = samples["question_id"]
        n = self.num_frames_for_answer
        if self.use_localizer:
            out_mr = self.generate(samples)
            _, frames = self.get_relevant_frames(samples, out_mr["prediction"], n)
        else:
            durations = np.asarray(samples["duration"], np.float64)
            frames = self.extract_frames(
                samples, [[0, float(d)] for d in durations], n)
        samples["relevant_frames"] = frames
        tensors = self._qa_tensors(samples, with_targets=True)
        embeds, attn, bias = self._qa_encoder_input(tensors)
        loss, _ = self.module.loss_from_encoder_input(
            embeds, attn, tensors["target_ids"], tensors["target_mask"],
            position_bias=bias, t5=self.answerer)
        return {"loss": loss}
