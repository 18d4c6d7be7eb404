"""Pipeline-parallel forward of the whole T5 encoder-decoder stack (the
port's counterpart of ``mr_blip_tpu/models/t5_pipeline.py``).

``parallel/pipeline.py``'s GPipe schedule over both layer stacks: a rank is
one stage and builds (or loads) only its ``num_layers / S`` encoder blocks
and ``num_decoder_layers / S`` decoder blocks, which is what saves memory;
the shared embedding, the two rel-pos tables, the final RMSNorms and the LM
head are on every rank, as the JAX package replicates them. The encoder and
decoder rel-pos biases are materialized once per call from their tables and
ride every stage as pipeline extras; the encoder states ride the decoder's
microbatch dict, so that every stage's cross-attention sees its own
microbatch's memory; then the final norm, and the tied head (x d_model^-0.5
against the embedding) or the LoRA ``lm_head``. The blocks are the port's
``T5Block``, so the encoder's self-attention (a (1, H, N, N) bias with a
key-only mask) reaches the biased flash kernel on the card at N >= 256:
kernel 3 without gradients, kernel 5 with them and kernels 6 and 8 in the
backward.

The pipelined path is deterministic, as in JAX: no dropout (the residual,
FFN and LoRA dropouts are off during the call whatever the module's mode),
so train with ``dropout_rate=0`` under pp, or use dp/tp for dropout runs.

A stage model is a ``T5ForConditionalGeneration`` over the stage's blocks
(``build_stage_model``); ``stage_state_dict`` cuts its tensors from the
whole model's ``state_dict`` (``encoder.block.i`` for the stage's i,
renumbered from 0) and ``global_name`` maps a stage tensor's name back.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Dict

import torch

from mr_blip_tpu_torch.models.t5 import T5Config, T5ForConditionalGeneration
from mr_blip_tpu_torch.parallel.pipeline import pipeline_apply

_BLOCK = re.compile(r"^(encoder|decoder)\.block\.(\d+)\.(.*)$")


def stage_layers(num_layers: int, n_stages: int, stage: int) -> range:
    """The global indices of stage ``stage``'s blocks."""
    assert num_layers % n_stages == 0, (
        f"{num_layers} layers do not split into {n_stages} stages")
    per = num_layers // n_stages
    return range(stage * per, (stage + 1) * per)


def build_stage_model(cfg: T5Config, n_stages: int, device=None,
                      dtype=None) -> T5ForConditionalGeneration:
    """A T5 holding one stage's blocks (and the replicated parts)."""
    stage_cfg = dataclasses.replace(
        cfg, num_layers=len(stage_layers(cfg.num_layers, n_stages, 0)),
        num_decoder_layers=len(stage_layers(cfg.num_decoder_layers, n_stages, 0)))
    return T5ForConditionalGeneration(stage_cfg, device=device, dtype=dtype)


def global_name(name: str, cfg: T5Config, n_stages: int, stage: int) -> str:
    """A stage model's tensor name -> its name in the whole model."""
    m = _BLOCK.match(name)
    if m is None:
        return name
    section, i, rest = m.groups()
    layers = cfg.num_layers if section == "encoder" else cfg.num_decoder_layers
    return f"{section}.block.{stage_layers(layers, n_stages, stage)[int(i)]}.{rest}"


def stack_block_params(state_dict: Dict[str, torch.Tensor], section: str,
                       num_layers: int, n_stages: int, stage: int) -> Dict[str, torch.Tensor]:
    """``{section}.block.i.*`` of the whole model's ``state_dict`` for the
    stage's i, renumbered from 0 (``block.j.*``): the rank's slice of the
    JAX package's stage-stacked block tree."""
    layers = stage_layers(num_layers, n_stages, stage)
    out = {}
    for name, t in state_dict.items():
        m = _BLOCK.match(name)
        if m and m.group(1) == section and int(m.group(2)) in layers:
            out[f"block.{int(m.group(2)) - layers.start}.{m.group(3)}"] = t
    return out


def stage_state_dict(state_dict: Dict[str, torch.Tensor], cfg: T5Config, n_stages: int,
                     stage: int) -> Dict[str, torch.Tensor]:
    """The stage model's ``state_dict`` cut from the whole one's."""
    out = {k: v for k, v in state_dict.items() if not _BLOCK.match(k)}
    for section, layers in (("encoder", cfg.num_layers),
                            ("decoder", cfg.num_decoder_layers)):
        out.update({f"{section}.{k}": v for k, v in stack_block_params(
            state_dict, section, layers, n_stages, stage).items()})
    return out


@contextlib.contextmanager
def _deterministic(module: torch.nn.Module):
    """Eval mode (no dropout) for the call, the modes put back after."""
    modes = [(m, m.training) for m in module.modules()]
    module.train(False)
    try:
        yield
    finally:
        for m, mode in modes:
            m.training = mode


def t5_pipeline_forward(cfg: T5Config, model: T5ForConditionalGeneration,
                        inputs_embeds: torch.Tensor, decoder_input_ids: torch.Tensor,
                        group=None, encoder_mask=None, decoder_mask=None,
                        num_microbatches: int | None = None,
                        compute_dtype=torch.bfloat16, timings: dict | None = None
                        ) -> torch.Tensor:
    """Teacher-forced logits with both layer stacks pipelined over ``group``.

    Args:
        cfg: the whole model's config (all the layers).
        model: this rank's stage (``build_stage_model``), stage = the rank
            in ``group``.
        inputs_embeds: (B, N, d_model) encoder input, the same on every rank.
        decoder_input_ids: (B, T) shifted labels.
        encoder_mask / decoder_mask: (B, N) / (B, T) validity (1 = keep).
        timings: a dict that gets the transfers of the two pipelines under
            "encoder" and "decoder" (``pipeline_apply``'s ``timings``).
    Returns:
        (B, T, vocab) fp32 logits on every rank: the function of
        ``T5ForConditionalGeneration``'s ``encode`` then ``decode`` without
        dropout.
    """
    b, n, _ = inputs_embeds.shape
    t = decoder_input_ids.shape[1]
    dev = inputs_embeds.device
    if encoder_mask is None:
        encoder_mask = torch.ones((b, n), dtype=torch.int32, device=dev)
    if decoder_mask is None:
        decoder_mask = torch.ones((b, t), dtype=torch.int32, device=dev)
    n_stages = torch.distributed.get_world_size(group)
    stage_cfg = model.cfg
    if (stage_cfg.num_layers * n_stages, stage_cfg.num_decoder_layers * n_stages) != (
            cfg.num_layers, cfg.num_decoder_layers):
        raise ValueError(f"a stage of {stage_cfg.num_layers} + {stage_cfg.num_decoder_layers} "
                         f"blocks does not split {cfg.num_layers} + {cfg.num_decoder_layers} "
                         f"over the group")

    def wire_log(name):
        return None if timings is None else timings.setdefault(name, [])

    with _deterministic(model):
        pos_n = torch.arange(n, device=dev)
        pos_t = torch.arange(t, device=dev)
        enc_bias = model.encoder.rel_bias(pos_n, pos_n).to(compute_dtype)
        dec_bias = model.decoder.rel_bias(pos_t, pos_t).to(compute_dtype)
        causal = torch.tril(torch.ones(t, t, dtype=torch.bool, device=dev))[None, None]

        def enc_stage(blocks, tree, bias):
            attn_mask = tree["mask"][:, None, None, :].bool()
            h = tree["h"]
            for blk in blocks:
                h = blk(h, attn_mask, bias)
            return {"h": h, "mask": tree["mask"]}

        enc_out = pipeline_apply(
            enc_stage, model.encoder.block,
            {"h": inputs_embeds.to(compute_dtype), "mask": encoder_mask.to(torch.int32)},
            group, num_microbatches=num_microbatches, extras=(enc_bias,),
            timings=wire_log("encoder"))
        enc_states = model.encoder.final_norm(enc_out["h"])
        dec_in = model.shared(decoder_input_ids)

        def dec_stage(blocks, tree, bias):
            self_mask = causal & tree["dec_mask"][:, None, None, :].bool()
            cross_mask = tree["enc_mask"][:, None, None, :].bool()
            h = tree["h"]
            for blk in blocks:
                h = blk(h, self_mask, bias, tree["enc"], cross_mask)
            return dict(tree, h=h)

        dec_out = pipeline_apply(
            dec_stage, model.decoder.block,
            {"h": dec_in.to(compute_dtype), "enc": enc_states.to(compute_dtype),
             "enc_mask": encoder_mask.to(torch.int32),
             "dec_mask": decoder_mask.to(torch.int32)},
            group, num_microbatches=num_microbatches, extras=(dec_bias,),
            timings=wire_log("decoder"))
        h = model.decoder.final_norm(dec_out["h"])
        return model.logits(h).float()
