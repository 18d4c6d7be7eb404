#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``mr_blip_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA H100 (sm_90a),
the CUDA toolkit (nvcc) and PyTorch built for CUDA. It imports no JAX.
Phases, each printing its own lines; any failure raises, so the exit code
is nonzero and the final line is not printed:

1. device: the card's name and power limit, torch and CUDA versions;
2. build: nvcc compiles ``mr_blip_tpu_torch/csrc/*.cu`` for sm_90a;
3. kernel vs plain on the card: each hand kernel against its plain PyTorch
   version (fp32 math from the same bf16 inputs) at the main paths' shapes
   and the ragged ones (2049, 2040 x 2048, 300, a fully masked batch row),
   with no NaN: forward outputs max |diff| <= 0.02; the forwards'
   logsumexp (kernels 5 and 9) <= 1e-3; the backward outputs dq, dk, dv and dbias
   (kernels 6-8) max |diff| <= 0.02 x max |plain| and cosine >= 0.999. The
   four W8A8 kernels (13-16) against their plain versions (the same integer
   arithmetic, products exact in fp64): linear at (61,677, 1,408)^2 with a
   residual and at its three main-path shapes (Q-Former cross K/V with bias,
   T5 qkv with the RMS pre-norm, T5 o with the residual), max |diff| <= 0.35;
   GELU MLP (61,677, 1,408, 6,144) with LN and residual <= 0.4; gated MLP
   (8,191, 2,048, 5,120) and its main-path shape <= 0.4; attention block
   (6, 264, 1,408) with n_valid 257 and large garbage in the pad rows (which
   must not move a valid row by a bit) and (240, 257, 1,408) <= 0.05; each
   with cosine >= 0.999, and the share of elements more than 2 bf16 ulps off
   printed (a flipped requantization step moves one row); a float32 input on
   the card must raise. Kernels 3 and 5 in fp32 (the parity mode's CUDA-core
   body) at 4 x 2,056 and at 4 x 2,049 with a ragged key mask, kernel 3
   through the dispatch: max |diff| <= 1e-4 x max |plain|, lse <= 1e-3; a
   float16 call must raise. Times by CUDA events, median of 10 launches: the
   kernel, its plain version and, where one PyTorch call computes the same
   function, that call (``library_ms``: ``F.layer_norm``;
   ``scaled_dot_product_attention``, with the bias as ``attn_mask`` for
   kernels 3 and 5; its autograd backward, dq, dk and dv together, as the
   one number for kernels 6-8; ``torch._int_mm`` between the plain quantize
   and dequantize passes for kernel 13; none for 14-16), each timed line
   with the ratio kernel / library of the same call. ``bound_ms`` is the
   least time the card could take: the larger of the bytes (inputs once,
   outputs once) over 3.35 TB/s and the operations over the dense peak of
   their type (989 TFLOP/s bf16, 1,979 TOP/s int8; H100 SXM data sheet).
   The four in-kernel rel-pos flash kernels (9-12; table at N(0, 1), 32
   buckets, max distance 128) against their plain versions (the bias
   materialized from the table) at the long-context shapes (1 and 4 x 8,000
   x H 32, the train micro-batch's and the generate batch's; the plain
   versions run there one batch row and 8 heads at a time), at 4 x 4,008
   (120 frames) and at 2,049, 1,037, 300, 257 (near tiles only), with ragged
   key masks and a fully masked batch row: the same bars as kernels 5-8,
   dtable max |diff| <= 0.02 x max |plain| and bit-equal between two
   launches; the plain version with the table zeroed must fail the bar; a
   float32 call on the card must raise. Kernel 9 is timed at the generate
   shape, with kernel 3 on the same inputs and the materialized 3.8 GiB bias
   beside it (held against the same plain output, bar 0.02, and timed),
   kernels 10-12 at the train shape; their
   ``library_ms`` is ``scaled_dot_product_attention`` with the materialized
   bias as ``attn_mask`` (built outside the timed region), its autograd
   backward for 10-12, and their ``plain_ms`` the chunked plain forward and
   backward together;
4. generate path: ``BLIP2_MR(...).generate`` at full EVA ViT-g + Q-Former +
   Flan-T5-XL width with random weights, 2 batches of 4 videos x 60 uint8
   frames; every kernel's launch count must rise by its expected number per
   batch, predictions must parse and beam scores be finite;
5. kernel path vs plain path: one reduced-depth full-width model, its T5
   rel-pos table redrawn at N(0, 1) so the bias moves the attention, run in
   bf16 on the CPU (plain versions) and on the card (kernels); the T5
   encoder outputs must agree row by row (cosine >= 0.999), and the plain
   path with the bias left out must not (so a kernel that dropped the bias
   would fail);
6. train path: the LoRA step of the full-depth, full-width
   ``qformer_freeze_lora`` model through ``TrainCtx`` (lr 3e-4, weight
   decay 0.05, ``accum_grad_iters`` 2, dropouts on) over 4 micro-batches of
   4 x 60 frames, so 2 optimizer updates; per micro-batch kernels 5, 6 and 8
   must launch 24 times each (once per encoder layer), kernels 3 and 7 never,
   LayerNorm 110 and packed QKV 39 times; every loss finite, every LoRA
   gradient finite and nonzero before each update (weight decay alone
   would move a LoRA tensor with no gradient), every LoRA tensor changed by
   each update, every frozen tensor bit-identical; prints
   seconds per micro-batch (forward / backward / optimizer), peak memory and
   the trainable parameter count;
7. gradients, kernel path vs plain path: the depth-2 full-width model (rel-pos
   table at N(0, 1), T5 query projections at HF T5's init scale), dropouts
   off, one forward and backward each for ``qformer_freeze_lora``, ``lora``
   (the Q-Former trains: the LayerNorm backward runs on the card) and
   ``qformer_freeze`` (the full-finetune backward: the rel-pos table trains
   and kernel 7 launches once per encoder layer), on the card and on the CPU
   in bf16; relative loss difference <= 1e-2 and, per trainable tensor,
   gradient cosine >= 0.99.

8. int8 generate path: the same full-depth, full-width model after
   ``quantize_for_inference()``, 2 batches of 4 x 60 uint8 frames, beam 5;
   per batch the fused attention block (kernel 16) and the GELU MLP (14)
   must launch 39 times each, the W8A8 linear (13) 54 times (6 Q-Former
   cross layers + 2 per T5 encoder layer), the gated MLP (15) 24 times, the
   biased flash forward (3) 24 times, LayerNorm (1) 32 times (110 less the
   78 ViT block norms, which the int8 kernels compute) and the packed QKV
   kernel (2) never; predictions parse, beam scores finite; prints seconds
   per batch, the three stage times and peak memory beside phase 4's;
9. int8 kernel path vs int8 plain path: the depth-2 full-width model (rel-pos
   table at N(0, 1), T5 query projections at HF T5's init scale) after
   ``quantize_for_inference()``, in bf16 on the CPU (plain versions) and on
   the card (kernels): T5 encoder outputs cosine >= 0.999 row by row and
   first-step decoder logits cosine >= 0.999 per row; and on the card int8
   against bf16: cosine > 0.99 for both.

10. long-context generate path: ``BLIP2_MR(..., relpos_in_kernel=True)`` at
    full depth and width, 2 batches of 4 videos x 240 uint8 frames (encoder
    length 8,000), beam 5, in bf16 and after ``quantize_for_inference()``;
    per batch kernel 9 must launch 24 times and kernel 3 never, the other
    counts are those of phases 4 and 8 (the ViT takes the 960 frames of a
    batch in one call), and no (1, H, L, L) bias may exist (the per-length
    bias cache stays empty); then the same two batches with
    ``relpos_in_kernel=False`` (kernel 3 over the materialized bias), and one
    line with the three runs' seconds per batch, stage times and peak memory;
11. long-context train path: phase 6 with ``relpos_in_kernel=True`` over 4
    micro-batches of 1 video x 240 frames; per micro-batch kernels 9, 10 and
    12 must launch 24 times each, kernels 3, 5-8 and 11 never;
12. long context, kernel path vs plain path: the depth-2 full-width
    ``relpos_in_kernel`` model (weights as in phase 7), one forward and
    backward on the card and on the CPU in bf16: ``qformer_freeze_lora`` at
    1 x 240 frames (also against the card's own ``relpos_in_kernel=False``
    run of the same weights) and ``qformer_freeze`` at 1 x 120 frames (the
    rel-pos table trains: kernel 11 launches once per encoder layer and the
    table's gradient is compared with the plain path's); T5 encoder rows
    cosine >= 0.999, loss and gradients within phase 7's bars.

13. generate at 364 pixels (the resolution of BLIP-2's finetuned checkpoints
    and the default of the package's processors): ``BLIP2_MR(img_size=364)``
    at full depth and width, bf16, 2 batches of 4 x 60 uint8 frames at 364²,
    beam 5. 677 tokens an image are past the packed-QKV kernel's bound, so
    per batch kernel 4 (``flash_attention``) must launch 39 times and the
    packed-QKV kernel never; LayerNorm 110, biased flash 24. Prints seconds
    per batch, the three stage times and peak memory beside phase 4's. Then
    the same two batches after ``quantize_for_inference()``: the int8 ViT's
    split route, per batch kernel 4 39 times, the W8A8 linear 132 (54 as in
    phase 8 and 2 per ViT block), the GELU MLP 39, the fused attention block
    never, LayerNorm 32. Then the fp32 parity mode: the depth-2 model with
    ``compute_dtype="float32"`` at 224 pixels generates one batch of 4 x 60
    frames (encoder length 2,056) with kernel 4's and kernel 3's fp32
    instantiations once per ViT block and per encoder layer and no other
    kernel, and its frame features and T5 encoder rows must agree with the
    CPU's fp32 plain path to 1e-4 of their largest magnitude;
14. grounded QA at 364 pixels: ``BLIP2_MR(img_size=364,
    task="qformer_freeze_lora_QA_with_localizer", num_frames_for_answer=60)``
    (``configs/projects/eval/nextGQA.yaml`` but for ``resample_frames`` and
    the image size), full depth and width, 2 batches of 4 videos x 60 frames
    with five-option questions through ``videoQA_generate``; per batch kernel
    4 must launch 78 times (the localizer's ViT and the answerer's), biased
    flash 48, LayerNorm 220; every prediction in 0..4, every moment inside
    its video, the answerer's A-E logits finite, its encoder length the 2,040
    that phase 3 holds kernel 3 at; prints seconds per batch
    split into localizer, frame crop and answerer, and peak memory;
15. 364 pixels and QA, kernel path vs plain path: the depth-2 full-width
    ``qformer_freeze_lora_QA`` model (weights as in phase 7, both T5 stacks)
    on 2 x 8 frames at 364², in bf16 on the CPU and on the card: ViT output
    rows and T5 encoder rows cosine >= 0.999, the answerer's A-E logits
    cosine >= 0.999 per row; the same after ``quantize_vit()`` (the split
    int8 route: W8A8 linear, kernel 4, W8A8 linear per block, no fused
    block); and on the card ``set_attention_backend("xla")`` against
    ``"auto"`` (no flash launch, ViT rows cosine >= 0.999).

Phase 3 also holds kernel 4 (``flash_attention``) against its plain version:
(240, 677, H 16, D 88) bf16 through the strided q/k/v views of a packed QKV
tensor, max |diff| <= 0.02; (240, 257, 16, 88) fp32, max |diff| <= 1e-4 x max
|plain|; rectangular (4, 300, 32, 64) x 2,049 keys and (2, 1,037, 8, 64), each
with and without ``causal``, in both types; a call whose gradient is taken
(the recompute backward against the plain gradient, cosine >= 0.999); float16
and a head dim of 104 on the card must raise. It is timed at the 364-pixel
shape beside its plain version, ``scaled_dot_product_attention`` and kernel 2
on the same packed tensor, and at (240, 257) in bf16 beside kernel 2 again.
The other kernels of the 364-pixel paths are held at the shapes those paths
give them: LayerNorm at (162,480, 1,408) (240 x 677 ViT rows), the biased
flash forward at the answerer's encoder length (4 x 2,040, the last 5 keys
masked), the W8A8 linear at the two shapes of the split int8 ViT route
((162,480, 1,408) x 4,224 with LN and bias, x 1,408 with the residual) and
the W8A8 GELU MLP at (162,480, 1,408, 6,144).

The line before the last is one JSON object with every kernel's numbers
(launches: kernels 1-3 from phase 4, 4 from phase 13's 364-pixel run, 5, 6
and 8 from phase 6, 7 from phase 7's ``qformer_freeze`` run, 13-16 from phase
8, 9 from phase 10's bf16 run, 10 and 12 from phase 11, 11 from phase 12's
``qformer_freeze`` run; each count is taken with the counts set to 0 just
before its path runs); the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = 0.02  # max |kernel - plain|, as for the TPU kernels (bf16 outputs)
LSE_TOL = 1e-3  # max |kernel - plain| of the fp32 row logsumexp
GRAD_REL_TOL = 0.02  # backward outputs: max |kernel - plain| / max |plain|
COSINE_MIN = 0.999
N_FRAMES, BATCH, N_BATCHES = 60, 4, 2
REDUCED_DEPTH = 2  # layers per stack in phase 5
# Per generate batch at the flagship depth: LayerNorm 78 (ViT norm1/norm2 x 39)
# + 1 (ln_vision) + 31 (Q-Former); packed QKV once per ViT block; biased
# flash once per T5 encoder layer.
NO_RELPOS_LAUNCHES = {"flash_relpos_fwd_stats": 0, "flash_relpos_bwd_dq": 0,
                      "flash_relpos_bwd_dq_dtable": 0, "flash_relpos_bwd_dkv": 0}
EXPECTED_LAUNCHES = {"layer_norm": 110, "qkv_packed_attention": 39,
                     "flash_attention": 0, "flash_bias_attention": 24, "flash_bias_fwd_stats": 0,
                     "flash_bias_bwd_dq": 0, "flash_bias_bwd_dq_dbias": 0,
                     "flash_bias_bwd_dkv": 0, "w8a8_linear": 0, "w8a8_mlp": 0,
                     "w8a8_mlp_gated": 0, "w8a8_attn_block": 0, **NO_RELPOS_LAUNCHES}
GENERATE_KERNELS = ("layer_norm", "qkv_packed_attention", "flash_bias_attention")
INT8_KERNELS = ("w8a8_linear", "w8a8_mlp", "w8a8_mlp_gated", "w8a8_attn_block")
# Phase 8, per int8 generate batch: the fused attention block and the GELU
# MLP once per ViT block (their pre-norms inside: 78 LayerNorm launches
# fewer), the W8A8 linear for 6 Q-Former cross K/V and 2 per T5 encoder layer,
# the gated MLP and the biased flash once per T5 encoder layer.
EXPECTED_INT8_LAUNCHES = {"layer_norm": 32, "qkv_packed_attention": 0,
                          "flash_attention": 0, "flash_bias_attention": 24, "flash_bias_fwd_stats": 0,
                          "flash_bias_bwd_dq": 0, "flash_bias_bwd_dq_dbias": 0,
                          "flash_bias_bwd_dkv": 0, "w8a8_linear": 54, "w8a8_mlp": 39,
                          "w8a8_mlp_gated": 24, "w8a8_attn_block": 39,
                          **NO_RELPOS_LAUNCHES}
# max |kernel - plain| of the W8A8 kernels (the bars of the TPU kernels' own
# on-chip check) and the ulp distance past which an element is counted.
INT8_TOL = {"w8a8_linear": 0.35, "w8a8_mlp": 0.4, "w8a8_mlp_gated": 0.4,
            "w8a8_attn_block": 0.05}
ULP_BAR = 2
INT8_VS_BF16_COSINE_MIN = 0.99
# Published dense peaks of one H100 SXM (NVIDIA data sheet), for bound_ms.
PEAK_BF16_FLOPS, PEAK_INT8_OPS, PEAK_HBM_BYTES = 989e12, 1979e12, 3.35e12
PEAK_FP32_FLOPS = 67e12  # outside the tensor cores
# Phase 6, the LoRA train step (published config configs/projects/train/
# qvh.yaml: task qformer_freeze_lora, init_lr 3e-4, weight_decay 0.05):
# per micro-batch the forward with statistics, dQ and dK/dV once per T5
# encoder layer; no no-grad forward and no dbias (the table is frozen).
TRAIN_TASK, TRAIN_LR, TRAIN_WEIGHT_DECAY = "qformer_freeze_lora", 3e-4, 0.05
ACCUM, TRAIN_MICRO_BATCHES = 2, 4
EXPECTED_TRAIN_LAUNCHES = dict(EXPECTED_LAUNCHES, flash_bias_attention=0,
                               flash_bias_fwd_stats=24, flash_bias_bwd_dq=24,
                               flash_bias_bwd_dkv=24)
# Phase 7: kernel path vs plain path gradients, per task.
GRAD_TASKS = ("qformer_freeze_lora", "lora", "qformer_freeze")
LOSS_REL_TOL = 1e-2
GRAD_COSINE_MIN = 0.99
RELPOS_TABLE = "t5.encoder.rel_bias.rel_embedding"
# Phases 10-12, the long-context path (relpos_in_kernel=True): 240 frames a
# video, ~7,944 encoder tokens. Every launch count is per call, whatever the
# frame count (the ViT runs all 960 frames of a batch in one call, unchunked),
# so the counts are those of phases 4, 6 and 8 with the rel-pos kernels 9, 10
# and 12 in place of the biased kernels 3, 5, 6 and 8.
LONG_FRAMES, LONG_BATCHES, LONG_TRAIN_BATCH = 240, 2, 1
# The encoder length make_samples gives at 240 frames (7,680 frame tokens, the
# interleaved timestamps, the prompts, padded to a multiple of 8): the length
# phase 3 holds kernels 9-12 at, and phases 10 and 11 must show.
LONG_ENCODER_LENGTH = 8000
EXPECTED_LONG_LAUNCHES = dict(EXPECTED_LAUNCHES, flash_bias_attention=0,
                              flash_relpos_fwd_stats=24)
EXPECTED_LONG_INT8_LAUNCHES = dict(EXPECTED_INT8_LAUNCHES, flash_bias_attention=0,
                                   flash_relpos_fwd_stats=24)
EXPECTED_LONG_TRAIN_LAUNCHES = dict(EXPECTED_LONG_LAUNCHES, flash_relpos_bwd_dq=24,
                                    flash_relpos_bwd_dkv=24)
# Phase 12, (task, frames): the CPU plain path takes ~130 s at 1 x 240 frames,
# so only the LoRA task (the train path of phase 11) runs at the full length.
LONG_GRAD_TASKS = (("qformer_freeze_lora", 240), ("qformer_freeze", 120))
# Phases 13-15, 364 pixels: 26 x 26 patches + cls = 677 tokens an image, whose
# packed QKV (677 x 4,224 x 2 B = 5.7 MB) is past the 4 MiB bound of the
# packed-QKV kernel and of the fused int8 block, so the ViT's attention is
# kernel 4 once per block. The QA batch runs the ViT, the Q-Former and a T5
# encoder twice (localizer, then answerer).
BIG_IMG, BIG_TOKENS, BIG_BATCHES = 364, 677, 2
EXPECTED_BIG_LAUNCHES = dict(EXPECTED_LAUNCHES, qkv_packed_attention=0,
                             flash_attention=39)
EXPECTED_QA_LAUNCHES = dict(EXPECTED_LAUNCHES, qkv_packed_attention=0,
                            flash_attention=78, flash_bias_attention=48,
                            layer_norm=220)
QA_ANSWER_FRAMES = 60
# The answerer's encoder length over make_qa_samples: 60 x 32 frame tokens and
# the 115 tokens of the question with its options, padded to a multiple of 8.
# Phase 3 holds kernel 3 at this length, and phase 14 must show it.
QA_ENCODER_TOKENS = QA_ANSWER_FRAMES * 32 + 115
QA_ENCODER_LENGTH = -(-QA_ENCODER_TOKENS // 8) * 8
# The int8 model at 364 pixels: the ViT's split route, per block the W8A8 linear
# twice (qkv with the LN pre-norm, proj with the residual) around kernel 4, and
# the GELU MLP; the fused attention block never.
EXPECTED_BIG_INT8_LAUNCHES = dict(EXPECTED_INT8_LAUNCHES, flash_attention=39,
                                  w8a8_attn_block=0, w8a8_linear=54 + 2 * 39)
FP32_REL_TOL = 1e-4   # kernels 3-5 in fp32: max |kernel - plain| / max |plain|
FP32_FRAMES = 60      # frames a video in the fp32 run: encoder length 2,056 (kernel 3)
FP32_PATH_REL_TOL = 1e-4


def say(*parts):
    print(*parts, flush=True)


def require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


# ------------------------------------------------------------------- timing
def median_ms(torch, fn, iters=10, warmup=2):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def set_bound(entry, nbytes, bf16_flops=0.0, int8_ops=0.0):
    """``bound_ms``: the larger of bytes over the memory rate and operations
    over the peak rate of their type (two types add up: they share the
    tensor cores); ``bound_by`` says which."""
    by_bytes = nbytes / PEAK_HBM_BYTES
    by_ops = bf16_flops / PEAK_BF16_FLOPS + int8_ops / PEAK_INT8_OPS
    entry["bound_ms"] = 1e3 * max(by_bytes, by_ops)
    entry["bound_by"] = "bytes" if by_bytes >= by_ops else "operations"


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def timing_line(entry):
    lib = entry.get("library_ms")
    return (f"  kernel {entry['ms']:.4f} ms  plain {entry['plain_ms']:.4f} ms  library "
            + (f"{lib:.4f} ms (kernel / library {entry['ms'] / lib:.2f}x)"
               if lib is not None else "none")
            + f"  bound {entry['bound_ms']:.4f} ms ({entry['bound_by']})")


def max_err(torch, got, want):
    require(not torch.isnan(got).any(), "kernel output has NaN")
    require(bool(torch.isfinite(got).all()), "kernel output not finite")
    return float((got.float() - want.float()).abs().max())


# --------------------------------------------------------------- phase 3
def check_kernels(torch, kernels):
    import torch.nn.functional as F

    from mr_blip_tpu_torch.ops import flash_attention as fa
    from mr_blip_tpu_torch.ops.layer_norm import _ln_reference, fused_layer_norm

    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    # LayerNorm: weights near 1 keep |y| < 8, where bf16 rounds within 0.016.
    ln = kernels["layer_norm"]
    for rows, d, eps, flagship in ((61680, 1408, 1e-6, True),
                                   # the ViT's norms at 364 pixels: 240 x 677 rows
                                   (BATCH * N_FRAMES * BIG_TOKENS, 1408, 1e-6, False),
                                   (1001, 1408, 1e-5, False),
                                   (7680, 768, 1e-12, False)):
        x = randn(rows, d, scale=2.0)
        w = randn(d, scale=0.1, dtype=torch.float32) + 1.0
        b = randn(d, scale=0.1, dtype=torch.float32)
        got = fused_layer_norm(x, w, b, eps)
        torch.cuda.synchronize()
        err = max_err(torch, got, _ln_reference(x.float(), w, b, eps))
        line = f"layer_norm ({rows}, {d}) eps {eps:g}: max|diff| {err:.5f}"
        if flagship:
            ln["ms"] = median_ms(torch, lambda: fused_layer_norm(x, w, b, eps))
            ln["plain_ms"] = median_ms(torch, lambda: _ln_reference(x, w, b, eps))
            w16, b16 = w.to(x.dtype), b.to(x.dtype)
            ln["library_ms"] = median_ms(
                torch, lambda: F.layer_norm(x, (d,), w16, b16, eps))
            set_bound(ln, nbytes(x, got, w, b))
            line += timing_line(ln)
        say(line)
        require(err <= TOL, f"layer_norm ({rows}, {d}) off by {err}")
        ln["max_abs_err"] = max(ln.get("max_abs_err", 0.0), err)

    qk = kernels["qkv_packed_attention"]
    heads, hd = 16, 88
    for b, n, n_valid, flagship in ((240, 257, 0, True), (4, 264, 257, False)):
        qkv = randn(b, n, 3 * heads * hd)
        if n_valid:
            # Large values in the pad rows: wrong masking shows at once.
            qkv[:, n_valid:] *= 7.0
        got = fa.flash_attention_qkv_packed(qkv, heads, n_valid=n_valid)
        torch.cuda.synchronize()
        want = fa._qkv_packed_reference(qkv.float(), heads, hd, n_valid)
        err = max_err(torch, got, want)
        line = f"qkv_packed ({b}, {n}, {3 * heads * hd}) n_valid {n_valid}: max|diff| {err:.5f}"
        if flagship:
            qk["ms"] = median_ms(torch, lambda: fa.flash_attention_qkv_packed(qkv, heads))
            qk["plain_ms"] = median_ms(
                torch, lambda: fa._qkv_packed_reference(qkv, heads, hd))
            # (B, H, N, D) views of the packed tensor for the library call.
            q4, k4, v4 = (t.reshape(b, n, heads, hd).transpose(1, 2)
                          for t in qkv.split(heads * hd, dim=-1))
            qk["library_ms"] = median_ms(
                torch, lambda: F.scaled_dot_product_attention(q4, k4, v4))
            set_bound(qk, nbytes(qkv, got), bf16_flops=4.0 * b * heads * n * n * hd)
            line += timing_line(qk)
        say(line)
        require(err <= TOL, f"qkv_packed ({b}, {n}) off by {err}")
        qk["max_abs_err"] = max(qk.get("max_abs_err", 0.0), err)

    fb = kernels["flash_bias_attention"]
    heads, d = 32, 64
    for b, n, m, mask_kind, flagship in ((4, 2049, 2049, "tail", False),
                                         (4, 2056, 2056, None, True),
                                         (4, 2040, 2048, "tail", False),
                                         # the QA answerer's encoder: frames, then
                                         # the question, padded to a multiple of 8
                                         (4, QA_ENCODER_LENGTH, QA_ENCODER_LENGTH, "pad",
                                          False),
                                         (2, 300, 300, None, False),
                                         (2, 300, 300, "row1_all", False)):
        q = randn(b, n, heads, d)
        k, v = randn(b, m, heads, d), randn(b, m, heads, d)
        bias = randn(1, heads, n, m)
        kv_mask = None
        if mask_kind == "tail":
            lengths = torch.tensor([m, m - 1, m - 100, 1500], device=dev)
            kv_mask = (torch.arange(m, device=dev)[None] < lengths[:, None]).to(torch.int8)
        elif mask_kind == "pad":
            kv_mask = (torch.arange(m, device=dev)[None].expand(b, m)
                       < QA_ENCODER_TOKENS).to(torch.int8)
        elif mask_kind == "row1_all":
            kv_mask = torch.ones(b, m, dtype=torch.int8, device=dev)
            kv_mask[1] = 0
        got = fa.flash_attention_bias(q, k, v, bias, kv_mask)
        torch.cuda.synchronize()
        want = fa._flash_bias_fwd_stats_reference(q.float(), k.float(), v.float(),
                                                  bias.float(), kv_mask)[0]
        err = max_err(torch, got, want)
        line = (f"flash_bias ({b}, {n}x{m}, {heads}, {d}) mask {mask_kind}: "
                f"max|diff| {err:.5f}")
        if flagship:
            fb["ms"] = median_ms(torch, lambda: fa.flash_attention_bias(q, k, v, bias, kv_mask))
            fb["plain_ms"] = median_ms(
                torch, lambda: fa._flash_bias_fwd_stats_reference(q, k, v, bias, kv_mask))
            q4, k4, v4 = (t.transpose(1, 2) for t in (q, k, v))
            fb["library_ms"] = median_ms(
                torch, lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=bias))
            set_bound(fb, nbytes(q, k, v, bias, got),
                      bf16_flops=4.0 * b * heads * n * m * d)
            line += timing_line(fb)
        say(line)
        require(err <= TOL, f"flash_bias ({b}, {n}x{m}) mask {mask_kind} off by {err}")
        fb["max_abs_err"] = max(fb.get("max_abs_err", 0.0), err)

    del q, k, v, bias, qkv, x
    torch.cuda.empty_cache()
    check_fp32_bias_kernels(torch, heads, d)


def check_fp32_bias_kernels(torch, heads, d):
    """Kernels 3 and 5 in fp32 (the parity mode, CUDA-core FMAs), kernel 3
    through the dispatch as the fp32 model reaches it: out within
    FP32_REL_TOL x max |plain|, lse within LSE_TOL; a dtype neither kernel
    takes must raise rather than run plain."""
    import torch.nn.functional as F

    from mr_blip_tpu_torch.ops import flash_attention as fa
    from mr_blip_tpu_torch.ops.attention import dot_product_attention

    gen = torch.Generator(device="cuda").manual_seed(5)
    dev = "cuda"

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    for b, n, mask_kind in ((4, 2056, None), (4, 2049, "tail")):
        q, k, v = randn(b, n, heads, d), randn(b, n, heads, d), randn(b, n, heads, d)
        bias = randn(1, heads, n, n)
        kv_mask, mask4 = None, None
        if mask_kind == "tail":
            lengths = torch.tensor([n, n - 1, n - 100, 1500], device=dev)
            kv_mask = (torch.arange(n, device=dev)[None] < lengths[:, None]).to(torch.int8)
            mask4 = (kv_mask != 0)[:, None, None, :]
        before = fa.flash_attention_bias.launches
        got3 = dot_product_attention(q, k, v, bias=bias, mask=mask4)
        require(fa.flash_attention_bias.launches == before + 1,
                "fp32 biased attention did not launch kernel 3")
        before = fa.flash_bias_fwd_stats.launches
        got5, lse5 = fa.flash_bias_fwd_stats(q, k, v, bias, kv_mask)
        require(fa.flash_bias_fwd_stats.launches == before + 1,
                "fp32 flash_bias_fwd_stats did not launch kernel 5")
        torch.cuda.synchronize()
        want, lse_want = fa._flash_bias_fwd_stats_reference(q, k, v, bias, kv_mask)
        scale = float(want.abs().max())
        bar = FP32_REL_TOL * scale
        err3, err5 = max_err(torch, got3, want), max_err(torch, got5, want)
        err_lse = max_err(torch, lse5, lse_want)
        line = (f"flash_bias float32 ({b}, {n}x{n}, {heads}, {d}) mask {mask_kind}: "
                f"kernel 3 max|diff| {err3:.3e}, kernel 5 {err5:.3e} (bar {bar:.3e}, "
                f"max|plain| {scale:.4f}), lse {err_lse:.3e}")
        if mask_kind is None:
            ms = median_ms(torch, lambda: fa.flash_attention_bias(q, k, v, bias, kv_mask))
            q4, k4, v4 = (t.transpose(1, 2) for t in (q, k, v))
            lib_ms = median_ms(torch, lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=bias))
            line += (f"; kernel 3 {ms:.4f} ms, library {lib_ms:.4f} ms (kernel / library "
                     f"{ms / lib_ms:.2f}x), bound {1e3 * 4.0 * b * heads * n * n * d / PEAK_FP32_FLOPS:.4f} "
                     f"ms (operations, fp32 outside the tensor cores)")
        say(line)
        require(got3.dtype == torch.float32 and got5.dtype == torch.float32,
                f"fp32 kernels 3/5 returned {got3.dtype}, {got5.dtype}")
        require(err3 <= bar and err5 <= bar,
                f"fp32 kernels 3/5 ({b}, {n}) mask {mask_kind} off by {err3}, {err5} > {bar}")
        require(err_lse <= LSE_TOL, f"fp32 kernel 5 ({b}, {n}): lse off by {err_lse}")
        del q, k, v, bias, got3, got5, lse5, want, lse_want
        torch.cuda.empty_cache()

    # A dtype neither kernel takes raises rather than running plain.
    before = fa.flash_attention_bias.launches
    q16 = randn(2, 300, heads, d).to(torch.float16)
    try:
        dot_product_attention(q16, q16, q16, bias=randn(1, heads, 300, 300).half())
    except TypeError as exc:
        say(f"float16 biased attention on the card raises: {exc}")
    else:
        raise RuntimeError("float16 biased attention on the card ran plain")
    require(fa.flash_attention_bias.launches == before,
            "float16 biased attention counted a launch")


def cosine(torch, got, want):
    return float(torch.nn.functional.cosine_similarity(
        got.float().flatten(), want.float().flatten(), dim=0))


def check_flash_kernel(torch, kernels):
    """Kernel 4 (``flash_attention``: no bias, no key mask, optionally causal)
    against its plain version, fp32 math from the same inputs: bf16 outputs
    max |diff| <= 0.02, fp32 outputs <= 1e-4 x max |plain|."""
    import torch.nn.functional as F

    from mr_blip_tpu_torch.ops import flash_attention as fa
    from mr_blip_tpu_torch.ops.attention import dot_product_attention

    gen = torch.Generator(device="cuda").manual_seed(4)
    dev = "cuda"
    entry = kernels["flash_attention"]

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def plain(q, k, v, causal, chunk=60):
        """The plain version in fp32, ``chunk`` batch rows at a time (its
        (B, H, N, M) temporaries are 7 GB each at 240 x 16 x 677²)."""
        return torch.cat([fa._flash_reference(q[i:i + chunk].float(), k[i:i + chunk].float(),
                                              v[i:i + chunk].float(), causal)
                          for i in range(0, q.shape[0], chunk)])

    def hold(label, got, want, dtype):
        torch.cuda.synchronize()
        err = max_err(torch, got, want)
        scale = float(want.abs().max())
        bar = TOL if dtype == torch.bfloat16 else FP32_REL_TOL * scale
        say(f"flash_attention {label} {str(dtype)[6:]}: max|diff| {err:.3e} "
            f"(bar {bar:.3e}, max|plain| {scale:.4f})")
        require(got.dtype == dtype and got.is_contiguous(), f"flash_attention {label}: "
                f"output {got.dtype}, contiguous {got.is_contiguous()}")
        require(err <= bar, f"flash_attention {label} {dtype} off by {err} > {bar}")
        return err

    # The ViT's shapes, through the strided q/k/v views of a packed QKV
    # tensor: 364 pixels in bf16 (timed), 224 pixels in fp32.
    heads, hd = 16, 88
    for b, n, dtype in ((240, BIG_TOKENS, torch.bfloat16), (240, 257, torch.float32),
                        (240, 257, torch.bfloat16)):
        qkv = randn(b, n, 3 * heads * hd, dtype=dtype)
        q, k, v = qkv.view(b, n, 3, heads, hd).unbind(2)
        require(not q.is_contiguous(), "the q view of the packed tensor is contiguous")
        before = fa.flash_attention.launches
        got = fa.flash_attention(q, k, v)
        require(fa.flash_attention.launches == before + 1, "flash_attention counted no launch")
        want = plain(q, k, v, False)
        label = f"({b}, {n}, {heads}, {hd}) packed views"
        err = hold(label, got, want, dtype)
        flops = 4.0 * b * heads * n * n * hd
        ms = median_ms(torch, lambda: fa.flash_attention(q, k, v))
        q4, k4, v4 = (t.transpose(1, 2) for t in (q, k, v))
        lib_ms = median_ms(torch, lambda: F.scaled_dot_product_attention(q4, k4, v4))
        if dtype == torch.bfloat16 and n == 257:
            # Kernel 2's own shape (the ViT at 224 pixels): the two kernels'
            # times side by side, for the choice of one body for both.
            k2_ms = median_ms(torch, lambda: fa.flash_attention_qkv_packed(qkv, heads))
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
            say(f"flash_attention {label}: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} "
                f"TFLOP/s), library {lib_ms:.4f} ms (kernel / library {ms / lib_ms:.2f}x); "
                f"kernel 2 (qkv_packed_attention) on "
                f"the same packed tensor: {k2_ms:.4f} ms")
        elif dtype == torch.bfloat16:
            entry["max_abs_err"] = err
            entry["ms"] = ms
            entry["plain_ms"] = median_ms(torch, lambda: fa._flash_reference(q, k, v),
                                          iters=3, warmup=1)
            entry["library_ms"] = lib_ms
            set_bound(entry, nbytes(qkv, got), bf16_flops=flops)
            # Kernel 2 takes the same packed tensor (the ViT's gate keeps it
            # off this shape): its time and error beside kernel 4's.
            got2 = fa.flash_attention_qkv_packed(qkv, heads)
            err2 = max_err(torch, got2, want.reshape(b, n, heads * hd))
            k2_ms = median_ms(torch, lambda: fa.flash_attention_qkv_packed(qkv, heads))
            say(f"flash_attention {label}:" + timing_line(entry)
                + f"  ({flops / ms / 1e9:.1f} TFLOP/s); kernel 2 (qkv_packed_attention) on "
                f"the same packed tensor: {k2_ms:.4f} ms, max|diff| {err2:.5f}")
            require(err2 <= TOL, f"qkv_packed at {n} tokens off by {err2}")
            del got2
        else:
            by_ops = 1e3 * flops / PEAK_FP32_FLOPS
            say(f"flash_attention {label} float32: kernel {ms:.4f} ms "
                f"({flops / ms / 1e9:.1f} TFLOP/s), library {lib_ms:.4f} ms, bound "
                f"{by_ops:.4f} ms (operations, fp32 outside the tensor cores)")
        del qkv, q, k, v, q4, k4, v4, got, want
        torch.cuda.empty_cache()

    # Rectangular and causal, ragged lengths, both types.
    for b, n, m, h, d in ((4, 300, 2049, 32, 64), (2, 1037, 1037, 8, 64)):
        for dtype in (torch.bfloat16, torch.float32):
            q = randn(b, n, h, d, dtype=dtype)
            k, v = randn(b, m, h, d, dtype=dtype), randn(b, m, h, d, dtype=dtype)
            for causal in (False, True):
                got = fa.flash_attention(q, k, v, causal=causal)
                err = hold(f"({b}, {n}x{m}, {h}, {d}) causal {causal}", got,
                           plain(q, k, v, causal), dtype)
                if dtype == torch.bfloat16:
                    entry["max_abs_err"] = max(entry["max_abs_err"], err)

    # A call whose gradient is taken: the forward launches the kernel, the
    # backward recomputes the plain version.
    q, k, v = (randn(2, n, 8, 64, dtype=torch.bfloat16).requires_grad_()
               for n in (300, 520, 520))
    dout = randn(2, 300, 8, 64, dtype=torch.bfloat16)
    before = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, causal=True)
    require(fa.flash_attention.launches == before + 1 and out.grad_fn is not None,
            "flash_attention under autograd: no launch or no graph")
    grads = torch.autograd.grad(out, (q, k, v), dout)
    leaves = [t.detach().float().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(fa._flash_reference(*leaves, True), leaves, dout.float())
    for name, g, w in zip("qkv", grads, want):
        cos = cosine(torch, g, w)
        say(f"flash_attention gradient d{name}: cosine {cos:.6f}, max|diff| "
            f"{max_err(torch, g, w):.5f}")
        require(cos >= COSINE_MIN, f"flash_attention d{name}: cosine {cos}")

    # The dispatch: 256 queries and more without bias or mask reach the
    # kernel, fewer stay plain; a type or head dim it does not take raises.
    q = randn(2, 256, 4, 64, dtype=torch.bfloat16)
    before = fa.flash_attention.launches
    dot_product_attention(q, q, q)
    dot_product_attention(q[:, :255], q, q)
    require(fa.flash_attention.launches == before + 1,
            "dot_product_attention: the flash dispatch is off")
    for bad, exc_type in ((q.to(torch.float16), TypeError),
                          (randn(2, 256, 4, 104, dtype=torch.bfloat16), ValueError)):
        try:
            dot_product_attention(bad, bad, bad)
        except exc_type as exc:
            say(f"{bad.dtype} head dim {bad.shape[-1]} flash attention on the card "
                f"raises: {exc}")
        else:
            raise RuntimeError(f"{bad.dtype} head dim {bad.shape[-1]} flash attention "
                               "on the card did not raise")
    require(fa.flash_attention.launches == before + 1,
            "a refused flash attention counted a launch")
    torch.cuda.empty_cache()


def check_train_kernels(torch, kernels):
    """Kernels 5-8 against their plain versions (fp32 math from the same
    bf16 inputs; the backward kernels get the plain forward's lse and δ, so
    each is held alone)."""
    from mr_blip_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(1)
    dev = "cuda"

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    heads, d = 32, 64
    for b, n, m, mask_kind, flagship in ((4, 2056, 2056, None, True),
                                         (4, 2049, 2049, "tail", False),
                                         (4, 2040, 2048, "tail", False),
                                         (2, 300, 300, None, False),
                                         (2, 300, 300, "row1_all", False)):
        q, k, v, dout = randn(b, n, heads, d), randn(b, m, heads, d), \
            randn(b, m, heads, d), randn(b, n, heads, d)
        bias = randn(1, heads, n, m)
        kv_mask = torch.ones(b, m, dtype=torch.int8, device=dev)
        if mask_kind == "tail":
            lengths = torch.tensor([m, m - 1, m - 100, 1500], device=dev)
            kv_mask = (torch.arange(m, device=dev)[None] < lengths[:, None]).to(torch.int8)
        elif mask_kind == "row1_all":
            kv_mask[1] = 0
        f32 = [t.float() for t in (q, k, v, bias)]
        out_ref, lse_ref = fa._flash_bias_fwd_stats_reference(*f32, kv_mask)
        delta = torch.einsum("bnhd,bnhd->bhn", dout.float(), out_ref).contiguous()
        bwd_args = (q, k, v, bias, kv_mask, dout, lse_ref, delta)
        dq_r, dk_r, dv_r, dbias_r = fa._flash_bias_bwd_reference(
            *f32, kv_mask, dout.float(), lse_ref, delta)
        out, lse = fa.flash_bias_fwd_stats(q, k, v, bias, kv_mask)
        dq6 = fa.flash_bias_bwd_dq(*bwd_args)
        dq7, dbias7 = fa.flash_bias_bwd_dq_dbias(*bwd_args)
        dk8, dv8 = fa.flash_bias_bwd_dkv(*bwd_args)
        torch.cuda.synchronize()
        shape = f"({b}, {n}x{m}, {heads}, {d}) mask {mask_kind}"
        err_out = max_err(torch, out, out_ref)
        err_lse = max_err(torch, lse, lse_ref)
        say(f"flash_bias_fwd_stats {shape}: out max|diff| {err_out:.5f}, "
            f"lse max|diff| {err_lse:.6f}")
        require(err_out <= TOL, f"fwd_stats {shape}: out off by {err_out}")
        require(err_lse <= LSE_TOL, f"fwd_stats {shape}: lse off by {err_lse}")
        kernels["flash_bias_fwd_stats"]["max_abs_err"] = max(
            kernels["flash_bias_fwd_stats"].get("max_abs_err", 0.0), err_out)
        for key, pairs in (("flash_bias_bwd_dq", (("dq", dq6, dq_r),)),
                           ("flash_bias_bwd_dq_dbias", (("dq", dq7, dq_r),
                                                        ("dbias", dbias7, dbias_r))),
                           ("flash_bias_bwd_dkv", (("dk", dk8, dk_r), ("dv", dv8, dv_r)))):
            for name, got, want in pairs:
                err = max_err(torch, got, want)
                scale = float(want.abs().max())
                cos = cosine(torch, got, want)
                say(f"{key} {shape}: {name} max|diff| {err:.5f} (max|plain| "
                    f"{scale:.4f}), cosine {cos:.6f}")
                require(err <= GRAD_REL_TOL * scale,
                        f"{key} {shape}: {name} off by {err} > {GRAD_REL_TOL} x {scale}")
                require(cos >= COSINE_MIN, f"{key} {shape}: {name} cosine {cos}")
                kernels[key]["max_abs_err"] = max(kernels[key].get("max_abs_err", 0.0), err)
        if flagship:
            plain_bwd = lambda: fa._flash_bias_bwd_reference(  # noqa: E731
                q, k, v, bias, kv_mask, dout, lse_ref, delta)
            timed = {
                "flash_bias_fwd_stats": (
                    lambda: fa.flash_bias_fwd_stats(q, k, v, bias, kv_mask),
                    lambda: fa._flash_bias_fwd_stats_reference(q, k, v, bias, kv_mask)),
                "flash_bias_bwd_dq": (lambda: fa.flash_bias_bwd_dq(*bwd_args), plain_bwd),
                "flash_bias_bwd_dq_dbias": (
                    lambda: fa.flash_bias_bwd_dq_dbias(*bwd_args), plain_bwd),
                "flash_bias_bwd_dkv": (lambda: fa.flash_bias_bwd_dkv(*bwd_args), plain_bwd),
            }
            # Library yardsticks: the forward with the bias as attn_mask, and
            # its autograd backward (dq, dk and dv in one call) as the one
            # number for kernels 6-8.
            qg, kg, vg = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
            sdpa = torch.nn.functional.scaled_dot_product_attention
            lib_fwd = median_ms(torch, lambda: sdpa(qg, kg, vg, attn_mask=bias))
            lib_out = sdpa(qg, kg, vg, attn_mask=bias)
            dout4 = dout.transpose(1, 2)
            lib_bwd = median_ms(torch, lambda: torch.autograd.grad(
                lib_out, (qg, kg, vg), dout4, retain_graph=True))
            del lib_out, qg, kg, vg
            unit = float(b) * heads * n * m * d  # one N x M x D product is 2 of these
            qkv_io = nbytes(q, k, v, bias)
            bounds = {
                "flash_bias_fwd_stats": (qkv_io + nbytes(out, lse), 4 * unit),
                "flash_bias_bwd_dq": (qkv_io + nbytes(dout, lse_ref, delta, dq6), 6 * unit),
                "flash_bias_bwd_dq_dbias": (
                    qkv_io + nbytes(dout, lse_ref, delta, dq7, dbias7), 6 * unit),
                "flash_bias_bwd_dkv": (qkv_io + nbytes(dout, lse_ref, delta, dk8, dv8),
                                       8 * unit),
            }
            for key, (kernel_fn, plain_fn) in timed.items():
                kernels[key]["ms"] = median_ms(torch, kernel_fn)
                kernels[key]["plain_ms"] = median_ms(torch, plain_fn)
                kernels[key]["library_ms"] = (lib_fwd if key == "flash_bias_fwd_stats"
                                              else lib_bwd)
                set_bound(kernels[key], bounds[key][0], bf16_flops=bounds[key][1])
                say(f"{key} {shape}:" + timing_line(kernels[key]))
        del q, k, v, dout, bias, f32, out_ref, lse_ref, delta, dq_r, dk_r, dv_r, dbias_r
        del out, lse, dq6, dq7, dbias7, dk8, dv8
        torch.cuda.empty_cache()


def check_relpos_kernels(torch, kernels):
    """Kernels 9-12 against their plain versions (fp32 math from the same
    bf16 inputs, the bias materialized from the table; the backward kernels
    get the plain forward's lse and δ). Above 3,000 positions the plain
    versions run one batch row and 8 heads at a time (their (B, H, N, N)
    fp32 temporaries are 2 GB each at 8,000 x 8 heads); the kernels always
    get the whole tensors."""
    import torch.nn.functional as F

    from mr_blip_tpu_torch.ops import flash_attention as fa
    from mr_blip_tpu_torch.ops.attention import relpos_attention

    gen = torch.Generator(device="cuda").manual_seed(3)
    dev = "cuda"
    heads, d, nb, maxd = 32, 64, 32, 128
    keys = ("flash_relpos_fwd_stats", "flash_relpos_bwd_dq",
            "flash_relpos_bwd_dq_dtable", "flash_relpos_bwd_dkv")

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    def plain(q, k, v, table, kv_mask, dout):
        """(out, lse, δ, dq, dk, dv, dtable) of the plain versions."""
        b, n = q.shape[:2]
        step_b, step_h = (1, 8) if n > 3000 else (b, heads)
        rows = []
        dtable = torch.zeros(heads, nb, device=dev)
        for b0 in range(0, b, step_b):
            cols = []
            for h0 in range(0, heads, step_h):
                sl = (slice(b0, b0 + step_b), slice(None), slice(h0, h0 + step_h))
                qf, kf, vf, df = (t[sl].float() for t in (q, k, v, dout))
                tab, msk = table[h0:h0 + step_h], kv_mask[b0:b0 + step_b]
                out, lse = fa._flash_relpos_fwd_stats_reference(qf, kf, vf, tab, msk,
                                                                nb, maxd)
                delta = torch.einsum("bnhd,bnhd->bhn", df, out)
                dq, dk, dv, dtab = fa._flash_relpos_bwd_reference(
                    qf, kf, vf, tab, msk, df, lse, delta, nb, maxd)
                dtable[h0:h0 + step_h] += dtab
                cols.append((out, lse, delta, dq, dk, dv))
            # heads are dim 2 of (B, N, H, D) tensors and dim 1 of lse and δ
            rows.append([torch.cat(ts, dim=1 if ts[0].ndim == 3 else 2)
                         for ts in zip(*cols)])
        return [torch.cat(ts, dim=0) for ts in zip(*rows)] + [dtable]

    def hold_grad(key, shape, name, got, want):
        err = max_err(torch, got, want)
        scale = float(want.abs().max())
        cos = cosine(torch, got, want)
        say(f"{key} {shape}: {name} max|diff| {err:.5f} (max|plain| {scale:.4f}), "
            f"cosine {cos:.6f}")
        require(err <= GRAD_REL_TOL * scale,
                f"{key} {shape}: {name} off by {err} > {GRAD_REL_TOL} x {scale}")
        require(cos >= COSINE_MIN, f"{key} {shape}: {name} cosine {cos}")
        kernels[key]["max_abs_err"] = max(kernels[key].get("max_abs_err", 0.0), err)

    # "train": the train micro-batch's shape (1 video x 240 frames), timed
    # for kernels 10-12; "generate": the generate batch's shape (4 x 240
    # frames), timed for kernel 9; 4,008 is 4 x 120 frames; 257 has near
    # tiles only (every |key - query| < 256).
    for b, n, mask_kind, role in ((1, LONG_ENCODER_LENGTH, None, "train"),
                                  (4, LONG_ENCODER_LENGTH, None, "generate"),
                                  (4, 4008, "tail", None),
                                  (4, 2049, "tail", "control"),
                                  (2, 1037, None, None),
                                  (2, 300, None, None),
                                  (2, 257, "tail", None),
                                  (2, 300, "row1_all", None)):
        q, k, v, dout = (randn(b, n, heads, d) for _ in range(4))
        table = torch.randn(heads, nb, generator=gen, device=dev)
        kv_mask = torch.ones(b, n, dtype=torch.int8, device=dev)
        if mask_kind == "tail":
            lengths = torch.tensor([n, n - 1, n - 100, 3 * n // 4][:b], device=dev)
            kv_mask = (torch.arange(n, device=dev)[None] < lengths[:, None]).to(torch.int8)
        elif mask_kind == "row1_all":
            kv_mask[1] = 0
        out_r, lse_r, delta, dq_r, dk_r, dv_r, dtab_r = plain(q, k, v, table, kv_mask, dout)
        delta = delta.contiguous()
        lse_r = lse_r.contiguous()
        bwd_args = (q, k, v, table, kv_mask, dout, lse_r, delta, nb, maxd)
        out, lse = fa.flash_relpos_fwd_stats(q, k, v, table, kv_mask, nb, maxd)
        dq10 = fa.flash_relpos_bwd_dq(*bwd_args)
        dq11, dtab11 = fa.flash_relpos_bwd_dq_dtable(*bwd_args)
        dtab_again = fa.flash_relpos_bwd_dq_dtable(*bwd_args)[1]
        dk12, dv12 = fa.flash_relpos_bwd_dkv(*bwd_args)
        torch.cuda.synchronize()
        shape = f"({b}, {n}, {heads}, {d}) mask {mask_kind}"
        err_out, err_lse = max_err(torch, out, out_r), max_err(torch, lse, lse_r)
        say(f"flash_relpos_fwd_stats {shape}: out max|diff| {err_out:.5f}, "
            f"lse max|diff| {err_lse:.6f}")
        require(err_out <= TOL, f"relpos fwd {shape}: out off by {err_out}")
        require(err_lse <= LSE_TOL, f"relpos fwd {shape}: lse off by {err_lse}")
        kernels[keys[0]]["max_abs_err"] = max(kernels[keys[0]].get("max_abs_err", 0.0),
                                              err_out)
        hold_grad(keys[1], shape, "dq", dq10, dq_r)
        hold_grad(keys[2], shape, "dq", dq11, dq_r)
        hold_grad(keys[2], shape, "dtable", dtab11, dtab_r)
        require(torch.equal(dtab11, dtab_again),
                f"{keys[2]} {shape}: dtable differs between two launches")
        hold_grad(keys[3], shape, "dk", dk12, dk_r)
        hold_grad(keys[3], shape, "dv", dv12, dv_r)
        if role == "control":
            # A wrong bias cannot pass: the plain version with the table
            # zeroed must fail the forward's bar.
            zero = plain(q, k, v, torch.zeros_like(table), kv_mask, dout)
            err_zero = float((out.float() - zero[0].float()).abs().max())
            say(f"  control, plain version with the table zeroed: out max|diff| "
                f"{err_zero:.5f} (bar {TOL})")
            require(err_zero > TOL, "the check cannot tell the rel-pos bias from none")
            del zero
        if role in ("train", "generate"):
            del dq_r, dk_r, dv_r
            torch.cuda.empty_cache()
            unit = float(b) * heads * n * n * d  # one N x N x D product is 2 of these
            io = nbytes(q, k, v, table, kv_mask)
            plain_all = lambda: plain(q, k, v, table, kv_mask, dout)  # noqa: E731
            # The library yardstick needs the bias materialized: (1, H, N, N)
            # bf16, built outside the timed region.
            bias = fa._relpos_bias(table, n, nb, maxd).to(torch.bfloat16).contiguous()
            qg, kg, vg = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
            sdpa = F.scaled_dot_product_attention
            if role == "generate":
                entry = kernels[keys[0]]
                entry["ms"] = median_ms(torch, lambda: fa.flash_relpos_fwd_stats(
                    q, k, v, table, kv_mask, nb, maxd))
                entry["plain_ms"] = median_ms(torch, plain_all, iters=1, warmup=0)
                with torch.no_grad():
                    entry["library_ms"] = median_ms(
                        torch, lambda: sdpa(qg, kg, vg, attn_mask=bias))
                set_bound(entry, io + nbytes(out, lse), bf16_flops=4 * unit)
                # Kernel 3 on the same inputs over the materialized bias,
                # held against the same plain output.
                err3 = max_err(torch, fa.flash_attention_bias(q, k, v, bias, kv_mask), out_r)
                require(err3 <= TOL, f"flash_bias {shape}: out off by {err3}")
                k3 = kernels["flash_bias_attention"]
                k3["max_abs_err"] = max(k3.get("max_abs_err", 0.0), err3)
                k3_ms = median_ms(torch, lambda: fa.flash_attention_bias(
                    q, k, v, bias, kv_mask))
                say(f"{keys[0]} {shape}:" + timing_line(entry)
                    + f"  ({4 * unit / entry['ms'] / 1e9:.1f} TFLOP/s); kernel 3 "
                    f"(flash_bias_attention) on the same inputs with the materialized "
                    f"{bias.numel() * 2 / 2**30:.2f} GiB bias: {k3_ms:.4f} ms (kernel / "
                    f"library {k3_ms / entry['library_ms']:.2f}x), max|diff| {err3:.5f}")
            else:
                fwd_ms = median_ms(torch, lambda: fa.flash_relpos_fwd_stats(
                    q, k, v, table, kv_mask, nb, maxd))
                say(f"{keys[0]} {shape}: kernel {fwd_ms:.4f} ms "
                    f"({4 * unit / fwd_ms / 1e9:.1f} TFLOP/s)")
                plain_ms = median_ms(torch, plain_all, iters=1, warmup=0)
                lib_out = sdpa(qg, kg, vg, attn_mask=bias)
                dout4 = dout.transpose(1, 2)
                lib_bwd = median_ms(torch, lambda: torch.autograd.grad(
                    lib_out, (qg, kg, vg), dout4, retain_graph=True))
                del lib_out
                bwd_io = io + nbytes(dout, lse_r, delta)
                timed = {
                    keys[1]: (lambda: fa.flash_relpos_bwd_dq(*bwd_args),
                              bwd_io + nbytes(dq10), 6 * unit),
                    keys[2]: (lambda: fa.flash_relpos_bwd_dq_dtable(*bwd_args),
                              bwd_io + nbytes(dq11, dtab11), 6 * unit),
                    keys[3]: (lambda: fa.flash_relpos_bwd_dkv(*bwd_args),
                              bwd_io + nbytes(dk12, dv12), 8 * unit),
                }
                for key, (kernel_fn, io_bytes, flops) in timed.items():
                    entry = kernels[key]
                    entry["ms"] = median_ms(torch, kernel_fn)
                    # The plain forward and backward run together (one chunked
                    # pass): the one number for kernels 10-12.
                    entry["plain_ms"] = plain_ms
                    entry["library_ms"] = lib_bwd
                    set_bound(entry, io_bytes, bf16_flops=flops)
                    say(f"{key} {shape}:" + timing_line(entry)
                        + f"  ({flops / entry['ms'] / 1e9:.1f} TFLOP/s)")
            del bias, qg, kg, vg
        del q, k, v, dout, out, lse, out_r, dq10, dq11, dk12, dv12, lse_r, delta
        torch.cuda.empty_cache()

    # A CUDA call the dispatch sends to the rel-pos kernels, in a dtype they
    # do not take, must raise rather than run plain.
    before = fa.flash_relpos_fwd_stats.launches
    q32 = torch.randn(2, 300, heads, d, generator=gen, device=dev)
    try:
        relpos_attention(q32, q32, q32, torch.randn(heads, nb, device=dev))
    except TypeError as exc:
        say(f"float32 rel-pos attention on the card raises: {exc}")
    else:
        raise RuntimeError("float32 rel-pos attention on the card ran plain")
    require(fa.flash_relpos_fwd_stats.launches == before,
            "float32 rel-pos attention counted a launch")
    torch.cuda.empty_cache()


def ulp_distance(torch, got, want):
    """Elementwise distance of two bf16 tensors in bf16 ulps."""
    def ordered(t):
        bits = t.contiguous().view(torch.int16).int()
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return (ordered(got) - ordered(want)).abs()


def check_int8_kernels(torch, kernels):
    """Kernels 13-16 against their plain versions (the same quantization
    arithmetic, integer products exact in fp64) on the card."""
    from mr_blip_tpu_torch.ops import int8_matmul as i8

    gen = torch.Generator(device="cuda").manual_seed(2)
    dev = "cuda"

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def qw(k, n, scale=0.05):
        w = torch.randn(k, n, generator=gen, device=dev) * scale
        s = i8.div_exact(w.abs().amax(dim=0).clamp_min(1e-8), 127.0)
        return i8.k_major(torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)), s

    def norm(kind, k):
        if kind is None:
            return None
        return (kind, randn(k, scale=0.05, dtype=torch.float32) + 1.0,
                randn(k, scale=0.05, dtype=torch.float32) if kind == "ln" else None, 1e-6)

    def hold(key, label, got, want):
        torch.cuda.synchronize()
        err = max_err(torch, got, want)
        cos = cosine(torch, got, want)
        ulps = ulp_distance(torch, got, want)
        off = float((ulps > ULP_BAR).float().mean())
        say(f"{key} {label}: max|diff| {err:.5f}, cosine {cos:.6f}, share of elements "
            f"> {ULP_BAR} bf16 ulps off {off:.2e} (any bit off {float((ulps > 0).float().mean()):.2e})")
        require(err <= INT8_TOL[key], f"{key} {label} off by {err}")
        require(cos >= COSINE_MIN, f"{key} {label}: cosine {cos}")
        entry = kernels[key]
        entry["max_abs_err"] = max(entry.get("max_abs_err", 0.0), err)

    def timed(key, label, kernel_fn, plain_fn, library_fn, io_bytes, int8_ops,
              bf16_flops=0.0):
        entry = kernels[key]
        entry["ms"] = median_ms(torch, kernel_fn)
        entry["plain_ms"] = median_ms(torch, plain_fn, iters=3, warmup=1)
        entry["library_ms"] = (None if library_fn is None
                               else median_ms(torch, library_fn))
        set_bound(entry, io_bytes, bf16_flops=bf16_flops, int8_ops=int8_ops)
        say(f"{key} {label}:" + timing_line(entry)
            + f"  ({(int8_ops + bf16_flops) / entry['ms'] / 1e9:.0f} TOP/s)")

    # Kernel 13. The ragged ViT token count with a residual, then the three
    # main-path shapes; the Q-Former cross K/V shape is the one timed.
    lin = "w8a8_linear"
    for m, k, n, kind, has_bias, has_res, flagship in (
            (61677, 1408, 1408, None, False, True, False),
            # the split int8 ViT route at 364 pixels (240 x 677 tokens): qkv
            # with the LN pre-norm and bias, proj with bias and residual
            (240 * BIG_TOKENS, 1408, 4224, "ln", True, False, False),
            (240 * BIG_TOKENS, 1408, 1408, None, True, True, False),
            (61680, 1408, 1536, None, True, False, True),
            (8224, 2048, 6144, "rms", False, False, False),
            (8224, 2048, 2048, None, False, True, False)):
        x = randn(m, k, scale=0.3)
        wq, sw = qw(k, n)
        bias = randn(n, scale=0.05, dtype=torch.float32) if has_bias else None
        res = randn(m, n, scale=0.3) if has_res else None
        nm = norm(kind, k)
        got = i8.w8a8_linear(x, wq, sw, bias, norm=nm, residual=res)
        want = i8._w8a8_linear_plain(x, wq, sw, bias, nm, res)
        label = f"({m}, {k}) x ({k}, {n}) norm {kind} bias {has_bias} residual {has_res}"
        hold(lin, label, got, want)
        if flagship:
            def library():
                q, sa = i8._quant_rows(i8._norm_rows(x.float(), nm))
                y = torch._int_mm(q, wq).float() * (sa * sw)
                return (y + bias).to(torch.bfloat16)
            require(torch.equal(library(), want), "the _int_mm yardstick computes "
                    "another function than w8a8_linear's plain version")
            timed(lin, label,
                  lambda: i8.w8a8_linear(x, wq, sw, bias, norm=nm, residual=res),
                  lambda: i8._w8a8_linear_plain(x, wq, sw, bias, nm, res), library,
                  nbytes(x, wq, sw, bias, got), 2.0 * m * k * n)
        del x, wq, got, want, res
        torch.cuda.empty_cache()
    # A dtype the kernel does not take must raise, not run plain.
    before = i8.w8a8_linear.launches
    try:
        i8.w8a8_linear(randn(64, 64, dtype=torch.float32), *qw(64, 64))
    except TypeError as exc:
        say(f"float32 w8a8_linear on the card raises: {exc}")
    else:
        raise RuntimeError("float32 w8a8_linear on the card did not raise")
    require(i8.w8a8_linear.launches == before, "float32 w8a8_linear counted a launch")
    torch.cuda.empty_cache()

    # Kernel 14: the ViT MLP, LN pre-norm, residual, 4 hidden chunks of 1,536.
    mlp = "w8a8_mlp"
    d, h = 1408, 6144
    w1, s1 = qw(d, h)
    w2, s2 = qw(h, d)
    b1 = randn(h, scale=0.01, dtype=torch.float32)
    b2 = randn(d, scale=0.01, dtype=torch.float32)
    nm = norm("ln", d)
    # The last shape is the split int8 ViT route's at 364 pixels (240 x 677 rows).
    for m, flagship in ((61677, False), (61680, True), (240 * BIG_TOKENS, False)):
        x, r = randn(m, d, scale=0.3), randn(m, d, scale=0.3)
        got = i8.w8a8_mlp(x, w1, s1, b1, w2, s2, b2, norm=nm, residual=r)
        want = i8._w8a8_mlp_plain(x, w1, s1, b1, w2, s2, b2, nm, r, i8.DEFAULT_BLOCK_H)
        label = f"({m}, {d}, {h}) LN residual"
        hold(mlp, label, got, want)
        if flagship:
            timed(mlp, label,
                  lambda: i8.w8a8_mlp(x, w1, s1, b1, w2, s2, b2, norm=nm, residual=r),
                  lambda: i8._w8a8_mlp_plain(x, w1, s1, b1, w2, s2, b2, nm, r,
                                             i8.DEFAULT_BLOCK_H),
                  None, nbytes(x, r, w1, w2, got), 4.0 * m * d * h)
        del x, r, got, want
        torch.cuda.empty_cache()
    del w1, w2
    torch.cuda.empty_cache()

    # Kernel 15: the T5 encoder FFN, 8 hidden chunks of 640.
    gated = "w8a8_mlp_gated"
    d, h = 2048, 5120
    w0, s0 = qw(d, h)
    w1, s1 = qw(d, h)
    wo, so = qw(h, d)
    for m, kind, has_res, flagship in ((8191, None, False, False),
                                       (8224, "rms", True, True)):
        x = randn(m, d, scale=0.3)
        r = x if has_res else None
        nm = norm(kind, d)
        got = i8.w8a8_mlp_gated(x, w0, s0, w1, s1, wo, so, norm=nm, residual=r)
        want = i8._w8a8_mlp_gated_plain(x, w0, s0, w1, s1, wo, so, nm, r,
                                        i8.DEFAULT_GATED_BLOCK_H)
        label = f"({m}, {d}, {h}) norm {kind} residual {has_res}"
        hold(gated, label, got, want)
        if flagship:
            timed(gated, label,
                  lambda: i8.w8a8_mlp_gated(x, w0, s0, w1, s1, wo, so, norm=nm,
                                            residual=r),
                  lambda: i8._w8a8_mlp_gated_plain(x, w0, s0, w1, s1, wo, so, nm, r,
                                                   i8.DEFAULT_GATED_BLOCK_H),
                  None, nbytes(x, r, w0, w1, wo, got), 6.0 * m * d * h)
        del x, r, got, want
    del w0, w1, wo
    torch.cuda.empty_cache()

    # Kernel 16: the padded shape of the TPU check (garbage in the pad rows
    # must not move a valid row), then the main-path shape.
    blk = "w8a8_attn_block"
    c, heads = 1408, 16
    wqkv, sqkv = qw(c, 3 * c, scale=0.02)
    wp, sp = qw(c, c, scale=0.02)
    qb = randn(3 * c, scale=0.05, dtype=torch.float32)
    qb[c:2 * c] = 0.0
    pb = randn(c, scale=0.05, dtype=torch.float32)
    nm = norm("ln", c)

    def block(x, n_valid):
        return i8.w8a8_attn_block(x, wqkv, sqkv, qb, wp, sp, pb, norm=nm,
                                  num_heads=heads, n_valid=n_valid)

    def block_plain(x, n_valid):
        return i8._w8a8_attn_block_plain(x, wqkv, sqkv, qb, wp, sp, pb, nm[1], nm[2],
                                         nm[3], heads, n_valid)

    x = randn(6, 264, c, scale=0.5)
    x[:, 257:] = 1e4
    got = block(x, 257)
    hold(blk, "(6, 264, 1408) n_valid 257", got[:, :257], block_plain(x, 257)[:, :257])
    x[:, 257:] = -3e3
    require(torch.equal(block(x, 257)[:, :257], got[:, :257]),
            "w8a8_attn_block: the pad rows moved a valid row")
    b, n = 240, 257
    x = randn(b, n, c, scale=0.5)
    got = block(x, 0)
    label = f"({b}, {n}, {c})"
    hold(blk, label, got, block_plain(x, 0))
    timed(blk, label, lambda: block(x, 0), lambda: block_plain(x, 0), None,
          nbytes(x, got, wqkv, wp), 2.0 * b * n * c * 4 * c,
          bf16_flops=4.0 * b * n * n * c)
    del x, got
    torch.cuda.empty_cache()


# --------------------------------------------------------------- phase 4
def flagship_model(device="cuda", **kw):
    from mr_blip_tpu_torch.models.blip2_mr import BLIP2_MR
    from mr_blip_tpu_torch.profile_inference import FLAGSHIP

    return BLIP2_MR(**dict(FLAGSHIP, **kw), device=device)


def reduced_model(device, init_params=True, task=None, relpos_in_kernel=False, **kw):
    """The flagship model at full widths, every stack REDUCED_DEPTH deep;
    ``kw`` overrides entries of the flagship configuration."""
    import dataclasses

    from mr_blip_tpu_torch.models.blip2_mr import BLIP2_MR
    from mr_blip_tpu_torch.models.blip2_mr_module import Blip2MRModule
    from mr_blip_tpu_torch.models.eva_vit import eva_vit_g_config
    from mr_blip_tpu_torch.models.t5 import t5_flan_xl_config
    from mr_blip_tpu_torch.profile_inference import FLAGSHIP

    def vit_config(**kw):
        return dataclasses.replace(eva_vit_g_config(**kw), depth=REDUCED_DEPTH)

    def t5_config(**kw):
        return dataclasses.replace(t5_flan_xl_config(**kw), num_layers=REDUCED_DEPTH,
                                   num_decoder_layers=REDUCED_DEPTH)

    class ReducedDepth(BLIP2_MR):
        VIT_CONFIGS = {"eva_vit_g": vit_config}
        T5_CONFIGS = {"flan-t5-xl": t5_config}

        def __init__(self):
            super().__init__(**dict(FLAGSHIP, task=task or FLAGSHIP["task"], **kw),
                             init_params=False, device=device,
                             relpos_in_kernel=relpos_in_kernel)
            self.qformer_config = dataclasses.replace(self.qformer_config,
                                                      num_layers=REDUCED_DEPTH)
            self.module = Blip2MRModule(
                self.vit_config, self.qformer_config, self.t5_config,
                compute_dtype=self.compute_dtype, device=self.device,
                with_answerer=self.is_qa).eval()
            self.module.requires_grad_(False)
            if init_params:
                self.init_params(FLAGSHIP["seed"])

    return ReducedDepth()


def main_path(torch, wrappers, int8=False, long=False, relpos_in_kernel=None,
              img_size=224):
    """Phase 4 (bf16) or, with ``int8``, phase 8: the same model after
    ``quantize_for_inference()``. With ``long``, phase 10: LONG_BATCHES
    batches of 4 x LONG_FRAMES frames through the ``relpos_in_kernel`` model
    (``relpos_in_kernel=False`` for its materialized-bias comparison run).
    With ``img_size=364``, phase 13: BIG_BATCHES batches at 364 pixels, the
    ViT's attention through kernel 4 (with ``int8`` between two W8A8 linears).
    Returns the launch counts of the run and its summary numbers."""
    from mr_blip_tpu_torch.profile_inference import make_samples
    from mr_blip_tpu_torch.text.span_grammar import moment_str_to_list

    relpos = long if relpos_in_kernel is None else relpos_in_kernel
    if relpos:
        expected = EXPECTED_LONG_INT8_LAUNCHES if int8 else EXPECTED_LONG_LAUNCHES
    else:
        expected = EXPECTED_INT8_LAUNCHES if int8 else EXPECTED_LAUNCHES
    n_frames, n_batches = (LONG_FRAMES, LONG_BATCHES) if long else (N_FRAMES, N_BATCHES)
    name = ("long " if long else "") + ("int8 path" if int8 else "main path")
    if long and not relpos:
        name += ", materialized bias"
    if img_size != 224:
        require(not long, "the 364-pixel runs are at 60 frames")
        expected = EXPECTED_BIG_INT8_LAUNCHES if int8 else EXPECTED_BIG_LAUNCHES
        n_batches = BIG_BATCHES
        name = f"{img_size}-pixel " + ("int8 path" if int8 else "path")
    t0 = time.time()
    model = flagship_model(relpos_in_kernel=relpos, img_size=img_size)
    torch.cuda.synchronize()
    say(f"model built with random weights in {time.time() - t0:.1f} s; "
        f"{sum(p.numel() for p in model.module.parameters()) / 1e9:.3f} B params")
    if int8:
        t0 = time.time()
        model.quantize_for_inference()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        int8_numel = sum(b.numel() for b in model.module.buffers()
                         if b.dtype == torch.int8)
        say(f"quantize_for_inference in {time.time() - t0:.1f} s; {int8_numel / 1e9:.3f} B "
            f"int8 weights, {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    batches = [make_samples(BATCH, n_frames, seed, img_size) for seed in range(n_batches)]
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    seconds = []
    for i, samples in enumerate(batches):
        before = {name: w.launches for name, w in wrappers.items()}
        t0 = time.time()
        handle = model.generate_dispatch(samples)
        out = model.generate_collect(handle)
        torch.cuda.synchronize()
        seconds.append(time.time() - t0)
        rose = {name: w.launches - before[name] for name, w in wrappers.items()}
        scores = handle["scores"].float().cpu()
        say(f"{name} batch {i}: {seconds[-1]:.3f} s  launches {rose}  "
            f"scores {[round(float(s), 4) for s in scores]}  "
            f"predictions {out['prediction']}")
        require(rose == expected, f"{name} batch {i}: launches {rose}, "
                f"expected {expected}")
        require(len(out["prediction"]) == BATCH, "wrong number of predictions")
        for p in out["prediction"]:
            moment_str_to_list(p)
        require(bool(torch.isfinite(scores).all()), "beam scores not finite")
        # No (1, H, L, L) tensor under relpos_in_kernel: the cache stays empty.
        require(bool(model._enc_bias_cache) != relpos,
                f"{name}: encoder bias cache holds {list(model._enc_bias_cache)}")
    launches = {name: w.launches for name, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()

    # Stage split on one more batch, synchronizing between stages.
    stage = {}
    with torch.inference_mode():
        batch = model.prepare_mr_batch(batches[1])
        tensors = model._to_device(batch)
        bias = model._encoder_bias_for(batch)
        torch.cuda.synchronize()
        t0 = time.time()
        frames = model.frames_to_t5(tensors)
        torch.cuda.synchronize()
        stage["frames_to_qformer_s"] = time.time() - t0
        t0 = time.time()
        enc, attn = model.encode_t5(tensors, frames, bias)
        torch.cuda.synchronize()
        stage["t5_encode_s"] = time.time() - t0
        steps = []  # decode steps, counted through the model's own step
        step = model.module.t5.decode_step
        model.module.t5.decode_step = lambda *a: steps.append(1) or step(*a)
        t0 = time.time()
        model.decode(enc, attn)
        torch.cuda.synchronize()
        stage["decode_s"] = time.time() - t0
        del model.module.t5.decode_step
    steady = statistics.mean(seconds[1:])
    require(not long or enc.shape[1] == LONG_ENCODER_LENGTH,
            f"{name}: encoder length {enc.shape[1]}, kernels 9-12 were held at "
            f"{LONG_ENCODER_LENGTH}")
    say(f"{name}: B={BATCH} x {n_frames} frames at {img_size}², encoder length "
        f"{enc.shape[1]}; steady {steady:.3f} s/batch (batches 1-{n_batches - 1}), first "
        f"{seconds[0]:.3f} s; stages "
        + ", ".join(f"{k} {v:.3f}" for k, v in stage.items())
        + f" ({len(steps)} decode steps, {1e3 * stage['decode_s'] / len(steps):.1f} ms "
        f"each); peak memory {peak / 2**30:.2f} GiB")
    summary = dict(stage, steady_s=steady, first_s=seconds[0], peak_gib=peak / 2**30,
                   decode_steps=len(steps), encoder_length=enc.shape[1])
    del model, enc, frames
    torch.cuda.empty_cache()
    return launches, summary


# --------------------------------------------------------------- phase 5
def encoder_outputs(torch, model, samples):
    with torch.inference_mode():
        batch = model.prepare_mr_batch(samples)
        tensors = model._to_device(batch)
        enc, _ = model.encode_t5(tensors, model.frames_to_t5(tensors),
                                 model._encoder_bias_for(batch))
    return enc.float().cpu()


def kernel_vs_plain_path(torch, wrappers):
    from mr_blip_tpu_torch.profile_inference import make_samples

    samples = make_samples(2, 8, seed=7)
    gpu = reduced_model("cuda")
    # The random init draws the rel-pos table at N(0, 0.02), too small to
    # move the attention; at N(0, 1) the bias does, so the check sees it.
    state = gpu.state_dict()
    table = RELPOS_TABLE
    gen = torch.Generator(device="cuda").manual_seed(1)
    state[table] = torch.randn(state[table].shape, generator=gen, device="cuda")
    gpu.load_state_dict(state)
    before = {name: w.launches for name, w in wrappers.items()}
    enc_gpu = encoder_outputs(torch, gpu, samples)
    rose = {name: w.launches - before[name] for name, w in wrappers.items()}
    require(all(rose[k] for k in GENERATE_KERNELS),
            f"reduced model skipped a kernel: {rose}")
    state = {k: v.cpu() for k, v in gpu.state_dict().items()}
    del gpu
    cpu = reduced_model("cpu", init_params=False)
    cpu.load_state_dict(state)
    t0 = time.time()
    enc_cpu = encoder_outputs(torch, cpu, samples)
    seconds = time.time() - t0
    cos = torch.nn.functional.cosine_similarity(enc_gpu, enc_cpu, dim=-1)
    # Control: the plain path without the bias must fall below the bar.
    state[table] = torch.zeros_like(state[table])
    cpu.load_state_dict(state)
    cos_nobias = torch.nn.functional.cosine_similarity(
        enc_gpu, encoder_outputs(torch, cpu, samples), dim=-1)
    say(f"kernel path vs plain path (depth {REDUCED_DEPTH}, full width, "
        f"2 x 8 frames, encoder length {enc_gpu.shape[1]}, rel-pos table "
        f"N(0, 1)): per-row cosine min {float(cos.min()):.6f} mean "
        f"{float(cos.mean()):.6f}; against the plain path without the bias "
        f"min {float(cos_nobias.min()):.6f} mean {float(cos_nobias.mean()):.6f}; "
        f"kernel launches {rose}; CPU run {seconds:.1f} s")
    require(float(cos.min()) >= COSINE_MIN, f"cosine {float(cos.min())} < {COSINE_MIN}")
    require(float(cos_nobias.min()) < COSINE_MIN,
            "the check cannot tell the bias from none: cosine without it "
            f"{float(cos_nobias.min())}")


# --------------------------------------------------------------- phase 6
def checksums(torch, tensors):
    """Two integer checksums of each tensor's bits: any changed bit moves
    at least one of them."""
    out = []
    for t in tensors:
        bits = t.detach().contiguous().view(-1).view(torch.int16 if t.element_size() == 2
                                                   else torch.int32).long()
        weights = torch.arange(bits.numel(), device=bits.device) % 7919 + 1
        out.append((int(bits.sum()), int((bits * weights).sum())))
    return out


def train_path(torch, wrappers, long=False):
    """The LoRA train step at full depth and width: 4 micro-batches of
    4 x 60 frames, 2 optimizer updates (accum_grad_iters 2), dropouts on.
    With ``long``, phase 11: the ``relpos_in_kernel`` model over micro-batches
    of 1 video x 240 frames (the token count of 4 x 60)."""
    from mr_blip_tpu_torch.profile_inference import make_samples
    from mr_blip_tpu_torch.runners.train_state import TrainCtx

    batch_size, n_frames = (LONG_TRAIN_BATCH, LONG_FRAMES) if long else (BATCH, N_FRAMES)
    expected = EXPECTED_LONG_TRAIN_LAUNCHES if long else EXPECTED_TRAIN_LAUNCHES
    label = "long train" if long else "train"
    t0 = time.time()
    model = flagship_model(task=TRAIN_TASK, relpos_in_kernel=long)
    ctx = TrainCtx(model, weight_decay=TRAIN_WEIGHT_DECAY, accum_grad_iters=ACCUM,
                   seed=0)
    trainable, total = model.trainable_param_count()
    named = dict(model.module.named_parameters())
    lora = {n: p for n, p in named.items() if p.requires_grad}
    frozen = [p for p in named.values() if not p.requires_grad]
    require(lora and all("lora_" in n for n in lora), "trainable set is not LoRA-only")
    frozen_sums = checksums(torch, frozen)
    torch.cuda.synchronize()
    say(f"{label} model built in {time.time() - t0:.1f} s: task {TRAIN_TASK}, "
        f"{trainable:,} trainable of {total:,} params ({len(lora)} LoRA tensors, fp32)")
    batches = [model.prepare_mr_batch(make_samples(batch_size, n_frames, seed))
               for seed in range(TRAIN_MICRO_BATCHES)]
    lengths = {-(-(b["int_mask"].shape[1] + b["end_ids"].shape[1]
                   + b["text_ids"].shape[1]) // 8) * 8 for b in batches}
    require(not long or lengths == {LONG_ENCODER_LENGTH},
            f"{label}: encoder lengths {lengths}, kernels 9-12 were held at "
            f"{LONG_ENCODER_LENGTH}")

    # Stage clocks: synchronized host time around the loss and the update.
    clock = {}

    def timed(name, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            start = time.time()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            clock[name] = time.time() - start
            return out
        return run

    def check_grads():
        start = time.time()
        missing = [n for n, p in lora.items() if p.grad is None]
        require(not missing, f"{len(missing)} LoRA tensors got no gradient, "
                f"e.g. {missing[:3]}")
        amax = torch.stack([p.grad.abs().amax() for p in lora.values()]).tolist()
        bad = [n for n, a in zip(lora, amax) if not (math.isfinite(a) and a > 0)]
        require(not bad, f"{len(bad)} LoRA gradients zero or not finite before "
                f"the update, e.g. {bad[:3]}")
        clock["grad_check"] = time.time() - start

    model.loss = timed("forward", model.loss)
    optimizer_step = timed("optimizer", ctx.optimizer.step)
    ctx.optimizer.step = lambda *a, **kw: check_grads() or optimizer_step(*a, **kw)
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    rows, snapshot = [], None
    for i, batch in enumerate(batches):
        if i % ACCUM == 0:
            snapshot = {n: p.detach().clone() for n, p in lora.items()}
        before = {name: w.launches for name, w in wrappers.items()}
        clock.clear()
        ctx.set_lr(TRAIN_LR)
        start = time.time()
        loss = ctx.step(batch)
        torch.cuda.synchronize()
        step_s = time.time() - start
        rose = {name: w.launches - before[name] for name, w in wrappers.items()}
        split = {"forward": clock["forward"], "optimizer": clock.get("optimizer", 0.0)}
        split["backward"] = (step_s - split["forward"] - split["optimizer"]
                             - clock.get("grad_check", 0.0))
        rows.append((step_s, split))
        say(f"{label} micro-batch {i}: loss {loss:.5f}  {step_s:.3f} s (forward "
            f"{split['forward']:.3f}, backward {split['backward']:.3f}, optimizer "
            f"{split['optimizer']:.4f})  launches {rose}")
        require(math.isfinite(loss), f"micro-batch {i}: loss {loss}")
        require(rose == expected, f"micro-batch {i}: launches {rose}, "
                f"expected {expected}")
        if (i + 1) % ACCUM == 0:
            require("grad_check" in clock, f"update {(i + 1) // ACCUM}: gradients "
                    "not checked")
            same = [n for n, p in lora.items() if torch.equal(p, snapshot[n])]
            require(not same, f"update {(i + 1) // ACCUM}: {len(same)} LoRA tensors "
                    f"unchanged, e.g. {same[:3]}")
    launches = {name: w.launches for name, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    require(ctx.updates == TRAIN_MICRO_BATCHES // ACCUM, f"{ctx.updates} updates")
    require(checksums(torch, frozen) == frozen_sums, "a frozen tensor changed")
    require(bool(model._enc_bias_cache) != long,
            f"{label}: encoder bias cache holds {list(model._enc_bias_cache)}")
    steady = rows[1:]
    mean = {k: statistics.mean(r[1][k] for r in steady) for k in rows[0][1]}
    say(f"{label} path: B={batch_size} x {n_frames} frames (encoder length "
        f"{', '.join(map(str, sorted(lengths)))}), {TRAIN_MICRO_BATCHES} micro-batches, "
        f"{ctx.updates} updates; every LoRA gradient finite and nonzero and every "
        f"LoRA tensor moved at each update, every frozen tensor bit-identical; "
        f"steady {statistics.mean(r[0] for r in steady):.3f} s per micro-batch (micro-batches 1-{len(rows) - 1}: forward "
        f"{mean['forward']:.3f}, backward {mean['backward']:.3f}, optimizer "
        f"{mean['optimizer']:.4f} averaged over all), first {rows[0][0]:.3f} s; "
        f"peak memory {peak / 2**30:.2f} GiB")
    del model, ctx, batches, lora, frozen, named, snapshot
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------- phase 7
def path_gradients(torch, model, batch, task):
    """Loss and gradients of the trainable tensors, in eval mode (dropouts
    off). Under ``qformer_freeze`` the JAX policy trains nothing, so the
    encoder's rel-pos table is set to train: the full-finetune backward
    (dbias, kernel 7) is what reaches it."""
    model.set_trainable()
    if task == "qformer_freeze":
        model.module.t5.encoder.rel_bias.rel_embedding.requires_grad_(True)
    rows = []  # the T5 encoder's output rows, fp32 on the host
    hook = model.module.t5.encoder.register_forward_hook(
        lambda mod, args, out: rows.append(out.detach().float().cpu()))
    loss = model.loss(batch)
    hook.remove()
    loss.backward()
    grads = {n: p.grad.float().cpu() for n, p in model.module.named_parameters()
             if p.requires_grad}
    return float(loss.detach()), grads, rows[0]


def gradients_kernel_vs_plain(torch, wrappers, long=False):
    """Phase 7 or, with ``long``, phase 12: the ``relpos_in_kernel`` model at
    1 x 240 frames, where the encoder's rows are compared too (kernel path
    against plain path, and against the card's own materialized-bias run).
    Returns the launches of the kernel that emits the table's gradient."""
    from mr_blip_tpu_torch.profile_inference import make_samples

    family = "flash_relpos" if long else "flash_bias"
    fwd, dq, dkv = (f"{family}_{k}" for k in ("fwd_stats", "bwd_dq", "bwd_dkv"))
    dq_table = "flash_relpos_bwd_dq_dtable" if long else "flash_bias_bwd_dq_dbias"
    dbias_launches = 0
    for task, frames in (LONG_GRAD_TASKS if long else [(t, 8) for t in GRAD_TASKS]):
        samples = make_samples(1 if long else 2, frames, seed=7)
        size = f"{1 if long else 2} x {frames}"
        gpu = reduced_model("cuda", task=task, relpos_in_kernel=long)
        cfg = gpu.t5_config
        # The rel-pos table at N(0, 1), as in phase 5. The T5 query
        # projections at HF T5's init scale (d_model * d_kv)^-1/2: at the
        # random init's 0.02, T5's unscaled logits have std ~6, attention is
        # near one-hot and bf16 rounding flips near-ties: there the plain
        # path in bf16 against the plain path in fp32 (both on the CPU) gave
        # gradient cosines down to 0.85.
        state = gpu.state_dict()
        gen = torch.Generator(device="cuda").manual_seed(1)
        state[RELPOS_TABLE] = torch.randn(state[RELPOS_TABLE].shape, generator=gen,
                                          device="cuda")
        for name in state:
            if name.startswith("t5.") and name.endswith("attention.q.weight"):
                state[name] = (torch.randn(state[name].shape, generator=gen, device="cuda")
                               * (cfg.d_model * cfg.d_kv) ** -0.5)
        gpu.load_state_dict(state)
        batch = gpu.prepare_mr_batch(samples)
        for w in wrappers.values():
            w.launches = 0
        loss_gpu, g_gpu, enc_gpu = path_gradients(torch, gpu, batch, task)
        rose = {name: w.launches for name, w in wrappers.items()}
        require(not (long and gpu._enc_bias_cache), "an encoder bias was materialized")
        state = {k: v.cpu() for k, v in gpu.state_dict().items()}
        del gpu
        torch.cuda.empty_cache()
        if long and frames == LONG_FRAMES:
            # The card's own materialized-bias run of the same weights
            # (kernel 5 over the (1, H, L, L) bias).
            mat = reduced_model("cuda", task=task, init_params=False)
            mat.load_state_dict(state)
            enc_mat = path_gradients(torch, mat, batch, task)[2]
            require(bool(mat._enc_bias_cache), "the comparison run built no bias")
            del mat
            torch.cuda.empty_cache()
            cos_mat = torch.nn.functional.cosine_similarity(enc_gpu, enc_mat, dim=-1)
            say(f"long context, encoder rows, in-kernel bias vs materialized bias on the "
                f"card: per-row cosine min {float(cos_mat.min()):.6f} mean "
                f"{float(cos_mat.mean()):.6f}")
            require(float(cos_mat.min()) >= COSINE_MIN,
                    f"in-kernel vs materialized bias: cosine {float(cos_mat.min())}")
        cpu = reduced_model("cpu", task=task, init_params=False, relpos_in_kernel=long)
        cpu.load_state_dict(state)
        t0 = time.time()
        loss_cpu, g_cpu, enc_cpu = path_gradients(torch, cpu, batch, task)
        seconds = time.time() - t0
        if long:
            cos_enc = torch.nn.functional.cosine_similarity(enc_gpu, enc_cpu, dim=-1)
            say(f"long context {task}, encoder rows (length {enc_gpu.shape[1]}), kernel "
                f"path vs plain path: per-row cosine min {float(cos_enc.min()):.6f} "
                f"mean {float(cos_enc.mean()):.6f}")
            require(float(cos_enc.min()) >= COSINE_MIN,
                    f"long context {task}: encoder cosine {float(cos_enc.min())}")
        require(g_gpu.keys() == g_cpu.keys() and g_gpu, f"{task}: trainable sets differ")
        # An attention key bias adds the same q·b to every logit of a row,
        # which the softmax ignores: its gradient is zero but for rounding.
        compared = [n for n in g_gpu if not n.endswith("key.bias")]
        cos = {n: cosine(torch, g_gpu[n], g_cpu[n]) for n in compared}
        worst = min(cos, key=cos.get)
        rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
        say(f"gradients {task} (depth {REDUCED_DEPTH}, full width, {size} frames"
            f"{', relpos_in_kernel' if long else ''}): "
            f"loss {loss_gpu:.5f} vs plain {loss_cpu:.5f} (rel {rel:.2e}); "
            f"{len(cos)} trainable tensors compared ({len(g_gpu) - len(cos)} key "
            f"biases left out), cosine min {cos[worst]:.6f} ({worst}), "
            f"mean {statistics.mean(cos.values()):.6f}; launches "
            f"{ {k: v for k, v in rose.items() if v} }; CPU run {seconds:.1f} s")
        require(rel <= LOSS_REL_TOL, f"{task}: loss rel diff {rel}")
        require(cos[worst] >= GRAD_COSINE_MIN, f"{task}: {worst} cosine {cos[worst]}")
        require(rose[fwd] == REDUCED_DEPTH and rose[dkv] == REDUCED_DEPTH,
                f"{task}: {rose}")
        require(not long or not any(v for k, v in rose.items() if k.startswith("flash_bias")),
                f"{task}: a biased flash kernel ran on the relpos_in_kernel path: {rose}")
        if task == "qformer_freeze":
            g = g_gpu[RELPOS_TABLE]
            require(bool(torch.isfinite(g).all()) and bool(g.abs().max() > 0),
                    "rel-pos table gradient not finite and nonzero")
            require(rose[dq_table] == REDUCED_DEPTH and rose[dq] == 0, f"{task}: {rose}")
            dbias_launches = rose[dq_table]
            say(f"  rel-pos table gradient: max|g| {float(g.abs().max()):.4e}, "
                f"cosine {cos[RELPOS_TABLE]:.6f}")
        else:
            require(rose[dq] == REDUCED_DEPTH and rose[dq_table] == 0, f"{task}: {rose}")
        if task == "lora":
            require(rose["layer_norm"] > 0, "lora: LayerNorm kernel not launched")
        del cpu, g_gpu, g_cpu, enc_gpu, enc_cpu
    return dbias_launches


# --------------------------------------------------------------- phase 9
def int8_outputs(torch, model, samples):
    """T5 encoder outputs and first-step decoder logits (one beam), fp32 on
    the host."""
    with torch.inference_mode():
        batch = model.prepare_mr_batch(samples)
        tensors = model._to_device(batch)
        enc, attn = model.encode_t5(tensors, model.frames_to_t5(tensors),
                                    model._encoder_bias_for(batch))
        t5 = model.module.t5
        rows = enc.shape[0]
        cache = t5.decoder.init_cache(rows, 4, enc.dtype, enc.device)
        start = torch.full((rows, 1), model.t5_config.decoder_start_token_id,
                           dtype=torch.long, device=enc.device)
        logits = t5.decode_step(start, 0, cache, t5.decoder.cross_kv(enc), attn)
    return enc.float().cpu(), logits[:, 0].float().cpu()


def int8_kernel_vs_plain_path(torch, wrappers):
    from mr_blip_tpu_torch.profile_inference import make_samples

    samples = make_samples(2, 8, seed=7)
    gpu = reduced_model("cuda")
    cfg = gpu.t5_config
    # The rel-pos table and the T5 query projections as in phases 5 and 7, so
    # that the bias moves the attention and bf16 rounding flips no near-tie.
    state = gpu.state_dict()
    gen = torch.Generator(device="cuda").manual_seed(1)
    state[RELPOS_TABLE] = torch.randn(state[RELPOS_TABLE].shape, generator=gen,
                                      device="cuda")
    for name in state:
        if name.startswith("t5.") and name.endswith("attention.q.weight"):
            state[name] = (torch.randn(state[name].shape, generator=gen, device="cuda")
                           * (cfg.d_model * cfg.d_kv) ** -0.5)
    gpu.load_state_dict(state)
    state = {k: v.cpu() for k, v in state.items()}
    enc_bf16, logits_bf16 = int8_outputs(torch, gpu, samples)
    gpu.quantize_for_inference()
    for w in wrappers.values():
        w.launches = 0
    enc_gpu, logits_gpu = int8_outputs(torch, gpu, samples)
    rose = {name: w.launches for name, w in wrappers.items()}
    require(all(rose[k] for k in INT8_KERNELS) and rose["qkv_packed_attention"] == 0,
            f"reduced int8 model: launches {rose}")
    del gpu
    torch.cuda.empty_cache()
    cpu = reduced_model("cpu", init_params=False)
    cpu.load_state_dict(state)
    cpu.quantize_for_inference()
    t0 = time.time()
    enc_cpu, logits_cpu = int8_outputs(torch, cpu, samples)
    seconds = time.time() - t0
    cos = torch.nn.functional.cosine_similarity
    enc_cos = cos(enc_gpu, enc_cpu, dim=-1)
    logit_cos = cos(logits_gpu, logits_cpu, dim=-1)
    enc_q = cos(enc_gpu.flatten(), enc_bf16.flatten(), dim=0)
    logit_q = cos(logits_gpu.flatten(), logits_bf16.flatten(), dim=0)
    say(f"int8 kernel path vs int8 plain path (depth {REDUCED_DEPTH}, full width, "
        f"2 x 8 frames, encoder length {enc_gpu.shape[1]}): encoder per-row cosine min "
        f"{float(enc_cos.min()):.6f} mean {float(enc_cos.mean()):.6f}; first-step "
        f"logits per-row cosine min {float(logit_cos.min()):.6f}; int8 vs bf16 on the "
        f"card: encoder cosine {float(enc_q):.6f}, logits cosine {float(logit_q):.6f}; "
        f"kernel launches { {k: v for k, v in rose.items() if v} }; CPU run {seconds:.1f} s")
    require(float(enc_cos.min()) >= COSINE_MIN, f"encoder cosine {float(enc_cos.min())}")
    require(float(logit_cos.min()) >= COSINE_MIN, f"logits cosine {float(logit_cos.min())}")
    require(float(enc_q) > INT8_VS_BF16_COSINE_MIN and float(logit_q) > INT8_VS_BF16_COSINE_MIN,
            f"int8 vs bf16 cosines {float(enc_q)}, {float(logit_q)}")


# ------------------------------------------------------------ phases 13-15
def fp32_outputs(torch, model, samples):
    """Frame features and T5 encoder rows of one batch, fp32 on the host."""
    with torch.inference_mode():
        batch = model.prepare_mr_batch(samples)
        tensors = model._to_device(batch)
        feats = model.frames_to_t5(tensors)
        enc, _ = model.encode_t5(tensors, feats, model._encoder_bias_for(batch))
    return feats.float().cpu(), enc.float().cpu()


def fp32_path(torch, wrappers):
    """The second half of phase 13: the fp32 parity mode on the card. At 224
    pixels the ViT's fp32 QKV fails the packed-QKV kernel's type gate, so its
    attention is kernel 4's fp32 instantiation, once per block; the encoder
    (2,056 tokens at 60 frames) runs kernel 3's, once per layer."""
    from mr_blip_tpu_torch.profile_inference import make_samples
    from mr_blip_tpu_torch.text.span_grammar import moment_str_to_list

    samples = make_samples(BATCH, FP32_FRAMES, seed=3)
    gpu = reduced_model("cuda", compute_dtype="float32")
    for w in wrappers.values():
        w.launches = 0
    t0 = time.time()
    handle = gpu.generate_dispatch(samples)
    out = gpu.generate_collect(handle)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    rose = {name: w.launches for name, w in wrappers.items() if w.launches}
    for p in out["prediction"]:
        moment_str_to_list(p)
    require(bool(torch.isfinite(handle["scores"]).all()), "fp32: beam scores not finite")
    require(rose == {"flash_attention": REDUCED_DEPTH, "flash_bias_attention": REDUCED_DEPTH},
            f"fp32 path: launches {rose}")
    feats_gpu, enc_gpu = fp32_outputs(torch, gpu, samples)
    state = {k: v.cpu() for k, v in gpu.state_dict().items()}
    del gpu
    cpu = reduced_model("cpu", init_params=False, compute_dtype="float32")
    cpu.load_state_dict(state)
    t0 = time.time()
    feats_cpu, enc_cpu = fp32_outputs(torch, cpu, samples)
    cpu_seconds = time.time() - t0
    errs = []
    for label, got, want in (("frame features", feats_gpu, feats_cpu),
                             ("T5 encoder rows", enc_gpu, enc_cpu)):
        require(got.dtype == torch.float32 and got.shape == want.shape,
                f"fp32 path: {label} {got.dtype} {tuple(got.shape)}")
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        errs.append(f"{label} max|diff| {err:.3e} (max|plain| {scale:.4f})")
        require(err <= FP32_PATH_REL_TOL * scale, f"fp32 path: {label} off by {err}")
    say(f"fp32 path (depth {REDUCED_DEPTH}, full width, {BATCH} x {FP32_FRAMES} frames at "
        f"224², encoder length {enc_gpu.shape[1]}): generate {seconds:.3f} s, launches "
        f"{rose}; against the CPU's fp32 plain path ({cpu_seconds:.1f} s): "
        + ", ".join(errs) + f" (bar {FP32_PATH_REL_TOL:g} x)")
    torch.cuda.empty_cache()


def tap_answerer(model):
    """Keeps, per call of the model's answerer, the A-E logits of its second
    decoding step (fp32 on the host) and its encoder's output length."""
    logits, lengths = [], []
    inner = model._qa_answer_scores

    def tapped(samples):
        out = inner(samples)
        logits.append(out[1][1][:, model.answer_ids].float().cpu())
        return out

    model._qa_answer_scores = tapped
    model.answerer.encoder.register_forward_hook(
        lambda mod, args, out: lengths.append(out.shape[1]))
    return logits, lengths


def qa_path(torch, wrappers):
    """Phase 14: two-stage grounded QA at 364 pixels, full depth and width.
    Returns the launch counts of the run and its summary numbers."""
    from mr_blip_tpu_torch.profile_inference import QA_TASK, make_qa_samples

    t0 = time.time()
    model = flagship_model(img_size=BIG_IMG, task=QA_TASK,
                           num_frames_for_answer=QA_ANSWER_FRAMES)
    torch.cuda.synchronize()
    say(f"QA model built with random weights in {time.time() - t0:.1f} s; "
        f"{sum(p.numel() for p in model.module.parameters()) / 1e9:.3f} B params, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    batches = [make_qa_samples(BATCH, N_FRAMES, seed, BIG_IMG) for seed in range(BIG_BATCHES)]
    answer_logits, answerer_lengths = tap_answerer(model)
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    rows = []
    for i, samples in enumerate(batches):
        before = {name: w.launches for name, w in wrappers.items()}
        clock = [time.time()]

        def lap():
            torch.cuda.synchronize()
            clock.append(time.time())

        handle = model.videoQA_dispatch(samples)
        lap()
        handle = model.videoQA_redecode(handle)
        lap()
        frames = handle["frames"]
        out = model.videoQA_collect(handle)
        lap()
        localizer, crop, answerer = (b - a for a, b in zip(clock, clock[1:]))
        rows.append((clock[-1] - clock[0], localizer, crop, answerer))
        rose = {name: w.launches - before[name] for name, w in wrappers.items()}
        moments = out["relevant_moments"][0]
        say(f"QA batch {i}: {rows[-1][0]:.3f} s (localizer {localizer:.3f}, frame crop "
            f"{crop:.3f}, answerer {answerer:.3f})  launches "
            f"{ {k: v for k, v in rose.items() if v} }  predictions {out['output_text']}  "
            f"moments {moments}  A-E logits of video 0 "
            f"{[round(float(x), 3) for x in answer_logits[-1][0]]}; answerer's encoder "
            f"length {answerer_lengths[-1]}")
        require(len(answer_logits) == i + 1 and answerer_lengths[-1] == QA_ENCODER_LENGTH,
                f"QA batch {i}: the answerer ran {len(answer_logits) - i} times at encoder "
                f"length {answerer_lengths[-1]}, kernel 3 was held at {QA_ENCODER_LENGTH}")
        require(rose == EXPECTED_QA_LAUNCHES, f"QA batch {i}: launches {rose}, "
                f"expected {EXPECTED_QA_LAUNCHES}")
        require(len(out["output_text"]) == BATCH
                and all(p in range(5) for p in out["output_text"]),
                f"QA predictions {out['output_text']}")
        require(frames.shape == (BATCH, QA_ANSWER_FRAMES, BIG_IMG, BIG_IMG, 3)
                and str(frames.dtype) == "uint8", f"answerer frames {frames.shape}")
        for (start, end), duration in zip(moments, samples["duration"]):
            require(0 <= start <= end <= duration, f"moment {[start, end]} outside "
                    f"its video of {duration} s")
        require(answer_logits[-1].shape == (BATCH, 5)
                and bool(torch.isfinite(answer_logits[-1]).all()),
                "answer logits not finite")
    launches = {name: w.launches for name, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    steady = rows[1:]
    summary = {k: statistics.mean(r[j] for r in steady) for j, k in enumerate(
        ("steady_s", "localizer_s", "crop_s", "answerer_s"))}
    summary.update(first_s=rows[0][0], peak_gib=peak / 2**30)
    say(f"QA path: B={BATCH} x {N_FRAMES} frames at {BIG_IMG}², {QA_ANSWER_FRAMES} frames "
        f"for the answerer; steady {summary['steady_s']:.3f} s/batch (batches "
        f"1-{len(rows) - 1}: localizer {summary['localizer_s']:.3f}, frame crop "
        f"{summary['crop_s']:.3f}, answerer {summary['answerer_s']:.3f}), first "
        f"{rows[0][0]:.3f} s; peak memory {summary['peak_gib']:.2f} GiB")
    del model
    torch.cuda.empty_cache()
    return launches, summary


def qa_outputs(torch, model, samples, answer_logits):
    """ViT output rows, the main T5's encoder rows (the localizer's prompt)
    and the answerer's A-E logits (``answer_logits``: the model's
    ``tap_answerer`` list), fp32 on the host."""
    vit_rows = []
    hook = model.module.visual_encoder.register_forward_hook(
        lambda mod, args, out: vit_rows.append(out.detach().float().cpu()))
    enc = encoder_outputs(torch, model, samples)
    hook.remove()
    model.videoQA_generate(samples)
    return vit_rows[0], enc, answer_logits[-1]


def qa_kernel_vs_plain_path(torch, wrappers):
    """Phase 15: the depth-2 QA model at 364 pixels, kernel path (card)
    against plain path (CPU), float and with the int8 ViT; and the "xla"
    attention backend against "auto" on the card."""
    from mr_blip_tpu_torch.ops.attention import set_attention_backend
    from mr_blip_tpu_torch.profile_inference import make_qa_samples

    frames = 8
    samples = make_qa_samples(2, frames, seed=7, img_size=BIG_IMG)
    kw = dict(task="qformer_freeze_lora_QA", img_size=BIG_IMG, num_frames_for_answer=frames)
    gpu = reduced_model("cuda", **kw)
    cfg = gpu.t5_config
    # Both T5 stacks as phase 7 draws them: rel-pos tables at N(0, 1), query
    # projections at HF T5's init scale.
    state = gpu.state_dict()
    gen = torch.Generator(device="cuda").manual_seed(1)
    for name in state:
        if name.endswith("encoder.rel_bias.rel_embedding"):
            state[name] = torch.randn(state[name].shape, generator=gen, device="cuda")
        elif "t5." in name and name.endswith("attention.q.weight"):
            state[name] = (torch.randn(state[name].shape, generator=gen, device="cuda")
                           * (cfg.d_model * cfg.d_kv) ** -0.5)
    gpu.load_state_dict(state)
    state = {k: v.cpu() for k, v in state.items()}
    cpu = reduced_model("cpu", init_params=False, **kw)
    cpu.load_state_dict(state)
    gpu_logits, _ = tap_answerer(gpu)
    cpu_logits, _ = tap_answerer(cpu)
    cos = torch.nn.functional.cosine_similarity

    def compare(label, got, want, seconds):
        mins = {}
        for name, g, w in zip(("ViT rows", "T5 encoder rows", "A-E logits"), got, want):
            c = cos(g, w, dim=-1)
            mins[name] = float(c.min())
            require(mins[name] >= COSINE_MIN, f"{label}: {name} cosine {mins[name]}")
        say(f"{label} (depth {REDUCED_DEPTH}, full width, 2 x {frames} frames at "
            f"{BIG_IMG}², {got[0].shape[1]} tokens an image): per-row cosine min "
            + ", ".join(f"{k} {v:.6f}" for k, v in mins.items())
            + f"; A-E logits of video 0 {[round(float(x), 3) for x in got[2][0]]} vs "
            f"{[round(float(x), 3) for x in want[2][0]]}; kernel launches "
            f"{ {k: w.launches for k, w in wrappers.items() if w.launches} }; CPU run "
            f"{seconds:.1f} s")

    def run_both(label, expect):
        for w in wrappers.values():
            w.launches = 0
        got = qa_outputs(torch, gpu, samples, gpu_logits)
        rose = {k: w.launches for k, w in wrappers.items()}
        require(all(rose[k] == v for k, v in expect.items()), f"{label}: launches {rose}")
        t0 = time.time()
        want = qa_outputs(torch, cpu, samples, cpu_logits)
        compare(label, got, want, time.time() - t0)
        return got

    # The ViT runs twice (the localizer's prompt, then the answerer).
    float_out = run_both("364 pixels and QA, kernel path vs plain path",
                         {"flash_attention": 2 * REDUCED_DEPTH, "qkv_packed_attention": 0,
                          "flash_bias_attention": 2 * REDUCED_DEPTH})
    # The "xla" backend on the card against "auto": no flash kernel at all.
    set_attention_backend("xla")
    try:
        for w in wrappers.values():
            w.launches = 0
        xla_out = qa_outputs(torch, gpu, samples, gpu_logits)
        flash = {k: w.launches for k, w in wrappers.items()
                 if k.startswith("flash") and w.launches}
    finally:
        set_attention_backend("auto")
    require(not flash, f"the xla backend launched {flash}")
    compare('attention backend "auto" vs "xla" on the card', float_out, xla_out, 0.0)
    # The int8 ViT above the bound: the split route on both sides.
    gpu.quantize_vit()
    cpu.quantize_vit()
    run_both("364 pixels and QA with the int8 ViT, kernel path vs plain path",
             {"flash_attention": 2 * REDUCED_DEPTH, "w8a8_attn_block": 0,
              "w8a8_linear": 4 * REDUCED_DEPTH, "w8a8_mlp": 2 * REDUCED_DEPTH})
    del gpu, cpu
    torch.cuda.empty_cache()


# --------------------------------------------------------------------- main
def kernel_tables():
    """The wrappers whose launches are counted, and one entry per kernel for
    the ``kernels`` line (source in the port, TPU kernel replaced)."""
    from mr_blip_tpu_torch.ops import flash_attention as fa
    from mr_blip_tpu_torch.ops import int8_matmul as i8
    from mr_blip_tpu_torch.ops.layer_norm import fused_layer_norm

    wrappers = {"layer_norm": fused_layer_norm,
                "qkv_packed_attention": fa.flash_attention_qkv_packed,
                "flash_attention": fa.flash_attention,
                "flash_bias_attention": fa.flash_attention_bias,
                "flash_bias_fwd_stats": fa.flash_bias_fwd_stats,
                "flash_bias_bwd_dq": fa.flash_bias_bwd_dq,
                "flash_bias_bwd_dq_dbias": fa.flash_bias_bwd_dq_dbias,
                "flash_bias_bwd_dkv": fa.flash_bias_bwd_dkv,
                "flash_relpos_fwd_stats": fa.flash_relpos_fwd_stats,
                "flash_relpos_bwd_dq": fa.flash_relpos_bwd_dq,
                "flash_relpos_bwd_dq_dtable": fa.flash_relpos_bwd_dq_dtable,
                "flash_relpos_bwd_dkv": fa.flash_relpos_bwd_dkv,
                "w8a8_linear": i8.w8a8_linear, "w8a8_mlp": i8.w8a8_mlp,
                "w8a8_mlp_gated": i8.w8a8_mlp_gated,
                "w8a8_attn_block": i8.w8a8_attn_block}
    fa_src = "mr_blip_tpu/ops/flash_attention.py"
    i8_src = "mr_blip_tpu/ops/int8_matmul.py"
    sources = {
        "layer_norm": ("layer_norm.cu", "mr_blip_tpu/ops/layer_norm.py:26"),
        "qkv_packed_attention": ("qkv_packed_attention.cu", f"{fa_src}:1446"),
        "flash_attention": ("flash_attention.cu", f"{fa_src}:54"),
        "flash_bias_attention": ("flash_bias_attention.cu", f"{fa_src}:195"),
        "flash_bias_fwd_stats": ("flash_bias_attention.cu", f"{fa_src}:421"),
        "flash_bias_bwd_dq": ("flash_bias_backward.cu", f"{fa_src}:507"),
        "flash_bias_bwd_dq_dbias": ("flash_bias_backward.cu", f"{fa_src}:545"),
        "flash_bias_bwd_dkv": ("flash_bias_backward.cu", f"{fa_src}:594"),
        "flash_relpos_fwd_stats": ("flash_relpos_attention.cu", f"{fa_src}:882"),
        "flash_relpos_bwd_dq": ("flash_relpos_backward.cu", f"{fa_src}:1121"),
        "flash_relpos_bwd_dq_dtable": ("flash_relpos_backward.cu", f"{fa_src}:1015"),
        "flash_relpos_bwd_dkv": ("flash_relpos_backward.cu", f"{fa_src}:1180"),
        "w8a8_linear": ("int8_matmul.cu", f"{i8_src}:123"),
        "w8a8_mlp": ("int8_matmul.cu", f"{i8_src}:229"),
        "w8a8_mlp_gated": ("int8_matmul.cu", f"{i8_src}:359"),
        "w8a8_attn_block": ("int8_attn_block.cu", f"{i8_src}:505"),
    }
    kernels = {key: {"name": key, "route": "cuda",
                     "source": f"mr_blip_tpu_torch/csrc/{src}", "replaces": rep}
               for key, (src, rep) in sources.items()}
    return wrappers, kernels


def main():
    start = time.time()
    if not (ROOT / "mr_blip_tpu_torch" / "csrc").is_dir():
        raise SystemExit("chip_smoke.py: mr_blip_tpu_torch/csrc not found next "
                         "to this script; run it from a checkout of the repo")
    sys.path.insert(0, str(ROOT))
    import torch

    # phase 1: device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    say(smi)
    say(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    say(f"device 0: {name}, {torch.cuda.device_count()} visible")

    # phase 2: build
    from mr_blip_tpu_torch.ops import _cuda

    t0 = time.time()
    lib = _cuda.build()
    _cuda.library()
    say(f"kernels built and loaded in {time.time() - t0:.1f} s: {lib.relative_to(ROOT)}")
    for line in (lib.parent / "ptxas.log").read_text().splitlines():
        if "Used" in line or "spill" in line:
            say("  ptxas:", line.strip())

    wrappers, kernels = kernel_tables()

    # phase 3: kernel vs plain
    check_kernels(torch, kernels)
    check_flash_kernel(torch, kernels)
    check_train_kernels(torch, kernels)
    check_relpos_kernels(torch, kernels)
    check_int8_kernels(torch, kernels)
    # phase 4: the generate path at full width (kernels 1-3)
    launches, bf16_summary = main_path(torch, wrappers)
    # phase 5: kernel path vs plain path, encoder outputs
    kernel_vs_plain_path(torch, wrappers)
    # phase 6: the LoRA train path at full width (kernels 5, 6, 8)
    train_launches = train_path(torch, wrappers)
    # phase 7: kernel path vs plain path, gradients (kernel 7 under full finetune)
    dbias_launches = gradients_kernel_vs_plain(torch, wrappers)
    # phase 8: the int8 generate path at full width and depth (kernels 13-16)
    int8_launches, int8_summary = main_path(torch, wrappers, int8=True)
    say("generate, bf16 (phase 4) vs int8 (phase 8), seconds: " + ", ".join(
        f"{k} {bf16_summary[k]:.3f} vs {int8_summary[k]:.3f}"
        for k in ("steady_s", "frames_to_qformer_s", "t5_encode_s", "decode_s"))
        + f"; peak memory {bf16_summary['peak_gib']:.2f} vs "
        f"{int8_summary['peak_gib']:.2f} GiB")
    # phase 9: int8 kernel path vs int8 plain path, and int8 vs bf16
    int8_kernel_vs_plain_path(torch, wrappers)
    # phase 10: long-context generate at full depth and width (kernel 9), bf16
    # and int8, and one materialized-bias run of the same batches beside them
    long_launches, long_summary = main_path(torch, wrappers, long=True)
    _, long_int8_summary = main_path(torch, wrappers, int8=True, long=True)
    _, long_mat_summary = main_path(torch, wrappers, long=True, relpos_in_kernel=False)
    say(f"long-context generate (4 x {LONG_FRAMES} frames, encoder length "
        f"{long_summary['encoder_length']}), in-kernel bias bf16 / in-kernel bias int8 / "
        "materialized bias bf16 (kernel 3), seconds: " + ", ".join(
            f"{k} " + " / ".join(f"{x[k]:.3f}" for x in (long_summary, long_int8_summary,
                                                         long_mat_summary))
            for k in ("steady_s", "first_s", "frames_to_qformer_s", "t5_encode_s", "decode_s"))
        + "; peak memory " + " / ".join(
            f"{x['peak_gib']:.2f}" for x in (long_summary, long_int8_summary,
                                             long_mat_summary)) + " GiB")
    # phase 11: the long-context LoRA train step (kernels 9, 10, 12)
    long_train_launches = train_path(torch, wrappers, long=True)
    # phase 12: long context, kernel path vs plain path (kernel 11 under full finetune)
    dtable_launches = gradients_kernel_vs_plain(torch, wrappers, long=True)
    # phase 13: generate at 364 pixels (kernel 4), then the fp32 parity mode
    big_launches, big_summary = main_path(torch, wrappers, img_size=BIG_IMG)
    say(f"generate at 224² (phase 4) vs {BIG_IMG}² (phase 13), seconds: " + ", ".join(
        f"{k} {bf16_summary[k]:.3f} vs {big_summary[k]:.3f}"
        for k in ("steady_s", "frames_to_qformer_s", "t5_encode_s", "decode_s"))
        + f"; peak memory {bf16_summary['peak_gib']:.2f} vs "
        f"{big_summary['peak_gib']:.2f} GiB")
    _, big_int8_summary = main_path(torch, wrappers, int8=True, img_size=BIG_IMG)
    say(f"generate at {BIG_IMG}², bf16 vs int8 (the ViT's split route), seconds: "
        + ", ".join(f"{k} {big_summary[k]:.3f} vs {big_int8_summary[k]:.3f}"
                    for k in ("steady_s", "frames_to_qformer_s", "t5_encode_s", "decode_s"))
        + f"; peak memory {big_summary['peak_gib']:.2f} vs "
        f"{big_int8_summary['peak_gib']:.2f} GiB")
    fp32_path(torch, wrappers)
    # phase 14: two-stage grounded QA at 364 pixels
    qa_path(torch, wrappers)
    # phase 15: 364 pixels and QA, kernel path vs plain path
    qa_kernel_vs_plain_path(torch, wrappers)

    for key, entry in kernels.items():
        if key == "flash_attention":
            entry["launches"] = big_launches[key]
        elif key in INT8_KERNELS:
            entry["launches"] = int8_launches[key]
        elif key in GENERATE_KERNELS:
            entry["launches"] = launches[key]
        elif key == "flash_bias_bwd_dq_dbias":
            entry["launches"] = dbias_launches
        elif key == "flash_relpos_fwd_stats":
            entry["launches"] = long_launches[key]
        elif key == "flash_relpos_bwd_dq_dtable":
            entry["launches"] = dtable_launches
        elif key.startswith("flash_relpos"):
            entry["launches"] = long_train_launches[key]
        else:
            entry["launches"] = train_launches[key]
    say(f"wall time {time.time() - start:.1f} s")
    say(json.dumps({"kernels": [
        {k: entry[k] for k in ("name", "route", "source", "replaces", "launches",
                               "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                               "library_ms")}
        for entry in kernels.values()]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
