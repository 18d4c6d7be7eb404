#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``mr_blip_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA H100 (sm_90a),
the CUDA toolkit (nvcc) and PyTorch built for CUDA. It imports no JAX.
Phases, each printing its own lines; any failure raises, so the exit code
is nonzero and the final line is not printed. Phase 4 decodes the flagship's
published 50 new tokens; the flagship's generates of phases 8, 10, 13, 14,
16-18, 20-24 and 26 (b) decode SHORT_NEW_TOKENS (16): random weights never
emit EOS, so each runs to its cap, and what those phases hold (launches per
batch, rows equal to ``generate`` on the same model) holds at any length.
The OPT variant (phase 19), the serve process (phase 20) and phase 25 keep 50.

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
   residual, at its main-path shapes (Q-Former cross K/V with bias, T5 qkv
   with the RMS pre-norm, T5 o with the residual, the 364-pixel ViT's qkv
   and proj) and at the tiny configs' widths (32 x 96, 64 x 64), max |diff|
   <= 0.35; GELU MLP (61,677, 1,408, 6,144) with LN and residual, and the
   chunk widths of its chain route (D 128 and H 384 in chunks of 128, D 576
   and H 1,152 with chunk 576, the tiny ViT's D 32 and H 64) <= 0.4; gated
   MLP (8,191, 2,048, 5,120), its main-path shape (8,224 rows, RMS,
   residual) and the long-context batch's 32,000 rows on its tile route,
   and the chunk widths of its chain route (D 512 and H 2,048 in chunks of
   512, the tiny T5's D 64 and H 256 in chunks of 128) <= 0.4; attention block
   (6, 264, 1,408) with n_valid 257 and large garbage in the pad rows (which
   must not move a valid row by a bit), (240, 257, 1,408) and (2, 400,
   1,408) (past the resident K/V: the first version's attention) <= 0.05; each
   with cosine >= 0.999, and the share of elements more than 2 bf16 ulps off
   printed (a flipped requantization step moves one row); a float32 input on
   the card must raise. Kernels 3, 5 and 6-8 in fp32 (the parity mode's
   CUDA-core bodies) at 4 x 2,056, at 4 x 2,049 with a ragged key mask and at
   2 x 300 with a fully masked batch row, kernel 3 through the dispatch, the
   backward kernels from the plain forward's lse and δ: out, dq, dk, dv and
   dbias max |diff| <= 1e-4 x max |plain|, lse <= 1e-3, each timed at 4 x
   2,056 beside the library's fp32 call; a float16 call to kernel 3 or 6 must
   raise. Times by CUDA events, median of 10 launches: the
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
   (120 frames) and at 2,049, 1,037, 300, 257 (near tiles only), 100 and
   40 (a backward work item's second 64-row half partly or wholly past the
   end), with ragged key masks and a fully masked batch row: the same bars as kernels 5-8,
   dtable max |diff| <= 0.02 x max |plain| and bit-equal between two
   launches; the plain version with the table zeroed must fail the bar; a
   float16 call on the card must raise. Kernels 9-12 in fp32 (the parity
   mode's CUDA-core bodies) at 2 x 1,037, 2 x 257 with a ragged key tail and
   2 x 300 with a fully masked batch row: out, dq, dk, dv and dtable within
   1e-4 x max |plain|, lse <= 1e-3, dtable bit-equal between two launches;
   timed at 1 x 4,008 beside the library's fp32 calls. Kernel 9 is timed at the generate
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
   batch, predictions must parse and beam scores be finite; no more than the
   model's weights and 1 GiB may be allocated before the batches (so that the
   peak is the path's own), and each stage prints its peak above its start
   (as phases 8, 10 and 13 do);
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
   off, one forward and backward of 1 x 8 frames each for
   ``qformer_freeze_lora``, ``lora``
   (the Q-Former trains: the LayerNorm backward runs on the card) and
   ``qformer_freeze`` (the full-finetune backward: the rel-pos table trains
   and kernel 7 launches once per encoder layer), on the card and on the CPU
   in bf16; relative loss difference <= 1e-2 and, per trainable tensor,
   gradient cosine >= 0.99. Then the fp32 parity mode
   (``compute_dtype="float32"``) on both sides for ``qformer_freeze_lora``
   (kernels 5, 6, 8 in fp32) and ``qformer_freeze`` (5, 7, 8): relative loss
   difference <= 1e-4 and gradient cosine >= 0.9999, each of the three
   kernels launched once per encoder layer.

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
    1 x 8 frames (also against the card's own ``relpos_in_kernel=False``
    run of the same weights) and ``qformer_freeze`` at 1 x 8 frames (the
    rel-pos table trains: kernel 11 launches once per encoder layer and the
    table's gradient is compared with the plain path's); T5 encoder rows
    cosine >= 0.999, loss and gradients within phase 7's bars. Then the fp32
    parity mode on both sides, both tasks on a short clip of 1 x 8 frames
    (kernels 9, 10, 12 and 9, 11, 12 in fp32 on the model path; phase 3
    holds them in fp32 at 8,000 tokens): loss within 1e-4 relative, gradient
    cosine >= 0.9999, as phase 7's fp32 runs; the first fp32 model also
    generates (kernel 9 in fp32 once per encoder layer, the prediction
    parses).

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
    ``compute_dtype="float32"`` at 224 pixels generates one batch of 1 x 60
    frames (encoder length 2,056) with kernel 4's and kernel 3's fp32
    instantiations once per ViT block and per encoder layer and no other
    kernel, and its frame features and T5 encoder rows must agree with the
    CPU's fp32 plain path to 1e-4 of their largest magnitude;
14. grounded QA at 364 pixels: ``BLIP2_MR(img_size=364,
    task="qformer_freeze_lora_QA_with_localizer", num_frames_for_answer=60)``
    (``configs/projects/eval/nextGQA.yaml`` but for ``resample_frames`` and
    the image size), full depth and width, 1 batch of 4 videos x 60 frames
    with five-option questions through ``videoQA_generate`` (a first batch
    took what a second one did); kernel 4 must launch 78 times (the
    localizer's ViT and the answerer's), biased flash 48, LayerNorm 220;
    every prediction in 0..4, every moment inside its video, the answerer's
    A-E logits finite, its encoder length the 2,040 that phase 3 holds kernel
    3 at; prints its seconds split into localizer, frame crop and answerer,
    and peak memory; then the batch's frames put on the card are cropped
    there (a CUDA tensor out, equal to the host crop), both crops timed;
15. 364 pixels and QA, kernel path vs plain path: the depth-2 full-width
    ``qformer_freeze_lora_QA`` model (weights as in phase 7, both T5 stacks)
    on 1 x 8 frames at 364², in bf16 on the CPU and on the card: ViT output
    rows and T5 encoder rows cosine >= 0.999, the answerer's A-E logits
    cosine >= 0.999 per row; the same after ``quantize_vit()`` (the split
    int8 route: W8A8 linear, kernel 4, W8A8 linear per block, no fused
    block); and on the card ``set_attention_backend("xla")`` against
    ``"auto"`` (no flash launch, ViT rows cosine >= 0.999).
16. the evaluation entry point: ``mr_blip_tpu_torch.evaluate.main`` on
    ``configs/projects/eval/qvh.yaml`` (read by the port's own YAML reader:
    EVA ViT-g, Flan-T5-XL, bf16, 60 frames, beam 5, batch 4, uint8 frames),
    over a synthetic test split of 8 queries on 150 s videos at 10 fps
    (``datasets/synthetic.py``), with ``videos.storage=synthetic``,
    ``model.load_finetuned=False`` (random weights from ``from_config``) and a
    temporary ``run.output_dir``; each of its 2 batches must reach the model
    with its frames already on the card and launch kernels 1 / 2 / 3 110 / 39 /
    24 times (no other kernel), its result rows must equal ``model.generate``
    on the same loader batches from the same model, string for string, and
    its metrics dict must hold the six keys with ``total`` 8. Prints seconds
    and frames/s per batch, the time before the first batch, peak memory and
    the metrics (random weights: every span is ``[[-1, -1]]``, so the scores
    are no quality number). Then temporal action localization on the same
    model: ``evaluate.main`` on ``configs/projects/eval/anet_TAL.yaml``
    (task ``temporal_action_localization``, the ``anet_TAL`` builder; its
    model section asks ``from_config`` for what qvh.yaml's does, checked on the
    constructor's arguments) over one batch of 4 synthetic 120 s videos
    (ActivityNet's length; every other query empty, as in TAL): launches
    110 / 39 / 24, rows equal to a serial ``model.generate``, the metrics the
    JAX task's seven keys, and the warning for the missing classes file.
17. the train entry point: ``mr_blip_tpu_torch.train.main`` on
    ``configs/projects/train/qvh.yaml`` as published (EVA ViT-g and Q-Former
    frozen, Flan-T5-XL with LoRA r=8, ``use_grad_checkpoint``, micro-batches
    of 1 x 60 frames, ``accum_grad_iters`` 8, ``linear_warmup_cosine_lr``,
    random weights) but for synthetic annotations (8 train queries, 1 val, 1
    test, 150 s videos at 10 fps), ``run.max_epoch=1`` and a temporary output
    directory: every micro-batch must launch kernel 5 48 times (the forward
    and each encoder block's recompute), 6 and 8 24, LayerNorm 110, packed QKV
    39, kernels 3 and 7 never, and every val/test generate 110 / 39 / 24;
    every loss finite; after the run every trainable tensor moved and every
    frozen one bit-equal. Then one 1 x 60 micro-batch of that model with
    checkpointing on and off on the same dropout masks (loss within 1e-6
    relative, LoRA gradients cosine >= 0.9999 and max |diff| <= 1e-3 x max
    |g|, each one's peak memory printed). Prints seconds per micro-batch and
    per update and peak memory.
    (A run SIGTERMed mid-window and its bit-equal resume run in phase 21,
    on the QLoRA model.)
18. the grounded-QA evaluation entry point: ``mr_blip_tpu_torch.evaluate.main``
    on ``configs/projects/eval/nextGQA.yaml`` as published (task ``videogqa``,
    ``qformer_freeze_lora_QA_with_localizer``: EVA ViT-g, Q-Former, Flan-T5-XL
    localizer and answerer at full width and depth, bf16, 60 frames at 224²,
    ``num_frames_for_answer`` 60, ``resample_frames: True``, beam 5, batch 1,
    8 loader threads) but for a synthetic split of QA_QUESTIONS five-option
    grounded questions over 40 s ``synthetic://`` videos (NExT-QA's length),
    ``model.load_finetuned=False`` (random weights) and a temporary output
    directory. Per question the localizer's generate and the answerer must
    launch kernels 1 / 2 / 3 220 / 78 / 48 times together (phase 16's
    110 / 39 / 24 twice) and no other kernel; the rows must equal, field for
    field, a serial ``videoQA_generate`` of the same loader batches on the
    same model; on random weights every span is ``[[-1, -1]]``, so every
    row's moment must be ``[0, round(duration)]`` and the frames handed to
    the answerer must equal, bit for bit, the reader's own decode of the 60
    uniform picks inside that window; the metrics must carry Acc@GQA, mIoP,
    TIoP@0.3/0.5, mIoU, TIoU@0.3/0.5, ``agg_metrics`` and ``total``. Prints
    seconds per question (steady, pipelined), the localizer / re-decode /
    answerer split of the serial run, and peak memory beside the card.
19. the OPT variant's evaluation entry point: ``mr_blip_tpu_torch.evaluate.main``
    on ``configs/projects/eval/opt_charades.yaml`` (``blip2_opt_mr``: EVA
    ViT-g, Q-Former and OPT-2.7b at full width and depth (32 layers, d 2,560,
    32 heads, FFN 10,240), bf16, greedy, ``min_len`` 5, batch 1; vocabulary
    of the fallback tokenizer, random weights) over OPT_QUESTIONS synthetic
    queries on 30 s videos (Charades-STA's length), one model built for the
    phase. At the published 60 frames the prompt passes OPT's 2,048
    positions: the run must raise the model's ``ValueError``. The frame count
    is cut to the largest whose prompt and 50 new tokens fit (printed; it
    must be OPT_FRAMES, whose prefill rows phase 3 holds kernel 1 at); each
    question must launch LayerNorm 110 (ViT, ln_vision, Q-Former) + 65 for
    the prefill + 65 per decode step, packed QKV 39, no other kernel; rows
    equal a serial ``model.generate`` of the same loader batches. Prints
    seconds per question (steady) and peak memory. Then one LoRA micro-batch
    of ``TrainCtx.step`` on that model (finite loss, every LoRA gradient
    finite and nonzero, LayerNorm 175 and packed QKV 39 launches), and the
    depth-2 model at full width on 1 x 8 frames against the CPU's plain path
    (the OPT's logits over the prompt, cosine >= 0.999 row by row).
20. online serving: ``models.load_model("blip2_mr", "pretrain_flant5xl")``
    on the card (EVA ViT-g, Q-Former, Flan-T5-XL, bf16, beam 5, weights
    redrawn from seed 0) behind a ``MomentRetrievalServer`` (max_batch 4,
    buckets 1/2/4, two decode workers), ``warmup(60)``; (a) four frame
    requests from one thread form one batch whose rows equal
    ``model.generate`` on the same four rows; (b) three requests form one
    batch padded to 4 whose rows equal ``generate`` on the padded rows' first
    three; (c) 8 ``synthetic://`` requests of 150 s (QVHighlights' length)
    from 8 client threads through ``serve.make_httpd`` on 127.0.0.1: every
    reply 200 and a span list. Every dispatched batch, warmup and reference
    generates included, launches kernels 1 / 2 / 3 110 / 39 / 24 times.
    Prints batches, occupancy, requests/s, latency p50/p95/p99, seconds per
    batch under load beside phase 4's and peak memory. Then ``python -m
    mr_blip_tpu_torch.serve --model-type pretrain_flant5xl --n-frms 60 --port
    0`` as a process: four requests answered, SIGTERM, exit 0 with its stats
    line.
21. QLoRA-style training: ``mr_blip_tpu_torch.train.main`` on
    ``configs/projects/train/qvh.yaml`` with ``model.int8_base=True
    model.int8_vit=True`` (the T5 base weight-only int8 under the LoRA
    deltas, the ViT on the W8A8 kernels; random weights) over 4 synthetic
    train queries, one val and one test, micro-batches of 1 x 60 frames
    under ``use_grad_checkpoint``, 2 to an update (``run.accum_grad_iters``;
    10 queries and qvh.yaml's 8 until phase 26 came). A first run is
    SIGTERMed from a thread of this process after 3 micro-batches (one
    update and one micro-batch into the next window): it must exit 143 with a
    ``resume_state.pth`` of ``epoch_complete`` False; a second, resuming from
    it, must load the weights (every ``kernel_q`` among them), AdamW state,
    counters and partial gradients bit for bit, log ``(epoch 0)``, re-run the
    epoch and exit 0. Per micro-batch of both runs LayerNorm 32, kernels 16
    and 14 39 each, 5 48, 6 and 8 24, nothing else; the val/test generates
    32 / 39 / 39 / 24 (kernels 1 / 16 / 14 / 3); every T5 ``kernel_q``
    bit-equal after the update and after the resumed run, every LoRA tensor
    moved, every loss finite; one more forward with checkpointing off saves
    no float tensor of an int8 weight's shape for the backward. Prints
    seconds per micro-batch and per update and peak memory beside phase
    17's, and the resume state's bytes and write and load seconds. Then the
    depth-2 model (``int8_base`` and the int8 ViT, weights as phase 7 draws
    them) on the card against the CPU's plain path in bf16: loss within 1e-2
    relative, every LoRA gradient's cosine >= 0.99.
22. data and sequence parallelism on the one card: two ranks under
    ``python -m torch.distributed.run --standalone --nproc_per_node=2`` (this
    script as the worker, ``--dp-worker``), both on the one card over
    ``gloo`` (``run.dist_backend=gloo``: NCCL refuses two ranks on one
    device), each launch under a subprocess timeout and a group timeout.
    (a) ``mr_blip_tpu_torch.train`` on ``configs/projects/train/qvh.yaml``
    as published over synthetic annotations (4 train, 1 val, 1 test query;
    8 train and 2 of each until phase 26 came), one epoch, ``accum_grad_iters`` 2: each
    rank takes 2 micro-batches of 1 x 60 frames, one update over the 4 rows.
    Gates: every
    trainable tensor bit-equal across the ranks after the run (all-gathered
    fingerprints), every frozen one bit-equal to its value as built; each
    rank's micro-batch launches phase 17's counts (kernel 5 48, 6 and 8 24,
    LayerNorm 110, packed QKV 39); the merged val and test rows hold each
    query once, each equal to rank 0's own ``model.generate`` of that query
    after the run. Prints each rank's seconds per micro-batch, seconds per
    update, the gradient all-reduce's milliseconds and peak memory. (b) A
    worker at phase 4's flagship widths, every stack 2 deep (full depth before
    phase 24 came; task ``lora``: the Q-Former trains too), dropout 0: dp, one update over one 1 x 60 row per
    rank (targets of unequal length) against rank 0's one-process update
    over both rows from the same start, each row a batch of its own, no
    collective (the rows as one batch of 2 printed beside it: at this depth
    the random-weight model turns the float noise of other shapes into
    large differences): loss within 1e-3 relative, gradient cosine >= 0.999 (the whole gradient), the trainable
    tensors within 1e-3 x their max |value| and at most 1e-3 of their
    elements more than the lr apart (AdamW's first update is about lr·sign(g): a near-zero gradient
    whose sign flips lands 2·lr away; a wrong gradient flips many); sp (``sequence_parallel``), one 1 x 60 row on both
    ranks, each rank's ViT over 30 frames, against the one-process step over
    the two frame shares one after the other (one pass over the 60 printed
    beside it): the same bars, and ``generate``'s spans identical. Then NCCL at world size 1: rank 0 alone joins a one-rank
    ``nccl`` group and takes dp's reference update through it (the
    update's all-reduce on NCCL), against the update without a group; prints
    NCCL's version.
23. the reference-checkpoint import and the BLIP2_MR variants. (a) Phase 4's
    model (full width and depth, seed 0) exported to the reference's four
    sources in their own names (LAVIS EVA ViT-g with ``q_bias``/``v_bias``,
    the BLIP-2 stage-2 ``Qformer.*``/``query_tokens``/``ln_vision``/
    ``t5_proj``, the HF T5, the PEFT ``lora_A``/``lora_B`` under
    ``t5_model.``), every parameter filled with NaN, imported through
    ``models/port.py::port_checkpoints``: no NaN left, every tensor bit-equal
    to before, and one 4 x 60 batch's T5 encoder states, beam scores and
    spans bit-equal to the batch run before the round trip (kernels 1-3
    twice phase 4's counts: the encode and the generate). (b) The depth-2
    model at published widths, its weights drawn from another seed, written
    as the reference's files (``eva_vit_g.pth``, a ``{"model": ...}`` BLIP-2
    ``.pth``, a two-shard safetensors T5 directory with its index, a
    finetuned ``.pth`` with ``t5_model.`` and ``answerer_model.`` LoRA), then
    ``port_weights.main`` and ``from_config`` with ``pretrained`` set to its
    output (``load_model`` at depth 2): every tensor equal to the source's.
    (c) Each variant at full width and depth on (a)'s weights, one 1 x 60
    batch: ``only_frames`` (encoder length 1,992, where phase 3 holds kernel
    3), ``frame_token_aggregation="mean"`` (200 tokens: the plain attention),
    ``fast_gelu`` and ``blip2_fmr`` (per-frame rows of ~85 tokens): spans
    parse or the 60 scores are finite, and kernels 1-3 launch 110 / 39 / 24
    (0 for mean and blip2_fmr); then each at depth 2 on 1 x 8 frames (4 new
    tokens) on the card against the CPU's plain path (rel-pos table at N(0,
    1)): T5 encoder
    rows cosine >= 0.999 and equal spans (blip2_fmr: first-step logits
    cosine >= 0.999, yes-no scores within 2% of the largest logit and equal
    answers where a score is clear of a threshold put in the widest gap of
    the CPU's scores). Prints each
    part's seconds and peak memory beside the card.
24. the unfrozen-ViT train path. (a) ``mr_blip_tpu_torch.train.main`` on
    ``configs/projects/train/qvh.yaml`` as published with
    ``model.freeze_vit=False``: the EVA ViT-g trains (fp32 masters cast to
    bf16 at use, stochastic depth ramped to 0.4, every block checkpointed),
    2 synthetic train queries (one update over 2 micro-batches of 1 x 60, 8
    until phase 26 came, 4 until phase 28),
    one val query. Gates: every ViT tensor moved, every frozen tensor (T5
    base, Q-Former) bit-equal, every loss finite, per micro-batch LayerNorm
    188 and packed QKV 78 (forward and recompute: bf16 reaches kernel 2
    from the fp32 masters), kernel 5 48, 6 and 8 24, the val generate phase
    4's. Prints the seconds per micro-batch and update, the optimizer
    step's, the peak; then one more micro-batch under ``torch.profiler``:
    its device time and the shares of the plain backward of kernels 1 and 2
    and of the ViT's forward, backward and recompute. (b) The depth-2 model
    at full width with the ViT trained, 1 x 8 frames, at 224 and 364 pixels
    (kernels 1, 2 and 1, 4 under autograd): the card's loss and every
    trainable gradient against the CPU's plain path in bf16, loss within
    1e-2 relative, every cosine >= 0.99 (phase 7's bars).
25. the real vocabulary, the offline scorer and the asset-day gates. (a)
    The committed tokenizer directories (``tests/data/torch_tokenizer/``:
    the JAX fixture, the Flan-T5-shaped one with its precompiled charsmap,
    OPT's byte-level BPE) through the port's own reader: every golden
    string's ids and decodes equal to those ``transformers`` wrote into
    ``ids.json``, and no ``transformers``, ``tokenizers``, ``sentencepiece``
    or ``regex`` in the process. (b) The flagship built with
    ``tokenizer_path`` (the Flan-T5-shaped directory: 32,128 rows, phase 4's
    geometry, so the seed draws phase 4's weights, checksummed), one 4 x 60
    batch of phase 4's samples: kernels 1-3 110 / 39 / 24, the encoder
    length 2,024 (prompt 2,017; phase 3 holds kernel 3 there), the spans
    parse; the host's prompt preparation a batch beside the mock's. (c)
    ``python -m mr_blip_tpu_torch.standalone_eval`` on the committed QVH
    goldens (``qvh_expected.json`` exactly) and ``python -m
    mr_blip_tpu_torch.asset_gates`` on two ``log.txt`` files of phase 16's
    metrics (int8 drift gate exit 0, baseline gate exit 1), in processes of
    their own.
26. tensor parallelism and the dp server on the one card. (a) Two ranks of
    one tensor-parallel group (``run.tp=2``, dp 1) under
    ``python -m torch.distributed.run`` (``--dp-worker tp``), both on the
    card over gloo, every T5 attention on 16 of its 32 heads, the FFN on
    2,560 of its 5,120 columns (the row-parallel partial products summed in
    fp32 and rounded once), the LM head's logits gathered. First, on the
    card alone, ``layers._RowProduct`` (bf16 operands, fp32 out) at a rank's
    FFN output shape against the fp32 product (1e-5 of its max) and its
    backward against ``F.linear``'s. Then phase 4's model (full depth and
    width, seed 0) in fp32 on 1 x 60 frames, its encoder states and first
    decode step's logits: rank 0 alone on the unsharded model, plain and
    with its ``o`` / ``wo`` sums split in two as tp splits them (a noise
    baseline, printed), then both ranks sharded with a synchronize around
    each collective (their milliseconds by size): the ranks' logits
    bit-equal, encoder states and logits cosine >= 0.999 against the plain
    run (24 random-weight layers amplify fp32 rounding: the beams are
    compared at depth 2, where they are equal). The depth-2 model at full width, dropout 0, in bf16 and in fp32:
    a 1 x 60 generate (8 new tokens; the ranks' beams equal) and one LoRA
    update against rank 0 alone on the unsharded model; fp32: beams equal, scores and loss within 1e-4,
    gradient cosine >= 0.9999, the update within phase 22's bars; bf16: loss
    within 1e-3 (relative), gradient cosine >= 0.97, the update within 1e-3
    of the largest tensor, and the same update with the partial LoRA
    gradients, or the row-parallel partial products, not summed over the
    group must each fall outside one of those bars; the
    ranks' tensors bit-equal. ``mr_blip_tpu_torch.train`` on
    ``configs/projects/train/qvh.yaml`` with ``run.tp=2`` and
    ``model.max_new_tokens=8`` over 1 train query (one update of one 1 x 60
    micro-batch) and 1 val query (no test split): the micro-batch phase
    17's launches on each rank, the generate phase 4's, trainable tensors
    and losses bit-equal across the ranks, the
    frozen shards as built, the merged rows each query once. (b) Phase
    20's model behind the server
    (batches of 4), then with a second replica on the same card
    (``set_mesh``) behind a server of batches of 8: 8 frame requests, then a
    ragged 3 (padded to 8; its first block is the one model's batch padded
    to 4); every row of the replicas equal to the one model's, each batch
    two blocks of 4 rows, 2 x 110 / 39 / 24 launches a batch; requests/s of
    both beside phase 20's.
27. pipeline parallelism (``parallel/pipeline.py``, ``models/t5_pipeline.py``),
    run in phase 26 (a)'s launch (``pp_worker_part``: no process start of
    its own): the two gloo ranks are two stages on the one card, each
    building only its 12 + 12 blocks of Flan-T5-XL at full width and depth
    (LoRA rank 8 on every Linear, bf16, every tensor drawn by its name in
    the whole model), 4 rows of 2,056 encoder tokens and 32 decoder tokens
    with ragged masks. (a) One LoRA AdamW update through
    ``t5_pipeline_forward`` at M = 2 and 4 against the whole model in one
    process (rank 0 alone): logits cosine >= 0.999, loss within 1e-2, the
    LoRA gradients' cosine >= 0.99, kernels 5, 6 and 8 12 x M launches a
    rank an update; a no-grad pipelined forward (kernel 3, 12 x M a rank)
    within the logits bar; two planted faults (rank 1's encoder blocks in
    reverse order; microbatch 1 zeroed) must each fall outside it. (b)
    Depth 2 in fp32: logits, loss and LoRA gradients within 1e-5 of the
    largest, the update's elements more than the lr apart <= 1e-3. Per
    rank: s per pipelined update, each send and receive's ms by microbatch
    and stack, weights and peak.
28. the LAVIS zoo's evaluation entry points: ``mr_blip_tpu_torch.evaluate``
    on ``configs/projects/zoo/caption_coco_eval.yaml`` (blip_caption
    base_coco: ViT-B/16 at 224², BERT-base, fp32, beam 3) and
    ``ret_coco_eval.yaml`` (with ``model.model_type=coco``: its published
    base_coco names no type of blip_retrieval, so both packages would build
    the tiny model) over 64 synthetic:// images x 5 captions, batches of 64,
    ``run.device: tpu`` read as the card: metrics finite, the first batch's
    captions and score_i2t rows equal to the wrapper's own call on its rows,
    no kernel launched (fp32 LayerNorm and attention under 256 tokens take
    the plain path, as in JAX); s per batch and the peak. Then the depth-2
    base-width BLIPv1 on the card against the CPU: caption loss, ITC
    features and ITM logits within 1e-4 of the largest, greedy caption ids
    equal. Then the CLIP and ALBEF families: (c) ``clip_ret_coco_eval.yaml``
    with ``model.model_size=ViT-B-16`` (its ``model_type`` names no size the
    wrapper reads) over the same images and captions, fp32: metrics finite,
    the similarity matrix equal to the wrapper's own call on the loader's
    batches (its call on the first batch alone printed beside: the host's
    product of another shape rounds otherwise), no kernel launched (197
    tokens, fp32, as in JAX). (d) The
    CLIP towers at ViT-L/14, full width and depth, on the same 64 images and
    320 captions: the ``CLIP`` module in bf16 (its default) launches kernel
    1 50 times and kernel 4 24 times (257 x 16 x 64) for the image batch and
    kernel 1 25 times per text batch of 64, its features within cosine
    0.999 (per row) of the same module on its kernels' plain versions on the
    card; the fp32 ``ClipModel`` wrapper's ``compute_sim_matrix`` launches
    kernel 4's fp32 body 24 times per batch that brings new images; at depth
    2 its matrix within 1e-5 of the largest against the CPU; RN50 at full
    width in fp32 on 8 images (TF32 off) within 1e-4 of the CPU. (e)
    ``nlvr_eval.yaml`` with ``model.model_size=base`` (ALBEF base: ViT-B/16,
    MED with fusion at layer 6, fp32) over 64 synthetic pairs: accuracy
    finite, the first batch's predictions equal to the wrapper's own call,
    no kernel launched; depth 2 (fusion at layer 1) within 1e-5 of the
    largest against the CPU.

Phase 3 holds kernels 3, 5, 6 and 8 at 4 x 2,056 with the 16 heads a
tensor-parallel rank runs (phase 26), at their 32-head bars, each timed
beside its plain version and its bound.

Phase 3 holds kernel 2 (the packed-QKV attention) at (240, 257) (timed),
(4, 264) with 257 valid keys and large pad values, (6, 194), (8, 300) and
(7, 50) on its resident path and (8, 330) and (8, 496), the 4 MiB gate's largest length,
on its streaming path, each line naming the path the shape took.

Phase 3 also holds kernel 4 (``flash_attention``) against its plain version:
(240, 677, H 16, D 88) bf16 through the strided q/k/v views of a packed QKV
tensor, max |diff| <= 0.02; (240, 257, 16, 88) fp32, max |diff| <= 1e-4 x max
|plain|; rectangular (4, 300, 32, 64) x 2,049 keys and (2, 1,037, 8, 64), each
with and without ``causal``, in both types; a call whose gradient is taken
(the recompute backward against the plain gradient, cosine >= 0.999); float16
and a head dim of 104 on the card must raise. It is timed at the 364-pixel
shape beside its plain version, ``scaled_dot_product_attention`` and kernel 2
on the same packed tensor, and at (240, 257) in bf16 beside kernel 2 again,
and at phase 28 (d)'s CLIP ViT-L/14 shape (64, 257, H 16, D 64) in bf16 and
fp32, each timed beside its plain version, ``scaled_dot_product_attention``
and its bound.
The other kernels of the 364-pixel paths are held at the shapes those paths
give them: LayerNorm at (162,480, 1,408) (240 x 677 ViT rows), the biased
flash forward at the answerer's encoder length (4 x 2,040, the last 5 keys
masked) and at phase 23's ``only_frames`` length (1 x 1,992), the W8A8 linear at the two shapes of the split int8 ViT route
((162,480, 1,408) x 4,224 with LN and bias, x 1,408 with the residual) and
the W8A8 GELU MLP at (162,480, 1,408, 6,144). The biased flash forward is also
held at phase 18's encoder lengths, batch 1: 2,088 (the localizer) and 2,024
(the answerer, its last 5 keys masked), and at phase 25's, 4 x 2,024 (the
last 7 keys masked). LayerNorm is also held at phase 19's
OPT shapes, width 2,560 through its generic 16-byte kernel: the prefill's
1,988 rows and a decode step's single row, each timed beside ``F.layer_norm``
and its bound, and, since an event pair around so short a call times the
host's launch, also as device time (``graph_ms``: 20 launches captured in a
CUDA graph and replayed).

The line before the last is one JSON object with every kernel's numbers
(launches: kernels 1-3 from phase 4 (phases 16 and 18 print their own
beside them), 4 from phase 13's 364-pixel run, 5, 6
and 8 from phase 6, 7 from phase 7's ``qformer_freeze`` run, 13-16 from phase
8, 9 from phase 10's bf16 run, 10 and 12 from phase 11, 11 from phase 12's
``qformer_freeze`` run; ``train_entry_launches`` from phase 17's first run,
``qa_entry_launches`` from phase 18's pipelined run (all its questions);
``opt_entry_launches`` from phase 19's evaluation (all its questions);
``serve_launches`` from phase 20's server batches, warmup and reference
generates; ``qlora_launches`` from phase 21's two runs (their micro-batches
and the resumed run's generates); ``dp_launches`` per micro-batch on one
rank in phase 22 (a); ``variant_launches`` from phase 23 (c)'s four
full-width batches; ``unfrozen_launches`` per micro-batch of phase 24 (a);
``vocab_launches`` from phase 25 (b)'s batch; ``tp_launches`` rank 0's over
phase 26 (a)'s train entry point (one micro-batch and a val generate);
``dp_serve_launches`` the replicas' over phase 26 (b)'s two batches (four
blocks); ``pp_launches`` rank 0's over phase 27 (a)'s M = 4 pipelined update
and its no-grad forward (M = 2);
``zoo_launches`` phase 28's (0 in its four evaluations; kernels 1 and 4 in
(d)'s ViT-L/14 towers, bf16 module and fp32 wrapper);
each count is taken with the counts set to 0 just before its path
runs); the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
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
# New tokens of the flagship's generates after phase 4, which decodes the
# published 50. Random weights never emit EOS, so every generate runs to its
# cap, and no gate depends on it: launch counts are the encoder's, rows are
# compared with generate on the same model. Cut from 50 when the whole
# script passed its 1,200 s on a slower host.
SHORT_NEW_TOKENS = 16
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
# Phase 13's int8 peak when kernel 14 kept its fp32 hidden in a workspace
# (M x H x 4 bytes; NVIDIA H100 80GB HBM3, 700 W), printed beside the peak
# of the run.
INT8_BIG_PEAK_FP32_HIDDEN_GIB = 10.61
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
# One video of 8 frames a run (2 videos before: the CPU's runs were most of
# the phase's time).
GRAD_FRAMES = 8
LOSS_REL_TOL = 1e-2
GRAD_COSINE_MIN = 0.99
# Phase 7 in the fp32 parity mode: kernels 5, 6, 8 (LoRA) and 5, 7, 8 (the
# table trains). Both sides compute in fp32 and differ only in the order of
# their sums (and ex2 against exp), ~1e-6 relative, so the bars are the
# parity mode's own: loss within 1e-4 relative, gradient cosine >= 0.9999.
FP32_GRAD_TASKS = ("qformer_freeze_lora", "qformer_freeze")
FP32_LOSS_REL_TOL = 1e-4
FP32_GRAD_COSINE_MIN = 0.9999
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
# Phase 12, (task, frames): the CPU plain path took 154 s at 1 x 240 frames,
# 72 s (later 47.7 s) at 1 x 120 and 20.9-30.5 s at 1 x 60 (bf16 on the card
# machine's 8 cores), the largest CPU share of the script, so both tasks run
# at GRAD_FRAMES (encoder length 344, still past the kernels' 256; 40 frames
# until phase 22 came, 24 until phase 26, 16 until phase 28). Phase 3 holds
# kernels 9-12 at the full 8,000 tokens.
LONG_GRAD_TASKS = (("qformer_freeze_lora", GRAD_FRAMES), ("qformer_freeze", GRAD_FRAMES))
# Phase 12 in the fp32 parity mode (kernels 9, 10, 12 and 9, 11, 12 in fp32)
# on a short clip, where the CPU's fp32 runs take about a second (at 1 x 60
# frames they took 8-14 s each).
LONG_FP32_GRAD_TASKS = (("qformer_freeze_lora", GRAD_FRAMES),
                        ("qformer_freeze", GRAD_FRAMES))
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
# Videos in the fp32 run: 1 (4 until phase 22 came, 2 until the script
# passed 1,200 s; the CPU's fp32 reference took 24.9 s at 4, 18.8 s at 2).
FP32_BATCH = 1
FP32_PATH_REL_TOL = 1e-4
# Phase 16, the evaluation entry point on configs/projects/eval/qvh.yaml: 8
# synthetic queries over 150 s videos at 10 fps (the length of QVHighlights
# clips), two batches of its batch size 4.
EVAL_QUERIES, EVAL_VIDEO_FRAMES, EVAL_FPS = 8, 1500, 10.0
# Phase 17, the train entry point on configs/projects/train/qvh.yaml (batches
# of 1 x 60 frames, accum_grad_iters 8, use_grad_checkpoint): 8 synthetic
# train queries (1 update an epoch), 1 val and 1 test, 1 epoch (2 until the
# script passed 1,200 s).
TRAIN_QUERIES, TRAIN_EVAL_QUERIES, TRAIN_EPOCHS, TRAIN_ACCUM = 8, 1, 1, 8
# Per micro-batch under use_grad_checkpoint: kernel 5 once per encoder layer
# in the forward and once more in the layer's recompute, kernels 6 and 8 once
# per encoder layer in the backward, kernels 3 and 7 never; the frozen ViT,
# ln_vision and Q-Former (no grad, never recomputed) as in phase 6.
EXPECTED_REMAT_TRAIN_LAUNCHES = dict(EXPECTED_TRAIN_LAUNCHES, flash_bias_fwd_stats=48)
# Checkpointing on against off, one micro-batch, the same dropout masks.
REMAT_LOSS_REL_TOL, REMAT_GRAD_COSINE_MIN, REMAT_GRAD_REL_TOL = 1e-6, 0.9999, 1e-3
# Phase 18, the grounded-QA entry point on configs/projects/eval/nextGQA.yaml
# (batch 1): QA_QUESTIONS synthetic questions over 40 s videos at 10 fps
# (NExT-QA's length). Per question the localizer's generate launches what a
# phase-4 batch launches, and the answerer the same again: its ViT, ln_vision
# and Q-Former over the 60 re-decoded frames, its T5 encoder's 24 layers.
# Three questions (six before phases 20 and 21 were added): one steady
# pipelined question between the first and the last.
QA_QUESTIONS, QA_VIDEO_FRAMES, QA_FPS = 3, 400, 10.0
# Its encoder lengths (the interleaved prompt of one 60-frame video; 60 x 32
# frame tokens and the question with its options, padded to a multiple of 8):
# phase 3 holds kernel 3 at both, and phase 18 must show them.
QA_ENTRY_LOCALIZER_LENGTH, QA_ENTRY_ANSWERER_LENGTH = 2088, 2024
EXPECTED_QA_ENTRY_LAUNCHES = dict(EXPECTED_LAUNCHES, layer_norm=220,
                                  qkv_packed_attention=78, flash_bias_attention=48)
QA_METRIC_KEYS = ("Acc@GQA", "mIoP", "TIoP@0.3", "TIoP@0.5", "mIoU", "TIoU@0.3",
                  "TIoU@0.5", "agg_metrics", "total")
# Phase 16's TAL batch, configs/projects/eval/anet_TAL.yaml (its model section
# is qvh.yaml's, so phase 16's model serves it): one batch of 4 synthetic
# videos of 120 s at 10 fps (ActivityNet's length).
TAL_QUERIES, TAL_VIDEO_FRAMES = 4, 1200
TAL_METRIC_KEYS = ("agg_metrics", "r1", "mAP", "mIoU", "invalid_predictions",
                   "class_label_mismatch", "total")
# Phase 19, configs/projects/eval/opt_charades.yaml (OPT-2.7b, greedy, batch
# 1): OPT_QUESTIONS synthetic queries over 30 s videos at 10 fps
# (Charades-STA's length). At the published 60 frames the prompt (122
# timestamp tokens, 1,920 frame tokens, the end token and 48 text tokens:
# 2,091 with the fallback tokenizer) passes OPT's 2,048 positions and the
# model must refuse it; the phase then takes the largest frame count whose
# prompt and 50 new tokens fit, found at run time: OPT_FRAMES (prompt 1,989,
# last position 2,037). The prefill writes the prompt but its last token:
# OPT_PREFILL_ROWS rows, where phase 3 holds kernel 1 at the OPT's width.
# 2 queries (4 until phases 27-28 came).
OPT_WIDTH, OPT_QUESTIONS, OPT_VIDEO_FRAMES, OPT_FPS = 2560, 2, 300, 10.0
OPT_FRAMES, OPT_PREFILL_ROWS = 57, 1988
# Per pass of the OPT decoder (the prefill, each decode step, the train
# forward): 2 LayerNorms a layer over 32 layers and the final norm.
OPT_LN_PER_PASS = 2 * 32 + 1
# Phase 20, online serving: (a) and (b) on a server whose ragged batches wait
# SERVE_FORM_WAIT_MS (so that (b)'s three requests form one batch); (c)
# SERVE_REQUESTS synthetic:// requests of 150 s from SERVE_CLIENTS client
# threads through the HTTP server, max_wait serve.py's default (16 requests
# until phases 27-28 came).
SERVE_FORM_WAIT_MS, SERVE_WAIT_MS = 5000, 50
SERVE_REQUESTS, SERVE_CLIENTS = 8, 8
SERVE_PROCESS_TIMEOUT_S = 300
# Phase 21, QLoRA-style training on configs/projects/train/qvh.yaml with
# model.int8_base and model.int8_vit: micro-batches of 1 x 60 frames,
# QLORA_ACCUM to an update (qvh.yaml's 8, and 10 queries, until phase 26
# came). Per micro-batch the T5 encoder's kernels as phase 17's (kernel 5 in
# the forward and the recompute, 6 and 8 in the backward); the ViT's blocks on the fused
# W8A8 attention block (16) and GELU MLP (14), their pre-norms inside them:
# LayerNorm 32 (ln_vision and the Q-Former), packed QKV never. Its val and
# test generates: phase 8's ViT and phase 4's T5 encoder. The first run is
# SIGTERMed after QLORA_PREEMPT_AFTER micro-batches (one update and one
# micro-batch into the second window, not a multiple of QLORA_ACCUM); a second run
# resumes it and re-runs the epoch.
QLORA_QUERIES, QLORA_PREEMPT_AFTER, QLORA_ACCUM = 4, 3, 2
INT8_VIT_LAUNCHES = dict(layer_norm=32, qkv_packed_attention=0, w8a8_mlp=39,
                         w8a8_attn_block=39)
EXPECTED_QLORA_LAUNCHES = dict(EXPECTED_REMAT_TRAIN_LAUNCHES, **INT8_VIT_LAUNCHES)
EXPECTED_QLORA_GENERATE_LAUNCHES = dict(EXPECTED_LAUNCHES, **INT8_VIT_LAUNCHES)
# Phase 22, two ranks on the one card over gloo. (a): qvh.yaml over
# DP_QUERIES train queries (8, accum 4, until phase 26 came) and
# DP_EVAL_QUERIES val and test queries (2 until phase 26; 1: rank 1's share
# is empty), one epoch, accum_grad_iters DP_ACCUM:
# each rank takes DP_ACCUM micro-batches, one update over every train row.
# (b): the flagship model at depth 2, one row per rank (dp) or one row on
# both (sp), against one process; the bars.
DP_RANKS, DP_QUERIES, DP_ACCUM, DP_EVAL_QUERIES = 2, 4, 2, 1
DP_LAUNCH_TIMEOUT_S, DP_GROUP_TIMEOUT_S = 420, 300
DP_LOSS_REL_TOL, DP_GRAD_COSINE_MIN, DP_TENSOR_REL_TOL = 1e-3, 0.999, 1e-3
# The share of trainable elements whose two updates land more than the lr
# apart (a flipped near-zero gradient; see _dp_rel).
DP_APART_MAX = 1e-3
DP_WINDOWS = ("[[10, 25]]", "[[10, 25], [30, 42], [100, 120]]")
# Phase 26, tensor parallelism and the dp server on the one card. (a): two
# gloo ranks, tp=2: Flan-T5-XL's 32 heads a layer run as 16 on each rank
# (phase 3 holds kernels 3, 5, 6 and 8 at TP_HEADS); phase 4's model at full
# depth in fp32 on TP_FULL_ROWS rows, its encoder states and first-step
# logits against one process's to TP_FULL_COSINE_MIN (on an H100 tp came to
# cosine 0.99995 of the logits: 24 random-weight layers amplify fp32
# rounding, so the beams differ; the same model in one process with its
# row-parallel sums split as tp splits them shows that noise beside it);
# the depth-2 model's generate and one LoRA update against one process in
# bf16 and fp32; qvh.yaml under run.tp=2 over TP_QUERIES train queries (one
# update of TP_QUERIES micro-batches) and one val query. Every tp generate
# stops at TP_NEW_TOKENS new tokens (phase 4 decodes 50; 16 until phases
# 27-28 came): a tp decode step runs 72 all-reduces through host memory,
# about 0.25 s. (b):
# phase 20's model and a second replica of it on the same card behind the
# server: DP_SERVE_REQUESTS requests, then a ragged 3.
TP_SIZE, TP_HEADS, TP_QUERIES = 2, 16, 1
TP_FULL_ROWS, TP_NEW_TOKENS, TP_FULL_COSINE_MIN = 1, 8, 0.999
TP_DEPTH2_DTYPES = ("bfloat16", "float32")
TP_FP32_COSINE_MIN = 0.9999
# bf16 at depth 2 rounds the half-width GEMMs and the summed partial
# products in another order than one process: on an H100 its loss came 6.7e-5
# (relative) and its gradients at cosine 0.980 from one process's. The bars
# sit just outside those readings; each planted fault must fall outside one.
TP_BF16_LOSS_REL, TP_BF16_COSINE_MIN = 1e-3, 0.97
# layers._RowProduct on the card: fp32 accumulation of bf16 operands against
# the fp32 product of the same operands (max |diff| / max |product|).
TP_ROW_PRODUCT_REL_TOL = 1e-5
DP_SERVE_REQUESTS, DP_SERVE_RAGGED = 8, 3
DP_SERVE_FORM_WAIT_MS = 1000  # the ragged 3 arrive within it: one batch
# Phase 27, pipeline parallelism (in phase 26 (a)'s launch: its two gloo
# ranks are the two stages). Flan-T5-XL at full width and depth with LoRA
# rank 8 on every Linear (the flagship's), bf16, each rank building only its
# 12 + 12 blocks; PP_ROWS rows of phase 4's encoder length (the last 7 keys
# of row 1 and the last 300 of row 3 masked), PP_TARGET decoder tokens (the
# last 8 of row 2 masked), every tensor drawn by its global name from one
# seed so that a stage and the whole model agree. (a) One LoRA AdamW update
# at each M of PP_MICROBATCHES against the whole model in one process (rank
# 0 alone), and a no-grad pipelined forward (kernel 3); bars stated before
# the first chip run: logits cosine >= PP_BF16_COSINE_MIN, loss within
# PP_BF16_LOSS_REL, the LoRA gradients' cosine >= PP_BF16_GRAD_COSINE_MIN;
# two planted faults (rank 1's encoder blocks in reverse order; microbatch 1
# zeroed) must each fall outside the logits bar. (b) Depth 2 at full width
# in fp32, M = 2: logits, loss and LoRA gradients within PP_FP32_REL of the
# largest (max |diff| / max |one process|), the update's share of elements
# more than the lr apart <= DP_APART_MAX.
PP_SIZE, PP_ROWS, PP_TARGET, PP_ENCODER_LENGTH = 2, 4, 32, 2056
PP_MICROBATCHES, PP_LORA_RANK, PP_SEED = (2, 4), 8, 27
PP_BF16_COSINE_MIN, PP_BF16_LOSS_REL, PP_BF16_GRAD_COSINE_MIN = 0.999, 1e-2, 0.99
PP_FP32_REL = 1e-5
# Phase 28, the BLIP-v1 zoo's evaluation entry points at base width
# (ViT-B/16 at 224², BERT-base MED, fp32 as the JAX wrappers run it):
# caption_coco_eval.yaml and ret_coco_eval.yaml as published over synthetic
# annotations of ZOO_IMAGES synthetic:// images x ZOO_CAPTIONS captions
# (string image ids), evaluated at the published batch of 64;
# ret_coco_eval.yaml's model_type base_coco names no type of blip_retrieval
# (coco, flickr), so both packages build the tiny model from it: the run
# adds model.model_type=coco (base width). Then the depth-2 base-width
# BLIPv1 on the card against the CPU (FP32_PATH_REL_TOL of the largest;
# greedy caption ids equal). No kernel runs on this path (fp32 LayerNorm,
# attention under 256 tokens), as in JAX.
ZOO_IMAGES, ZOO_CAPTIONS, ZOO_SEED = 64, 5, 28
ZOO_WORDS = ("a man woman dog cat red blue small large old young riding holding "
             "standing sitting near on in of the street field table water tree "
             "bike horse ball car train plate food sky grass beach snow window").split()
# Phase 28 (c)-(e), the CLIP and ALBEF families. (c) clip_ret_coco_eval.yaml
# with model.model_size=ViT-B-16 (its model_type names no size the wrapper
# reads: the tiny model otherwise) over phase 28's images and captions, fp32:
# ViT-B/16 has 197 tokens, under the 256 of the flash dispatch, and fp32
# LayerNorm is plain, so no kernel runs, as in JAX. (d) The towers at
# ViT-L/14 (257 tokens: kernel 4 at 16 heads of 64): the CLIP module in bf16
# (its default), the 64 images in one batch and the 320 captions in batches
# of 64; per image batch kernel 1 ln_pre + 2 x 24 blocks + the final norm
# and kernel 4 once a block, per text batch kernel 1 2 x 12 blocks +
# ln_final (the causal text attention has a mask: plain). Features held
# against the same module with its kernels' plain versions on the card
# (cosine >= CLIP_BF16_COSINE_MIN per row, a bar set before the first
# run). Then the fp32 wrapper (kernel 4's fp32 body, once a block for each
# batch's new images), the sim matrix at depth 2 against the CPU within
# CLIP_CPU_REL_TOL of the largest, and RN50 at full width in fp32 on
# CLIP_RN50_IMAGES images against the CPU (TF32 off) within
# FP32_PATH_REL_TOL. (e) nlvr_eval.yaml with model.model_size=base (ALBEF
# base: ViT-B/16, MED with fusion at layer 6, fp32) over ZOO_NLVR_PAIRS
# synthetic pairs; then depth 2 (fusion at layer 1) against the CPU within
# CLIP_CPU_REL_TOL.
CLIP_EVAL_SIZE, CLIP_L14, CLIP_L14_SHAPE = "ViT-B-16", "ViT-L-14", (ZOO_IMAGES, 257, 16, 64)
CLIP_TEXT_BATCH = 64
EXPECTED_CLIP_IMAGE_LAUNCHES = {"layer_norm": 50, "flash_attention": 24}
EXPECTED_CLIP_TEXT_LAUNCHES = {"layer_norm": 25, "flash_attention": 0}
CLIP_BF16_COSINE_MIN, CLIP_CPU_REL_TOL, CLIP_RN50_IMAGES = 0.999, 1e-5, 8
ZOO_NLVR_PAIRS = 64
# Phase 23, the reference-checkpoint import and the BLIP2_MR variants. The
# encoder length of an only_frames 1 x 60 batch of make_samples ("<vid>" 5
# tokens, 60 x 32 frame tokens, the end's 2 and the text's 64, padded to a
# multiple of 8): phase 3 holds kernel 3 at it, and phase 23 must show it.
ONLY_FRAMES_ENCODER_LENGTH = 1992
# Phase 25, the real vocabulary. The committed tokenizer directories (the
# JAX fixture, the Flan-T5-shaped one, OPT's BPE) and the prompt of phase
# 4's 4 x 60 batch under the Flan-T5-shaped one: 1,984 interleaved tokens
# (64 timestamp pieces, 60 x 32 frame tokens), the end's 1 and the text's 32
# (the mock's 64), padded to a multiple of 8; phase 3 holds kernel 3 there
# with the last 7 keys masked.
VOCAB_DIRS = ("fixture_t5", "flan_t5", "opt_bpe")
VOCAB_PROMPT_TOKENS, VOCAB_ENCODER_LENGTH = 2017, 2024
TOKENIZE_REPS = 20
# Frames of the depth-2 card-vs-CPU runs (only_frames 328 tokens, fast_gelu
# past 256: kernel 3 on the card; mean and blip2_fmr stay under 256).
VARIANT_CPU_FRAMES = 8
# Their beam search: 4 new tokens and no minimum, so that the CPU's runs stay
# short (a step of the full-width head and its beams is most of them).
VARIANT_CPU_NEW_TOKENS = 4
EXPECTED_NO_BIAS_LAUNCHES = dict(EXPECTED_LAUNCHES, flash_bias_attention=0)
# Per full-width 1 x 60 batch: the ViT, ln_vision and Q-Former as phase 4's;
# the biased flash kernel over the encoder's 24 layers where the sequence
# is 256 tokens or more (mean aggregation: 200; blip2_fmr's rows: ~85).
VARIANTS = {"only_frames": (dict(task="lora_only_frames"), EXPECTED_LAUNCHES),
            "mean": (dict(frame_token_aggregation="mean"), EXPECTED_NO_BIAS_LAUNCHES),
            "fast_gelu": (dict(fast_gelu=True), EXPECTED_LAUNCHES),
            "blip2_fmr": ({}, EXPECTED_NO_BIAS_LAUNCHES)}
# Phase 24, the unfrozen-ViT train path: configs/projects/train/qvh.yaml with
# model.freeze_vit=False (stochastic depth at the constructor's default rate),
# UNFROZEN_QUERIES train queries: one update of UNFROZEN_ACCUM micro-batches
# of 1 x 60 frames (8, qvh.yaml's accum_grad_iters, until phase 26 came, 4
# until phase 28);
# one val query, no test
# split. Per micro-batch every ViT block is checkpointed: LayerNorm norm1 and
# norm2 in the forward and again in the recompute (4 x 39), ln_vision and the
# Q-Former's 31 once (a graph, no recompute); packed QKV once a block in each;
# the T5 encoder's kernels as phase 17's. The val generate launches phase 4's.
UNFROZEN_QUERIES, UNFROZEN_ACCUM, UNFROZEN_DROP_PATH = 2, 2, 0.4
EXPECTED_UNFROZEN_LAUNCHES = dict(EXPECTED_REMAT_TRAIN_LAUNCHES, layer_norm=4 * 39 + 32,
                                  qkv_packed_attention=2 * 39)
# Phase 24 (b): depth 2 against the CPU at 224 pixels (kernel 2 under
# autograd) and at 364 (kernel 4 under autograd).
UNFROZEN_IMG_SIZES = (224, BIG_IMG)


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


def graph_ms(torch, fn, reps=20):
    """Device time of one ``fn()``: ``reps`` calls captured in one CUDA graph,
    the graph's replay timed by ``median_ms``, divided by ``reps``. For a
    call so short that the event pair around it measures the host's launch."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return median_ms(torch, graph.replay) / reps


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
    from mr_blip_tpu_torch.ops.layer_norm import _ln_plan, _ln_reference, fused_layer_norm

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
    # The OPT-2.7b decoder's norms (phase 19): the prefill's rows and a
    # decode step's single row at width 2,560, through the generic 16-byte
    # kernel (no register kernel has this width); each timed.
    for rows in (OPT_PREFILL_ROWS, 1):
        d, eps = OPT_WIDTH, 1e-5
        x = randn(rows, d, scale=2.0)
        w = randn(d, scale=0.1, dtype=torch.float32) + 1.0
        b = randn(d, scale=0.1, dtype=torch.float32)
        got = fused_layer_norm(x, w, b, eps)
        torch.cuda.synchronize()
        err = max_err(torch, got, _ln_reference(x.float(), w, b, eps))
        timed = {"ms": median_ms(torch, lambda: fused_layer_norm(x, w, b, eps)),
                 "plain_ms": median_ms(torch, lambda: _ln_reference(x, w, b, eps))}
        w16, b16 = w.to(x.dtype), b.to(x.dtype)
        timed["library_ms"] = median_ms(torch, lambda: F.layer_norm(x, (d,), w16, b16, eps))
        set_bound(timed, nbytes(x, got, w, b))
        plan = _ln_plan(d, x.data_ptr(), got.data_ptr(), w.data_ptr(), b.data_ptr())
        before = fused_layer_norm.launches
        timed["device_ms"] = graph_ms(torch, lambda: fused_layer_norm(x, w, b, eps))
        timed["library_device_ms"] = graph_ms(
            torch, lambda: F.layer_norm(x, (d,), w16, b16, eps))
        fused_layer_norm.launches = before
        say(f"layer_norm ({rows}, {d}) eps {eps:g} [OPT, {plan} kernel]: max|diff| "
            f"{err:.5f}" + timing_line(timed) + f"; device time (CUDA graph of 20 "
            f"launches) kernel {timed['device_ms']:.4f} ms, library "
            f"{timed['library_device_ms']:.4f} ms")
        require(plan == "vec8", f"layer_norm at width {d}: the {plan} kernel")
        require(err <= TOL, f"layer_norm ({rows}, {d}) off by {err}")
        ln["max_abs_err"] = max(ln["max_abs_err"], err)
        ln[f"opt_{'prefill' if rows > 1 else 'step'}"] = timed

    qk = kernels["qkv_packed_attention"]
    heads, hd = 16, 88
    # 257: the ViT at 224 pixels (resident K/V, a 1-key tail); 264 with 257
    # valid: the padded layout with large pad values; 194: an odd number of
    # query tiles an item; 300: resident with a full-width tail; 50 (one query
    # tile an item: the consumers take items in turns); 330: past the resident
    # path's 5 key tiles (streaming); 496: the 4 MiB gate's largest length
    # (streaming).
    for b, n, n_valid, flagship in ((240, 257, 0, True), (4, 264, 257, False),
                                    (6, 194, 0, False), (8, 300, 0, False),
                                    (7, 50, 0, False), (8, 330, 0, False),
                                    (8, 496, 0, False)):
        qkv = randn(b, n, 3 * heads * hd)
        if n_valid:
            # Large values in the pad rows: wrong masking shows at once.
            qkv[:, n_valid:] *= 7.0
        got = fa.flash_attention_qkv_packed(qkv, heads, n_valid=n_valid)
        torch.cuda.synchronize()
        want = fa._qkv_packed_reference(qkv.float(), heads, hd, n_valid)
        err = max_err(torch, got, want)
        line = (f"qkv_packed ({b}, {n}, {3 * heads * hd}) n_valid {n_valid} "
                f"[{fa.qkv_packed_path(n, n_valid)} path]: max|diff| {err:.5f}")
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
                                         # phase 18's localizer and answerer
                                         # encoders (batch 1; the answerer's
                                         # last keys are padding)
                                         (1, QA_ENTRY_LOCALIZER_LENGTH,
                                          QA_ENTRY_LOCALIZER_LENGTH, None, False),
                                         (1, QA_ENTRY_ANSWERER_LENGTH,
                                          QA_ENTRY_ANSWERER_LENGTH, "entry_pad", False),
                                         # phase 23's only_frames prompt
                                         (1, ONLY_FRAMES_ENCODER_LENGTH,
                                          ONLY_FRAMES_ENCODER_LENGTH, None, False),
                                         # phase 25's flagship under the
                                         # Flan-T5-shaped tokenizer
                                         (4, VOCAB_ENCODER_LENGTH, VOCAB_ENCODER_LENGTH,
                                          "vocab_pad", False),
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
        elif mask_kind == "entry_pad":
            kv_mask = (torch.arange(m, device=dev)[None].expand(b, m) < m - 5).to(torch.int8)
        elif mask_kind == "vocab_pad":
            kv_mask = (torch.arange(m, device=dev)[None].expand(b, m)
                       < VOCAB_PROMPT_TOKENS).to(torch.int8)
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
    """Kernels 3, 5 and 6-8 in fp32 (the parity mode, CUDA-core FMAs), kernel
    3 through the dispatch as the fp32 model reaches it: out, dq, dk, dv and
    dbias within FP32_REL_TOL x max |plain|, lse within LSE_TOL (the backward
    kernels get the plain forward's lse and δ, so each is held alone); a
    dtype no kernel takes must raise rather than run plain."""
    import torch.nn.functional as F

    from mr_blip_tpu_torch.ops import flash_attention as fa
    from mr_blip_tpu_torch.ops.attention import dot_product_attention

    gen = torch.Generator(device="cuda").manual_seed(5)
    dev = "cuda"

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    for b, n, mask_kind in ((4, 2056, None), (4, 2049, "tail"), (2, 300, "row1_all")):
        q, k, v = randn(b, n, heads, d), randn(b, n, heads, d), randn(b, n, heads, d)
        dout = randn(b, n, heads, d)
        bias = randn(1, heads, n, n)
        kv_mask = torch.ones(b, n, dtype=torch.int8, device=dev)
        if mask_kind == "tail":
            lengths = torch.tensor([n, n - 1, n - 100, 1500], device=dev)
            kv_mask = (torch.arange(n, device=dev)[None] < lengths[:, None]).to(torch.int8)
        elif mask_kind == "row1_all":
            kv_mask[1] = 0
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
        shape = f"({b}, {n}x{n}, {heads}, {d}) mask {mask_kind}"
        line = (f"flash_bias float32 {shape}: "
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
                f"fp32 kernels 3/5 {shape} off by {err3}, {err5} > {bar}")
        require(err_lse <= LSE_TOL, f"fp32 kernel 5 {shape}: lse off by {err_lse}")
        del got3, got5, lse5
        check_fp32_backward(torch, fa, (q, k, v, bias, kv_mask, dout), want, lse_want,
                            shape, timed=mask_kind is None)
        del q, k, v, dout, bias, want, lse_want
        torch.cuda.empty_cache()

    # A dtype no kernel takes raises rather than running plain.
    before = fa.flash_attention_bias.launches
    q16 = randn(2, 300, heads, d).to(torch.float16)
    bias16 = randn(1, heads, 300, 300).half()
    try:
        dot_product_attention(q16, q16, q16, bias=bias16)
    except TypeError as exc:
        say(f"float16 biased attention on the card raises: {exc}")
    else:
        raise RuntimeError("float16 biased attention on the card ran plain")
    require(fa.flash_attention_bias.launches == before,
            "float16 biased attention counted a launch")
    lse16 = torch.zeros(2, heads, 300, device=dev)
    before = fa.flash_bias_bwd_dq.launches
    try:
        fa.flash_bias_bwd_dq(q16, q16, q16, bias16, None, q16, lse16, lse16)
    except TypeError as exc:
        say(f"float16 flash_bias_bwd_dq on the card raises: {exc}")
    else:
        raise RuntimeError("float16 flash_bias_bwd_dq on the card ran")
    require(fa.flash_bias_bwd_dq.launches == before,
            "float16 flash_bias_bwd_dq counted a launch")


def check_fp32_backward(torch, fa, inputs, out_ref, lse_ref, shape, timed):
    """Kernels 6-8 in fp32 against the plain backward on the same inputs
    (lse and δ from the plain forward): each output within FP32_REL_TOL x
    max |plain|; at the main shape also timed beside the library's fp32
    autograd backward."""
    q, k, v, bias, kv_mask, dout = inputs
    delta = torch.einsum("bnhd,bnhd->bhn", dout, out_ref).contiguous()
    args = (q, k, v, bias, kv_mask, dout, lse_ref, delta)
    want = fa._flash_bias_bwd_reference(*args)
    counts = {w: w.launches for w in (fa.flash_bias_bwd_dq, fa.flash_bias_bwd_dq_dbias,
                                      fa.flash_bias_bwd_dkv)}
    dq6 = fa.flash_bias_bwd_dq(*args)
    dq7, dbias7 = fa.flash_bias_bwd_dq_dbias(*args)
    dk8, dv8 = fa.flash_bias_bwd_dkv(*args)
    torch.cuda.synchronize()
    require(all(w.launches == c + 1 for w, c in counts.items()),
            f"fp32 kernels 6-8 {shape}: not each launched once")
    errs = []
    for label, got, ref in (("6 dq", dq6, want[0]), ("7 dq", dq7, want[0]),
                            ("7 dbias", dbias7, want[3]), ("8 dk", dk8, want[1]),
                            ("8 dv", dv8, want[2])):
        require(got.dtype == torch.float32, f"fp32 kernel {label} returned {got.dtype}")
        err = max_err(torch, got, ref)
        scale = float(ref.abs().max())
        errs.append(f"{label} {err:.3e} (max|plain| {scale:.4f})")
        require(err <= FP32_REL_TOL * scale,
                f"fp32 kernel {label} {shape} off by {err} > {FP32_REL_TOL} x {scale}")
    line = f"flash_bias backward float32 {shape}: max|diff| " + ", ".join(errs)
    if timed:
        ms = {key: median_ms(torch, lambda fn=fn: fn(*args)) for key, fn in (
            ("6", fa.flash_bias_bwd_dq), ("7", fa.flash_bias_bwd_dq_dbias),
            ("8", fa.flash_bias_bwd_dkv))}
        qg, kg, vg = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        lib_out = torch.nn.functional.scaled_dot_product_attention(qg, kg, vg,
                                                                   attn_mask=bias)
        lib_ms = median_ms(torch, lambda: torch.autograd.grad(
            lib_out, (qg, kg, vg), dout.transpose(1, 2), retain_graph=True))
        b, n, heads, d = q.shape
        unit = 2.0 * b * heads * n * k.shape[1] * d  # flops of one N x M x D product
        line += ("; kernel 6 {:.4f} ms, 7 {:.4f} ms, 8 {:.4f} ms, library backward {:.4f} ms "
                 "(6 + 8 / library {:.2f}x), bound 6 {:.4f} ms, 8 {:.4f} ms (operations, "
                 "fp32 outside the tensor cores)").format(
                     ms["6"], ms["7"], ms["8"], lib_ms, (ms["6"] + ms["8"]) / lib_ms,
                     1e3 * 3 * unit / PEAK_FP32_FLOPS, 1e3 * 4 * unit / PEAK_FP32_FLOPS)
        del lib_out, qg, kg, vg
    say(line)
    del want, dq6, dq7, dbias7, dk8, dv8


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

    # The CLIP ViT-L/14 tower of phase 28 (d): 257 tokens, 16 heads of 64,
    # through the packed QKV views, bf16 from the module and fp32 from the
    # zoo wrapper; timed beside its plain version, the library call and its
    # bound (fp32: the operations over the CUDA-core peak).
    b, n, heads, hd = CLIP_L14_SHAPE
    for dtype in (torch.bfloat16, torch.float32):
        qkv = randn(b, n, 3 * heads * hd, dtype=dtype)
        q, k, v = qkv.view(b, n, 3, heads, hd).unbind(2)
        got = fa.flash_attention(q, k, v)
        label = f"({b}, {n}, {heads}, {hd}) CLIP ViT-L/14"
        err = hold(label, got, plain(q, k, v, False), dtype)
        if dtype == torch.bfloat16:
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
        flops = 4.0 * b * heads * n * n * hd
        fig = {"ms": median_ms(torch, lambda: fa.flash_attention(q, k, v)),
               "plain_ms": median_ms(torch, lambda: fa._flash_reference(q, k, v), iters=3,
                                     warmup=1)}
        q4, k4, v4 = (t.transpose(1, 2) for t in (q, k, v))
        fig["library_ms"] = median_ms(torch, lambda: F.scaled_dot_product_attention(q4, k4, v4))
        set_bound(fig, nbytes(qkv, got), bf16_flops=flops if dtype == torch.bfloat16 else 0.0)
        if dtype == torch.float32 and 1e3 * flops / PEAK_FP32_FLOPS > fig["bound_ms"]:
            fig["bound_ms"], fig["bound_by"] = 1e3 * flops / PEAK_FP32_FLOPS, "operations"
        say(f"flash_attention {label} {str(dtype)[6:]}:" + timing_line(fig)
            + f"  ({flops / fig['ms'] / 1e9:.1f} TFLOP/s)")
        del qkv, q, k, v, q4, k4, v4, got
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


def check_tp_kernels(torch, kernels):
    """Kernels 3, 5, 6 and 8 at 4 x 2,056 with the 16 heads a rank runs
    under tensor parallelism (Flan-T5-XL's 32 over tp=2, phase 26), against
    their plain versions at the bars of their 32-head shapes; each timed
    beside its plain version and its bound (printed, the ``kernels`` line
    keeps the 32-head numbers). Returns {kernel: (ms, plain ms, bound ms)}."""
    from mr_blip_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(26)
    dev = "cuda"

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    b, n, heads, d = BATCH, 2056, TP_HEADS, 64
    q, k, v, dout = (randn(b, n, heads, d) for _ in range(4))
    bias = randn(1, heads, n, n)
    kv_mask = torch.ones(b, n, dtype=torch.int8, device=dev)
    f32 = [t.float() for t in (q, k, v, bias)]
    out_ref, lse_ref = fa._flash_bias_fwd_stats_reference(*f32, kv_mask)
    delta = torch.einsum("bnhd,bnhd->bhn", dout.float(), out_ref).contiguous()
    bwd_args = (q, k, v, bias, kv_mask, dout, lse_ref, delta)
    dq_r, dk_r, dv_r, _ = fa._flash_bias_bwd_reference(*f32, kv_mask, dout.float(),
                                                       lse_ref, delta)
    out3 = fa.flash_attention_bias(q, k, v, bias, kv_mask)
    out5, lse5 = fa.flash_bias_fwd_stats(q, k, v, bias, kv_mask)
    dq6 = fa.flash_bias_bwd_dq(*bwd_args)
    dk8, dv8 = fa.flash_bias_bwd_dkv(*bwd_args)
    torch.cuda.synchronize()
    shape = f"({b}, {n}x{n}, {heads}, {d})"
    for key, name, got, want in (("flash_bias_attention", "out", out3, out_ref),
                                 ("flash_bias_fwd_stats", "out", out5, out_ref)):
        err = max_err(torch, got, want)
        say(f"{key} {shape} (a tp=2 rank's heads): {name} max|diff| {err:.5f}")
        require(err <= TOL, f"{key} {shape}: {name} off by {err}")
        kernels[key]["max_abs_err"] = max(kernels[key].get("max_abs_err", 0.0), err)
    err_lse = max_err(torch, lse5, lse_ref)
    say(f"flash_bias_fwd_stats {shape}: lse max|diff| {err_lse:.6f}")
    require(err_lse <= LSE_TOL, f"fwd_stats {shape}: lse off by {err_lse}")
    for key, name, got, want in (("flash_bias_bwd_dq", "dq", dq6, dq_r),
                                 ("flash_bias_bwd_dkv", "dk", dk8, dk_r),
                                 ("flash_bias_bwd_dkv", "dv", dv8, dv_r)):
        err, scale, cos = max_err(torch, got, want), float(want.abs().max()), \
            cosine(torch, got, want)
        say(f"{key} {shape} (a tp=2 rank's heads): {name} max|diff| {err:.5f} (max|plain| "
            f"{scale:.4f}), cosine {cos:.6f}")
        require(err <= GRAD_REL_TOL * scale and cos >= COSINE_MIN,
                f"{key} {shape}: {name} off by {err} (x {scale}), cosine {cos}")
        kernels[key]["max_abs_err"] = max(kernels[key].get("max_abs_err", 0.0), err)
    unit = float(b) * heads * n * n * d
    qkv_io = nbytes(q, k, v, bias)
    plain_bwd = lambda: fa._flash_bias_bwd_reference(  # noqa: E731
        q, k, v, bias, kv_mask, dout, lse_ref, delta)
    timed = {
        "flash_bias_attention": (lambda: fa.flash_attention_bias(q, k, v, bias, kv_mask),
                                 lambda: fa._flash_bias_fwd_stats_reference(
                                     q, k, v, bias, kv_mask),
                                 qkv_io + nbytes(out3), 4 * unit),
        "flash_bias_fwd_stats": (lambda: fa.flash_bias_fwd_stats(q, k, v, bias, kv_mask),
                                 lambda: fa._flash_bias_fwd_stats_reference(
                                     q, k, v, bias, kv_mask),
                                 qkv_io + nbytes(out5, lse5), 4 * unit),
        "flash_bias_bwd_dq": (lambda: fa.flash_bias_bwd_dq(*bwd_args), plain_bwd,
                              qkv_io + nbytes(dout, lse_ref, delta, dq6), 6 * unit),
        "flash_bias_bwd_dkv": (lambda: fa.flash_bias_bwd_dkv(*bwd_args), plain_bwd,
                               qkv_io + nbytes(dout, lse_ref, delta, dk8, dv8), 8 * unit),
    }
    times = {}
    for key, (kernel_fn, plain_fn, io, flops) in timed.items():
        entry = {}
        entry["ms"], entry["plain_ms"] = median_ms(torch, kernel_fn), median_ms(torch, plain_fn)
        entry["library_ms"] = None
        set_bound(entry, io, bf16_flops=flops)
        times[key] = (entry["ms"], entry["plain_ms"], entry["bound_ms"])
        say(f"{key} {shape} (a tp=2 rank's heads):" + timing_line(entry)
            + f"; {kernels[key].get('ms', float('nan')):.4f} ms at 32 heads")
    del q, k, v, dout, bias, f32, out_ref, lse_ref, delta, dq_r, dk_r, dv_r
    del out3, out5, lse5, dq6, dk8, dv8
    torch.cuda.empty_cache()
    return times


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
    # tiles only (every |key - query| < 256); at 40 the second consumer of
    # a backward kernel's one 128-row work item owns no row, and 100 ends
    # inside its second 64-row half.
    for b, n, mask_kind, role in ((1, LONG_ENCODER_LENGTH, None, "train"),
                                  (4, LONG_ENCODER_LENGTH, None, "generate"),
                                  (4, 4008, "tail", None),
                                  (4, 2049, "tail", "control"),
                                  (2, 1037, None, None),
                                  (2, 300, None, None),
                                  (2, 257, "tail", None),
                                  (2, 300, "row1_all", None),
                                  (2, 40, "tail", None),
                                  (2, 100, None, None)):
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
    q16 = torch.randn(2, 300, heads, d, generator=gen, device=dev).half()
    try:
        relpos_attention(q16, q16, q16, torch.randn(heads, nb, device=dev))
    except TypeError as exc:
        say(f"float16 rel-pos attention on the card raises: {exc}")
    else:
        raise RuntimeError("float16 rel-pos attention on the card ran plain")
    require(fa.flash_relpos_fwd_stats.launches == before,
            "float16 rel-pos attention counted a launch")
    del q16
    torch.cuda.empty_cache()
    check_fp32_relpos_kernels(torch, kernels)


def check_fp32_relpos_kernels(torch, kernels):
    """Kernels 9-12 in fp32 (the parity mode's CUDA-core bodies) against
    their plain versions in fp32 on the same inputs (the backward kernels get
    the plain forward's lse and δ): out, dq, dk, dv and dtable within
    FP32_REL_TOL x max |plain|, lse within LSE_TOL, dtable bit-equal between
    two launches; each kernel reached through its wrapper's fp32 C entry.
    Timed at 1 x 4,008 (120 frames) beside the library's fp32 calls over the
    materialized bias."""
    import torch.nn.functional as F

    from mr_blip_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(6)
    dev = "cuda"
    heads, d, nb, maxd = 32, 64, 32, 128
    wrappers = (fa.flash_relpos_fwd_stats, fa.flash_relpos_bwd_dq,
                fa.flash_relpos_bwd_dq_dtable, fa.flash_relpos_bwd_dkv)
    for b, n, mask_kind in ((2, 1037, None), (2, 257, "tail"), (2, 300, "row1_all"),
                            (1, 4008, None)):
        q, k, v, dout = (torch.randn(b, n, heads, d, generator=gen, device=dev)
                         for _ in range(4))
        table = torch.randn(heads, nb, generator=gen, device=dev)
        kv_mask = torch.ones(b, n, dtype=torch.int8, device=dev)
        if mask_kind == "tail":
            kv_mask[1, n - 30:] = 0
        elif mask_kind == "row1_all":
            kv_mask[1] = 0
        timed = n == 4008
        shape = f"({b}, {n}, {heads}, {d}) mask {mask_kind}"
        counts = [w.launches for w in wrappers]
        out, lse = fa.flash_relpos_fwd_stats(q, k, v, table, kv_mask, nb, maxd)
        torch.cuda.synchronize()
        if timed:
            # Timing only: the kernel's own lse and δ (the other shapes hold
            # the values).
            lse_r = lse
            delta = torch.einsum("bnhd,bnhd->bhn", dout, out).contiguous()
        else:
            out_r, lse_r = fa._flash_relpos_fwd_stats_reference(q, k, v, table, kv_mask,
                                                                nb, maxd)
            delta = torch.einsum("bnhd,bnhd->bhn", dout, out_r).contiguous()
        args = (q, k, v, table, kv_mask, dout, lse_r, delta, nb, maxd)
        dq10 = fa.flash_relpos_bwd_dq(*args)
        dq11, dtab11 = fa.flash_relpos_bwd_dq_dtable(*args)
        dtab_again = fa.flash_relpos_bwd_dq_dtable(*args)[1]
        dk12, dv12 = fa.flash_relpos_bwd_dkv(*args)
        torch.cuda.synchronize()
        rose = [w.launches - c for w, c in zip(wrappers, counts)]
        require(rose == [1, 1, 2, 1], f"fp32 kernels 9-12 {shape}: launches {rose}")
        require(all(t.dtype == torch.float32 for t in (out, dq10, dq11, dtab11, dk12, dv12)),
                f"fp32 kernels 9-12 {shape}: not all outputs fp32")
        require(torch.equal(dtab11, dtab_again),
                f"fp32 kernel 11 {shape}: dtable differs between two launches")
        if not timed:
            dq_r, dk_r, dv_r, dtab_r = fa._flash_relpos_bwd_reference(*args)
            errs = []
            for label, got, ref in (("9 out", out, out_r), ("10 dq", dq10, dq_r),
                                    ("11 dq", dq11, dq_r), ("11 dtable", dtab11, dtab_r),
                                    ("12 dk", dk12, dk_r), ("12 dv", dv12, dv_r)):
                err = max_err(torch, got, ref)
                scale = float(ref.abs().max())
                errs.append(f"{label} {err:.3e} (max|plain| {scale:.4f})")
                require(err <= FP32_REL_TOL * scale,
                        f"fp32 kernel {label} {shape} off by {err} > {FP32_REL_TOL} x {scale}")
            err_lse = max_err(torch, lse, lse_r)
            require(err_lse <= LSE_TOL, f"fp32 kernel 9 {shape}: lse off by {err_lse}")
            say(f"flash_relpos float32 {shape}: max|diff| " + ", ".join(errs)
                + f", lse {err_lse:.3e}; dtable bit-equal between two launches")
            del out_r, dq_r, dk_r, dv_r, dtab_r
        else:
            ms = {i: median_ms(torch, lambda fn=fn: fn(*args)) for i, fn in (
                (10, fa.flash_relpos_bwd_dq), (11, fa.flash_relpos_bwd_dq_dtable),
                (12, fa.flash_relpos_bwd_dkv))}
            ms[9] = median_ms(torch, lambda: fa.flash_relpos_fwd_stats(
                q, k, v, table, kv_mask, nb, maxd))
            bias = fa._relpos_bias(table, n, nb, maxd).contiguous()
            qg, kg, vg = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
            with torch.no_grad():
                lib_fwd = median_ms(torch, lambda: F.scaled_dot_product_attention(
                    qg, kg, vg, attn_mask=bias))
            lib_out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=bias)
            lib_bwd = median_ms(torch, lambda: torch.autograd.grad(
                lib_out, (qg, kg, vg), dout.transpose(1, 2), retain_graph=True))
            unit = 2.0 * b * heads * n * n * d  # flops of one N x N x D product
            say(f"flash_relpos float32 {shape}: kernel 9 {ms[9]:.4f} ms (library "
                f"{lib_fwd:.4f} ms, bound {1e3 * 2 * unit / PEAK_FP32_FLOPS:.4f} ms), "
                f"10 {ms[10]:.4f} ms, 11 {ms[11]:.4f} ms, 12 {ms[12]:.4f} ms (library "
                f"backward {lib_bwd:.4f} ms; bound 10 {1e3 * 3 * unit / PEAK_FP32_FLOPS:.4f}, "
                f"12 {1e3 * 4 * unit / PEAK_FP32_FLOPS:.4f} ms; operations, fp32 outside "
                f"the tensor cores)")
            del bias, qg, kg, vg, lib_out
        del q, k, v, dout, out, lse, lse_r, delta, dq10, dq11, dtab11, dk12, dv12
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
            (8224, 2048, 2048, None, False, True, False),
            # the tiny configs' widths: one ragged column tile, K past its end
            (4099, 32, 96, "ln", True, False, False),
            (300, 64, 64, None, False, True, False)):
        x = randn(m, k, scale=0.3)
        wq, sw = qw(k, n)
        bias = randn(n, scale=0.05, dtype=torch.float32) if has_bias else None
        res = randn(m, n, scale=0.3) if has_res else None
        nm = norm(kind, k)
        got = i8.w8a8_linear(x, wq, sw, bias, norm=nm, residual=res)
        want = i8._w8a8_linear_plain(x, wq, sw, bias, nm, res)
        label = (f"({m}, {k}) x ({k}, {n}) norm {kind} bias {has_bias} residual {has_res}, "
                 "column tiles {} x {}".format(*i8._linear_plan(n)))
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
    # The chunk widths no fc1 cluster covers take the chain route; D 576 and
    # H 1,152 with chunk 576 run chunks of 384 on the clusters.
    for m, d, h, block_h in ((4096, 128, 384, 128), (4096, 576, 1152, 576),
                             (4096, 32, 64, i8.DEFAULT_BLOCK_H)):
        w1, s1 = qw(d, h)
        w2, s2 = qw(h, d)
        b1 = randn(h, scale=0.01, dtype=torch.float32)
        b2 = randn(d, scale=0.01, dtype=torch.float32)
        nm = norm("ln", d)
        x, r = randn(m, d, scale=0.3), randn(m, d, scale=0.3)
        got = i8.w8a8_mlp(x, w1, s1, b1, w2, s2, b2, norm=nm, residual=r, block_h=block_h)
        want = i8._w8a8_mlp_plain(x, w1, s1, b1, w2, s2, b2, nm, r, block_h)
        chunk = i8._pick_block(h, block_h)
        hold(mlp, f"({m}, {d}, {h}) chunk {chunk}, {i8._mlp_route(h, chunk)} route", got,
             want)
        del x, r, got, want, w1, w2
    torch.cuda.empty_cache()

    # Kernel 15: the T5 encoder FFN, 8 hidden chunks of 640 (the tile route),
    # at the int8 generate batch's 8,224 rows (timed), a ragged count and the
    # long-context batch's 4 x 8,000 rows; then the chain route's chunk
    # widths (Flan-T5-base's H 2,048 in chunks of 512, the tiny T5's D 64
    # and H 256 in chunks of 128).
    gated = "w8a8_mlp_gated"
    xl = i8.DEFAULT_GATED_BLOCK_H
    for d, h, shapes in ((2048, 5120, ((8191, xl, None, False, False),
                                       (8224, xl, "rms", True, True),
                                       (32000, xl, "rms", True, False))),
                         (512, 2048, ((4096, xl, "rms", True, False),)),
                         (64, 256, ((4096, 128, "rms", True, False),))):
        w0, s0 = qw(d, h)
        w1, s1 = qw(d, h)
        wo, so = qw(h, d)
        for m, block_h, kind, has_res, flagship in shapes:
            x = randn(m, d, scale=0.3)
            r = x if has_res else None
            nm = norm(kind, d)
            got = i8.w8a8_mlp_gated(x, w0, s0, w1, s1, wo, so, norm=nm, residual=r,
                                    block_h=block_h)
            want = i8._w8a8_mlp_gated_plain(x, w0, s0, w1, s1, wo, so, nm, r, block_h)
            chunk = i8._pick_block(h, block_h)
            label = (f"({m}, {d}, {h}) norm {kind} residual {has_res}, chunk {chunk}, "
                     f"{i8._mlp_route(h, chunk, i8.GATED_TILE)} route")
            hold(gated, label, got, want)
            if flagship:
                timed(gated, label,
                      lambda: i8.w8a8_mlp_gated(x, w0, s0, w1, s1, wo, so, norm=nm,
                                                residual=r),
                      lambda: i8._w8a8_mlp_gated_plain(x, w0, s0, w1, s1, wo, so, nm, r,
                                                       block_h),
                      None, nbytes(x, r, w0, w1, wo, got), 6.0 * m * d * h)
            del x, r, got, want
            torch.cuda.empty_cache()
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
    # Past the resident K/V (5 key tiles): the first version's attention.
    x = randn(2, 400, c, scale=0.5)
    hold(blk, "(2, 400, 1408), 7 key tiles", block(x, 0), block_plain(x, 0))
    del x, got
    torch.cuda.empty_cache()


# --------------------------------------------------------------- phase 4
def flagship_model(device="cuda", **kw):
    from mr_blip_tpu_torch.models.blip2_mr import BLIP2_MR
    from mr_blip_tpu_torch.profile_inference import FLAGSHIP

    return BLIP2_MR(**dict(FLAGSHIP, **kw), device=device)


def reduced_vit_config(**kw):
    import dataclasses

    from mr_blip_tpu_torch.models.eva_vit import eva_vit_g_config

    return dataclasses.replace(eva_vit_g_config(**kw), depth=REDUCED_DEPTH)


def reduced_t5_config(**kw):
    import dataclasses

    from mr_blip_tpu_torch.models.t5 import t5_flan_xl_config

    return dataclasses.replace(t5_flan_xl_config(**kw), num_layers=REDUCED_DEPTH,
                               num_decoder_layers=REDUCED_DEPTH)


def reduced_model(device, init_params=True, task=None, relpos_in_kernel=False,
                  cls=None, **kw):
    """The flagship model (``cls``, default ``BLIP2_MR``) at full widths,
    every stack REDUCED_DEPTH deep; ``kw`` overrides entries of the flagship
    configuration. Without ``init_params`` every tensor is loaded right
    after, so the modules skip ``torch.nn.init`` (on the host that init took
    12 s of a model's build)."""
    import dataclasses

    from mr_blip_tpu_torch.models.blip2_mr import BLIP2_MR
    from mr_blip_tpu_torch.models.blip2_mr_module import Blip2MRModule
    from mr_blip_tpu_torch.profile_inference import FLAGSHIP

    class ReducedDepth(cls or BLIP2_MR):
        VIT_CONFIGS = {"eva_vit_g": reduced_vit_config}
        T5_CONFIGS = {"flan-t5-xl": reduced_t5_config}

        def __init__(self):
            super().__init__(**dict(FLAGSHIP, task=task or FLAGSHIP["task"], **kw),
                             init_params=False, device=device,
                             relpos_in_kernel=relpos_in_kernel)
            self.qformer_config = dataclasses.replace(self.qformer_config,
                                                      num_layers=REDUCED_DEPTH)
            self.module = Blip2MRModule(
                self.vit_config, self.qformer_config, self.t5_config,
                compute_dtype=self.compute_dtype, device=self.device,
                with_answerer=self.is_qa,
                frame_token_aggregation=self.frame_token_aggregation).eval()
            self.module.requires_grad_(False)
            if init_params:
                self.init_params(FLAGSHIP["seed"])

    if init_params:
        return ReducedDepth()
    with no_weight_init():
        return ReducedDepth()


def first_step(torch, model, samples):
    """{"enc0": the T5 encoder states, "logits0": the first decode step's
    fp32 logits} of ``samples`` on the host (the teacher-forced decoder on
    the start token)."""
    with torch.inference_mode():
        batch = model.prepare_mr_batch(samples, need_targets=False)
        tensors = model._to_device(batch)
        enc, attn = model.encode_t5(tensors, model.frames_to_t5(tensors),
                                    model._encoder_bias_for(batch))
        start = torch.full((enc.shape[0], 1), model.t5_config.decoder_start_token_id,
                           dtype=torch.long, device=enc.device)
        logits = model.module.t5.decode(start, enc, encoder_mask=attn)[:, 0]
        return {"enc0": enc.cpu(), "logits0": logits.float().cpu()}


def main_path(torch, wrappers, int8=False, long=False, relpos_in_kernel=None,
              img_size=224, new_tokens=None):
    """Phase 4 (bf16) or, with ``int8``, phase 8: the same model after
    ``quantize_for_inference()``. With ``long``, phase 10: LONG_BATCHES
    batches of 4 x LONG_FRAMES frames through the ``relpos_in_kernel`` model
    (``relpos_in_kernel=False`` for its materialized-bias comparison run).
    With ``img_size=364``, phase 13: BIG_BATCHES batches at 364 pixels, the
    ViT's attention through kernel 4 (with ``int8`` between two W8A8 linears).
    ``new_tokens`` caps the decode (default the flagship's 50). Returns the
    launch counts of the run and its summary numbers."""
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
    model = flagship_model(relpos_in_kernel=relpos, img_size=img_size,
                           **({"max_new_tokens": new_tokens} if new_tokens else {}))
    torch.cuda.synchronize()
    say(f"model built with random weights in {time.time() - t0:.1f} s; "
        f"{sum(p.numel() for p in model.module.parameters()) / 1e9:.3f} B params")
    weight_sums = weight_checksums(torch, model)
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
    # What is allocated now is the model and nothing an earlier phase left:
    # the peak below is this path's.
    resident = torch.cuda.memory_allocated()
    weights = sum(t.numel() * t.element_size()
                  for t in (*model.module.parameters(), *model.module.buffers()))
    require(resident - weights < 2**30, f"{name}: {resident / 2**30:.2f} GiB allocated "
            f"before the batches, {weights / 2**30:.2f} GiB of them the model's")
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

    # Stage split on one more batch, synchronizing between stages; each
    # stage's peak allocation above what is allocated when it starts.
    stage, stage_peak = {}, {}

    def start_stage():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        return torch.cuda.memory_allocated(), time.time()

    def end_stage(key, started):
        torch.cuda.synchronize()
        stage[key] = time.time() - started[1]
        stage_peak[key[:-2]] = (torch.cuda.max_memory_allocated() - started[0]) / 2**30

    with torch.inference_mode():
        batch = model.prepare_mr_batch(batches[1])
        tensors = model._to_device(batch)
        bias = model._encoder_bias_for(batch)
        started = start_stage()
        frames = model.frames_to_t5(tensors)
        end_stage("frames_to_qformer_s", started)
        started = start_stage()
        enc, attn = model.encode_t5(tensors, frames, bias)
        end_stage("t5_encode_s", started)
        steps = []  # decode steps, counted through the model's own step
        step = model.module.t5.decode_step
        model.module.t5.decode_step = lambda *a: steps.append(1) or step(*a)
        started = start_stage()
        model.decode(enc, attn)
        end_stage("decode_s", started)
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
        f"each); peak memory {peak / 2**30:.2f} GiB ({resident / 2**30:.2f} GiB allocated "
        "before the batches); stage peaks above their start "
        + ", ".join(f"{k} {v:.2f}" for k, v in stage_peak.items()) + " GiB")
    summary = dict(stage, steady_s=steady, first_s=seconds[0], peak_gib=peak / 2**30,
                   weight_checksums=weight_sums,
                   decode_steps=len(steps), encoder_length=enc.shape[1])
    del model, enc, frames
    torch.cuda.empty_cache()
    return launches, summary


def generates_side_by_side(label, a, b):
    """One line of two ``main_path`` summaries; their decodes side by side
    per step too (the two may cap the decode at different lengths)."""
    per_step = [1e3 * x["decode_s"] / x["decode_steps"] for x in (a, b)]
    return (f"{label}, seconds: " + ", ".join(
        f"{k} {a[k]:.3f} vs {b[k]:.3f}"
        for k in ("steady_s", "frames_to_qformer_s", "t5_encode_s", "decode_s"))
        + f" ({a['decode_steps']} vs {b['decode_steps']} decode steps, {per_step[0]:.1f} vs "
        f"{per_step[1]:.1f} ms each); peak memory {a['peak_gib']:.2f} vs "
        f"{b['peak_gib']:.2f} GiB")


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
        bits = t.detach().contiguous().view(-1).view(
            {1: torch.int8, 2: torch.int16}.get(t.element_size(), torch.int32)).long()
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

    model.loss_terms = timed("forward", model.loss_terms)
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
    # The timing wrappers close over the model's and the optimizer's bound
    # methods: reference cycles that kept the model's 7.5 GiB allocated until
    # the cyclic garbage collector happened to run (phase 13's peak read 20.53
    # GiB). Unwrap them, so that the model is freed here.
    del model.loss_terms, ctx.optimizer.step
    del model, ctx, batches, lora, frozen, named, snapshot
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------- phase 7
def bf16_friendly_state(torch, model):
    """``model``'s state with the rel-pos table at N(0, 1), as in phase 5,
    and the T5 query projections at HF T5's init scale (d_model *
    d_kv)^-1/2, drawn on the card from seed 1: at the random init's 0.02,
    T5's unscaled logits have std ~6, attention is near one-hot and bf16
    rounding flips near-ties (the plain path in bf16 against the plain path
    in fp32, both on the CPU, gave gradient cosines down to 0.85)."""
    cfg = model.t5_config
    state = model.state_dict()
    gen = torch.Generator(device="cuda").manual_seed(1)
    state[RELPOS_TABLE] = torch.randn(state[RELPOS_TABLE].shape, generator=gen, device="cuda")
    for name in state:
        if name.startswith("t5.") and name.endswith("attention.q.weight"):
            state[name] = (torch.randn(state[name].shape, generator=gen, device="cuda")
                           * (cfg.d_model * cfg.d_kv) ** -0.5)
    return state


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


def gradients_kernel_vs_plain(torch, wrappers, long=False, fp32=False):
    """Phase 7 or, with ``long``, phase 12: the ``relpos_in_kernel`` model at
    LONG_GRAD_TASKS' lengths, where the encoder's rows are compared too (kernel path
    against plain path, and against the card's own materialized-bias run).
    With ``fp32``, phase 7's parity-mode runs: ``compute_dtype="float32"``
    on both sides (kernels 5-8 in their fp32 instantiations), held to the
    FP32_* bars. Returns the launches of the kernel that emits the table's
    gradient."""
    from mr_blip_tpu_torch.profile_inference import make_samples
    from mr_blip_tpu_torch.text.span_grammar import moment_str_to_list

    family = "flash_relpos" if long else "flash_bias"
    fwd, dq, dkv = (f"{family}_{k}" for k in ("fwd_stats", "bwd_dq", "bwd_dkv"))
    dq_table = "flash_relpos_bwd_dq_dtable" if long else "flash_bias_bwd_dq_dbias"
    dtype_kw = {"compute_dtype": "float32"} if fp32 else {}
    loss_tol, cosine_min = ((FP32_LOSS_REL_TOL, FP32_GRAD_COSINE_MIN) if fp32
                            else (LOSS_REL_TOL, GRAD_COSINE_MIN))
    if long:
        tasks = LONG_FP32_GRAD_TASKS if fp32 else LONG_GRAD_TASKS
    else:
        tasks = [(t, GRAD_FRAMES) for t in (FP32_GRAD_TASKS if fp32 else GRAD_TASKS)]
    dbias_launches = 0
    for task, frames in tasks:
        samples = make_samples(1, frames, seed=7)
        size = f"1 x {frames}"
        gpu = reduced_model("cuda", task=task, relpos_in_kernel=long, **dtype_kw)
        gpu.load_state_dict(bf16_friendly_state(torch, gpu))
        batch = gpu.prepare_mr_batch(samples)
        for w in wrappers.values():
            w.launches = 0
        loss_gpu, g_gpu, enc_gpu = path_gradients(torch, gpu, batch, task)
        rose = {name: w.launches for name, w in wrappers.items()}
        require(not (long and gpu._enc_bias_cache), "an encoder bias was materialized")
        if long and fp32 and task == tasks[0][0]:
            # The fp32 parity mode generates through kernel 9 too.
            for w in wrappers.values():
                w.launches = 0
            out = gpu.generate(samples)
            gen_rose = {name: w.launches for name, w in wrappers.items() if w.launches}
            require(gen_rose.get(fwd) == REDUCED_DEPTH and len(out["prediction"]) == 1,
                    f"long context float32 generate: launches {gen_rose}")
            for pred in out["prediction"]:
                moment_str_to_list(pred)
            say(f"long context float32 generate (depth {REDUCED_DEPTH}, {size} frames): "
                f"predictions {out['prediction']}, launches {gen_rose}")
        state = {k: v.cpu() for k, v in gpu.state_dict().items()}
        del gpu
        torch.cuda.empty_cache()
        if long and not fp32 and task == tasks[0][0]:
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
        cpu = reduced_model("cpu", task=task, init_params=False, relpos_in_kernel=long,
                            **dtype_kw)
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
            f"{', relpos_in_kernel' if long else ''}{', float32' if fp32 else ''}): "
            f"loss {loss_gpu:.5f} vs plain {loss_cpu:.5f} (rel {rel:.2e}); "
            f"{len(cos)} trainable tensors compared ({len(g_gpu) - len(cos)} key "
            f"biases left out), cosine min {cos[worst]:.6f} ({worst}), "
            f"mean {statistics.mean(cos.values()):.6f}; launches "
            f"{ {k: v for k, v in rose.items() if v} }; CPU run {seconds:.1f} s")
        require(rel <= loss_tol, f"{task}: loss rel diff {rel}")
        require(cos[worst] >= cosine_min, f"{task}: {worst} cosine {cos[worst]}")
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
    state = bf16_friendly_state(torch, gpu)
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

    samples = make_samples(FP32_BATCH, FP32_FRAMES, seed=3)
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
    say(f"fp32 path (depth {REDUCED_DEPTH}, full width, {FP32_BATCH} x {FP32_FRAMES} frames at "
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
                           num_frames_for_answer=QA_ANSWER_FRAMES,
                           max_new_tokens=SHORT_NEW_TOKENS)
    torch.cuda.synchronize()
    say(f"QA model built with random weights in {time.time() - t0:.1f} s; "
        f"{sum(p.numel() for p in model.module.parameters()) / 1e9:.3f} B params, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    batches = [make_qa_samples(BATCH, N_FRAMES, 0, BIG_IMG)]
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
    # Frames a loader put on the card are cropped there, with no copy back.
    on_card = dict(samples, video=torch.from_numpy(samples["video"]).cuda())
    torch.cuda.synchronize()
    t0 = time.time()
    card_frames = model.extract_frames(on_card, moments, QA_ANSWER_FRAMES)
    torch.cuda.synchronize()
    card_crop_s = time.time() - t0
    t0 = time.time()
    host_frames = model.extract_frames(samples, moments, QA_ANSWER_FRAMES)
    host_crop_s = time.time() - t0
    require(card_frames.is_cuda and torch.equal(card_frames.cpu(), torch.from_numpy(host_frames)),
            "the crop of frames on the card differs from the host crop")
    say(f"QA crop of the batch's frames: on the card {card_crop_s:.4f} s "
        f"(a CUDA tensor out), on the host {host_crop_s:.4f} s, equal")
    del on_card, card_frames
    summary = dict(zip(("batch_s", "localizer_s", "crop_s", "answerer_s"), rows[0]),
                   peak_gib=peak / 2**30)
    say(f"QA path: B={BATCH} x {N_FRAMES} frames at {BIG_IMG}², {QA_ANSWER_FRAMES} frames "
        f"for the answerer; {summary['batch_s']:.3f} s/batch (one batch: localizer "
        f"{summary['localizer_s']:.3f}, frame crop {summary['crop_s']:.3f}, answerer "
        f"{summary['answerer_s']:.3f}); peak memory {summary['peak_gib']:.2f} GiB")
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

    # One video: the CPU's bf16 runs of the two stages took 68 s at 2 x 8.
    batch, frames = 1, 8
    samples = make_qa_samples(batch, frames, seed=7, img_size=BIG_IMG)
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
        say(f"{label} (depth {REDUCED_DEPTH}, full width, {batch} x {frames} frames at "
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
# -------------------------------------------------------------- phase 16
def evaluation_entry_point(torch, wrappers, card):
    """Phase 16: ``python -m mr_blip_tpu_torch.evaluate`` on
    ``configs/projects/eval/qvh.yaml`` (EVA ViT-g, Flan-T5-XL, bf16, 60
    frames, beam 5, batch 4, uint8 frames: the repo's YAML read by the port's
    own reader), called in this process on EVAL_QUERIES synthetic queries
    over 150 s videos, its model built by ``BLIP2_MR.from_config`` with random
    weights (no checkpoint is in the repo). Each ``generate_dispatch`` of the
    pipelined evaluation must launch what phase 4's batches launch, on frames
    the loader already put on the card; the result rows must equal, string
    for string, ``model.generate`` on the same loader batches and the same
    model; the metrics dict is printed. Returns the launch counts of the run
    and its summary numbers."""
    import tempfile

    from mr_blip_tpu_torch import evaluate
    from mr_blip_tpu_torch.datasets.synthetic import make_mr_annotations
    from mr_blip_tpu_torch.models.blip2_mr import BLIP2_MR
    from mr_blip_tpu_torch.tasks.moment_retrieval import MomentRetrievalTask

    calls = []  # per dispatch: (model, samples, launches, start, decode steps)
    collect_ends = []
    dispatch, collect = BLIP2_MR.generate_dispatch, BLIP2_MR.generate_collect

    def tapped_dispatch(model, samples):
        start = time.time()
        require(isinstance(samples["video"], torch.Tensor) and samples["video"].is_cuda,
                "evaluation: the loader did not put the frames on the card")
        before = {name: w.launches for name, w in wrappers.items()}
        steps = []  # decode steps, counted through the model's own step
        step = model.module.t5.decode_step
        model.module.t5.decode_step = lambda *a: steps.append(1) or step(*a)
        try:
            handle = dispatch(model, samples)
        finally:
            del model.module.t5.decode_step
        calls.append((model, samples, {name: w.launches - before[name]
                                       for name, w in wrappers.items()}, start, len(steps)))
        return handle

    def tapped_collect(model, handle):
        out = collect(model, handle)
        collect_ends.append(time.time())
        return out

    with tempfile.TemporaryDirectory() as tmp:
        paths = make_mr_annotations(tmp, n_train=0, n_val=0, n_test=EVAL_QUERIES,
                                    n_video_frames=EVAL_VIDEO_FRAMES, fps=EVAL_FPS)
        out_dir = Path(tmp) / "out"
        argv = ["--cfg-path", str(ROOT / "configs/projects/eval/qvh.yaml"), "--options",
                *(f"datasets.qvh.build_info.annotations.{split}.storage={path}"
                  for split, path in paths.items()),
                "datasets.qvh.build_info.videos.storage=synthetic",
                "model.load_finetuned=False", f"run.output_dir={out_dir}",
                f"model.max_new_tokens={SHORT_NEW_TOKENS}"]
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        resident = torch.cuda.memory_allocated()  # what earlier phases still hold
        torch.cuda.reset_peak_memory_stats()
        for w in wrappers.values():
            w.launches = 0
        BLIP2_MR.generate_dispatch, BLIP2_MR.generate_collect = tapped_dispatch, tapped_collect
        t0 = time.time()
        try:
            logs = evaluate.main(argv)
        finally:
            BLIP2_MR.generate_dispatch, BLIP2_MR.generate_collect = dispatch, collect
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = {name: w.launches for name, w in wrappers.items()}
        peak = torch.cuda.max_memory_allocated()
        (result_file,) = out_dir.glob("*/result/test_epochbest.json")
        rows = json.loads(result_file.read_text())

    n_batches = -(-EVAL_QUERIES // BATCH)
    require(len(calls) == n_batches and len(collect_ends) == n_batches,
            f"evaluation: {len(calls)} dispatches, {len(collect_ends)} collects, "
            f"expected {n_batches}")
    model = calls[0][0]
    require(all(c[0] is model for c in calls), "evaluation: more than one model")
    require(model.num_beams == 5 and model.compute_dtype == torch.bfloat16
            and model.vit_config.depth == 39 and model.t5_config.num_layers == 24
            and model.t5_config.d_model == 2048 and model.task == "qformer_freeze_lora",
            "evaluation: the model is not qvh.yaml's")
    # A batch's time runs from its dispatch to the next one's (the loop also
    # collects the batch before); the last one's to the end of its collect.
    starts = [c[3] for c in calls]
    seconds = [b - a for a, b in zip(starts, starts[1:] + [collect_ends[-1]])]
    for i, (_, samples, rose, _, steps) in enumerate(calls):
        frames = tuple(samples["video"].shape)
        say(f"evaluation batch {i}: {seconds[i]:.3f} s, {frames[0] * frames[1] / seconds[i]:.1f} "
            f"frames/s, {steps} decode steps, frames {frames} {samples['video'].dtype} on the "
            f"card  launches { {k: v for k, v in rose.items() if v} }")
        require(rose == EXPECTED_LAUNCHES, f"evaluation batch {i}: launches {rose}, "
                f"expected {EXPECTED_LAUNCHES}")
        require(frames == (BATCH, N_FRAMES, 224, 224, 3), f"evaluation frames {frames}")
    # The same batches through model.generate, outside the evaluation loop.
    want = []
    for _, samples, _, _, _ in calls:
        want += MomentRetrievalTask._rows_from_outputs(model.generate(samples))
    want = json.loads(json.dumps(want, default=float))
    require(rows == want, f"evaluation rows differ from model.generate: {rows} vs {want}")
    metrics = json.loads(json.dumps(logs["test"], default=float))
    require(set(metrics) == {"agg_metrics", "r1", "mAP", "mIoU", "invalid_predictions",
                             "total"} and metrics["total"] == EVAL_QUERIES,
            f"evaluation metrics {metrics}")
    require(len(rows) == EVAL_QUERIES and all(
        set(r) == {"qid", "raw_prediction", "prediction", "target", "duration"}
        and r["duration"] == EVAL_VIDEO_FRAMES / EVAL_FPS for r in rows),
        "evaluation rows malformed")
    say(f"evaluation rows (equal to model.generate on the same batches, string for "
        f"string): {[(r['qid'], r['prediction'], r['target']) for r in rows]}")
    say(f"evaluation metrics (random weights: every span [[-1, -1]], so no quality "
        f"number): {json.dumps(metrics)}")
    tal_entry_point(torch, wrappers, model, calls, tapped_dispatch)
    steady = statistics.mean(seconds[1:])
    say(f"evaluation entry point (configs/projects/eval/qvh.yaml, {EVAL_QUERIES} queries over "
        f"{EVAL_VIDEO_FRAMES / EVAL_FPS:.0f} s videos, B={BATCH} x {N_FRAMES} frames): "
        f"steady {steady:.3f} s/batch ({BATCH * N_FRAMES / steady:.1f} frames/s; batches "
        f"1-{n_batches - 1}), first {seconds[0]:.3f} s; before the first batch "
        f"{starts[0] - t0:.3f} s (config, datasets, from_config, first loader batch); "
        f"main() {wall:.3f} s; peak memory {(peak - resident) / 2**30:.2f} GiB above the "
        f"{resident / 2**30:.2f} GiB earlier phases held; {card}")
    del model, calls
    torch.cuda.empty_cache()
    return launches, dict(steady_s=steady, first_s=seconds[0], wall_s=wall,
                          peak_gib=(peak - resident) / 2**30, metrics=metrics)


def tal_entry_point(torch, wrappers, model, calls, tapped_dispatch):
    """Phase 16's TAL batch: ``mr_blip_tpu_torch.evaluate.main`` on
    ``configs/projects/eval/anet_TAL.yaml`` (task
    ``temporal_action_localization``, the ``anet_TAL`` builder) over one batch
    of TAL_QUERIES synthetic videos of 120 s. Its model section asks
    ``from_config`` for what qvh.yaml's does (checked on the constructor's
    arguments), so phase 16's ``model`` serves it; its classes file does not
    exist, so the task logs a warning and validates no label. The batch must
    launch phase 4's kernels, its rows equal a serial ``model.generate`` of
    the same loader batch, and its metrics carry the JAX package's keys."""
    import logging
    import tempfile

    from mr_blip_tpu_torch import evaluate
    from mr_blip_tpu_torch.common.config import Config
    from mr_blip_tpu_torch.datasets.synthetic import make_tal_annotations
    from mr_blip_tpu_torch.models.blip2_mr import BLIP2_MR
    from mr_blip_tpu_torch.tasks.temporal_action_localization import TALTask

    class Stop(Exception):
        pass

    def constructor_kwargs(path):
        seen = {}

        def probe_init(self, **kwargs):
            seen.update(kwargs)
            raise Stop

        try:
            type("Probe", (BLIP2_MR,), {"__init__": probe_init}).from_config(
                Config(cfg_path=str(ROOT / path)).model_cfg)
        except Stop:
            return seen

    tal_kw = constructor_kwargs("configs/projects/eval/anet_TAL.yaml")
    require(tal_kw == constructor_kwargs("configs/projects/eval/qvh.yaml"),
            f"TAL: anet_TAL.yaml asks for another model than qvh.yaml: {tal_kw}")
    messages = []

    class Messages(logging.Filter):  # survives setup_logger's basicConfig(force=True)
        def filter(self, record):
            messages.append(record.getMessage())
            return True

    dispatch = BLIP2_MR.generate_dispatch
    from_config = BLIP2_MR.__dict__["from_config"]
    calls.clear()
    log_filter = Messages()
    with tempfile.TemporaryDirectory() as tmp:
        paths = make_tal_annotations(tmp, n_train=0, n_val=0, n_test=TAL_QUERIES,
                                     n_video_frames=TAL_VIDEO_FRAMES, fps=EVAL_FPS)
        argv = ["--cfg-path", str(ROOT / "configs/projects/eval/anet_TAL.yaml"), "--options",
                *(f"datasets.anet_TAL.build_info.annotations.{split}.storage={path}"
                  for split, path in paths.items()),
                "datasets.anet_TAL.build_info.videos.storage=synthetic",
                f"run.output_dir={Path(tmp) / 'out'}"]
        BLIP2_MR.from_config = classmethod(lambda cls, cfg, device="cuda": model)
        BLIP2_MR.generate_dispatch = tapped_dispatch
        logging.getLogger().addFilter(log_filter)
        t0 = time.time()
        try:
            logs = evaluate.main(argv)
        finally:
            logging.getLogger().removeFilter(log_filter)
            BLIP2_MR.from_config, BLIP2_MR.generate_dispatch = from_config, dispatch
        wall = time.time() - t0
        (result_file,) = (Path(tmp) / "out").glob("*/result/test_epochbest.json")
        rows = json.loads(result_file.read_text())
    require(len(calls) == 1, f"TAL: {len(calls)} batches, expected 1")
    _, samples, rose, _, steps = calls[0]
    require(rose == EXPECTED_LAUNCHES, f"TAL batch: launches {rose}, expected "
            f"{EXPECTED_LAUNCHES}")
    require(tuple(samples["video"].shape) == (BATCH, N_FRAMES, 224, 224, 3)
            and samples["video"].is_cuda, f"TAL frames {tuple(samples['video'].shape)}")
    require(all(p == "" or p.startswith("Query: ") for p in samples["query_prompt"])
            and "" in samples["query_prompt"]
            and all("action class" in p for p in samples["task_prompt"]),
            "TAL: the batch does not carry the TAL prompts")
    want = json.loads(json.dumps(TALTask().valid_step(model, samples), default=float))
    require(rows == want, f"TAL rows differ from model.generate: {rows} vs {want}")
    metrics = json.loads(json.dumps(logs["test"], default=float))
    require(set(metrics) == set(TAL_METRIC_KEYS) and metrics["total"] == TAL_QUERIES,
            f"TAL metrics {metrics}")
    require(any("classes file" in m and "not found" in m for m in messages),
            "TAL: no warning for the missing classes file")
    say(f"TAL batch (configs/projects/eval/anet_TAL.yaml on phase 16's model, {TAL_QUERIES} "
        f"videos of {TAL_VIDEO_FRAMES / EVAL_FPS:.0f} s, 1 x {BATCH} x {N_FRAMES} frames): "
        f"{steps} decode steps, launches { {k: v for k, v in rose.items() if v} }; rows equal "
        f"to model.generate: {[(r['qid'], r['prediction'], r['target']) for r in rows]}; "
        f"classes file missing -> warning, no label validation; metrics (random weights) "
        f"{json.dumps(metrics)}; main() {wall:.3f} s")


# -------------------------------------------------------------- phase 17
def train_entry_point(torch, wrappers, card):
    """Phase 17: ``python -m mr_blip_tpu_torch.train`` on
    ``configs/projects/train/qvh.yaml`` (EVA ViT-g and Q-Former frozen,
    Flan-T5-XL with LoRA r=8, use_grad_checkpoint, micro-batches of 1 x 60
    frames, accum_grad_iters 8, linear_warmup_cosine_lr as published), called
    in this process over synthetic annotations: a run of TRAIN_EPOCHS epochs
    over TRAIN_QUERIES train queries (every micro-batch's and every val/test
    generate's launches as predicted, every loss finite, every trainable
    tensor moved and every frozen one bit-equal after it); then one
    micro-batch of its model with
    checkpointing on and off on the same dropout masks. (The preempted run
    and its resume run in phase 21, on the QLoRA model.) Returns the run's
    launch counts and its summary numbers."""
    import tempfile

    from mr_blip_tpu_torch import train
    from mr_blip_tpu_torch.datasets.synthetic import make_mr_annotations
    from mr_blip_tpu_torch.models.blip2_mr import BLIP2_MR
    from mr_blip_tpu_torch.models.layers import set_dropout_generator
    from mr_blip_tpu_torch.profile_inference import make_samples
    from mr_blip_tpu_torch.runners.train_state import TrainCtx

    phase_start = time.time()
    models, steps, generates = [], [], []
    built = {}

    def counts():
        return {name: w.launches for name, w in wrappers.items()}

    def rose(before):
        return {name: w.launches - before[name] for name, w in wrappers.items()}

    from_config = BLIP2_MR.from_config.__func__
    step, dispatch = TrainCtx.step, BLIP2_MR.generate_dispatch

    def tapped_from_config(cls, cfg, device="cuda"):
        model = from_config(cls, cfg, device=device)
        models.append(model)
        mask = model.trainable_mask()
        built["trainable"], frozen = {}, []
        for n, p in model.module.named_parameters():
            if mask[n]:
                built["trainable"][n] = p.detach().float().clone()
            else:
                frozen.append(p)
        built["frozen"] = checksums(torch, frozen)
        return model

    def tapped_step(ctx, batch):
        before = counts()
        torch.cuda.synchronize()
        start = time.time()
        loss = step(ctx, batch)
        torch.cuda.synchronize()
        steps.append((rose(before), time.time() - start, loss, ctx.updates))
        return loss

    def tapped_dispatch(model, samples):
        require(isinstance(samples["video"], torch.Tensor) and samples["video"].is_cuda,
                "train entry point: an evaluation batch's frames are not on the card")
        before = counts()
        handle = dispatch(model, samples)
        generates.append(rose(before))
        return handle

    taps = ((BLIP2_MR, "from_config", classmethod(tapped_from_config)),
            (TrainCtx, "step", tapped_step),
            (BLIP2_MR, "generate_dispatch", tapped_dispatch))
    originals = [(cls, name, cls.__dict__[name]) for cls, name, _ in taps]
    with tempfile.TemporaryDirectory() as tmp:
        run_paths = make_mr_annotations(
            f"{tmp}/run", n_train=TRAIN_QUERIES, n_val=TRAIN_EVAL_QUERIES,
            n_test=TRAIN_EVAL_QUERIES, n_video_frames=EVAL_VIDEO_FRAMES, fps=EVAL_FPS)
        argv = ["--cfg-path", str(ROOT / "configs/projects/train/qvh.yaml"), "--options",
                *(f"datasets.qvh.build_info.annotations.{split}.storage={path}"
                  for split, path in run_paths.items()),
                "datasets.qvh.build_info.videos.storage=synthetic",
                f"run.output_dir={Path(tmp) / 'train'}", f"run.max_epoch={TRAIN_EPOCHS}",
                f"model.max_new_tokens={SHORT_NEW_TOKENS}"]
        for cls, name, tap in taps:
            setattr(cls, name, tap)
        try:
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            resident = torch.cuda.memory_allocated()  # what earlier phases still hold
            torch.cuda.reset_peak_memory_stats()
            for w in wrappers.values():
                w.launches = 0
            t0 = time.time()
            logs = train.main(argv)
            torch.cuda.synchronize()
            wall = time.time() - t0
            launches = counts()
            peak = torch.cuda.max_memory_allocated()
        finally:
            for cls, name, original in originals:
                setattr(cls, name, original)
    (model,) = models
    remat = remat_on_off(torch, model, built, set_dropout_generator, make_samples)
    del model
    models.clear()
    gc.collect()
    torch.cuda.empty_cache()

    # The run: launches per micro-batch and per generate, losses, weights.
    n_steps = TRAIN_EPOCHS * TRAIN_QUERIES
    require(len(steps) == n_steps, f"train entry point: {len(steps)} micro-batches, "
            f"expected {n_steps}")
    for i, (r, _, loss, _) in enumerate(steps):
        require(r == EXPECTED_REMAT_TRAIN_LAUNCHES, f"train entry point micro-batch {i}: "
                f"launches {r}, expected {EXPECTED_REMAT_TRAIN_LAUNCHES}")
        require(math.isfinite(loss), f"train entry point micro-batch {i}: loss {loss}")
    require(steps[-1][3] == n_steps // TRAIN_ACCUM, f"train entry point: {steps[-1][3]} updates")
    n_generates = (TRAIN_EPOCHS + 1) * TRAIN_EVAL_QUERIES  # val each epoch, then test
    require(len(generates) == n_generates, f"train entry point: {len(generates)} "
            f"generate batches, expected {n_generates}")
    for i, r in enumerate(generates):
        require(r == EXPECTED_LAUNCHES, f"train entry point generate {i}: launches {r}, "
                f"expected {EXPECTED_LAUNCHES}")
    metrics = json.loads(json.dumps(logs["test"], default=float))
    require(metrics["total"] == TRAIN_EVAL_QUERIES, f"train entry point metrics {metrics}")

    seconds = [r[1] for r in steps]
    windows = [sum(seconds[i:i + TRAIN_ACCUM]) for i in range(0, n_steps, TRAIN_ACCUM)]
    update_s = statistics.mean(windows[1:] or windows)
    steady = statistics.median(seconds[1:])
    say(f"train entry point (configs/projects/train/qvh.yaml, {TRAIN_QUERIES} queries x "
        f"{TRAIN_EPOCHS} epochs, B=1 x {N_FRAMES} frames, accum_grad_iters {TRAIN_ACCUM}, "
        f"use_grad_checkpoint): every micro-batch launched "
        f"{ {k: v for k, v in EXPECTED_REMAT_TRAIN_LAUNCHES.items() if v} } and every val/test "
        f"generate { {k: v for k, v in EXPECTED_LAUNCHES.items() if v} }; "
        f"losses {[round(r[2], 4) for r in steps]}; every trainable tensor moved, every "
        f"frozen one bit-equal; test metrics (random weights) {json.dumps(metrics)}")
    say(f"train entry point seconds: micro-batch steady {steady:.3f} (median of 1-{n_steps - 1}; "
        f"mean {statistics.mean(seconds[1:]):.3f}, first {seconds[0]:.3f}); update "
        f"{update_s:.3f} (the mean of the windows of {TRAIN_ACCUM} micro-batches after the "
        f"first, or the first alone: {[round(w, 3) for w in windows]}); main() {wall:.3f}; "
        f"peak memory "
        f"{(peak - resident) / 2**30:.2f} GiB above the {resident / 2**30:.2f} GiB earlier phases "
        f"held; {card}")
    say(f"train entry point checkpointing: one 1 x {N_FRAMES} micro-batch, dropout on, the same "
        f"masks: loss on {remat['loss'][True]:.7f} off {remat['loss'][False]:.7f} (rel diff "
        f"{remat['loss_rel']:.2e}); LoRA gradients cosine min {remat['cos']:.7f}, max |diff| / "
        f"max |g| {remat['rel']:.2e}; peak memory on {remat['peak'][True]:.2f} GiB, off "
        f"{remat['peak'][False]:.2f} GiB; seconds on {remat['s'][True]:.3f}, off "
        f"{remat['s'][False]:.3f}; phase {time.time() - phase_start:.1f} s; {card}")
    return launches, dict(steady_s=steady, update_s=update_s,
                          peak_gib=(peak - resident) / 2**30)


def remat_on_off(torch, model, built, set_dropout_generator, make_samples):
    """One micro-batch of the trained model with ``use_grad_checkpoint`` on
    and off (the T5 stacks' ``use_remat``), in train mode on the same
    generator seed: the loss within REMAT_LOSS_REL_TOL relative, every LoRA
    gradient within the cosine and max-|diff| bars. Also checks, before it,
    that the train-entry run moved every trainable tensor and left every
    frozen one bit-equal (``built``: the model as built)."""
    named = dict(model.module.named_parameters())
    trainable = {n: p for n, p in named.items() if p.requires_grad}
    require(trainable.keys() == built["trainable"].keys(), "the trainable set changed")
    same = [n for n, p in trainable.items() if torch.equal(p.detach(), built["trainable"][n])]
    require(not same, f"train entry point: {len(same)} trainable tensors never moved, "
            f"e.g. {same[:3]}")
    frozen = [p for n, p in named.items() if n not in trainable]
    require(checksums(torch, frozen) == built["frozen"], "train entry point: a frozen "
            "tensor changed")
    require(model.t5_config.use_remat and model.module.t5.encoder.use_remat,
            "qvh.yaml's model does not checkpoint its T5 blocks")
    batch = model.prepare_mr_batch(make_samples(1, N_FRAMES, seed=17))
    t5 = model.module.t5
    gen = torch.Generator(device=model.device)
    set_dropout_generator(model.module, gen)
    model.train()
    out = {"loss": {}, "grads": {}, "peak": {}, "s": {}}
    for remat in (True, False):
        t5.encoder.use_remat = t5.decoder.use_remat = remat
        for p in trainable.values():
            p.grad = None
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        gen.manual_seed(1234)
        start = time.time()
        loss = model.loss(batch)
        loss.backward()
        torch.cuda.synchronize()
        out["s"][remat] = time.time() - start
        out["peak"][remat] = (torch.cuda.max_memory_allocated() - base) / 2**30
        out["loss"][remat] = float(loss.detach())
        out["grads"][remat] = {n: p.grad.detach().float().clone() for n, p in trainable.items()}
    t5.encoder.use_remat = t5.decoder.use_remat = True
    for p in trainable.values():
        p.grad = None
    on, off = out["loss"][True], out["loss"][False]
    out["loss_rel"] = abs(on - off) / abs(off)
    cos, rel = [], []
    for n, g in out["grads"][False].items():
        got = out["grads"][True][n]
        require(bool(torch.isfinite(got).all()) and float(g.abs().max()) > 0,
                f"checkpointing: gradient of {n} not finite or zero")
        cos.append(cosine(torch, got, g))
        rel.append(float((got - g).abs().max()) / float(g.abs().max()))
    out["cos"], out["rel"] = min(cos), max(rel)
    require(math.isfinite(on) and out["loss_rel"] <= REMAT_LOSS_REL_TOL,
            f"checkpointing on/off: loss {on} vs {off}")
    require(out["cos"] >= REMAT_GRAD_COSINE_MIN and out["rel"] <= REMAT_GRAD_REL_TOL,
            f"checkpointing on/off: LoRA gradient cosine {out['cos']}, max |diff| / max |g| "
            f"{out['rel']}")
    del out["grads"]
    return out


# -------------------------------------------------------------- phase 18
def qa_entry_point(torch, wrappers, card):
    """Phase 18: ``python -m mr_blip_tpu_torch.evaluate`` on
    ``configs/projects/eval/nextGQA.yaml`` as published (the grounded-QA
    model at full width and depth, ``resample_frames: True``, batch 1, 8
    loader threads), called in this process on QA_QUESTIONS synthetic
    questions over 40 s ``synthetic://`` videos, its model built by
    ``BLIP2_MR.from_config`` with random weights. Each question's localizer
    and answerer must launch EXPECTED_QA_ENTRY_LAUNCHES together; the rows
    must equal a serial ``videoQA_generate`` of the same loader batches on the
    same model, field for field; every moment must be the whole video (random
    weights: every span ``[[-1, -1]]``) and the answerer's frames the reader's
    own decode of that window. Returns the launch counts of the run and its
    summary numbers."""
    import tempfile

    import numpy as np

    from mr_blip_tpu_torch import evaluate
    from mr_blip_tpu_torch.datasets.sampling import sample_frame_indices
    from mr_blip_tpu_torch.datasets.synthetic import make_qa_annotations
    from mr_blip_tpu_torch.datasets.video_reader import VideoReader
    from mr_blip_tpu_torch.models.blip2_mr import BLIP2_MR
    from mr_blip_tpu_torch.tasks.vqa import VideoGQA

    questions = []  # per dispatch: [model, samples, localizer launches, start]
    answers = []  # per collect: (answerer's frames, answerer launches, end)
    dispatch, collect = BLIP2_MR.videoQA_dispatch, BLIP2_MR.videoQA_collect

    def counts():
        return {name: w.launches for name, w in wrappers.items()}

    def rose(before):
        return {name: w.launches - before[name] for name, w in wrappers.items()}

    def tapped_dispatch(model, samples):
        start = time.time()
        require(isinstance(samples["video"], torch.Tensor) and samples["video"].is_cuda,
                "QA evaluation: the loader did not put the frames on the card")
        before = counts()
        handle = dispatch(model, samples)
        questions.append((model, samples, rose(before), start))
        return handle

    def tapped_collect(model, handle):
        before = counts()
        out = collect(model, handle)
        answers.append((handle["frames"], rose(before), time.time()))
        return out

    with tempfile.TemporaryDirectory() as tmp:
        paths = make_qa_annotations(tmp, n_train=1, n_val=1, n_test=QA_QUESTIONS,
                                    n_video_frames=QA_VIDEO_FRAMES, fps=QA_FPS)
        out_dir = Path(tmp) / "out"
        argv = ["--cfg-path", str(ROOT / "configs/projects/eval/nextGQA.yaml"), "--options",
                *(f"datasets.nextgqa.build_info.annotations.{split}.storage={path}"
                  for split, path in paths.items()),
                "datasets.nextgqa.build_info.videos.storage=synthetic",
                "model.load_finetuned=False", f"run.output_dir={out_dir}",
                f"model.max_new_tokens={SHORT_NEW_TOKENS}"]
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        resident = torch.cuda.memory_allocated()  # what earlier phases still hold
        torch.cuda.reset_peak_memory_stats()
        for w in wrappers.values():
            w.launches = 0
        BLIP2_MR.videoQA_dispatch, BLIP2_MR.videoQA_collect = tapped_dispatch, tapped_collect
        t0 = time.time()
        try:
            logs = evaluate.main(argv)
        finally:
            BLIP2_MR.videoQA_dispatch, BLIP2_MR.videoQA_collect = dispatch, collect
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = counts()
        peak = torch.cuda.max_memory_allocated()
        (result_file,) = out_dir.glob("*/result/test_epochbest.json")
        rows = json.loads(result_file.read_text())

    require(len(questions) == len(answers) == QA_QUESTIONS,
            f"QA evaluation: {len(questions)} dispatches, {len(answers)} collects, "
            f"expected {QA_QUESTIONS} (batch 1)")
    model = questions[0][0]
    require(all(q[0] is model for q in questions), "QA evaluation: more than one model")
    require(model.task == "qformer_freeze_lora_QA_with_localizer" and model.resample_frames
            and model.num_frames_for_answer == 60 and model.num_beams == 5
            and model.compute_dtype == torch.bfloat16 and model.img_size == 224
            and model.vit_config.depth == 39 and model.t5_config.num_layers == 24
            and model.t5_config.d_model == 2048, "QA evaluation: the model is not nextGQA.yaml's")
    # A question's time runs from its dispatch to the next one's: its
    # localizer and the answerer of the question before. The last one's runs
    # to its answer, so it holds two answerers and stays out of the steady
    # mean.
    starts = [q[3] for q in questions]
    seconds = [b - a for a, b in zip(starts, starts[1:] + [answers[-1][2]])]
    per_question = []
    for i, ((_, samples, loc, _), (frames, ans, _)) in enumerate(zip(questions, answers)):
        both = {k: loc[k] + ans[k] for k in loc}
        per_question.append(both)
        duration = float(samples["duration"][0])
        say(f"QA question {i}: {seconds[i]:.3f} s  launches localizer "
            f"{ {k: v for k, v in loc.items() if v} } + answerer "
            f"{ {k: v for k, v in ans.items() if v} }")
        require(both == EXPECTED_QA_ENTRY_LAUNCHES, f"QA question {i}: launches {both}, "
                f"predicted {EXPECTED_QA_ENTRY_LAUNCHES}")
        require(tuple(samples["video"].shape) == (1, N_FRAMES, 224, 224, 3),
                f"QA question {i}: frames {tuple(samples['video'].shape)}")
        # The answerer's frames: the reader's own decode of the 60 uniform
        # picks inside [0, round(duration)], the window of a [[-1, -1]] span.
        vr = VideoReader(samples["video_path"][0], width=224, height=224)
        idx = sample_frame_indices(vlen=len(vr), fps=vr.get_avg_fps(), n_frms=60,
                                   sampling="uniform", clip_proposal=[0, round(duration)])
        want = vr.get_batch(idx)
        vr.close()
        require(frames.shape == (1, 60, 224, 224, 3) and frames.dtype == np.uint8
                and np.array_equal(frames[0], want),
                f"QA question {i}: the answerer's frames are not the window's re-decode")
    # The same loader batches through a serial videoQA_generate, its stages
    # synchronized and timed: localizer, re-decode, answerer.
    task, serial, stages, lengths = VideoGQA(), [], [], {"localizer": [], "answerer": []}
    hooks = [getattr(model.module, name).encoder.register_forward_hook(
        lambda mod, args, out, key=key: lengths[key].append(out.shape[1]))
        for name, key in (("t5", "localizer"), ("answerer_t5", "answerer"))]
    for _, samples, _, _ in questions:
        torch.cuda.synchronize()
        clock = [time.time()]
        handle = model.videoQA_dispatch(samples)
        torch.cuda.synchronize()
        clock.append(time.time())
        handle = model.videoQA_redecode(handle)
        handle["frames"] = model.collect_window_redecodes(handle.pop("pending"))
        clock.append(time.time())
        out = model.videoQA_collect(handle)
        torch.cuda.synchronize()
        clock.append(time.time())
        stages.append([b - a for a, b in zip(clock, clock[1:])])
        serial += task._rows_from_outputs(out, handle["samples"])
    for hook in hooks:
        hook.remove()
    require(set(lengths["localizer"]) == {QA_ENTRY_LOCALIZER_LENGTH}
            and set(lengths["answerer"]) == {QA_ENTRY_ANSWERER_LENGTH},
            f"QA encoder lengths {lengths}: phase 3 held kernel 3 at "
            f"{QA_ENTRY_LOCALIZER_LENGTH} and {QA_ENTRY_ANSWERER_LENGTH}")
    serial = json.loads(json.dumps(serial))
    require(rows == serial, f"QA rows differ from a serial videoQA_generate: {rows} vs {serial}")
    for r in rows:
        require(r["relevant_moments"] == [[0, round(r["duration"])]]
                and r["duration"] == QA_VIDEO_FRAMES / QA_FPS and r["prediction"] in range(5),
                f"QA row {r}")
    metrics = json.loads(json.dumps(logs["test"]))
    require(all(k in metrics for k in QA_METRIC_KEYS) and metrics["total"] == QA_QUESTIONS,
            f"QA metrics {metrics}")
    say(f"QA rows (equal to a serial videoQA_generate, field for field): "
        f"{[(r['qid'], r['prediction'], r['target'], r['relevant_moments']) for r in rows]}")
    say(f"QA metrics (random weights: every span [[-1, -1]], so no quality number): "
        f"{json.dumps(metrics)}")
    steady = statistics.mean(seconds[1:-1])
    split = [statistics.mean(s[j] for s in stages[1:]) for j in range(3)]
    say(f"QA entry point (configs/projects/eval/nextGQA.yaml, resample_frames, "
        f"{QA_QUESTIONS} questions over {QA_VIDEO_FRAMES / QA_FPS:.0f} s videos, 1 x {N_FRAMES} "
        f"frames, 60 re-decoded for the answerer): steady {steady:.3f} s/question "
        f"(pipelined, questions 1-{QA_QUESTIONS - 2}), first {seconds[0]:.3f} s, last "
        f"{seconds[-1]:.3f} s (its localizer and two answerers); serial "
        f"localizer {split[0]:.3f} / re-decode {split[1]:.3f} / answerer {split[2]:.3f} s "
        f"(questions 1-{QA_QUESTIONS - 1}); launches per question (localizer + answerer) "
        f"{ {k: v for k, v in per_question[0].items() if v} } predicted "
        f"{ {k: v for k, v in EXPECTED_QA_ENTRY_LAUNCHES.items() if v} }; encoder lengths "
        f"localizer {sorted(set(lengths['localizer']))}, answerer "
        f"{sorted(set(lengths['answerer']))}; before the first "
        f"question {starts[0] - t0:.3f} s; main() {wall:.3f} s; peak memory "
        f"{(peak - resident) / 2**30:.2f} GiB above the {resident / 2**30:.2f} GiB earlier "
        f"phases held; {card}")
    del model, questions, answers
    torch.cuda.empty_cache()
    return launches, dict(steady_s=steady, first_s=seconds[0], wall_s=wall,
                          localizer_s=split[0], redecode_s=split[1], answerer_s=split[2],
                          peak_gib=(peak - resident) / 2**30)


# -------------------------------------------------------------- phase 19
def opt_prompt_length(model, sample):
    """The OPT prompt's length for one dataset item: the timestamp prompt,
    the frame tokens, the end token and the bucketed query + task prompt."""
    from mr_blip_tpu_torch.datasets.base_dataset import default_collate

    batch = model.prepare_opt_batch(default_collate([sample]), need_targets=False)
    return (batch["vid_ids"].shape[1] + batch["frames"].shape[1] * model.module.tokens_per_frame
            + batch["end_ids"].shape[1] + batch["text_ids"].shape[1])


def opt_entry_point(torch, wrappers, card):
    """Phase 19: ``python -m mr_blip_tpu_torch.evaluate`` on
    ``configs/projects/eval/opt_charades.yaml`` (``blip2_opt_mr``: EVA ViT-g,
    Q-Former, OPT-2.7b at full width and depth, bf16, greedy, ``min_len`` 5,
    batch 1), called in this process on OPT_QUESTIONS synthetic queries over
    30 s videos, its model built once by ``BLIP2_MR_OPT.from_config`` with
    random weights and the fallback tokenizer's vocabulary. At the published
    60 frames the prompt passes OPT's 2,048 positions and the run must raise
    the model's ``ValueError``; the frame count is then cut to the largest
    whose prompt and ``max_new_tokens`` fit (printed; OPT_FRAMES), and every
    question must launch LayerNorm 110 + 65 x (1 + decode steps) and packed
    QKV 39 times and no other kernel, its rows equal a serial
    ``model.generate`` of the same loader batches. Then one LoRA micro-batch
    of ``TrainCtx.step`` on that model (finite loss, every LoRA gradient
    finite and nonzero) and the depth-2 kernel path against the CPU's plain
    path. Returns the launch counts of the evaluation and its summary."""
    import tempfile

    from mr_blip_tpu_torch import evaluate, tasks
    from mr_blip_tpu_torch.common.config import Config
    from mr_blip_tpu_torch.datasets.synthetic import make_mr_annotations
    from mr_blip_tpu_torch.models.blip2_mr_opt import BLIP2_MR_OPT
    from mr_blip_tpu_torch.runners.train_state import TrainCtx
    from mr_blip_tpu_torch.tasks.moment_retrieval import MomentRetrievalTask

    cfg_path = ROOT / "configs/projects/eval/opt_charades.yaml"
    built = []  # the model and the config section it was built from
    calls, collect_ends = [], []
    from_config = BLIP2_MR_OPT.__dict__["from_config"]
    dispatch, collect = BLIP2_MR_OPT.generate_dispatch, BLIP2_MR_OPT.generate_collect

    def built_once(cls, cfg, device="cuda"):
        if not built:
            t0 = time.time()
            built.append((from_config.__func__(cls, cfg, device=device), dict(cfg),
                          time.time() - t0))
        require(dict(cfg) == built[0][1], "phase 19: a second run asks for another model")
        return built[0][0]

    def tapped_dispatch(model, samples):
        start = time.time()
        require(isinstance(samples["video"], torch.Tensor) and samples["video"].is_cuda,
                "OPT evaluation: the loader did not put the frames on the card")
        before = {name: w.launches for name, w in wrappers.items()}
        steps = []
        step = model.module.decode_step
        model.module.decode_step = lambda *a: steps.append(1) or step(*a)
        try:
            handle = dispatch(model, samples)
        finally:
            del model.module.decode_step
        calls.append((samples, {name: w.launches - before[name]
                                for name, w in wrappers.items()}, start, len(steps)))
        return handle

    def tapped_collect(model, handle):
        out = collect(model, handle)
        collect_ends.append(time.time())
        return out

    def argv(tmp, paths, n_frms):
        return ["--cfg-path", str(cfg_path), "--options",
                *(f"datasets.charades_sta.build_info.annotations.{split}.storage={path}"
                  for split, path in paths.items()),
                "datasets.charades_sta.build_info.videos.storage=synthetic",
                f"datasets.charades_sta.vis_processor.eval.n_frms={n_frms}",
                f"run.output_dir={Path(tmp) / f'out{n_frms}'}"]

    with tempfile.TemporaryDirectory() as tmp:
        paths = make_mr_annotations(tmp, n_train=0, n_val=OPT_QUESTIONS, n_test=0,
                                    n_video_frames=OPT_VIDEO_FRAMES, fps=OPT_FPS)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        resident = torch.cuda.memory_allocated()  # what earlier phases still hold
        BLIP2_MR_OPT.from_config = classmethod(built_once)
        BLIP2_MR_OPT.generate_dispatch = tapped_dispatch
        BLIP2_MR_OPT.generate_collect = tapped_collect
        try:
            # The published 60 frames: the model must refuse the prompt.
            t0 = time.time()
            refusal = None
            try:
                evaluate.main(argv(tmp, paths, 60))
            except ValueError as err:
                refusal = str(err)
            gc.collect()  # closes the interrupted loaders
            refusal_s = time.time() - t0
            require(refusal is not None and "max_position_embeddings" in refusal
                    and "2048" in refusal, f"OPT at 60 frames: no position refusal ({refusal})")
            model, _, build_s = built[0]
            cfg = model.opt_config
            require(model.num_beams == 1 and model.min_new_tokens == 5
                    and model.compute_dtype == torch.bfloat16 and model.vit_config.depth == 39
                    and (cfg.num_layers, cfg.hidden_size, cfg.num_heads, cfg.ffn_dim)
                    == (32, OPT_WIDTH, 32, 10240) and model.task == "qformer_freeze_lora"
                    and cfg.vocab_size == model.tokenizer.vocab_size,
                    "OPT evaluation: the model is not opt_charades.yaml's")
            # The largest frame count whose positions (the prefill's P - 1,
            # then max_new_tokens steps) stay below max_position_embeddings.
            lengths = {}
            for n in range(60, 0, -1):
                run_cfg = Config(cfg_path=str(cfg_path), options=argv(tmp, paths, n)[3:])
                data = tasks.setup_task(run_cfg).build_datasets(run_cfg)["charades_sta"]["val"]
                lengths[n] = max(opt_prompt_length(model, data[i]) for i in range(len(data)))
                if lengths[n] + model.max_new_tokens - 1 <= cfg.max_position_embeddings:
                    frames = n
                    break
            say(f"OPT evaluation: prompt {lengths[60]} tokens at the published 60 frames "
                f"(+{model.max_new_tokens} new tokens) passes the {cfg.max_position_embeddings} "
                f"positions -> ValueError in {refusal_s:.1f} s ({refusal}); "
                f"frames cut to {frames} (prompt {lengths[frames]}, last position "
                f"{lengths[frames] + model.max_new_tokens - 2}; prompts by frames "
                f"{lengths}); model built in {build_s:.1f} s")
            require(frames == OPT_FRAMES and lengths[frames] - 1 == OPT_PREFILL_ROWS,
                    f"OPT evaluation: {frames} frames, prefill {lengths[frames] - 1} rows; "
                    f"phase 3 holds kernel 1 at {OPT_PREFILL_ROWS}")

            # The evaluation at that frame count.
            calls.clear()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for w in wrappers.values():
                w.launches = 0
            t0 = time.time()
            logs = evaluate.main(argv(tmp, paths, frames))
            torch.cuda.synchronize()
            wall = time.time() - t0
            launches = {name: w.launches for name, w in wrappers.items()}
            peak = torch.cuda.max_memory_allocated()
            (result_file,) = (Path(tmp) / f"out{frames}").glob("*/result/val_epochbest.json")
            rows = json.loads(result_file.read_text())
        finally:
            BLIP2_MR_OPT.from_config = from_config
            BLIP2_MR_OPT.generate_dispatch, BLIP2_MR_OPT.generate_collect = dispatch, collect

    require(len(calls) == OPT_QUESTIONS and len(collect_ends) == OPT_QUESTIONS,
            f"OPT evaluation: {len(calls)} dispatches, {len(collect_ends)} collects")
    starts = [c[2] for c in calls]
    seconds = [b - a for a, b in zip(starts, starts[1:] + [collect_ends[-1]])]
    for i, (samples, rose, _, steps) in enumerate(calls):
        shape = tuple(samples["video"].shape)
        expected = dict(EXPECTED_LAUNCHES, flash_bias_attention=0,
                        layer_norm=110 + OPT_LN_PER_PASS * (1 + steps))
        say(f"OPT question {i}: {seconds[i]:.3f} s, {steps} decode steps, frames {shape}  "
            f"launches { {k: v for k, v in rose.items() if v} } (predicted "
            f"{ {k: v for k, v in expected.items() if v} })")
        require(rose == expected, f"OPT question {i}: launches {rose}, expected {expected}")
        require(shape == (1, frames, 224, 224, 3), f"OPT question {i}: frames {shape}")
    want = []
    for samples, _, _, _ in calls:
        want += MomentRetrievalTask._rows_from_outputs(model.generate(samples))
    want = json.loads(json.dumps(want, default=float))
    require(rows == want, f"OPT evaluation rows differ from model.generate: {rows} vs {want}")
    metrics = json.loads(json.dumps(logs["val"], default=float))
    require(set(metrics) == {"agg_metrics", "r1", "mAP", "mIoU", "invalid_predictions",
                             "total"} and metrics["total"] == OPT_QUESTIONS,
            f"OPT evaluation metrics {metrics}")
    steady = statistics.mean(seconds[1:])
    say(f"OPT evaluation rows (equal to model.generate): "
        f"{[(r['qid'], r['raw_prediction'], r['prediction']) for r in rows]}; metrics "
        f"(random weights) {json.dumps(metrics)}")
    say(f"OPT evaluation entry point (configs/projects/eval/opt_charades.yaml, OPT-2.7b, "
        f"{OPT_QUESTIONS} queries over {OPT_VIDEO_FRAMES / OPT_FPS:.0f} s videos, 1 x {frames} "
        f"frames, greedy): steady {steady:.3f} s/question (questions 1-{OPT_QUESTIONS - 1}), "
        f"first {seconds[0]:.3f} s; main() {wall:.3f} s; peak memory "
        f"{(peak - resident) / 2**30:.2f} GiB above the {resident / 2**30:.2f} GiB earlier "
        f"phases held; {card}")

    # One LoRA micro-batch on the same model (dropouts on, no update).
    samples = dict(calls[0][0])
    ctx = TrainCtx(model, accum_grad_iters=2)
    ctx.set_lr(3e-4)
    batch = model.prepare_mr_batch(samples)
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    loss = ctx.step(batch)
    torch.cuda.synchronize()
    step_s = time.time() - t0
    rose = {name: w.launches for name, w in wrappers.items() if w.launches}
    lora = {n: p for n, p in model.module.named_parameters() if p.requires_grad}
    require(math.isfinite(loss), f"OPT LoRA step: loss {loss}")
    require(lora and all(n.startswith("opt.") and "lora_" in n for n in lora)
            and all(p.grad is not None and bool(torch.isfinite(p.grad).all())
                    for p in lora.values())
            and all(float(p.grad.abs().max()) > 0 for n, p in lora.items()
                    if "lora_a" in n or "lora_b" in n),
            "OPT LoRA step: a LoRA gradient is missing, not finite or zero")
    expected = {"layer_norm": 110 + OPT_LN_PER_PASS, "qkv_packed_attention": 39}
    require(rose == expected, f"OPT LoRA step: launches {rose}, expected {expected}")
    say(f"OPT LoRA micro-batch (TrainCtx.step, 1 x {frames} frames, sequence "
        f"{batch['vid_ids'].shape[1] + frames * 32 + 1 + batch['text_ids'].shape[1] + batch['answer_ids'].shape[1]}"
        f" tokens): loss {loss:.4f}, {len(lora)} LoRA tensors with finite nonzero gradients, "
        f"{sum(p.numel() for p in lora.values()):,} parameters train; {step_s:.3f} s; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {rose}; {card}")
    del model, ctx, lora, built[:], calls[:]
    gc.collect()
    torch.cuda.empty_cache()
    opt_kernel_vs_plain_path(torch, wrappers)
    return launches, dict(steady_s=steady, first_s=seconds[0], wall_s=wall,
                          peak_gib=(peak - resident) / 2**30, frames=frames)


def reduced_opt_model(device, init_params=True):
    """The OPT variant at full widths, ViT, Q-Former and OPT REDUCED_DEPTH
    deep, opt_charades.yaml's settings (without ``init_params``, built as
    ``reduced_model`` builds it)."""
    import dataclasses

    from mr_blip_tpu_torch.models.blip2_mr_opt import BLIP2_MR_OPT, Blip2OPTModule
    from mr_blip_tpu_torch.models.eva_vit import eva_vit_g_config
    from mr_blip_tpu_torch.models.opt import opt_2_7b_config

    class ReducedDepth(BLIP2_MR_OPT):
        VIT_CONFIGS = {"eva_vit_g": lambda **kw: dataclasses.replace(
            eva_vit_g_config(**kw), depth=REDUCED_DEPTH)}
        OPT_CONFIGS = {"opt-2.7b": lambda **kw: dataclasses.replace(
            opt_2_7b_config(**kw), num_layers=REDUCED_DEPTH)}

        def __init__(self):
            super().__init__(task="qformer_freeze_lora", num_beams=1, min_new_tokens=5,
                             init_params=False, device=device)
            self.qformer_config = dataclasses.replace(self.qformer_config,
                                                      num_layers=REDUCED_DEPTH)
            self.module = Blip2OPTModule(self.vit_config, self.qformer_config,
                                         self.opt_config, compute_dtype=self.compute_dtype,
                                         device=self.device).eval()
            self.module.requires_grad_(False)
            if init_params:
                self.init_params(0)

    if init_params:
        return ReducedDepth()
    with no_weight_init():
        return ReducedDepth()


def opt_logits(torch, model, samples):
    """The OPT's logits over the assembled prompt, fp32 on the host."""
    with torch.inference_mode():
        tensors = model._to_device(model.prepare_opt_batch(samples, need_targets=False))
        embeds, mask = model.module.prefill(tensors["frames"],
                                            *(tensors[k] for k in model._PROMPT_KEYS))
        return model.module.opt(embeds, attention_mask=mask).float().cpu()


def opt_kernel_vs_plain_path(torch, wrappers):
    """The depth-2 OPT model at full width on 1 x 8 frames, bf16, on the card
    (kernels 1 and 2) and on the CPU (their plain versions): the logits of
    every prompt row must agree, cosine >= 0.999."""
    from mr_blip_tpu_torch.models.layers import LayerNormFP32
    from mr_blip_tpu_torch.profile_inference import make_samples

    samples = make_samples(1, 8, seed=7)
    gpu = reduced_opt_model("cuda")
    for w in wrappers.values():
        w.launches = 0
    got = opt_logits(torch, gpu, samples)
    rose = {name: w.launches for name, w in wrappers.items() if w.launches}
    # Every LayerNorm of the model runs once (the ViT has no final norm).
    norms = sum(isinstance(m, LayerNormFP32) for m in gpu.module.modules())
    require(rose == {"layer_norm": norms, "qkv_packed_attention": REDUCED_DEPTH},
            f"reduced OPT model: launches {rose}, {norms} LayerNorms")
    state = {k: v.cpu() for k, v in gpu.state_dict().items()}
    del gpu
    torch.cuda.empty_cache()
    cpu = reduced_opt_model("cpu", init_params=False)
    cpu.load_state_dict(state)
    t0 = time.time()
    want = opt_logits(torch, cpu, samples)
    seconds = time.time() - t0
    cos = torch.nn.functional.cosine_similarity(got[0], want[0], dim=-1)
    say(f"OPT kernel path vs plain path (depth {REDUCED_DEPTH}, full width, 1 x 8 frames, "
        f"{got.shape[1]} prompt rows, vocabulary {got.shape[2]}): logits per-row cosine min "
        f"{float(cos.min()):.6f} mean {float(cos.mean()):.6f}; launches {rose}; CPU run "
        f"{seconds:.1f} s")
    require(bool(torch.isfinite(got).all()), "OPT kernel path: logits not finite")
    require(float(cos.min()) >= COSINE_MIN, f"OPT logits cosine {float(cos.min())}")


# -------------------------------------------------------------- phase 20
def serving_rows(reqs, videos):
    """The rows the server dispatches for ``reqs``, as ``generate`` samples;
    ``videos``: their frames as submitted (the server replaces a request's
    frames by the copy it staged on the card)."""
    import numpy as np

    from mr_blip_tpu_torch.datasets.mr_datasets import TASK_PROMPT

    return {
        "video": np.stack(videos),
        "timestamps": np.stack([np.linspace(0.0, r.duration, len(v), endpoint=False)
                                for r, v in zip(reqs, videos)]),
        "duration": np.asarray([r.duration for r in reqs]),
        "query_id": [r.qid for r in reqs],
        "video_prompt_end": ["<extra_id_0>"] * len(reqs),
        "query_prompt": ["Query: " + r.query + "\n" for r in reqs],
        "task_prompt": [TASK_PROMPT] * len(reqs),
    }


def serving_entry_point(torch, wrappers, card, main_summary):
    """Phase 20: online serving at full width. ``load_model("blip2_mr",
    "pretrain_flant5xl")`` on the card (EVA ViT-g, Q-Former, Flan-T5-XL, bf16,
    beam 5; weights redrawn from seed 0), a ``MomentRetrievalServer``
    (max_batch 4, buckets 1/2/4, two decode workers) warmed at 60 frames,
    then (a) four frame requests from one thread: one batch, rows equal to
    ``model.generate`` on the same four rows; (b) three requests: one batch
    padded to 4, rows equal to ``generate`` on the padded rows' first three;
    (c) SERVE_REQUESTS ``synthetic://`` requests of QVHighlights' 150 s from
    SERVE_CLIENTS client threads through ``make_httpd`` on 127.0.0.1: every
    reply 200 and spans. Every dispatched batch, warmup included, launches
    kernels 1-3 110 / 39 / 24 times. Then ``python -m
    mr_blip_tpu_torch.serve`` runs as a process: four requests, SIGTERM, exit
    0 with its stats line. Returns the launch counts of (a)-(c), its
    summary numbers and the model (phase 26 (b) serves it again)."""
    import os
    import signal
    import tempfile
    import threading
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    from mr_blip_tpu_torch.models import load_model
    from mr_blip_tpu_torch.models.blip2_mr import BLIP2_MR
    from mr_blip_tpu_torch.processors.video_processors import BlipVideoEvalProcessor
    from mr_blip_tpu_torch.serve import make_httpd
    from mr_blip_tpu_torch.serving import MomentRetrievalServer, MRRequest
    from mr_blip_tpu_torch.text.span_grammar import moment_str_to_list

    batches = []  # per dispatch: (thread name, rows, launches, seconds)
    dispatch = BLIP2_MR.generate_dispatch

    def tapped_dispatch(model, samples):
        before = {name: w.launches for name, w in wrappers.items()}
        torch.cuda.synchronize()
        start = time.time()
        handle = dispatch(model, samples)
        torch.cuda.synchronize()
        batches.append((threading.current_thread().name, len(samples["query_id"]),
                        {name: w.launches - before[name] for name, w in wrappers.items()},
                        time.time() - start))
        return handle

    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    t0 = time.time()
    model = load_model("blip2_mr", "pretrain_flant5xl")
    model.init_params(0)
    model.max_new_tokens = SHORT_NEW_TOKENS
    torch.cuda.synchronize()
    build_s = time.time() - t0
    require(model.num_beams == 5 and model.compute_dtype == torch.bfloat16
            and model.vit_config.depth == 39 and model.t5_config.num_layers == 24
            and model.device.type == "cuda", "serving: not the pretrain_flant5xl model")
    proc = BlipVideoEvalProcessor(image_size=224, n_frms=N_FRAMES, normalize=False)
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    BLIP2_MR.generate_dispatch = tapped_dispatch
    try:
        srv = MomentRetrievalServer(model, vis_processor=proc, max_batch=BATCH,
                                    max_wait_ms=SERVE_FORM_WAIT_MS, batch_buckets=[1, 2, 4],
                                    decode_workers=2)
        warmup_s = srv.warmup(N_FRAMES)
        require(len(batches) == 3, f"serving warmup: {len(batches)} batches")
        samples = make_serving_samples(BATCH, seed=20)
        # (a) four frame requests from one thread: one full batch
        reqs = [MRRequest(query=f"a person is doing something {i}", duration=150.0,
                          video=samples[i], qid=f"a{i}") for i in range(BATCH)]
        got_a = [f.result(timeout=600) for f in [srv.submit(r) for r in reqs]]
        want = model.generate(serving_rows(reqs, samples))
        require([g["raw_prediction"] for g in got_a] == want["raw_prediction"]
                and [g["prediction"] for g in got_a] == want["prediction"],
                f"serving (a): rows differ from model.generate: {got_a} vs {want}")
        # (b) three requests: one batch padded to 4 by repeating the last row
        reqs = [MRRequest(query=r.query, duration=r.duration, video=v, qid=r.qid)
                for r, v in zip(reqs[:3], samples)]
        got_b = [f.result(timeout=600) for f in [srv.submit(r) for r in reqs]]
        want = model.generate(serving_rows(reqs + [reqs[-1]], samples[:3] + samples[2:3]))
        require([g["raw_prediction"] for g in got_b] == want["raw_prediction"][:3],
                f"serving (b): rows differ from generate on the padded rows: {got_b} vs {want}")
        srv.close(timeout=600)
        st = srv.stats()
        server_batches = [b for b in batches if b[0] == "mrserve-device"]
        require(st.batches == 2 and [b[1] for b in server_batches] == [4, 4]
                and abs(st.mean_batch_occupancy - 7 / 8) < 1e-12 and st.completed == 7,
                f"serving (a), (b): {st}, batches {[b[1] for b in server_batches]}")
        # (c) HTTP under closed-loop load from SERVE_CLIENTS threads
        first_c = len(batches)
        srv = MomentRetrievalServer(model, vis_processor=proc, max_batch=BATCH,
                                    max_wait_ms=SERVE_WAIT_MS, batch_buckets=[1, 2, 4],
                                    decode_workers=2)
        httpd = make_httpd(srv, host="127.0.0.1", port=0)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{httpd.server_address[1]}/v1/moment_retrieval"

        def post(i):
            body = json.dumps({"query": f"a person is doing something {i}", "duration": 150.0,
                               "video_path": f"synthetic://{EVAL_VIDEO_FRAMES}x96x128@"
                                             f"{EVAL_FPS}#{i}", "qid": f"c{i}"}).encode()
            req = urllib.request.Request(url, data=body, method="POST")
            with urllib.request.urlopen(req, timeout=600) as r:
                return r.status, json.loads(r.read())

        t_load = time.time()
        with ThreadPoolExecutor(SERVE_CLIENTS) as pool:
            replies = list(pool.map(post, range(SERVE_REQUESTS)))
        load_s = time.time() - t_load
        httpd.shutdown()
        httpd.server_close()
        srv.close(timeout=600)
        st_c = srv.stats()
    finally:
        BLIP2_MR.generate_dispatch = dispatch
    peak = torch.cuda.max_memory_allocated()
    launches = {name: w.launches for name, w in wrappers.items()}
    for code, out in replies:
        require(code == 200, f"serving (c): reply {code} {out}")
        moment_str_to_list(out["prediction"])
    require(sorted(out["qid"] for _, out in replies) == sorted(f"c{i}" for i in
                                                               range(SERVE_REQUESTS)),
            "serving (c): replies do not match the requests")
    for i, (_, rows, rose, _) in enumerate(batches):
        require(rose == EXPECTED_LAUNCHES, f"serving batch {i} ({rows} rows): launches "
                f"{rose}, expected {EXPECTED_LAUNCHES}")
    loaded = [b for b in batches[first_c:]]
    require(st_c.completed == SERVE_REQUESTS and st_c.failed == 0
            and st_c.batches == len(loaded), f"serving (c): {st_c}")
    per_batch = statistics.mean(b[3] for b in loaded)
    say(f"serving (phase 20; pretrain_flant5xl via load_model, B<={BATCH} x {N_FRAMES} frames, "
        f"buckets 1/2/4): model built in {build_s:.1f} s, warmup of 3 buckets {warmup_s:.1f} s; "
        f"(a) 4 requests -> 1 batch, rows equal to model.generate; (b) 3 requests -> 1 batch "
        f"padded to 4, rows equal to generate on the padded rows; every batch launched "
        f"{ {k: v for k, v in EXPECTED_LAUNCHES.items() if v} } ({len(batches)} dispatches "
        f"with warmup and the reference generates)")
    say(f"serving under load (c) ({SERVE_REQUESTS} synthetic:// requests of "
        f"{EVAL_VIDEO_FRAMES / EVAL_FPS:.0f} s from {SERVE_CLIENTS} client threads over HTTP, "
        f"max_wait {SERVE_WAIT_MS} ms): batches {st_c.batches} of rows "
        f"{[b[1] for b in loaded]}, occupancy {st_c.mean_batch_occupancy:.3f}, "
        f"{st_c.throughput_rps:.3f} requests/s ({SERVE_REQUESTS / load_s:.3f} over the "
        f"clients' {load_s:.3f} s), latency p50 {st_c.latency_p50_s:.3f} p95 "
        f"{st_c.latency_p95_s:.3f} p99 {st_c.latency_p99_s:.3f} s; seconds per batch under "
        f"load {per_batch:.3f} (each {[round(b[3], 3) for b in loaded]}; {SHORT_NEW_TOKENS} new "
        f"tokens) vs phase 4's steady {main_summary['steady_s']:.3f} "
        f"({main_summary['decode_steps']}); peak memory {(peak - resident) / 2**30:.2f} GiB "
        f"above the {resident / 2**30:.2f} GiB earlier phases held; {card}")
    summary = dict(batches=st_c.batches, occupancy=st_c.mean_batch_occupancy,
                   rps=st_c.throughput_rps, p50_s=st_c.latency_p50_s,
                   p95_s=st_c.latency_p95_s, p99_s=st_c.latency_p99_s,
                   batch_s=per_batch, peak_gib=(peak - resident) / 2**30)
    del srv
    gc.collect()
    torch.cuda.empty_cache()

    # python -m mr_blip_tpu_torch.serve as a process: four requests, SIGTERM.
    t0 = time.time()
    errors = tempfile.TemporaryFile(mode="w+")  # its log, read if it fails
    server = subprocess.Popen(
        [sys.executable, "-m", "mr_blip_tpu_torch.serve", "--model-type", "pretrain_flant5xl",
         "--n-frms", str(N_FRAMES), "--port", "0"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=errors, text=True)
    killer = threading.Timer(SERVE_PROCESS_TIMEOUT_S, server.kill)
    killer.start()

    def log_tail():
        errors.seek(0)
        return errors.read()[-2000:]

    try:
        line = server.stdout.readline()
        require(line.startswith("serving on"), f"serve: no 'serving on' line ({line!r}): "
                f"{log_tail()}")
        ready_s = time.time() - t0
        url = f"http://127.0.0.1:{int(line.strip().rsplit(':', 1)[1])}/v1/moment_retrieval"
        with ThreadPoolExecutor(4) as pool:
            replies = list(pool.map(post, range(4)))
        require(all(code == 200 for code, _ in replies), f"serve: replies {replies}")
        server.send_signal(signal.SIGTERM)
        out, _ = server.communicate(timeout=SERVE_PROCESS_TIMEOUT_S)
    finally:
        killer.cancel()
        if server.poll() is None:
            os.kill(server.pid, signal.SIGKILL)
            server.communicate()
    require(server.returncode == 0, f"serve: exit {server.returncode}: {log_tail()}")
    errors.close()
    stats = json.loads(out.strip().splitlines()[-1])
    require(stats["completed"] == 4 and stats["failed"] == 0 and stats["queued"] == 0,
            f"serve: stats {stats}")
    say(f"python -m mr_blip_tpu_torch.serve: serving {ready_s:.1f} s after start; 4 requests "
        f"answered (batches {stats['batches']}, occupancy "
        f"{stats['mean_batch_occupancy']:.3f}); SIGTERM -> exit 0 after draining, stats line "
        f"{json.dumps(stats)}; {time.time() - t0:.1f} s in all")
    return launches, summary, model


def make_serving_samples(n, seed):
    """``n`` videos of N_FRAMES random uint8 frames at 224²."""
    from mr_blip_tpu_torch.profile_inference import make_samples

    return list(make_samples(n, N_FRAMES, seed)["video"])


# -------------------------------------------------------------- phase 21
def qlora_entry_point(torch, wrappers, card, train_summary):
    """Phase 21: QLoRA-style training at full width, ``python -m
    mr_blip_tpu_torch.train`` on ``configs/projects/train/qvh.yaml`` with
    ``model.int8_base=True model.int8_vit=True`` (the T5 base weight-only int8
    under the LoRA deltas, the ViT on the W8A8 kernels), random weights, over
    QLORA_QUERIES synthetic train queries, one val and one test query,
    micro-batches of 1 x 60 frames under ``use_grad_checkpoint``. Called
    twice in this process: a run SIGTERMed from a thread of this process
    after QLORA_PREEMPT_AFTER micro-batches (one update of QLORA_ACCUM and
    one micro-batch into the next window) must exit 143 with a resume state of
    the unfinished epoch; a run resuming from it must load the weights
    (every ``kernel_q`` among them), the AdamW state, the counters and the
    partial gradients bit for bit, log ``(epoch 0)``, re-run the epoch and
    exit 0. Every T5 ``kernel_q`` bit-equal to the built one after the update
    and after the resumed run, every LoRA tensor moved, every loss finite,
    each micro-batch's and each generate's launches as predicted; one more
    forward of the trained model with checkpointing off must save for the
    backward no float tensor of a frozen int8 weight's shape. Then the
    depth-2 model against the CPU's plain path (loss, LoRA gradients by
    cosine, phase 7's bars). Returns the two runs' launch counts."""
    import logging
    import os
    import signal
    import tempfile
    import threading

    from mr_blip_tpu_torch import train
    from mr_blip_tpu_torch.datasets.synthetic import make_mr_annotations
    from mr_blip_tpu_torch.models.blip2_mr import BLIP2_MR
    from mr_blip_tpu_torch.profile_inference import make_samples
    from mr_blip_tpu_torch.runners.runner_base import RunnerBase
    from mr_blip_tpu_torch.runners.train_state import TrainCtx

    models, steps, generates, messages = [], [], [], []
    built, saved, loaded, peaks = {}, {}, {}, {}
    stop_after = [QLORA_PREEMPT_AFTER]
    from_config = BLIP2_MR.from_config.__func__
    step, dispatch = TrainCtx.step, BLIP2_MR.generate_dispatch
    write_resume, load_checkpoint = RunnerBase._write_resume_state, RunnerBase.load_checkpoint

    def counts():
        return {name: w.launches for name, w in wrappers.items()}

    def int8_t5(model):
        return [b for n, b in model.module.named_buffers()
                if n.startswith("t5.") and n.endswith("kernel_q")]

    def lora_moved(model):
        lora = {n: p for n, p in model.module.named_parameters() if "lora_" in n}
        same = [n for n, p in lora.items() if torch.equal(p.detach().float(), built["lora"][n])]
        require(lora and not same, f"QLoRA: {len(same)} LoRA tensors never moved, e.g. "
                f"{same[:3]}")
        return len(lora)

    def tapped_from_config(cls, cfg, device="cuda"):
        model = from_config(cls, cfg, device=device)
        models.append(model)
        if not built:  # the first run's weights as built
            built["kernel_q"] = checksums(torch, int8_t5(model))
            built["lora"] = {n: p.detach().float().clone()
                             for n, p in model.module.named_parameters() if "lora_" in n}
        return model

    def tapped_step(ctx, batch):
        before = counts()
        torch.cuda.synchronize()
        if not steps:  # the peak so far is the build's (and the resume state's load)
            peaks["build"] = max(peaks.get("build", 0), torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
        start = time.time()
        loss = step(ctx, batch)
        torch.cuda.synchronize()
        steps.append(({n: w.launches - before[n] for n, w in wrappers.items()},
                      time.time() - start, loss, ctx.updates))
        if len(steps) == stop_after[0]:  # SIGTERM from another thread
            thread = threading.Thread(target=os.kill, args=(os.getpid(), signal.SIGTERM))
            thread.start()
            thread.join()
        return loss

    def tapped_dispatch(model, samples):
        before = counts()
        handle = dispatch(model, samples)
        generates.append({n: w.launches - before[n] for n, w in wrappers.items()})
        return handle

    def state_snapshot(runner):
        """Bit checksums of every weight, ``kernel_q`` apart; exact host
        copies of the train state (small: the LoRA tensors, their gradients
        and moments)."""
        ctx = runner.train_ctx.state_dict()

        def copy(t):
            return None if t is None else t.to("cpu", copy=True)

        return {"weights": checksums(torch, list(runner.model.state_dict().values())),
                "kernel_q": checksums(torch, int8_t5(runner.model)),
                "params": {n: copy(t) for n, t in ctx["params"].items()},
                "grads": {n: copy(g) for n, g in ctx["grads"].items()},
                "moments": {(i, k): copy(v) for i, st in ctx["optimizer"]["state"].items()
                            for k, v in st.items()},
                "counters": (ctx["calls"], ctx["updates"])}

    def tapped_write_resume(runner, cur_epoch, epoch_complete=True):
        if epoch_complete:  # not the preemption's state
            return write_resume(runner, cur_epoch, epoch_complete)
        saved.update(state_snapshot(runner))
        lora_moved(runner.model)
        torch.cuda.synchronize()
        start = time.time()
        path = write_resume(runner, cur_epoch, epoch_complete)
        saved["write_s"] = time.time() - start
        saved["bytes"] = os.path.getsize(path)
        return path

    def tapped_load_checkpoint(runner, path):
        start = time.time()
        load_checkpoint(runner, path)
        torch.cuda.synchronize()
        loaded["load_s"] = time.time() - start
        loaded.update(state_snapshot(runner))
        loaded["start_epoch"] = runner.start_epoch

    class Messages(logging.Filter):  # survives setup_logger's basicConfig(force=True)
        def filter(self, record):
            messages.append(record.getMessage())
            return True

    def free():
        models.clear()
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    taps = ((BLIP2_MR, "from_config", classmethod(tapped_from_config)),
            (TrainCtx, "step", tapped_step), (BLIP2_MR, "generate_dispatch", tapped_dispatch),
            (RunnerBase, "_write_resume_state", tapped_write_resume),
            (RunnerBase, "load_checkpoint", tapped_load_checkpoint))
    originals = [(cls, name, cls.__dict__[name]) for cls, name, _ in taps]
    log_filter = Messages()
    with tempfile.TemporaryDirectory() as tmp:
        paths = make_mr_annotations(f"{tmp}/run", n_train=QLORA_QUERIES, n_val=1, n_test=1,
                                    n_video_frames=EVAL_VIDEO_FRAMES, fps=EVAL_FPS)

        def argv(out, *options):
            return ["--cfg-path", str(ROOT / "configs/projects/train/qvh.yaml"), "--options",
                    *(f"datasets.qvh.build_info.annotations.{split}.storage={path}"
                      for split, path in paths.items()),
                    "datasets.qvh.build_info.videos.storage=synthetic",
                    f"run.output_dir={Path(tmp) / out}", "run.max_epoch=1",
                    f"run.accum_grad_iters={QLORA_ACCUM}",
                    f"model.max_new_tokens={SHORT_NEW_TOKENS}",
                    "model.int8_base=True", "model.int8_vit=True", *options]

        free()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        for w in wrappers.values():
            w.launches = 0
        for cls, name, tap in taps:
            setattr(cls, name, tap)
        logging.getLogger().addFilter(log_filter)
        try:
            # --- the run, preempted
            code = None
            t0 = time.time()
            try:
                train.main(argv("preempt"))
            except SystemExit as e:
                code = e.code
            preempt_wall = time.time() - t0
            peaks["run"] = torch.cuda.max_memory_allocated()
            stop_after[0] = None
            require(code == 143, f"QLoRA preempted run: exit code {code}, expected 143")
            (model,) = models
            require(model.t5_config.int8_base and model.vit_config.int8_matmul
                    and model.t5_config.use_remat and model.task == "qformer_freeze_lora",
                    "QLoRA: not qvh.yaml's model with int8_base and int8_vit")
            del model
            run_steps = list(steps)
            require(len(run_steps) == QLORA_PREEMPT_AFTER,
                    f"QLoRA preempted run: {len(run_steps)} micro-batches")
            (resume_path,) = (Path(tmp) / "preempt").glob("*/resume_state.pth")
            state = torch.load(resume_path, map_location="cpu", mmap=True, weights_only=True)
            require(state["epoch"] == 0 and state["epoch_complete"] is False,
                    f"QLoRA resume state: epoch {state['epoch']}, epoch_complete "
                    f"{state['epoch_complete']}")
            del state
            free()
            torch.cuda.reset_peak_memory_stats()
            steps.clear()
            messages.clear()

            # --- the run, resumed
            t0 = time.time()
            resume_logs = train.main(argv("resume", f"run.resume_ckpt_path={resume_path}"))
            torch.cuda.synchronize()
            resume_wall = time.time() - t0
            peaks["run"] = max(peaks["run"], torch.cuda.max_memory_allocated())
        finally:
            logging.getLogger().removeFilter(log_filter)
            for cls, name, original in originals:
                setattr(cls, name, original)
        launches = counts()
    (model,) = models
    for i, (rose, _, loss, _) in enumerate(run_steps + steps):
        require(rose == EXPECTED_QLORA_LAUNCHES, f"QLoRA micro-batch {i}: launches {rose}, "
                f"expected {EXPECTED_QLORA_LAUNCHES}")
        require(math.isfinite(loss), f"QLoRA micro-batch {i}: loss {loss}")
    require(len(generates) == 2 and all(g == EXPECTED_QLORA_GENERATE_LAUNCHES
                                        for g in generates),
            f"QLoRA val/test generates: {generates}")
    # The preempted run's state after its update, bit-equal after the load.
    require(saved["kernel_q"] == built["kernel_q"], "QLoRA: a T5 kernel_q changed in the update")
    require(loaded["start_epoch"] == 0, f"QLoRA resumed run: start epoch {loaded['start_epoch']}")
    require(any("Resume checkpoint loaded" in m and "(epoch 0)" in m for m in messages),
            "QLoRA resumed run: no 'Resume checkpoint loaded ... (epoch 0)' in its log")
    require(loaded["weights"] == saved["weights"] and loaded["kernel_q"] == built["kernel_q"],
            "QLoRA resumed run: weights differ from the saved")
    require(loaded["counters"] == saved["counters"] == (
        QLORA_PREEMPT_AFTER, QLORA_PREEMPT_AFTER // QLORA_ACCUM),
        f"QLoRA resumed run: calls, updates {loaded['counters']} (saved {saved['counters']})")
    for key in ("params", "grads", "moments"):
        require(saved[key].keys() == loaded[key].keys(), f"QLoRA resumed run: {key} names differ")
        for name, want in saved[key].items():
            got = loaded[key][name]
            require(want is not None and torch.equal(got, want),
                    f"QLoRA resumed run: {key} {name} differs from the saved (or is missing)")
    require(len(steps) == QLORA_QUERIES and steps[-1][3] == (
        QLORA_PREEMPT_AFTER + QLORA_QUERIES) // QLORA_ACCUM,
        f"QLoRA resumed run: {len(steps)} micro-batches, {steps[-1][3]} updates")
    require(json.loads(json.dumps(resume_logs["test"], default=float))["total"] == 1,
            f"QLoRA resumed run: test logs {resume_logs}")
    require(checksums(torch, int8_t5(model)) == built["kernel_q"],
            "QLoRA: a T5 kernel_q changed in the resumed run")
    n_lora = lora_moved(model)
    int8_bytes = sum(b.numel() for b in model.module.buffers() if b.dtype == torch.int8)

    # Nothing float of an int8 weight's shape is saved for the backward: one
    # forward without checkpointing (which would hide the blocks' tensors).
    shapes = set()
    for b in int8_t5(model):
        shapes |= {tuple(b.shape), tuple(b.t().shape)}
    saved_floats = []

    def pack(t):
        if t.is_floating_point() and tuple(t.shape) in shapes:
            saved_floats.append((t.dtype, tuple(t.shape)))
        return t

    t5 = model.module.t5
    t5.encoder.use_remat = t5.decoder.use_remat = False
    model.train()
    batch = model.prepare_mr_batch(make_samples(1, N_FRAMES, seed=17))
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = model.loss(batch)
    del loss
    t5.encoder.use_remat = t5.decoder.use_remat = True
    model.eval()
    require(not saved_floats, f"QLoRA: float copies of int8 weights saved for the backward: "
            f"{saved_floats[:5]}")
    del model, t5, batch
    free()

    seconds = [s[1] for s in run_steps]
    say(f"QLoRA entry point (configs/projects/train/qvh.yaml + model.int8_base=True "
        f"model.int8_vit=True, {QLORA_QUERIES} queries, B=1 x {N_FRAMES} frames, "
        f"accum_grad_iters {QLORA_ACCUM}, use_grad_checkpoint): every micro-batch of both "
        f"runs launched { {k: v for k, v in EXPECTED_QLORA_LAUNCHES.items() if v} } and the "
        f"val/test generates { {k: v for k, v in EXPECTED_QLORA_GENERATE_LAUNCHES.items() if v} }; "
        f"losses {[round(s[2], 4) for s in run_steps]} then, resumed, "
        f"{[round(s[2], 4) for s in steps]}; {len(built['kernel_q'])} T5 kernel_q bit-equal "
        f"after the update and after the resumed run, {n_lora} LoRA tensors moved; "
        f"{int8_bytes / 1e9:.3f} GB of int8 weights; no float copy of an int8 weight saved "
        f"for the backward")
    say(f"QLoRA preemption: SIGTERM after {QLORA_PREEMPT_AFTER} micro-batches -> exit 143 "
        f"({preempt_wall:.3f} s); resume_state.pth {saved['bytes']:,} bytes written in "
        f"{saved['write_s']:.3f} s, loaded in {loaded['load_s']:.3f} s; weights (every "
        f"kernel_q among them), AdamW state, counters {saved['counters']} and partial "
        f"gradients bit-equal after the load; the resumed run re-ran epoch 0 ({len(steps)} "
        f"micro-batches, {resume_wall:.3f} s) and exited 0")
    say(f"QLoRA vs phase 17 (bf16 base), seconds: micro-batch steady "
        f"{statistics.median(seconds[1:]):.3f} vs {train_summary['steady_s']:.3f} (first "
        f"{seconds[0]:.3f}); update {sum(seconds[:QLORA_ACCUM]):.3f} (its {QLORA_ACCUM} "
        f"micro-batches, the first included) vs {train_summary['update_s']:.3f}; peak memory "
        f"of the micro-batches and generates {(peaks['run'] - resident) / 2**30:.2f} vs "
        f"{train_summary['peak_gib']:.2f} GiB above what earlier phases held (model build with "
        f"its int8 conversions, or with the resume state's load, "
        f"{(peaks['build'] - resident) / 2**30:.2f}); {card}")
    qlora_kernel_vs_plain_path(torch, wrappers)
    return launches


def qlora_kernel_vs_plain_path(torch, wrappers):
    """Phase 21's depth-2 check: the ``qformer_freeze_lora`` model with
    ``int8_base`` and the int8 ViT, weights as phase 7 draws them, one
    forward and backward of 1 x GRAD_FRAMES frames on the card (kernels) and
    on the CPU (plain versions) in bf16: loss within LOSS_REL_TOL, every LoRA
    gradient's cosine >= GRAD_COSINE_MIN."""
    from mr_blip_tpu_torch.profile_inference import make_samples

    task = "qformer_freeze_lora"
    samples = make_samples(1, GRAD_FRAMES, seed=7)
    gpu = reduced_model("cuda", task=task)
    gpu.load_state_dict(bf16_friendly_state(torch, gpu))
    gpu.quantize_vit().quantize_base_for_train()
    batch = gpu.prepare_mr_batch(samples)
    for w in wrappers.values():
        w.launches = 0
    loss_gpu, g_gpu, _ = path_gradients(torch, gpu, batch, task)
    rose = {name: w.launches for name, w in wrappers.items() if w.launches}
    state = {k: v.cpu() for k, v in gpu.state_dict().items()}
    del gpu
    torch.cuda.empty_cache()
    cpu = reduced_model("cpu", task=task, init_params=False)
    cpu.quantize_vit().quantize_base_for_train()
    cpu.load_state_dict(state)
    t0 = time.time()
    loss_cpu, g_cpu, _ = path_gradients(torch, cpu, batch, task)
    seconds = time.time() - t0
    require(g_gpu.keys() == g_cpu.keys() and all("lora_" in n for n in g_gpu),
            f"QLoRA depth {REDUCED_DEPTH}: trainable sets {sorted(g_gpu)[:3]}")
    cos = {n: cosine(torch, g_gpu[n], g_cpu[n]) for n in g_gpu}
    worst = min(cos, key=cos.get)
    rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    say(f"QLoRA kernel path vs plain path (depth {REDUCED_DEPTH}, full width, 1 x "
        f"{GRAD_FRAMES} frames, int8_base + int8 ViT): loss {loss_gpu:.5f} vs plain "
        f"{loss_cpu:.5f} (rel {rel:.2e}); {len(cos)} LoRA gradients, cosine min "
        f"{cos[worst]:.6f} ({worst}), mean {statistics.mean(cos.values()):.6f}; launches "
        f"{rose}; CPU run {seconds:.1f} s")
    require(rel <= LOSS_REL_TOL, f"QLoRA depth {REDUCED_DEPTH}: loss rel diff {rel}")
    require(cos[worst] >= GRAD_COSINE_MIN, f"QLoRA depth {REDUCED_DEPTH}: {worst} cosine "
            f"{cos[worst]}")
    require(rose.get("w8a8_attn_block") == REDUCED_DEPTH and rose.get("w8a8_mlp") == REDUCED_DEPTH
            and rose.get("flash_bias_bwd_dkv") == REDUCED_DEPTH,
            f"QLoRA depth {REDUCED_DEPTH}: launches {rose}")
    del cpu, g_gpu, g_cpu


# -------------------------------------------------------------- phase 22
def dp_launch(mode, workdir, *args, timeout=DP_LAUNCH_TIMEOUT_S, phase=22):
    """``torch.distributed.run --standalone`` of DP_RANKS copies of this
    script as ``--dp-worker mode``, its output to ``<workdir>/<mode>.log``;
    raises on a nonzero exit or the timeout. On the timeout torchrun gets
    SIGTERM (it stops its ranks), then every process of its group SIGKILL."""
    import os
    import signal

    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={DP_RANKS}", str(ROOT / "chip_smoke.py"), "--dp-worker",
           mode, str(workdir), *args]
    log = Path(workdir) / f"{mode}.log"
    with open(log, "w") as out:
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=out, stderr=subprocess.STDOUT,
                                env=dict(os.environ, PYTHONPATH=str(ROOT)),
                                start_new_session=True)
        try:
            proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(timeout=30)
            finally:
                try:
                    os.killpg(proc.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
                proc.wait()
            raise RuntimeError(f"phase {phase} ({mode}): no end within {timeout} s:\n"
                               f"{log.read_text()[-6000:]}")
    require(proc.returncode == 0,
            f"phase {phase} ({mode}): exit {proc.returncode}:\n{log.read_text()[-6000:]}")


def dp_read(workdir, mode):
    return [json.loads((Path(workdir) / f"{mode}_rank{r}.json").read_text())
            for r in range(DP_RANKS)]


def parallel_entry_points(torch, card):
    """Phase 22 (see the module docstring): (a) the train entry point over
    two ranks, (b) dp, sp and the one-rank NCCL update at flagship widths
    and depth 2.
    Returns (a)'s launches per micro-batch of one rank."""
    import tempfile

    from mr_blip_tpu_torch.datasets.synthetic import make_mr_annotations

    phase_start = time.time()
    gc.collect()
    torch.cuda.empty_cache()  # the ranks need the card's memory, not this process
    with tempfile.TemporaryDirectory() as tmp:
        paths = make_mr_annotations(
            f"{tmp}/run", n_train=DP_QUERIES, n_val=DP_EVAL_QUERIES,
            n_test=DP_EVAL_QUERIES, n_video_frames=EVAL_VIDEO_FRAMES, fps=EVAL_FPS)
        argv = ["--cfg-path", str(ROOT / "configs/projects/train/qvh.yaml"), "--options",
                *(f"datasets.qvh.build_info.annotations.{split}.storage={path}"
                  for split, path in paths.items()),
                "datasets.qvh.build_info.videos.storage=synthetic",
                f"run.output_dir={Path(tmp) / 'train'}", "run.max_epoch=1",
                f"run.accum_grad_iters={DP_ACCUM}", "run.dist_backend=gloo",
                f"run.dist_timeout_s={DP_GROUP_TIMEOUT_S}",
                f"model.max_new_tokens={SHORT_NEW_TOKENS}"]
        t0 = time.time()
        dp_launch("train", tmp, *argv)
        train_wall = time.time() - t0
        ranks = dp_read(tmp, "train")
        dp_train_report(ranks, train_wall, card)
        t0 = time.time()
        dp_launch("step", tmp)
        step_wall = time.time() - t0
        step = dp_read(tmp, "step")
    dp_step_report(step, step_wall, card)
    say(f"phase 22 (a) and (b): {time.time() - phase_start:.1f} s")
    return ranks[0]["steps"][0]


def dp_train_report(ranks, train_wall, card):
    """Phase 22 (a)'s gates and lines."""
    n_micro = DP_QUERIES // DP_RANKS
    for r, rank in enumerate(ranks):
        require(len(rank["steps"]) == n_micro and rank["updates"] == 1,
                f"phase 22 rank {r}: {len(rank['steps'])} micro-batches, "
                f"{rank['updates']} updates")
        for i, launched in enumerate(rank["steps"]):
            require(launched == EXPECTED_REMAT_TRAIN_LAUNCHES, f"phase 22 rank {r} "
                    f"micro-batch {i}: launches {launched}, expected "
                    f"{EXPECTED_REMAT_TRAIN_LAUNCHES}")
        for i, launched in enumerate(rank["generates"]):
            require(launched == EXPECTED_LAUNCHES, f"phase 22 rank {r} generate {i}: "
                    f"launches {launched}")
        require(rank["frozen_equal"] and rank["moved"], f"phase 22 rank {r}: frozen "
                f"tensors equal {rank['frozen_equal']}, trainable moved {rank['moved']}")
        require(all(math.isfinite(x) for x in rank["losses"]), f"phase 22 rank {r}: "
                f"losses {rank['losses']}")
    require(len({rank["fingerprint"] for rank in ranks}) == 1,
            "phase 22: the ranks' trainable tensors differ after the run")
    require(ranks[0]["losses"] == ranks[1]["losses"], "phase 22: the ranks report "
            "different global losses")
    rows = ranks[0]["rows"]
    for split in ("val", "test"):
        require(rows[split]["merged"] == DP_EVAL_QUERIES and rows[split]["unique"]
                == DP_EVAL_QUERIES and rows[split]["equal"], f"phase 22 {split} rows {rows}")
    seconds = [rank["seconds"] for rank in ranks]
    say(f"dp train entry point (configs/projects/train/qvh.yaml, {DP_RANKS} ranks on one "
        f"card over gloo, {n_micro} micro-batches of 1 x {N_FRAMES} frames each, "
        f"accum_grad_iters {DP_ACCUM}, one update over {DP_QUERIES} rows): every "
        f"micro-batch launched { {k: v for k, v in EXPECTED_REMAT_TRAIN_LAUNCHES.items() if v} } "
        f"on each rank, every generate { {k: v for k, v in EXPECTED_LAUNCHES.items() if v} }; "
        f"trainable tensors bit-equal across the ranks, frozen ones as built; merged val "
        f"and test rows each query once, equal to rank 0's generate; losses "
        f"{[round(x, 4) for x in ranks[0]['losses']]}")
    say("dp train entry point seconds per micro-batch: " + "; ".join(
        f"rank {r} {[round(x, 3) for x in sec]} (steady median "
        f"{statistics.median(sec[1:]):.3f})" for r, sec in enumerate(seconds))
        + "; update " + ", ".join(f"rank {r} {sum(sec):.3f}" for r, sec in enumerate(seconds))
        + "; gradient all-reduce ms " + ", ".join(
            f"rank {r} {rank['all_reduce_ms']}" for r, rank in enumerate(ranks))
        + " (" + f"{ranks[0]['grad_bytes'] / 1e6:.2f} MB" + "); peak memory "
        + ", ".join(f"rank {r} {rank['peak_gib']:.2f} GiB" for r, rank in enumerate(ranks))
        + f"; launch {train_wall:.1f} s; {card}")


def dp_step_report(step, step_wall, card):
    """Phase 22 (b)'s gates and lines."""
    dp, sp, nccl = step[0]["dp"], step[0]["sp"], step[0]["nccl"]
    for name, run in (("dp", dp), ("sp", sp)):
        require(run["loss_rel"] <= DP_LOSS_REL_TOL and run["grad_cos"] >= DP_GRAD_COSINE_MIN
                and run["tensor_rel"] <= DP_TENSOR_REL_TOL and run["apart"] <= DP_APART_MAX,
                f"phase 22 {name} vs one process: {run}")
    require(sp["spans_equal"], f"phase 22 sp: spans differ from one process's: {sp}")
    require([s_["sp"]["vit_frames"] for s_ in step] == [[N_FRAMES // DP_RANKS]] * DP_RANKS,
            f"phase 22 sp: ViT frames per rank {[s_['sp']['vit_frames'] for s_ in step]}")
    require(len({s_["dp"]["fingerprint"] for s_ in step}) == 1
            and len({s_["sp"]["fingerprint"] for s_ in step}) == 1,
            "phase 22: the ranks' tensors differ after the dp or sp update")
    require(nccl["backend"] == "nccl" and nccl["tensor_rel"] <= DP_TENSOR_REL_TOL
            and nccl["loss_rel"] <= DP_LOSS_REL_TOL, f"phase 22 NCCL: {nccl}")

    def line(run):
        return (f"loss {run['loss']:.6f} vs {run['loss_ref']:.6f} (rel {run['loss_rel']:.2e}), "
                f"gradient cosine {run['grad_cos']:.6f} (per tensor min "
                f"{run['grad_cos_tensor']:.6f} over those whose gradient norm is >= 1e-3 of "
                f"the largest), post-update max |diff| / max |tensor| {run['tensor_rel']:.2e}, "
                f"share of elements more than the lr apart {run['apart']:.2e}")

    say(f"dp step (flagship widths, depth {REDUCED_DEPTH}, task lora, dropout 0, 1 x "
        f"{N_FRAMES} frames a rank, targets of "
        f"{dp['tokens']} tokens) against one process over both rows one by one: {line(dp)}; "
        f"seconds dp {[s_['dp']['seconds'] for s_ in step]} vs one process {dp['seconds_ref']}; "
        f"launches per rank {dp['launches']}. Beside it, not held (other shapes): against "
        f"one process over both rows as one batch of 2: {line(dp['batch_of_2'])}")
    say(f"sp step (1 x {N_FRAMES} frames, the ViT over {N_FRAMES // DP_RANKS} a rank) against "
        f"one process over the two frame shares: {line(sp)}, spans equal; seconds sp "
        f"{[s_['sp']['seconds'] for s_ in step]} vs {sp['seconds_ref']}; generate sp "
        f"{[s_['sp']['generate_s'] for s_ in step]} vs {sp['generate_ref_s']:.3f} s. Beside it, "
        f"not held: against one pass over the {N_FRAMES} frames: {line(sp['one_pass'])}, "
        f"spans equal {sp['one_pass']['spans_equal']}; {card}")
    say(f"NCCL {nccl['version']} at world size 1: the update of both rows as one batch through "
        f"a one-rank nccl group against the same update without a group: loss rel "
        f"{nccl['loss_rel']:.2e}, post-update max |diff| / max |tensor| "
        f"{nccl['tensor_rel']:.2e} (bit-equal: {nccl['bit_equal']}); launch {step_wall:.1f} s; "
        f"{card}")


def _dp_rel(torch, got, want):
    """(max |got - want| / max |want| over all the tensors, the share of
    elements apart by more than the lr). AdamW's first update moves each
    element by about lr·sign(g), so an element whose near-zero gradient
    flips sign between two exact-in-math computations lands 2·lr away:
    the share of those counts the flips, which a wrong gradient would make
    common."""
    diff = max(float((got[n].float() - w.float()).abs().max()) for n, w in want.items())
    scale = max(float(w.float().abs().max()) for w in want.values())
    apart = sum(int(((got[n].float() - w.float()).abs() > TRAIN_LR).sum())
                for n, w in want.items())
    return diff / scale, apart / sum(w.numel() for w in want.values())


def _dp_samples(rows):
    """One batch of the rows of ``make_samples`` dicts."""
    import numpy as np

    out = {}
    for key, value in rows[0].items():
        out[key] = (np.concatenate([r[key] for r in rows]) if hasattr(value, "shape")
                    else [x for r in rows for x in r[key]])
    return out


def dp_train_worker(torch, workdir, argv, mode="train"):
    """Phase 22 (a) (and phase 26 (a)'s tp run, ``mode`` "tp_train"), one
    rank: ``train.main(argv)`` with taps; the frozen tensors are checksummed
    at the first step (after a tensor-parallel rank cut its shards)."""
    import os

    from mr_blip_tpu_torch import train
    from mr_blip_tpu_torch.common import dist as dist_utils
    from mr_blip_tpu_torch.datasets.loader import DataLoader
    from mr_blip_tpu_torch.models.blip2_mr import BLIP2_MR
    from mr_blip_tpu_torch.parallel import mesh
    from mr_blip_tpu_torch.runners.runner_base import RunnerBase
    from mr_blip_tpu_torch.runners.train_state import TrainCtx

    wrappers, _ = kernel_tables()
    rank = int(os.environ["RANK"])
    built, steps, seconds, losses, generates, reduce_ms, runners = {}, [], [], [], [], [], []

    def counts():
        return {name: w.launches for name, w in wrappers.items()}

    from_config = BLIP2_MR.from_config.__func__
    step, dispatch, train_fn = TrainCtx.step, BLIP2_MR.generate_dispatch, RunnerBase.train
    all_reduce_grads, destroy = mesh.all_reduce_grads, dist_utils.destroy

    def tapped_from_config(cls, cfg, device="cuda"):
        model = from_config(cls, cfg, device=device)
        mask = model.trainable_mask()
        built["trainable"] = {n: p.detach().float().clone()
                              for n, p in model.module.named_parameters() if mask[n]}
        return model

    def tapped_step(ctx, batch):
        if "frozen" not in built:
            built["frozen"] = checksums(torch, [
                p for n, p in ctx.model.module.named_parameters()
                if n not in built["trainable"]])
        before = counts()
        torch.cuda.synchronize()
        start = time.time()
        loss = step(ctx, batch)
        torch.cuda.synchronize()
        seconds.append(time.time() - start)
        steps.append({k: v - before[k] for k, v in counts().items()})
        losses.append(loss)
        return loss

    def tapped_dispatch(model, samples):
        before = counts()
        handle = dispatch(model, samples)
        generates.append({k: v - before[k] for k, v in counts().items()})
        return handle

    def tapped_reduce(params, *a, **kw):
        params = list(params)
        built["grad_bytes"] = sum(p.grad.numel() * 4 for p in params if p.grad is not None)
        torch.cuda.synchronize()
        start = time.time()
        all_reduce_grads(params, *a, **kw)
        torch.cuda.synchronize()
        reduce_ms.append(round((time.time() - start) * 1e3, 1))

    def tapped_train(runner):
        runners.append(runner)
        return train_fn(runner)

    BLIP2_MR.from_config = classmethod(tapped_from_config)
    TrainCtx.step, BLIP2_MR.generate_dispatch = tapped_step, tapped_dispatch
    RunnerBase.train = tapped_train
    mesh.all_reduce_grads = tapped_reduce
    dist_utils.destroy = lambda: None  # the checks below still gather
    torch.cuda.reset_peak_memory_stats()
    start = counts()
    train.main(argv)
    launched = {k: v - start[k] for k, v in counts().items()}
    peak = torch.cuda.max_memory_allocated()
    (runner,) = runners
    model, ctx = runner.model, runner.train_ctx
    named = dict(model.module.named_parameters())
    frozen = [p for n, p in named.items() if n not in built["trainable"]]
    summary = {
        "steps": steps, "seconds": seconds, "generates": generates,
        "all_reduce_ms": reduce_ms, "grad_bytes": built.get("grad_bytes", 0),
        "launches": launched,
        "peak_gib": peak / 2**30, "updates": ctx.updates,
        "losses": losses, "frozen_equal": checksums(torch, frozen) == built["frozen"],
        "moved": all(not torch.equal(named[n].detach().float(), v)
                     for n, v in built["trainable"].items()),
        "unmoved": [n for n, v in built["trainable"].items()
                    if torch.equal(named[n].detach().float(), v)][:5],
        "fingerprint": mesh.assert_replicated(ctx.named_params, f"{mode} run"),
        "tp": dist_utils.tp_size(),
    }
    if rank == 0:
        summary["rows"] = {}
        for split, name in (("val", "val_epoch0"), ("test", "test_epochbest")):
            if split not in list(runner.valid_splits) + list(runner.test_splits):
                continue
            merged = json.loads((runner.result_dir / f"{name}.json").read_text())
            summary["rows"][split] = {"merged": len(merged),
                                      "unique": len({r["qid"] for r in merged})}
            if dist_utils.tp_size() > 1:
                continue  # a group's generate is a collective: held on the CPU
            loader = DataLoader(runner.datasets["qvh"][split], batch_size=1, num_workers=1)
            own = [row for samples in loader
                   for row in runner.task._rows_from_outputs(model.generate(samples))]
            key = lambda r: r["qid"]  # noqa: E731
            summary["rows"][split]["equal"] = sorted(merged, key=key) == sorted(
                json.loads(json.dumps(own, default=float)), key=key)
    dist_utils.barrier()
    (Path(workdir) / f"{mode}_rank{rank}.json").write_text(json.dumps(summary))
    destroy()


def dp_step_worker(torch, workdir):
    """Phase 22 (b), one rank: dp and sp updates of the flagship model at
    depth REDUCED_DEPTH (full depth until the script passed 990 s with phase
    24) against one process, then rank 0's update through a one-rank NCCL
    group.

    The one-process references run the shapes the ranks run: dp's each row
    as a batch of 1 (its token-loss sum over both rows' token count, one
    update), sp's the two frame shares one after the other. At full depth
    this random-weight model turns float noise into large differences: the
    same two rows as one batch of 2 gave a loss 1.2% apart from the rows one
    by one and a gradient cosine of -0.04 in bf16 (3.4e-4 and 0.968 in fp32;
    0.017% and 0.9994 at depth 2; no collective in any of these; NVIDIA H100
    80GB HBM3 at 700.00 W). So batches of other shapes are printed beside the
    references, not held to the bars."""
    import datetime

    import torch.distributed as tdist

    from mr_blip_tpu_torch.common import dist as dist_utils
    from mr_blip_tpu_torch.models.layers import Dropout
    from mr_blip_tpu_torch.parallel import mesh
    from mr_blip_tpu_torch.profile_inference import make_samples
    from mr_blip_tpu_torch.runners.train_state import TrainCtx

    dist_utils.init_distributed_mode({"device": "cuda", "dist_backend": "gloo",
                                      "dist_timeout_s": DP_GROUP_TIMEOUT_S})
    rank = dist_utils.get_rank()
    wrappers, _ = kernel_tables()
    model = reduced_model(dist_utils.local_device("cuda"))
    for m in model.module.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    model.set_trainable()
    module = model.module
    trainable = {n: p for n, p in module.named_parameters() if p.requires_grad}
    masters = {n: p.detach().clone() for n, p in trainable.items()}
    mesh.assert_replicated(masters, "phase 22: the depth-2 model as built")
    rows = []
    for r, window in enumerate(DP_WINDOWS):
        row = make_samples(1, N_FRAMES, seed=220 + r)
        row["relevant_windows"], row["query_id"] = [window], [f"q{r}"]
        rows.append(row)

    def restore():
        with torch.no_grad():
            for n, p in trainable.items():
                p.copy_(masters[n])
                p.grad = None

    def update(samples, alone=False, rows_one_by_one=False):
        """One update from the masters (``alone``: no collective; with
        ``rows_one_by_one`` ``samples`` is a list of rows, each a forward
        and backward of its own, their loss sums over all their tokens);
        returns (loss, gradients, post-update tensors, seconds, launches)."""
        restore()
        ctx = TrainCtx(model, weight_decay=TRAIN_WEIGHT_DECAY, seed=0)
        ctx.distributed = ctx.distributed and not alone
        ctx.set_lr(TRAIN_LR)
        grads, optimizer_step = {}, ctx.optimizer.step

        def snapshot(*a, **k):
            grads.update({n: p.grad.detach().float().clone() for n, p in trainable.items()})
            return optimizer_step(*a, **k)

        ctx.optimizer.step = snapshot
        before = {k: w.launches for k, w in wrappers.items()}
        torch.cuda.synchronize()
        start = time.time()
        if rows_one_by_one:
            batches = [model.prepare_mr_batch(r) for r in samples]
            count = sum(int(b["target_mask"].sum()) for b in batches)
            model.train()
            loss = 0.0
            for b in batches:
                total, _ = model.loss_terms(b)
                (total / count).backward()
                loss += float(total.detach()) / count
            for group in ctx.optimizer.param_groups:
                group["lr"] = TRAIN_LR
            ctx.optimizer.step()
            ctx.optimizer.zero_grad(set_to_none=True)
        else:
            loss = ctx.step(model.prepare_mr_batch(samples))
        torch.cuda.synchronize()
        took = time.time() - start
        launched = {k: w.launches - before[k] for k, w in wrappers.items()
                    if w.launches - before[k]}
        post = {n: p.detach().clone() for n, p in trainable.items()}
        del ctx.optimizer.step
        return loss, grads, post, took, launched

    def compare(run, ref):
        rel, apart = _dp_rel(torch, run[2], ref[2])
        names = list(ref[1])
        norms = {n: float(ref[1][n].norm()) for n in names}
        return {"loss": run[0], "loss_ref": ref[0], "loss_rel": abs(run[0] - ref[0]) / abs(ref[0]),
                "tensor_rel": rel, "apart": apart, "seconds_ref": round(ref[3], 3),
                # the whole gradient; per tensor only where the tensor's
                # gradient is not noise (a key bias's is zero in exact math)
                "grad_cos": cosine(torch, torch.cat([run[1][n].flatten() for n in names]),
                                   torch.cat([ref[1][n].flatten() for n in names])),
                "grad_cos_tensor": min(cosine(torch, run[1][n], ref[1][n]) for n in names
                                       if norms[n] >= 1e-3 * max(norms.values()))}

    def shares(frames):
        """sp's encode_frames in one process: the shares one after the other."""
        b, t = frames.shape[:2]
        flat = frames.reshape((b * t,) + frames.shape[2:])
        q = torch.cat([module.encode_flat(flat[slice(*mesh.frame_share(b * t, r, DP_RANKS))])
                       for r in range(DP_RANKS)])
        return q.reshape(b, t * q.shape[1], model.t5_config.d_model)

    out = {}
    # dp: each rank its row; rank 0 then both rows in one process
    dp = update(rows[rank])
    out["dp"] = {"seconds": round(dp[3], 3), "launches": dp[4],
                 "fingerprint": mesh.assert_replicated(dp[2], "phase 22 dp"),
                 "tokens": [int(model.prepare_mr_batch(r)["target_mask"].sum()) for r in rows]}
    if rank == 0:
        dp_ref = update(rows, alone=True, rows_one_by_one=True)
        out["dp"].update(compare(dp, dp_ref))
        dp_batch = update(_dp_samples(rows), alone=True)
        out["dp"]["batch_of_2"] = compare(dp, dp_batch)
    dist_utils.barrier()
    # sp: the same row on both ranks, the frames shared out
    vit_frames = []
    hook = module.visual_encoder.register_forward_pre_hook(
        lambda mod, args: vit_frames.append(int(args[0].shape[0])))
    module.sequence_parallel = True
    sp = update(rows[0])
    hook.remove()
    out["sp"] = {"seconds": round(sp[3], 3), "vit_frames": vit_frames,
                 "fingerprint": mesh.assert_replicated(sp[2], "phase 22 sp")}
    restore()
    torch.cuda.synchronize()
    start = time.time()
    spans = model.generate(rows[1])["raw_prediction"]
    torch.cuda.synchronize()
    out["sp"]["generate_s"] = round(time.time() - start, 3)
    if rank == 0:
        module.sequence_parallel = False
        module.encode_frames = shares
        start = time.time()
        want = model.generate(rows[1])["raw_prediction"]
        torch.cuda.synchronize()
        generate_ref_s = time.time() - start
        out["sp"].update(compare(sp, update(rows[0], alone=True)),
                         spans_equal=spans == want, generate_ref_s=generate_ref_s)
        del module.encode_frames  # one pass over the 60 frames
        out["sp"]["one_pass"] = compare(sp, update(rows[0], alone=True))
        out["sp"]["one_pass"]["spans_equal"] = spans == model.generate(rows[1])["raw_prediction"]
    dist_utils.barrier()
    tdist.destroy_process_group()
    # NCCL at world size 1: rank 0's batch of both rows through a one-rank group
    if rank == 0:
        # a store of this process's own: a tcp:// rendezvous would look for
        # torchrun's agent store (TORCHELASTIC_USE_AGENT_STORE) and wait
        tdist.init_process_group("nccl", store=tdist.HashStore(), world_size=1, rank=0,
                                 timeout=datetime.timedelta(seconds=DP_GROUP_TIMEOUT_S))
        nccl = update(_dp_samples(rows))
        out["nccl"] = dict(compare(nccl, dp_batch), backend=tdist.get_backend(),
                           version=".".join(map(str, torch.cuda.nccl.version())),
                           bit_equal=all(torch.equal(nccl[2][n], t)
                                         for n, t in dp_batch[2].items()))
        tdist.destroy_process_group()
    (Path(workdir) / f"step_rank{rank}.json").write_text(json.dumps(out))


# -------------------------------------------------------------- phase 26
def check_row_product(torch):
    """``layers._RowProduct``'s card branch (bf16 operands, ``torch.mm``
    with an fp32 ``out_dtype``: a row-parallel shard's partial product) at
    a tp=2 rank's FFN output shape (4 x 2,056 rows, 2,560 of the 5,120
    inputs, 2,048 outputs): forward against the fp32 product of the same
    bf16 operands, backward against ``F.linear``'s on them. Returns
    (forward, input-gradient, weight-gradient) max |diff| / max |want|."""
    from mr_blip_tpu_torch.models.layers import _RowProduct

    gen = torch.Generator(device="cuda").manual_seed(27)
    x = torch.randn(BATCH, 2056, 2560, generator=gen, device="cuda").bfloat16()
    w = (0.02 * torch.randn(2048, 2560, generator=gen, device="cuda")).bfloat16()
    dy = torch.randn(BATCH, 2056, 2048, generator=gen, device="cuda")
    leaves = [t.clone().requires_grad_() for t in (x, w, x, w)]
    y = _RowProduct.apply(leaves[0], leaves[1])
    y.backward(dy)
    torch.nn.functional.linear(leaves[2], leaves[3]).backward(dy.bfloat16())
    want = x.float() @ w.float().t()

    def rel(got, ref):
        return float((got.float() - ref.float()).abs().max() / ref.float().abs().max())

    errs = (rel(y.detach(), want), rel(leaves[0].grad, leaves[2].grad),
            rel(leaves[1].grad, leaves[3].grad))
    require(y.dtype == torch.float32 and errs[0] <= TP_ROW_PRODUCT_REL_TOL
            and max(errs[1:]) <= GRAD_REL_TOL,
            f"phase 26 (a): _RowProduct on the card off by {errs} (dtype {y.dtype})")
    del x, w, dy, leaves, y, want
    torch.cuda.empty_cache()
    return errs


def tp_entry_point(torch, card, main_summary, pp_ranks):
    """Phase 26 (a): tensor parallelism, two ranks of one tensor-parallel
    group (tp=2, dp=1) on the one card over gloo, this script as the worker
    (``--dp-worker tp``): phase 4's model (full depth and width, seed 0) in
    fp32 against one process, beside a one-process noise baseline; the
    depth-2 model in bf16 and fp32 against one process, bf16 beside two
    planted faults; ``train/qvh.yaml`` under
    ``run.tp=2`` (see the module docstring). Prints every number, then
    holds them. Returns rank 0's launches over the train entry point's run."""
    import tempfile

    from mr_blip_tpu_torch.datasets.synthetic import make_mr_annotations

    phase_start = time.time()
    gc.collect()
    torch.cuda.empty_cache()
    row_errs = check_row_product(torch)
    say(f"tp row-parallel partial product on the card (layers._RowProduct, bf16 operands, "
        f"fp32 out, {BATCH} x 2,056 x 2,560 by 2,048): forward max |diff| / max |fp32 product| "
        f"{row_errs[0]:.2e} (bar {TP_ROW_PRODUCT_REL_TOL}), backward against F.linear's: "
        f"input {row_errs[1]:.2e}, weight {row_errs[2]:.2e} (bar {GRAD_REL_TOL})")
    with tempfile.TemporaryDirectory() as tmp:
        paths = make_mr_annotations(
            f"{tmp}/run", n_train=TP_QUERIES, n_val=1, n_test=1,
            n_video_frames=EVAL_VIDEO_FRAMES, fps=EVAL_FPS)
        argv = ["--cfg-path", str(ROOT / "configs/projects/train/qvh.yaml"), "--options",
                *(f"datasets.qvh.build_info.annotations.{split}.storage={path}"
                  for split, path in paths.items()),
                "datasets.qvh.build_info.videos.storage=synthetic",
                f"run.output_dir={Path(tmp) / 'train'}", "run.max_epoch=1",
                "run.test_splits=[]", f"model.max_new_tokens={TP_NEW_TOKENS}",
                f"run.accum_grad_iters={TP_QUERIES}", "run.dist_backend=gloo",
                f"run.dist_timeout_s={DP_GROUP_TIMEOUT_S}", f"run.tp={TP_SIZE}"]
        t0 = time.time()
        dp_launch("tp", tmp, *argv, phase=26)
        wall = time.time() - t0
        ranks = dp_read(tmp, "tp")
        train = dp_read(tmp, "tp_train")
    full = [r["full"] for r in ranks]
    ref = full[0]
    d2 = {dtype: ranks[0][dtype] for dtype in TP_DEPTH2_DTYPES}
    seconds = [rank["seconds"] for rank in train]
    say(f"tp at full depth in float32 (phase 4's model, seed 0, {TP_FULL_ROWS} x {N_FRAMES} "
        f"frames, {TP_SIZE} ranks of one tensor-parallel group on one card over gloo, "
        f"{TP_HEADS} heads a rank), the encoder states and the first decode step's logits "
        f"against one process (rank 0 alone, unsharded): encoder states cosine "
        f"{ref['tp']['enc_cos']:.9f}, logits cosine {ref['tp']['logits_cos']:.9f} (max |diff| "
        f"{ref['tp']['logits_err']:.2e} of {ref['logits_max']:.4f}), top-1 equal "
        f"{ref['tp']['top1_equal']}; the noise baseline, one process with its o and wo sums "
        f"split in two as tp splits them: encoder states cosine {ref['split']['enc_cos']:.9f}, "
        f"logits cosine {ref['split']['logits_cos']:.9f} (max |diff| "
        f"{ref['split']['logits_err']:.2e}), top-1 equal {ref['split']['top1_equal']}; the "
        f"ranks' logits bit-equal {full[0]['logits_sha'] == full[1]['logits_sha']}; launches a "
        f"rank {ref['launches']}; one process {ref['seconds_ref']:.3f} s; fp32 weights "
        + ", ".join(f"{f['weight_gib']:.2f}" for f in full) + " GiB a rank")
    for r, f in enumerate(full):
        say(f"tp rank {r} collectives (the fp32 encoder and one teacher-forced decoder step of "
            f"{TP_FULL_ROWS} x {N_FRAMES} with a synchronize around each collective, "
            f"{f['tapped_seconds']:.3f} s): "
            + "; ".join(f"{c['kind']} of {c['numel']:,} elements x{c['count']}: "
                        f"{c['ms']:.3f} ms each" for c in f["collectives"])
            + f"; all-reduce ms per encoder layer {f['encoder_ms_per_layer']:.3f}, per "
            f"decoder layer and step {f['decode_ms_per_layer_step']:.3f}")
    for dtype, res in d2.items():
        say(f"tp depth {REDUCED_DEPTH} in {dtype} (full width, dropout 0, 1 x {N_FRAMES} "
            f"frames) against one process (rank 0 alone, unsharded): beams equal "
            f"{res['seqs_equal']}, scores max |diff| {res['score_err']:.2e}; one LoRA update: "
            f"loss {res['loss']:.6f} vs {res['loss_ref']:.6f} (rel {res['loss_rel']:.2e}), "
            f"gradient cosine {res['grad_cos']:.6f}, post-update max |diff| / max |tensor| "
            f"{res['tensor_rel']:.2e}, share more than the lr apart {res['apart']:.2e}; "
            f"seconds tp {[r[dtype]['update_s'] for r in ranks]} vs one process "
            f"{res['seconds_ref']}")
    for fault, res in d2["bfloat16"]["faults"].items():
        say(f"tp depth {REDUCED_DEPTH} bf16 with a planted fault ({fault}): loss rel "
            f"{res['loss_rel']:.2e} (bar {TP_BF16_LOSS_REL}), gradient cosine "
            f"{res['grad_cos']:.6f} (bar {TP_BF16_COSINE_MIN})")
    say(f"tp train entry point (configs/projects/train/qvh.yaml, run.tp={TP_SIZE}, "
        f"{TP_QUERIES} micro-batches of 1 x {N_FRAMES} on both ranks, one update, 1 val "
        f"query, {TP_NEW_TOKENS} new tokens): launches a micro-batch "
        f"{[{k: v for k, v in x.items() if v} for x in train[0]['steps']]}, a generate "
        f"{[{k: v for k, v in x.items() if v} for x in train[0]['generates']]}; losses "
        f"{[round(x, 4) for x in train[0]['losses']]}; seconds per micro-batch "
        + "; ".join(f"rank {r} {[round(x, 3) for x in sec]}" for r, sec in enumerate(seconds))
        + "; peak " + ", ".join(f"rank {r} {rank['peak_gib']:.2f} GiB"
                                for r, rank in enumerate(train))
        + "; worker parts (s) " + ", ".join(f"rank {r} {rank['parts']}"
                                            for r, rank in enumerate(ranks))
        + f"; launch {wall:.1f} s; phase 26 (a) {time.time() - phase_start:.1f} s; "
        f"phase 4 steady {main_summary['steady_s']:.3f} s a batch; {card}")
    require(full[0]["logits_sha"] == full[1]["logits_sha"],
            "phase 26 (a): the ranks' full-depth logits differ")
    require(min(ref["tp"]["enc_cos"], ref["tp"]["logits_cos"]) >= TP_FULL_COSINE_MIN,
            f"phase 26 (a) full depth fp32 against one process: {ref}")
    for dtype in TP_DEPTH2_DTYPES:
        require(all(r[dtype]["seqs"] == ranks[0][dtype]["seqs"]
                    and r[dtype]["scores"] == ranks[0][dtype]["scores"] for r in ranks)
                and all(math.isfinite(x) for x in ranks[0][dtype]["scores"]),
                f"phase 26 (a): the ranks' depth-2 {dtype} beams differ or are not finite")
    fp32, bf16 = d2["float32"], d2["bfloat16"]
    require(fp32["seqs_equal"] and fp32["score_err"] <= FP32_PATH_REL_TOL
            and fp32["loss_rel"] <= FP32_PATH_REL_TOL and fp32["grad_cos"] >= TP_FP32_COSINE_MIN
            and fp32["tensor_rel"] <= DP_TENSOR_REL_TOL and fp32["apart"] <= DP_APART_MAX,
            f"phase 26 (a) depth {REDUCED_DEPTH} fp32 against one process: {fp32}")
    require(bf16["loss_rel"] <= TP_BF16_LOSS_REL and bf16["grad_cos"] >= TP_BF16_COSINE_MIN
            and bf16["tensor_rel"] <= DP_TENSOR_REL_TOL,
            f"phase 26 (a) depth {REDUCED_DEPTH} bf16 against one process: {bf16}")
    for fault, res in bf16["faults"].items():
        require(res["loss_rel"] > TP_BF16_LOSS_REL or res["grad_cos"] < TP_BF16_COSINE_MIN,
                f"phase 26 (a): the bf16 bars pass a planted fault ({fault}): {res}")
    for dtype in TP_DEPTH2_DTYPES:
        require(len({r[dtype]["fingerprint"] for r in ranks}) == 1, f"phase 26 (a): the "
                f"ranks' trainable tensors differ after the depth-2 {dtype} update")
    for r, rank in enumerate(train):
        require(rank["tp"] == TP_SIZE and len(rank["steps"]) == TP_QUERIES
                and rank["updates"] == 1, f"phase 26 (a) rank {r}: tp {rank['tp']}, "
                f"{len(rank['steps'])} micro-batches, {rank['updates']} updates")
        for i, launched in enumerate(rank["steps"]):
            require(launched == EXPECTED_REMAT_TRAIN_LAUNCHES, f"phase 26 (a) rank {r} "
                    f"micro-batch {i}: launches {launched}")
        for i, launched in enumerate(rank["generates"]):
            require(launched == EXPECTED_LAUNCHES, f"phase 26 (a) rank {r} generate {i}: "
                    f"launches {launched}")
        require(rank["frozen_equal"] and rank["moved"] and all(
            math.isfinite(x) for x in rank["losses"]), f"phase 26 (a) rank {r}: frozen "
            f"equal {rank['frozen_equal']}, unmoved {rank['unmoved']}, losses {rank['losses']}")
    require(len({rank["fingerprint"] for rank in train}) == 1
            and train[0]["losses"] == train[1]["losses"],
            "phase 26 (a): the ranks' trainable tensors or losses differ after the run")
    pp_ranks[:] = [r["pp"] for r in ranks]
    for split, rows in train[0]["rows"].items():
        require(rows["merged"] == rows["unique"] == 1, f"phase 26 (a) {split} rows {rows}")
    say(f"tp gates passed: at full depth in fp32 encoder states and first-step logits "
        f"cosine >= {TP_FULL_COSINE_MIN}, the ranks' logits bit-equal; at depth "
        f"{REDUCED_DEPTH} in fp32 beams equal, scores and loss within {FP32_PATH_REL_TOL}, "
        f"gradient cosine >= {TP_FP32_COSINE_MIN}, the update within phase 22's bars, in bf16 "
        f"loss within {TP_BF16_LOSS_REL}, gradient cosine >= {TP_BF16_COSINE_MIN}, and each "
        f"planted fault outside them; the ranks' beams equal; every bf16 launch count as "
        f"one process's; the ranks' tensors bit-equal")
    return train[0]["launches"]


def pipeline_report(pp_ranks, card):
    """Phase 27 (run in phase 26 (a)'s launch, ``pp_worker_part``): prints
    every number per rank, then holds the bars. Returns rank 0's launches
    over the M = 4 pipelined LoRA step and the no-grad forward."""
    bf16, fp32 = [r["bf16"] for r in pp_ranks], [r["fp32"] for r in pp_ranks]

    def whole(runs, m):
        """The rank shares of one run combined."""
        parts = [r[f"M{m}"] for r in runs]
        dot, g2, r2 = (sum(p[k] for p in parts) for k in ("dot", "g2", "r2"))
        return dict(parts[0], grad_cos=dot / math.sqrt(g2 * r2),
                    grad_rel=max(p["grad_diff"] for p in parts)
                    / max(p["grad_max"] for p in parts),
                    apart=sum(p["apart"] for p in parts) / sum(p["numel"] for p in parts))

    for tag, runs in (("bf16 Flan-T5-XL (24 + 24 layers)", bf16),
                      (f"fp32 depth {REDUCED_DEPTH}", fp32)):
        say(f"pp={PP_SIZE} {tag} at full width, {PP_ROWS} x {PP_ENCODER_LENGTH} encoder "
            f"tokens, {PP_TARGET} decoder tokens, LoRA rank {PP_LORA_RANK}, two gloo ranks on "
            f"one card (each holding its half of the blocks): one process "
            f"{runs[0]['seconds_ref']:.3f} s an update (peak {runs[0]['peak_ref_gib']:.2f} "
            "GiB); weights a rank " + ", ".join(f"{r['weight_gib']:.2f}" for r in runs)
            + " GiB; peak a rank " + ", ".join(f"{r['peak_gib']:.2f}" for r in runs) + " GiB")
        for key in sorted(k for k in runs[0] if k.startswith("M")):
            res = whole(runs, int(key[1:]))
            say(f"  {key}: loss {res['loss']:.6f} vs {res['loss_ref']:.6f} (rel "
                f"{abs(res['loss'] - res['loss_ref']) / abs(res['loss_ref']):.2e}), logits "
                f"cosine {res['logits_cos']:.9f} (max |diff| / max {res['logits_rel']:.2e}), "
                f"LoRA gradient cosine {res['grad_cos']:.9f} (max |diff| / max "
                f"{res['grad_rel']:.2e}), update elements more than the lr apart "
                f"{res['apart']:.2e}; s per pipelined update a rank "
                + ", ".join(f"{r[key]['seconds']:.3f}" for r in runs)
                + "; launches a rank " + "; ".join(str(r[key]["launches"]) for r in runs))
            for r, run in enumerate(runs):
                for stack, transfers in run[key]["wire"].items():
                    by_kind = {}
                    for t in transfers:
                        by_kind.setdefault(t["kind"], []).append(t["ms"])
                    say(f"    rank {r} (stage {r}) {stack}: " + ", ".join(
                        f"{kind} {len(ms)} x, {statistics.mean(ms):.3f} ms each (max "
                        f"{max(ms):.3f})" for kind, ms in by_kind.items())
                        + f"; {transfers[0]['bytes'] / 2**20:.1f} MiB the first")
    say(f"pp bf16 no-grad pipelined forward (M={PP_MICROBATCHES[0]}): logits cosine "
        f"{bf16[0]['nograd_cos']:.9f}; launches a rank "
        + "; ".join(str(r["nograd_launches"]) for r in bf16))
    for fault, cos in bf16[0]["faults"].items():
        say(f"pp bf16 with a planted fault ({fault}): logits cosine {cos:.6f} (bar "
            f"{PP_BF16_COSINE_MIN})")
    layers = 24 // PP_SIZE
    for tag, runs in (("bf16", bf16), ("fp32", fp32)):
        for key in (k for k in runs[0] if k.startswith("M")):
            m, res = int(key[1:]), whole(runs, int(key[1:]))
            loss_rel = abs(res["loss"] - res["loss_ref"]) / abs(res["loss_ref"])
            if tag == "bf16":
                require(res["logits_cos"] >= PP_BF16_COSINE_MIN and loss_rel <= PP_BF16_LOSS_REL
                        and res["grad_cos"] >= PP_BF16_GRAD_COSINE_MIN,
                        f"phase 27 bf16 {key} against one process: {res}")
                want = {"flash_bias_fwd_stats": layers * m, "flash_bias_bwd_dq": layers * m,
                        "flash_bias_bwd_dkv": layers * m}
                for r, run in enumerate(runs):
                    require(run[key]["launches"] == want, f"phase 27 rank {r} {key}: launches "
                            f"{run[key]['launches']}, want {want}")
            else:
                require(res["logits_rel"] <= PP_FP32_REL and loss_rel <= PP_FP32_REL
                        and res["grad_rel"] <= PP_FP32_REL and res["apart"] <= DP_APART_MAX,
                        f"phase 27 fp32 {key} against one process: {res}")
            require(math.isfinite(res["loss"]), f"phase 27 {tag} {key}: loss {res['loss']}")
    require(bf16[0]["nograd_cos"] >= PP_BF16_COSINE_MIN,
            f"phase 27: the no-grad pipelined forward's logits cosine {bf16[0]['nograd_cos']}")
    for r, run in enumerate(bf16):
        want = {"flash_bias_attention": layers * PP_MICROBATCHES[0]}
        require(run["nograd_launches"] == want, f"phase 27 rank {r} no-grad forward: "
                f"launches {run['nograd_launches']}, want {want}")
    for fault, cos in bf16[0]["faults"].items():
        require(cos < PP_BF16_COSINE_MIN, f"phase 27: the bf16 bar passes a planted fault "
                f"({fault}): cosine {cos}")
    say(f"pp gates passed: bf16 at full depth logits cosine >= {PP_BF16_COSINE_MIN}, loss "
        f"within {PP_BF16_LOSS_REL}, LoRA gradient cosine >= {PP_BF16_GRAD_COSINE_MIN} at M = "
        f"{', '.join(map(str, PP_MICROBATCHES))}, each planted fault outside the logits bar, "
        f"kernels 5, 6 and 8 {layers} x M launches a rank an update, kernel 3 {layers} x M a "
        f"no-grad forward; fp32 at depth {REDUCED_DEPTH} within {PP_FP32_REL}; {card}")
    step, nograd = bf16[0][f"M{PP_MICROBATCHES[-1]}"]["launches"], bf16[0]["nograd_launches"]
    return {k: step.get(k, 0) + nograd.get(k, 0) for k in {*step, *nograd}}


def cosine64(torch, got, want):
    """``cosine`` in float64 (fp32 sums over millions of elements drift)."""
    return float(torch.nn.functional.cosine_similarity(
        got.double().flatten(), want.double().flatten(), dim=0))


@contextlib.contextmanager
def split_row_sums(torch, model, parts=TP_SIZE):
    """The T5's row-parallel layers (``o``, ``wo``) computing their product
    as ``parts`` fp32 partial products over slices of the input features,
    summed and rounded once: tensor parallelism's order for those sums, in
    one process (a noise baseline for its rounding)."""
    from mr_blip_tpu_torch.models.t5 import T5Attention, T5FeedForward

    denses = [m.o if isinstance(m, T5Attention) else m.wo for m in model.module.t5.modules()
              if isinstance(m, (T5Attention, T5FeedForward))]

    def split(dense):
        def forward(x):  # layers.Dense._forward_tp's row mode, every rank's part
            cdt = dense.compute_dtype
            x, w = x.to(cdt), dense.weight.to(cdt)
            step = x.shape[-1] // parts
            y = 0.0
            for lo in range(0, x.shape[-1], step):
                part = x[..., lo:lo + step].float() @ w[:, lo:lo + step].float().t()
                if dense.lora_rank:
                    delta = (dense.lora_dropout(x[..., lo:lo + step])
                             @ dense.lora_a[lo:lo + step].to(cdt)) @ dense.lora_b.to(cdt)
                    part = part + (delta * dense.lora_scaling).to(part.dtype)
                y = y + part
            return y.to(cdt)
        return forward

    for dense in denses:
        require(dense.bias is None and dense.tp is None, "split_row_sums: a biased or "
                "sharded row-parallel layer")
        dense.forward = split(dense)
    try:
        yield
    finally:
        for dense in denses:
            del dense.forward


def tp_full_depth(torch, dev, rank, group, counts):
    """Phase 26 (a) (1), one rank: phase 4's model (seed 0, full depth and
    width) in fp32 on TP_FULL_ROWS rows of 60 frames, the encoder states and
    the first decode step's logits (``first_step``). Rank 0 first runs them
    on the whole model alone (no collective), plain and with the
    row-parallel sums split as tensor parallelism splits them
    (``split_row_sums``); then both ranks shard the model and run them with
    every collective timed; rank 0 compares."""
    import hashlib

    import torch.distributed as tdist

    from mr_blip_tpu_torch.common import dist as dist_utils
    from mr_blip_tpu_torch.profile_inference import make_samples

    samples = make_samples(TP_FULL_ROWS, N_FRAMES, 0, 224)
    model = flagship_model(dev, compute_dtype="float32")
    if rank == 0:
        torch.cuda.synchronize()
        t0 = time.time()
        ref = first_step(torch, model, samples)
        ref_s = time.time() - t0
        with split_row_sums(torch, model):
            base = first_step(torch, model, samples)
    dist_utils.barrier()
    model.set_tensor_parallel(group)
    gc.collect()
    torch.cuda.empty_cache()
    weight_gib = sum(t.numel() * t.element_size() for t in
                     (*model.module.parameters(), *model.module.buffers())) / 2**30
    seen = []
    real = {"all_reduce": tdist.all_reduce, "all_gather": tdist.all_gather}

    def timed(kind):
        def call(*a, **k):
            torch.cuda.synchronize()
            start = time.perf_counter()
            result = real[kind](*a, **k)
            torch.cuda.synchronize()
            seen.append((kind, a[0].numel() if kind == "all_reduce" else a[1].numel(),
                         time.perf_counter() - start))
            return result
        return call

    before = counts()
    tdist.all_reduce, tdist.all_gather = timed("all_reduce"), timed("all_gather")
    try:
        torch.cuda.synchronize()
        t0 = time.time()
        mine = first_step(torch, model, samples)
        tapped_s = time.time() - t0
    finally:
        tdist.all_reduce, tdist.all_gather = real["all_reduce"], real["all_gather"]
    launches = {k: v - before[k] for k, v in counts().items() if v - before[k]}
    groups = {}
    for kind, numel, took in seen:
        groups.setdefault((kind, numel), []).append(took)
    collectives = sorted(({"kind": k, "numel": n, "count": len(t),
                           "ms": 1e3 * statistics.mean(t)} for (k, n), t in groups.items()),
                         key=lambda c: -c["count"] * c["ms"])
    cfg = model.t5_config
    # The encoder's two all-reduces a layer (o, wo) over (B, L, d_model), the
    # decoder's three a layer (self o, cross o, wo) over its rows for the
    # one step, the logits' gather.
    encoder = [c for c in collectives if c["kind"] == "all_reduce"
               and c["count"] == 2 * cfg.num_layers]
    decode = [c for c in collectives if c["kind"] == "all_reduce" and c not in encoder]
    out = {"launches": launches, "tapped_seconds": tapped_s, "weight_gib": weight_gib,
           "logits_sha": hashlib.sha256(mine["logits0"].numpy().tobytes()).hexdigest(),
           "collectives": collectives[:6],
           "encoder_ms_per_layer": 2 * sum(c["ms"] * c["count"] for c in encoder)
           / max(1, sum(c["count"] for c in encoder)),
           "decode_ms_per_layer_step": 3 * sum(c["ms"] * c["count"] for c in decode)
           / max(1, sum(c["count"] for c in decode))}
    if rank == 0:
        want = ref["logits0"]
        for key, run in (("tp", mine), ("split", base)):
            out[key] = {"enc_cos": cosine64(torch, run["enc0"], ref["enc0"]),
                        "logits_cos": cosine64(torch, run["logits0"], want),
                        "logits_err": float((run["logits0"] - want).abs().max()),
                        "top1_equal": bool((run["logits0"].argmax(-1)
                                            == want.argmax(-1)).all())}
        out.update(logits_max=float(want.abs().max()), seconds_ref=ref_s)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tp_depth2(torch, dev, rank, group, compute_dtype):
    """Phase 26 (a) (2), one rank: the depth-2 model at full width in
    ``compute_dtype``, dropout 0, sharded over ``group``: a 1 x 60 generate
    and one LoRA update (in bf16 then again under each planted fault: the
    partial LoRA gradients, or the row-parallel partial products, not
    summed over the group); rank 0 also runs both on the unsharded model
    alone (no collective) and compares."""
    from mr_blip_tpu_torch.models import layers
    from mr_blip_tpu_torch.models.layers import Dropout
    from mr_blip_tpu_torch.parallel import mesh
    from mr_blip_tpu_torch.parallel import tensor as tensor_parallel
    from mr_blip_tpu_torch.profile_inference import make_samples
    from mr_blip_tpu_torch.runners.train_state import TrainCtx

    def no_dropout(m):
        for mod in m.module.modules():
            if isinstance(mod, Dropout):
                mod.rate = 0.0
        return m

    row = make_samples(1, N_FRAMES, seed=260)
    row["relevant_windows"], row["query_id"] = [DP_WINDOWS[1]], ["q26"]
    small = no_dropout(reduced_model(dev, compute_dtype=compute_dtype,
                                     max_new_tokens=TP_NEW_TOKENS))
    ref = no_dropout(reduced_model(dev, compute_dtype=compute_dtype,
                                   max_new_tokens=TP_NEW_TOKENS)) if rank == 0 else None
    small.set_tensor_parallel(group)

    def generate(m):
        h = m.generate_dispatch(row)
        return h["seqs"].cpu().tolist(), h["scores"].float().cpu().tolist()

    def update(m, alone):
        """(loss, gradients, tensors after, seconds) of one update from the
        model's tensors as they are, which it puts back after."""
        ctx = TrainCtx(m, weight_decay=TRAIN_WEIGHT_DECAY, seed=0)
        if alone:
            ctx.distributed = False
        ctx.set_lr(TRAIN_LR)
        start_state = {n: p.detach().clone() for n, p in ctx.named_params.items()}
        grads, optimizer_step = {}, ctx.optimizer.step

        def snapshot(*a, **k):
            grads.update({n: p.grad.detach().float().clone()
                          for n, p in ctx.named_params.items()})
            return optimizer_step(*a, **k)

        ctx.optimizer.step = snapshot
        torch.cuda.synchronize()
        start = time.time()
        loss = ctx.step(m.prepare_mr_batch(row))
        torch.cuda.synchronize()
        took = round(time.time() - start, 3)
        after = {n: p.detach().clone() for n, p in ctx.named_params.items()}
        with torch.no_grad():
            for n, p in ctx.named_params.items():
                p.copy_(start_state[n])
        return loss, grads, after, took

    def compare(run, ref_run):
        names = list(ref_run[1])
        return {"loss_rel": abs(run[0] - ref_run[0]) / abs(ref_run[0]),
                "grad_cos": cosine(torch, torch.cat([run[1][n].flatten() for n in names]),
                                   torch.cat([ref_run[1][n].flatten() for n in names]))}

    seqs, scores = generate(small)
    tp_run = update(small, alone=False)
    out = {"update_s": tp_run[3], "seqs": seqs, "scores": scores,
           "fingerprint": mesh.assert_replicated(tp_run[2], "phase 26 (a) update")}
    faults = {}
    if compute_dtype == "bfloat16":
        summed = tensor_parallel.reduce_partial_grads
        tensor_parallel.reduce_partial_grads = lambda params, group: None
        try:
            faults["the partial gradients not summed over the group"] = update(small, False)
        finally:
            tensor_parallel.reduce_partial_grads = summed
        reduced = layers.reduce_from_tp
        layers.reduce_from_tp = lambda x, group: x
        try:
            faults["the row-parallel partial products not summed"] = update(small, False)
        finally:
            layers.reduce_from_tp = reduced
    if rank == 0:
        ref_seqs, ref_scores = generate(ref)
        ref_run = update(ref, alone=True)
        rel, apart = _dp_rel(torch, tp_run[2], ref_run[2])
        out.update(seqs_equal=seqs == ref_seqs,
                   score_err=max(abs(a - b) for a, b in zip(scores, ref_scores)),
                   loss=tp_run[0], loss_ref=ref_run[0], tensor_rel=rel, apart=apart,
                   seconds_ref=ref_run[3], faults={
                       name: compare(run, ref_run) for name, run in faults.items()},
                   **compare(tp_run, ref_run))
    return out

# -------------------------------------------------------------- phase 27
def pp_fill(torch, model, cfg, n_stages, stage):
    """Every tensor of ``model`` (a stage of ``n_stages``, or the whole
    model at 1) drawn from PP_SEED and its name in the whole model, at the
    scales of HF's T5 init (T5 has no 1/sqrt(d) in its attention, so ``q``
    carries it: N(0, 1/(d_model·d_kv))): RMSNorm weights 1, the shared
    embedding N(0, 1), the rel-pos tables N(0, 0.5), ``lora_b`` N(0, 0.01),
    every other matrix N(0, 1/fan-in)."""
    import zlib

    from mr_blip_tpu_torch.models.t5_pipeline import global_name

    with torch.no_grad():
        for name, t in model.state_dict().items():
            whole = global_name(name, cfg, n_stages, stage)
            parent, leaf = whole.rsplit(".", 2)[-2:]
            if whole.endswith("norm.weight"):
                t.fill_(1.0)
                continue
            std = {"rel_embedding": 0.5, "lora_b": 0.01}.get(leaf)
            if std is None:
                std = (1.0 if whole.startswith("shared.")
                       else t.shape[0 if leaf == "lora_a" else 1] ** -0.5)
                if parent == "q" and leaf == "weight":
                    std *= cfg.d_kv ** -0.5
            gen = torch.Generator(device=t.device)
            gen.manual_seed(PP_SEED * 1_000_003 + zlib.crc32(whole.encode()))
            t.copy_(torch.randn(t.shape, generator=gen, device=t.device) * std)


def pp_model(torch, cfg, dev, dtype, n_stages=1, stage=0):
    """The whole T5 (``n_stages`` 1) or stage ``stage``'s, built on the meta
    device then allocated on ``dev`` (a stage never holds another's blocks),
    filled by ``pp_fill``; the LoRA tensors fp32 masters and trainable, the
    rest frozen; eval mode (the pipelined path runs without dropout)."""
    from mr_blip_tpu_torch.models.t5 import T5ForConditionalGeneration
    from mr_blip_tpu_torch.models.t5_pipeline import build_stage_model

    model = (T5ForConditionalGeneration(cfg, device="meta", dtype=dtype) if n_stages == 1
             else build_stage_model(cfg, n_stages, device="meta", dtype=dtype))
    model = model.to_empty(device=dev)
    pp_fill(torch, model, cfg, n_stages, stage)
    for name, p in model.named_parameters():
        lora = name.rsplit(".", 1)[1] in ("lora_a", "lora_b")
        if lora:
            p.data = p.data.float()
        p.requires_grad_(lora)
    return model.eval()


def pp_inputs(torch, cfg, dev, dtype):
    gen = torch.Generator(device=dev)
    gen.manual_seed(PP_SEED)
    x = torch.randn(PP_ROWS, PP_ENCODER_LENGTH, cfg.d_model, generator=gen,
                    device=dev).to(dtype)
    labels = torch.randint(2, cfg.vocab_size, (PP_ROWS, PP_TARGET), generator=gen, device=dev)
    enc_mask = torch.ones(PP_ROWS, PP_ENCODER_LENGTH, dtype=torch.int32, device=dev)
    enc_mask[1, -7:] = 0
    enc_mask[3, -300:] = 0
    label_mask = torch.ones(PP_ROWS, PP_TARGET, dtype=torch.int32, device=dev)
    label_mask[2, -8:] = 0
    return x, labels, enc_mask, label_mask


def pp_step(torch, model, logits_fn, labels, label_mask):
    """One LoRA AdamW update from the model's tensors as they are: (loss,
    logits, gradients, updated tensors, seconds); the tensors put back."""
    from mr_blip_tpu_torch.models.t5 import cross_entropy_lm_loss

    params = {n: p for n, p in model.named_parameters() if p.requires_grad}
    start = {n: p.detach().clone() for n, p in params.items()}
    opt = torch.optim.AdamW(params.values(), lr=TRAIN_LR, weight_decay=TRAIN_WEIGHT_DECAY)
    torch.cuda.synchronize()
    t0 = time.time()
    logits = logits_fn()
    loss = cross_entropy_lm_loss(logits, labels, label_mask)
    loss.backward()
    opt.step()
    torch.cuda.synchronize()
    took = time.time() - t0
    grads = {n: p.grad.detach().clone() for n, p in params.items()}
    after = {n: p.detach().clone() for n, p in params.items()}
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(start[n])
            p.grad = None
    return float(loss.detach()), logits.detach(), grads, after, took


def pp_compare(torch, rank, names, run, ref):
    """This rank's share of the comparison with one process: sums for the
    gradient cosine (float64), max |diff| and max |ref| of the gradients
    and of the updated tensors, the update's elements apart by more than
    the lr; the logits and loss on rank 0 (every rank holds them)."""
    g, rg = run[2], ref["grads"]
    out = {"dot": 0.0, "g2": 0.0, "r2": 0.0, "grad_diff": 0.0, "grad_max": 0.0,
           "apart": 0, "numel": 0}
    for local, whole in names.items():
        a, b = g[local].double(), rg[whole].to(g[local].device).double()
        out["dot"] += float((a * b).sum())
        out["g2"] += float((a * a).sum())
        out["r2"] += float((b * b).sum())
        out["grad_diff"] = max(out["grad_diff"], float((a - b).abs().max()))
        out["grad_max"] = max(out["grad_max"], float(b.abs().max()))
        u = run[3][local].float()
        ru = ref["after"][whole].to(u.device).float()
        out["apart"] += int(((u - ru).abs() > TRAIN_LR).sum())
        out["numel"] += u.numel()
    if rank == 0:
        logits, want = run[1].float(), ref["logits"].to(run[1].device).float()
        out.update(loss=run[0], loss_ref=ref["loss"],
                   logits_cos=cosine64(torch, logits, want),
                   logits_rel=float((logits - want).abs().max() / want.abs().max()))
    return out


def pp_worker_part(torch, dev, rank, workdir, counts):
    """Phase 27, one rank (in phase 26 (a)'s launch): (a) Flan-T5-XL at full
    depth in bf16, (b) depth 2 in fp32, each against one process (see
    PP_SIZE). Returns the rank's numbers (JSON)."""
    import dataclasses

    import torch.distributed as tdist

    from mr_blip_tpu_torch.common import dist as dist_utils
    from mr_blip_tpu_torch.models.t5 import shift_right, t5_flan_xl_config
    from mr_blip_tpu_torch.models.t5_pipeline import global_name, t5_pipeline_forward
    from mr_blip_tpu_torch.parallel import pipeline

    group = tdist.new_group(list(range(PP_SIZE)))
    full_cfg = t5_flan_xl_config(lora_rank=PP_LORA_RANK, dropout_rate=0.0)
    out = {}
    for tag, cfg, dtype, micro in (
            ("bf16", full_cfg, torch.bfloat16, PP_MICROBATCHES),
            ("fp32", dataclasses.replace(full_cfg, num_layers=REDUCED_DEPTH,
                                         num_decoder_layers=REDUCED_DEPTH),
             torch.float32, PP_MICROBATCHES[:1])):
        x, labels, enc_mask, label_mask = pp_inputs(torch, cfg, dev, dtype)
        dec_ids = shift_right(labels, cfg.decoder_start_token_id, cfg.pad_token_id)
        ref_path = Path(workdir) / f"pp_ref_{tag}.pt"
        res = {}
        if rank == 0:  # one process: the whole model, alone
            torch.cuda.reset_peak_memory_stats(dev)
            whole = pp_model(torch, cfg, dev, dtype)
            loss, logits, grads, after, took = pp_step(
                torch, whole, lambda: whole.decode(dec_ids, whole.encode(x, mask=enc_mask),
                                                   decoder_mask=label_mask,
                                                   encoder_mask=enc_mask),
                labels, label_mask)
            torch.save({"loss": loss, "logits": logits.cpu(),
                        "grads": {n: t.cpu() for n, t in grads.items()},
                        "after": {n: t.cpu() for n, t in after.items()}}, ref_path)
            res.update(seconds_ref=took,
                       peak_ref_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
            del whole, logits, grads, after
            gc.collect()
            torch.cuda.empty_cache()
        dist_utils.barrier()
        ref = torch.load(ref_path, weights_only=True)
        torch.cuda.reset_peak_memory_stats(dev)
        model = pp_model(torch, cfg, dev, dtype, n_stages=PP_SIZE, stage=rank)
        res["weight_gib"] = sum(t.numel() * t.element_size()
                                for t in model.state_dict().values()) / 2**30
        names = {n: global_name(n, cfg, PP_SIZE, rank) for n, p in model.named_parameters()
                 if p.requires_grad and (rank == 0 or ".block." in n)}

        def forward(m, timings=None):
            return t5_pipeline_forward(cfg, model, x, dec_ids, group, encoder_mask=enc_mask,
                                       decoder_mask=label_mask, num_microbatches=m,
                                       compute_dtype=dtype, timings=timings)

        want = ref["logits"].to(dev)
        if tag == "bf16":  # also the warm-up of the steps below
            before = counts()
            with torch.no_grad():
                logits = forward(micro[0])
            res["nograd_launches"] = {k: v - before[k] for k, v in counts().items()
                                      if v - before[k]}
            res["nograd_cos"] = cosine64(torch, logits, want)
        for m in micro:
            timings = {}
            before = counts()
            run = pp_step(torch, model, lambda: forward(m, timings), labels, label_mask)
            launched = {k: v - before[k] for k, v in counts().items() if v - before[k]}
            res[f"M{m}"] = dict(pp_compare(torch, rank, names, run, ref), seconds=run[4],
                                launches=launched, wire={
                                    stack: [dict(t, ms=round(t["ms"], 3)) for t in ts]
                                    for stack, ts in timings.items()})
        if tag == "bf16":
            faults = {}
            blocks = model.encoder.block
            if rank == 1:
                model.encoder.block = torch.nn.ModuleList(list(blocks)[::-1])
            with torch.no_grad():
                faults["rank 1's encoder blocks in reverse order"] = cosine64(
                    torch, forward(micro[0]), want)
            model.encoder.block = blocks
            split = pipeline._split
            pipeline._split = lambda leaves, m: [
                mb if i != 1 else [t * 0 for t in mb] for i, mb in enumerate(split(leaves, m))]
            try:
                with torch.no_grad():
                    faults["microbatch 1 zeroed"] = cosine64(torch, forward(micro[0]), want)
            finally:
                pipeline._split = split
            res["faults"] = faults
        res["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        out[tag] = res
        del model, ref
        gc.collect()
        torch.cuda.empty_cache()
        dist_utils.barrier()
    return out



def pp_worker(torch, workdir):
    """Phase 27 alone (``--dp-worker pp``), one rank: ``pp_worker_part``
    over a two-rank gloo world, its numbers to ``pp_rank<r>.json``."""
    from mr_blip_tpu_torch.common import dist as dist_utils

    dist_utils.init_distributed_mode({"device": "cuda", "dist_backend": "gloo",
                                      "dist_timeout_s": DP_GROUP_TIMEOUT_S})
    wrappers, _ = kernel_tables()
    out = {"pp": pp_worker_part(torch, dist_utils.local_device("cuda"),
                                dist_utils.get_rank(), workdir,
                                lambda: {name: w.launches for name, w in wrappers.items()})}
    (Path(workdir) / f"pp_rank{dist_utils.get_rank()}.json").write_text(json.dumps(out))
    dist_utils.destroy()


def pp_entry_point(torch, card):
    """Phase 27 in a launch of its own (for running it alone; the whole
    script runs it in phase 26 (a)'s launch): returns ``pipeline_report``'s
    launches."""
    import tempfile

    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        dp_launch("pp", tmp, phase=27)
        ranks = dp_read(tmp, "pp")
    return pipeline_report([r["pp"] for r in ranks], card)


def tp_worker(torch, workdir, argv):
    """Phase 26 (a), one rank: (1) ``tp_full_depth``; (2) ``tp_depth2`` in
    bf16 and in fp32; then phase 27 (``pp_worker_part``, the two ranks as
    two pipeline stages); (3) ``train.main(argv)`` under run.tp
    (``dp_train_worker``)."""
    from mr_blip_tpu_torch.common import dist as dist_utils

    dist_utils.init_distributed_mode({"device": "cuda", "dist_backend": "gloo", "tp": TP_SIZE,
                                      "dist_timeout_s": DP_GROUP_TIMEOUT_S})
    rank, group = dist_utils.get_rank(), dist_utils.tp_group()
    dev = dist_utils.local_device("cuda")
    wrappers, _ = kernel_tables()
    out, parts, part_start = {}, {}, time.time()

    def part(name):
        nonlocal part_start
        parts[name] = round(time.time() - part_start, 1)
        part_start = time.time()

    out["full"] = tp_full_depth(torch, dev, rank, group, lambda: {
        name: w.launches for name, w in wrappers.items()})
    part("full depth fp32")
    for dtype in TP_DEPTH2_DTYPES:
        out[dtype] = tp_depth2(torch, dev, rank, group, dtype)
        gc.collect()
        torch.cuda.empty_cache()
    dist_utils.barrier()
    part("depth 2")
    out["pp"] = pp_worker_part(torch, dev, rank, workdir, lambda: {
        name: w.launches for name, w in wrappers.items()})
    part("pp (phase 27)")
    out["parts"] = parts
    (Path(workdir) / f"tp_rank{rank}.json").write_text(json.dumps(out))

    # (3) the train entry point under run.tp
    torch.cuda.reset_peak_memory_stats(dev)
    dp_train_worker(torch, workdir, argv, mode="tp_train")


def dp_server_entry_point(torch, wrappers, card, model, serve_summary):
    """Phase 26 (b): phase 20's model behind the server (batches of 4), then
    the same model with a second replica on the same card behind a server of
    batches of 8 (``set_mesh``: each batch split into two blocks of 4 rows,
    each on its replica's thread and stream), over the same
    DP_SERVE_REQUESTS frame requests and then a ragged DP_SERVE_RAGGED
    (padded to 4, and to 8: its first block is the one model's padded
    batch). Every block has the shape of a one-model batch, so every row
    equals the one model's bit for bit (a block of another shape rounds its
    bf16 products in another order, which 24 random-weight layers amplify).
    Prints requests/s of both beside phase 20's. Returns the replicas'
    launches over their run."""
    import threading

    from mr_blip_tpu_torch.models.blip2_mr import BLIP2_MR
    from mr_blip_tpu_torch.serving import MomentRetrievalServer, MRRequest

    phase_start = time.time()
    videos = make_serving_samples(DP_SERVE_REQUESTS, seed=26)

    def requests(n):
        return [MRRequest(query=f"a person is doing something {i}", duration=150.0,
                          video=videos[i], qid=f"d{i}") for i in range(n)]

    def serve(m, max_batch):
        srv = MomentRetrievalServer(m, max_batch=max_batch, max_wait_ms=DP_SERVE_FORM_WAIT_MS,
                                    batch_buckets=[max_batch], decode_workers=0)
        torch.cuda.synchronize()
        start = time.time()
        got = [f.result(timeout=600) for f in [srv.submit(r) for r in
                                                requests(DP_SERVE_REQUESTS)]]
        full_s = time.time() - start
        got += [f.result(timeout=600) for f in [srv.submit(r) for r in
                                                 requests(DP_SERVE_RAGGED)]]
        srv.close(timeout=600)
        return got, full_s, srv.stats()

    one, one_s, one_st = serve(model, BATCH)
    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    t0 = time.time()
    model.set_mesh([model.device, model.device])
    torch.cuda.synchronize()
    copy_s = time.time() - t0
    copied = torch.cuda.memory_allocated() - resident
    blocks, real = [], BLIP2_MR._generate_prepared
    lock = threading.Lock()

    def tapped(view, batch):
        with lock:
            blocks.append(len(batch["end_ids"]))
        return real(view, batch)

    BLIP2_MR._generate_prepared = tapped
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    try:
        two, two_s, two_st = serve(model, 2 * BATCH)
    finally:
        BLIP2_MR._generate_prepared = real
    launches = {name: w.launches for name, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    model.set_mesh(None)
    n_blocks = 2 * (DP_SERVE_REQUESTS // (2 * BATCH) + 1)
    equal = [a["raw_prediction"] == b["raw_prediction"] and a["prediction"] == b["prediction"]
             for a, b in zip(two, one)]
    say(f"dp server (phase 20's model and a second replica on the same card, set_mesh, "
        f"batches of 8 split 4 + 4, a thread and a stream a replica): {DP_SERVE_REQUESTS} "
        f"requests then a ragged {DP_SERVE_RAGGED} (padded to 8), rows equal to the one "
        f"model's (batches of 4) {sum(equal)} of {len(equal)}; blocks {blocks}; launches "
        f"{ {k: v for k, v in launches.items() if v} } ({n_blocks} blocks); "
        f"requests/s over the {DP_SERVE_REQUESTS}: two replicas "
        f"{DP_SERVE_REQUESTS / two_s:.3f}, one model {DP_SERVE_REQUESTS / one_s:.3f} (same "
        f"server, same requests), phase 20's closed loop {serve_summary['rps']:.3f}; latency "
        f"p50 {two_st.latency_p50_s:.3f} vs {one_st.latency_p50_s:.3f} s; replica copied in "
        f"{copy_s:.1f} s ({copied / 2**30:.2f} GiB); peak {peak / 2**30:.2f} GiB; phase 26 (b) "
        f"{time.time() - phase_start:.1f} s; {card}")
    require(all(equal), f"phase 26 (b): the replicas' rows differ from the one model's: "
            f"{two} vs {one}")
    require(blocks == [BATCH] * n_blocks and two_st.completed == DP_SERVE_REQUESTS
            + DP_SERVE_RAGGED, f"phase 26 (b): blocks {blocks}, {two_st}")
    want = {k: n_blocks * v for k, v in EXPECTED_LAUNCHES.items()}
    require(launches == want, f"phase 26 (b): launches {launches}, expected {want}")
    return launches


def dp_worker(argv):
    """``chip_smoke.py --dp-worker <train|step|tp|pp> <dir> [train argv]``:
    one rank of phase 22 (26, 27) under ``torch.distributed.run``."""
    import os

    import torch

    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(int(os.environ["LOCAL_RANK"]) % torch.cuda.device_count())
    mode, workdir = argv[0], argv[1]
    if mode == "train":
        dp_train_worker(torch, workdir, argv[2:])
    elif mode == "tp":
        tp_worker(torch, workdir, argv[2:])
    elif mode == "pp":
        pp_worker(torch, workdir)
    else:
        dp_step_worker(torch, workdir)


# -------------------------------------------------------------- phase 23
def _hf_t5_name(name):
    """The port's T5 name -> HF ``T5ForConditionalGeneration``'s."""
    if name in ("shared.weight", "lm_head.weight"):
        return name
    side, rest = name.split(".", 1)
    if rest == "rel_bias.rel_embedding":
        return f"{side}.block.0.layer.0.SelfAttention.relative_attention_bias.weight"
    if rest == "final_norm.weight":
        return f"{side}.final_layer_norm.weight"
    _, block, module, leaf = rest.split(".", 3)
    ff = 2 if side == "decoder" else 1
    layer = {"self_attention": "0.SelfAttention", "self_attn_norm": "0.layer_norm",
             "cross_attention": "1.EncDecAttention", "cross_attn_norm": "1.layer_norm",
             "ff": f"{ff}.DenseReluDense", "ff_norm": f"{ff}.layer_norm"}[module]
    return f"{side}.block.{block}.layer.{layer}.{leaf}"


def _blip2_name(name):
    """The port's Q-Former name -> the BLIP-2 stage-2 checkpoint's."""
    if name == "query_tokens":
        return name
    if name.startswith("embeddings_norm."):
        return "Qformer.bert.embeddings.LayerNorm." + name.split(".")[-1]
    _, i, module, rest = name.split(".", 3)
    p = f"Qformer.bert.encoder.layer.{i}."
    if module in ("self_attention", "cross_attention"):
        src = "attention" if module == "self_attention" else "crossattention"
        proj, leaf = rest.split(".")
        if proj in ("query", "key", "value"):
            return f"{p}{src}.self.{proj}.{leaf}"
        return f"{p}{src}.output.{'dense' if proj == 'output' else 'LayerNorm'}.{leaf}"
    return {"intermediate_query": f"{p}intermediate_query.dense.",
            "output_query": f"{p}output_query.dense.",
            "output_query_norm": f"{p}output_query.LayerNorm."}[module] + rest


def reference_sources(state):
    """A ``BLIP2_MR`` state dict as the reference's four sources, in their own
    names, each tensor a copy: the LAVIS EVA ViT-g (``q_bias``/``v_bias``,
    ``patch_embed.proj``), the BLIP-2 stage-2 checkpoint (``Qformer.*``,
    ``query_tokens``, ``ln_vision``, ``t5_proj``), the HF T5, and the PEFT
    LoRA tensors under ``t5_model.`` as the finetuned checkpoint holds them."""
    eva, blip2, t5, finetuned = {}, {}, {}, {}
    for name, value in state.items():
        top, rest = name.split(".", 1)
        value = value.detach().clone()
        if top == "visual_encoder":
            eva[rest.replace("patch_embed.", "patch_embed.proj.")] = value
        elif top in ("ln_vision", "t5_proj"):
            blip2[name] = value
        elif top == "qformer":
            blip2[_blip2_name(rest)] = value
        elif top == "t5" and ".lora_" in rest:
            module, leaf = rest.rsplit(".", 1)
            hf = module if module == "lm_head" else _hf_t5_name(module + ".weight")[:-7]
            finetuned[f"t5_model.base_model.model.{hf}.lora_{leaf[-1].upper()}"
                      ".default.weight"] = value.t().contiguous()
        elif top == "t5":
            t5[_hf_t5_name(rest)] = value
        else:
            raise ValueError(f"no reference source holds {name}")
    return eva, blip2, t5, finetuned


def write_safetensors(torch, path, tensors):
    """The safetensors format (the machine has no package for it): a u64
    header length, the JSON header, the raw bytes."""
    names = {torch.float32: "F32", torch.bfloat16: "BF16", torch.float16: "F16"}
    header, blobs, offset = {}, [], 0
    for name, t in tensors.items():
        data = t.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(data)]}
        blobs.append(data)
        offset += len(data)
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for data in blobs:
            f.write(data)


def reduced_depth_load():
    """Within it, ``load_model`` and ``from_config`` build BLIP2_MR at
    REDUCED_DEPTH (ViT, Q-Former and T5), full widths."""
    import contextlib
    import dataclasses

    from mr_blip_tpu_torch.models import blip2_mr

    @contextlib.contextmanager
    def patched():
        saved = (blip2_mr.BLIP2_MR.VIT_CONFIGS, blip2_mr.BLIP2_MR.T5_CONFIGS,
                 blip2_mr.qformer_base_config)
        blip2_mr.BLIP2_MR.VIT_CONFIGS = {"eva_vit_g": reduced_vit_config}
        blip2_mr.BLIP2_MR.T5_CONFIGS = {"flan-t5-xl": reduced_t5_config}
        blip2_mr.qformer_base_config = lambda *a, **kw: dataclasses.replace(
            saved[2](*a, **kw), num_layers=REDUCED_DEPTH)
        try:
            yield
        finally:
            (blip2_mr.BLIP2_MR.VIT_CONFIGS, blip2_mr.BLIP2_MR.T5_CONFIGS,
             blip2_mr.qformer_base_config) = saved

    return patched()


def fmr_samples(samples):
    """``make_samples`` with the frame-level baseline's inputs."""
    b, t = samples["video"].shape[:2]
    return dict(samples, loc_input=["Question: a person is doing something "
                                    "interesting? Is this frame relevant?"] * b,
                qa_output=["_".join(["no"] * t)] * b)


def import_round_trip(torch, wrappers, card):
    """Phase 23 (a): phase 4's flagship model through the reference's sources
    and back, in memory. Returns the model (its weights are phase 4's)."""
    from mr_blip_tpu_torch.models import port
    from mr_blip_tpu_torch.profile_inference import make_samples

    t0 = time.time()
    model = flagship_model(max_new_tokens=SHORT_NEW_TOKENS)
    samples = make_samples(BATCH, N_FRAMES, seed=0)

    def run():
        for w in wrappers.values():
            w.launches = 0
        with torch.inference_mode():
            batch = model.prepare_mr_batch(samples, need_targets=False)
            tensors = model._to_device(batch)
            enc, _ = model.encode_t5(tensors, model.frames_to_t5(tensors),
                                     model._encoder_bias_for(batch))
        handle = model.generate_dispatch(samples)
        out = model.generate_collect(handle)
        torch.cuda.synchronize()
        rose = {k: w.launches for k, w in wrappers.items()}
        require(rose == {k: 2 * v for k, v in EXPECTED_LAUNCHES.items()},
                f"import round trip: launches {rose}, expected twice phase 4's")
        return enc, handle["scores"].float(), out["prediction"], rose

    enc0, scores0, pred0, _ = run()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    sources = reference_sources(before)
    with torch.no_grad():
        for p in model.module.parameters():
            p.fill_(float("nan"))
    model.clear_bias_cache()
    t1 = time.time()
    eva, blip2, t5, finetuned = sources
    model.load_state_dict(port.port_checkpoints(
        model.state_dict(), eva_vit=eva, blip2=blip2, t5=t5, finetuned=finetuned))
    torch.cuda.synchronize()
    import_s = time.time() - t1
    after = model.state_dict()
    nan_left = [k for k, v in after.items() if v.is_floating_point() and v.isnan().any()]
    differ = [k for k in before if not torch.equal(after[k], before[k])]
    enc1, scores1, pred1, rose = run()
    peak = torch.cuda.max_memory_allocated() / 2**30
    say(f"[{card}] import round trip (phase 4's model, full width and depth): "
        f"{len(before)} tensors, {sum(len(s) for s in sources)} reference tensors "
        f"(EVA {len(eva)}, BLIP-2 {len(blip2)}, HF T5 {len(t5)}, LoRA {len(finetuned)}); "
        f"import {import_s:.2f} s; NaN left in {len(nan_left)}, tensors off {len(differ)}; "
        f"encoder states ({tuple(enc1.shape)}) bit-equal {torch.equal(enc0, enc1)}, "
        f"beam scores bit-equal {torch.equal(scores0, scores1)}, predictions equal "
        f"{pred0 == pred1}; launches of the two batches {rose}; phase {time.time() - t0:.1f} s, "
        f"peak {peak:.2f} GiB")
    require(not nan_left, f"import: NaN left in {nan_left[:3]}")
    require(not differ, f"import: {len(differ)} tensors differ, e.g. {differ[:3]}")
    require(torch.equal(enc0, enc1) and torch.equal(scores0, scores1) and pred0 == pred1,
            "import: the generate batch moved after the round trip")
    del before, sources, eva, blip2, t5, finetuned, enc0, enc1
    torch.cuda.empty_cache()
    return model


def import_file_route(torch, card):
    """Phase 23 (b): the depth-2 model at published widths written as the
    reference's files, ``port_weights.main`` over them, ``from_config`` over
    its output."""
    import tempfile

    from mr_blip_tpu_torch import port_weights
    from mr_blip_tpu_torch.common.config import load_yaml
    from mr_blip_tpu_torch.common.utils import get_abs_path
    from mr_blip_tpu_torch.models.blip2_mr import BLIP2_MR

    t0 = time.time()
    src = reduced_model("cuda")
    src.init_params(123)  # not the seeds the port_weights and from_config models draw
    want = {k: v.cpu() for k, v in src.state_dict().items()}
    del src
    eva, blip2, t5, finetuned = reference_sources(want)
    finetuned.update({"answerer_model." + k[len("t5_model."):]: v
                      for k, v in finetuned.items()})
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        torch.save(eva, tmp / "eva_vit_g.pth")
        torch.save({"model": blip2}, tmp / "blip2_pretrained_flant5xl.pth")
        torch.save({"model": finetuned, "epoch": 0}, tmp / "checkpoint_best.pth")
        (tmp / "flan-t5-xl").mkdir()
        keys = sorted(t5)
        shards = {"model-00001-of-00002.safetensors": keys[::2],
                  "model-00002-of-00002.safetensors": keys[1::2]}
        for shard, part in shards.items():
            write_safetensors(torch, tmp / "flan-t5-xl" / shard, {k: t5[k] for k in part})
        (tmp / "flan-t5-xl" / "model.safetensors.index.json").write_text(json.dumps(
            {"metadata": {}, "weight_map": {k: n for n, part in shards.items()
                                            for k in part}}))
        file_mb = sum(f.stat().st_size for f in tmp.rglob("*") if f.is_file()) / 1e6
        t1 = time.time()
        out = tmp / "ported.pth"
        with reduced_depth_load():
            port_weights.main([
                "--arch", "blip2_mr", "--model-type", "pretrain_flant5xl",
                "--eva-vit", str(tmp / "eva_vit_g.pth"),
                "--blip2", str(tmp / "blip2_pretrained_flant5xl.pth"),
                "--t5", str(tmp / "flan-t5-xl"), "--lora", str(tmp / "checkpoint_best.pth"),
                "--output", str(out)])
            port_s = time.time() - t1
            t1 = time.time()
            cfg = dict(load_yaml(get_abs_path(BLIP2_MR.PRETRAINED_MODEL_CONFIG_DICT[
                "pretrain_flant5xl"]))["model"], pretrained=str(out), vocab_size=32128)
            model = BLIP2_MR.from_config(cfg, device="cuda")
            load_s = time.time() - t1
        got = model.state_dict()
        differ = [k for k in want if not torch.equal(got[k].cpu(), want[k])]
        say(f"[{card}] file route (depth {REDUCED_DEPTH}, published widths): sources "
            f"{file_mb:.1f} MB (a two-shard safetensors T5 with its index), port_weights "
            f"{port_s:.2f} s, output {out.stat().st_size / 1e6:.1f} MB, from_config "
            f"{load_s:.2f} s; {len(got)} tensors, {len(differ)} off the sources; phase "
            f"{time.time() - t0:.1f} s")
        require(set(got) == set(want) and not differ,
                f"file route: {len(differ)} tensors off the sources, e.g. {differ[:3]}")
    del model, got
    torch.cuda.empty_cache()


def variant_outputs(torch, model, samples):
    """One encode and decode of a batch -> (T5 encoder states, the first
    decoding step's logits of blip2_fmr's frame rows or None, the outputs
    ``generate`` would give)."""
    from mr_blip_tpu_torch.models.blip2_fmr import Blip2FMR

    with torch.inference_mode():
        if isinstance(model, Blip2FMR):
            embeds, mask = model._frame_rows(model._prepare(samples, with_targets=False))
            enc = model.module.t5.encode(embeds, mask=mask)
            start = torch.full((enc.shape[0], 1), model.t5_config.decoder_start_token_id,
                               dtype=torch.long, device=enc.device)
            logits = model.module.t5.decode(start, enc, encoder_mask=mask)[:, 0]
            scores = (logits[:, model.yes_id] - logits[:, model.no_id]).reshape(
                samples["video"].shape[:2])
            return (enc.float().cpu(), logits.cpu(),
                    model.answers(scores.cpu().numpy(), samples))
        batch = model.prepare_mr_batch(samples, need_targets=False)
        tensors = model._to_device(batch)
        enc, attn = model.encode_t5(tensors, model.frames_to_t5(tensors),
                                    model._encoder_bias_for(batch))
        seqs, _ = model.decode(enc, attn)
    return enc.float().cpu(), None, model.generate_collect({"seqs": seqs,
                                                            "samples": samples})


def no_weight_init():
    """Within it, modules skip ``torch.nn.init`` (a model whose every tensor
    is loaded right after)."""
    import contextlib

    import torch

    names = ("kaiming_uniform_", "uniform_", "normal_", "trunc_normal_", "zeros_",
             "ones_", "xavier_uniform_")

    @contextlib.contextmanager
    def patched():
        saved = {n: getattr(torch.nn.init, n) for n in names}
        for n in names:
            setattr(torch.nn.init, n, lambda tensor, *a, **kw: tensor)
        try:
            yield
        finally:
            for n, fn in saved.items():
                setattr(torch.nn.init, n, fn)

    return patched()


def variants_path(torch, wrappers, card, model):
    """Phase 23 (c): each variant at full width and depth on phase 4's weights,
    one 1 x 60 batch; then at depth 2 on the card against the CPU's plain
    path. Returns the launch counts of the full-width runs."""
    import numpy as np

    from mr_blip_tpu_torch.models.blip2_fmr import Blip2FMR
    from mr_blip_tpu_torch.models.blip2_mr import BLIP2_MR
    from mr_blip_tpu_torch.profile_inference import FLAGSHIP, make_samples
    from mr_blip_tpu_torch.text.span_grammar import moment_str_to_list

    state = model.state_dict()
    total = {k: 0 for k in wrappers}
    for name, (kw, expected) in VARIANTS.items():
        cls = Blip2FMR if name == "blip2_fmr" else BLIP2_MR
        t0 = time.time()
        variant = cls(**dict(FLAGSHIP, **kw, max_new_tokens=SHORT_NEW_TOKENS),
                      init_params=False, device="cuda")
        variant.load_state_dict(state)
        samples = fmr_samples(make_samples(1, N_FRAMES, seed=31))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        built = time.time() - t0
        for w in wrappers.values():
            w.launches = 0
        t0 = time.time()
        out = variant.generate(samples)
        torch.cuda.synchronize()
        seconds = time.time() - t0
        rose = {k: w.launches for k, w in wrappers.items()}
        for k in total:
            total[k] += rose[k]
        lengths = sorted(variant._enc_bias_cache)
        detail = {k: rose[k] for k in GENERATE_KERNELS}
        if name == "blip2_fmr":
            scores = out["yes_score"]
            require(scores.shape == (1, N_FRAMES) and bool(np.isfinite(scores).all()),
                    f"{name}: scores {scores.shape}")
            shown = f"scores [{float(scores.min()):.4f}, {float(scores.max()):.4f}]"
        else:
            for p in out["prediction"]:
                moment_str_to_list(p)
            shown = f"prediction {out['prediction']}"
        say(f"[{card}] {name} (full width and depth, 1 x {N_FRAMES} frames): "
            f"{seconds:.3f} s (built and loaded in {built:.1f} s), encoder lengths {lengths}, "
            f"launches {detail}, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
            f"{shown}")
        require(rose == expected, f"{name}: launches {rose}, expected {expected}")
        if name == "only_frames":
            require(lengths == [ONLY_FRAMES_ENCODER_LENGTH],
                    f"only_frames: encoder length {lengths}, phase 3 held kernel 3 at "
                    f"{ONLY_FRAMES_ENCODER_LENGTH}")
        del variant
        torch.cuda.empty_cache()

    # Depth 2: the card against the CPU's plain path, rel-pos table at N(0, 1).
    for name, (kw, _) in VARIANTS.items():
        cls = Blip2FMR if name == "blip2_fmr" else None
        samples = fmr_samples(make_samples(1, VARIANT_CPU_FRAMES, seed=37))
        kw = dict(kw, max_new_tokens=VARIANT_CPU_NEW_TOKENS, min_new_tokens=0)
        gpu = reduced_model("cuda", cls=cls, **kw)
        sd = gpu.state_dict()
        gen = torch.Generator(device="cuda").manual_seed(2)
        sd[RELPOS_TABLE] = torch.randn(sd[RELPOS_TABLE].shape, generator=gen, device="cuda")
        gpu.load_state_dict(sd)
        before = {k: w.launches for k, w in wrappers.items()}
        enc_gpu, logits_gpu, out_gpu = variant_outputs(torch, gpu, samples)
        rose = {k: wrappers[k].launches - before[k] for k in GENERATE_KERNELS}
        sd = {k: v.cpu() for k, v in gpu.state_dict().items()}
        del gpu
        t0 = time.time()
        with no_weight_init():
            cpu = reduced_model("cpu", init_params=False, cls=cls, **kw)
        cpu.load_state_dict(sd)
        built = time.time() - t0
        t0 = time.time()
        enc_cpu, logits_cpu, out_cpu = variant_outputs(torch, cpu, samples)
        cpu_s = time.time() - t0
        cos = torch.nn.functional.cosine_similarity(enc_gpu, enc_cpu, dim=-1)
        line = (f"[{card}] {name} at depth {REDUCED_DEPTH}, 1 x {VARIANT_CPU_FRAMES} frames, "
                f"card vs CPU plain path: encoder length {enc_gpu.shape[1]}, rows cosine "
                f"min {float(cos.min()):.6f}; launches on the card {rose}; CPU {cpu_s:.1f} s "
                f"(model built in {built:.1f} s)")
        require(float(cos.min()) >= COSINE_MIN, f"{name}: encoder cosine {float(cos.min())}")
        if logits_gpu is not None:
            # The scores are differences of bf16 logits: the bar is 2% of the
            # largest logit's magnitude; the answers must agree where a
            # score is clear of the threshold by twice the largest difference.
            lcos = torch.nn.functional.cosine_similarity(logits_gpu.float(),
                                                         logits_cpu.float(), dim=-1)
            s_gpu = torch.as_tensor(out_gpu["yes_score"])
            s_cpu = torch.as_tensor(out_cpu["yes_score"])
            err = float((s_gpu - s_cpu).abs().max())
            bar = GRAD_REL_TOL * float(logits_cpu.float().abs().max())
            # The threshold in the widest gap of the CPU's scores, so that
            # frames fall on both sides of it.
            ordered = s_cpu.flatten().sort().values
            gap = int((ordered[1:] - ordered[:-1]).argmax())
            cpu.threshold = float(ordered[gap] + ordered[gap + 1]) / 2
            clear = (s_cpu - cpu.threshold).abs() > 2 * err
            agree = (torch.as_tensor(cpu.answers(s_gpu.numpy(), samples)["pred_ans"])
                     == torch.as_tensor(cpu.answers(s_cpu.numpy(), samples)["pred_ans"])
                     )[clear]
            say(line + f"; first-step logits cosine min {float(lcos.min()):.6f}; yes-no "
                f"scores max|diff| {err:.5f} (bar {bar:.5f}), answers equal "
                f"{bool(agree.all())} on the {int(clear.sum())} of {s_cpu.numel()} frames "
                f"clear of the threshold {cpu.threshold:.4f}")
            require(float(lcos.min()) >= COSINE_MIN and err <= bar and bool(agree.all()),
                    f"{name}: logits cosine {float(lcos.min())}, scores off by {err}")
        else:
            say(line + f"; predictions {out_gpu['prediction']} vs {out_cpu['prediction']}")
            require(out_gpu["prediction"] == out_cpu["prediction"],
                    f"{name}: spans differ between the card and the CPU")
        del cpu
        if name in ("only_frames", "fast_gelu"):
            require(rose["flash_bias_attention"] == REDUCED_DEPTH,
                    f"{name} at depth {REDUCED_DEPTH}: the biased flash kernel launched "
                    f"{rose['flash_bias_attention']} times")
        torch.cuda.empty_cache()
    return total


# -------------------------------------------------------------- phase 24
def unfrozen_vit_entry_point(torch, wrappers, card):
    """Phase 24 (a): ``python -m mr_blip_tpu_torch.train`` on
    ``configs/projects/train/qvh.yaml`` as published with
    ``model.freeze_vit=False`` (the EVA ViT-g trains: fp32 masters cast to
    bf16 at use, stochastic depth up to the default 0.4, every block
    checkpointed under ``use_grad_checkpoint``), random weights, over
    UNFROZEN_QUERIES synthetic train queries (one update of UNFROZEN_ACCUM
    micro-batches of 1 x 60 frames), one val query and no test split. Gates: every ViT
    tensor moved, every frozen tensor (the T5 base, the Q-Former)
    bit-equal, every loss finite, each micro-batch's launches as predicted
    (kernel 2 twice a block: the forward and the recompute, in bf16 from the
    fp32 masters) and the val generate's as phase 4's. Prints the seconds
    per micro-batch, per update and of the optimizer step, and the peak.
    Then one more micro-batch of the trained model under ``torch.profiler``
    (``profile_unfrozen_step``). Returns the run's launches per
    micro-batch."""
    import tempfile

    from mr_blip_tpu_torch import train
    from mr_blip_tpu_torch.datasets.synthetic import make_mr_annotations
    from mr_blip_tpu_torch.models.blip2_mr import BLIP2_MR
    from mr_blip_tpu_torch.runners.train_state import TrainCtx

    phase_start = time.time()
    models, steps, generates, optimizer_s = [], [], [], []
    built = {}

    def counts():
        return {name: w.launches for name, w in wrappers.items()}

    def rose(before):
        return {name: w.launches - before[name] for name, w in wrappers.items()}

    from_config = BLIP2_MR.from_config.__func__
    step, dispatch = TrainCtx.step, BLIP2_MR.generate_dispatch

    def tapped_from_config(cls, cfg, device="cuda"):
        model = from_config(cls, cfg, device=device)
        models.append(model)
        named, mask = dict(model.module.named_parameters()), model.trainable_mask()
        # fp32 bits: the masters start as the bf16 weights, exactly
        built["vit"] = {n: checksums(torch, [p.float()]) for n, p in named.items()
                        if n.startswith("visual_encoder.")}
        built["frozen"] = checksums(torch, [p for n, p in named.items() if not mask[n]])
        return model

    def timed(optimizer_step):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            start = time.time()
            out = optimizer_step(*args, **kwargs)
            torch.cuda.synchronize()
            optimizer_s.append(time.time() - start)
            return out
        return run

    def tapped_step(ctx, batch):
        if "step" not in vars(ctx.optimizer):  # the optimizer step, timed alone
            ctx.optimizer.step = timed(ctx.optimizer.step)
        before = counts()
        torch.cuda.synchronize()
        start = time.time()
        loss = step(ctx, batch)
        torch.cuda.synchronize()
        steps.append((rose(before), time.time() - start, loss, ctx.updates))
        return loss

    def tapped_dispatch(model, samples):
        before = counts()
        handle = dispatch(model, samples)
        generates.append(rose(before))
        return handle

    taps = ((BLIP2_MR, "from_config", classmethod(tapped_from_config)),
            (TrainCtx, "step", tapped_step),
            (BLIP2_MR, "generate_dispatch", tapped_dispatch))
    originals = [(cls, name, cls.__dict__[name]) for cls, name, _ in taps]
    with tempfile.TemporaryDirectory() as tmp:
        run_paths = make_mr_annotations(
            f"{tmp}/run", n_train=UNFROZEN_QUERIES, n_val=1, n_test=1,
            n_video_frames=EVAL_VIDEO_FRAMES, fps=EVAL_FPS)
        argv = ["--cfg-path", str(ROOT / "configs/projects/train/qvh.yaml"), "--options",
                *(f"datasets.qvh.build_info.annotations.{split}.storage={path}"
                  for split, path in run_paths.items()),
                "datasets.qvh.build_info.videos.storage=synthetic",
                f"run.output_dir={Path(tmp) / 'train'}", "run.max_epoch=1",
                f"run.accum_grad_iters={UNFROZEN_ACCUM}",
                "run.test_splits=[]", "model.freeze_vit=False",
                f"model.max_new_tokens={SHORT_NEW_TOKENS}"]
        for cls, name, tap in taps:
            setattr(cls, name, tap)
        try:
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            resident = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            for w in wrappers.values():
                w.launches = 0
            t0 = time.time()
            train.main(argv)
            torch.cuda.synchronize()
            wall = time.time() - t0
            peak = torch.cuda.max_memory_allocated()
        finally:
            for cls, name, original in originals:
                setattr(cls, name, original)
    (model,) = models
    require(not model.freeze_vit and model.vit_config.drop_path_rate == UNFROZEN_DROP_PATH
            and model.vit_config.use_checkpoint, f"qvh.yaml with model.freeze_vit=False "
            f"built {model.vit_config}")
    named = dict(model.module.named_parameters())
    vit = {n: p for n, p in named.items() if n.startswith("visual_encoder.")}
    require(all(p.requires_grad and p.dtype == torch.float32 for p in vit.values()),
            "the ViT's tensors are not trainable fp32 masters")
    same = [n for n, p in vit.items() if checksums(torch, [p]) == built["vit"][n]]
    require(not same, f"unfrozen ViT: {len(same)} ViT tensors never moved, e.g. {same[:3]}")
    mask = model.trainable_mask()
    require(checksums(torch, [p for n, p in named.items() if not mask[n]]) == built["frozen"],
            "unfrozen ViT: a frozen tensor (the T5 base or the Q-Former) changed")
    require(len(steps) == UNFROZEN_QUERIES and steps[-1][3] == 1,
            f"unfrozen ViT: {len(steps)} micro-batches, {steps[-1][3] if steps else 0} updates")
    for i, (r, _, loss, _) in enumerate(steps):
        require(r == EXPECTED_UNFROZEN_LAUNCHES, f"unfrozen ViT micro-batch {i}: launches "
                f"{r}, expected {EXPECTED_UNFROZEN_LAUNCHES}")
        require(math.isfinite(loss), f"unfrozen ViT micro-batch {i}: loss {loss}")
    require(len(optimizer_s) == 1, f"unfrozen ViT: {len(optimizer_s)} optimizer steps")
    require(generates == [EXPECTED_LAUNCHES], f"unfrozen ViT: val generates {generates}")
    seconds = [r[1] for r in steps]
    trainable, total = model.trainable_param_count()
    say(f"[{card}] unfrozen ViT (configs/projects/train/qvh.yaml, model.freeze_vit=False, "
        f"drop_path_rate {UNFROZEN_DROP_PATH}, use_grad_checkpoint, {trainable / 1e6:.2f} M of "
        f"{total / 1e6:.2f} M parameters train): {UNFROZEN_QUERIES} micro-batches of 1 x "
        f"{N_FRAMES}, one update, one val generate; every micro-batch launched "
        f"{ {k: v for k, v in EXPECTED_UNFROZEN_LAUNCHES.items() if v} }, the generate "
        f"{ {k: v for k, v in EXPECTED_LAUNCHES.items() if v} }; losses "
        f"{[round(r[2], 4) for r in steps]}; all {len(vit)} ViT tensors moved, every "
        f"frozen one bit-equal")
    say(f"[{card}] unfrozen ViT seconds: micro-batch steady {statistics.median(seconds[1:]):.3f} "
        f"(median of 1-{len(seconds) - 1}; mean {statistics.mean(seconds[1:]):.3f}, first "
        f"{seconds[0]:.3f}); update {sum(seconds):.3f} (the {len(seconds)} micro-batches), of it the "
        f"optimizer step {optimizer_s[0]:.3f}; main() {wall:.3f}; peak memory "
        f"{(peak - resident) / 2**30:.2f} GiB above the {resident / 2**30:.2f} GiB earlier "
        f"phases held")
    gc.collect()  # the run's optimizer state
    torch.cuda.empty_cache()
    profile_unfrozen_step(torch, wrappers, model, card)
    del model, vit, named
    models.clear()
    gc.collect()
    torch.cuda.empty_cache()
    say(f"phase 24 (a): {time.time() - phase_start:.1f} s")
    return steps[0][0]


def device_shares(trace, ranges):
    """Device microseconds of a Chrome trace: the total over every kernel,
    memcpy and memset, and for each entry of ``ranges`` (name -> predicate
    on an event name) the time of the device work launched while a CPU op
    or ``record_function`` range that it accepts was open on the launching
    thread (a launch is tied to its device work by the trace's correlation
    id; nested ranges count once)."""
    events = json.loads(Path(trace).read_text())["traceEvents"]
    device = [e for e in events if e.get("ph") == "X"
              and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    spans = {name: {} for name in ranges}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in ("cpu_op", "user_annotation"):
            continue
        for name, accepts in ranges.items():
            if accepts(e["name"]):
                spans[name].setdefault(e["tid"], []).append(
                    (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    out = {name: 0.0 for name in ranges}
    out["total"] = sum(float(e["dur"]) for e in device)
    for e in device:
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is None:
            continue
        ts = float(launch["ts"])
        for name in ranges:
            if any(start <= ts <= end for start, end in spans[name].get(launch["tid"], ())):
                out[name] += float(e["dur"])
    return out


def profile_unfrozen_step(torch, wrappers, model, card):
    """One more 1 x 60 micro-batch of phase 24 (a)'s trained model (a fresh
    ``TrainCtx``, no update) under ``torch.profiler``, with ranges on the
    ViT's forward, its backward (from the gradient of its output to the
    accumulation of the patch conv's weight) and each block's recompute
    inside it. Prints the device time of the step and the shares of the
    plain backward of kernels 1 and 2 (the autograd nodes
    ``_FusedLayerNormBackward`` and ``_QkvPackedBackward``: the plain
    versions recomputed and differentiated) and of the ViT's forward,
    backward and recompute, with the launches of the step."""
    import tempfile

    from mr_blip_tpu_torch.profile_inference import make_samples
    from mr_blip_tpu_torch.runners.train_state import TrainCtx

    ctx = TrainCtx(model, accum_grad_iters=UNFROZEN_ACCUM)
    ctx.set_lr(0.0)
    batch = model.prepare_mr_batch(make_samples(1, N_FRAMES, seed=41))
    vit = model.module.visual_encoder
    open_ranges, hooks = {}, []

    def enter(name):
        leave(name)
        open_ranges[name] = torch.profiler.record_function(name)
        open_ranges[name].__enter__()

    def leave(name):
        if name in open_ranges:
            open_ranges.pop(name).__exit__(None, None, None)

    def vit_out(module, args, out):
        leave("vit_forward")
        if out.requires_grad:
            out.register_hook(lambda grad: enter("vit_backward"))

    def in_backward():
        return torch._C._current_autograd_node() is not None

    hooks.append(vit.register_forward_pre_hook(lambda m, a: enter("vit_forward")))
    hooks.append(vit.register_forward_hook(vit_out))
    for blk in vit.blocks:
        hooks.append(blk.register_forward_pre_hook(
            lambda m, a: enter("vit_recompute") if in_backward() else None))
        hooks.append(blk.register_forward_hook(
            lambda m, a, o: leave("vit_recompute") if in_backward() else None))
    hooks.append(vit.patch_embed.weight.register_post_accumulate_grad_hook(
        lambda p: leave("vit_backward")))
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for w in wrappers.values():
                w.launches = 0
            torch.cuda.synchronize()
            # The whole block forward in each recompute (checkpoint's early
            # stop would leave it before its forward hook closes the range).
            with torch.utils.checkpoint.set_checkpoint_early_stop(False), \
                    torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
                start = time.time()
                ctx.step(batch)
                torch.cuda.synchronize()
                wall = time.time() - start
            launched = {k: w.launches for k, w in wrappers.items() if w.launches}
            trace = Path(tmp) / "unfrozen_step.json"
            prof.export_chrome_trace(str(trace))
            us = device_shares(trace, {
                "layer_norm_backward": lambda n: n.endswith("_FusedLayerNormBackward"),
                "qkv_packed_backward": lambda n: n.endswith("_QkvPackedBackward"),
                "vit_forward": lambda n: n == "vit_forward",
                "vit_backward": lambda n: n == "vit_backward",
                "vit_recompute": lambda n: n == "vit_recompute"})
    finally:
        for h in hooks:
            h.remove()
        for name in list(open_ranges):
            leave(name)
        for p in ctx.params:
            p.grad = None
    require(launched == {k: v for k, v in EXPECTED_UNFROZEN_LAUNCHES.items() if v},
            f"profiled unfrozen step: launches {launched}")
    total = us.pop("total")
    require(total > 0, "the profiled step shows no device time")
    say(f"[{card}] unfrozen ViT, one profiled 1 x {N_FRAMES} micro-batch (torch.profiler): "
        f"device {total / 1e3:.1f} ms of {wall * 1e3:.1f} ms wall (busy {total / 1e6 / wall:.3f}); "
        + ", ".join(f"{name} {v / 1e3:.1f} ms ({v / total:.1%})" for name, v in us.items())
        + f"; plain backward of kernels 1 and 2 together "
        f"{(us['layer_norm_backward'] + us['qkv_packed_backward']) / total:.1%} of the device "
        f"time; launches {launched}")


def unfrozen_vit_vs_plain(torch, wrappers, card):
    """Phase 24 (b): the depth-2 model at full width with the ViT trained
    (``qformer_freeze_lora``, ``freeze_vit=False``), one 1 x GRAD_FRAMES
    batch in eval mode (no dropout, no stochastic depth), at 224 pixels
    (kernels 1 and 2 under autograd) and at 364 (kernels 1 and 4): the
    card's loss and the gradient of every trainable tensor (every ViT
    tensor, the LoRA deltas) against the CPU's plain path in bf16, phase
    7's bars (loss within LOSS_REL_TOL relative, every cosine >=
    GRAD_COSINE_MIN); weights drawn as phase 7 draws them."""
    from mr_blip_tpu_torch.profile_inference import make_samples

    start = time.time()
    for img_size in UNFROZEN_IMG_SIZES:
        samples = make_samples(1, GRAD_FRAMES, seed=43, img_size=img_size)
        kw = dict(task=TRAIN_TASK, freeze_vit=False, img_size=img_size)
        gpu = reduced_model("cuda", **kw)
        gpu.load_state_dict(bf16_friendly_state(torch, gpu))
        batch = gpu.prepare_mr_batch(samples)
        for w in wrappers.values():
            w.launches = 0
        loss_gpu, g_gpu, _ = path_gradients(torch, gpu, batch, TRAIN_TASK)
        launched = {k: w.launches for k, w in wrappers.items() if w.launches}
        state = {k: v.cpu() for k, v in gpu.state_dict().items()}
        del gpu
        torch.cuda.empty_cache()
        with no_weight_init():
            cpu = reduced_model("cpu", init_params=False, **kw)
        cpu.load_state_dict(state)
        t0 = time.time()
        loss_cpu, g_cpu, _ = path_gradients(torch, cpu, batch, TRAIN_TASK)
        cpu_s = time.time() - t0
        del cpu
        vit = [n for n in g_gpu if n.startswith("visual_encoder.")]
        require(g_gpu.keys() == g_cpu.keys() and vit, f"{img_size}²: trainable sets differ")
        cos = {n: cosine(torch, g_gpu[n], g_cpu[n]) for n in g_gpu}
        worst = min(cos, key=cos.get)
        worst_vit = min(vit, key=cos.get)
        rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
        attention = "qkv_packed_attention" if img_size == 224 else "flash_attention"
        say(f"[{card}] unfrozen ViT gradients at {img_size}² (depth {REDUCED_DEPTH}, full width, "
            f"1 x {GRAD_FRAMES} frames, {TRAIN_TASK}): loss {loss_gpu:.5f} vs plain "
            f"{loss_cpu:.5f} (rel {rel:.2e}); {len(cos)} trainable tensors ({len(vit)} of the "
            f"ViT), cosine min {cos[worst]:.6f} ({worst}), ViT min {cos[worst_vit]:.6f} "
            f"({worst_vit}), mean {statistics.mean(cos.values()):.6f}; launches {launched}; "
            f"CPU run {cpu_s:.1f} s")
        require(rel <= LOSS_REL_TOL, f"unfrozen ViT {img_size}²: loss rel diff {rel}")
        require(cos[worst] >= GRAD_COSINE_MIN, f"unfrozen ViT {img_size}²: {worst} cosine "
                f"{cos[worst]}")
        require(all(float(g_gpu[n].abs().max()) > 0 and bool(torch.isfinite(g_gpu[n]).all())
                    for n in vit), f"unfrozen ViT {img_size}²: a ViT gradient is zero or "
                "not finite")
        require(launched.get(attention) == REDUCED_DEPTH and launched.get("layer_norm", 0) > 0,
                f"unfrozen ViT {img_size}²: launches {launched}")
    say(f"phase 24 (b): {time.time() - start:.1f} s")


def weight_checksums(torch, model):
    """Checksums of every eighth parameter tensor: two models drawn from one
    seed at one geometry give the same."""
    params = list(model.module.parameters())
    return checksums(torch, params[::8])


def vocabulary_entry_point(torch, wrappers, card, phase4, eval_metrics):
    """Phase 25: (a) each committed tokenizer directory of
    ``tests/data/torch_tokenizer/`` through the port's own reader
    (``HFT5Tokenizer``): every golden string's ids (with and without special
    tokens) and decodes (with and without ``skip_special_tokens``) equal to
    what ``transformers`` wrote into ``ids.json``, the vocabulary size and
    special ids too, ``check_vocab``'s facts on the Flan-T5-shaped one, and
    no ``transformers``, ``tokenizers``, ``sentencepiece`` or ``regex`` in
    the process. (b) The flagship under ``tokenizer_path`` (the
    Flan-T5-shaped directory; 32,100 pieces padded to 128: 32,128 rows,
    phase 4's geometry, so the seed draws phase 4's weights, checksummed),
    one 4 x 60 batch of phase 4's samples: kernels 1-3 launch what phase 4's
    batches launch, the encoder length is the one phase 3 held kernel 3 at,
    the spans parse; the host's tokenize time a batch beside the mock's.
    (c) ``python -m mr_blip_tpu_torch.standalone_eval`` on the committed QVH
    goldens (``qvh_expected.json`` exactly) and ``python -m
    mr_blip_tpu_torch.asset_gates`` on two ``log.txt`` files holding phase
    16's metrics: the int8 drift gate passes (exit 0), the baseline gate
    fails (exit 1: random weights). Returns the launch counts of (b)."""
    import tempfile

    from mr_blip_tpu_torch.profile_inference import make_samples
    from mr_blip_tpu_torch.text.span_grammar import moment_str_to_list
    from mr_blip_tpu_torch.text.timestamps import (
        find_annoying_numbers,
        find_annoying_numbers_replacement_dict,
    )
    from mr_blip_tpu_torch.text.tokenizer import HFT5Tokenizer, MockT5Tokenizer
    from mr_blip_tpu_torch.text.vocab_facts import check_vocab

    phase_start = time.time()
    data = ROOT / "tests" / "data" / "torch_tokenizer"
    goldens = json.loads((data / "ids.json").read_text(encoding="utf-8"))
    for name in VOCAB_DIRS:
        t0 = time.perf_counter()
        tok = HFT5Tokenizer(str(data / name))
        load_ms = 1e3 * (time.perf_counter() - t0)
        want = goldens[name]
        got = (tok.vocab_size, tok.pad_token_id, tok.eos_token_id, tok.unk_token_id)
        require(got == (want["vocab_size"], want["pad_token_id"], want["eos_token_id"],
                        want["unk_token_id"]), f"tokenizer {name}: vocab and ids {got}")
        bad = [c["text"] for c in want["cases"]
               if tok.encode(c["text"]) != c["ids"]
               or tok.encode(c["text"], add_special_tokens=False) != c["ids_plain"]
               or tok.decode(c["ids"]) != c["decode"]
               or tok.decode(c["ids"], skip_special_tokens=True) != c["decode_skip"]]
        require(not bad, f"tokenizer {name}: ids or decodes differ from transformers' on {bad}")
        say(f"tokenizer {name}: {len(want['cases'])} golden strings, ids and decodes "
            f"equal to transformers'; vocab {tok.vocab_size}, pad/eos/unk {got[1:]}; "
            f"read in {load_ms:.1f} ms")
    facts = check_vocab(HFT5Tokenizer(str(data / "flan_t5")))
    require(not facts["failures"], f"check_vocab: {facts['failures']}")
    say(f"check_vocab (flan_t5): answer ids {facts['answer_ids']}, extra ids "
        f"{facts['extra_ids']}, annoying {facts['annoying']} / {facts['annoying_space']}")
    # (b) the flagship under the tokenizer directory
    t0 = time.time()
    model = flagship_model(tokenizer_path=str(data / "flan_t5"), vocab_size=None)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    require(model.t5_config.vocab_size == 32128
            and model.answer_ids == [71, 272, 205, 309, 262]
            and type(model.tokenizer) is HFT5Tokenizer,
            f"phase 25: vocabulary {model.t5_config.vocab_size}, answer ids "
            f"{model.answer_ids}, tokenizer {type(model.tokenizer).__name__}")
    require(weight_checksums(torch, model) == phase4["weight_checksums"],
            "phase 25: the weights differ from phase 4's")
    samples = make_samples(BATCH, N_FRAMES, 0)
    mock = MockT5Tokenizer()
    mock_remap = find_annoying_numbers_replacement_dict(find_annoying_numbers(mock, 200)[0])

    def tokenize_ms(tok, remap):
        saved = model.tokenizer, model.annoying_numbers_replacement_dict
        model.tokenizer, model.annoying_numbers_replacement_dict = tok, remap
        try:
            times = []
            for _ in range(TOKENIZE_REPS):
                t = time.perf_counter()
                model.prepare_mr_batch(samples, need_targets=False)
                times.append(1e3 * (time.perf_counter() - t))
            return statistics.median(times)
        finally:
            model.tokenizer, model.annoying_numbers_replacement_dict = saved

    real_ms = tokenize_ms(model.tokenizer, model.annoying_numbers_replacement_dict)
    mock_ms = tokenize_ms(mock, mock_remap)
    batch = model.prepare_mr_batch(samples, need_targets=False)
    prompt = (batch["int_mask"].shape[1] + batch["end_ids"].shape[1]
              + batch["text_ids"].shape[1])
    length = -(-prompt // 8) * 8
    require((prompt, length) == (VOCAB_PROMPT_TOKENS, VOCAB_ENCODER_LENGTH),
            f"phase 25: prompt {prompt} tokens, encoder length {length}; phase 3 held "
            f"kernel 3 at {VOCAB_ENCODER_LENGTH} ({VOCAB_PROMPT_TOKENS} keys)")
    for w in wrappers.values():
        w.launches = 0
    t0 = time.time()
    handle = model.generate_dispatch(samples)
    out = model.generate_collect(handle)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = {name: w.launches for name, w in wrappers.items()}
    require(launches == EXPECTED_LAUNCHES, f"phase 25: launches {launches}, "
            f"expected {EXPECTED_LAUNCHES}")
    scores = handle["scores"].float().cpu()
    require(bool(torch.isfinite(scores).all()), "phase 25: beam scores not finite")
    require(len(out["prediction"]) == BATCH, "phase 25: wrong number of predictions")
    for p in out["prediction"]:
        moment_str_to_list(p)
    say(f"flagship under tokenizer_path=tests/data/torch_tokenizer/flan_t5 (vocabulary "
        f"32,128, phase 4's weights; built in {build_s:.1f} s): B={BATCH} x {N_FRAMES} "
        f"frames, prompt {prompt} tokens, encoder length {length} (the mock's phase 4 "
        f"{phase4['encoder_length']}); generate {seconds:.3f} s (first batch of this model; "
        f"phase 4 steady {phase4['steady_s']:.3f} s, first {phase4['first_s']:.3f} s); "
        f"launches { {k: v for k, v in launches.items() if v} }; predictions "
        f"{out['prediction']}")
    say(f"host tokenize (prepare_mr_batch, 4 x 60, median of {TOKENIZE_REPS}): "
        f"Flan-T5-shaped tokenizer {real_ms:.2f} ms/batch vs mock {mock_ms:.2f} ms/batch; "
        f"{card}")
    del model, handle, out
    torch.cuda.empty_cache()

    # (c) the offline scorer and the asset-day gates, each a process
    golden = ROOT / "tests" / "data" / "golden"
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        row = {f"test_{k}": v for k, v in eval_metrics.items()}
        for tag in ("bf16", "int8"):
            (tmp / tag / "job").mkdir(parents=True)
            (tmp / tag / "job" / "log.txt").write_text(json.dumps(row, default=float) + "\n")
        commands = {
            "scorer": (["-m", "mr_blip_tpu_torch.standalone_eval", "--submission_path",
                        str(golden / "qvh_submission.jsonl"), "--gt_path",
                        str(golden / "qvh_gt.jsonl"), "--save_path", str(tmp / "qvh.json"),
                        "--not_verbose"], 0),
            "int8 gate": (["-m", "mr_blip_tpu_torch.asset_gates", "int8", str(tmp / "bf16"),
                           str(tmp / "int8")], 0),
            "baseline gate": (["-m", "mr_blip_tpu_torch.asset_gates", "baseline",
                               str(tmp / "bf16"), "1.0"], 1),
        }
        t0 = time.time()
        procs = {name: subprocess.Popen([sys.executable, *argv], cwd=ROOT, text=True,
                                        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
                 for name, (argv, _) in commands.items()}
        for name, proc in procs.items():
            try:
                stdout, stderr = proc.communicate(timeout=300)
            finally:
                proc.kill()
            require(proc.returncode == commands[name][1],
                    f"phase 25: {name} exited {proc.returncode}, expected "
                    f"{commands[name][1]}: {stdout[-1000:]} {stderr[-2000:]}")
            if name != "scorer":
                say(f"asset_gates {name} (phase 16's metrics): exit {proc.returncode}; "
                    + " | ".join(line.strip() for line in stdout.splitlines()))
        got = json.loads((tmp / "qvh.json").read_text())
        require(got == json.loads((golden / "qvh_expected.json").read_text()),
                "phase 25: the scorer's output differs from qvh_expected.json")
        say(f"python -m mr_blip_tpu_torch.standalone_eval on the QVH goldens: equal to "
            f"qvh_expected.json (brief {json.dumps(got['brief'])}); three processes "
            f"{time.time() - t0:.1f} s")
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in (
        "transformers", "tokenizers", "sentencepiece", "regex", "jax", "flax"))
    require(not loaded, f"phase 25: {loaded} imported")
    say(f"[{card}] phase 25: {time.time() - phase_start:.1f} s; no transformers, tokenizers, "
        "sentencepiece, regex, jax or flax in the process")
    return launches

# -------------------------------------------------------------- phase 28
def zoo_annotations(path):
    """ZOO_IMAGES x ZOO_CAPTIONS caption records of synthetic:// images,
    image-major, string image ids (a COCO Karpathy split's schema)."""
    import numpy as np

    rng = np.random.default_rng(ZOO_SEED)
    anns = [{"image": f"1x64x64#{i}", "image_id": f"img{i}",
             "caption": " ".join(rng.choice(ZOO_WORDS, int(rng.integers(6, 12))))}
            for i in range(ZOO_IMAGES) for _ in range(ZOO_CAPTIONS)]
    Path(path).write_text(json.dumps(anns))
    return str(path)


@contextlib.contextmanager
def captured_zoo_models(torch, built):
    """Every zoo wrapper ``from_config`` builds goes into ``built``, its
    ``generate``, ``compute_sim_matrix`` and ``predict`` timed (each call's
    seconds and result appended to ``built[i].calls``)."""
    from mr_blip_tpu_torch.models import zoo_wrappers

    originals = {cls: cls.__dict__["from_config"] for cls in
                 (zoo_wrappers.BlipCaptionModel, zoo_wrappers.BlipRetrievalModel,
                  zoo_wrappers.ClipModel, zoo_wrappers.AlbefNLVRModel)}

    def timed(model, name):
        fn = getattr(model, name)

        def call(*a, **k):
            torch.cuda.synchronize()
            t0 = time.time()
            res = fn(*a, **k)
            torch.cuda.synchronize()
            model.calls.append((name, time.time() - t0, res))
            return res
        return call

    def hook(original):
        def from_config(cls, cfg, device="cuda"):
            model = original.__func__(cls, cfg, device=device)
            model.calls = []
            for name in ("generate", "compute_sim_matrix", "predict"):
                if hasattr(model, name):
                    setattr(model, name, timed(model, name))
            built.append(model)
            return model
        return classmethod(from_config)

    for cls, original in originals.items():
        cls.from_config = hook(original)
    try:
        yield
    finally:
        for cls, original in originals.items():
            cls.from_config = original


def zoo_depth2_vs_cpu(torch):
    """The depth-2 base-width BLIPv1 (2 ViT blocks, 2 MED layers a stack) on
    the card against the same weights on the CPU: caption loss, the ITC
    features, ITM logits and greedy caption ids of 4 images."""
    import numpy as np

    from mr_blip_tpu_torch.models import blip_v1, med, vit, zoo_wrappers

    cfg = blip_v1.BLIPConfig(vision=vit.BaseViTConfig(depth=REDUCED_DEPTH),
                             text=med.MedConfig(num_layers=REDUCED_DEPTH))
    models = {}
    for dev in ("cpu", "cuda"):  # the tiny wrapper, its module and vocabulary swapped
        w = zoo_wrappers.BlipCaptionModel(model_size="tiny", device=dev)
        w.config, w.tokenizer = cfg, zoo_wrappers.WordTokenizer(cfg.text.vocab_size)
        w.module = blip_v1.BLIPv1(cfg, device=dev, dtype=torch.float32).eval()
        models[dev] = w
    zoo_wrappers.init_blip_weights_(models["cpu"].module, ZOO_SEED)
    models["cuda"].module.load_state_dict(models["cpu"].module.state_dict())
    rng = np.random.default_rng(ZOO_SEED)
    batch = {"image": rng.standard_normal((4, 224, 224, 3)).astype(np.float32),
             "text_input": [" ".join(rng.choice(ZOO_WORDS, 8)) for _ in range(4)]}
    out = {}
    for dev, w in models.items():
        with torch.no_grad():
            ims = zoo_wrappers._stack_images(batch, w.device)
            ids, mask = w._text(batch["text_input"])
            states = w.module.encode_image(ims)
            out[dev] = {"loss": w(batch)["loss"].detach(),
                        "image_feat": w.module.image_feat(ims),
                        "text_feat": w.module.text_feat(ids, mask),
                        "itm": w.module.itm_logits_from_states(states, ids, mask),
                        "greedy": w._greedy(ims, 12)}
    errs = {k: float((out["cuda"][k].cpu().float() - v.float()).abs().max()
                     / v.float().abs().max()) for k, v in out["cpu"].items() if k != "greedy"}
    return errs, bool(torch.equal(out["cuda"]["greedy"].cpu(), out["cpu"]["greedy"]))


@contextlib.contextmanager
def plain_versions_on_card():
    """Every ``LayerNormFP32`` and attention site of the port on its kernel's
    plain version, on the card: no kernel wrapper is called."""
    from mr_blip_tpu_torch.models import layers
    from mr_blip_tpu_torch.ops.attention import set_attention_backend
    from mr_blip_tpu_torch.ops.layer_norm import _ln_reference

    original = layers.fused_layer_norm

    def plain(x, weight, bias, eps=1e-6):
        return _ln_reference(x.reshape(-1, x.shape[-1]), weight, bias, eps).reshape(x.shape)

    layers.fused_layer_norm = plain
    set_attention_backend("xla")
    try:
        yield
    finally:
        layers.fused_layer_norm = original
        set_attention_backend("auto")


def zoo_gallery(ann):
    """Phase 28's retrieval rows as the evaluation's loader batches them
    (64 captions a batch, in order)."""
    from mr_blip_tpu_torch.datasets.base_dataset import default_collate
    from mr_blip_tpu_torch.datasets.image_datasets import RetrievalDataset
    from mr_blip_tpu_torch.processors.text_processors import BlipCaptionProcessor

    ds = RetrievalDataset(text_processor=BlipCaptionProcessor(), vis_root="synthetic://",
                          ann_paths=[ann])
    return [default_collate([ds[i] for i in range(lo, min(lo + 64, len(ds)))])
            for lo in range(0, len(ds), 64)]


def rel_err(torch, got, want):
    return float((got.cpu().float() - want.cpu().float()).abs().max()
                 / want.cpu().float().abs().max())


def clip_l14_towers(torch, wrappers, batches):
    """Phase 28 (d): the CLIP towers at ViT-L/14, full width and depth, on
    phase 28's 64 images and 320 captions. Returns the launches, the
    figures and the gates' readings."""
    import numpy as np

    from mr_blip_tpu_torch.models import clip, zoo_wrappers

    images, seen = [], set()  # every image once, first seen first
    for batch in batches:
        for j, img_id in enumerate(batch["image_id"]):
            if img_id not in seen:
                seen.add(img_id)
                images.append(torch.as_tensor(np.asarray(batch["image"][j])))
    images = torch.stack(images).float().cuda()
    texts = [t for b in batches for t in b["text_input"]]
    out = {}
    # the fp32 wrapper (its tokenizer, its weights), then the bf16 module
    # (CLIP's default dtype) on the same weights
    model = zoo_wrappers.ClipModel(model_size=CLIP_L14, device="cuda", seed=ZOO_SEED)
    text_batches = [model.tokenize(texts[lo:lo + CLIP_TEXT_BATCH])
                    for lo in range(0, len(texts), CLIP_TEXT_BATCH)]
    module = clip.CLIP(model.config, device="cuda").eval()
    module.load_state_dict(model.state_dict())
    counts = {"image": [], "text": []}

    def encode(count):
        feats = {}
        with torch.no_grad():
            for w in wrappers.values():
                w.launches = 0
            torch.cuda.synchronize()
            t0 = time.time()
            feats["image"] = module.encode_image(images)
            torch.cuda.synchronize()
            feats["image_s"] = time.time() - t0
            if count:
                counts["image"].append({k: w.launches for k, w in wrappers.items()})
            txt = []
            t0 = time.time()
            for ids in text_batches:
                for w in wrappers.values():
                    w.launches = 0
                txt.append(module.encode_text(ids))
                if count:
                    counts["text"].append({k: w.launches for k, w in wrappers.items()})
            torch.cuda.synchronize()
            feats["text_s"] = time.time() - t0
            feats["text"] = torch.cat(txt)
        return feats

    encode(count=True)  # the launches; each path's second call is timed
    with plain_versions_on_card():
        encode(count=False)
    kernel = encode(count=False)
    with plain_versions_on_card():
        plain = encode(count=False)
    for w in wrappers.values():
        w.launches = 0
    out["bf16_cos"] = {k: float(torch.nn.functional.cosine_similarity(
        kernel[k].float(), plain[k].float(), dim=-1).min()) for k in ("image", "text")}
    out["bf16_err"] = {k: rel_err(torch, kernel[k], plain[k]) for k in ("image", "text")}
    out["bf16_s"] = {k: (kernel[f"{k}_s"], plain[f"{k}_s"]) for k in ("image", "text")}
    launches = {k: sum(c[k] for part in counts.values() for c in part) for k in wrappers}
    out["counts"] = counts
    del module, kernel, plain
    torch.cuda.empty_cache()

    # fp32 through the wrapper: its compute_sim_matrix over the same batches
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    sims = model.compute_sim_matrix(batches)
    torch.cuda.synchronize()
    out["fp32_s"] = time.time() - t0
    out["fp32_launches"] = {k: w.launches for k, w in wrappers.items()}
    out["sims_shape"] = sims.shape
    out["sims_finite"] = bool(np.isfinite(sims).all())
    for k in wrappers:
        launches[k] += out["fp32_launches"][k]
    del model
    torch.cuda.empty_cache()

    # depth 2 at full width, card against the CPU, on the first batch
    cfg = dataclasses.replace(clip.clip_config_from_name(CLIP_L14), text_layers=REDUCED_DEPTH,
                              vision=dataclasses.replace(clip.clip_config_from_name(
                                  CLIP_L14).vision, depth=REDUCED_DEPTH))
    reduced = {}
    for dev in ("cpu", "cuda"):
        w = zoo_wrappers.ClipModel(model_size="tiny", device=dev)
        w.config, w.model_size = cfg, CLIP_L14
        w._word_tok = zoo_wrappers.WordTokenizer(cfg.vocab_size)
        w.module = clip.CLIP(cfg, device=dev, dtype=torch.float32).eval()
        reduced[dev] = w
    zoo_wrappers.init_clip_weights_(reduced["cpu"].module, ZOO_SEED)
    reduced["cuda"].load_state_dict(reduced["cpu"].state_dict())
    before = wrappers["flash_attention"].launches
    depth2 = {dev: w.compute_sim_matrix(batches[:1]) for dev, w in reduced.items()}
    out["depth2_flash"] = wrappers["flash_attention"].launches - before
    out["depth2_err"] = rel_err(torch, torch.as_tensor(depth2["cuda"]),
                                torch.as_tensor(depth2["cpu"]))

    # RN50 at full width in fp32, card against the CPU (TF32 off)
    rn = {dev: zoo_wrappers.ClipModel(model_size="RN50", device=dev) for dev in ("cpu", "cuda")}
    zoo_wrappers.init_clip_weights_(rn["cpu"].module, ZOO_SEED)
    rn["cuda"].load_state_dict(rn["cpu"].state_dict())
    ims = images[:CLIP_RN50_IMAGES].cpu()
    ids = rn["cpu"].tokenize(texts[:CLIP_RN50_IMAGES])
    rn_out = {}
    for dev, w in rn.items():
        with torch.no_grad():
            rn_out[dev] = {"image": w.module.encode_image(ims.to(dev)),
                           "logits": w.module(ims.to(dev), ids.to(dev))[0]}
    out["rn50_err"] = {k: rel_err(torch, rn_out["cuda"][k], v) for k, v in rn_out["cpu"].items()}
    out["rn50_stride_ok"] = tuple(rn["cpu"].module.visual.attnpool.pos_embed.shape) == (50, 2048)
    del rn, reduced
    torch.cuda.empty_cache()
    return launches, out


def nlvr_annotations(path):
    """ZOO_NLVR_PAIRS NLVR2 rows of synthetic:// image pairs."""
    import numpy as np

    rng = np.random.default_rng(ZOO_SEED)
    rows = [{"image": f"1x64x64#{i}", "image2": f"1x64x64#{i + ZOO_NLVR_PAIRS}",
             "sentence": " ".join(rng.choice(ZOO_WORDS, int(rng.integers(6, 12)))),
             "label": int(rng.integers(0, 2))} for i in range(ZOO_NLVR_PAIRS)]
    Path(path).write_text(json.dumps(rows))
    return str(path)


def albef_depth2_vs_cpu(torch, ann):
    """Phase 28 (e)'s depth-2 AlbefNLVR at base width (2 ViT blocks, 2 MED
    layers, fusion at layer 1) on the card against the CPU: the logits of
    the first 8 pairs."""
    from mr_blip_tpu_torch.datasets.base_dataset import default_collate
    from mr_blip_tpu_torch.datasets.image_datasets import ClassificationDataset
    from mr_blip_tpu_torch.models import albef, med, vit, zoo_wrappers
    from mr_blip_tpu_torch.processors.text_processors import BlipCaptionProcessor

    cfg = albef.ALBEFConfig(vision=vit.BaseViTConfig(depth=REDUCED_DEPTH),
                            text=med.MedConfig(vocab_size=30522, num_layers=REDUCED_DEPTH,
                                               fusion_layer=1))
    models = {}
    for dev in ("cpu", "cuda"):
        w = zoo_wrappers.AlbefNLVRModel(model_size="tiny", device=dev)
        w.config, w.tokenizer = cfg, zoo_wrappers.WordTokenizer(cfg.text.vocab_size)
        w.module = albef.AlbefNLVR(cfg, device=dev, dtype=torch.float32).eval()
        models[dev] = w
    zoo_wrappers.init_blip_weights_(models["cpu"].module, ZOO_SEED)
    models["cuda"].load_state_dict(models["cpu"].state_dict())
    ds = ClassificationDataset(text_processor=BlipCaptionProcessor(), vis_root="synthetic://",
                               ann_paths=[ann])
    batch = default_collate([ds[i] for i in range(min(8, len(ds)))])
    logits = {}
    for dev, w in models.items():
        with torch.no_grad():
            logits[dev] = w._logits(batch)
    return rel_err(torch, logits["cuda"], logits["cpu"])


def clip_albef_entry_points(torch, wrappers, card, tmp, ann):
    """Phase 28 (c)-(e): see CLIP_EVAL_SIZE. Returns the launches of (c),
    (d) and (e)."""
    import numpy as np

    from mr_blip_tpu_torch import evaluate
    from mr_blip_tpu_torch.datasets.base_dataset import default_collate
    from mr_blip_tpu_torch.datasets.image_datasets import ClassificationDataset
    from mr_blip_tpu_torch.processors.text_processors import BlipCaptionProcessor

    part_start = time.time()
    runs = {}
    nlvr_ann = nlvr_annotations(Path(tmp) / "nlvr.json")
    for name, ds, a, extra in (
            ("clip_ret_coco_eval", "coco_retrieval", ann, [f"model.model_size={CLIP_EVAL_SIZE}"]),
            ("nlvr_eval", "nlvr", nlvr_ann, ["model.model_size=base"])):
        out_dir = Path(tmp) / name
        argv = ["--cfg-path", str(ROOT / f"configs/projects/zoo/{name}.yaml"), "--options",
                *(f"datasets.{ds}.build_info.annotations.{split}.storage={a}"
                  for split in ("train", "val", "test")),
                f"datasets.{ds}.build_info.images.storage=synthetic://",
                f"run.output_dir={out_dir}", *extra]
        built = []
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.synchronize()
        t0 = time.time()
        with captured_zoo_models(torch, built):
            logs = evaluate.main(argv)
        torch.cuda.synchronize()
        runs[name] = {"logs": logs["test"], "wall": time.time() - t0, "model": built[0],
                      "launches": {k: w.launches for k, w in wrappers.items()},
                      "rows": [json.loads(f.read_text()) for f in
                               out_dir.glob("*/result/test_epochbest.json")]}
        require(len(built) == 1, f"phase 28 {name}: {len(built)} models built")
    clip_run, nlvr_run = runs["clip_ret_coco_eval"], runs["nlvr_eval"]
    # (c) the wrapper's own call on the loader's batches (the cosine matrix is
    # one product over the gallery, so a part of it is rounded by the host's
    # GEMM of another shape: the whole is compared), and its first batch's
    # rows alone (max |diff|, printed)
    batches = zoo_gallery(ann)
    cmodel = clip_run["model"]
    sims = next(res for name, _, res in cmodel.calls if name == "compute_sim_matrix")
    clip_rows_equal = bool(np.array_equal(cmodel.compute_sim_matrix(batches), sims))
    first = cmodel.compute_sim_matrix(batches[:1])
    first_err = float(np.abs(first - sims[:first.shape[0], :first.shape[1]]).max())
    # (e) the first batch's predictions: the wrapper's own call on it
    ds = ClassificationDataset(text_processor=BlipCaptionProcessor(), vis_root="synthetic://",
                               ann_paths=[nlvr_ann])
    nmodel = nlvr_run["model"]
    mine = nmodel.predict(default_collate([ds[i] for i in range(min(64, len(ds)))]))
    eval_preds = [r["prediction"] for r in nlvr_run["rows"][0]][:len(mine["predictions"])]
    nlvr_equal = eval_preds == mine["predictions"]
    sim_s = [t for n, t, _ in cmodel.calls if n == "compute_sim_matrix"]
    cmodel_size, cdev = cmodel.model_size, cmodel.device.type
    nmodel_size, ndev = nmodel.model_size, nmodel.device.type
    fusion = nmodel.config.text.fusion_layer
    del cmodel, nmodel, clip_run["model"], nlvr_run["model"]
    torch.cuda.empty_cache()
    t_d = time.time()
    l14_launches, l14 = clip_l14_towers(torch, wrappers, batches)
    d_s = time.time() - t_d
    albef_err = albef_depth2_vs_cpu(torch, nlvr_ann)

    say(f"zoo CLIP retrieval (clip_ret_coco_eval.yaml, model.model_size={CLIP_EVAL_SIZE}: "
        f"ViT-B/16 at 224², 197 tokens, fp32, {ZOO_IMAGES} images x "
        f"{ZOO_IMAGES * ZOO_CAPTIONS} texts): metrics {clip_run['logs']}; compute_sim_matrix "
        f"{[round(t, 3) for t in sim_s]} s; wall "
        f"{clip_run['wall']:.1f} s; equal to the wrapper's own call on the loader's batches "
        f"{clip_rows_equal}; its call on the first batch alone within {first_err:.1e}; {card}")
    image_counts, text_counts = l14["counts"]["image"], l14["counts"]["text"]
    say(f"zoo CLIP {CLIP_L14} towers, bf16 module (kernels), {ZOO_IMAGES} images in one batch "
        f"and {ZOO_IMAGES * ZOO_CAPTIONS} captions in batches of {CLIP_TEXT_BATCH}: launches per "
        f"image batch { {k: v for k, v in image_counts[0].items() if v} }, per text batch "
        f"{ {k: v for k, v in text_counts[0].items() if v} }; against its plain versions on "
        f"the card: min row cosine {l14['bf16_cos']}, max |diff| / max {l14['bf16_err']}; "
        f"s kernels / plain: images {l14['bf16_s']['image'][0]:.4f} / "
        f"{l14['bf16_s']['image'][1]:.4f}, texts {l14['bf16_s']['text'][0]:.4f} / "
        f"{l14['bf16_s']['text'][1]:.4f}; {card}")
    say(f"zoo CLIP {CLIP_L14} fp32 wrapper: compute_sim_matrix {l14['sims_shape']} in "
        f"{l14['fp32_s']:.3f} s, launches { {k: v for k, v in l14['fp32_launches'].items() if v} }"
        f"; depth {REDUCED_DEPTH} card vs CPU max |diff| / max {l14['depth2_err']:.2e} "
        f"(kernel 4 fp32 launches {l14['depth2_flash']}); RN50 full width fp32 card vs CPU on "
        f"{CLIP_RN50_IMAGES} images {l14['rn50_err']}; part (d) {d_s:.1f} s; {card}")
    say(f"zoo NLVR (nlvr_eval.yaml, model.model_size=base: ALBEF base, fusion at layer "
        f"{fusion}, fp32, {ZOO_NLVR_PAIRS} synthetic pairs): metrics {nlvr_run['logs']}; wall "
        f"{nlvr_run['wall']:.1f} s; the first batch's predictions equal to the wrapper's own "
        f"call {nlvr_equal}; depth {REDUCED_DEPTH} card vs CPU logits max |diff| / max "
        f"{albef_err:.2e}; (c)-(e) {time.time() - part_start:.1f} s; {card}")
    for name, run in runs.items():
        require(not any(run["launches"].values()), f"phase 28 {name}: kernels launched "
                f"{ {k: v for k, v in run['launches'].items() if v} } (none on this path)")
        require(all(math.isfinite(v) for v in run["logs"].values() if isinstance(v, float)),
                f"phase 28 {name}: {run['logs']}")
    require(cmodel_size == CLIP_EVAL_SIZE and cdev == "cuda" and clip_rows_equal
            and {"txt_r1", "img_r1", "r_mean"} <= set(clip_run["logs"])
            and sims.shape == (ZOO_IMAGES, ZOO_IMAGES * ZOO_CAPTIONS),
            f"phase 28 (c): {clip_run['logs']}, rows equal {clip_rows_equal}")
    for counts, expected, what in ((image_counts, EXPECTED_CLIP_IMAGE_LAUNCHES, "image"),
                                   (text_counts, EXPECTED_CLIP_TEXT_LAUNCHES, "text")):
        for c in counts:
            require({k: c[k] for k in expected} == expected
                    and not any(v for k, v in c.items() if k not in expected),
                    f"phase 28 (d) {what} batch launches {c}, expected {expected}")
    require(min(l14["bf16_cos"].values()) >= CLIP_BF16_COSINE_MIN,
            f"phase 28 (d) bf16 against its plain versions: {l14['bf16_cos']}")
    require(l14["fp32_launches"]["flash_attention"] == 24 * new_image_batches(batches)
            and not any(v for k, v in l14["fp32_launches"].items() if k != "flash_attention")
            and l14["sims_finite"] and l14["depth2_flash"] == REDUCED_DEPTH
            and l14["depth2_err"] <= CLIP_CPU_REL_TOL,
            f"phase 28 (d) fp32: launches {l14['fp32_launches']}, depth 2 {l14['depth2_err']}")
    require(max(l14["rn50_err"].values()) <= FP32_PATH_REL_TOL and l14["rn50_stride_ok"],
            f"phase 28 (d) RN50 card vs CPU: {l14['rn50_err']}")
    require(nmodel_size == "base" and ndev == "cuda" and fusion == 6 and nlvr_equal
            and nlvr_run["logs"]["total"] == ZOO_NLVR_PAIRS
            and albef_err <= CLIP_CPU_REL_TOL,
            f"phase 28 (e): {nlvr_run['logs']}, equal {nlvr_equal}, depth 2 {albef_err}")
    say("zoo CLIP and ALBEF gates passed: (c) and (e) finite at base width, equal to the "
        f"wrappers' own calls, no kernel launched; (d) kernels 1 and 4 in the predicted counts, "
        f"bf16 within cosine {CLIP_BF16_COSINE_MIN} of the plain versions, depth {REDUCED_DEPTH} "
        f"within {CLIP_CPU_REL_TOL} and RN50 within {FP32_PATH_REL_TOL} of the CPU")
    return {k: runs["clip_ret_coco_eval"]["launches"][k] + runs["nlvr_eval"]["launches"][k]
            + l14_launches[k] for k in wrappers}


def new_image_batches(batches):
    """The batches that bring an image not seen before: the CLIP wrapper's
    image-tower calls over them."""
    seen, n = set(), 0
    for batch in batches:
        ids = set(batch["image_id"]) - seen
        n += bool(ids)
        seen |= ids
    return n


def zoo_entry_point(torch, wrappers, card):
    """Phase 28: ``mr_blip_tpu_torch.evaluate.main`` on
    configs/projects/zoo/caption_coco_eval.yaml and ret_coco_eval.yaml at
    base width (see ZOO_IMAGES); the metrics finite, the evaluation's first
    batch equal to the wrapper's own call on its rows (captions; score_i2t
    rows), no kernel launched; then ``zoo_depth2_vs_cpu``; then the CLIP and
    ALBEF parts (``clip_albef_entry_points``). Returns the launches of the
    phase: 0 in the four evaluations, the CLIP ViT-L/14 towers' in (d)."""
    import tempfile

    import numpy as np

    from mr_blip_tpu_torch import evaluate
    from mr_blip_tpu_torch.datasets.base_dataset import default_collate
    from mr_blip_tpu_torch.datasets.image_datasets import CaptionDataset, RetrievalDataset
    from mr_blip_tpu_torch.processors.text_processors import BlipCaptionProcessor

    phase_start = time.time()
    gc.collect()
    torch.cuda.empty_cache()
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        ann = zoo_annotations(Path(tmp) / "ann.json")
        for name, ds, extra in (("caption_coco_eval", "coco_caption", []),
                                ("ret_coco_eval", "coco_retrieval", ["model.model_type=coco"])):
            out_dir = Path(tmp) / name
            argv = ["--cfg-path", str(ROOT / f"configs/projects/zoo/{name}.yaml"), "--options",
                    *(f"datasets.{ds}.build_info.annotations.{split}.storage={ann}"
                      for split in ("train", "val", "test")),
                    f"datasets.{ds}.build_info.images.storage=synthetic://",
                    f"run.output_dir={out_dir}", *extra]
            built = []
            torch.cuda.synchronize()
            resident = torch.cuda.memory_allocated()  # what earlier phases still hold
            torch.cuda.reset_peak_memory_stats()
            for w in wrappers.values():
                w.launches = 0
            t0 = time.time()
            with captured_zoo_models(torch, built):
                logs = evaluate.main(argv)
            torch.cuda.synchronize()
            runs[name] = {"logs": logs["test"], "wall": time.time() - t0, "model": built[0],
                          "launches": {k: w.launches for k, w in wrappers.items()},
                          "peak": (torch.cuda.max_memory_allocated() - resident) / 2**30,
                          "rows": [json.loads(f.read_text()) for f in
                                   out_dir.glob("*/result/test_epochbest.json")]}
            require(len(built) == 1, f"phase 28 {name}: {len(built)} models built")
        cap, ret = runs["caption_coco_eval"], runs["ret_coco_eval"]
        # the wrapper's own call on the evaluation's first batch (the loader's
        # rows 0-63 in order, collated as the loader collates them)
        ds_cap = CaptionDataset(text_processor=BlipCaptionProcessor(), vis_root="synthetic://",
                                ann_paths=[ann])
        first = default_collate([ds_cap[i] for i in range(64)])
        model = cap["model"]
        gen_s = [t for name, t, _ in model.calls if name == "generate"]  # the evaluation's
        mine = model.generate(first, max_length=30, num_beams=3, min_length=5)["captions"]
        by_image = {r["image_id"]: r["caption"] for r in cap["rows"][0]}
        cap_equal = all(by_image[i] == c for i, c in zip(first["image_id"], mine))
        ds_ret = RetrievalDataset(text_processor=BlipCaptionProcessor(),
                                  vis_root="synthetic://", ann_paths=[ann])
        rmodel = ret["model"]
        score_i2t = next(res for name, _, res in rmodel.calls
                         if name == "compute_sim_matrix")[0]
        batches = [default_collate([ds_ret[i] for i in range(lo, min(lo + 64, len(ds_ret)))])
                   for lo in range(0, len(ds_ret), 64)]
        gallery = rmodel.gallery(batches)
        first_images = sorted({int(i[3:]) for i in batches[0]["image_id"]})
        rows_equal = all(np.array_equal(rmodel.rerank_i2t(gallery, i), score_i2t[i])
                         for i in first_images)
        sim_s = [t for name, t, _ in rmodel.calls if name == "compute_sim_matrix"]
        for run in runs.values():
            run["model"] = (run["model"].model_size, run["model"].device.type)
        del model, rmodel, gallery
        torch.cuda.empty_cache()
    errs, greedy_equal = zoo_depth2_vs_cpu(torch)
    say(f"zoo captioning (configs/projects/zoo/caption_coco_eval.yaml as published: "
        f"blip_caption base_coco, ViT-B/16 at 224², BERT-base, fp32, beam 3, 5-30 tokens, "
        f"{ZOO_IMAGES} synthetic images x {ZOO_CAPTIONS} captions, batches of 64): metrics "
        f"{cap['logs']}; s per generate batch {[round(t, 3) for t in gen_s]}; wall "
        f"{cap['wall']:.1f} s; peak {cap['peak']:.2f} GiB above what earlier phases hold; the "
        f"first batch's captions equal "
        f"to the wrapper's own call {cap_equal}; first captions {mine[:2]}")
    say(f"zoo retrieval (ret_coco_eval.yaml, model.model_type=coco: blip_retrieval base, "
        f"k_test 128, {ZOO_IMAGES} images x {ZOO_IMAGES * ZOO_CAPTIONS} texts): metrics "
        f"{ret['logs']}; compute_sim_matrix {[round(t, 3) for t in sim_s]} s (the ITC pass, "
        f"{ZOO_IMAGES} i2t and {ZOO_IMAGES * ZOO_CAPTIONS} t2i reranks); wall "
        f"{ret['wall']:.1f} s; peak {ret['peak']:.2f} GiB above; score_i2t rows of the first "
        f"batch's {len(first_images)} images equal to the wrapper's own rerank {rows_equal}")
    say(f"zoo depth {REDUCED_DEPTH} at base width, card vs CPU (fp32): max |diff| / max "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + f"; greedy caption ids equal {greedy_equal}; phase 28 "
        f"{time.time() - phase_start:.1f} s; {card}")
    for name, run in runs.items():
        require(not any(run["launches"].values()), f"phase 28 {name}: kernels launched "
                f"{ {k: v for k, v in run['launches'].items() if v} } (none on this path)")
        require(all(math.isfinite(v) for v in run["logs"].values() if isinstance(v, float))
                and run["model"] == ("base", "cuda"), f"phase 28 {name}: {run['logs']}")
    require(cap["logs"]["total"] == ZOO_IMAGES and len(gen_s) == ZOO_IMAGES * ZOO_CAPTIONS // 64
            and cap_equal, f"phase 28 captioning: {cap['logs']}, {len(gen_s)} batches, first "
            f"batch equal {cap_equal}")
    require({"txt_r1", "img_r1", "r_mean"} <= set(ret["logs"]) and rows_equal
            and score_i2t.shape == (ZOO_IMAGES, ZOO_IMAGES * ZOO_CAPTIONS),
            f"phase 28 retrieval: {ret['logs']}, rows equal {rows_equal}")
    require(max(errs.values()) <= FP32_PATH_REL_TOL and greedy_equal,
            f"phase 28 depth {REDUCED_DEPTH} card vs CPU: {errs}, greedy equal {greedy_equal}")
    say(f"zoo gates passed: both configs' metrics finite at base width, the first batch "
        f"equal to the wrapper's own call, no kernel launched, depth {REDUCED_DEPTH} within "
        f"{FP32_PATH_REL_TOL} of the CPU")
    # (c)-(e): the CLIP and ALBEF families
    with tempfile.TemporaryDirectory() as tmp:
        clip_albef = clip_albef_entry_points(torch, wrappers, card, tmp,
                                             zoo_annotations(Path(tmp) / "ann.json"))
    say(f"phase 28: {time.time() - phase_start:.1f} s; {card}")
    return {k: cap["launches"][k] + ret["launches"][k] + clip_albef[k] for k in wrappers}



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
    log = (lib.parent / "ptxas.log").read_text().splitlines()
    for line in log:
        if "Used" in line or "spill" in line or "C75" in line:
            say("  ptxas:", line.strip())
    say(f"  ptxas: {sum('C75' in line for line in log)} C75xx lines (serialized or "
        "drained wgmma)")

    wrappers, kernels = kernel_tables()
    marks = [start]

    def done(phases):
        """Prints the seconds the phases just run took."""
        marks.append(time.time())
        say(f"phase {phases}: {marks[-1] - marks[-2]:.1f} s (at {marks[-1] - start:.1f} s)")

    done("1-2")
    # phase 3: kernel vs plain
    check_kernels(torch, kernels)
    check_flash_kernel(torch, kernels)
    check_train_kernels(torch, kernels)
    tp_kernel_times = check_tp_kernels(torch, kernels)
    check_relpos_kernels(torch, kernels)
    check_int8_kernels(torch, kernels)
    done(3)
    # phase 4: the generate path at full width (kernels 1-3)
    launches, bf16_summary = main_path(torch, wrappers)
    done(4)
    # phase 5: kernel path vs plain path, encoder outputs
    kernel_vs_plain_path(torch, wrappers)
    done(5)
    # phase 6: the LoRA train path at full width (kernels 5, 6, 8)
    train_launches = train_path(torch, wrappers)
    done(6)
    # phase 7: kernel path vs plain path, gradients (kernel 7 under full finetune)
    dbias_launches = gradients_kernel_vs_plain(torch, wrappers)
    gradients_kernel_vs_plain(torch, wrappers, fp32=True)
    done(7)
    # phase 8: the int8 generate path at full width and depth (kernels 13-16)
    int8_launches, int8_summary = main_path(torch, wrappers, int8=True,
                                            new_tokens=SHORT_NEW_TOKENS)
    say(generates_side_by_side("generate, bf16 (phase 4) vs int8 (phase 8)", bf16_summary,
                               int8_summary))
    done(8)
    # phase 9: int8 kernel path vs int8 plain path, and int8 vs bf16
    int8_kernel_vs_plain_path(torch, wrappers)
    done(9)
    # phase 10: long-context generate at full depth and width (kernel 9), bf16
    # and int8, and one materialized-bias run of the same batches beside them
    long_launches, long_summary = main_path(torch, wrappers, long=True,
                                            new_tokens=SHORT_NEW_TOKENS)
    _, long_int8_summary = main_path(torch, wrappers, int8=True, long=True,
                                     new_tokens=SHORT_NEW_TOKENS)
    _, long_mat_summary = main_path(torch, wrappers, long=True, relpos_in_kernel=False,
                                    new_tokens=SHORT_NEW_TOKENS)
    say(f"long-context generate (4 x {LONG_FRAMES} frames, encoder length "
        f"{long_summary['encoder_length']}, {SHORT_NEW_TOKENS} decode steps), in-kernel bias "
        "bf16 / in-kernel bias int8 / "
        "materialized bias bf16 (kernel 3), seconds: " + ", ".join(
            f"{k} " + " / ".join(f"{x[k]:.3f}" for x in (long_summary, long_int8_summary,
                                                         long_mat_summary))
            for k in ("steady_s", "first_s", "frames_to_qformer_s", "t5_encode_s", "decode_s"))
        + "; peak memory " + " / ".join(
            f"{x['peak_gib']:.2f}" for x in (long_summary, long_int8_summary,
                                             long_mat_summary)) + " GiB")
    done(10)
    # phase 11: the long-context LoRA train step (kernels 9, 10, 12)
    long_train_launches = train_path(torch, wrappers, long=True)
    done(11)
    # phase 12: long context, kernel path vs plain path (kernel 11 under full finetune)
    dtable_launches = gradients_kernel_vs_plain(torch, wrappers, long=True)
    gradients_kernel_vs_plain(torch, wrappers, long=True, fp32=True)
    done(12)
    # phase 13: generate at 364 pixels (kernel 4), then the fp32 parity mode
    big_launches, big_summary = main_path(torch, wrappers, img_size=BIG_IMG,
                                          new_tokens=SHORT_NEW_TOKENS)
    say(generates_side_by_side(f"generate at 224² (phase 4) vs {BIG_IMG}² (phase 13)",
                               bf16_summary, big_summary))
    _, big_int8_summary = main_path(torch, wrappers, int8=True, img_size=BIG_IMG,
                                    new_tokens=SHORT_NEW_TOKENS)
    say(generates_side_by_side(f"generate at {BIG_IMG}², bf16 vs int8 (the ViT's split route)",
                               big_summary, big_int8_summary)
        + f" (int8 with kernel 14's fp32 hidden workspace: {INT8_BIG_PEAK_FP32_HIDDEN_GIB} GiB)")
    fp32_path(torch, wrappers)
    done(13)
    # phase 14: two-stage grounded QA at 364 pixels
    qa_path(torch, wrappers)
    done(14)
    # phase 15: 364 pixels and QA, kernel path vs plain path
    qa_kernel_vs_plain_path(torch, wrappers)
    done(15)
    # phase 16: the evaluation entry point on configs/projects/eval/qvh.yaml
    eval_launches, eval_summary = evaluation_entry_point(torch, wrappers, smi)
    say(f"generate batch (phase 4, {bf16_summary['decode_steps']} new tokens) vs evaluation "
        f"batch (phase 16, {SHORT_NEW_TOKENS}), seconds: steady "
        f"{bf16_summary['steady_s']:.3f} vs {eval_summary['steady_s']:.3f}, first "
        f"{bf16_summary['first_s']:.3f} vs {eval_summary['first_s']:.3f}; peak memory "
        f"{bf16_summary['peak_gib']:.2f} vs {eval_summary['peak_gib']:.2f} GiB; evaluation "
        f"launches of kernels 1-3 { {k: eval_launches[k] for k in GENERATE_KERNELS} }")
    done(16)
    # phase 17: the train entry point on configs/projects/train/qvh.yaml
    train_entry_launches, train_entry_summary = train_entry_point(torch, wrappers, smi)
    done(17)
    # phase 18: the grounded-QA evaluation entry point on configs/projects/eval/nextGQA.yaml
    qa_entry_launches, _ = qa_entry_point(torch, wrappers, smi)
    done(18)
    # phase 19: the OPT variant's evaluation entry point on
    # configs/projects/eval/opt_charades.yaml, a LoRA step, depth 2 vs plain
    opt_entry_launches, _ = opt_entry_point(torch, wrappers, smi)
    done(19)
    # phase 20: online serving at full width (load_model, the server, HTTP,
    # python -m mr_blip_tpu_torch.serve)
    serve_launches, serve_summary, serve_model = serving_entry_point(torch, wrappers, smi,
                                                                      bf16_summary)
    done(20)
    # phase 21: QLoRA-style training at full width (int8_base, int8 ViT)
    qlora_launches = qlora_entry_point(torch, wrappers, smi, train_entry_summary)
    done(21)
    # phase 22: data and sequence parallelism, two ranks on the one card
    dp_launches = parallel_entry_points(torch, smi)
    done(22)
    # phase 23: the reference-checkpoint import (in memory at full width, the
    # file route at depth 2) and the BLIP2_MR variants at full width
    t23 = time.time()
    torch.cuda.reset_peak_memory_stats()
    imported = import_round_trip(torch, wrappers, smi)
    import_file_route(torch, smi)
    variant_launches = variants_path(torch, wrappers, smi, imported)
    del imported
    torch.cuda.empty_cache()
    say(f"[{smi}] phase 23: {time.time() - t23:.1f} s, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    done(23)
    # phase 24: the unfrozen-ViT train path (the train entry point with
    # model.freeze_vit=False, a profiled micro-batch, depth 2 against the CPU)
    unfrozen_launches = unfrozen_vit_entry_point(torch, wrappers, smi)
    unfrozen_vit_vs_plain(torch, wrappers, smi)
    done(24)
    # phase 25: the real vocabulary (the committed tokenizer directories
    # through the port's reader, the flagship under the Flan-T5-shaped one
    # on phase 4's weights), the offline scorer and the asset-day gates
    vocab_launches = vocabulary_entry_point(torch, wrappers, smi, bf16_summary,
                                            eval_summary["metrics"])
    done(25)
    # phase 26: tensor parallelism (two ranks, tp=2) and the dp server (phase
    # 20's model with a second replica)
    pp_ranks = []
    tp_launches = tp_entry_point(torch, smi, bf16_summary, pp_ranks)
    say("tp=2 kernels 3, 5, 6, 8 at 16 heads (phase 3), ms kernel / plain / bound: " + "; ".join(
        f"{k} {v[0]:.4f} / {v[1]:.4f} / {v[2]:.4f}" for k, v in tp_kernel_times.items()))
    dp_serve_launches = dp_server_entry_point(torch, wrappers, smi, serve_model, serve_summary)
    del serve_model
    done(26)
    # phase 27: pipeline parallelism (run in phase 26 (a)'s two-rank launch:
    # Flan-T5-XL over two stages against one process, the planted faults)
    pp_launches = pipeline_report(pp_ranks, smi)
    done(27)
    # phase 28: the BLIP-v1 zoo's evaluation entry points at base width
    zoo_launches = zoo_entry_point(torch, wrappers, smi)
    done(28)

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
        entry["train_entry_launches"] = train_entry_launches[key]
        entry["qa_entry_launches"] = qa_entry_launches[key]
        entry["opt_entry_launches"] = opt_entry_launches[key]
        entry["serve_launches"] = serve_launches[key]
        entry["qlora_launches"] = qlora_launches[key]
        entry["dp_launches"] = dp_launches[key]
        entry["variant_launches"] = variant_launches[key]
        entry["unfrozen_launches"] = unfrozen_launches[key]
        entry["vocab_launches"] = vocab_launches[key]
        entry["tp_launches"] = tp_launches[key]
        entry["dp_serve_launches"] = dp_serve_launches[key]
        entry["pp_launches"] = pp_launches.get(key, 0)
        entry["zoo_launches"] = zoo_launches[key]
    say(f"wall time {time.time() - start:.1f} s")
    say(json.dumps({"kernels": [
        {k: entry[k] for k in ("name", "route", "source", "replaces", "launches",
                               "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                               "library_ms", "train_entry_launches", "qa_entry_launches",
                               "opt_entry_launches", "serve_launches", "qlora_launches",
                               "dp_launches", "variant_launches", "unfrozen_launches",
                               "vocab_launches", "tp_launches", "dp_serve_launches",
                               "pp_launches", "zoo_launches")}
        for entry in kernels.values()]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-worker"]:
        dp_worker(sys.argv[2:])
    else:
        main()
