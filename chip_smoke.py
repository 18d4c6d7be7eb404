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
   version (fp32 math from the same bf16 inputs) at the generate path's
   shapes and the ragged ones, max |diff| <= 0.02 with no NaN, and both
   times (CUDA events, median of 10 launches);
4. main path: ``BLIP2_MR(...).generate`` at full EVA ViT-g + Q-Former +
   Flan-T5-XL width with random weights, 3 batches of 4 videos x 60 uint8
   frames; every kernel's launch count must rise by its expected number per
   batch, predictions must parse and beam scores be finite;
5. kernel path vs plain path: one reduced-depth full-width model, its T5
   rel-pos table redrawn at N(0, 1) so the bias moves the attention, run in
   bf16 on the CPU (plain versions) and on the card (kernels); the T5
   encoder outputs must agree row by row (cosine >= 0.999), and the plain
   path with the bias left out must not (so a kernel that dropped the bias
   would fail).

The line before the last is one JSON object with every kernel's numbers;
the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = 0.02  # max |kernel - plain|, as for the TPU kernels (bf16 outputs)
COSINE_MIN = 0.999
N_FRAMES, BATCH, N_BATCHES = 60, 4, 3
REDUCED_DEPTH = 2  # layers per stack in phase 5
# Per generate batch at the flagship depth: LayerNorm 78 (ViT norm1/norm2 x 39)
# + 1 (ln_vision) + 31 (Q-Former); packed QKV once per ViT block; biased
# flash once per T5 encoder layer.
EXPECTED_LAUNCHES = {"layer_norm": 110, "qkv_packed_attention": 39,
                     "flash_bias_attention": 24}


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


def max_err(torch, got, want):
    require(not torch.isnan(got).any(), "kernel output has NaN")
    require(bool(torch.isfinite(got).all()), "kernel output not finite")
    return float((got.float() - want.float()).abs().max())


# --------------------------------------------------------------- phase 3
def check_kernels(torch, kernels):
    from mr_blip_tpu_torch.ops import flash_attention as fa
    from mr_blip_tpu_torch.ops.layer_norm import _ln_reference, fused_layer_norm

    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    # LayerNorm: weights near 1 keep |y| < 8, where bf16 rounds within 0.016.
    ln = kernels["layer_norm"]
    for rows, d, eps, flagship in ((61680, 1408, 1e-6, True),
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
            line += f"  kernel {ln['ms']:.4f} ms  plain {ln['plain_ms']:.4f} ms"
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
            line += f"  kernel {qk['ms']:.4f} ms  plain {qk['plain_ms']:.4f} ms"
        say(line)
        require(err <= TOL, f"qkv_packed ({b}, {n}) off by {err}")
        qk["max_abs_err"] = max(qk.get("max_abs_err", 0.0), err)

    fb = kernels["flash_bias_attention"]
    heads, d = 32, 64
    for b, n, m, mask_kind, flagship in ((4, 2049, 2049, "tail", False),
                                         (4, 2056, 2056, None, True),
                                         (4, 2040, 2048, "tail", False),
                                         (2, 300, 300, None, False),
                                         (2, 300, 300, "row1_all", False)):
        q = randn(b, n, heads, d)
        k, v = randn(b, m, heads, d), randn(b, m, heads, d)
        bias = randn(1, heads, n, m)
        kv_mask = None
        check_rows = slice(0, b)
        if mask_kind == "tail":
            lengths = torch.tensor([m, m - 1, m - 100, 1500], device=dev)
            kv_mask = (torch.arange(m, device=dev)[None] < lengths[:, None]).to(torch.int8)
        elif mask_kind == "row1_all":
            kv_mask = torch.ones(b, m, dtype=torch.int8, device=dev)
            kv_mask[1] = 0
            check_rows = slice(0, 1)
        got = fa.flash_attention_bias(q, k, v, bias, kv_mask)
        torch.cuda.synchronize()
        want = fa._flash_bias_reference(q.float(), k.float(), v.float(),
                                        bias.float(), kv_mask)
        require(bool(torch.isfinite(got).all()), f"flash_bias ({b}, {n}x{m}) not finite")
        err = max_err(torch, got[check_rows], want[check_rows])
        line = (f"flash_bias ({b}, {n}x{m}, {heads}, {d}) mask {mask_kind}: "
                f"max|diff| {err:.5f}")
        if flagship:
            fb["ms"] = median_ms(torch, lambda: fa.flash_attention_bias(q, k, v, bias, kv_mask))
            fb["plain_ms"] = median_ms(
                torch, lambda: fa._flash_bias_reference(q, k, v, bias, kv_mask))
            line += f"  kernel {fb['ms']:.4f} ms  plain {fb['plain_ms']:.4f} ms"
        say(line)
        require(err <= TOL, f"flash_bias ({b}, {n}x{m}) mask {mask_kind} off by {err}")
        fb["max_abs_err"] = max(fb.get("max_abs_err", 0.0), err)

    # A CUDA call the dispatch sends to the biased kernel, in a dtype the
    # kernel does not take, must raise rather than run plain.
    from mr_blip_tpu_torch.ops.attention import dot_product_attention

    before = fa.flash_attention_bias.launches
    q32 = randn(2, 300, heads, d, dtype=torch.float32)
    bias32 = randn(1, heads, 300, 300, dtype=torch.float32)
    try:
        dot_product_attention(q32, q32, q32, bias=bias32)
    except TypeError as exc:
        say(f"float32 biased attention on the card raises: {exc}")
    else:
        raise RuntimeError("float32 biased attention on the card ran plain")
    require(fa.flash_attention_bias.launches == before,
            "float32 biased attention counted a launch")
    del q, k, v, bias, qkv, x, q32, bias32
    torch.cuda.empty_cache()


# --------------------------------------------------------------- phase 4
def flagship_model(device="cuda"):
    from mr_blip_tpu_torch.models.blip2_mr import BLIP2_MR
    from mr_blip_tpu_torch.profile_inference import FLAGSHIP

    return BLIP2_MR(**FLAGSHIP, device=device)


def reduced_model(device, init_params=True):
    """The flagship model at full widths, every stack REDUCED_DEPTH deep."""
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
            super().__init__(**FLAGSHIP, init_params=False, device=device)
            self.qformer_config = dataclasses.replace(self.qformer_config,
                                                      num_layers=REDUCED_DEPTH)
            self.module = Blip2MRModule(
                self.vit_config, self.qformer_config, self.t5_config,
                compute_dtype=self.compute_dtype, device=self.device).eval()
            self.module.requires_grad_(False)
            if init_params:
                self.init_params(FLAGSHIP["seed"])

    return ReducedDepth()


def main_path(torch, wrappers):
    from mr_blip_tpu_torch.profile_inference import make_samples
    from mr_blip_tpu_torch.text.span_grammar import moment_str_to_list

    t0 = time.time()
    model = flagship_model()
    torch.cuda.synchronize()
    say(f"model built with random weights in {time.time() - t0:.1f} s; "
        f"{sum(p.numel() for p in model.module.parameters()) / 1e9:.3f} B params")
    batches = [make_samples(BATCH, N_FRAMES, seed) for seed in range(N_BATCHES)]
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
        say(f"batch {i}: {seconds[-1]:.3f} s  launches {rose}  "
            f"scores {[round(float(s), 4) for s in scores]}  "
            f"predictions {out['prediction']}")
        require(rose == EXPECTED_LAUNCHES, f"batch {i}: launches {rose}, "
                f"expected {EXPECTED_LAUNCHES}")
        require(len(out["prediction"]) == BATCH, "wrong number of predictions")
        for p in out["prediction"]:
            moment_str_to_list(p)
        require(bool(torch.isfinite(scores).all()), "beam scores not finite")
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
    say(f"main path: B={BATCH} x {N_FRAMES} frames, encoder length "
        f"{enc.shape[1]}; steady {steady:.3f} s/batch (batches 1-2), first "
        f"{seconds[0]:.3f} s; stages "
        + ", ".join(f"{k} {v:.3f}" for k, v in stage.items())
        + f" ({len(steps)} decode steps, {1e3 * stage['decode_s'] / len(steps):.1f} ms "
        f"each); peak memory {peak / 2**30:.2f} GiB")
    del model, enc, frames
    torch.cuda.empty_cache()
    return launches


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
    table = "t5.encoder.rel_bias.rel_embedding"
    gen = torch.Generator(device="cuda").manual_seed(1)
    state[table] = torch.randn(state[table].shape, generator=gen, device="cuda")
    gpu.load_state_dict(state)
    before = {name: w.launches for name, w in wrappers.items()}
    enc_gpu = encoder_outputs(torch, gpu, samples)
    rose = {name: w.launches - before[name] for name, w in wrappers.items()}
    require(all(rose.values()), f"reduced model skipped a kernel: {rose}")
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


# --------------------------------------------------------------------- main
def main():
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
    from mr_blip_tpu_torch.ops.flash_attention import (
        flash_attention_bias,
        flash_attention_qkv_packed,
    )
    from mr_blip_tpu_torch.ops.layer_norm import fused_layer_norm

    t0 = time.time()
    lib = _cuda.build()
    _cuda.library()
    say(f"kernels built and loaded in {time.time() - t0:.1f} s: {lib.relative_to(ROOT)}")
    for line in (lib.parent / "ptxas.log").read_text().splitlines():
        if "Used" in line or "spill" in line:
            say("  ptxas:", line.strip())

    wrappers = {"layer_norm": fused_layer_norm,
                "qkv_packed_attention": flash_attention_qkv_packed,
                "flash_bias_attention": flash_attention_bias}
    kernels = {
        "layer_norm": {"name": "layer_norm", "route": "cuda",
                       "source": "mr_blip_tpu_torch/csrc/layer_norm.cu",
                       "replaces": "mr_blip_tpu/ops/layer_norm.py:26"},
        "qkv_packed_attention": {
            "name": "qkv_packed_attention", "route": "cuda",
            "source": "mr_blip_tpu_torch/csrc/qkv_packed_attention.cu",
            "replaces": "mr_blip_tpu/ops/flash_attention.py:1446"},
        "flash_bias_attention": {
            "name": "flash_bias_attention", "route": "cuda",
            "source": "mr_blip_tpu_torch/csrc/flash_bias_attention.cu",
            "replaces": "mr_blip_tpu/ops/flash_attention.py:195"},
    }

    # phase 3: kernel vs plain
    check_kernels(torch, kernels)
    # phase 4: the main path at full width
    launches = main_path(torch, wrappers)
    # phase 5: kernel path vs plain path
    kernel_vs_plain_path(torch, wrappers)

    for key, entry in kernels.items():
        entry["launches"] = launches[key]
    say(json.dumps({"kernels": [
        {k: entry[k] for k in ("name", "route", "source", "replaces", "launches",
                               "max_abs_err", "ms", "plain_ms")}
        for entry in kernels.values()]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
