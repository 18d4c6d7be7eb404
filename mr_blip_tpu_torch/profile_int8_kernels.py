"""Times of the W8A8 kernels at the main path's shapes, piece by piece.

    python3 -m mr_blip_tpu_torch.profile_int8_kernels

Needs one CUDA card. Prints the card's name and power limit, then one JSON
line each for:

* every W8A8 wrapper at each shape the int8 generate batch of 4 x 60 frames
  gives it (CUDA events, median of 10 launches), with the int8 TOP/s its
  products reach;
* the device kernels inside one ``w8a8_mlp``, one ``w8a8_mlp_gated`` and one
  ``w8a8_attn_block`` call (``torch.profiler``): the quantization passes, the
  int8 GEMMs by epilogue, the requantization pass and the attention phase;
* the bf16 products the int8 GEMMs replace, as PyTorch runs them (cuBLAS):
  a yardstick only, the port never takes it for an int8 layer.

Random inputs and weights from a seed; nothing is checked here
(``chip_smoke.py`` holds each kernel against its plain version).
"""

from __future__ import annotations

import json
import statistics
import subprocess

import torch

from mr_blip_tpu_torch.ops import int8_matmul as i8

_VIT_ROWS, _VIT_D, _VIT_H = 240 * 257, 1408, 6144
_T5_ROWS, _T5_D, _T5_FF = 4 * 2056, 2048, 5120


def _median_ms(fn, iters=10, warmup=2):
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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_int8_kernels: no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

    def qw(k, n):
        w = torch.randn(k, n, generator=gen, device="cuda") * 0.02
        s = i8.div_exact(w.abs().amax(dim=0).clamp_min(1e-8), 127.0)
        return i8.k_major(torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)), s

    def vec(n, scale=0.05, offset=0.0):
        return randn(n, scale=scale, dtype=torch.float32) + offset

    x = randn(_VIT_ROWS, _VIT_D, scale=0.5)
    x2 = randn(_T5_ROWS, _T5_D, scale=0.5)
    ln = ("ln", vec(_VIT_D, offset=1.0), vec(_VIT_D), 1e-6)
    rms = ("rms", vec(_T5_D, offset=1.0), None, 1e-6)
    w_kv, s_kv = qw(_VIT_D, 1536)
    w_qkv, s_qkv = qw(_T5_D, 3 * _T5_D)
    w_o, s_o = qw(_T5_D, _T5_D)
    w1, s1 = qw(_VIT_D, _VIT_H)
    w2, s2 = qw(_VIT_H, _VIT_D)
    b1, b2, b_kv = vec(_VIT_H), vec(_VIT_D), vec(1536)
    g0, t0 = qw(_T5_D, _T5_FF)
    g1, t1 = qw(_T5_D, _T5_FF)
    go, to = qw(_T5_FF, _T5_D)
    a_qkv, sa_qkv = qw(_VIT_D, 3 * _VIT_D)
    a_p, sa_p = qw(_VIT_D, _VIT_D)
    a_qb, a_pb = vec(3 * _VIT_D), vec(_VIT_D)
    x3 = x.reshape(240, 257, _VIT_D)

    def mlp():
        return i8.w8a8_mlp(x, w1, s1, b1, w2, s2, b2, norm=ln, residual=x)

    def gated():
        return i8.w8a8_mlp_gated(x2, g0, t0, g1, t1, go, to, norm=rms, residual=x2)

    def block():
        return i8.w8a8_attn_block(x3, a_qkv, sa_qkv, a_qb, a_p, sa_p, a_pb, norm=ln,
                                  num_heads=16)

    m, d, h = _VIT_ROWS, _VIT_D, _VIT_H
    m2, d2, ff = _T5_ROWS, _T5_D, _T5_FF
    cases = [
        ("w8a8_linear Q-Former K/V (61680, 1408) x 1536, bias",
         lambda: i8.w8a8_linear(x, w_kv, s_kv, b_kv), 2.0 * m * d * 1536),
        ("w8a8_linear T5 qkv (8224, 2048) x 6144, RMS",
         lambda: i8.w8a8_linear(x2, w_qkv, s_qkv, norm=rms), 2.0 * m2 * d2 * 3 * d2),
        ("w8a8_linear T5 o (8224, 2048) x 2048, residual",
         lambda: i8.w8a8_linear(x2, w_o, s_o, residual=x2), 2.0 * m2 * d2 * d2),
        ("w8a8_mlp (61680, 1408, 6144)", mlp, 4.0 * m * d * h),
        ("w8a8_mlp_gated (8224, 2048, 5120)", gated, 6.0 * m2 * d2 * ff),
        ("w8a8_attn_block (240, 257, 1408)", block, 2.0 * m * d * 4 * d),
    ]
    for name, fn, int8_ops in cases:
        ms = _median_ms(fn)
        print(json.dumps({"call": name, "ms": ms,
                          "int8_top_s": int8_ops / ms / 1e9}), flush=True)

    for name, fn in (("w8a8_mlp", mlp), ("w8a8_mlp_gated", gated),
                     ("w8a8_attn_block", block)):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        parts = [[e.key[:60], e.count, e.device_time_total / 1e3]
                 for e in sorted(prof.key_averages(), key=lambda e: -e.device_time_total)
                 if e.device_time_total > 0]
        print(json.dumps({"inside": name, "device_kernels_ms": parts}), flush=True)

    for name, a, k, n in (("ViT fc1", x, d, h), ("ViT qkv", x, d, 3 * d),
                          ("T5 wi_0", x2, d2, ff)):
        w = randn(k, n, scale=0.02)
        ms = _median_ms(lambda: a @ w)
        print(json.dumps({"bf16_product": f"{name} ({a.shape[0]}, {k}) x {n}", "ms": ms,
                          "tflop_s": 2.0 * a.shape[0] * k * n / ms / 1e9}), flush=True)


if __name__ == "__main__":
    main()
