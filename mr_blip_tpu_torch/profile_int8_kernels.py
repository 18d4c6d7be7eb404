"""Times of the W8A8 kernels at the main path's shapes, piece by piece.

    python3 -m mr_blip_tpu_torch.profile_int8_kernels
    python3 -m mr_blip_tpu_torch.profile_int8_kernels --other DIR

Needs one CUDA card. Prints the card's name and power limit, then one JSON
line each for:

* every W8A8 wrapper at each shape the int8 generate batch of 4 x 60 frames
  gives it (CUDA events, median of 10 launches), with the int8 TOP/s its
  products reach;
* how many clusters of kernel 14's fc1 blocks the card holds at once, by
  cluster size (``cudaOccupancyMaxActiveClusters``);
* the device kernels inside one ``w8a8_mlp``, one ``w8a8_mlp_gated`` and one
  ``w8a8_attn_block`` call (``torch.profiler``): the quantization passes,
  kernel 14's fc1 (with the requantizing epilogue) and fc2, the other int8
  GEMMs by epilogue, kernel 15's requantization pass and the attention phase;
* the bf16 products the int8 GEMMs replace, as PyTorch runs them (cuBLAS):
  a yardstick only, the port never takes it for an int8 layer.

Random inputs and weights from a seed; nothing is checked here
(``chip_smoke.py`` holds each kernel against its plain version).

With ``--other DIR`` (another checkout's ``mr_blip_tpu_torch``, for example
the parent commit unpacked with ``git archive`` into a git-ignored directory)
it times kernel 1 (LayerNorm) and kernel 14 (``w8a8_mlp``) of both builds
instead, side by side in one process: each library is built from its own
``csrc`` and bound with its own checkout's C signatures (read from its
``ops/_cuda.py``), and launched on the same inputs in turns other, this,
this, other (CUDA events, median of 10 each; a kernel's number is the mean
of its turns), at the shapes of ``chip_smoke.py``'s phase 3; each output is
held against the other build's first (max |diff| and whether they are
equal). Then ``torch.profiler`` names the device kernels inside one call of
each build's ``w8a8_mlp``. One JSON line per shape and build.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import runpy
import statistics
import subprocess
from pathlib import Path

import torch
import torch.nn.functional as F

from mr_blip_tpu_torch.ops import _cuda
from mr_blip_tpu_torch.ops import int8_matmul as i8
from mr_blip_tpu_torch.ops import layer_norm as ln

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


def _device_kernels(fn):
    """[name, launches, device ms] of the device kernels inside one call."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [[e.key[:60], e.count, e.device_time_total / 1e3]
            for e in sorted(prof.key_averages(), key=lambda e: -e.device_time_total)
            if e.device_time_total > 0]


def _check(err, name):
    if err:
        raise RuntimeError(f"{name}: cudaError_t {err}")


def _layer_norm_launcher(lib, n_args, x, w, b, out, eps):
    """LayerNorm through a build's C entry: this checkout's names its kernel
    (``_ln_plan``), an older one takes none."""
    stream = torch.cuda.current_stream().cuda_stream
    rows, d = x.shape
    extra = []
    if n_args == len(_cuda._SIGNATURES["mrb_layer_norm_bf16"]):
        extra = [ln._LN_KERNELS[ln._ln_plan(d, x.data_ptr(), out.data_ptr(), w.data_ptr(),
                                            b.data_ptr())]]

    def launch():
        _check(lib.mrb_layer_norm_bf16(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                                       out.data_ptr(), rows, d, eps, *extra, stream),
               "mrb_layer_norm_bf16")
        return out
    return launch


def _mlp_launcher(lib, n_args, x, weights, norm, residual, out):
    """``w8a8_mlp`` through a build's C entry: this checkout's takes xq, sa,
    hq, sh and fc1's cluster size; an older one also an fp32 hidden (h32)
    and no cluster."""
    stream = torch.cuda.current_stream().cuda_stream
    m, d = x.shape
    hdim = weights[0].shape[1]
    block_h = i8._pick_block(hdim, i8.DEFAULT_BLOCK_H)
    xq, sa, hq, sh = i8._mlp_workspace(m, d, hdim, hdim // block_h, x.device)
    if n_args == len(_cuda._SIGNATURES["mrb_w8a8_mlp"]):
        tail = [xq, sa, hq, sh], [i8._mlp_plan(hdim, block_h)[1]]
    else:
        h32 = torch.empty((m, hdim), dtype=torch.float32, device=x.device)
        tail = [xq, sa, h32, hq, sh], []
    _, ls, lb, eps = norm

    def launch():
        _check(lib.mrb_w8a8_mlp(
            x.data_ptr(), ls.data_ptr(), lb.data_ptr(), 1, eps,
            *[t.data_ptr() for t in weights], residual.data_ptr(), out.data_ptr(),
            *[t.data_ptr() for t in tail[0]], m, d, hdim, block_h, *tail[1], stream),
            "mrb_w8a8_mlp")
        return out
    return launch


def compare_with(other: Path) -> None:
    """Kernels 1 and 14 of this build beside another checkout's."""
    entries = ("mrb_layer_norm_bf16", "mrb_w8a8_mlp")
    other_pkg = other.resolve() / "mr_blip_tpu_torch"
    other_sigs = runpy.run_path(str(other_pkg / "ops" / "_cuda.py"))["_SIGNATURES"]
    builds = {
        "other": (_cuda.load(_cuda.build(other_pkg / "csrc", _cuda.BUILD_ROOT / "other"),
                             entries, other_sigs), other_sigs),
        "this": (_cuda.load(_cuda.build(), entries), _cuda._SIGNATURES)}
    gen = torch.Generator(device="cuda").manual_seed(0)
    device = torch.cuda.get_device_name(0)

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

    def qw(k, n):
        w = torch.randn(k, n, generator=gen, device="cuda") * 0.05
        s = i8.div_exact(w.abs().amax(dim=0).clamp_min(1e-8), 127.0)
        return i8.k_major(torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)), s

    def turns(launchers):
        """Outputs held against the other build's, then the turns."""
        first = {name: launchers[name]().clone() for name in ("other", "this")}
        torch.cuda.synchronize()
        diff = float((first["this"].float() - first["other"].float()).abs().max())
        equal = bool(torch.equal(first["this"], first["other"]))
        times = {"other": [], "this": []}
        for name in ("other", "this", "this", "other"):
            times[name].append(_median_ms(launchers[name]))
        return {k: statistics.mean(v) for k, v in times.items()}, times, diff, equal

    for rows, d, eps in ((61680, 1408, 1e-6), (240 * 677, 1408, 1e-6), (7680, 768, 1e-12)):
        x = randn(rows, d, scale=2.0)
        w = randn(d, scale=0.1, dtype=torch.float32) + 1.0
        b = randn(d, scale=0.1, dtype=torch.float32)
        outs = {name: torch.empty_like(x) for name in builds}
        launchers = {name: _layer_norm_launcher(lib, len(sigs["mrb_layer_norm_bf16"]), x, w,
                                                b, outs[name], eps)
                     for name, (lib, sigs) in builds.items()}
        ms, times, diff, equal = turns(launchers)
        w16, b16 = w.to(x.dtype), b.to(x.dtype)
        lib_ms = _median_ms(lambda: F.layer_norm(x, (d,), w16, b16, eps))
        nbytes = 2 * x.numel() * 2 + 2 * d * 4
        print(json.dumps({"kernel": f"layer_norm ({rows}, {d}) eps {eps:g}",
                          "this_ms": ms["this"], "other_ms": ms["other"], "turns": times,
                          "library_ms": lib_ms, "this_gb_s": nbytes / ms["this"] / 1e6,
                          "max_abs_diff_this_vs_other": diff, "equal": equal,
                          "device": device}), flush=True)
        del x, outs, launchers
        torch.cuda.empty_cache()

    d, h = _VIT_D, _VIT_H
    w1, s1 = qw(d, h)
    w2, s2 = qw(h, d)
    weights = (w1, s1, randn(h, scale=0.01, dtype=torch.float32), w2, s2,
               randn(d, scale=0.01, dtype=torch.float32))
    norm = ("ln", randn(d, scale=0.05, dtype=torch.float32) + 1.0,
            randn(d, scale=0.05, dtype=torch.float32), 1e-6)
    for m in (61680, 240 * 677):
        x, r = randn(m, d, scale=0.3), randn(m, d, scale=0.3)
        outs = {name: torch.empty_like(x) for name in builds}
        launchers = {name: _mlp_launcher(lib, len(sigs["mrb_w8a8_mlp"]), x, weights, norm, r,
                                         outs[name])
                     for name, (lib, sigs) in builds.items()}
        ms, times, diff, equal = turns(launchers)
        ops = 4.0 * m * d * h
        print(json.dumps({"kernel": f"w8a8_mlp ({m}, {d}, {h})", "this_ms": ms["this"],
                          "other_ms": ms["other"], "turns": times,
                          "this_int8_top_s": ops / ms["this"] / 1e9,
                          "max_abs_diff_this_vs_other": diff, "equal": equal,
                          "device": device}), flush=True)
        if m == 61680:
            for name in ("other", "this"):
                print(json.dumps({"inside": f"w8a8_mlp ({m}, {d}, {h}), {name}",
                                  "device_kernels_ms": _device_kernels(launchers[name])}),
                      flush=True)
        del x, r, outs, launchers
        torch.cuda.empty_cache()


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--other", type=Path,
                        help="another checkout (or archive) holding mr_blip_tpu_torch")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_int8_kernels: no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    if args.other is not None:
        compare_with(args.other)
        return
    lib = _cuda.library()
    for cluster in (8, 4, 2, 1):
        active = ctypes.c_int(0)
        _check(lib.mrb_w8a8_mlp_active_clusters(cluster, ctypes.addressof(active)),
               "mrb_w8a8_mlp_active_clusters")
        print(json.dumps({"fc1_cluster": cluster, "active_clusters": active.value}),
              flush=True)
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
        print(json.dumps({"inside": name, "device_kernels_ms": _device_kernels(fn)}),
              flush=True)

    for name, a, k, n in (("ViT fc1", x, d, h), ("ViT qkv", x, d, 3 * d),
                          ("T5 wi_0", x2, d2, ff)):
        w = randn(k, n, scale=0.02)
        ms = _median_ms(lambda: a @ w)
        print(json.dumps({"bf16_product": f"{name} ({a.shape[0]}, {k}) x {n}", "ms": ms,
                          "tflop_s": 2.0 * a.shape[0] * k * n / ms / 1e9}), flush=True)


if __name__ == "__main__":
    main()
