"""Times of the W8A8 kernels at the main path's shapes, piece by piece.

    python3 -m mr_blip_tpu_torch.profile_int8_kernels
    python3 -m mr_blip_tpu_torch.profile_int8_kernels --other DIR

Needs one CUDA card. Prints the card's name and power limit, then one JSON
line each for:

* every W8A8 wrapper at each shape the int8 generate batch of 4 x 60 frames
  gives it (CUDA events, median of 10 launches), with the int8 TOP/s its
  products reach;
* how many clusters of kernel 14's and kernel 15's fc1 blocks the card
  holds at once, by cluster size (``cudaOccupancyMaxActiveClusters``);
* the device kernels inside one ``w8a8_mlp``, one ``w8a8_mlp_gated``, one
  ``w8a8_attn_block`` and one ``w8a8_linear`` call (``torch.profiler``): the
  quantization passes, the MLPs' fc1 tiles (with the requantizing epilogue)
  and their second products on the GEMM tile, the GEMM tile's products and
  the attention phase;
* the bf16 products the int8 GEMMs replace, as PyTorch runs them (cuBLAS):
  a yardstick only, the port never takes it for an int8 layer;
* the SM clock and the power the card draws (``nvidia-smi``, every 100 ms)
  while it runs the W8A8 linear at the ViT qkv shape for 3 s, then the bf16
  product of the same shape: how far the power limit holds the products.

Random inputs and weights from a seed; nothing is checked here
(``chip_smoke.py`` holds each kernel against its plain version).

With ``--other DIR`` (another checkout's ``mr_blip_tpu_torch``, for example
the parent commit unpacked with ``git archive`` into a git-ignored directory)
it times kernel 1 (LayerNorm), kernel 13 (``w8a8_linear``, at the six
main-path shapes of ``chip_smoke.py``'s phase 3), kernel 14 (``w8a8_mlp``),
kernel 15 (``w8a8_mlp_gated`` at 8,224 and 32,000 rows: the int8 generate
batch's and the long-context batch's) and kernel 16 (``w8a8_attn_block`` at
(240, 257, 1,408)) of both builds instead, side by side in one process:
each library is built from its own
``csrc`` and bound with its own checkout's C signatures (read from its
``ops/_cuda.py``), and launched on the same inputs in turns other, this,
this, other (CUDA events, median of 10 each; a kernel's number is the mean
of its turns); each output is held against the other build's first (max
|diff| and whether they are equal). Then ``torch.profiler`` names the device
kernels inside one call of each build's ``w8a8_linear`` (the Q-Former
shape), ``w8a8_mlp``, ``w8a8_mlp_gated`` (at 8,224 rows) and
``w8a8_attn_block``: the quantize passes, the products (with their int8
TOP/s) and the attention. One JSON line per shape and build. As a
yardstick for kernel 15's products alone, ``torch._int_mm`` at its two
product shapes: (M, 2,048) x (2,048, 10,240) (gate and up together) and
(M, 640) x (640, 2,048) eight times (wo, a hidden chunk a call); the port
never calls it.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import runpy
import statistics
import subprocess
import time
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


def _under_load(fn, seconds=3.0):
    """ms a call of ``fn`` run back to back for ``seconds``, and the SM clock
    (MHz) and power draw (W) sampled meanwhile: medians and ranges."""
    fn()
    torch.cuda.synchronize()
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, text=True)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0, calls = time.time(), 0
    start.record()
    while time.time() - t0 < seconds:
        for _ in range(20):
            fn()
        calls += 20
        torch.cuda.synchronize()
    end.record()
    end.synchronize()
    smi.terminate()
    rows = [[float(v) for v in line.split(",")] for line in smi.communicate()[0].splitlines()
            if line.strip()]
    rows = rows[3:-2] or rows  # the samples taken while the loop ran
    clocks, watts = [r[0] for r in rows], [r[1] for r in rows]
    return {"ms": start.elapsed_time(end) / calls, "calls": calls,
            "clocks_sm_mhz": [statistics.median(clocks), min(clocks), max(clocks)],
            "power_draw_w": [statistics.median(watts), min(watts), max(watts)]}


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


def _gated_launcher(lib, sigs, x, weights, norm, residual, out):
    """``w8a8_mlp_gated`` through a build's C entry: where the build has a
    chain entry beside it (this checkout's), ``mrb_w8a8_mlp_gated`` is the
    tile route and takes xq, sa, hq, sh and the gated fc1's cluster size;
    in an older build it is the chain and takes an fp32 hidden (h32)."""
    stream = torch.cuda.current_stream().cuda_stream
    m, d = x.shape
    hdim = weights[0].shape[1]
    block_h = i8._pick_block(hdim, i8.DEFAULT_GATED_BLOCK_H)
    xq, sa, hq, sh = i8._mlp_workspace(m, d, hdim, hdim // block_h, x.device)
    if "mrb_w8a8_mlp_gated_chain" in sigs:
        tail = [xq, sa, hq, sh], [i8._mlp_plan(hdim, block_h, i8.GATED_TILE)[1]]
    else:
        h32 = torch.empty((m, hdim), dtype=torch.float32, device=x.device)
        tail = [xq, sa, h32, hq, sh], []
    _, ls, _, eps = norm

    def launch():
        _check(lib.mrb_w8a8_mlp_gated(
            x.data_ptr(), ls.data_ptr(), None, 2, eps,
            *[t.data_ptr() for t in weights], residual.data_ptr(), out.data_ptr(),
            *[t.data_ptr() for t in tail[0]], m, d, hdim, block_h, *tail[1], stream),
            "mrb_w8a8_mlp_gated")
        return out
    return launch


def _linear_launcher(lib, n_args, x, wq, sw, bias, norm, residual, out):
    """``w8a8_linear`` through a build's C entry: this checkout's takes the
    GEMM tile's column width (``_linear_plan``), an older one none."""
    stream = torch.cuda.current_stream().cuda_stream
    m, k = x.shape
    n = wq.shape[1]
    xq = torch.empty((m, k), dtype=torch.int8, device=x.device)
    sa = torch.empty((m,), dtype=torch.float32, device=x.device)
    extra = []
    if n_args == len(_cuda._SIGNATURES["mrb_w8a8_linear"]):
        extra = [i8._linear_plan(n)[0]]
    kind, ls, lb, eps = norm if norm is not None else (None, None, None, 0.0)

    def launch():
        _check(lib.mrb_w8a8_linear(
            x.data_ptr(), i8._ptr(ls), i8._ptr(lb), i8._NORM_KINDS[kind], eps,
            wq.data_ptr(), sw.data_ptr(), i8._ptr(bias), i8._ptr(residual), out.data_ptr(),
            xq.data_ptr(), sa.data_ptr(), m, k, n, *extra, stream), "mrb_w8a8_linear")
        return out
    return launch


def _attn_block_launcher(lib, n_args, x, weights, norm, heads, out):
    """``w8a8_attn_block`` through a build's C entry: this checkout's takes
    the column widths of its two products, an older one none."""
    stream = torch.cuda.current_stream().cuda_stream
    b, n, c = x.shape
    ws = i8._attn_block_workspace(b * n, c, x.device)
    extra = []
    if n_args == len(_cuda._SIGNATURES["mrb_w8a8_attn_block"]):
        extra = [i8._linear_plan(3 * c)[0], i8._linear_plan(c)[0]]
    _, ls, lb, eps = norm
    q_scale = float(torch.tensor((c // heads) ** -0.5, dtype=torch.bfloat16))

    def launch():
        _check(lib.mrb_w8a8_attn_block(
            x.data_ptr(), ls.data_ptr(), lb.data_ptr(), eps,
            *[t.data_ptr() for t in weights], out.data_ptr(),
            *[t.data_ptr() for t in ws], b, n, c, heads, 0, q_scale, *extra, stream),
            "mrb_w8a8_attn_block")
        return out
    return launch


def _with_rates(kernels, int8_ops):
    """[name, launches, ms, int8 TOP/s] for the products (int8_ops: the
    operations of each product kernel, by a part of its name)."""
    rows = []
    for name, count, ms in kernels:
        ops = next((v for key, v in int8_ops.items() if key in name), None)
        rows.append([name, count, ms] + ([ops * count / ms / 1e9] if ops else []))
    return rows


def compare_with(other: Path) -> None:
    """Kernels 1, 13, 14, 15 and 16 of this build beside another checkout's."""
    entries = ("mrb_layer_norm_bf16", "mrb_w8a8_linear", "mrb_w8a8_mlp",
               "mrb_w8a8_mlp_gated", "mrb_w8a8_attn_block")
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

    def vec(n, scale=0.05, offset=0.0):
        return randn(n, scale=scale, dtype=torch.float32) + offset

    def norm_of(kind, k):
        if kind is None:
            return None
        return (kind, vec(k, offset=1.0), vec(k) if kind == "ln" else None, 1e-6)

    # Kernel 13 at the six main-path shapes of chip_smoke.py's phase 3.
    for m, k, n, kind, has_bias, has_res in (
            (61677, 1408, 1408, None, False, True),
            (240 * 677, 1408, 4224, "ln", True, False),
            (240 * 677, 1408, 1408, None, True, True),
            (61680, 1408, 1536, None, True, False),
            (8224, 2048, 6144, "rms", False, False),
            (8224, 2048, 2048, None, False, True)):
        x = randn(m, k, scale=0.3)
        wq, sw = qw(k, n)
        bias = vec(n) if has_bias else None
        res = randn(m, n, scale=0.3) if has_res else None
        nm = norm_of(kind, k)
        outs = {name: torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
                for name in builds}
        launchers = {name: _linear_launcher(lib, len(sigs["mrb_w8a8_linear"]), x, wq, sw,
                                            bias, nm, res, outs[name])
                     for name, (lib, sigs) in builds.items()}
        ms, times, diff, equal = turns(launchers)
        ops = 2.0 * m * k * n
        label = f"w8a8_linear ({m}, {k}) x {n} norm {kind} bias {has_bias} residual {has_res}"
        print(json.dumps({"kernel": label, "this_ms": ms["this"], "other_ms": ms["other"],
                          "turns": times, "this_int8_top_s": ops / ms["this"] / 1e9,
                          "other_int8_top_s": ops / ms["other"] / 1e9,
                          "max_abs_diff_this_vs_other": diff, "equal": equal,
                          "device": device}), flush=True)
        if (m, n) == (61680, 1536):
            for name in ("other", "this"):
                print(json.dumps({"inside": f"{label}, {name}", "device_kernels_ms": _with_rates(
                    _device_kernels(launchers[name]), {"gemm": ops})}), flush=True)
        del x, wq, res, outs, launchers
        torch.cuda.empty_cache()

    # Kernel 16 at (240, 257, 1,408).
    b, n, c, heads = 240, 257, _VIT_D, 16
    wqkv, sqkv = qw(c, 3 * c)
    wp, sp = qw(c, c)
    weights = (wqkv, sqkv, vec(3 * c), wp, sp, vec(c))
    nm = norm_of("ln", c)
    x = randn(b, n, c, scale=0.5)
    outs = {name: torch.empty_like(x) for name in builds}
    launchers = {name: _attn_block_launcher(lib, len(sigs["mrb_w8a8_attn_block"]), x,
                                            weights, nm, heads, outs[name])
                 for name, (lib, sigs) in builds.items()}
    ms, times, diff, equal = turns(launchers)
    ops = 2.0 * b * n * c * 4 * c
    label = f"w8a8_attn_block ({b}, {n}, {c})"
    print(json.dumps({"kernel": label, "this_ms": ms["this"], "other_ms": ms["other"],
                      "turns": times, "this_int8_top_s": ops / ms["this"] / 1e9,
                      "max_abs_diff_this_vs_other": diff, "equal": equal,
                      "device": device}), flush=True)
    rows = b * n
    for name in ("other", "this"):
        # The qkv and proj products of this build are two instances of the
        # GEMM tile (192 and 176 columns); the other's one int8_gemm twice.
        print(json.dumps({"inside": f"{label}, {name}", "device_kernels_ms": _with_rates(
            _device_kernels(launchers[name]),
            {"gemm_tile_kernel<192": 2.0 * rows * c * 3 * c,
             "gemm_tile_kernel<176": 2.0 * rows * c * c,
             "int8_gemm": 2.0 * rows * c * 2 * c})}), flush=True)
    del x, outs, launchers, wqkv, wp
    torch.cuda.empty_cache()

    # Kernel 15 at the int8 generate batch's and the long-context batch's
    # rows, RMS pre-norm, the input as the residual (the T5 encoder's FFN).
    d, h = _T5_D, _T5_FF
    g0, t0 = qw(d, h)
    g1, t1 = qw(d, h)
    go, to = qw(h, d)
    weights = (g0, t0, g1, t1, go, to)
    nm = norm_of("rms", d)
    for m in (_T5_ROWS, 4 * 8000):
        x = randn(m, d, scale=0.3)
        outs = {name: torch.empty_like(x) for name in builds}
        launchers = {name: _gated_launcher(lib, sigs, x, weights, nm, x, outs[name])
                     for name, (lib, sigs) in builds.items()}
        ms, times, diff, equal = turns(launchers)
        ops = 6.0 * m * d * h
        label = f"w8a8_mlp_gated ({m}, {d}, {h}) RMS residual"
        print(json.dumps({"kernel": label, "this_ms": ms["this"], "other_ms": ms["other"],
                          "turns": times, "this_int8_top_s": ops / ms["this"] / 1e9,
                          "other_int8_top_s": ops / ms["other"] / 1e9,
                          "max_abs_diff_this_vs_other": diff, "equal": equal,
                          "device": device}), flush=True)
        if m == _T5_ROWS:
            for name in ("other", "this"):
                # This build: the gate/up tile (fc1_requant_kernel<true>) and
                # wo on the segmented GEMM tile; the other's first version:
                # int8_gemm by epilogue (1 gate, 2 up, 0 wo) and
                # requant_chunks.
                print(json.dumps({"inside": f"{label}, {name}", "device_kernels_ms": _with_rates(
                    _device_kernels(launchers[name]),
                    {"fc1_requant_kernel<true>": 4.0 * m * d * h,
                     "gemm_tile_kernel<176, true>": 2.0 * m * h * d,
                     "int8_gemm_kernel<1,": 2.0 * m * d * h,
                     "int8_gemm_kernel<2,": 2.0 * m * d * h,
                     "int8_gemm_kernel<0,": 2.0 * m * h * d})}), flush=True)
        # The products alone through torch._int_mm: gate and up as one
        # (M, D) x (D, 2H) product, wo as H / 640 products over the chunks.
        xq = torch.randint(-127, 128, (m, d), generator=gen, device="cuda",
                           dtype=torch.int8)
        hq = torch.randint(-127, 128, (m, 640), generator=gen, device="cuda",
                           dtype=torch.int8)
        w_gu, w_o = i8.k_major(torch.cat([g0, g1], dim=1)), i8.k_major(go[:640])
        n_chunks = h // 640
        for part, fn, part_ops in (
                ("gate and up", lambda: torch._int_mm(xq, w_gu), 4.0 * m * d * h),
                ("wo", lambda: [torch._int_mm(hq, w_o) for _ in range(n_chunks)],
                 2.0 * m * h * d)):
            part_ms = _median_ms(fn)
            print(json.dumps({"int_mm_yardstick": f"{label}: {part}", "ms": part_ms,
                              "int8_top_s": part_ops / part_ms / 1e9,
                              "device": device}), flush=True)
        del x, outs, launchers, xq, hq, w_gu, w_o
        torch.cuda.empty_cache()
    del g0, g1, go, weights
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
    for gated in (0, 1):
        for cluster in (8, 4, 2, 1):
            active = ctypes.c_int(0)
            _check(lib.mrb_w8a8_mlp_active_clusters(cluster, gated,
                                                    ctypes.addressof(active)),
                   "mrb_w8a8_mlp_active_clusters")
            print(json.dumps({"fc1": "gated" if gated else "gelu", "fc1_cluster": cluster,
                              "active_clusters": active.value}), flush=True)
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
        ("w8a8_linear ViT qkv (61680, 1408) x 4224, LN, bias",
         lambda: i8.w8a8_linear(x, a_qkv, sa_qkv, a_qb, norm=ln), 2.0 * m * d * 3 * d),
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
    print(json.dumps({"inside": "w8a8_linear Q-Former K/V", "device_kernels_ms": _with_rates(
        _device_kernels(cases[0][1]), {"gemm": cases[0][2]})}), flush=True)

    for name, a, k, n in (("ViT fc1", x, d, h), ("ViT qkv", x, d, 3 * d),
                          ("T5 wi_0", x2, d2, ff)):
        w = randn(k, n, scale=0.02)
        ms = _median_ms(lambda: a @ w)
        print(json.dumps({"bf16_product": f"{name} ({a.shape[0]}, {k}) x {n}", "ms": ms,
                          "tflop_s": 2.0 * a.shape[0] * k * n / ms / 1e9}), flush=True)

    w = randn(d, 3 * d, scale=0.02)
    for name, fn in (("w8a8_linear ViT qkv (61680, 1408) x 4224", lambda: i8.w8a8_linear(
                         x, a_qkv, sa_qkv, a_qb)),
                     ("bf16 x @ w (61680, 1408) x 4224", lambda: x @ w)):
        print(json.dumps({"under_load": name, **_under_load(fn)}), flush=True)


if __name__ == "__main__":
    main()
