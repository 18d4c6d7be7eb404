"""Kernels 3-8 of this checkout beside another checkout's, one card.

    python3 -m mr_blip_tpu_torch.profile_flash_kernels --other DIR

``DIR`` holds another checkout's ``mr_blip_tpu_torch/csrc`` (for example the
parent commit, unpacked with ``git archive`` into a git-ignored directory of
this one). Both sources are built with the same nvcc flags into git-ignored
``_build/`` directories, loaded side by side through ctypes, and launched on
the same inputs in turns (other, this, this, other) through the same C entries
(``mrb_flash_bias_attention_bf16``, ``mrb_flash_bias_fwd_stats_bf16``,
``mrb_flash_attention``, and the backward's ``mrb_flash_bias_bwd_dq_bf16``,
``mrb_flash_bias_bwd_dq_dbias_bf16``, ``mrb_flash_bias_bwd_dkv_bf16``), with
one PyTorch call on the same inputs beside them: ``scaled_dot_product_attention``
for the forwards, its autograd backward (dq, dk and dv in one call) for the
backward kernels. The backward's fp32 entries (``mrb_flash_bias_bwd_*_f32``)
are timed for this checkout alone, in turns (this, this), beside the fp32
library backward. Times are CUDA events, the median of 20 launches after 3
warm-up launches; a kernel's number is the mean of its turns. Shapes: the
main paths' (kernel 4 at 240 x 677 x H 16 x D 88 through the views of a packed
QKV projection, and at 240 x 257; kernels 3 and 5 at 4 x 2,056 x H 32 x D 64
with the bias, kernel 3 also at 4 x 8,000 over the materialized 3.8 GiB bias;
kernels 6-8 at 4 x 2,056 x H 32 x D 64 with the bias, lse and δ from the
plain forward). Before timing, each kernel's outputs on each shape are held
against the other build's (max |diff| printed). Prints the card's name and
power limit, then one JSON line per kernel and shape; needs a CUDA card and
nvcc.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
from pathlib import Path

import torch
import torch.nn.functional as F

from mr_blip_tpu_torch.ops import _cuda
from mr_blip_tpu_torch.ops import flash_attention as fa

BWD = ("dq", "dq_dbias", "dkv")
ENTRIES = ("mrb_flash_bias_attention_bf16", "mrb_flash_bias_fwd_stats_bf16",
           "mrb_flash_attention", *(f"mrb_flash_bias_bwd_{k}_bf16" for k in BWD))
THIS_ONLY = tuple(f"mrb_flash_bias_bwd_{k}_f32" for k in BWD)


def median_ms(fn, iters=20, warmup=3):
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


def _check(err, name):
    if err:
        raise RuntimeError(f"{name}: cudaError_t {err}")


def cases(gen):
    """(label, flops, launch(lib) -> outputs, library call, this checkout
    only) per kernel and shape."""
    dev = "cuda"
    stream = torch.cuda.current_stream().cuda_stream

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    for b, n in ((240, 677), (240, 257)):
        h, d = 16, 88
        qkv = randn(b, n, 3 * h * d)
        q, k, v = qkv.view(b, n, 3, h, d).unbind(2)
        out = torch.empty(b, n, h, d, dtype=torch.bfloat16, device=dev)

        def k4(lib, q=q, k=k, v=v, out=out, b=b, n=n, h=h, d=d):
            _check(lib.mrb_flash_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, n, n, h,
                d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], 0, 0,
                d ** -0.5, stream), "mrb_flash_attention")
            return out

        q4, k4_, v4 = (t.transpose(1, 2) for t in (q, k, v))
        yield (f"kernel 4 ({b}, {n}, {h}, {d})", 4.0 * b * h * n * n * d, k4,
               lambda q4=q4, k4_=k4_, v4=v4: F.scaled_dot_product_attention(q4, k4_, v4),
               False)

    h, d = 32, 64
    for b, n in ((4, 2056), (4, 8000)):
        q, k, v = randn(b, n, h, d), randn(b, n, h, d), randn(b, n, h, d)
        bias = randn(1, h, n, n)
        mask = torch.ones(b, n, dtype=torch.int8, device=dev)
        out = torch.empty_like(q)
        lse = torch.empty(b, h, n, dtype=torch.float32, device=dev)
        q4, k4_, v4 = (t.transpose(1, 2) for t in (q, k, v))
        lib_call = (lambda q4=q4, k4_=k4_, v4=v4, bias=bias:
                    F.scaled_dot_product_attention(q4, k4_, v4, attn_mask=bias))

        def k3(lib, q=q, k=k, v=v, bias=bias, mask=mask, out=out, b=b, n=n):
            _check(lib.mrb_flash_bias_attention_bf16(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                mask.data_ptr(), out.data_ptr(), b, n, n, h, d, d ** -0.5, stream),
                "mrb_flash_bias_attention_bf16")
            return out

        def k5(lib, q=q, k=k, v=v, bias=bias, mask=mask, out=out, lse=lse, b=b, n=n):
            _check(lib.mrb_flash_bias_fwd_stats_bf16(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                mask.data_ptr(), out.data_ptr(), lse.data_ptr(), b, n, n, h, d,
                d ** -0.5, stream), "mrb_flash_bias_fwd_stats_bf16")
            return lse

        flops = 4.0 * b * h * n * n * d
        yield f"kernel 3 ({b}, {n}, {h}, {d})", flops, k3, lib_call, False
        if n < 8000:
            yield f"kernel 5 ({b}, {n}, {h}, {d})", flops, k5, lib_call, False
        del q, k, v, bias, out, lse, k3, k5, lib_call

    yield from backward_cases(gen, torch.bfloat16)
    yield from backward_cases(gen, torch.float32)


def backward_cases(gen, dtype, b=4, n=2056, h=32, d=64):
    """Kernels 6, 7 and 8 at the train shape in ``dtype`` (fp32: this
    checkout alone), beside the library's autograd backward."""
    dev = "cuda"
    stream = torch.cuda.current_stream().cuda_stream
    q, k, v, dout = (torch.randn((b, n, h, d), generator=gen, device=dev).to(dtype)
                     for _ in range(4))
    bias = torch.randn((1, h, n, n), generator=gen, device=dev).to(dtype)
    mask = torch.ones(b, n, dtype=torch.int8, device=dev)
    out, lse = fa._flash_bias_fwd_stats_reference(q.float(), k.float(), v.float(),
                                                  bias.float(), mask)
    delta = torch.einsum("bnhd,bnhd->bhn", dout.float(), out).contiguous()
    del out
    ins = [t.data_ptr() for t in (q, k, v, bias, mask, dout, lse, delta)]
    outs = {"dq": (torch.empty_like(q),),
            "dq_dbias": (torch.empty_like(q),
                         torch.empty(bias.shape, dtype=torch.float32, device=dev)),
            "dkv": (torch.empty_like(k), torch.empty_like(v))}
    qg, kg, vg = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=bias)
    dout4 = dout.transpose(1, 2)

    def library_call():
        return torch.autograd.grad(lib_out, (qg, kg, vg), dout4, retain_graph=True)

    suffix = "bf16" if dtype == torch.bfloat16 else "f32"
    unit = 2.0 * b * h * n * n * d  # one N x M x D product
    for kernel, number, products in (("dq", 6, 3), ("dq_dbias", 7, 3), ("dkv", 8, 4)):
        name = f"mrb_flash_bias_bwd_{kernel}_{suffix}"

        def launch(lib, name=name, res=outs[kernel]):
            _check(getattr(lib, name)(*ins, *[t.data_ptr() for t in res], b, n, n, h,
                                      d, d ** -0.5, stream), name)
            return res

        yield (f"kernel {number} {suffix} ({b}, {n}, {h}, {d})", products * unit, launch,
               library_call, dtype != torch.bfloat16)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--other", required=True, type=Path,
                        help="a checkout (or archive) holding mr_blip_tpu_torch/csrc")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_flash_kernels: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    other_csrc = args.other.resolve() / "mr_blip_tpu_torch" / "csrc"
    libs = {"other": _cuda.load(_cuda.build(other_csrc, _cuda.BUILD_ROOT / "other"),
                                ENTRIES),
            "this": _cuda.load(_cuda.build(), ENTRIES + THIS_ONLY)}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, flops, launch, library_call, this_only in cases(gen):
        def outputs(lib):
            got = launch(lib)
            return [t.clone() for t in (got if isinstance(got, tuple) else (got,))]

        this_out = outputs(libs["this"])
        order = ("this", "this") if this_only else ("other", "this", "this", "other")
        diff = None if this_only else max(
            float((a.float() - b_.float()).abs().max())
            for a, b_ in zip(this_out, outputs(libs["other"])))
        del this_out
        turns = {name: [] for name in order}
        for name in order:
            turns[name].append(median_ms(lambda: launch(libs[name])))
        ms = {name: statistics.mean(t) for name, t in turns.items()}
        lib_ms = median_ms(library_call)
        print(json.dumps({
            "kernel": label, "this_ms": ms["this"], "other_ms": ms.get("other"),
            "turns": turns, "library_ms": lib_ms,
            "this_over_library": ms["this"] / lib_ms,
            "this_tflops": flops / ms["this"] / 1e9,
            "max_abs_diff_this_vs_other": diff,
            "device": torch.cuda.get_device_name(0)}), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
