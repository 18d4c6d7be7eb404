"""Kernels 2-12 of this checkout beside another checkout's, one card.

    python3 -m mr_blip_tpu_torch.profile_flash_kernels --other DIR

``DIR`` holds another checkout's ``mr_blip_tpu_torch/csrc`` (for example the
parent commit, unpacked with ``git archive`` into a git-ignored directory of
this one). Both sources are built with the same nvcc flags into git-ignored
``_build/`` directories, loaded side by side through ctypes, and launched on
the same inputs in turns (other, this, this, other) through the same C entries
(``mrb_qkv_packed_attention_bf16``, ``mrb_flash_bias_attention_bf16``,
``mrb_flash_bias_fwd_stats_bf16``, ``mrb_flash_attention``,
``mrb_flash_relpos_fwd_stats_bf16``, and the backward's
``mrb_flash_bias_bwd_dq_bf16``, ``mrb_flash_bias_bwd_dq_dbias_bf16``,
``mrb_flash_bias_bwd_dkv_bf16``, and the rel-pos backward's
``mrb_flash_relpos_bwd_dq_bf16``, ``mrb_flash_relpos_bwd_dq_dtable_bf16``,
``mrb_flash_relpos_bwd_dkv_bf16``; each library bound with its own checkout's
C signatures, read from that checkout's ``ops/_cuda.py``), with one PyTorch
call on the same inputs beside them: ``scaled_dot_product_attention`` for the
forwards (over the materialized bias for kernels 9-12), its autograd backward
(dq, dk and dv in one call) for the backward kernels. The fp32 entries of the
backward kernels 6-8 are timed as the bf16 ones, those of the rel-pos kernels
9-12 for this checkout alone, in turns (this, this), beside the fp32 library
call. Times are
CUDA events, the median of 20 launches after 3 warm-up launches; a kernel's
number is the mean of its turns. Shapes: the main paths' (kernel 2 at 240 x
257 x H 16 x D 88, its resident path, and at 60 x 496, its streaming path;
kernel 4 at 240 x 677 through the views of a packed QKV projection, and at
240 x 257; kernels 3 and 5 at 4 x 2,056 x H 32 x D 64 with the bias, kernel 3
also at 4 x 8,000 over the materialized 3.8 GiB bias; kernel 9 at 4 and 1 x
8,000 x H 32 x D 64; kernels 6-8 at 4 x 2,056 x H 32 x D 64 with the bias,
lse and δ from the plain forward; kernels 10-12 in bf16 at 1 x 8,000 and
4 x 4,008, lse and δ from this checkout's kernel 9; the fp32 rel-pos kernels
at 1 x 4,008).
Before timing, each kernel's outputs on each shape are held against the
other build's (max |diff| printed). Prints the card's name and power limit,
then one JSON line per kernel and shape; needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import json
import runpy
import statistics
import subprocess
from pathlib import Path

import torch
import torch.nn.functional as F

from mr_blip_tpu_torch.ops import _cuda
from mr_blip_tpu_torch.ops import flash_attention as fa

BWD = ("dq", "dq_dbias", "dkv")
RELPOS_BWD = ("dq", "dq_dtable", "dkv")
ENTRIES = ("mrb_qkv_packed_attention_bf16", "mrb_flash_bias_attention_bf16",
           "mrb_flash_bias_fwd_stats_bf16", "mrb_flash_attention",
           "mrb_flash_relpos_fwd_stats_bf16",
           *(f"mrb_flash_bias_bwd_{k}_{t}" for k in BWD for t in ("bf16", "f32")),
           *(f"mrb_flash_relpos_bwd_{k}_bf16" for k in RELPOS_BWD))
THIS_ONLY = ("mrb_flash_relpos_fwd_stats_f32",
             *(f"mrb_flash_relpos_bwd_{k}_f32" for k in RELPOS_BWD))
NB, MAXD = 32, 128  # T5's rel-pos buckets


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

    for b, n in ((240, 257), (60, 496)):
        h, d = 16, 88
        qkv = randn(b, n, 3 * h * d)
        out = torch.empty(b, n, h * d, dtype=torch.bfloat16, device=dev)

        def k2(lib, qkv=qkv, out=out, b=b, n=n):
            _check(lib.mrb_qkv_packed_attention_bf16(
                qkv.data_ptr(), out.data_ptr(), b, n, h, d, 0, d ** -0.5, stream),
                "mrb_qkv_packed_attention_bf16")
            return out

        q4, k4_, v4 = (t.reshape(b, n, h, d).transpose(1, 2)
                       for t in qkv.split(h * d, dim=-1))
        yield (f"kernel 2 ({b}, {n}, {h}, {d}) {fa.qkv_packed_path(n)}",
               4.0 * b * h * n * n * d, k2,
               lambda q4=q4, k4_=k4_, v4=v4: F.scaled_dot_product_attention(q4, k4_, v4),
               False)
        del qkv, out, k2, q4, k4_, v4

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

    yield from relpos_cases(gen)
    yield from relpos_backward_cases(gen)
    yield from backward_cases(gen, torch.bfloat16)
    yield from backward_cases(gen, torch.float32)
    yield from relpos_fp32_cases(gen)


def relpos_cases(gen, h=32, d=64):
    """Kernel 9 in bf16 at the long-context generate and train shapes,
    beside the library call over the materialized bias. The parent's C entry
    may lack the far thresholds: the launch passes them only where the
    library's signature has them."""
    dev = "cuda"
    stream = torch.cuda.current_stream().cuda_stream
    past, future = fa.relpos_far_thresholds(NB, MAXD)
    lut = fa._bucket_lut(NB, MAXD, torch.device(dev))
    for b, n in ((4, 8000), (1, 8000)):
        q, k, v = (torch.randn((b, n, h, d), generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        table = torch.randn(h, NB, generator=gen, device=dev)
        mask = torch.ones(b, n, dtype=torch.int8, device=dev)
        out = torch.empty_like(q)
        lse = torch.empty(b, h, n, dtype=torch.float32, device=dev)
        bias = fa._relpos_bias(table, n, NB, MAXD).to(torch.bfloat16).contiguous()
        q4, k4_, v4 = (t.transpose(1, 2) for t in (q, k, v))

        def k9(lib, q=q, k=k, v=v, table=table, mask=mask, out=out, lse=lse, b=b, n=n):
            fn = lib.mrb_flash_relpos_fwd_stats_bf16
            far = (past, future) if len(fn.argtypes) == 18 else ()
            _check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), table.data_ptr(),
                      lut.data_ptr(), mask.data_ptr(), out.data_ptr(), lse.data_ptr(),
                      b, n, h, d, NB, MAXD, *far, d ** -0.5, stream),
                   "mrb_flash_relpos_fwd_stats_bf16")
            return out, lse

        yield (f"kernel 9 ({b}, {n}, {h}, {d})", 4.0 * b * h * n * n * d, k9,
               lambda q4=q4, k4_=k4_, v4=v4, bias=bias:
               F.scaled_dot_product_attention(q4, k4_, v4, attn_mask=bias), False)
        del q, k, v, table, mask, out, lse, bias, q4, k4_, v4, k9


def relpos_backward_cases(gen, h=32, d=64):
    """Kernels 10, 11 and 12 in bf16 at the long-context train shape (1 x
    8,000) and at 4 x 4,008 (120 frames), the lse from this checkout's
    kernel 9 and δ from its output, beside the library's autograd backward
    over the materialized bias. The parent's C entries may lack the far
    thresholds: the launch passes them only where the library's signature
    has them (two ints more than the fp32 entry of the same kernel)."""
    dev = "cuda"
    stream = torch.cuda.current_stream().cuda_stream
    past, future = fa.relpos_far_thresholds(NB, MAXD)
    lut = fa._bucket_lut(NB, MAXD, torch.device(dev))
    for b, n in ((1, 8000), (4, 4008)):
        q, k, v, dout = (torch.randn((b, n, h, d), generator=gen, device=dev)
                         .to(torch.bfloat16) for _ in range(4))
        table = torch.randn(h, NB, generator=gen, device=dev)
        mask = torch.ones(b, n, dtype=torch.int8, device=dev)
        out, lse = fa.flash_relpos_fwd_stats(q, k, v, table, mask, NB, MAXD)
        delta = torch.einsum("bnhd,bnhd->bhn", dout.float(), out.float()).contiguous()
        bias = fa._relpos_bias(table, n, NB, MAXD).to(torch.bfloat16).contiguous()
        qg, kg, vg = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=bias)
        dout4 = dout.transpose(1, 2)

        def library_call(lib_out=lib_out, qg=qg, kg=kg, vg=vg, dout4=dout4):
            return torch.autograd.grad(lib_out, (qg, kg, vg), dout4, retain_graph=True)

        ins = [t.data_ptr() for t in (q, k, v, table, lut, mask, dout, lse, delta)]
        outs = {"dq": (torch.empty_like(q),),
                "dq_dtable": (torch.empty_like(q), torch.empty(h, NB, device=dev),
                              torch.empty(fa.relpos_dtable_partials(b, n), h, NB,
                                          device=dev)),
                "dkv": (torch.empty_like(k), torch.empty_like(v))}
        unit = 2.0 * b * h * n * n * d  # one N x N x D product
        for kernel, number, products in zip(RELPOS_BWD, (10, 11, 12), (3, 3, 4)):
            name = f"mrb_flash_relpos_bwd_{kernel}_bf16"
            n_args = len(_cuda._SIGNATURES[f"mrb_flash_relpos_bwd_{kernel}_f32"])

            def launch(lib, name=name, res=outs[kernel], n_args=n_args, b=b, n=n,
                       ins=ins):
                fn = getattr(lib, name)
                far = (past, future) if len(fn.argtypes) == n_args + 2 else ()
                _check(fn(*ins, *[t.data_ptr() for t in res], b, n, h, d, NB, MAXD,
                          *far, d ** -0.5, stream), name)
                return res[:2]  # dq_dtable: (dq, dtable), not the workspace

            yield (f"kernel {number} bf16 ({b}, {n}, {h}, {d})", products * unit, launch,
                   library_call, False)
        del q, k, v, dout, table, mask, out, lse, delta, bias, qg, kg, vg, lib_out
        del dout4, ins, outs, library_call


def relpos_fp32_cases(gen, b=1, n=4008, h=32, d=64):
    """Kernels 9-12 in fp32 (this checkout alone) at 1 x 4,008 (120 frames),
    the backward from the plain forward's lse and δ, beside the library's
    fp32 forward and autograd backward over the materialized bias."""
    dev = "cuda"
    stream = torch.cuda.current_stream().cuda_stream
    past, future = fa.relpos_far_thresholds(NB, MAXD)
    lut = fa._bucket_lut(NB, MAXD, torch.device(dev))
    q, k, v, dout = (torch.randn((b, n, h, d), generator=gen, device=dev)
                     for _ in range(4))
    table = torch.randn(h, NB, generator=gen, device=dev)
    mask = torch.ones(b, n, dtype=torch.int8, device=dev)
    out, lse = fa._flash_relpos_fwd_stats_reference(q, k, v, table, mask, NB, MAXD)
    delta = torch.einsum("bnhd,bnhd->bhn", dout, out).contiguous()
    bias = fa._relpos_bias(table, n, NB, MAXD).contiguous()
    qg, kg, vg = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=bias)

    def library_fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(qg, kg, vg, attn_mask=bias)

    def library_bwd():
        return torch.autograd.grad(lib_out, (qg, kg, vg), dout.transpose(1, 2),
                                   retain_graph=True)

    head = [t.data_ptr() for t in (q, k, v, table, lut, mask)]
    fwd_out = (torch.empty_like(q), torch.empty(b, h, n, device=dev))

    def k9(lib):
        _check(lib.mrb_flash_relpos_fwd_stats_f32(
            *head, *[t.data_ptr() for t in fwd_out], b, n, h, d, NB, MAXD, past, future,
            d ** -0.5, stream), "mrb_flash_relpos_fwd_stats_f32")
        return fwd_out

    unit = 2.0 * b * h * n * n * d  # one N x N x D product
    yield f"kernel 9 f32 ({b}, {n}, {h}, {d})", 2 * unit, k9, library_fwd, True
    outs = {"dq": (torch.empty_like(q),),
            "dq_dtable": (torch.empty_like(q), torch.empty(h, NB, device=dev),
                          torch.empty(b * -(-n // 64), h, NB, device=dev)),
            "dkv": (torch.empty_like(k), torch.empty_like(v))}
    for kernel, number, products in (("dq", 10, 3), ("dq_dtable", 11, 3), ("dkv", 12, 4)):
        name = f"mrb_flash_relpos_bwd_{kernel}_f32"

        def launch(lib, name=name, res=outs[kernel]):
            _check(getattr(lib, name)(
                *head, *[t.data_ptr() for t in (dout, lse, delta)],
                *[t.data_ptr() for t in res], b, n, h, d, NB, MAXD, d ** -0.5, stream),
                name)
            return res

        yield (f"kernel {number} f32 ({b}, {n}, {h}, {d})", products * unit, launch,
               library_bwd, True)


def backward_cases(gen, dtype, b=4, n=2056, h=32, d=64):
    """Kernels 6, 7 and 8 at the train shape in ``dtype``, beside the
    library's autograd backward."""
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
               library_call, False)


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
    other_pkg = args.other.resolve() / "mr_blip_tpu_torch"
    other_sigs = runpy.run_path(str(other_pkg / "ops" / "_cuda.py"))["_SIGNATURES"]
    libs = {"other": _cuda.load(_cuda.build(other_pkg / "csrc", _cuda.BUILD_ROOT / "other"),
                                ENTRIES, other_sigs),
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
