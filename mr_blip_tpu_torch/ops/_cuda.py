"""Build and bind the hand-written Hopper kernels in ``csrc/``.

On first use, every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a``
(one ``nvcc`` per source, all started together) and linked into one shared
library with a plain C interface, which is loaded with ``ctypes``. The library goes to ``mr_blip_tpu_torch/_build/<hash>/``, keyed
by a hash of the sources and the flags, so an edited source rebuilds and an
unchanged one is reused. Nothing is imported or built when this module is
imported: the CPU tests import every module and have no ``nvcc``.

Every C entry returns ``cudaGetLastError()`` after its launch; ``check``
raises when it is not 0. Kernels launch on the caller's current stream,
allocate nothing and do not synchronize.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_long
_F = ctypes.c_float

# C signatures: name -> argtypes (every entry returns a cudaError_t as int).
_SIGNATURES = {
    # x, weight, bias, out, rows, d, eps, kernel, stream
    "mrb_layer_norm_bf16": [_P, _P, _P, _P, _L, _I, _F, _I, _P],
    # qkv, out, B, N, H, D, n_valid, scale, stream
    "mrb_qkv_packed_attention_bf16": [_P, _P, _I, _I, _I, _I, _I, _F, _P],
    # q, k, v, out, B, N, M, H, D, the batch, row and head strides of q, of k
    # and of v (elements), causal, is_fp32, scale, stream
    "mrb_flash_attention": [_P] * 4 + [_I] * 5 + [_L] * 9 + [_I] * 2 + [_F, _P],
    # q, k, v, bias, kv_mask, out, B, N, M, H, D, scale, stream
    "mrb_flash_bias_attention_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                      _I, _F, _P],
    # q, k, v, bias, kv_mask, out, lse, B, N, M, H, D, scale, stream
    "mrb_flash_bias_fwd_stats_bf16": [_P] * 7 + [_I] * 5 + [_F, _P],
    # the same two in fp32 (the CUDA-core body of flash_attention.cu)
    "mrb_flash_bias_attention_f32": [_P] * 6 + [_I] * 5 + [_F, _P],
    "mrb_flash_bias_fwd_stats_f32": [_P] * 7 + [_I] * 5 + [_F, _P],
    # q, k, v, bias, kv_mask, dout, lse, delta, dq, B, N, M, H, D, scale, stream
    "mrb_flash_bias_bwd_dq_bf16": [_P] * 9 + [_I] * 5 + [_F, _P],
    # ... as above, then dq, dbias, ...
    "mrb_flash_bias_bwd_dq_dbias_bf16": [_P] * 10 + [_I] * 5 + [_F, _P],
    # ... as above, then dk, dv, ...
    "mrb_flash_bias_bwd_dkv_bf16": [_P] * 10 + [_I] * 5 + [_F, _P],
    # the same three in fp32 (CUDA-core bodies in flash_bias_backward.cu)
    "mrb_flash_bias_bwd_dq_f32": [_P] * 9 + [_I] * 5 + [_F, _P],
    "mrb_flash_bias_bwd_dq_dbias_f32": [_P] * 10 + [_I] * 5 + [_F, _P],
    "mrb_flash_bias_bwd_dkv_f32": [_P] * 10 + [_I] * 5 + [_F, _P],
    # q, k, v, table, lut, kv_mask, out, lse, B, N, H, D, nb, maxd, the far
    # thresholds past and future, scale, stream
    "mrb_flash_relpos_fwd_stats_bf16": [_P] * 8 + [_I] * 8 + [_F, _P],
    # the same in fp32 (the CUDA-core body of flash_attention.cu)
    "mrb_flash_relpos_fwd_stats_f32": [_P] * 8 + [_I] * 8 + [_F, _P],
    # q, k, v, table, lut, kv_mask, dout, lse, delta, dq, B, N, H, D, nb, maxd,
    # the far thresholds past and future, scale, stream
    "mrb_flash_relpos_bwd_dq_bf16": [_P] * 10 + [_I] * 8 + [_F, _P],
    # ... as above, then dq, dtable, partial (workspace), ...
    "mrb_flash_relpos_bwd_dq_dtable_bf16": [_P] * 12 + [_I] * 8 + [_F, _P],
    # ... as above, then dk, dv, ...
    "mrb_flash_relpos_bwd_dkv_bf16": [_P] * 11 + [_I] * 8 + [_F, _P],
    # the same three in fp32 (the CUDA-core bodies of backward_f32.cuh),
    # without the far thresholds: q, ..., outputs, B, N, H, D, nb, maxd,
    # scale, stream
    "mrb_flash_relpos_bwd_dq_f32": [_P] * 10 + [_I] * 6 + [_F, _P],
    "mrb_flash_relpos_bwd_dq_dtable_f32": [_P] * 12 + [_I] * 6 + [_F, _P],
    "mrb_flash_relpos_bwd_dkv_f32": [_P] * 11 + [_I] * 6 + [_F, _P],
    # x, ls, lb, norm_kind, eps, wq, sw, bias, residual, out, xq, sa, M, K, N,
    # column tile, stream
    "mrb_w8a8_linear": [_P] * 3 + [_I, _F] + [_P] * 7 + [_I] * 4 + [_P],
    # x, ls, lb, norm_kind, eps, w1, s1, b1, w2, s2, b2, residual, out, xq, sa,
    # hq, sh, M, D, H, block_h, fc1 cluster, stream
    "mrb_w8a8_mlp": [_P] * 3 + [_I, _F] + [_P] * 12 + [_I] * 5 + [_P],
    # the chain route: x, ls, lb, norm_kind, eps, w1, s1, b1, w2, s2, b2,
    # residual, out, xq, sa, h32, hq, sh, M, D, H, block_h, stream
    "mrb_w8a8_mlp_chain": [_P] * 3 + [_I, _F] + [_P] * 13 + [_I] * 4 + [_P],
    # fc1 cluster, gated (0 or 1), int* active clusters out
    "mrb_w8a8_mlp_active_clusters": [_I, _I, _P],
    # x, ls, lb, norm_kind, eps, w0, s0, w1, s1, wo, so, residual, out, xq, sa,
    # hq, sh, M, D, H, block_h, gated fc1 cluster, stream
    "mrb_w8a8_mlp_gated": [_P] * 3 + [_I, _F] + [_P] * 12 + [_I] * 5 + [_P],
    # the chain route: x, ls, lb, norm_kind, eps, w0, s0, w1, s1, wo, so,
    # residual, out, xq, sa, h32, hq, sh, M, D, H, block_h, stream
    "mrb_w8a8_mlp_gated_chain": [_P] * 3 + [_I, _F] + [_P] * 13 + [_I] * 4 + [_P],
    # x, ls, lb, eps, wqkv, sqkv, qkv_bias, wproj, sproj, proj_bias, out, xq,
    # sa, qkv, attn, B, N, C, heads, n_valid, q_scale, the column tiles of
    # qkv and proj, stream
    "mrb_w8a8_attn_block": [_P] * 3 + [_F] + [_P] * 11 + [_I] * 5 + [_F, _I, _I, _P],
}


def _sources(csrc):
    return sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def build(csrc: Path = CSRC, build_root: Path = BUILD_ROOT) -> Path:
    """Compile ``csrc/*.cu`` into ``<build_root>/<hash>/libmrblip_kernels.so``
    unless that file exists already; returns its path."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(csrc):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out_dir = build_root / digest.hexdigest()[:16]
    lib = out_dir / "libmrblip_kernels.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    # One nvcc per source, all started together; then one link. The library
    # is built under a temporary name and renamed, so a build cut short
    # never leaves a library that looks complete.
    work = Path(tempfile.mkdtemp(dir=out_dir))
    nvcc = _nvcc()
    sources = sorted(csrc.glob("*.cu"))
    compiles = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(csrc), "-c", str(src), "-o",
             str(work / (src.stem + ".o"))],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for src in sources]
    logs, failed = [], []
    for src, proc in zip(sources, compiles):
        stdout, stderr = proc.communicate()
        logs.append(f"== {src.name}\n{stderr}")
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode}):\n{stdout}\n{stderr}")
    tmp = work / "lib.so"
    if not failed:
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp),
             *[str(work / (src.stem + ".o")) for src in sources]],
            capture_output=True, text=True)
        if link.returncode != 0:
            failed.append(f"link ({link.returncode}):\n{link.stdout}\n{link.stderr}")
    if failed:
        shutil.rmtree(work)
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, lib)
    shutil.rmtree(work)
    (out_dir / "ptxas.log").write_text("\n".join(logs))
    return lib


def load(path: Path, names=None, signatures=None) -> ctypes.CDLL:
    """Load a built kernel library and bind the C entries ``names`` (all of
    this package's by default) to ``signatures`` (this package's by default;
    another checkout's library takes that checkout's)."""
    signatures = _SIGNATURES if signatures is None else signatures
    lib = ctypes.CDLL(str(path))
    for name in signatures if names is None else names:
        fn = getattr(lib, name)
        fn.argtypes = signatures[name]
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    return load(build())


def check(err: int, name: str) -> None:
    """Raise when a C entry returned a nonzero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{name}: launch failed with cudaError_t {err}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
