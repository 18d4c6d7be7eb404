"""Attention kernels of the generate path (counterpart of
``mr_blip_tpu/ops/flash_attention.py``; only ``flash_attention_bias`` and
``flash_attention_qkv_packed`` are ported).

Each wrapper takes its plain version for a CPU tensor and launches its
hand-written kernel for a CUDA tensor, or raises:

* ``flash_attention_qkv_packed`` -> ``csrc/qkv_packed_attention.cu``
  (plain version ``_qkv_packed_reference``);
* ``flash_attention_bias`` -> ``csrc/flash_bias_attention.cu``
  (plain version ``xla_attention`` with the key mask).

Shapes follow the JAX package: (B, N, H, D) for q/k/v.
"""

from __future__ import annotations

import torch

from mr_blip_tpu_torch.ops import _cuda
from mr_blip_tpu_torch.ops.attention import xla_attention

# Largest head dim the kernels instantiate (csrc/attention_tile.cuh).
MAX_HEAD_DIM = 96


def _check_cuda_operand(name, t, dtype, device):
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _check_head_dim(d):
    if d % 8 or d > MAX_HEAD_DIM or d <= 0:
        raise ValueError(f"head dim {d} unsupported: need a multiple of 8 "
                         f"up to {MAX_HEAD_DIM}")


# ----------------------------------------------------------- packed QKV (ViT)
def _qkv_packed_reference(qkv: torch.Tensor, num_heads: int, head_dim: int,
                          n_valid: int = 0) -> torch.Tensor:
    hd = num_heads * head_dim
    b, n, _ = qkv.shape
    q, k, v = qkv[..., :hd], qkv[..., hd:2 * hd], qkv[..., 2 * hd:]
    mask = None
    if n_valid and n_valid < n:
        mask = (torch.arange(n, device=qkv.device) < n_valid)[None, None, None, :]
    out = xla_attention(
        q.reshape(b, n, num_heads, head_dim),
        k.reshape(b, n, num_heads, head_dim),
        v.reshape(b, n, num_heads, head_dim),
        mask=mask,
    )
    return out.reshape(b, n, hd)


def _qkv_packed_cuda(qkv, num_heads, head_dim, n_valid):
    b, n, three_hd = qkv.shape
    _check_cuda_operand("qkv", qkv, torch.bfloat16, qkv.device)
    _check_head_dim(head_dim)
    out = torch.empty((b, n, three_hd // 3), dtype=qkv.dtype, device=qkv.device)
    if b == 0 or n == 0:
        return out
    err = _cuda.library().mrb_qkv_packed_attention_bf16(
        qkv.data_ptr(), out.data_ptr(), b, n, num_heads, head_dim,
        int(n_valid), float(head_dim ** -0.5), _cuda.stream_ptr(qkv.device))
    _cuda.check(err, "mrb_qkv_packed_attention_bf16")
    flash_attention_qkv_packed.launches += 1
    return out


def flash_attention_qkv_packed(qkv: torch.Tensor, num_heads: int,
                               n_valid: int = 0) -> torch.Tensor:
    """Self-attention over the packed (B, N, 3*H*D) QKV tensor -> (B, N, H*D).

    ``n_valid`` > 0 masks key columns >= n_valid."""
    b, n, three_hd = qkv.shape
    if three_hd % (3 * num_heads):
        raise ValueError(f"last dim {three_hd} is not 3 * {num_heads} heads")
    head_dim = three_hd // (3 * num_heads)
    n_valid = int(n_valid or 0)
    if not 0 <= n_valid <= n:
        raise ValueError(f"n_valid={n_valid} outside [0, {n}]")
    if qkv.is_cuda:
        return _qkv_packed_cuda(qkv, num_heads, head_dim, n_valid)
    return _qkv_packed_reference(qkv, num_heads, head_dim, n_valid)


flash_attention_qkv_packed.launches = 0


# ------------------------------------------------- biased flash (T5 encoder)
def _flash_bias_reference(q, k, v, bias, kv_mask):
    mask = None if kv_mask is None else (kv_mask != 0)[:, None, None, :]
    return xla_attention(q, k, v, bias=bias, mask=mask)


def _flash_bias_cuda(q, k, v, bias, kv_mask):
    b, n, h, d = q.shape
    m = k.shape[1]
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v), ("bias", bias)):
        _check_cuda_operand(name, t, torch.bfloat16, dev)
    _check_head_dim(d)
    if kv_mask is None:
        kv_mask = torch.ones((b, m), dtype=torch.int8, device=dev)
    kv_mask = kv_mask.to(torch.int8).contiguous()
    _check_cuda_operand("kv_mask", kv_mask, torch.int8, dev)
    out = torch.empty_like(q)
    if b == 0 or n == 0:
        return out
    err = _cuda.library().mrb_flash_bias_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        kv_mask.data_ptr(), out.data_ptr(), b, n, m, h, d,
        float(d ** -0.5), _cuda.stream_ptr(dev))
    _cuda.check(err, "mrb_flash_bias_attention_bf16")
    flash_attention_bias.launches += 1
    return out


def flash_attention_bias(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: torch.Tensor,
                         kv_mask: torch.Tensor | None = None) -> torch.Tensor:
    """softmax(q·kᵀ·D^-½ + bias, keys with kv_mask == 0 excluded)·v.

    q: (B, N, H, D); k, v: (B, M, H, D); bias: (1, H, N, M) broadcast over
    the batch; kv_mask: optional (B, M), nonzero = attend. A row whose keys
    are all masked comes out as zeros from the kernel (finite), and as the
    mean of v from the plain version (``finfo.min`` fill)."""
    b, n, h, d = q.shape
    m = k.shape[1]
    if k.shape != (b, m, h, d) or v.shape != (b, m, h, d):
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if bias.shape != (1, h, n, m):
        raise ValueError(f"bias must be (1, {h}, {n}, {m}), got "
                         f"{tuple(bias.shape)}")
    if kv_mask is not None and kv_mask.shape != (b, m):
        raise ValueError(f"kv_mask must be ({b}, {m}), got "
                         f"{tuple(kv_mask.shape)}")
    if q.is_cuda:
        return _flash_bias_cuda(q, k, v, bias, kv_mask)
    return _flash_bias_reference(q, k, v, bias, kv_mask)


flash_attention_bias.launches = 0
