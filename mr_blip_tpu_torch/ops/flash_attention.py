"""Attention kernels of the generate, train, long-context and QA paths
(counterpart of ``mr_blip_tpu/ops/flash_attention.py``; every kernel of it is
ported).

Each wrapper takes its plain version for a CPU tensor and launches its
hand-written kernel for a CUDA tensor, or raises:

* ``flash_attention`` (no bias, no key mask, optionally causal; q_len !=
  k_len allowed; bf16 or fp32) -> ``csrc/flash_attention.cu`` (plain version
  ``_flash_reference``); backward: the plain version recomputed, as in JAX;
* ``flash_attention_qkv_packed`` -> ``csrc/qkv_packed_attention.cu``
  (the Hopper tile: K/V resident in shared memory per (image, head) up to 5
  key tiles, streamed above, ``qkv_packed_path``; plain version
  ``_qkv_packed_reference``); backward: the plain version recomputed, as in
  JAX;
* ``flash_attention_bias`` -> ``csrc/flash_bias_attention.cu`` (bf16; fp32:
  the CUDA-core body of ``csrc/flash_attention.cu``) when no gradient is
  needed; otherwise the custom VJP ``_FlashBias``: forward
  ``flash_bias_fwd_stats`` (the same kernels, with the row logsumexp),
  backward ``flash_bias_bwd_dq``, or ``flash_bias_bwd_dq_dbias`` when the
  bias requires grad, then ``flash_bias_bwd_dkv``
  (``csrc/flash_bias_backward.cu``: bf16 on ``csrc/backward_tile_sm90.cuh``,
  fp32 on the CUDA cores). Plain versions:
  ``_flash_bias_fwd_stats_reference`` (forward, both kernels) and
  ``_flash_bias_bwd_reference``;
* ``flash_attention_relpos`` (self-attention with the T5 rel-pos bias
  computed inside the kernel from the (H, num_buckets) table, so that no
  (1, H, N, N) bias exists): always the custom VJP's forward
  ``flash_relpos_fwd_stats`` -> ``csrc/flash_relpos_attention.cu``; when a
  gradient is needed, through ``_FlashRelpos``, whose backward is
  ``flash_relpos_bwd_dq``, or ``flash_relpos_bwd_dq_dtable`` when the table
  requires grad, then ``flash_relpos_bwd_dkv``
  (``csrc/flash_relpos_backward.cu``); bf16 or fp32 (the CUDA-core bodies
  of ``csrc/flash_attention.cu`` and ``csrc/backward_f32.cuh``). Plain
  versions:
  ``_flash_relpos_fwd_stats_reference`` and ``_flash_relpos_bwd_reference``
  (the bias materialized, then the biased plain versions).

Every launcher counts its launches in ``<wrapper>.launches``. Shapes follow
the JAX package: (B, N, H, D) for q/k/v, (1, H, N, M) for the bias, (H,
num_buckets) fp32 for the rel-pos table, (B, M) for the key mask, (B, H, N)
fp32 for the logsumexp and δ.
"""

from __future__ import annotations

import functools

import torch

from mr_blip_tpu_torch.ops import _cuda
from mr_blip_tpu_torch.ops.attention import xla_attention
from mr_blip_tpu_torch.ops.relpos import clamped_bucket_table, materialize_relpos_bias

# Largest head dim the forward kernels instantiate (csrc/attention_tile.cuh,
# csrc/attention_tile_sm90.cuh).
MAX_HEAD_DIM = 96
# The only head dim of the statistics and backward kernels (T5 d_kv).
BWD_HEAD_DIM = 64


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


class _QkvPacked(torch.autograd.Function):
    """Forward through ``launch`` (the kernel launcher; tests pass a CPU
    stand-in), backward through the plain version recomputed."""

    @staticmethod
    def forward(ctx, qkv, num_heads, head_dim, n_valid, launch):
        ctx.save_for_backward(qkv)
        ctx.args = (num_heads, head_dim, n_valid)
        return launch(qkv, num_heads, head_dim, n_valid)

    @staticmethod
    def backward(ctx, grad):
        qkv = ctx.saved_tensors[0].detach().requires_grad_()
        with torch.enable_grad():
            out = _qkv_packed_reference(qkv, *ctx.args)
        (dqkv,) = torch.autograd.grad(out, qkv, grad)
        return dqkv, None, None, None, None


# The most key tiles of 64 the packed-QKV kernel keeps resident in shared
# memory (csrc/attention_tile_sm90.cuh, KV_TILES).
QKV_RESIDENT_KEY_TILES = 5


def qkv_packed_path(n: int, n_valid: int = 0) -> str:
    """Which path of the packed-QKV kernel a shape takes, as the C entry
    decides it: "resident" (the K/V of an (image, head) held in shared
    memory) up to 5 key tiles of 64 valid keys, "streaming" above."""
    valid = n_valid if 0 < n_valid < n else n
    return "resident" if -(-valid // 64) <= QKV_RESIDENT_KEY_TILES else "streaming"


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
    if not qkv.is_cuda:
        return _qkv_packed_reference(qkv, num_heads, head_dim, n_valid)
    if torch.is_grad_enabled() and qkv.requires_grad:
        return _QkvPacked.apply(qkv, num_heads, head_dim, n_valid,
                                _qkv_packed_cuda)
    return _qkv_packed_cuda(qkv, num_heads, head_dim, n_valid)


flash_attention_qkv_packed.launches = 0


# -------------------------- flash without bias or key mask (ViT at 364 pixels)
_FLASH_DTYPES = (torch.bfloat16, torch.float32)


def _flash_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     causal: bool = False) -> torch.Tensor:
    """Plain version of ``flash_attention``: ``xla_attention`` with the causal
    mask q_pos >= k_pos (top-left aligned when q_len != k_len)."""
    mask = None
    if causal:
        q_pos = torch.arange(q.shape[1], device=q.device)
        k_pos = torch.arange(k.shape[1], device=q.device)
        mask = (q_pos[:, None] >= k_pos[None, :])[None, None]
    return xla_attention(q, k, v, mask=mask)


def _kernel_view(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the kernel reads it: innermost stride 1, every other stride
    and the base address a multiple of 16 bytes (a view of a packed QKV
    projection is; anything else is copied)."""
    unit = 16 // t.element_size()
    if t.stride(-1) != 1 or any(s % unit for s in t.stride()[:-1]):
        t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _flash_cuda(q, k, v, causal):
    b, n, h, d = q.shape
    m = k.shape[1]
    if q.dtype not in _FLASH_DTYPES:
        raise TypeError(f"q must be bfloat16 or float32, got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} must be {q.dtype}, got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, expected {q.device}")
    _check_head_dim(d)
    if m == 0:
        raise ValueError("flash_attention needs at least one key")
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    if b == 0 or n == 0:
        return out
    q, k, v = (_kernel_view(t) for t in (q, k, v))
    err = _cuda.library().mrb_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, n, m, h, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], int(causal),
        int(q.dtype == torch.float32), float(d ** -0.5),
        _cuda.stream_ptr(q.device))
    _cuda.check(err, "mrb_flash_attention")
    flash_attention.launches += 1
    return out


class _Flash(torch.autograd.Function):
    """Forward through ``launch`` (the kernel launcher; tests pass a CPU
    stand-in), backward through the plain version recomputed, as JAX's
    ``_flash_vjp_bwd`` does."""

    @staticmethod
    def forward(ctx, q, k, v, causal, launch):
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        return launch(q, k, v, causal)

    @staticmethod
    def backward(ctx, grad):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = _flash_reference(q, k, v, ctx.causal)
        return (*torch.autograd.grad(out, (q, k, v), grad), None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: torch.Tensor | None = None,
                    causal: bool = False) -> torch.Tensor:
    """softmax(q·kᵀ·D^-½)·v over (B, N, H, D) queries and (B, M, H, D) keys
    and values, N != M allowed; with ``causal``, query i attends to keys
    j <= i. Any other mask is not supported: callers with padding masks use
    ``xla_attention`` (the dispatcher in ``ops/attention.py`` sees to it).

    A CUDA call launches kernel 4 (bf16 or fp32; another dtype or head dim
    raises); q, k and v may be strided views, e.g. of a packed QKV
    projection. A CPU call runs the plain version."""
    if mask is not None:
        raise NotImplementedError(
            "flash_attention supports causal masking only; use xla_attention "
            "for arbitrary masks")
    b, _, h, d = q.shape
    m = k.shape[1]
    if k.shape != (b, m, h, d) or v.shape != (b, m, h, d):
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    causal = bool(causal)
    if not q.is_cuda:
        return _flash_reference(q, k, v, causal)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Flash.apply(q, k, v, causal, _flash_cuda)
    return _flash_cuda(q, k, v, causal)


flash_attention.launches = 0


# ------------------------------------------------- biased flash (T5 encoder)
def _math_dtype(t):
    return torch.promote_types(t.dtype, torch.float32)


def _key_valid(kv_mask, k):
    if kv_mask is None:
        return torch.ones(k.shape[0], 1, 1, k.shape[1], dtype=torch.bool,
                          device=k.device)
    return (kv_mask != 0)[:, None, None, :]


def _flash_bias_fwd_stats_reference(q, k, v, bias, kv_mask):
    """Plain version of kernels 3 and 5, in fp32 (or wider) from the same
    inputs: (out in q's dtype, lse (B, H, N)). Keys with kv_mask == 0 get
    p = 0; a row whose keys are all masked gives zeros and lse =
    log(1e-30), as the Pallas kernels do."""
    ct = _math_dtype(q)
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bnhd,bmhd->bhnm", q.to(ct), k.to(ct)) * scale + bias.to(ct)
    s = s.masked_fill(~_key_valid(kv_mask, k), float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m_safe)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhnm,bmhd->bnhd", p / l, v.to(ct))
    return out.to(q.dtype), (m_safe + torch.log(l))[..., 0]


def _flash_bias_bwd_reference(q, k, v, bias, kv_mask, dout, lse, delta):
    """Plain version of kernels 6-8, in fp32 (or wider), with the formulas
    of the Pallas kernel bodies: p = exp(s - lse) on valid keys,
    dp = dO·vᵀ, ds = p∘(dp - δ), dq = ds·k·scale, dk = dsᵀ·q·scale,
    dv = pᵀ·dO, dbias = Σ_b ds. Returns (dq, dk, dv) in q's dtype and
    dbias (1, H, N, M) in the math dtype."""
    ct = _math_dtype(q)
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, df = (t.to(ct) for t in (q, k, v, dout))
    s = torch.einsum("bnhd,bmhd->bhnm", qf, kf) * scale + bias.to(ct)
    p = torch.exp(s - lse.to(ct)[..., None])
    p = torch.where(_key_valid(kv_mask, k), p, torch.zeros_like(p))
    dp = torch.einsum("bnhd,bmhd->bhnm", df, vf)
    ds = p * (dp - delta.to(ct)[..., None])
    dq = torch.einsum("bhnm,bmhd->bnhd", ds, kf) * scale
    dk = torch.einsum("bhnm,bnhd->bmhd", ds, qf) * scale
    dv = torch.einsum("bhnm,bnhd->bmhd", p, df)
    return (dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype),
            ds.sum(dim=0, keepdim=True))


def _bias_operands(q, k, v, bias, kv_mask, *more, dtype=torch.bfloat16):
    """Check the ``dtype`` operands of a flash kernel launch (q, k, v and the
    (name, tensor) pairs in ``more``; the bias too unless None); returns the
    key mask as contiguous int8 (all ones when None)."""
    b = q.shape[0]
    m = k.shape[1]
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v), ("bias", bias), *more):
        if t is not None:
            _check_cuda_operand(name, t, dtype, dev)
    if kv_mask is None:
        kv_mask = torch.ones((b, m), dtype=torch.int8, device=dev)
    kv_mask = kv_mask.to(torch.int8).contiguous()
    _check_cuda_operand("kv_mask", kv_mask, torch.int8, dev)
    return kv_mask


def _check_stats(lse, delta, b, h, n, device):
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (b, h, n):
            raise ValueError(f"{name} must be ({b}, {h}, {n}), got {tuple(t.shape)}")
        _check_cuda_operand(name, t, torch.float32, device)


# The biased forward kernels' C entries by dtype: bf16 on the Hopper tile,
# fp32 (the parity mode) on the CUDA cores.
_FLASH_BIAS_ENTRIES = {torch.bfloat16: "bf16", torch.float32: "f32"}


def _flash_bias_dtype(q):
    if q.dtype not in _FLASH_BIAS_ENTRIES:
        raise TypeError(f"q must be bfloat16 or float32, got {q.dtype}")
    return q.dtype


def _flash_bias_cuda(q, k, v, bias, kv_mask):
    b, n, h, d = q.shape
    m = k.shape[1]
    dtype = _flash_bias_dtype(q)
    kv_mask = _bias_operands(q, k, v, bias, kv_mask, dtype=dtype)
    _check_head_dim(d)
    out = torch.empty_like(q)
    if b == 0 or n == 0:
        return out
    name = f"mrb_flash_bias_attention_{_FLASH_BIAS_ENTRIES[dtype]}"
    err = getattr(_cuda.library(), name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        kv_mask.data_ptr(), out.data_ptr(), b, n, m, h, d,
        float(d ** -0.5), _cuda.stream_ptr(q.device))
    _cuda.check(err, name)
    flash_attention_bias.launches += 1
    return out


def _check_bwd_head_dim(d):
    if d != BWD_HEAD_DIM:
        raise ValueError(f"head dim {d} unsupported by the biased flash "
                         f"statistics and backward kernels: need {BWD_HEAD_DIM}")


def flash_bias_fwd_stats(q, k, v, bias, kv_mask=None):
    """Kernel 5: the biased flash forward plus the fp32 (B, H, N) row
    logsumexp -> (out, lse); bf16 or fp32. Plain version for a CPU tensor."""
    if not q.is_cuda:
        return _flash_bias_fwd_stats_reference(q, k, v, bias, kv_mask)
    b, n, h, d = q.shape
    m = k.shape[1]
    dtype = _flash_bias_dtype(q)
    kv_mask = _bias_operands(q, k, v, bias, kv_mask, dtype=dtype)
    _check_bwd_head_dim(d)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    name = f"mrb_flash_bias_fwd_stats_{_FLASH_BIAS_ENTRIES[dtype]}"
    err = getattr(_cuda.library(), name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        kv_mask.data_ptr(), out.data_ptr(), lse.data_ptr(), b, n, m, h, d,
        float(d ** -0.5), _cuda.stream_ptr(q.device))
    _cuda.check(err, name)
    flash_bias_fwd_stats.launches += 1
    return out, lse


def _bwd_launch(kernel, q, k, v, bias, kv_mask, dout, lse, delta, outs):
    """Launch the backward C entry ``mrb_flash_bias_bwd_<kernel>_<dtype>``
    (bf16 or fp32, by q's dtype) writing into ``outs``."""
    b, n, h, d = q.shape
    m = k.shape[1]
    dtype = _flash_bias_dtype(q)
    kv_mask = _bias_operands(q, k, v, bias, kv_mask, ("dout", dout), dtype=dtype)
    _check_bwd_head_dim(d)
    _check_stats(lse, delta, b, h, n, q.device)
    name = f"mrb_flash_bias_bwd_{kernel}_{_FLASH_BIAS_ENTRIES[dtype]}"
    err = getattr(_cuda.library(), name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        kv_mask.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        *[t.data_ptr() for t in outs], b, n, m, h, d, float(d ** -0.5),
        _cuda.stream_ptr(q.device))
    _cuda.check(err, name)


def _flash_bias_bwd_dq_cuda(q, k, v, bias, kv_mask, dout, lse, delta):
    dq = torch.empty_like(q)
    _bwd_launch("dq", q, k, v, bias, kv_mask, dout, lse, delta, (dq,))
    flash_bias_bwd_dq.launches += 1
    return dq


def _flash_bias_bwd_dq_dbias_cuda(q, k, v, bias, kv_mask, dout, lse, delta):
    dq = torch.empty_like(q)
    dbias = torch.empty(bias.shape, dtype=torch.float32, device=q.device)
    _bwd_launch("dq_dbias", q, k, v, bias, kv_mask, dout, lse, delta,
                (dq, dbias))
    flash_bias_bwd_dq_dbias.launches += 1
    return dq, dbias


def _flash_bias_bwd_dkv_cuda(q, k, v, bias, kv_mask, dout, lse, delta):
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _bwd_launch("dkv", q, k, v, bias, kv_mask, dout, lse, delta, (dk, dv))
    flash_bias_bwd_dkv.launches += 1
    return dk, dv


def flash_bias_bwd_dq(q, k, v, bias, kv_mask, dout, lse, delta):
    """Kernel 6: dq (B, N, H, D) in q's dtype (bf16 or fp32 on the card)."""
    if not q.is_cuda:
        return _flash_bias_bwd_reference(q, k, v, bias, kv_mask, dout, lse,
                                         delta)[0]
    return _flash_bias_bwd_dq_cuda(q, k, v, bias, kv_mask, dout, lse, delta)


def flash_bias_bwd_dq_dbias(q, k, v, bias, kv_mask, dout, lse, delta):
    """Kernel 7: dq and dbias = Σ_b ds, (1, H, N, M) fp32, summed over the
    batch in order by the one block that owns each element (deterministic)."""
    if not q.is_cuda:
        dq, _, _, dbias = _flash_bias_bwd_reference(q, k, v, bias, kv_mask,
                                                    dout, lse, delta)
        return dq, dbias
    return _flash_bias_bwd_dq_dbias_cuda(q, k, v, bias, kv_mask, dout, lse,
                                         delta)


def flash_bias_bwd_dkv(q, k, v, bias, kv_mask, dout, lse, delta):
    """Kernel 8: (dk, dv), (B, M, H, D) each in k's dtype."""
    if not q.is_cuda:
        return _flash_bias_bwd_reference(q, k, v, bias, kv_mask, dout, lse,
                                         delta)[1:3]
    return _flash_bias_bwd_dkv_cuda(q, k, v, bias, kv_mask, dout, lse, delta)


for _fn in (flash_bias_fwd_stats, flash_bias_bwd_dq, flash_bias_bwd_dq_dbias,
            flash_bias_bwd_dkv):
    _fn.launches = 0


class _FlashBias(torch.autograd.Function):
    """The custom VJP of the biased flash attention (``_flash_bias_vjp_fwd``
    / ``_bwd`` in JAX). ``fwd`` is ``flash_bias_fwd_stats``; ``bwd_dq``,
    ``bwd_dq_dbias`` and ``bwd_dkv`` are the backward wrappers (tests pass
    CPU stand-ins). δ = rowsum(dO∘O) is computed here in fp32, as JAX
    computes it in XLA outside its kernels. dbias (kernel 7 in place of
    kernel 6) is computed only when the bias needs a gradient, which JAX
    states with its ``bias_grad`` flag; otherwise the bias gets none (JAX
    returns zeros, which LoRA training never reads). The backward kernels
    take bf16 and fp32; any other dtype on the card raises."""

    @staticmethod
    def forward(ctx, q, k, v, bias, kv_mask, fwd, bwd_dq, bwd_dq_dbias,
                bwd_dkv):
        out, lse = fwd(q, k, v, bias, kv_mask)
        ctx.save_for_backward(q, k, v, bias, kv_mask, out, lse)
        ctx.bwd = (bwd_dq, bwd_dq_dbias, bwd_dkv)
        return out

    @staticmethod
    def backward(ctx, grad):
        q, k, v, bias, kv_mask, out, lse = ctx.saved_tensors
        if q.is_cuda and q.dtype not in _FLASH_BIAS_ENTRIES:
            raise NotImplementedError(
                f"the biased flash backward kernels 6-8 (flash_bias_bwd_dq, "
                f"flash_bias_bwd_dq_dbias, flash_bias_bwd_dkv) take bfloat16 "
                f"and float32, not {q.dtype}")
        bwd_dq, bwd_dq_dbias, bwd_dkv = ctx.bwd
        grad = grad.contiguous()
        ct = _math_dtype(q)
        delta = torch.einsum("bnhd,bnhd->bhn", grad.to(ct), out.to(ct))
        delta = delta.to(lse.dtype).contiguous()
        args = (q, k, v, bias, kv_mask, grad, lse, delta)
        dbias = None
        if ctx.needs_input_grad[3]:
            dq, dbias = bwd_dq_dbias(*args)
            dbias = dbias.to(bias.dtype)
        else:
            dq = bwd_dq(*args)
        dk, dv = bwd_dkv(*args)
        return dq, dk, dv, dbias, None, None, None, None, None


_FLASH_BIAS_OPS = (flash_bias_fwd_stats, flash_bias_bwd_dq,
                   flash_bias_bwd_dq_dbias, flash_bias_bwd_dkv)


def flash_attention_bias(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: torch.Tensor,
                         kv_mask: torch.Tensor | None = None) -> torch.Tensor:
    """softmax(q·kᵀ·D^-½ + bias, keys with kv_mask == 0 excluded)·v.

    q: (B, N, H, D); k, v: (B, M, H, D); bias: (1, H, N, M) broadcast over
    the batch; kv_mask: optional (B, M), nonzero = attend. A bias that
    requires grad gets the true dbias (full finetuning; kernel 7 in place
    of kernel 6).

    When nothing needs a gradient, a CUDA call launches kernel 3 (bf16 or
    fp32); when q, k, v or bias needs one, the call goes through
    ``_FlashBias`` (kernels 5-8, bf16 or fp32). A CPU call runs
    their plain versions. A row whose keys are all
    masked comes out as zeros, as from the Pallas kernels."""
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
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v, bias)):
        return _FlashBias.apply(q, k, v, bias, kv_mask, *_FLASH_BIAS_OPS)
    if q.is_cuda:
        return _flash_bias_cuda(q, k, v, bias, kv_mask)
    return _flash_bias_fwd_stats_reference(q, k, v, bias, kv_mask)[0]


flash_attention_bias.launches = 0


# ------------------------------ in-kernel rel-pos flash (long-context encoder)
# What the kernels' shared-memory tables hold (csrc/backward_tile_sm90.cuh,
# csrc/backward_f32.cuh, csrc/attention_tile_sm90.cuh).
MAX_RELPOS_BUCKETS = 32
MAX_RELPOS_DISTANCE = 1023


@functools.lru_cache(maxsize=8)
def _bucket_lut(num_buckets, max_distance, device):
    """The clamped bucket table the kernels look up, on ``device``."""
    return clamped_bucket_table(num_buckets, max_distance).to(device).contiguous()


@functools.lru_cache(maxsize=8)
def relpos_far_thresholds(num_buckets: int, max_distance: int) -> tuple[int, int]:
    """(past, future) of the clamped bucket table: every key - query <=
    past has the bucket of -max_distance, every key - query >= future that
    of +max_distance (the table is constant beyond the clamp, and the log
    buckets reach their last value before it). Kernel 9 adds one value to a
    tile whose relative positions all lie at or past one of them."""
    lut = clamped_bucket_table(num_buckets, max_distance).tolist()
    c = 0
    while c < 2 * max_distance and lut[c + 1] == lut[0]:
        c += 1
    past = c - max_distance
    c = 2 * max_distance
    while c > 0 and lut[c - 1] == lut[-1]:
        c -= 1
    return past, c - max_distance


def _relpos_bias(table, n, num_buckets, max_distance):
    """(1, H, N, N) bias from the (H, num_buckets) table, by the bit-exact
    bucket function itself (not the clamped table)."""
    pos = torch.arange(n, device=table.device)
    return materialize_relpos_bias(table.T, pos, pos, True, num_buckets,
                                   max_distance)


def _flash_relpos_fwd_stats_reference(q, k, v, table, kv_mask, num_buckets=32,
                                      max_distance=128):
    """Plain version of kernel 9: the bias materialized from the table, then
    the biased plain forward -> (out in q's dtype, lse (B, H, N))."""
    bias = _relpos_bias(table.to(_math_dtype(q)), q.shape[1], num_buckets,
                        max_distance)
    return _flash_bias_fwd_stats_reference(q, k, v, bias, kv_mask)


def _flash_relpos_bwd_reference(q, k, v, table, kv_mask, dout, lse, delta,
                                num_buckets=32, max_distance=128):
    """Plain version of kernels 10-12: the biased plain backward over the
    materialized bias, and dtable[h, u] = Σ ds over every (b, i, j) with
    bucket(j - i) == u. Returns (dq, dk, dv) in q's dtype and dtable
    (H, num_buckets) in the math dtype."""
    n, h = q.shape[1], q.shape[2]
    bias = _relpos_bias(table.to(_math_dtype(q)), n, num_buckets, max_distance)
    dq, dk, dv, dbias = _flash_bias_bwd_reference(q, k, v, bias, kv_mask, dout,
                                                  lse, delta)
    # The (N, N) bucket of key - query, through the table the kernels use.
    pos = torch.arange(n, device=q.device)
    rel = (pos[None, :] - pos[:, None]).clamp(-max_distance, max_distance)
    buckets = _bucket_lut(num_buckets, max_distance, q.device)[rel + max_distance]
    dtable = torch.zeros((h, num_buckets), dtype=dbias.dtype, device=q.device)
    dtable.index_add_(1, buckets.reshape(-1).long(), dbias[0].reshape(h, -1))
    return dq, dk, dv, dtable


def _relpos_operands(q, k, v, table, kv_mask, num_buckets, max_distance, *more):
    """Check the operands of a rel-pos kernel launch (bf16 or fp32 by q's
    dtype; the table always fp32); returns the int8 key mask and the clamped
    bucket table on the device."""
    h, d = q.shape[2:]
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("the rel-pos flash kernels are self-attention only: "
                         f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not (0 < num_buckets <= MAX_RELPOS_BUCKETS
            and 0 < max_distance <= MAX_RELPOS_DISTANCE):
        raise ValueError(f"num_buckets {num_buckets} / max_distance {max_distance} "
                         f"unsupported: at most {MAX_RELPOS_BUCKETS} / "
                         f"{MAX_RELPOS_DISTANCE}")
    kv_mask = _bias_operands(q, k, v, None, kv_mask, *more, dtype=_flash_bias_dtype(q))
    _check_bwd_head_dim(d)
    if table.shape != (h, num_buckets):
        raise ValueError(f"table must be ({h}, {num_buckets}), got {tuple(table.shape)}")
    _check_cuda_operand("table", table, torch.float32, q.device)
    return kv_mask, _bucket_lut(num_buckets, max_distance, q.device)


def flash_relpos_fwd_stats(q, k, v, table, kv_mask=None, num_buckets=32,
                           max_distance=128):
    """Kernel 9: self-attention with the rel-pos bias looked up inside the
    kernel, plus the fp32 (B, H, N) row logsumexp -> (out, lse); bf16 or
    fp32. Plain version for a CPU tensor."""
    if not q.is_cuda:
        return _flash_relpos_fwd_stats_reference(q, k, v, table, kv_mask,
                                                 num_buckets, max_distance)
    return _flash_relpos_fwd_stats_cuda(q, k, v, table, kv_mask, num_buckets,
                                        max_distance)


def _flash_relpos_fwd_stats_cuda(q, k, v, table, kv_mask, num_buckets,
                                 max_distance):
    b, n, h, d = q.shape
    kv_mask, lut = _relpos_operands(q, k, v, table, kv_mask, num_buckets,
                                    max_distance)
    past, future = relpos_far_thresholds(num_buckets, max_distance)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    name = f"mrb_flash_relpos_fwd_stats_{_FLASH_BIAS_ENTRIES[q.dtype]}"
    err = getattr(_cuda.library(), name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), table.data_ptr(),
        lut.data_ptr(), kv_mask.data_ptr(), out.data_ptr(), lse.data_ptr(),
        b, n, h, d, num_buckets, max_distance, past, future, float(d ** -0.5),
        _cuda.stream_ptr(q.device))
    _cuda.check(err, name)
    flash_relpos_fwd_stats.launches += 1
    return out, lse


def _relpos_bwd_launch(kernel, q, k, v, table, kv_mask, dout, lse, delta,
                       num_buckets, max_distance, outs):
    """Launch ``mrb_flash_relpos_bwd_<kernel>_<dtype>`` (bf16 or fp32, by
    q's dtype) writing into ``outs``; the bf16 entries also take the far
    thresholds (their far/near tile split)."""
    b, n, h, d = q.shape
    kv_mask, lut = _relpos_operands(q, k, v, table, kv_mask, num_buckets,
                                    max_distance, ("dout", dout))
    _check_stats(lse, delta, b, h, n, q.device)
    suffix = _FLASH_BIAS_ENTRIES[q.dtype]
    far = relpos_far_thresholds(num_buckets, max_distance) if suffix == "bf16" else ()
    name = f"mrb_flash_relpos_bwd_{kernel}_{suffix}"
    err = getattr(_cuda.library(), name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), table.data_ptr(),
        lut.data_ptr(), kv_mask.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), *[t.data_ptr() for t in outs], b, n, h, d,
        num_buckets, max_distance, *far, float(d ** -0.5),
        _cuda.stream_ptr(q.device))
    _cuda.check(err, name)


def flash_relpos_bwd_dq(q, k, v, table, kv_mask, dout, lse, delta,
                        num_buckets=32, max_distance=128):
    """Kernel 10: dq (B, N, H, D) in q's dtype, the bias recomputed."""
    if not q.is_cuda:
        return _flash_relpos_bwd_reference(q, k, v, table, kv_mask, dout, lse,
                                           delta, num_buckets, max_distance)[0]
    return _flash_relpos_bwd_dq_cuda(q, k, v, table, kv_mask, dout, lse, delta,
                                     num_buckets, max_distance)


def _flash_relpos_bwd_dq_cuda(q, k, v, table, kv_mask, dout, lse, delta,
                              num_buckets, max_distance):
    dq = torch.empty_like(q)
    _relpos_bwd_launch("dq", q, k, v, table, kv_mask, dout, lse, delta,
                       num_buckets, max_distance, (dq,))
    flash_relpos_bwd_dq.launches += 1
    return dq


def flash_relpos_bwd_dq_dtable(q, k, v, table, kv_mask, dout, lse, delta,
                               num_buckets=32, max_distance=128):
    """Kernel 11: dq and dtable (H, num_buckets) fp32, every sum in a fixed
    order (it repeats bit for bit)."""
    if not q.is_cuda:
        dq, _, _, dtable = _flash_relpos_bwd_reference(
            q, k, v, table, kv_mask, dout, lse, delta, num_buckets, max_distance)
        return dq, dtable
    return _flash_relpos_bwd_dq_dtable_cuda(q, k, v, table, kv_mask, dout, lse,
                                            delta, num_buckets, max_distance)


def relpos_dtable_partials(b: int, n: int) -> int:
    """Row count of kernel 11's partial-sum workspace (rows of (H, nb)) at
    batch ``b`` and length ``n``: the bf16 kernel writes one per 64-row half
    of every 128-query block of every batch row, zeros for a half past N
    (the fp32 kernel one per 128-query block)."""
    return b * 2 * -(-n // 128)


def _flash_relpos_bwd_dq_dtable_cuda(q, k, v, table, kv_mask, dout, lse, delta,
                                     num_buckets, max_distance):
    b, n, h, _ = q.shape
    dq = torch.empty_like(q)
    dtable = torch.empty((h, num_buckets), dtype=torch.float32, device=q.device)
    partial = torch.empty((relpos_dtable_partials(b, n), h, num_buckets),
                          dtype=torch.float32, device=q.device)
    _relpos_bwd_launch("dq_dtable", q, k, v, table, kv_mask, dout, lse, delta,
                       num_buckets, max_distance, (dq, dtable, partial))
    flash_relpos_bwd_dq_dtable.launches += 1
    return dq, dtable


def flash_relpos_bwd_dkv(q, k, v, table, kv_mask, dout, lse, delta,
                         num_buckets=32, max_distance=128):
    """Kernel 12: (dk, dv), (B, N, H, D) each in k's dtype."""
    if not q.is_cuda:
        return _flash_relpos_bwd_reference(q, k, v, table, kv_mask, dout, lse,
                                           delta, num_buckets, max_distance)[1:3]
    return _flash_relpos_bwd_dkv_cuda(q, k, v, table, kv_mask, dout, lse, delta,
                                      num_buckets, max_distance)


def _flash_relpos_bwd_dkv_cuda(q, k, v, table, kv_mask, dout, lse, delta,
                               num_buckets, max_distance):
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _relpos_bwd_launch("dkv", q, k, v, table, kv_mask, dout, lse, delta,
                       num_buckets, max_distance, (dk, dv))
    flash_relpos_bwd_dkv.launches += 1
    return dk, dv


_FLASH_RELPOS_OPS = (flash_relpos_fwd_stats, flash_relpos_bwd_dq,
                     flash_relpos_bwd_dq_dtable, flash_relpos_bwd_dkv)
for _fn in _FLASH_RELPOS_OPS:
    _fn.launches = 0


class _FlashRelpos(torch.autograd.Function):
    """The custom VJP of the in-kernel rel-pos flash attention
    (``_flash_relpos_vjp_fwd`` / ``_bwd`` in JAX). ``fwd`` is
    ``flash_relpos_fwd_stats``; ``bwd_dq``, ``bwd_dq_dtable`` and ``bwd_dkv``
    are the backward wrappers (tests pass CPU stand-ins). δ = rowsum(dO∘O) is
    computed here in fp32. dtable (kernel 11 in place of kernel 10) is
    computed only when the table needs a gradient, which JAX states with its
    ``table_grad`` flag. The kernels take bf16 and fp32; any other dtype on
    the card raises."""

    @staticmethod
    def forward(ctx, q, k, v, table, kv_mask, num_buckets, max_distance, fwd,
                bwd_dq, bwd_dq_dtable, bwd_dkv):
        out, lse = fwd(q, k, v, table, kv_mask, num_buckets, max_distance)
        ctx.save_for_backward(q, k, v, table, kv_mask, out, lse)
        ctx.buckets = (num_buckets, max_distance)
        ctx.bwd = (bwd_dq, bwd_dq_dtable, bwd_dkv)
        return out

    @staticmethod
    def backward(ctx, grad):
        q, k, v, table, kv_mask, out, lse = ctx.saved_tensors
        if q.is_cuda and q.dtype not in _FLASH_BIAS_ENTRIES:
            raise NotImplementedError(
                f"the rel-pos flash backward kernels 10-12 take bfloat16 and "
                f"float32, not {q.dtype}")
        bwd_dq, bwd_dq_dtable, bwd_dkv = ctx.bwd
        grad = grad.contiguous()
        ct = _math_dtype(q)
        delta = torch.einsum("bnhd,bnhd->bhn", grad.to(ct), out.to(ct))
        delta = delta.to(lse.dtype).contiguous()
        args = (q, k, v, table, kv_mask, grad, lse, delta, *ctx.buckets)
        dtable = None
        if ctx.needs_input_grad[3]:
            dq, dtable = bwd_dq_dtable(*args)
            dtable = dtable.to(table.dtype)
        else:
            dq = bwd_dq(*args)
        dk, dv = bwd_dkv(*args)
        return (dq, dk, dv, dtable) + (None,) * 7


def flash_attention_relpos(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           table: torch.Tensor,
                           kv_mask: torch.Tensor | None = None,
                           num_buckets: int = 32,
                           max_distance: int = 128) -> torch.Tensor:
    """softmax(q·kᵀ·D^-½ + table[h, bucket(k_pos - q_pos)], keys with
    kv_mask == 0 excluded)·v with T5's bidirectional buckets: self-attention
    in O(N) memory, no (1, H, N, N) bias.

    q, k, v: (B, N, H, D), one length; ``table``: (H, num_buckets), the
    transpose of the model's (num_buckets, H) parameter, cast to contiguous
    fp32 here (its gradient flows back through the cast); kv_mask: optional
    (B, N), nonzero = attend. A table that requires grad gets the true
    dtable (full finetuning; kernel 11 in place of kernel 10).

    A CUDA call launches kernel 9 and, in its backward, kernels 10 or 11 and
    12; a CPU call runs their plain versions. A row whose keys are all
    masked comes out as zeros."""
    b, n, h, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"self-attention only: k/v shapes {tuple(k.shape)}/"
                         f"{tuple(v.shape)} must equal q's {tuple(q.shape)}")
    if table.shape != (h, num_buckets):
        raise ValueError(f"table must be ({h}, {num_buckets}), got "
                         f"{tuple(table.shape)}")
    if kv_mask is not None and kv_mask.shape != (b, n):
        raise ValueError(f"kv_mask must be ({b}, {n}), got {tuple(kv_mask.shape)}")
    table = table.float().contiguous()
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v, table)):
        return _FlashRelpos.apply(q, k, v, table, kv_mask, num_buckets,
                                  max_distance, *_FLASH_RELPOS_OPS)
    return flash_relpos_fwd_stats(q, k, v, table, kv_mask, num_buckets,
                                  max_distance)[0]
