"""W8A8 int8 matmul functions of the int8 inference path (counterpart of
``mr_blip_tpu/ops/int8_matmul.py``).

Quantization scheme: symmetric, round half to even; weights per output
channel (``models/quantize.py``), activations per row inside the function
(``scale[m] = max(max_k |x[m, k]|, 1e-6) / 127``, no calibration). The int8
products accumulate in int32 and are dequantized as ``acc * (s_act * s_w)``;
bias and residual are added in fp32 and the result is rounded to bf16 once.
The MLPs requantize their hidden activation per (row, chunk of ``block_h``
columns), so the chunk width chosen by ``_pick_block`` is part of the
function. GELU is the tanh approximation.

Four public wrappers, each with the JAX signature: ``w8a8_linear``,
``w8a8_mlp``, ``w8a8_mlp_gated`` and ``w8a8_attn_block``. A CPU tensor takes
the plain version beside it (``_w8a8_*_plain``, the kernel's arithmetic step
by step, integer products exact); a CUDA tensor launches the hand-written
kernel (``csrc/int8_matmul.cu``, ``csrc/int8_attn_block.cu``) or raises.
Forward only: an input that requires grad raises. Each wrapper counts its
launches in ``<wrapper>.launches``.

Weight layout: ``kernel_q`` int8 of shape (in, out) as in JAX. The kernels
read a weight with the input axis contiguous, so on the card ``wq`` must be
the transposed view of a contiguous (out, in) tensor (``k_major`` makes one);
any other layout raises.
"""

from __future__ import annotations

import torch

from mr_blip_tpu_torch.ops import _cuda

DEFAULT_BLOCK_H = 1536
DEFAULT_GATED_BLOCK_H = 640
_SQRT_2_OVER_PI = 0.7978845608028654
_NORM_KINDS = {None: 0, "ln": 1, "rms": 2}


def _pick_block(n: int, default: int) -> int:
    """Largest divisor of ``n`` that is <= ``default`` and a multiple of
    128; ``n`` itself when it is small or has no such divisor."""
    if n <= default:
        return n
    for d in range(default - default % 128, 127, -128):
        if n % d == 0:
            return d
    return n


def k_major(wq: torch.Tensor) -> torch.Tensor:
    """The same (in, out) matrix stored with the input axis contiguous,
    which is the layout the kernels read."""
    return wq.t().contiguous().t()


# ------------------------------------------------------------ plain pieces
def div_exact(t: torch.Tensor, value: float) -> torch.Tensor:
    """``t / value`` as a true division: on the card PyTorch turns a division
    by a Python number into a multiplication by its reciprocal, which can
    differ in the last bit."""
    return t / torch.full_like(t, value)


def _quant_rows(x: torch.Tensor):
    """Per-row symmetric int8 quantization in fp32 -> (q int8, scale)."""
    xf = x.float()
    scale = div_exact(xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-6), 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    cdf = 0.5 * (1.0 + torch.tanh(_SQRT_2_OVER_PI * (x + 0.044715 * (x * x * x))))
    return x * cdf


def _norm_rows(xf: torch.Tensor, norm) -> torch.Tensor:
    """The fused pre-norm in fp32: ``None``, ``("ln", scale, bias, eps)`` or
    ``("rms", scale, None, eps)``."""
    if norm is None:
        return xf
    kind, scale, bias, eps = norm
    ls = scale.float().reshape(1, -1)
    k = float(xf.shape[-1])
    if kind == "ln":
        mu = div_exact(xf.sum(dim=-1, keepdim=True), k)
        xc = xf - mu
        var = div_exact((xc * xc).sum(dim=-1, keepdim=True), k)
        return xc * torch.rsqrt(var + eps) * ls + bias.float().reshape(1, -1)
    if kind == "rms":
        var = div_exact((xf * xf).sum(dim=-1, keepdim=True), k)
        return xf * torch.rsqrt(var + eps) * ls
    raise ValueError(f"unknown norm kind {kind!r}")


def _int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a (.., M, K) @ b (K, N)`` of int8 values, exact, as fp32 (the
    rounding of the integer sum to fp32). Computed in fp64, which holds the
    sums exactly (they stay far below 2**53) on both devices; an fp32 matmul
    is exact only up to K = 1040, and PyTorch has no integer matmul on the
    card."""
    return (a.double() @ b.double()).float()


def _row(t: torch.Tensor) -> torch.Tensor:
    return t.float().reshape(1, -1)


def _w8a8_linear_plain(x, wq, sw, bias, norm, residual):
    q, sa = _quant_rows(_norm_rows(x.float(), norm))
    y = _int_matmul(q, wq) * (sa * _row(sw))
    if bias is not None:
        y = y + _row(bias)
    if residual is not None:
        y = y + residual.float()
    return y.to(torch.bfloat16)


def _mlp_tail(acc, bias, residual):
    if bias is not None:
        acc = acc + _row(bias)
    if residual is not None:
        acc = acc + residual.float()
    return acc.to(torch.bfloat16)


def _w8a8_mlp_plain(x, w1q, s1, b1, w2q, s2, b2, norm, residual, block_h):
    q, sa = _quant_rows(_norm_rows(x.float(), norm))
    hdim = w1q.shape[1]
    block_h = _pick_block(hdim, block_h)
    acc = torch.zeros(x.shape[0], x.shape[1], dtype=torch.float32, device=x.device)
    for j in range(hdim // block_h):
        sl = slice(j * block_h, (j + 1) * block_h)
        h = _int_matmul(q, w1q[:, sl]) * (sa * _row(s1)[:, sl]) + _row(b1)[:, sl]
        hq, sh = _quant_rows(_gelu_tanh(h))
        acc = acc + _int_matmul(hq, w2q[sl]) * (sh * _row(s2))
    return _mlp_tail(acc, b2, residual)


def _w8a8_mlp_gated_plain(x, w0q, s0, w1q, s1, woq, so, norm, residual, block_h):
    q, sa = _quant_rows(_norm_rows(x.float(), norm))
    hdim = w0q.shape[1]
    block_h = _pick_block(hdim, block_h)
    acc = torch.zeros(x.shape[0], x.shape[1], dtype=torch.float32, device=x.device)
    for j in range(hdim // block_h):
        sl = slice(j * block_h, (j + 1) * block_h)
        g = _gelu_tanh(_int_matmul(q, w0q[:, sl]) * (sa * _row(s0)[:, sl]))
        h = g * (_int_matmul(q, w1q[:, sl]) * (sa * _row(s1)[:, sl]))
        hq, sh = _quant_rows(h)
        acc = acc + _int_matmul(hq, woq[sl]) * (sh * _row(so))
    return _mlp_tail(acc, None, residual)


def _w8a8_attn_block_plain(x, wqkv, sqkv, qkv_bias, wproj, sproj, proj_bias,
                           ls, lb, eps, num_heads, n_valid):
    """The fused block's arithmetic: qkv rounded to bf16, q scaled by
    bf16(D^-1/2) in bf16, fp32 logits, keys >= n_valid masked, the softmax
    normalized before its rounding to bf16, bf16 attention output
    requantized per token, and the residual added before the last rounding."""
    b, n, c = x.shape
    hd = c // num_heads
    xf = x.float()
    xq, xs = _quant_rows(_norm_rows(xf, ("ln", ls, lb, eps)))
    qkv = (_int_matmul(xq, wqkv) * (xs * _row(sqkv)) + _row(qkv_bias)).to(torch.bfloat16)
    scale = torch.tensor(hd ** -0.5, dtype=torch.bfloat16, device=x.device)
    q = (qkv[..., :c] * scale).reshape(b, n, num_heads, hd)
    k = qkv[..., c:2 * c].reshape(b, n, num_heads, hd)
    v = qkv[..., 2 * c:].reshape(b, n, num_heads, hd)
    logits = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float())
    if n_valid and n_valid < n:
        pad = torch.arange(n, device=x.device) >= n_valid
        logits = logits.masked_fill(pad[None, None, None, :], float("-inf"))
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = torch.where(torch.isfinite(logits), p, torch.zeros_like(p))
    probs = (p / p.sum(dim=-1, keepdim=True)).to(torch.bfloat16)
    attn = torch.einsum("bhnm,bmhd->bnhd", probs.float(), v.float())
    attn = attn.reshape(b, n, c).to(torch.bfloat16)
    aq, a_s = _quant_rows(attn)
    y = _int_matmul(aq, wproj) * (a_s * _row(sproj)) + _row(proj_bias)
    return (y + xf).to(torch.bfloat16)


# --------------------------------------------------------- operand checks
def _refuse_grad(name, *tensors):
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} is forward only: an input requires grad")


def _norm_parts(norm, k):
    """(kind, scale, bias, eps) with the kind validated."""
    if norm is None:
        return None, None, None, 0.0
    kind, scale, bias, eps = norm
    if kind not in ("ln", "rms"):
        raise ValueError(f"unknown norm kind {kind!r}")
    if scale.numel() != k or (kind == "ln" and (bias is None or bias.numel() != k)):
        raise ValueError(f"norm parameters must hold {k} values")
    return kind, scale, bias if kind == "ln" else None, float(eps)


def _check_act(name, t, rows, cols, device):
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name} must be bfloat16 on the card, got {t.dtype}")
    if t.device != device or tuple(t.shape) != (rows, cols) or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous ({rows}, {cols}) tensor on "
                         f"{device}, got {tuple(t.shape)} on {t.device}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _check_weight(name, wq, k, n, device):
    if wq.dtype != torch.int8:
        raise TypeError(f"{name} must be int8, got {wq.dtype}")
    if wq.device != device or tuple(wq.shape) != (k, n):
        raise ValueError(f"{name} must be ({k}, {n}) on {device}, got "
                         f"{tuple(wq.shape)} on {wq.device}")
    if wq.stride() != (1, k):
        raise ValueError(f"{name} must be stored with the input axis contiguous "
                         f"(strides (1, {k})), got {wq.stride()}: pass k_major(w)")
    if k % 16 or n % 8:
        raise ValueError(f"{name}: the kernel needs in % 16 == 0 and out % 8 == 0, "
                         f"got ({k}, {n})")
    if wq.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _vec(name, t, n, device):
    """A contiguous fp32 (n,) vector on ``device``; None passes through."""
    if t is None:
        return None
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.device != device or t.numel() != n or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 vector of {n} on "
                         f"{device}")
    return t


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_chunks(hdim, block_h):
    if hdim != block_h and block_h % 128:
        raise ValueError(f"hidden chunk width {block_h} must be a multiple of 128")
    if block_h % 4:
        raise ValueError(f"hidden width {block_h} must be a multiple of 4")


# ---------------------------------------------------------------- linear
def _w8a8_linear_cuda(x, wq, sw, bias, norm, residual):
    m, k = x.shape
    n = wq.shape[1]
    dev = x.device
    kind, ls, lb, eps = _norm_parts(norm, k)
    _check_act("x", x, m, k, dev)
    _check_weight("wq", wq, k, n, dev)
    sw, bias = _vec("sw", sw, n, dev), _vec("bias", bias, n, dev)
    ls, lb = _vec("norm scale", ls, k, dev), _vec("norm bias", lb, k, dev)
    if residual is not None:
        _check_act("residual", residual, m, n, dev)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    if m == 0:
        return out
    xq = torch.empty((m, k), dtype=torch.int8, device=dev)
    sa = torch.empty((m,), dtype=torch.float32, device=dev)
    err = _cuda.library().mrb_w8a8_linear(
        x.data_ptr(), _ptr(ls), _ptr(lb), _NORM_KINDS[kind], eps, wq.data_ptr(),
        sw.data_ptr(), _ptr(bias), _ptr(residual), out.data_ptr(), xq.data_ptr(),
        sa.data_ptr(), m, k, n, _cuda.stream_ptr(dev))
    _cuda.check(err, "mrb_w8a8_linear")
    w8a8_linear.launches += 1
    return out


def w8a8_linear(x, wq, sw, bias=None, *, norm=None, residual=None):
    """``bf16 (M, K) @ int8 (K, N) -> bf16 (M, N)`` with per-row activation
    quantization inside. ``sw``: per-output-channel weight scales (N,);
    ``bias``: optional fp32 (N,); ``norm``: optional pre-norm applied to x
    first, ``("ln", scale, bias, eps)`` or ``("rms", scale, None, eps)``;
    ``residual``: optional (M, N) tensor added before the rounding."""
    _refuse_grad("w8a8_linear", x, residual)
    if not x.is_cuda:
        return _w8a8_linear_plain(x, wq, sw, bias, norm, residual)
    return _w8a8_linear_cuda(x, wq, sw, bias, norm, residual)


w8a8_linear.launches = 0


# ------------------------------------------------------------------- mlps
def _mlp_workspace(m, d, hdim, num_h, dev):
    return (torch.empty((m, d), dtype=torch.int8, device=dev),
            torch.empty((m,), dtype=torch.float32, device=dev),
            torch.empty((m, hdim), dtype=torch.float32, device=dev),
            torch.empty((m, hdim), dtype=torch.int8, device=dev),
            torch.empty((m, num_h), dtype=torch.float32, device=dev))


def _w8a8_mlp_cuda(x, w1q, s1, b1, w2q, s2, b2, norm, residual, block_h):
    m, d = x.shape
    hdim = w1q.shape[1]
    dev = x.device
    block_h = _pick_block(hdim, block_h)
    _check_chunks(hdim, block_h)
    kind, ls, lb, eps = _norm_parts(norm, d)
    _check_act("x", x, m, d, dev)
    _check_weight("w1q", w1q, d, hdim, dev)
    _check_weight("w2q", w2q, hdim, d, dev)
    s1, b1 = _vec("s1", s1, hdim, dev), _vec("b1", b1, hdim, dev)
    s2, b2 = _vec("s2", s2, d, dev), _vec("b2", b2, d, dev)
    ls, lb = _vec("norm scale", ls, d, dev), _vec("norm bias", lb, d, dev)
    if residual is not None:
        _check_act("residual", residual, m, d, dev)
    out = torch.empty((m, d), dtype=torch.bfloat16, device=dev)
    if m == 0:
        return out
    ws = _mlp_workspace(m, d, hdim, hdim // block_h, dev)
    err = _cuda.library().mrb_w8a8_mlp(
        x.data_ptr(), _ptr(ls), _ptr(lb), _NORM_KINDS[kind], eps,
        w1q.data_ptr(), s1.data_ptr(), b1.data_ptr(), w2q.data_ptr(),
        s2.data_ptr(), b2.data_ptr(), _ptr(residual), out.data_ptr(),
        *[t.data_ptr() for t in ws], m, d, hdim, block_h, _cuda.stream_ptr(dev))
    _cuda.check(err, "mrb_w8a8_mlp")
    w8a8_mlp.launches += 1
    return out


def w8a8_mlp(x, w1q, s1, b1, w2q, s2, b2, *, norm=None, residual=None,
             block_h=DEFAULT_BLOCK_H):
    """Fused int8 GELU MLP ``gelu(x @ w1 + b1) @ w2 + b2`` with the hidden
    activation requantized per (row, chunk of ``_pick_block(H, block_h)``
    columns). ``norm``: optional pre-norm on x; ``residual``: optional
    (M, D) tensor added before the rounding."""
    _refuse_grad("w8a8_mlp", x, residual)
    if not x.is_cuda:
        return _w8a8_mlp_plain(x, w1q, s1, b1, w2q, s2, b2, norm, residual, block_h)
    return _w8a8_mlp_cuda(x, w1q, s1, b1, w2q, s2, b2, norm, residual, block_h)


w8a8_mlp.launches = 0


def _w8a8_mlp_gated_cuda(x, w0q, s0, w1q, s1, woq, so, norm, residual, block_h):
    m, d = x.shape
    hdim = w0q.shape[1]
    dev = x.device
    block_h = _pick_block(hdim, block_h)
    _check_chunks(hdim, block_h)
    kind, ls, lb, eps = _norm_parts(norm, d)
    _check_act("x", x, m, d, dev)
    _check_weight("w0q", w0q, d, hdim, dev)
    _check_weight("w1q", w1q, d, hdim, dev)
    _check_weight("woq", woq, hdim, d, dev)
    s0, s1 = _vec("s0", s0, hdim, dev), _vec("s1", s1, hdim, dev)
    so = _vec("so", so, d, dev)
    ls, lb = _vec("norm scale", ls, d, dev), _vec("norm bias", lb, d, dev)
    if residual is not None:
        _check_act("residual", residual, m, d, dev)
    out = torch.empty((m, d), dtype=torch.bfloat16, device=dev)
    if m == 0:
        return out
    ws = _mlp_workspace(m, d, hdim, hdim // block_h, dev)
    err = _cuda.library().mrb_w8a8_mlp_gated(
        x.data_ptr(), _ptr(ls), _ptr(lb), _NORM_KINDS[kind], eps,
        w0q.data_ptr(), s0.data_ptr(), w1q.data_ptr(), s1.data_ptr(),
        woq.data_ptr(), so.data_ptr(), _ptr(residual), out.data_ptr(),
        *[t.data_ptr() for t in ws], m, d, hdim, block_h, _cuda.stream_ptr(dev))
    _cuda.check(err, "mrb_w8a8_mlp_gated")
    w8a8_mlp_gated.launches += 1
    return out


def w8a8_mlp_gated(x, w0q, s0, w1q, s1, woq, so, *, norm=None, residual=None,
                   block_h=DEFAULT_GATED_BLOCK_H):
    """Fused int8 gated-GELU MLP (T5 ``(gelu(x @ wi_0) * (x @ wi_1)) @ wo``,
    no bias), the gated hidden activation requantized per (row, chunk)."""
    _refuse_grad("w8a8_mlp_gated", x, residual)
    if not x.is_cuda:
        return _w8a8_mlp_gated_plain(x, w0q, s0, w1q, s1, woq, so, norm, residual,
                                     block_h)
    return _w8a8_mlp_gated_cuda(x, w0q, s0, w1q, s1, woq, so, norm, residual,
                                block_h)


w8a8_mlp_gated.launches = 0


# ---------------------------------------------------- fused ViT attention
def _w8a8_attn_block_cuda(x, wqkv, sqkv, qkv_bias, wproj, sproj, proj_bias,
                          ls, lb, eps, num_heads, n_valid):
    b, n, c = x.shape
    dev = x.device
    hd = c // num_heads
    if c % num_heads or hd % 8 or hd > 96:
        raise ValueError(f"head dim {c}/{num_heads} unsupported: need a multiple "
                         "of 8 up to 96")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"x must be bfloat16 on the card, got {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous and 16-byte aligned")
    _check_weight("wqkv", wqkv, c, 3 * c, dev)
    _check_weight("wproj", wproj, c, c, dev)
    sqkv, qkv_bias = _vec("sqkv", sqkv, 3 * c, dev), _vec("qkv_bias", qkv_bias, 3 * c, dev)
    sproj, proj_bias = _vec("sproj", sproj, c, dev), _vec("proj_bias", proj_bias, c, dev)
    ls, lb = _vec("norm scale", ls, c, dev), _vec("norm bias", lb, c, dev)
    out = torch.empty_like(x)
    if b == 0 or n == 0:
        return out
    rows = b * n
    xq = torch.empty((rows, c), dtype=torch.int8, device=dev)
    sa = torch.empty((rows,), dtype=torch.float32, device=dev)
    qkv = torch.empty((rows, 3 * c), dtype=torch.bfloat16, device=dev)
    attn = torch.empty((rows, c), dtype=torch.bfloat16, device=dev)
    q_scale = float(torch.tensor(hd ** -0.5, dtype=torch.bfloat16))
    err = _cuda.library().mrb_w8a8_attn_block(
        x.data_ptr(), ls.data_ptr(), lb.data_ptr(), float(eps), wqkv.data_ptr(),
        sqkv.data_ptr(), qkv_bias.data_ptr(), wproj.data_ptr(), sproj.data_ptr(),
        proj_bias.data_ptr(), out.data_ptr(), xq.data_ptr(), sa.data_ptr(),
        qkv.data_ptr(), attn.data_ptr(), b, n, c, num_heads, int(n_valid), q_scale,
        _cuda.stream_ptr(dev))
    _cuda.check(err, "mrb_w8a8_attn_block")
    w8a8_attn_block.launches += 1
    return out


def w8a8_attn_block(x, wqkv, sqkv, qkv_bias, wproj, sproj, proj_bias, *,
                    norm, num_heads, n_valid=0):
    """Fused int8 ViT attention block over (B, N, C) tokens:
    ``out = x + proj_bias + W8A8_proj(attn(W8A8_qkv(LN(x)) + qkv_bias))``.
    ``norm`` is ``("ln", scale, bias, eps)``; ``n_valid`` > 0 masks the keys
    at or past it (rows there hold garbage and never reach a valid row)."""
    b, n, c = x.shape
    kind, ls, lb, eps = norm
    if kind != "ln":
        raise ValueError(f"w8a8_attn_block takes a LayerNorm pre-norm, got {kind!r}")
    n_valid = int(n_valid or 0)
    if not 0 <= n_valid <= n:
        raise ValueError(f"n_valid={n_valid} outside [0, {n}]")
    _refuse_grad("w8a8_attn_block", x)
    if qkv_bias is None:
        qkv_bias = torch.zeros(3 * c, dtype=torch.float32, device=x.device)
    if proj_bias is None:
        proj_bias = torch.zeros(c, dtype=torch.float32, device=x.device)
    args = (x, wqkv, sqkv, qkv_bias, wproj, sproj, proj_bias, ls, lb, eps,
            num_heads, n_valid)
    if not x.is_cuda:
        return _w8a8_attn_block_plain(*args)
    return _w8a8_attn_block_cuda(*args)


w8a8_attn_block.launches = 0
