"""Attention core (counterpart of ``mr_blip_tpu/ops/attention.py``).

Every attention site funnels through ``dot_product_attention``, which keeps
the JAX dispatch rules with "on TPU" read as "tensor on CUDA": long
(>= 256 query) attention with no bias and no mask goes to the flash kernel,
long biased self-attention with a key-only mask to the biased flash kernel;
everything else is ``xla_attention`` in plain torch. Active attention-weight
dropout forces the plain path, as in JAX. ``set_attention_backend`` swaps the
backend for every site: "auto" (the rules above), "xla" (always plain) or
"flash" (always ``flash_attention``).
``relpos_attention`` is the long-context T5 encoder's core: the rel-pos
bias comes from the (H, num_buckets) table inside the rel-pos flash kernels
on the card, and is materialized for ``xla_attention`` elsewhere.

Shapes follow the (batch, length, heads, head_dim) convention.
"""

from __future__ import annotations

import torch

from mr_blip_tpu_torch.ops.relpos import materialize_relpos_bias

# Below this many query positions the plain version is used.
_FLASH_MIN_SEQ = 256
_BACKEND = "auto"


def set_attention_backend(name: str) -> None:
    """Override the attention backend globally: "auto" | "xla" | "flash"."""
    global _BACKEND
    if name not in ("auto", "xla", "flash"):
        raise ValueError(f"attention backend {name!r}: auto, xla or flash")
    _BACKEND = name


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: torch.Tensor | None = None,
                  mask: torch.Tensor | None = None,
                  dropout_rate: float = 0.0,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """Plain attention: fp32 logits and softmax, output in v's dtype.

    ``mask`` is boolean, broadcastable to (B, H, N, M), True = attend;
    masked logits are filled with ``finfo(float32).min`` as in JAX.
    ``dropout_rate`` > 0 drops attention probabilities (inverted scaling,
    HF T5 / BERT semantics), with keep draws from ``generator``."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    if mask is not None:
        logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1)
    if dropout_rate > 0.0:
        keep = torch.rand(probs.shape, generator=generator,
                          device=probs.device) < 1.0 - dropout_rate
        probs = torch.where(keep, probs / (1.0 - dropout_rate),
                            torch.zeros((), device=probs.device))
    return torch.einsum("bhnm,bmhd->bnhd", probs.to(v.dtype), v)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: torch.Tensor | None = None,
                          mask: torch.Tensor | None = None,
                          dropout_rate: float = 0.0,
                          generator: torch.Generator | None = None
                          ) -> torch.Tensor:
    """Multi-head attention with the JAX package's backend selection.

    q: (B, N, H, D), scaled inside by D**-0.5; k, v: (B, M, H, D); bias
    broadcastable to (B, H, N, M); mask boolean, True = attend.
    ``dropout_rate`` > 0 (training) forces the plain path, whose dropout
    draws from ``generator``. A bias that requires grad gets its gradient
    on either path.

    Under the "auto" backend a CUDA call with at least 256 queries goes to
    ``flash_attention`` when it has neither bias nor mask (q_len != k_len
    allowed; bf16 or fp32), and to the biased flash kernel when it has a
    (1, H, N, M) bias, q_len == k_len and at most a key-only (B, 1, 1, M)
    mask (bf16 or fp32), as in JAX. A CUDA call of a dtype its kernel does not
    take raises in the kernel's wrapper rather than running plain. The
    "flash" backend sends every call to ``flash_attention``, which refuses a
    mask; a bias raises here (the JAX package drops it without a word).
    """
    if dropout_rate > 0.0:
        return xla_attention(q, k, v, bias=bias, mask=mask,
                             dropout_rate=dropout_rate, generator=generator)
    k_only_mask = (
        mask is not None and mask.ndim == 4
        and mask.shape[1] == 1 and mask.shape[2] == 1
    )
    if _BACKEND == "auto" and q.is_cuda and q.shape[1] >= _FLASH_MIN_SEQ:
        from mr_blip_tpu_torch.ops.flash_attention import (
            flash_attention,
            flash_attention_bias,
        )

        if bias is None and mask is None:
            return flash_attention(q, k, v)
        if (
            bias is not None and bias.shape[0] == 1
            and q.shape[1] == k.shape[1]
            and (mask is None or k_only_mask)
        ):
            kv_mask = None
            if mask is not None:
                kv_mask = mask[:, 0, 0, :].expand(q.shape[0], k.shape[1])
            bias = bias.to(q.dtype).expand(1, q.shape[2], q.shape[1], k.shape[1])
            return flash_attention_bias(q, k, v, bias.contiguous(), kv_mask)
    if _BACKEND == "flash":
        from mr_blip_tpu_torch.ops.flash_attention import flash_attention

        if bias is not None:
            raise NotImplementedError(
                "the flash backend takes no bias; use the auto backend")
        return flash_attention(q, k, v, mask=mask)
    return xla_attention(q, k, v, bias=bias, mask=mask)


def relpos_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     table: torch.Tensor,
                     kv_mask: torch.Tensor | None = None,
                     num_buckets: int = 32, max_distance: int = 128,
                     dropout_rate: float = 0.0,
                     generator: torch.Generator | None = None) -> torch.Tensor:
    """Attention with the T5 bidirectional rel-pos bias derived from a
    (H, num_buckets) table.

    On a CUDA tensor with at least 256 positions, q_len == k_len, no active
    dropout and a backend other than "xla" this goes to
    ``flash_attention_relpos``, whose kernels
    look the bias up themselves (O(N) memory, no (1, H, N, M) tensor; bf16
    only: another dtype raises there). Otherwise (short sequences, the CPU,
    active attention-weight dropout) the bias is materialized and
    ``xla_attention`` runs, as in JAX: the same bucket function and the same
    table, so the two routes compute one function. ``kv_mask``: optional
    (B, M), nonzero = attend. A table that requires grad gets its gradient
    on either route."""
    if (_BACKEND != "xla" and q.is_cuda and dropout_rate <= 0.0
            and q.shape[1] >= _FLASH_MIN_SEQ and q.shape[1] == k.shape[1]):
        from mr_blip_tpu_torch.ops.flash_attention import flash_attention_relpos

        return flash_attention_relpos(q, k, v, table, kv_mask=kv_mask,
                                      num_buckets=num_buckets,
                                      max_distance=max_distance)
    bias = materialize_relpos_bias(
        table.T, torch.arange(q.shape[1], device=q.device),
        torch.arange(k.shape[1], device=q.device), True, num_buckets,
        max_distance)
    mask = None if kv_mask is None else (kv_mask != 0)[:, None, None, :]
    return xla_attention(q, k, v, bias=bias, mask=mask,
                         dropout_rate=dropout_rate, generator=generator)
