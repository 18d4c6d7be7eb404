"""Vectorized interleaved-prompt construction (host plan + device gather);
counterpart of ``mr_blip_tpu/models/prompt_assembly.py``, whose numpy
``build_interleave_plan`` is copied here unchanged.

The reference builds the interleaved video prompt
``[frame_1(32 tok) ‖ t_1][frame_2 ‖ t_2]… > duration`` with per-sample
Python loops and torch.cat (blip2_mr.py:691-757) — a CPU bottleneck it
itself flags.  Here the host precomputes a static *gather plan* (numpy) and
the device materializes the sequence with two batched gathers — no scatter,
no per-sample work on the accelerator:

    out[b, p] = frames[b, src_idx[b, p]]      where src_type[b, p] == FRAME
              = time_embs[b, src_idx[b, p]]   where src_type[b, p] == TIME
              = pad embedding                 where src_type[b, p] == PAD

Like the reference, samples are LEFT-padded to the batch max interleaved
length (blip2_mr.py:744-753), so positions near the text prompt stay
aligned across the batch.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

PAD, FRAME, TIME = 0, 1, 2


@dataclasses.dataclass
class InterleavePlan:
    """Static numpy plan consumed by the device-side gather."""

    src_type: np.ndarray      # (B, L) int32 in {PAD, FRAME, TIME}
    src_idx: np.ndarray       # (B, L) int32 index into frame rows / time tokens
    time_ids: np.ndarray      # (B, N_time) int32 token ids (0-padded)
    attn_mask: np.ndarray     # (B, L) int32, 1 = real token
    video_prompts: List[str]  # human-readable form, for logging parity

    @property
    def length(self) -> int:
        return self.src_type.shape[1]


def clean_timestamp_tokens(tokenizer, values: Sequence) -> List[List[int]]:
    """Tokenize each timestamp value, stripping the leading space piece.

    Mirrors ``get_clean_timestamp_tokens_and_embs`` (blip2_mr.py:1561-1608):
    tokenize ``str(v)`` without special tokens and drop a leading id-3
    ("▁") if present.
    """
    out = []
    for v in values:
        ids = tokenizer.encode(str(v), add_special_tokens=False)
        if ids and ids[0] == tokenizer.space_piece_id:
            ids = ids[1:]
        out.append(ids)
    return out


def build_interleave_plan(
    tokenizer,
    timestamps: Sequence[Sequence],
    durations: Sequence,
    tokens_per_frame: int,
    separator_token_id: int | None = None,
    pad_to_multiple: int = 8,
) -> InterleavePlan:
    """Build the gather plan for one batch.

    Args:
        timestamps: formatted per-frame timestamp values, shape [B][T]
            (ints or floats — whatever ``format_timestamps`` produced).
        durations: formatted per-sample durations.
        tokens_per_frame: 32 query tokens, or 1 under mean aggregation.
    """
    if separator_token_id is None:
        separator_token_id = tokenizer.convert_tokens_to_ids(">")

    batch_tokens: List[List[List[int]]] = []
    batch_dur_tokens: List[List[int]] = []
    prompts: List[str] = []
    for ts, dur in zip(timestamps, durations):
        per_frame = clean_timestamp_tokens(tokenizer, ts)
        dur_tokens = clean_timestamp_tokens(tokenizer, [dur])[0]
        batch_tokens.append(per_frame)
        batch_dur_tokens.append(dur_tokens)
        prompts.append(
            "".join(
                f"f{i}-{tokenizer.decode(t)}>" for i, t in enumerate(per_frame)
            )
            + tokenizer.decode(dur_tokens)
        )

    lengths = [
        sum(len(t) for t in per_frame) + len(per_frame) * tokens_per_frame
        + 1 + len(dur)
        for per_frame, dur in zip(batch_tokens, batch_dur_tokens)
    ]
    L = max(lengths)
    if pad_to_multiple > 1:
        L = ((L + pad_to_multiple - 1) // pad_to_multiple) * pad_to_multiple

    B = len(batch_tokens)
    n_time = max(
        sum(len(t) for t in per_frame) + 1 + len(dur)
        for per_frame, dur in zip(batch_tokens, batch_dur_tokens)
    )

    src_type = np.zeros((B, L), np.int32)
    src_idx = np.zeros((B, L), np.int32)
    time_ids = np.zeros((B, n_time), np.int32)
    attn = np.zeros((B, L), np.int32)

    for b, (per_frame, dur_tokens) in enumerate(zip(batch_tokens, batch_dur_tokens)):
        pos = L - lengths[b]  # LEFT padding offset
        t_cursor = 0
        for t, tok in enumerate(per_frame):
            fr0 = t * tokens_per_frame
            src_type[b, pos : pos + tokens_per_frame] = FRAME
            src_idx[b, pos : pos + tokens_per_frame] = np.arange(
                fr0, fr0 + tokens_per_frame
            )
            pos += tokens_per_frame
            for tid in tok:
                time_ids[b, t_cursor] = tid
                src_type[b, pos] = TIME
                src_idx[b, pos] = t_cursor
                t_cursor += 1
                pos += 1
        # separator then duration tokens
        for tid in [separator_token_id] + dur_tokens:
            time_ids[b, t_cursor] = tid
            src_type[b, pos] = TIME
            src_idx[b, pos] = t_cursor
            t_cursor += 1
            pos += 1
        attn[b, L - lengths[b]:] = 1
        assert pos == L

    return InterleavePlan(
        src_type=src_type, src_idx=src_idx, time_ids=time_ids,
        attn_mask=attn, video_prompts=prompts,
    )


def interleave_on_device(frames_for_t5: torch.Tensor, time_embs: torch.Tensor,
                         src_type: torch.Tensor, src_idx: torch.Tensor,
                         pad_emb: torch.Tensor) -> torch.Tensor:
    """Materialize the interleaved sequence with two gathers.

    Args:
        frames_for_t5: (B, T*n, d) projected frame tokens.
        time_embs: (B, N_time, d) embedded timestamp/duration tokens.
        src_type/src_idx: (B, L) plan arrays (integer tensors).
        pad_emb: (d,) embedding used at PAD positions.
    Returns:
        (B, L, d) interleaved encoder embeddings.
    """
    d = frames_for_t5.shape[-1]
    idx = src_idx.long()
    # Indices target whichever source the position selects; clamping keeps
    # the other gather in bounds (JAX mode="clip"; its values are discarded).
    def take(src):
        i = idx.clamp(0, src.shape[1] - 1)[..., None].expand(-1, -1, d)
        return torch.gather(src, 1, i)

    st = src_type[..., None]
    out = torch.where(st == FRAME, take(frames_for_t5), take(time_embs))
    return torch.where(st == PAD, pad_emb.to(out.dtype), out)
