"""Timestamp formatting for the interleaved video prompt.

Implements the five input time formats of the reference
(``lavis/models/blip2_mr_models/utils.py:388-529``) plus the
"annoying number" machinery (``blip2_mr.py:1497-1559``): integers under a
cutoff that the T5 tokenizer splits into multiple tokens are remapped to the
nearest single-token integer so every frame timestamp costs exactly one
token in the interleaved prompt.

All functions are host-side and operate on plain Python floats/lists; the
device-side prompt assembly consumes their integer token ids.  Float
round-tripping quirks of the reference are preserved intentionally (e.g.
``int(round(t / d, 2) * 100)`` truncating 28.999... to 28).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

TIME_FORMATS = (
    "seconds_integers",
    "seconds_floats",
    "relative_integers",
    "relative_floats",
    "framenumbers",
)


def find_annoying_numbers(tokenizer, range_end: int = 200) -> Tuple[List[int], List[int]]:
    """Integers in [0, range_end) that tokenize to more than one token.

    Returns ``(annoying, annoying_with_space)``: the second list holds
    numbers whose first token is the bare-space piece (id 3 in the T5
    vocab) — those are excluded from remapping because the space prefix is
    stripped separately at embedding time.
    """
    space_id = getattr(tokenizer, "space_piece_id", 3)
    annoying = []
    annoying_space = []
    for i in range(range_end):
        ids = tokenizer.encode(str(i), add_special_tokens=False)
        if len(ids) > 1:
            if ids[0] == space_id:
                annoying_space.append(i)
            else:
                annoying.append(i)
    return annoying, annoying_space


def find_annoying_numbers_replacement_dict(annoying_numbers: Sequence[int]) -> Dict[int, int]:
    """Closest non-annoying integer for each annoying one (ties prefer larger)."""
    annoying = set(annoying_numbers)
    replacement = {}
    for i in annoying_numbers:
        new_i = i
        for j in range(100):
            if (i + j) not in annoying:
                new_i = i + j
                break
            if (i - j) not in annoying:
                new_i = i - j
                break
        replacement[i] = new_i
    return replacement


def _remap(value: int, replacement: Dict[int, int] | None) -> int:
    if replacement and value in replacement:
        return replacement[value]
    return value


def format_timestamps(
    input_time_format: str,
    timestamps: Sequence[Sequence[float]],
    durations: Sequence[float],
    annoying_numbers_replacement_dict: Dict[int, int] | None = None,
):
    """Format per-frame timestamps for one batch.

    Args:
        input_time_format: one of ``TIME_FORMATS``.
        timestamps: per-sample frame timestamps in seconds, shape [B][T].
        durations: per-sample video durations in seconds, shape [B].

    Returns:
        (new_timestamps, new_durations, video_prompts) where
        ``new_timestamps[b]`` is the list of numbers to interleave with the
        frame tokens, ``new_durations[b]`` the (possibly remapped) duration,
        and ``video_prompts[b]`` the equivalent text form (used for the
        non-interleaved path and for logging).
    """
    fmt = input_time_format
    if fmt not in TIME_FORMATS:
        raise ValueError(
            f"Invalid input_time_format {fmt!r}, choose from {list(TIME_FORMATS)}"
        )

    remap = annoying_numbers_replacement_dict
    new_timestamps: List[list] = []
    new_durations: List = []
    video_prompts: List[str] = []

    for t, d in zip(timestamps, durations):
        d = float(d)
        if fmt == "seconds_integers":
            vals = [_remap(round(float(ts)), remap) for ts in t]
            dur = _remap(round(d), remap)
            # Leading ">" so the first frame also gets a separator.
            prompt = ">" + ">".join(str(v) for v in vals) + ">" + str(dur)
            new_timestamps.append([int(v) for v in vals])
            new_durations.append(dur)
        elif fmt == "seconds_floats":
            vals = [round(float(ts), 2) for ts in t]
            prompt = ">".join(str(v) for v in vals) + ">" + str(round(d))
            new_timestamps.append(vals)
            new_durations.append(d)
        elif fmt == "relative_integers":
            vals = [int(round(float(ts) / d, 2) * 100) for ts in t]
            prompt = ">".join(str(v) for v in vals) + ">" + str(round(d))
            new_timestamps.append(vals)
            new_durations.append(d)
        elif fmt == "relative_floats":
            vals = [round(float(ts) / d, 2) for ts in t]
            prompt = ">".join(str(v) for v in vals[:-1]) + ">" + str(round(d))
            new_timestamps.append(vals + [round(d)])
            new_durations.append(d)
        else:  # framenumbers
            vals = list(range(len(t)))
            prompt = ">".join(str(i) for i in vals) + ">" + str(d)
            new_timestamps.append(vals)
            new_durations.append(d)
        video_prompts.append(prompt)

    return new_timestamps, new_durations, video_prompts
