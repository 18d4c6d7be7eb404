"""The facts of a T5 vocabulary that the Mr. BLIP prompt and span pipeline
relies on, checked on a loaded tokenizer (the asset-day chain's step 2 and
``tests/test_torch_tokenizer.py``).

``check_vocab(tok)`` derives each fact and lists every one that fails: the
special ids (pad 0, eos 1, unk 2, the bare space piece "▁" 3); the answer
letters at the ids the reference hard-codes for its QA logits (71, 272, 205,
309, 262); ``<extra_id_0>`` the highest sentinel, descending; the annoying
numbers below 200 and their replacements (each nearest non-annoying integer
within 10, itself one piece or a space-flavoured one); the leading space
piece of the space-flavoured numbers; and the round trip of span strings.
"""

from __future__ import annotations

from typing import Any, Dict, List

from mr_blip_tpu_torch.text.timestamps import (
    find_annoying_numbers,
    find_annoying_numbers_replacement_dict,
)

REFERENCE_ANSWER_IDS = [71, 272, 205, 309, 262]
SPAN_STRINGS = ("[[10, 25]]", "[[0, 150]]", "[[3, 7], [80, 99]]")
MAX_REPLACEMENT_DISTANCE = 10


def check_vocab(tok) -> Dict[str, Any]:
    """The derived facts of ``tok`` and, under ``"failures"``, a line for
    each one that does not hold (empty when the vocabulary is fit)."""
    failures: List[str] = []
    specials = (tok.pad_token_id, tok.eos_token_id, tok.unk_token_id,
                tok.convert_tokens_to_ids("▁"))
    if specials != (0, 1, 2, 3):
        failures.append(f"special ids (pad, eos, unk, '▁') = {specials}, want (0, 1, 2, 3)")
    answer_ids = [tok.encode(letter, add_special_tokens=False)[-1] for letter in "ABCDE"]
    if answer_ids != REFERENCE_ANSWER_IDS:
        failures.append(f"answer ids A-E = {answer_ids}, want {REFERENCE_ANSWER_IDS}")
    extra = [tok.convert_tokens_to_ids(f"<extra_id_{k}>") for k in (0, 1, 99)]
    if not (extra[0] == extra[1] + 1 == extra[2] + 99):
        failures.append(f"<extra_id_0/1/99> = {extra}: not descending from the top")
    annoying, annoying_space = find_annoying_numbers(tok, 200)
    replacement = find_annoying_numbers_replacement_dict(annoying)
    for n, r in replacement.items():
        ids = tok.encode(str(r), add_special_tokens=False)
        if r in replacement or abs(r - n) > MAX_REPLACEMENT_DISTANCE or not (
                len(ids) == 1 or ids[0] == 3):
            failures.append(f"annoying {n} -> {r} (pieces {ids}) is not a near "
                            "single-piece or space-flavoured number")
    for n in annoying_space:
        ids = tok.encode(str(n), add_special_tokens=False)
        if not (ids[0] == 3 and len(ids) > 1):
            failures.append(f"space-flavoured {n} -> {ids}")
    for s in SPAN_STRINGS:
        ids = tok.encode(s, add_special_tokens=False)
        if tok.unk_token_id in ids or tok.decode(ids) != s:
            failures.append(f"span {s!r} -> {ids} -> {tok.decode(ids)!r}")
    return {"special_ids": list(specials), "answer_ids": answer_ids, "extra_ids": extra,
            "annoying": annoying, "annoying_space": annoying_space,
            "replacement": replacement, "vocab_size": tok.vocab_size,
            "failures": failures}
