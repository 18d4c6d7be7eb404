"""BERT WordPiece tokenizer (asset-driven, no network; the port's copy of
``mr_blip_tpu/text/wordpiece.py``, which imports only numpy).

The reference zoo models tokenize with HF ``BertTokenizer`` over the
bert-base-uncased ``vocab.txt`` (``lavis/models/blip_models/blip.py
init_tokenizer``, ``albef_models/__init__.py``, ``alpro_models``): basic
whitespace/punctuation/CJK pre-split + lowercase + accent stripping, then
greedy longest-match-first WordPiece with ``##`` continuation pieces.

This is a from-scratch implementation of that algorithm; point it at any
BERT ``vocab.txt`` (``MRBLIP_BERT_VOCAB`` env or explicit path). BLIP's
extra special tokens ([DEC]/[ENC]) are appended when absent, mirroring
``blip.py init_tokenizer``'s ``add_special_tokens``.

Parity: tests/test_torch_blip_v1.py holds the ids against the JAX
package's tokenizer over a vocabulary the test writes.
"""

from __future__ import annotations

import os
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII ranges treated as punctuation by BERT even when unicode says
    # otherwise ($, +, <, =, >, ^, `, |, ~)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F
    )


def basic_tokenize(text: str, lower: bool = True) -> List[str]:
    """BERT BasicTokenizer: clean, CJK-space, lowercase+strip accents,
    split on whitespace and punctuation."""
    out_chars = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or unicodedata.category(ch) in ("Cc", "Cf"):
            if ch in ("\t", "\n", "\r"):
                out_chars.append(" ")
            continue
        if _is_cjk(cp):
            out_chars.append(f" {ch} ")
        elif ch.isspace():
            out_chars.append(" ")
        else:
            out_chars.append(ch)
    tokens = []
    for tok in "".join(out_chars).split():
        if lower:
            tok = tok.lower()
            tok = "".join(
                c for c in unicodedata.normalize("NFD", tok)
                if unicodedata.category(c) != "Mn"
            )
        cur = []
        for ch in tok:
            if _is_punctuation(ch):
                if cur:
                    tokens.append("".join(cur))
                    cur = []
                tokens.append(ch)
            else:
                cur.append(ch)
        if cur:
            tokens.append("".join(cur))
    return tokens


def wordpiece_split(token: str, vocab: Dict[str, int], unk: str = "[UNK]",
                    max_chars: int = 100) -> List[str]:
    """Greedy longest-match-first WordPiece of one basic token."""
    if len(token) > max_chars:
        return [unk]
    pieces = []
    start = 0
    while start < len(token):
        end = len(token)
        cur = None
        while start < end:
            sub = token[start:end]
            if start > 0:
                sub = "##" + sub
            if sub in vocab:
                cur = sub
                break
            end -= 1
        if cur is None:
            return [unk]
        pieces.append(cur)
        start = end
    return pieces


class BertWordPieceTokenizer:
    """HF-BertTokenizer-equivalent encode/decode over a ``vocab.txt``.

    ``bos_token`` defaults to BLIP's [DEC] (prepended on decoder inputs by
    callers); [DEC]/[ENC] rows are appended when the vocab lacks them, as
    the reference's ``add_special_tokens`` does (blip.py:init_tokenizer).
    """

    def __init__(self, vocab_path: str, lower: bool = True,
                 add_blip_tokens: bool = True):
        self.lower = lower
        self.vocab: Dict[str, int] = {}
        with open(vocab_path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                self.vocab[line.rstrip("\n")] = i
        if add_blip_tokens:
            for tok in ("[DEC]", "[ENC]"):
                if tok not in self.vocab:
                    self.vocab[tok] = len(self.vocab)
        self.inv_vocab = {i: t for t, i in self.vocab.items()}
        self.pad_token_id = self.vocab.get("[PAD]", 0)
        self.unk_token_id = self.vocab.get("[UNK]", 1)
        self.cls_token_id = self.vocab.get("[CLS]", 2)
        self.sep_token_id = self.vocab.get("[SEP]", 3)
        self.mask_token_id = self.vocab.get("[MASK]", 4)
        self.bos_token_id = self.vocab.get("[DEC]", self.cls_token_id)
        self.enc_token_id = self.vocab.get("[ENC]", self.cls_token_id)
        self.eos_token_id = self.sep_token_id
        self.vocab_size = len(self.vocab)

    @classmethod
    def from_env(cls) -> Optional["BertWordPieceTokenizer"]:
        path = os.environ.get("MRBLIP_BERT_VOCAB")
        if path and os.path.exists(path):
            return cls(path)
        return None

    def tokenize(self, text: str) -> List[str]:
        pieces = []
        for tok in basic_tokenize(text, lower=self.lower):
            pieces.extend(wordpiece_split(tok, self.vocab))
        return pieces

    def encode(self, text: str, max_len: int = 512,
               add_special_tokens: bool = True) -> List[int]:
        ids = [self.vocab.get(p, self.unk_token_id) for p in self.tokenize(text)]
        if add_special_tokens:
            return [self.cls_token_id] + ids[: max_len - 2] + [self.sep_token_id]
        return ids[:max_len]

    def __call__(self, texts: Sequence[str], max_len: int = 512,
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """Padded batch (ids, mask) — the zoo wrappers' tokenizer surface."""
        rows = [self.encode(t, max_len) for t in texts]
        n = max(len(r) for r in rows)
        ids = np.full((len(rows), n), self.pad_token_id, np.int32)
        mask = np.zeros((len(rows), n), np.int32)
        for i, r in enumerate(rows):
            ids[i, : len(r)] = r
            mask[i, : len(r)] = 1
        return ids, mask

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        special = {self.pad_token_id, self.cls_token_id, self.sep_token_id,
                   self.mask_token_id, self.bos_token_id, self.enc_token_id}
        words: List[str] = []
        for i in ids:
            i = int(i)
            if skip_special_tokens and i == self.sep_token_id:
                break
            if skip_special_tokens and i in special:
                continue
            piece = self.inv_vocab.get(i, "[UNK]")
            if piece.startswith("##") and words:
                words[-1] += piece[2:]
            else:
                words.append(piece)
        return " ".join(words)
