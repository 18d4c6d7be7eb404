"""GPT-2's byte-level BPE (OPT's vocabulary), as HF ``tokenizers`` runs it.

The pieces ``tokenizer_json`` assembles for a ``BPE`` model: GPT-2's
byte-to-unicode table, its split pattern, merges by rank, the
``ByteLevel`` decoder and the reader of ``vocab.json`` + ``merges.txt``.
Standard library only: the split
pattern (``'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|
\\s+(?!\\S)|\\s+``) is scanned by hand over ``unicodedata.category``, since
``re`` has no ``\\p{...}`` and the ``regex`` package may be absent.
"""

from __future__ import annotations

import json
import os
import unicodedata
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

# Unicode's White_Space property (what Rust's char::is_whitespace and
# Oniguruma's \s test); Python's str.isspace also takes U+001C-U+001F.
WHITE_SPACE = frozenset(
    "\t\n\x0b\x0c\r \x85\xa0\u1680\u2028\u2029\u202f\u205f\u3000"
    + "".join(chr(c) for c in range(0x2000, 0x200B)))


@lru_cache(maxsize=1)
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible map of the 256 bytes to printable characters."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _letter(ch: str) -> bool:
    return unicodedata.category(ch)[0] == "L"


def _number(ch: str) -> bool:
    return unicodedata.category(ch)[0] == "N"


def _other(ch: str) -> bool:
    return not (ch in WHITE_SPACE or _letter(ch) or _number(ch))


_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")


def gpt2_split(text: str) -> List[str]:
    """``text`` cut by GPT-2's pattern, leftmost alternative first."""
    out, i, n = [], 0, len(text)
    while i < n:
        j = None
        if text[i] == "'":
            for c in _CONTRACTIONS:
                if text.startswith(c, i + 1):
                    j = i + 1 + len(c)
                    break
        if j is None:
            for cls in (_letter, _number, _other):
                k = i + 1 if text[i] == " " and i + 1 < n and cls(text[i + 1]) else i
                if k < n and cls(text[k]):
                    j = k + 1
                    while j < n and cls(text[j]):
                        j += 1
                    break
        if j is None:  # whitespace: \s+(?!\S), else \s+
            j = i
            while j < n and text[j] in WHITE_SPACE:
                j += 1
            if j < n and j - 1 > i:
                j -= 1
        out.append(text[i:j])
        i = j
    return out


def byte_level_pre_tokenize(text: str, add_prefix_space: bool, use_regex: bool) -> List[str]:
    """HF's ``ByteLevel`` pre-tokenizer: the split words, each byte mapped."""
    if add_prefix_space and not text.startswith(" "):
        text = " " + text
    table = bytes_to_unicode()
    words = gpt2_split(text) if use_regex else [text]
    return ["".join(table[b] for b in w.encode("utf-8")) for w in words if w]


def byte_level_decode(tokens: Sequence[str]) -> str:
    """HF's ``ByteLevel`` decoder: a token whose characters all map back to
    bytes gives those bytes, any other its own UTF-8; invalid UTF-8 becomes
    U+FFFD."""
    inverse = {c: b for b, c in bytes_to_unicode().items()}
    raw = bytearray()
    for token in tokens:
        mapped = [inverse.get(c) for c in token]
        raw.extend(token.encode("utf-8") if None in mapped else bytes(mapped))
    return raw.decode("utf-8", errors="replace")


class BPE:
    """A BPE model with GPT-2's options: no subword prefix or suffix, no
    dropout, no byte fallback, merges applied lowest rank first."""

    def __init__(self, vocab: Dict[str, int], merges: Sequence[Tuple[str, str]],
                 unk_token: Optional[str] = None, fuse_unk: bool = False):
        self.vocab = dict(vocab)
        self.inverse = {i: t for t, i in self.vocab.items()}
        self.ranks = {tuple(m): r for r, m in enumerate(merges)}
        self.unk_token = unk_token
        self.fuse_unk = fuse_unk
        self._cache: Dict[str, List[int]] = {}

    def __len__(self) -> int:
        return len(self.vocab)

    def _merge(self, word: str) -> List[str]:
        symbols = list(word)
        ranks = self.ranks
        while len(symbols) > 1:
            best = min(range(len(symbols) - 1),
                       key=lambda k: ranks.get((symbols[k], symbols[k + 1]), float("inf")))
            pair = (symbols[best], symbols[best + 1])
            if pair not in ranks:
                break
            merged, k = [], 0
            while k < len(symbols):
                if k + 1 < len(symbols) and (symbols[k], symbols[k + 1]) == pair:
                    merged.append(pair[0] + pair[1])
                    k += 2
                else:
                    merged.append(symbols[k])
                    k += 1
            symbols = merged
        return symbols

    def tokenize(self, word: str) -> List[int]:
        hit = self._cache.get(word)
        if hit is not None:
            return hit
        ids: List[int] = []
        unk_run = False
        for symbol in self._merge(word):
            if symbol in self.vocab:
                ids.append(self.vocab[symbol])
                unk_run = False
                continue
            if self.unk_token is None or self.unk_token not in self.vocab:
                raise ValueError(f"BPE: {symbol!r} is not in the vocabulary and the "
                                 "model has no unk_token")
            if not (self.fuse_unk and unk_run):
                ids.append(self.vocab[self.unk_token])
            unk_run = True
        if len(self._cache) >= 10000:
            self._cache.clear()
        self._cache[word] = ids
        return ids

    def id_to_token(self, idx: int) -> Optional[str]:
        return self.inverse.get(idx)


def read_vocab_merges(directory: str) -> Tuple[Dict[str, int], List[Tuple[str, str]]]:
    """``vocab.json`` and ``merges.txt`` as ``GPT2Tokenizer`` reads them (the
    first line of ``merges.txt``, its ``#version`` header, and the text after
    the last newline are dropped)."""
    with open(os.path.join(directory, "vocab.json"), encoding="utf-8") as f:
        vocab = json.load(f)
    with open(os.path.join(directory, "merges.txt"), encoding="utf-8") as f:
        lines = f.read().split("\n")[1:-1]
    return vocab, [tuple(line.split()) for line in lines]
