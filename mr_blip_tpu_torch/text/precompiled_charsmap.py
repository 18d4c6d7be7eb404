"""SentencePiece's precompiled normalization map, read as HF ``tokenizers``
reads it (``normalizers.Precompiled``; the ``spm_precompiled`` crate).

The blob (base64 in ``tokenizer.json``) is a little-endian u32 trie size in
bytes, then that many bytes of darts-clone double-array units, then the
NUL-separated replacement strings. A key is a UTF-8 string; its value is the
offset of its replacement in the string part.

Lookup follows HF's order: each grapheme shorter than 6 UTF-8 bytes is
looked up whole, and the *shortest* key that is a prefix of it replaces the
whole grapheme; otherwise (or with no match) each character is looked up on
its own, and a character with no key is copied through. Graphemes are
approximated here (``graphemes``): a base character and the combining marks
(category ``M*``), joiners and half-width voiced marks that follow it;
a control alone; ``"\\r\\n"``. Unicode's segmentation also joins an emoji
ZWJ sequence into one cluster and a prepended mark (e.g. U+0600) to what
follows it; there the port can differ from ``tokenizers``
(``tests/test_torch_tokenizer.py``, the known differences).
"""

from __future__ import annotations

import struct
import unicodedata
from typing import Dict, List, Optional

# Characters that extend the grapheme before them beyond the M* categories:
# ZWNJ, ZWJ, the half-width katakana voiced marks, the emoji skin-tone
# modifiers.
_EXTEND = frozenset("\u200c\u200d\uff9e\uff9f") | frozenset(
    chr(c) for c in range(0x1F3FB, 0x1F400))


def _extends(ch: str) -> bool:
    return ch in _EXTEND or unicodedata.category(ch).startswith("M")


def _control(ch: str) -> bool:
    """Grapheme_Cluster_Break=Control (approximately): a cluster of its own."""
    cat = unicodedata.category(ch)
    return cat in ("Cc", "Zl", "Zp") or (cat == "Cf" and ch not in "\u200c\u200d")


def graphemes(text: str) -> List[str]:
    """``text`` cut into approximate extended grapheme clusters."""
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        j = i + 1
        if text[i] == "\r" and j < n and text[j] == "\n":
            j += 1
        elif not _control(text[i]):
            while j < n and _extends(text[j]):
                j += 1
        out.append(text[i:j])
        i = j
    return out


class PrecompiledCharsMap:
    """The normalizer of one ``precompiled_charsmap`` blob."""

    def __init__(self, blob: bytes):
        if len(blob) < 4:
            raise ValueError("precompiled_charsmap: shorter than its 4-byte header")
        (trie_size,) = struct.unpack_from("<I", blob, 0)
        if trie_size % 4 or 4 + trie_size > len(blob):
            raise ValueError(f"precompiled_charsmap: trie size {trie_size} does not "
                             f"fit a {len(blob)}-byte blob")
        self._units = struct.unpack_from(f"<{trie_size // 4}I", blob, 4)
        self._normalized = blob[4 + trie_size:]
        self._cache: Dict[str, Optional[str]] = {}
        # ASCII characters with a replacement of their own: a pure-ASCII
        # text with none of them (and no "\r") is returned as it is.
        self._ascii_hits = frozenset(
            c for c in map(chr, range(128)) if self._transform(c) is not None)

    def _shortest_match(self, key: bytes) -> Optional[int]:
        """The value of the shortest key that is a prefix of ``key``: the
        first result of darts-clone's common-prefix search, as HF takes it."""
        units = self._units
        pos = units[0] >> 10 << ((units[0] & 0x200) >> 6)
        for byte in key:
            if byte == 0:
                return None
            pos ^= byte
            if pos >= len(units):
                return None
            unit = units[pos]
            if unit & 0x800000FF != byte:
                return None
            pos ^= unit >> 10 << ((unit & 0x200) >> 6)
            if unit & 0x100:
                return units[pos] & 0x7FFFFFFF
        return None

    def _transform(self, chunk: str) -> Optional[str]:
        if chunk in self._cache:
            return self._cache[chunk]
        offset = self._shortest_match(chunk.encode("utf-8"))
        out = None
        if offset is not None:
            end = self._normalized.find(b"\0", offset)
            out = self._normalized[offset:end if end >= 0 else None].decode("utf-8")
        self._cache[chunk] = out
        return out

    def __call__(self, text: str) -> str:
        if text.isascii() and "\r" not in text and not self._ascii_hits.intersection(text):
            return text
        parts = []
        for grapheme in graphemes(text):
            if len(grapheme.encode("utf-8")) < 6:
                norm = self._transform(grapheme)
                if norm is not None:
                    parts.append(norm)
                    continue
            for ch in grapheme:
                norm = self._transform(ch)
                parts.append(ch if norm is None else norm)
        return "".join(parts)
