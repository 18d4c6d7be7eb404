"""CLIP byte-pair-encoding tokenizer (pure Python, asset-driven; the port's
copy of ``mr_blip_tpu/text/clip_bpe.py``, which imports only the standard
library and numpy).

The reference vendors OpenAI CLIP's tokenizer
(``lavis/models/clip_models/tokenizer.py`` + ``bpe_simple_vocab_16e6.txt.gz``).
This is an independent implementation of the same public algorithm: byte→
unicode remapping, lowercased whitespace-normalized pre-tokenization with
the CLIP word regex, greedy lowest-rank BPE merges over ``</w>``-terminated
words, and the ``<|startoftext|>/<|endoftext|>`` sentinels.

The merge table ships with deployments (it is a data asset, not code); pass
its path explicitly or via ``MR_BLIP_CLIP_BPE``. Vocabulary layout matches
CLIP: 256 byte symbols, 256 ``</w>`` byte symbols, one token per merge, then
the two sentinels (49408 total with the standard 48894-merge table).
"""

from __future__ import annotations

import gzip
import html
import os
import re
from functools import lru_cache
from typing import List

# CLIP's pattern uses \p{L}/\p{N}; stdlib `re` equivalents: [^\W\d_]+ is
# "unicode letters", and the final class is "not whitespace/letter/number"
# ((?:[^\w\s]|_)+ — underscore is \w but neither letter nor number).
_WORD_RE = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
    r"|[^\W\d_]+|[0-9]|(?:[^\w\s]|_)+",
    re.IGNORECASE | re.UNICODE,
)


@lru_cache()
def _bytes_to_unicode():
    """Invertible byte -> printable-unicode map (GPT-2/CLIP convention)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    text = re.sub(r"\s+", " ", text.strip())
    return text.lower()


class ClipBPETokenizer:
    """Encode/decode with a CLIP-format merge table."""

    def __init__(self, bpe_path: str | None = None, context_length: int = 77):
        bpe_path = bpe_path or os.environ.get("MR_BLIP_CLIP_BPE")
        if not bpe_path or not os.path.exists(bpe_path):
            raise FileNotFoundError(
                f"CLIP BPE merge table not found at {bpe_path!r}; pass bpe_path "
                "or set MR_BLIP_CLIP_BPE"
            )
        opener = gzip.open if bpe_path.endswith(".gz") else open
        with opener(bpe_path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        # first line is a version header; CLIP uses merges [1 : 49152-256-2+1]
        merges = [tuple(m.split()) for m in lines[1 : 49152 - 256 - 2 + 1] if m]
        self._ranks = {m: i for i, m in enumerate(merges)}

        self._byte_enc = _bytes_to_unicode()
        self._byte_dec = {v: k for k, v in self._byte_enc.items()}
        vocab = list(self._byte_enc.values())
        vocab += [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merges]
        vocab += ["<|startoftext|>", "<|endoftext|>"]
        self._encoder = {tok: i for i, tok in enumerate(vocab)}
        self._decoder = {i: tok for tok, i in self._encoder.items()}
        self.vocab_size = len(vocab)
        self.sot_token = self._encoder["<|startoftext|>"]
        self.eot_token = self._encoder["<|endoftext|>"]
        self.context_length = context_length
        self._cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }

    # -- BPE core ---------------------------------------------------------
    def _bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self._ranks.get(p, float("inf")))
            if best not in self._ranks:
                break
            first, second = best
            merged = []
            i = 0
            while i < len(word):
                if (
                    i < len(word) - 1
                    and word[i] == first
                    and word[i + 1] == second
                ):
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for word in _WORD_RE.findall(_clean(text)):
            token = "".join(self._byte_enc[b] for b in word.encode("utf-8"))
            ids.extend(self._encoder[t] for t in self._bpe(token).split(" "))
        return ids

    def decode(self, ids) -> str:
        text = "".join(self._decoder[int(i)] for i in ids)
        raw = bytearray(self._byte_dec[c] for c in text if c in self._byte_dec)
        return (
            raw.decode("utf-8", errors="replace").replace("</w>", " ").strip()
        )

    def __call__(self, texts, context_length: int | None = None):
        """CLIP batch format: (B, context_length) int32 with SOT/EOT,
        zero-padded and EOT-truncated like the reference tokenize()."""
        import numpy as np

        if isinstance(texts, str):
            texts = [texts]
        length = context_length or self.context_length
        out = np.zeros((len(texts), length), np.int32)
        for i, t in enumerate(texts):
            ids = [self.sot_token] + self.encode(t) + [self.eot_token]
            if len(ids) > length:
                ids = ids[:length]
                ids[-1] = self.eot_token
            out[i, : len(ids)] = ids
        return out
