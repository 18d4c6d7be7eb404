"""Tokenizer layer: T5-compatible interface, offline-first.

Two implementations behind one interface:

* :class:`HFT5Tokenizer` — wraps a HuggingFace ``T5TokenizerFast`` loaded
  from a **local** path (this environment has no network egress; the real
  flan-t5 vocab ships with deployment checkpoints).
* :class:`MockT5Tokenizer` — deterministic SentencePiece-like tokenizer for
  tests and benchmarks.  It reproduces the *structural* properties the
  Mr. BLIP prompt pipeline depends on (reference blip2_mr.py:1497-1608):
  ids pad=0 / eos=1 / unk=2, id 3 = the bare space piece "▁", 100
  ``<extra_id_*>`` sentinels at the top of the vocab, single-token integers
  with a deliberate set of multi-token ("annoying") numbers, and exact
  round-trip decode for the span-string grammar.

The interface is the subset of the HF tokenizer API the framework uses.
"""

from __future__ import annotations

import re
from typing import List, Sequence

import numpy as np


class BatchEncoding(dict):
    @property
    def input_ids(self):
        return self["input_ids"]

    @property
    def attention_mask(self):
        return self["attention_mask"]


class TokenizerBase:
    pad_token_id = 0
    eos_token_id = 1
    unk_token_id = 2
    space_piece_id = 3

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        raise NotImplementedError

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = False) -> str:
        raise NotImplementedError

    def convert_tokens_to_ids(self, token: str) -> int:
        raise NotImplementedError

    def __call__(
        self,
        texts,
        padding: str = "longest",
        truncation: bool = False,
        max_length: int | None = None,
        add_special_tokens: bool = True,
        padding_side: str = "right",
    ) -> BatchEncoding:
        if isinstance(texts, str):
            texts = [texts]
        seqs = [self.encode(t, add_special_tokens=add_special_tokens) for t in texts]
        if truncation and max_length is not None:
            seqs = [s[:max_length] for s in seqs]
        if padding == "max_length" and max_length is not None:
            target = max_length
        else:
            target = max(len(s) for s in seqs) if seqs else 0
        ids = np.full((len(seqs), target), self.pad_token_id, np.int32)
        mask = np.zeros((len(seqs), target), np.int32)
        for i, s in enumerate(seqs):
            if padding_side == "left":
                ids[i, target - len(s):] = s
                mask[i, target - len(s):] = 1
            else:
                ids[i, : len(s)] = s
                mask[i, : len(s)] = 1
        return BatchEncoding(input_ids=ids, attention_mask=mask)

    def batch_decode(self, batch_ids, skip_special_tokens: bool = False):
        return [self.decode(list(map(int, ids)), skip_special_tokens) for ids in batch_ids]


class HFT5Tokenizer(TokenizerBase):
    """Adapter over a locally stored HF T5 tokenizer."""

    def __init__(self, path: str):
        import os

        os.environ.setdefault("HF_HUB_OFFLINE", "1")
        os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(path, local_files_only=True)
        self.pad_token_id = self._tok.pad_token_id
        self.eos_token_id = self._tok.eos_token_id
        self.unk_token_id = self._tok.unk_token_id
        self.vocab_size = self._tok.vocab_size

    def encode(self, text, add_special_tokens=True):
        return self._tok.encode(text, add_special_tokens=add_special_tokens)

    def decode(self, ids, skip_special_tokens=False):
        return self._tok.decode(ids, skip_special_tokens=skip_special_tokens)

    def convert_tokens_to_ids(self, token):
        return self._tok.convert_tokens_to_ids(token)


class MockT5Tokenizer(TokenizerBase):
    """Deterministic T5-shaped tokenizer (no external assets).

    Layout: 0-3 specials; 4..~N word/char pieces assigned on a fixed
    alphabet; top-100 ids are ``<extra_id_0..99>`` (descending like T5).
    Integers: every int in [0, annoying_range) encodes to the single piece
    "▁<int>" after ">" -free context, EXCEPT ints divisible by 13 (two
    pieces — "annoying") and ints divisible by 17 (space-prefixed pieces:
    leading id 3).  Multiples of both (221...) fall in the 13 class.
    """

    VOCAB_SIZE = 4096
    _ANNOYING_MOD = 13
    _SPACY_MOD = 17

    def __init__(self):
        self.vocab_size = self.VOCAB_SIZE
        self._piece_to_id = {"<pad>": 0, "</s>": 1, "<unk>": 2, "▁": 3}
        self._id_to_piece = {v: k for k, v in self._piece_to_id.items()}
        self._next_id = 4
        # extra_id sentinels at the top, descending (T5 convention)
        for i in range(100):
            tid = self.VOCAB_SIZE - 1 - i
            piece = f"<extra_id_{i}>"
            self._piece_to_id[piece] = tid
            self._id_to_piece[tid] = piece
        # Stable base alphabet: printable ASCII as both word-start ("▁x")
        # and continuation ("x") pieces.
        for ch in (chr(c) for c in range(32, 127)):
            if ch == " ":
                continue
            self._intern("▁" + ch)
            self._intern(ch)
        self._intern("\n")
        self._intern("▁\n")
        # Common words used by the fixed prompts.
        for w in (
            "Query", "Given", "the", "video", "and", "query", "find",
            "relevant", "windows", "Relevant", "Question", "Option",
            "Options", "Considering", "information", "presented", "in",
            "frame", "select", "correct", "answer", "from", "options",
            "seconds", "duration", "A", "B", "C", "D", "E",
        ):
            self._intern("▁" + w)
            self._intern(w)
        # Integer pieces.
        for i in range(0, 300):
            s = str(i)
            if i % self._ANNOYING_MOD == 0 and i > 0:
                continue  # forced multi-token
            if i % self._SPACY_MOD == 0 and i > 0:
                self._intern(s)  # continuation piece only -> "▁" + piece
                continue
            self._intern("▁" + s)
            self._intern(s)

    def _intern(self, piece: str) -> int:
        if piece not in self._piece_to_id:
            pid = self._next_id
            assert pid < self.VOCAB_SIZE - 100, "mock vocab overflow"
            self._piece_to_id[piece] = pid
            self._id_to_piece[pid] = piece
            self._next_id += 1
        return self._piece_to_id[piece]

    _SPECIAL_RE = re.compile(r"(<extra_id_\d+>|</s>)")
    _WORD_RE = re.compile(r"\d+|[^\W\d_]+|[^\w\s]|\n")

    def _encode_word(self, word: str, word_start: bool) -> List[int]:
        out = []
        if word.isdigit():
            n = int(word)
            canon = str(n)
            if canon == word and n < 300:
                if n > 0 and n % self._ANNOYING_MOD == 0:
                    # two-piece number: first digit piece + remainder piece
                    first, rest = word[0], word[1:]
                    head = ("▁" + first) if word_start else first
                    out.append(self._piece_to_id.get(head, self.unk_token_id))
                    if rest:
                        out.append(self._lookup_cont(rest))
                    return out
                if n > 0 and n % self._SPACY_MOD == 0:
                    if word_start:
                        out.append(self.space_piece_id)
                    out.append(self._piece_to_id.get(word, self.unk_token_id))
                    return out
                key = ("▁" + word) if word_start else word
                if key in self._piece_to_id:
                    return [self._piece_to_id[key]]
        key = ("▁" + word) if word_start else word
        if key in self._piece_to_id:
            return [self._piece_to_id[key]]
        # char fallback
        for j, ch in enumerate(word):
            k = ("▁" + ch) if (word_start and j == 0) else ch
            out.append(self._piece_to_id.get(k, self.unk_token_id))
        return out

    def _lookup_cont(self, s: str) -> int:
        if s in self._piece_to_id:
            return self._piece_to_id[s]
        return self.unk_token_id

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids: List[int] = []
        pos = 0
        pending_space = True  # T5 treats the first word as word-start
        for part in self._SPECIAL_RE.split(text):
            if not part:
                continue
            if self._SPECIAL_RE.fullmatch(part):
                ids.append(self._piece_to_id[part])
                pending_space = False
                continue
            idx = 0
            for m in self._WORD_RE.finditer(part):
                gap = part[idx : m.start()]
                word_start = pending_space or (" " in gap)
                ids.extend(self._encode_word(m.group(), word_start))
                idx = m.end()
                pending_space = False
            pending_space = part.endswith(" ")
        if add_special_tokens:
            ids.append(self.eos_token_id)
        return ids

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        pieces = []
        for i in ids:
            i = int(i)
            piece = self._id_to_piece.get(i, "<unk>")
            if skip_special_tokens and (
                i in (self.pad_token_id, self.eos_token_id)
                or piece.startswith("<extra_id_")
            ):
                continue
            if not skip_special_tokens and i == self.pad_token_id:
                pieces.append("<pad>")
                continue
            pieces.append(piece)
        text = "".join(pieces).replace("▁", " ")
        return text.strip(" ")

    def convert_tokens_to_ids(self, token: str) -> int:
        # bare ">" maps to its continuation piece (mid-sentence separator),
        # mirroring reference blip2_mr.py:284.
        return self._piece_to_id.get(token, self.unk_token_id)


def load_tokenizer(name_or_path: str | None = None) -> TokenizerBase:
    """Load the HF tokenizer from a local path, else fall back to the mock."""
    if name_or_path and name_or_path not in ("mock", "none"):
        import os

        if os.path.exists(name_or_path):
            return HFT5Tokenizer(name_or_path)
    return MockT5Tokenizer()
