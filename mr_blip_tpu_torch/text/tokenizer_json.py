"""A reader of HF fast-tokenizer directories that needs no ``tokenizers``,
``transformers`` or ``sentencepiece``.

It runs the pipeline HF's ``Tokenizer`` runs, for exactly the node types
that T5 and OPT exports use, and raises ``ValueError`` naming the type and
the file for any other:

* added tokens (``special``, ``normalized``, ``lstrip``, ``rstrip``,
  ``single_word``), split out leftmost-longest before the normalizer;
* normalizers ``Precompiled``, ``Replace`` (a string or a ``Regex``),
  ``Strip``, ``NFC``, ``NFKC``, ``Sequence`` and none;
* pre-tokenizers ``Metaspace`` (``prepend_scheme`` always / first / never or
  the legacy ``add_prefix_space``, with and without ``split``),
  ``WhitespaceSplit``, ``ByteLevel`` and ``Sequence``;
* the ``Unigram`` model (Viterbi over piece scores, runs of unknown
  characters fused into one unknown piece) and GPT-2's ``BPE``;
* post-processors ``TemplateProcessing`` and ``ByteLevel``;
* decoders ``Metaspace``, ``ByteLevel``, ``Replace``, ``Strip``, ``Fuse`` and
  ``Sequence``.

``HFDirectory`` adds what ``transformers`` reads beside ``tokenizer.json``
(``tokenizer_config.json``, ``special_tokens_map.json``) and the route it
takes for a ``vocab.json`` + ``merges.txt`` directory (``GPT2Converter``).
"""

from __future__ import annotations

import base64
import json
import os
import re
import unicodedata
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from mr_blip_tpu_torch.text.bpe import (
    BPE,
    WHITE_SPACE,
    byte_level_decode,
    byte_level_pre_tokenize,
    read_vocab_merges,
)
from mr_blip_tpu_torch.text.precompiled_charsmap import PrecompiledCharsMap

# (text, starts at the input's offset 0, leading characters were removed by
# the normalizer): what Metaspace's "first" scheme reads of a split.
Piece = Tuple[str, bool, bool]


def _unsupported(kind: str, node, where: str) -> ValueError:
    name = node.get("type") if isinstance(node, dict) else node
    return ValueError(f"{where}: {kind} {name!r} is not supported by the port's reader")


# ----------------------------------------------------------------- normalizers
def _pattern(node, where: str) -> "re.Pattern":
    pattern = node.get("pattern", {})
    if "String" in pattern:
        return re.compile(re.escape(pattern["String"]))
    if "Regex" in pattern:
        try:
            return re.compile(pattern["Regex"])
        except re.error as err:
            raise ValueError(f"{where}: Replace pattern {pattern['Regex']!r}: {err}") from err
    raise ValueError(f"{where}: Replace pattern {pattern!r}")


def _strip(text: str, left: bool, right: bool) -> str:
    i, j = 0, len(text)
    while left and i < j and text[i] in WHITE_SPACE:
        i += 1
    while right and j > i and text[j - 1] in WHITE_SPACE:
        j -= 1
    return text[i:j]


def build_normalizer(node, where: str) -> Tuple[Callable[[str], str], bool]:
    """(the normalizer, whether it can strip leading characters)."""
    if node is None:
        return (lambda s: s), False
    kind = node.get("type")
    if kind == "Sequence":
        parts = [build_normalizer(n, where) for n in node["normalizers"]]

        def run(s):
            for fn, _ in parts:
                s = fn(s)
            return s
        return run, any(left for _, left in parts)
    if kind == "Precompiled":
        charsmap = node.get("precompiled_charsmap")
        if not charsmap:  # HF's Precompiled with an empty map changes nothing
            return (lambda s: s), False
        return PrecompiledCharsMap(base64.b64decode(charsmap)), False
    if kind == "Replace":
        pattern, content = _pattern(node, where), node["content"]
        return (lambda s: pattern.sub(lambda _: content, s)), False
    if kind == "Strip":
        left, right = bool(node.get("strip_left")), bool(node.get("strip_right"))
        return (lambda s: _strip(s, left, right)), left
    if kind in ("NFC", "NFKC"):
        return (lambda s: unicodedata.normalize(kind, s)), False
    raise _unsupported("normalizer", node, where)


# -------------------------------------------------------------- pre-tokenizers
def _metaspace_scheme(node) -> str:
    if "prepend_scheme" in node:
        return node["prepend_scheme"]
    return "always" if node.get("add_prefix_space", True) else "never"


_WHITESPACE_RUN = re.compile("[" + re.escape("".join(sorted(WHITE_SPACE))) + "]+")


def _split_merged_with_next(text: str, delim: str) -> List[str]:
    cuts = [0] + [i for i, c in enumerate(text) if c == delim and i > 0] + [len(text)]
    return [text[a:b] for a, b in zip(cuts, cuts[1:]) if b > a]


def build_pre_tokenizer(node, where: str) -> Callable[[List[Piece]], List[Piece]]:
    if node is None:
        return lambda pieces: pieces
    kind = node.get("type")
    if kind == "Sequence":
        steps = [build_pre_tokenizer(n, where) for n in node["pretokenizers"]]

        def run(pieces):
            for step in steps:
                pieces = step(pieces)
            return pieces
        return run
    if kind == "Metaspace":
        rep, scheme = node.get("replacement", "▁"), _metaspace_scheme(node)
        split = node.get("split", True)
        if scheme not in ("always", "first", "never"):
            raise _unsupported("Metaspace prepend_scheme", scheme, where)

        def metaspace(pieces):
            out = []
            for text, origin, lead_removed in pieces:
                text = text.replace(" ", rep)
                if text and not text.startswith(rep) and (
                        scheme == "always"
                        or (scheme == "first" and origin and not lead_removed)):
                    text = rep + text
                parts = _split_merged_with_next(text, rep) if split else [text]
                out.extend((p, origin and k == 0 and not lead_removed, False)
                           for k, p in enumerate(parts) if p)
            return out
        return metaspace
    if kind == "WhitespaceSplit":
        def whitespace_split(pieces):
            out = []
            for text, origin, lead_removed in pieces:
                words = _WHITESPACE_RUN.split(text)
                first = origin and not lead_removed and text[:1] not in WHITE_SPACE
                out.extend((w, first and k == 0, False) for k, w in enumerate(words) if w)
            return out
        return whitespace_split
    if kind == "ByteLevel":
        prefix, use_regex = node.get("add_prefix_space", True), node.get("use_regex", True)
        return lambda pieces: [(w, False, False) for text, _, _ in pieces
                               for w in byte_level_pre_tokenize(text, prefix, use_regex)]
    raise _unsupported("pre_tokenizer", node, where)


# ------------------------------------------------------------------- models
class Unigram:
    """HF's Unigram model: the optimized Viterbi of ``encode_optimized``
    (scores summed in float64 in the same order, ties kept by the first,
    shortest piece), runs of unknown pieces fused into one."""

    K_UNK_PENALTY = 10.0

    def __init__(self, vocab: Sequence[Tuple[str, float]], unk_id: Optional[int]):
        self.pieces = [p for p, _ in vocab]
        self.scores = [float(s) for _, s in vocab]
        self.ids = {p: i for i, p in enumerate(self.pieces)}
        self.unk_id = unk_id
        self.unk_score = min(self.scores) - self.K_UNK_PENALTY
        self.max_len = max(map(len, self.pieces))
        self._cache: Dict[str, List[int]] = {}

    def __len__(self) -> int:
        return len(self.pieces)

    def _viterbi(self, word: str) -> List[str]:
        n = len(word)
        score = [0.0] * (n + 1)
        start: List[Optional[int]] = [None] * (n + 1)
        piece_id = [0] * (n + 1)
        for i in range(n):
            base = score[i]
            single = False
            for k in range(i + 1, min(n, i + self.max_len) + 1):
                pid = self.ids.get(word[i:k])
                if pid is not None:
                    cand = self.scores[pid] + base
                    if start[k] is None or cand > score[k]:
                        score[k], start[k], piece_id[k] = cand, i, pid
                    single = single or k == i + 1
            if not single:
                if self.unk_id is None:
                    raise ValueError(f"Unigram: {word[i]!r} has no piece and the model "
                                     "has no unk_id")
                cand = self.unk_score + base
                if start[i + 1] is None or cand > score[i + 1]:
                    score[i + 1], start[i + 1], piece_id[i + 1] = cand, i, self.unk_id
        out: List[str] = []
        unk: List[str] = []
        end = n
        while end > 0:
            begin = start[end]
            if piece_id[end] == self.unk_id:
                unk.append(word[begin:end])
            else:
                if unk:
                    out.append("".join(reversed(unk)))
                    unk = []
                out.append(word[begin:end])
            end = begin
        if unk:
            out.append("".join(reversed(unk)))
        return out[::-1]

    def tokenize(self, word: str) -> List[int]:
        hit = self._cache.get(word)
        if hit is None:
            hit = [self.ids.get(p, self.unk_id) for p in self._viterbi(word)]
            if len(self._cache) >= 10000:
                self._cache.clear()
            self._cache[word] = hit
        return hit

    def id_to_token(self, idx: int) -> Optional[str]:
        return self.pieces[idx] if 0 <= idx < len(self.pieces) else None


def build_model(node, where: str):
    kind = node.get("type")
    if kind == "Unigram":
        if node.get("byte_fallback"):
            raise ValueError(f"{where}: Unigram byte_fallback=true is not supported "
                             "by the port's reader")
        return Unigram([tuple(v) for v in node["vocab"]], node.get("unk_id"))
    if kind == "BPE":
        for key, plain in (("dropout", None), ("continuing_subword_prefix", ""),
                           ("end_of_word_suffix", ""), ("byte_fallback", False),
                           ("ignore_merges", False)):
            if node.get(key) not in (plain, None):
                raise ValueError(f"{where}: BPE {key}={node[key]!r} is not supported "
                                 "by the port's reader")
        merges = [tuple(m.split(" ")) if isinstance(m, str) else tuple(m)
                  for m in node["merges"]]
        return BPE(node["vocab"], merges, node.get("unk_token"), bool(node.get("fuse_unk")))
    raise _unsupported("model", node, where)


# ---------------------------------------------------------- post and decoders
def build_post_processor(node, where: str) -> Callable[[List[int]], List[int]]:
    if node is None or node.get("type") == "ByteLevel":
        return lambda ids: ids
    if node.get("type") != "TemplateProcessing":
        raise _unsupported("post_processor", node, where)
    specials = {k: list(v["ids"]) for k, v in node.get("special_tokens", {}).items()}
    template = []
    for item in node["single"]:
        if "Sequence" in item:
            template.append(None)
        else:
            template.append(specials[item["SpecialToken"]["id"]])

    def post(ids):
        out = []
        for part in template:
            out.extend(ids if part is None else part)
        return out
    return post


def _strip_token(token: str, content: str, start: int, stop: int) -> str:
    i = 0
    while i < min(start, len(token)) and token[i] == content:
        i += 1
    j = len(token)
    for _ in range(stop):
        if j > i and token[j - 1] == content:
            j -= 1
        else:
            break
    return token[i:j]


def build_decoder(node, where: str) -> Callable[[List[str]], List[str]]:
    """The decoder's ``decode_chain``: tokens in, strings out (joined by the
    caller)."""
    if node is None:
        return lambda tokens: [" ".join(tokens)]
    kind = node.get("type")
    if kind == "Sequence":
        steps = [build_decoder(n, where) for n in node["decoders"]]

        def run(tokens):
            for step in steps:
                tokens = step(tokens)
            return tokens
        return run
    if kind == "Metaspace":
        rep, scheme = node.get("replacement", "▁"), _metaspace_scheme(node)
        return lambda tokens: [
            t.replace(rep, "") if i == 0 and scheme != "never" else t.replace(rep, " ")
            for i, t in enumerate(tokens)]
    if kind == "Replace":
        pattern, content = _pattern(node, where), node["content"]
        return lambda tokens: [pattern.sub(lambda _: content, t) for t in tokens]
    if kind == "Strip":
        content, start, stop = node["content"], int(node["start"]), int(node["stop"])
        return lambda tokens: [_strip_token(t, content, start, stop) for t in tokens]
    if kind == "Fuse":
        return lambda tokens: ["".join(tokens)]
    if kind == "ByteLevel":
        return lambda tokens: [byte_level_decode(tokens)]
    raise _unsupported("decoder", node, where)


# ---------------------------------------------------------------- the pipeline
class AddedToken:
    def __init__(self, content: str, special: bool = False, normalized: Optional[bool] = None,
                 lstrip: bool = False, rstrip: bool = False, single_word: bool = False):
        self.content = content
        self.special = special
        self.normalized = (not special) if normalized is None else normalized
        self.lstrip, self.rstrip, self.single_word = lstrip, rstrip, single_word

    @classmethod
    def from_json(cls, node) -> "AddedToken":
        if isinstance(node, str):
            return cls(node)
        return cls(node["content"], bool(node.get("special", False)), node.get("normalized"),
                   bool(node.get("lstrip")), bool(node.get("rstrip")),
                   bool(node.get("single_word")))


def _word_char(ch: str) -> bool:
    return ch.isalnum() or ch == "_"


class Pipeline:
    """One HF ``Tokenizer``: encode, decode and the vocabulary."""

    def __init__(self, model, normalizer=None, pre_tokenizer=None, post_processor=None,
                 decoder=None, where: str = "tokenizer.json"):
        self.model = model
        self.normalize, self._strips_left = build_normalizer(normalizer, where)
        self.pre_tokenize = build_pre_tokenizer(pre_tokenizer, where)
        self.decode_chain = build_decoder(decoder, where)
        self.post_process = build_post_processor(post_processor, where)
        self.added: Dict[str, Tuple[int, AddedToken]] = {}
        self._matchers: Optional[Dict[bool, Optional["re.Pattern"]]] = None
        self._by_id: Optional[Dict[int, str]] = None

    @property
    def vocab_size(self) -> int:
        return len(self.model)

    def add_token(self, token: AddedToken, idx: Optional[int] = None):
        """Adds (or redefines) an added token: its id is the model's for a
        piece of the vocabulary, else ``idx``."""
        model_id = (self.model.ids.get(token.content) if isinstance(self.model, Unigram)
                    else self.model.vocab.get(token.content))
        if token.content in self.added:
            idx = self.added[token.content][0]
        elif model_id is not None:
            idx = model_id
        elif idx is None:
            raise ValueError(f"added token {token.content!r} has no id")
        self.added[token.content] = (idx, token)
        self._matchers = self._by_id = None

    def _matcher(self, normalized: bool) -> Optional["re.Pattern"]:
        """Leftmost-longest over the added tokens of one kind: at each
        position the longest content is tried first."""
        if self._matchers is None:
            self._matchers = {}
            for kind in (True, False):
                contents = sorted((c for c, (_, t) in self.added.items()
                                   if t.normalized == kind), key=len, reverse=True)
                self._matchers[kind] = (re.compile("|".join(map(re.escape, contents)))
                                        if contents else None)
        return self._matchers[normalized]

    def token_to_id(self, token: str) -> Optional[int]:
        if token in self.added:
            return self.added[token][0]
        if isinstance(self.model, Unigram):
            return self.model.ids.get(token)
        return self.model.vocab.get(token)

    def _split_added(self, text: str, normalized: bool):
        """HF's ``AddedVocabulary::find_matches``: (segment, added id or None,
        segment start) in order."""
        matcher = self._matcher(normalized)
        if matcher is None or not text:
            return [(text, None, 0)]
        out, pos = [], 0
        for m in matcher.finditer(text):
            idx, token = self.added[m.group()]
            begin, end = m.start(), m.end()
            if token.single_word and (
                    (begin > 0 and _word_char(text[begin - 1]))
                    or (end < len(text) and _word_char(text[end]))):
                continue
            if token.lstrip:
                while begin > pos and text[begin - 1] in WHITE_SPACE:
                    begin -= 1
            if token.rstrip:
                while end < len(text) and text[end] in WHITE_SPACE:
                    end += 1
            if pos < begin:
                out.append((text[pos:begin], None, pos))
            out.append((text[begin:end], idx, begin))
            pos = end
        if pos < len(text):
            out.append((text[pos:], None, pos))
        return out

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids: List[int] = []
        for segment, idx, start in self._split_added(text, normalized=False):
            if idx is not None:
                ids.append(idx)
                continue
            lead_removed = self._strips_left and segment[:1] in WHITE_SPACE
            norm = self.normalize(segment)
            for part, idx2, start2 in self._split_added(norm, normalized=True):
                if idx2 is not None:
                    ids.append(idx2)
                    continue
                piece = (part, start == 0 and start2 == 0, lead_removed and start2 == 0)
                for word, _, _ in self.pre_tokenize([piece]):
                    ids.extend(self.model.tokenize(word))
        return self.post_process(ids) if add_special_tokens else ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = False) -> str:
        """HF's ``Tokenizer::decode``: an added token's content or the
        model's piece per id (unknown ids dropped; with
        ``skip_special_tokens``, every special added token's content too),
        then the decoder over them all."""
        if self._by_id is None:
            self._by_id = {i: t.content for i, t in self.added.values()}
        special = {c for c, (_, t) in self.added.items() if t.special}
        tokens = []
        for i in ids:
            token = self._by_id.get(i)
            if token is None:
                token = self.model.id_to_token(int(i))
            if token is None or (skip_special_tokens and token in special):
                continue
            tokens.append(token)
        return "".join(self.decode_chain(tokens))


def read_tokenizer_json(path: str) -> Pipeline:
    """A ``tokenizer.json`` file as a pipeline with its added tokens."""
    where = os.path.basename(path)
    with open(path, encoding="utf-8") as f:
        node = json.load(f)
    pipeline = Pipeline(build_model(node["model"], where), node.get("normalizer"),
                        node.get("pre_tokenizer"), node.get("post_processor"),
                        node.get("decoder"), where)
    for added in node.get("added_tokens", []):
        pipeline.add_token(AddedToken.from_json(added), added["id"])
    return pipeline


# ------------------------------------------------------------------ directories
SPECIAL_KEYS = ("bos_token", "eos_token", "unk_token", "sep_token", "pad_token",
                "cls_token", "mask_token")
# The special tokens each tokenizer class takes when its files name none.
_CLASS_DEFAULTS = {
    "T5": {"eos_token": "</s>", "unk_token": "<unk>", "pad_token": "<pad>"},
    "GPT2": {"bos_token": "<|endoftext|>", "eos_token": "<|endoftext|>",
             "unk_token": "<|endoftext|>"},
}


def _content(value) -> Optional[str]:
    if isinstance(value, dict):
        return value.get("content")
    return value


def _read_json(path: str):
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as f:
        return json.load(f)


class HFDirectory:
    """A tokenizer directory as ``AutoTokenizer.from_pretrained`` builds it
    for ``T5TokenizerFast`` and ``GPT2TokenizerFast``: the pipeline, the
    special tokens and ``clean_up_tokenization_spaces``."""

    def __init__(self, path: str):
        config_path = os.path.join(path, "tokenizer_config.json")
        config = _read_json(config_path)
        cls = str(config.get("tokenizer_class") or "")
        tok_json = os.path.join(path, "tokenizer.json")
        if os.path.exists(tok_json):
            self.pipeline = read_tokenizer_json(tok_json)
            family = ("GPT2" if isinstance(self.pipeline.model, BPE) else "T5")
        elif os.path.exists(os.path.join(path, "vocab.json")) and os.path.exists(
                os.path.join(path, "merges.txt")):
            family = "GPT2"
            self.pipeline = self._from_vocab_merges(path, config)
        elif os.path.exists(os.path.join(path, "spiece.model")):
            raise ValueError(
                f"{path}: a SentencePiece directory (spiece.model) without tokenizer.json; "
                "the port reads tokenizer.json only (transformers would need "
                "sentencepiece to convert it)")
        else:
            raise ValueError(f"{path}: no tokenizer.json (nor vocab.json + merges.txt)")
        if cls and not cls.startswith(("T5Tokenizer", "GPT2Tokenizer")):
            raise ValueError(f"{config_path}: tokenizer_class {cls!r} is not supported by "
                             "the port's reader (T5Tokenizer, GPT2Tokenizer)")
        if family == "T5" and config.get("add_prefix_space") is not None:
            raise ValueError(f"{config_path}: add_prefix_space on a T5 tokenizer makes "
                             "transformers rebuild it from spiece.model")
        specials = dict(_CLASS_DEFAULTS[family])
        specials.update({k: _content(config[k]) for k in SPECIAL_KEYS if k in config})
        extra = [_content(t) for t in config.get("additional_special_tokens") or []]
        if "added_tokens_decoder" not in config:
            smap = _read_json(os.path.join(path, "special_tokens_map.json"))
            specials.update({k: _content(smap[k]) for k in SPECIAL_KEYS if k in smap})
            if smap.get("additional_special_tokens"):
                extra = [_content(t) for t in smap["additional_special_tokens"]]
        for idx, node in sorted(((int(k), v) for k, v in
                                 config.get("added_tokens_decoder", {}).items())):
            if node["content"] not in self.pipeline.added:
                self.pipeline.add_token(AddedToken.from_json(node), idx)
        named = [t for t in list(specials.values()) + extra if t is not None]
        for content in named:
            if content in self.pipeline.added:
                self.pipeline.added[content][1].special = True
            else:
                self.pipeline.add_token(AddedToken(content, special=True))
        self.specials = specials
        self.clean_up_tokenization_spaces = bool(config.get("clean_up_tokenization_spaces",
                                                            False))

    @staticmethod
    def _from_vocab_merges(path: str, config) -> Pipeline:
        """What ``GPT2Converter`` builds from ``GPT2Tokenizer``'s files."""
        vocab, merges = read_vocab_merges(path)
        bos = _content(config.get("bos_token", "<|endoftext|>"))
        post = None
        if config.get("add_bos_token", False):
            post = {"type": "TemplateProcessing",
                    "single": [{"SpecialToken": {"id": bos, "type_id": 0}},
                               {"Sequence": {"id": "A", "type_id": 0}}],
                    "special_tokens": {bos: {"id": bos, "ids": [vocab[bos]],
                                             "tokens": [bos]}}}
        return Pipeline(BPE(vocab, merges),
                        pre_tokenizer={"type": "ByteLevel", "use_regex": True,
                                       "add_prefix_space": bool(config.get("add_prefix_space",
                                                                           False))},
                        post_processor=post, decoder={"type": "ByteLevel"},
                        where="vocab.json")
