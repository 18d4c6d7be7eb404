"""Builds the tokenizer directories and goldens under
``tests/data/torch_tokenizer/`` (test tooling: needs ``tokenizers`` and
``transformers``, which the port itself never imports).

    python -m tests.torch_tokenizer_fixtures [out_dir]

* ``fixture_t5/``: the JAX package's ``build_fixture_tokenizer`` (Unigram,
  1,280 pieces, no normalizer).
* ``flan_t5/``: a Flan-T5-shaped directory as today's ``SpmConverter``
  writes it: ``Precompiled`` (a hand-built charsmap: full-width letters and
  digits, no-break and ideographic spaces, control whitespace, one
  combining-mark composition), ``Strip(right)``, ``Replace(" {2,}", "▁")``;
  32,100 pieces with ``<extra_id_k>`` at 32,099 - k and the answer letters
  at 71 / 272 / 205 / 309 / 262.
* ``opt_bpe/``: a GPT-2 byte-level BPE ``vocab.json`` + ``merges.txt``
  trained here on the prompts' words and digits, saved by ``GPT2Tokenizer``
  with OPT's special tokens (``<pad>`` 1, ``</s>`` 2 as BOS and EOS,
  ``<unk>`` 3) and ``add_bos_token``.
* ``ids.json``: what ``transformers`` gives for ``GOLDEN_STRINGS`` on each:
  the ids with and without special tokens and both decodes.

Every build is deterministic: ``tests/test_torch_tokenizer.py`` rebuilds
each file and requires it byte-equal to the committed copy.
"""

from __future__ import annotations

import itertools
import json
import os
import string
import struct
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data", "torch_tokenizer")
DIRS = ("fixture_t5", "flan_t5", "opt_bpe")

FLAN_VOCAB = 32100
ANSWER_IDS = {"A": 71, "B": 272, "C": 205, "D": 309, "E": 262}
FLAN_ANNOYING_SPACE = (59, 142, 171)
FLAN_ANNOYING_NONSPACE = (97, 131, 188)

# Full-width forms, spaces, control whitespace and one composition.
CHARSMAP_RULES = {
    **{chr(0xFF01 + i): chr(0x21 + i) for i in range(94)},  # ！..～ -> !..~
    " ": " ", "　": " ", "\t": " ", "\n": " ", "\r": " ",
    "é": "é",
}

_WORDS = (
    "Query Given the video and query find relevant windows Relevant Option "
    "Question Answer a is person doing something interesting of to in on "
    "Considering information presented frame select correct answer from "
    "options duration seconds cat jumps someone opens door yes no what who "
    "where when why how this that it not Is frame relevant"
).split()


def build_charsmap(rules) -> bytes:
    """A SentencePiece ``precompiled_charsmap``: the u32 trie size, a
    darts-clone double array (XOR addressing) of the UTF-8 keys, then the
    NUL-terminated replacements."""
    normalized = b""
    root: dict = {}
    for key, value in sorted((k.encode(), v.encode()) for k, v in rules.items()):
        node = root
        for byte in key:
            node = node.setdefault(byte, {})
        node[None] = len(normalized)
        normalized += value + b"\0"
    units = {0: 0}
    used, bases = {0}, set()
    queue = [(0, root)]
    while queue:
        pos, node = queue.pop(0)
        labels = [0 if k is None else k for k in node]
        base = 1
        while base in bases or base == pos or any(base ^ lab in used for lab in labels):
            base += 1
        bases.add(base)
        units[pos] |= (pos ^ base) << 10
        for key in sorted(node, key=lambda k: -1 if k is None else k):
            child = base ^ (0 if key is None else key)
            used.add(child)
            if key is None:
                units[child] = node[None] | (1 << 31)
            else:
                units[child] = key | ((1 << 8) if None in node[key] else 0)
                queue.append((child, node[key]))
    size = (max(max(units), max(bases)) | 0xFF) + 1
    trie = struct.pack(f"<{size}I", *(units.get(i, 0) for i in range(size)))
    return struct.pack("<I", len(trie)) + trie + normalized


def _flan_piece_table():
    pieces: list = [None] * FLAN_VOCAB
    taken = set()

    def put(idx, piece, score):
        assert pieces[idx] is None and piece not in taken, (idx, piece)
        pieces[idx] = (piece, score)
        taken.add(piece)

    for idx, piece in enumerate(("<pad>", "</s>", "<unk>")):
        put(idx, piece, 0.0)
    put(3, "▁", -2.0)
    for letter, idx in ANSWER_IDS.items():
        put(idx, "▁" + letter, -5.0)
    for k in range(100):
        put(FLAN_VOCAB - 1 - k, f"<extra_id_{k}>", 0.0)
    annoying = set(FLAN_ANNOYING_SPACE) | set(FLAN_ANNOYING_NONSPACE)
    pool = [(d, -3.0) for d in string.digits]
    pool += [("▁" + str(n), -2.5) for n in range(1000) if n not in annoying]
    pool += [(str(n), -1.0) for n in FLAN_ANNOYING_SPACE]
    pool += [(str(n)[1:], -1.5) for n in FLAN_ANNOYING_NONSPACE]
    for p in ["[", "]", "[[", "]]", ",", ".", ":", ">", "?", "(", ")", "-", "!", "'",
              "<", "/", "é", "ï", "ü", "ö", "★"]:
        pool += [(p, -6.0), ("▁" + p, -6.0)]
    for w in _WORDS:
        pool += [("▁" + w, -5.0), (w, -7.0)]
    for c in string.ascii_letters:
        pool += [(c, -9.0), ("▁" + c, -9.5)]
    lower = string.ascii_lowercase
    for k, pair in enumerate(itertools.product(lower, repeat=2)):
        pool += [("".join(pair), -9.6 - 0.01 * (k % 7)), ("▁" + "".join(pair), -9.7)]
    triples = ["".join(t) for t in itertools.product(lower, repeat=3)]
    pool += [(t, -10.0 - 0.01 * (k % 11)) for k, t in enumerate(triples)]
    pool += [("▁" + t, -10.5 - 0.01 * (k % 13)) for k, t in enumerate(triples)]
    free = iter(i for i, p in enumerate(pieces) if p is None)
    for piece, score in pool:
        if piece in taken:
            continue
        idx = next(free, None)
        if idx is None:
            break
        put(idx, piece, score)
    assert all(p is not None for p in pieces)
    return pieces


def _save_t5(tok, out_dir):
    from tokenizers import AddedToken
    from transformers import T5TokenizerFast

    extra = [AddedToken(f"<extra_id_{k}>", special=True, normalized=False)
             for k in range(100)]
    hf_tok = T5TokenizerFast(tokenizer_object=tok, unk_token="<unk>", eos_token="</s>",
                             pad_token="<pad>", extra_ids=0,
                             additional_special_tokens=extra)
    os.makedirs(out_dir, exist_ok=True)
    hf_tok.save_pretrained(out_dir)


def build_flan_t5(out_dir: str) -> str:
    from tokenizers import Regex, Tokenizer, decoders, normalizers, pre_tokenizers, processors
    from tokenizers.models import Unigram

    tok = Tokenizer(Unigram(_flan_piece_table(), unk_id=2, byte_fallback=False))
    tok.normalizer = normalizers.Sequence([
        normalizers.Precompiled(build_charsmap(CHARSMAP_RULES)),
        normalizers.Strip(left=False, right=True),
        normalizers.Replace(Regex(" {2,}"), "▁"),
    ])
    tok.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁", prepend_scheme="always")
    tok.decoder = decoders.Metaspace(replacement="▁", prepend_scheme="always")
    tok.post_processor = processors.TemplateProcessing(
        single=["$A", "</s>"], pair=["$A", "</s>", "$B", "</s>"],
        special_tokens=[("</s>", 1)])
    _save_t5(tok, out_dir)
    return out_dir


def _bpe_corpus():
    from mr_blip_tpu_torch.text.timestamps import format_timestamps

    lines = [" ".join(_WORDS), " ".join(w.lower() for w in _WORDS)]
    lines += [" ".join(str(n) for n in range(k, 1000, 7)) for k in range(7)]
    stamps = format_timestamps("seconds_integers", [np.linspace(0, 150, 60, endpoint=False)],
                               [150.0])[2][0]
    lines += [stamps, "[[10, 25]] [[0, 150]] [[3, 7], [80, 99]]",
              "Given the video and the query, find the relevant windows.",
              "Relevant windows: Query: a person is doing something"]
    return lines * 3


def build_opt_bpe(out_dir: str) -> str:
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers
    from transformers import GPT2Tokenizer

    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    trainer = trainers.BpeTrainer(vocab_size=700, min_frequency=2, show_progress=False,
                                  special_tokens=["<s>", "<pad>", "</s>", "<unk>"],
                                  initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    tok.train_from_iterator(_bpe_corpus(), trainer)
    os.makedirs(out_dir, exist_ok=True)
    tok.model.save(out_dir)
    hf_tok = GPT2Tokenizer(os.path.join(out_dir, "vocab.json"),
                           os.path.join(out_dir, "merges.txt"),
                           unk_token="<unk>", bos_token="</s>", eos_token="</s>",
                           pad_token="<pad>", add_bos_token=True, add_prefix_space=False)
    hf_tok.save_pretrained(out_dir)
    return out_dir


def build_fixture_t5(out_dir: str) -> str:
    from mr_blip_tpu.text.fixture_tokenizer import build_fixture_tokenizer

    return build_fixture_tokenizer(out_dir)


MAKE_DIR = {"fixture_t5": build_fixture_t5, "flan_t5": build_flan_t5,
            "opt_bpe": build_opt_bpe}


def _video_prompt(frames: int, duration: float) -> str:
    from mr_blip_tpu_torch.text.timestamps import format_timestamps

    return format_timestamps("seconds_integers",
                             [np.linspace(0, duration, frames, endpoint=False)],
                             [duration])[2][0]


GOLDEN_STRINGS = [
    "", " ", "A", "B", "C", "D", "E", "yes", "no", "<extra_id_0>", "<extra_id_0>\n",
    "<vid>", "</s>", "[[10, 25]]", "[[0, 150]]", "[[3, 7], [80, 99]]",
    "[[10, 25]]</s>", "Query: a person is doing something\n",
    "Given the video and the query, find the relevant windows.\nRelevant windows: ",
    _video_prompt(60, 150.0), _video_prompt(60, 200.0),
    " ".join(str(n) for n in (59, 87, 97, 113, 123, 124, 131, 142, 149, 157, 171, 188)),
    "a  b", "two  spaces  and   three", "trailing  ", "  leading", "tab\tand\nnewline",
    "Ｆｕｌｌ ｗｉｄｔｈ １２３", "no break　space", "café é",
    "Ａ́ x", "café naïve ★", "<extra_id_0> hello <extra_id_1>", "x<extra_id_99>y<pad>",
    "it's don't I'm we've they'll", "Question: what is it?\nOption A: a cat.\nOption B: a door.",
    "12345678901234567890", "unknown §¶ 中文 chars",
]


def golden_record(directory: str):
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(directory, local_files_only=True)
    cases = []
    for text in GOLDEN_STRINGS:
        ids = tok.encode(text)
        cases.append({"text": text, "ids": ids,
                      "ids_plain": tok.encode(text, add_special_tokens=False),
                      "decode": tok.decode(ids),
                      "decode_skip": tok.decode(ids, skip_special_tokens=True)})
    return {"vocab_size": tok.vocab_size, "pad_token_id": tok.pad_token_id,
            "eos_token_id": tok.eos_token_id, "unk_token_id": tok.unk_token_id,
            "cases": cases}


def build_all(out_dir: str = DATA) -> str:
    goldens = {}
    for name in DIRS:
        path = MAKE_DIR[name](os.path.join(out_dir, name))
        goldens[name] = golden_record(path)
    with open(os.path.join(out_dir, "ids.json"), "w", encoding="utf-8") as f:
        json.dump(goldens, f, ensure_ascii=False, indent=1)
        f.write("\n")
    return out_dir


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(HERE))
    print(build_all(sys.argv[1] if len(sys.argv) > 1 else DATA))
