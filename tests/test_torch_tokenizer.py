"""The port's tokenizer reader (``mr_blip_tpu_torch/text/tokenizer_json.py``,
``bpe.py``, ``precompiled_charsmap.py`` under ``HFT5Tokenizer``) against
``transformers`` and ``tokenizers``, on the CPU.

The committed directories under ``tests/data/torch_tokenizer/`` (the JAX
package's fixture, a Flan-T5-shaped one with a precompiled charsmap, OPT's
byte-level BPE) must give ``ids.json``'s ids and decodes, which
``transformers`` wrote, and ``AutoTokenizer``'s on random strings; each file
must rebuild byte-equal (``tests/torch_tokenizer_fixtures.py``). Each node
type the reader takes is built with ``tokenizers`` and held against it, the
2022 form of a Flan-T5 ``tokenizer.json`` and a BPE ``tokenizer.json`` too;
unknown node types and a ``spiece.model``-only directory are refused.
``check_vocab`` derives the vocabulary facts of ``tests/test_real_vocab.py``;
set ``MRBLIP_TOKENIZER_PATH=<a Flan-T5 directory>`` to run it, and the
comparison with ``transformers``, on a real vocabulary.

Known differences (``ROADMAP.md`` Queue 3): the charsmap's grapheme clusters
are approximated; ``test_precompiled_known_differences`` holds the two cases
found (an emoji ZWJ sequence, a prepended mark).
"""

import base64
import json
import os
import random
from pathlib import Path

import pytest
from tokenizers import AddedToken, Regex, Tokenizer, decoders, normalizers, pre_tokenizers
from transformers import AutoTokenizer

from mr_blip_tpu_torch.text import tokenizer_json
from mr_blip_tpu_torch.text.precompiled_charsmap import PrecompiledCharsMap
from mr_blip_tpu_torch.text.tokenizer import HFT5Tokenizer, MockT5Tokenizer, load_tokenizer
from mr_blip_tpu_torch.text.vocab_facts import check_vocab
from tests import torch_tokenizer_fixtures as fixtures

DATA = Path(fixtures.DATA)
GOLDEN = json.loads((DATA / "ids.json").read_text(encoding="utf-8"))
REAL_TOKENIZER = os.environ.get("MRBLIP_TOKENIZER_PATH")
FUZZ_ALPHABET = (list("abcxyz AEIOU0123456789 .,:?!'[]<>/\n\t\r") + [
    "<extra_id_0>", "</s>", "<pad>", "  ", "　", "Ａ", "ａ", "１",
    "é", "́", "é", "‍", "\U0001F469", "中", "§", "'s",
    "'ll", "\x1c", " ", "\u0085", "ｶﾞ", "\U0001F44D\U0001F3FD", "क्"])


def _assert_same(port, hf, texts):
    for text in texts:
        for add in (True, False):
            assert port.encode(text, add_special_tokens=add) == hf.encode(
                text, add_special_tokens=add), (text, add)
        ids = hf.encode(text)
        for skip in (False, True):
            assert port.decode(ids, skip_special_tokens=skip) == hf.decode(
                ids, skip_special_tokens=skip), (text, skip)


def _fuzz(seed, n=400):
    rng = random.Random(seed)
    return ["".join(rng.choice(FUZZ_ALPHABET) for _ in range(rng.randrange(0, 14)))
            for _ in range(n)]


# ----------------------------------------------------- committed directories
@pytest.mark.parametrize("name", fixtures.DIRS)
def test_goldens(name):
    tok, want = HFT5Tokenizer(str(DATA / name)), GOLDEN[name]
    assert (tok.vocab_size, tok.pad_token_id, tok.eos_token_id, tok.unk_token_id) == (
        want["vocab_size"], want["pad_token_id"], want["eos_token_id"],
        want["unk_token_id"])
    assert [c["text"] for c in want["cases"]] == fixtures.GOLDEN_STRINGS
    for case in want["cases"]:
        text = case["text"]
        assert tok.encode(text) == case["ids"], text
        assert tok.encode(text, add_special_tokens=False) == case["ids_plain"], text
        assert tok.decode(case["ids"]) == case["decode"], text
        assert tok.decode(case["ids"], skip_special_tokens=True) == case["decode_skip"], text


@pytest.mark.parametrize("name", fixtures.DIRS)
def test_random_strings_and_ids_equal_transformers(name):
    path = str(DATA / name)
    port, hf = HFT5Tokenizer(path), AutoTokenizer.from_pretrained(path, local_files_only=True)
    _assert_same(port, hf, _fuzz(fixtures.DIRS.index(name)))
    rng = random.Random(1)
    for _ in range(200):
        ids = [rng.randrange(hf.vocab_size + 3) for _ in range(rng.randrange(1, 12))]
        for skip in (False, True):
            assert port.decode(ids, skip) == hf.decode(ids, skip_special_tokens=skip), ids
    for token in ("▁", "<extra_id_0>", "A", "▁A", "zzz", "</s>", ">", "<pad>", "Ġ"):
        assert port.convert_tokens_to_ids(token) == hf.convert_tokens_to_ids(token), token


def test_call_and_batch_decode_follow_the_base_class():
    """``__call__`` (padding, truncation, ``padding_side``) and
    ``batch_decode`` are ``TokenizerBase``'s over ``encode``/``decode``, as
    in the JAX package's ``HFT5Tokenizer``."""
    tok = HFT5Tokenizer(str(DATA / "flan_t5"))
    texts = ["[[10, 25]]", "Query: a cat jumps", ""]
    enc = tok(texts, padding="longest", add_special_tokens=True)
    for row, mask, text in zip(enc.input_ids, enc.attention_mask, texts):
        ids = tok.encode(text)
        assert list(row[:len(ids)]) == ids and mask.sum() == len(ids)
        assert set(row[len(ids):]) <= {tok.pad_token_id}
    left = tok(texts, padding="max_length", max_length=4, truncation=True,
               padding_side="left")
    assert left.input_ids.shape == (3, 4)
    assert list(left.input_ids[2]) == [0, 0, 0, 1] and list(left.attention_mask[2]) == [0, 0, 0, 1]
    assert tok.batch_decode(enc.input_ids, skip_special_tokens=True) == [
        tok.decode(r, skip_special_tokens=True) for r in enc.input_ids]


@pytest.fixture(scope="module")
def rebuilt(tmp_path_factory):
    return Path(fixtures.build_all(str(tmp_path_factory.mktemp("torch_tokenizer"))))


@pytest.mark.parametrize("name", list(fixtures.DIRS) + ["ids.json"])
def test_committed_files_rebuild_byte_equal(rebuilt, name):
    files = ([Path(name)] if name.endswith(".json") else
             sorted(p.relative_to(DATA) for p in (DATA / name).iterdir()))
    assert files
    for rel in files:
        assert (rebuilt / rel).read_bytes() == (DATA / rel).read_bytes(), rel


def test_load_tokenizer_rules(tmp_path):
    assert isinstance(load_tokenizer(None), MockT5Tokenizer)
    assert isinstance(load_tokenizer("mock"), MockT5Tokenizer)
    assert isinstance(load_tokenizer("none"), MockT5Tokenizer)
    assert isinstance(load_tokenizer(str(tmp_path / "missing")), MockT5Tokenizer)
    assert isinstance(load_tokenizer(str(DATA / "opt_bpe")), HFT5Tokenizer)


# ----------------------------------------------------------- other T5 forms
def test_flan_t5_2022_form(tmp_path):
    """The 2022 Flan-T5 files: ``Precompiled`` alone, ``WhitespaceSplit`` then
    the legacy ``Metaspace(add_prefix_space)``, the legacy decoder."""
    node = json.loads((DATA / "flan_t5" / "tokenizer.json").read_text(encoding="utf-8"))
    node["normalizer"] = node["normalizer"]["normalizers"][0]
    assert node["normalizer"]["type"] == "Precompiled"
    node["pre_tokenizer"] = {"type": "Sequence", "pretokenizers": [
        {"type": "WhitespaceSplit"},
        {"type": "Metaspace", "replacement": "▁", "add_prefix_space": True}]}
    node["decoder"] = {"type": "Metaspace", "replacement": "▁", "add_prefix_space": True}
    for f in ("tokenizer_config.json", "special_tokens_map.json"):
        (tmp_path / f).write_bytes((DATA / "flan_t5" / f).read_bytes())
    (tmp_path / "tokenizer.json").write_text(json.dumps(node), encoding="utf-8")
    hf = AutoTokenizer.from_pretrained(str(tmp_path), local_files_only=True)
    _assert_same(HFT5Tokenizer(str(tmp_path)), hf, fixtures.GOLDEN_STRINGS + _fuzz(7, 200))


@pytest.mark.parametrize("form", ["clean_up", "config_2022"])
def test_tokenizer_config_forms(tmp_path, form):
    """``clean_up_tokenization_spaces: true``, and a 2022 ``tokenizer_config``
    (no ``added_tokens_decoder``: ``special_tokens_map.json`` names the
    special tokens), read as ``transformers`` reads them."""
    for f in (DATA / "fixture_t5").iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    config = json.loads((tmp_path / "tokenizer_config.json").read_text(encoding="utf-8"))
    if form == "clean_up":
        config["clean_up_tokenization_spaces"] = True
    else:
        config = {"eos_token": "</s>", "unk_token": "<unk>", "pad_token": "<pad>",
                  "extra_ids": 100, "model_max_length": 512,
                  "tokenizer_class": "T5Tokenizer"}
    (tmp_path / "tokenizer_config.json").write_text(json.dumps(config), encoding="utf-8")
    hf = AutoTokenizer.from_pretrained(str(tmp_path), local_files_only=True)
    port = HFT5Tokenizer(str(tmp_path))
    assert (port.pad_token_id, port.eos_token_id, port.unk_token_id, port.vocab_size) == (
        hf.pad_token_id, hf.eos_token_id, hf.unk_token_id, hf.vocab_size)
    _assert_same(port, hf, fixtures.GOLDEN_STRINGS + ["a . b , c ? it 's", "x ! don 't"])


def test_bpe_tokenizer_json(tmp_path):
    """OPT's vocabulary as a ``tokenizer.json`` (``BPE``, ``ByteLevel``
    pre-tokenizer and decoder, the BOS template) reads as the
    ``vocab.json`` + ``merges.txt`` route does."""
    hf = AutoTokenizer.from_pretrained(str(DATA / "opt_bpe"), local_files_only=True)
    hf.save_pretrained(str(tmp_path))
    assert (tmp_path / "tokenizer.json").exists()
    node = json.loads((tmp_path / "tokenizer.json").read_text(encoding="utf-8"))
    assert node["model"]["type"] == "BPE" and node["pre_tokenizer"]["type"] == "ByteLevel"
    port = HFT5Tokenizer(str(tmp_path))
    assert port.vocab_size == hf.vocab_size and port.pad_token_id == 1
    _assert_same(port, hf, fixtures.GOLDEN_STRINGS + _fuzz(3, 200))


def test_real_or_committed_flan_t5_vocab_facts():
    """``check_vocab`` on a real Flan-T5 directory when
    ``MRBLIP_TOKENIZER_PATH`` names one, else on the committed Flan-T5-shaped
    one; the port's ids equal ``transformers``' there."""
    path = REAL_TOKENIZER or str(DATA / "flan_t5")
    port = HFT5Tokenizer(path)
    facts = check_vocab(port)
    assert facts["failures"] == []
    if not REAL_TOKENIZER:
        assert facts["annoying"] == sorted(fixtures.FLAN_ANNOYING_NONSPACE)
        assert facts["annoying_space"] == sorted(fixtures.FLAN_ANNOYING_SPACE)
        assert facts["vocab_size"] == 32100 and facts["extra_ids"] == [32099, 32098, 32000]
    _assert_same(port, AutoTokenizer.from_pretrained(path, local_files_only=True),
                 fixtures.GOLDEN_STRINGS)


def test_check_vocab_fixture_and_failures():
    """The JAX fixture's crafted sets; the mock fails the reference's ids."""
    facts = check_vocab(HFT5Tokenizer(str(DATA / "fixture_t5")))
    assert facts["failures"] == []
    assert facts["annoying"] == [123, 124, 149] and facts["annoying_space"] == [87, 113, 157]
    assert facts["answer_ids"] == [71, 272, 205, 309, 262]
    assert all(abs(r - n) <= 2 for n, r in facts["replacement"].items())
    bad = check_vocab(MockT5Tokenizer())["failures"]
    assert any(line.startswith("answer ids") for line in bad)
    assert check_vocab(HFT5Tokenizer(str(DATA / "opt_bpe")))["failures"]


# ---------------------------------------------------------------- node types
def _charsmap_rules():
    return dict(fixtures.CHARSMAP_RULES, **{"x": "Y", "xy": "Z", "ｶ": "カ",
                                             "ｶﾞ": "ガ"})


def test_precompiled_equals_tokenizers():
    blob = fixtures.build_charsmap(_charsmap_rules())
    port, hf = PrecompiledCharsMap(blob), normalizers.Precompiled(blob)
    texts = [c["text"] for c in GOLDEN["flan_t5"]["cases"]] + _fuzz(11, 600) + [
        "xy", "xyz", "ｶﾞ", "Ａ́", "Ａ́́", "a\r\nb",
        "é́"]
    for text in texts:
        assert port(text) == hf.normalize_str(text), ascii(text)


def test_precompiled_known_differences():
    """Where the grapheme approximation differs from ``tokenizers``: HF takes
    "©" ZWJ "©" as one 7-byte cluster (each character alone); the port cuts
    it after the joiner, looks the 5-byte "©" ZWJ up whole and drops the
    joiner. HF joins the prepended U+0600 to the digit after it and drops
    the digit; the port keeps it."""
    blob = fixtures.build_charsmap({"\u00a9": "(c)", "\u0600": "#"})
    port, hf = PrecompiledCharsMap(blob), normalizers.Precompiled(blob)
    assert (port("\u00a9\u200d\u00a9"), hf.normalize_str("\u00a9\u200d\u00a9")) == (
        "(c)(c)", "(c)\u200d(c)")
    assert (port("\u06001"), hf.normalize_str("\u06001")) == ("#1", "#")


def _base_tokenizer():
    return Tokenizer.from_file(str(DATA / "fixture_t5" / "tokenizer.json"))


def _metaspace(scheme, split):
    return pre_tokenizers.Metaspace(replacement="▁", prepend_scheme=scheme, split=split)


NORMALIZERS = {
    "none": None,
    "replace_string": normalizers.Replace("a", "b"),
    "replace_regex": normalizers.Replace(Regex(" {2,}"), "▁"),
    "strip_left": normalizers.Strip(left=True, right=False),
    "strip_right": normalizers.Strip(left=False, right=True),
    "strip_both": normalizers.Strip(),
    "nfc": normalizers.NFC(),
    "nfkc": normalizers.NFKC(),
    "sequence": normalizers.Sequence([normalizers.NFKC(), normalizers.Replace("1", "2"),
                                      normalizers.Strip(left=False, right=True)]),
    "precompiled": normalizers.Precompiled(fixtures.build_charsmap(_charsmap_rules())),
}
PRE_TOKENIZERS = {
    **{f"metaspace_{s}_{'split' if sp else 'whole'}": _metaspace(s, sp)
       for s in ("always", "first", "never") for sp in (True, False)},
    "whitespace_split": pre_tokenizers.WhitespaceSplit(),
    "sequence": pre_tokenizers.Sequence([pre_tokenizers.WhitespaceSplit(),
                                         _metaspace("first", True)]),
}
DECODERS = {
    "metaspace_never": decoders.Metaspace(replacement="▁", prepend_scheme="never"),
    "metaspace_first": decoders.Metaspace(replacement="▁", prepend_scheme="first"),
    "replace": decoders.Replace("▁", " "),
    "strip": decoders.Strip(content="▁", left=1, right=0),
    "fuse": decoders.Fuse(),
    "sequence": decoders.Sequence([decoders.Replace("▁", " "), decoders.Fuse(),
                                   decoders.Strip(content=" ", left=1, right=0)]),
    "none": None,
}
NODE_TEXTS = (list(fixtures.GOLDEN_STRINGS) + ["  two  lead", "a b ", "x  ", "ab aab 11",
                                               "Ａ１ é"] + _fuzz(5, 150))


def _hold(tmp_path, hf_tok):
    path = tmp_path / "tokenizer.json"
    hf_tok.save(str(path))
    port = tokenizer_json.read_tokenizer_json(str(path))
    for text in NODE_TEXTS:
        for add in (True, False):
            want = hf_tok.encode(text, add_special_tokens=add).ids
            assert port.encode(text, add_special_tokens=add) == want, (ascii(text), add)
        for skip in (False, True):
            assert port.decode(want, skip) == hf_tok.decode(want, skip_special_tokens=skip), (
                ascii(text), skip)


@pytest.mark.parametrize("name", list(NORMALIZERS))
def test_normalizer_node(tmp_path, name):
    tok = _base_tokenizer()
    tok.normalizer = NORMALIZERS[name]
    _hold(tmp_path, tok)


@pytest.mark.parametrize("name", list(PRE_TOKENIZERS))
def test_pre_tokenizer_node(tmp_path, name):
    tok = _base_tokenizer()
    tok.normalizer = normalizers.Strip(left=True, right=False)
    tok.pre_tokenizer = PRE_TOKENIZERS[name]
    _hold(tmp_path, tok)


@pytest.mark.parametrize("name", list(DECODERS))
def test_decoder_node(tmp_path, name):
    tok = _base_tokenizer()
    tok.decoder = DECODERS[name]
    _hold(tmp_path, tok)


@pytest.mark.parametrize("flags", [dict(lstrip=True), dict(rstrip=True),
                                   dict(single_word=True), dict(normalized=True),
                                   dict(lstrip=True, rstrip=True, special=False)])
def test_added_token_flags(tmp_path, flags):
    tok = _base_tokenizer()
    tok.normalizer = normalizers.Replace("q", "<vid>")
    tok.add_tokens([AddedToken("<vid>", **{"special": True, "normalized": False, **flags}),
                    AddedToken("ab", **flags)])
    _hold(tmp_path, tok)
    texts = ["x <vid> y", "x<vid>y", "q <vid>q", " ab  abc ab", "<vid>"]
    port = tokenizer_json.read_tokenizer_json(str(tmp_path / "tokenizer.json"))
    for text in texts:
        assert port.encode(text) == tok.encode(text).ids, (text, flags)


# ------------------------------------------------------------------ refusals
@pytest.mark.parametrize("part,node", [
    ("normalizer", {"type": "Lowercase"}),
    ("pre_tokenizer", {"type": "BertPreTokenizer"}),
    ("decoder", {"type": "WordPiece", "prefix": "##", "cleanup": True}),
    ("post_processor", {"type": "RobertaProcessing", "sep": ["</s>", 2], "cls": ["<s>", 0]}),
    ("model", {"type": "WordPiece", "vocab": {"a": 0}, "unk_token": "a"}),
])
def test_unknown_node_types_raise(tmp_path, part, node):
    tree = json.loads((DATA / "fixture_t5" / "tokenizer.json").read_text(encoding="utf-8"))
    tree[part] = node
    (tmp_path / "tokenizer.json").write_text(json.dumps(tree), encoding="utf-8")
    with pytest.raises(ValueError, match=rf"tokenizer\.json: .*'{node['type']}'"):
        HFT5Tokenizer(str(tmp_path))


def test_byte_fallback_and_spiece_only_raise(tmp_path):
    tree = json.loads((DATA / "fixture_t5" / "tokenizer.json").read_text(encoding="utf-8"))
    tree["model"]["byte_fallback"] = True
    (tmp_path / "tokenizer.json").write_text(json.dumps(tree), encoding="utf-8")
    with pytest.raises(ValueError, match="byte_fallback"):
        HFT5Tokenizer(str(tmp_path))
    spm = tmp_path / "spm"
    spm.mkdir()
    (spm / "spiece.model").write_bytes(b"\x00")
    with pytest.raises(ValueError, match="tokenizer.json"):
        HFT5Tokenizer(str(spm))


def test_charsmap_blob_round_trip():
    """A ``precompiled_charsmap`` as ``tokenizer.json`` holds it (base64)."""
    node = json.loads((DATA / "flan_t5" / "tokenizer.json").read_text(encoding="utf-8"))
    blob = base64.b64decode(node["normalizer"]["normalizers"][0]["precompiled_charsmap"])
    assert blob == fixtures.build_charsmap(fixtures.CHARSMAP_RULES)
    assert PrecompiledCharsMap(blob)("Ａｂｃ　１") == "Abc 1"
