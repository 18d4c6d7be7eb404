"""The port's models under real vocabularies against the JAX package's, on
the CPU.

``tests/test_real_vocab.py::TestModelUnderRealVocab`` holds the JAX model
under the fixture T5 tokenizer; here the port's ``BLIP2_MR``, ``blip2_fmr``
and OPT variant run under the committed directories of
``tests/data/torch_tokenizer/`` (read by the port's own reader; the JAX
package reads them with ``transformers``), on the same weights
(``init_params_fast``'s tree redrawn from a numpy seed, converted by
``state_dict_from_jax``), tiny and in fp32: the same derived answer ids,
annoying-number remap and padded vocabulary, losses and the
``videoQA_generate`` A-E logits within 1e-4, spans identical.

The tiny OPT's 256-row vocabulary is smaller than any byte-level BPE
vocabulary (256 byte symbols and the specials): the JAX package's embedding
then reads NaN for ids past it and the port's raises ``IndexError``
(``test_tiny_opt_vocab_under_bpe``; ROADMAP Queue 3). The OPT comparison
widens the tiny vocabulary to 768 rows on both sides.
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

import mr_blip_tpu  # noqa: F401
from mr_blip_tpu.models import opt as jopt
from mr_blip_tpu.models.blip2_fmr import Blip2FMR as JaxFMR
from mr_blip_tpu.models.blip2_mr import BLIP2_MR as JaxBLIP2_MR
from mr_blip_tpu.models.blip2_mr_opt import BLIP2_MR_OPT as JaxOPT
from mr_blip_tpu_torch.models import opt as topt
from mr_blip_tpu_torch.models.blip2_fmr import Blip2FMR
from mr_blip_tpu_torch.models.blip2_mr import BLIP2_MR
from mr_blip_tpu_torch.models.blip2_mr_opt import BLIP2_MR_OPT
from mr_blip_tpu_torch.models.convert import state_dict_from_jax
from mr_blip_tpu_torch.text.span_grammar import moment_str_to_list
from mr_blip_tpu_torch.text.tokenizer import HFT5Tokenizer

DATA = Path(__file__).resolve().parent / "data" / "torch_tokenizer"
T5_DIRS = ("fixture_t5", "flan_t5")
TINY = dict(img_size=28, vit_model="tiny", t5_model="tiny", num_beams=2,
            max_new_tokens=8, compute_dtype="float32")
QA_TASK = "lora_QA_with_localizer"


def _redraw(tree, seed):
    """Every leaf (or leaf shape) of ``tree`` drawn from a numpy seed."""
    rng = np.random.default_rng(seed)
    flat = traverse_util.flatten_dict(tree)
    for key, leaf in flat.items():
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        flat[key] = 1.0 + 0.1 * noise if key[-1] == "scale" else 0.3 * noise
    return traverse_util.unflatten_dict(flat)


@functools.lru_cache(maxsize=None)
def _params(name, task="lora"):
    jm = JaxBLIP2_MR(**TINY, task=task, tokenizer_path=str(DATA / name),
                     init_params=False, scan_layers=False)
    return _redraw(jm.init_params_fast(jax.random.PRNGKey(0), dtype=jnp.float32), 23)


def _pair(name, task="lora", jax_cls=JaxBLIP2_MR, port_cls=BLIP2_MR, answerer=False):
    path = str(DATA / name)
    params = _params(name)
    jm = jax_cls(**TINY, task=task, tokenizer_path=path, init_params=False,
                 scan_layers=False)
    jm.params = jax.tree.map(jnp.asarray, params)
    pm = port_cls(**TINY, task=task, tokenizer_path=path, init_params=False, device="cpu")
    if answerer:
        jm.answerer_params = jax.tree.map(jnp.asarray, _redraw(params, 24))
        pm.load_state_dict(state_dict_from_jax(params, jax.tree.map(
            np.asarray, jm.answerer_params)), strict=True)
    else:
        pm.load_state_dict(state_dict_from_jax(params), strict=True)
    return jm, pm


def _samples(b=2, t=6, seed=0):
    rng = np.random.default_rng(seed)
    duration = [124.0, 171.0][:b]
    options = ("Option A: a cat. Option B: a dog. Option C: a bird. "
               "Option D: a fish. Option E: a horse.")
    return {
        "video": rng.integers(0, 256, (b, t, 28, 28, 3), dtype=np.uint8),
        "timestamps": np.stack([np.linspace(0, d, t, endpoint=False) for d in duration]),
        "duration": np.array(duration),
        "query_id": [f"q{i}" for i in range(b)],
        "question_id": [f"q{i}" for i in range(b)],
        "video_prompt_end": ["<extra_id_0>"] * b,
        "query_prompt": ["Query: a cat jumps\n", "Query: someone opens a door\n"][:b],
        "task_prompt": ["Given the video and the query, find the relevant "
                        "windows.\nRelevant windows: "] * b,
        "relevant_windows": ["[[0, 10]]", "[[4, 12], [20, 30]]"][:b],
        "qa_input": [f"Question: what jumps? {options} Answer: "] * b,
        "qa_output": ["A", "C"][:b],
        "loc_input": ["Question: a cat jumps? Is this frame relevant?",
                      "Question: someone opens a door?"][:b],
    }


@pytest.mark.parametrize("name", T5_DIRS)
def test_derived_vocabulary_equals_jax(name):
    """Answer ids, the annoying remap and the padded vocabulary: the JAX
    model's (through ``transformers``) and the reference's constants."""
    jm = JaxBLIP2_MR(**TINY, task=QA_TASK, tokenizer_path=str(DATA / name),
                     init_params=False, scan_layers=False)
    pm = BLIP2_MR(**TINY, task=QA_TASK, tokenizer_path=str(DATA / name),
                  init_params=False, device="cpu")
    assert pm.answer_ids == jm.answer_ids == [71, 272, 205, 309, 262]
    assert pm.annoying_numbers_replacement_dict == jm.annoying_numbers_replacement_dict
    assert pm.annoying_numbers_replacement_dict
    want_vocab = {"fixture_t5": 1280, "flan_t5": 32128}[name]
    assert pm.t5_config.vocab_size == jm.t5_config.vocab_size == want_vocab
    assert pm.tokenizer.vocab_size == jm.tokenizer.vocab_size


@pytest.mark.parametrize("name", T5_DIRS)
def test_mr_loss_and_spans_equal_jax(name):
    jm, pm = _pair(name)
    samples = _samples()
    batch_p = pm.prepare_mr_batch(samples)
    batch_j = jm.prepare_mr_batch(samples)
    for key in ("end_ids", "text_ids", "time_ids", "src_idx", "target_ids"):
        np.testing.assert_array_equal(np.asarray(batch_p[key]), np.asarray(batch_j[key]))
    want, got = float(jm(samples)["loss"]), float(pm(samples)["loss"])
    assert abs(got - want) <= 1e-4, (got, want)
    jout, pout = jm.generate(samples), pm.generate(samples)
    assert pout["raw_prediction"] == jout["raw_prediction"]
    assert pout["prediction"] == jout["prediction"]
    assert all(isinstance(moment_str_to_list(p), list) for p in pout["prediction"])


def test_videoqa_answer_logits_equal_jax():
    """The answerer's step-1 logits at the derived A-E ids within 1e-4, the
    predictions and moments identical."""
    jm, pm = _pair("fixture_t5", task=QA_TASK, answerer=True)
    samples = _samples()
    want, got = jm.videoQA_generate(samples), pm.videoQA_generate(samples)
    assert got["output_text"] == want["output_text"]
    assert got["relevant_moments"] == want["relevant_moments"]
    handle = jm.videoQA_redecode(jm.videoQA_dispatch(samples))
    enc = jm.tokenizer(list(samples["qa_input"]), truncation=True, max_length=jm.max_txt_len)
    _, scores = jm._jit_qa_answer({**jm.params, "t5": jm.answerer_params["t5"]},
                                  handle["frames"], enc.input_ids, enc.attention_mask, 2, 8)
    want_logits = np.asarray(scores)[1][:, jm.answer_ids]
    _, got_scores = pm._qa_answer_scores(dict(samples, relevant_frames=handle["frames"]))
    got_logits = got_scores[1][:, pm.answer_ids].numpy()
    np.testing.assert_allclose(got_logits, want_logits, atol=1e-4)
    assert got["output_text"] == np.argmax(got_logits, axis=-1).tolist()


def test_fmr_equal_jax(monkeypatch):
    real = JaxFMR._prepare

    def keep_uint8(self, samples, with_targets):  # the JAX package casts to float32
        batch = real(self, samples, with_targets)
        batch["frames"] = np.asarray(samples["video"])
        return batch

    monkeypatch.setattr(JaxFMR, "_prepare", keep_uint8)
    jm, pm = _pair("fixture_t5", jax_cls=JaxFMR, port_cls=Blip2FMR)
    tok = HFT5Tokenizer(str(DATA / "fixture_t5"))
    assert (pm.yes_id, pm.no_id) == (jm.yes_id, jm.no_id) == (
        tok.encode("yes", add_special_tokens=False)[-1],
        tok.encode("no", add_special_tokens=False)[-1])
    samples = dict(_samples(), qa_output=["_".join(["yes", "no", "no"] * 2)] * 2)
    jout, pout = jm.generate(samples), pm.generate(samples)
    assert float(np.abs(pout["yes_score"] - jout["yes_score"]).max()) <= 1e-4
    assert pout["prediction"] == jout["prediction"]
    want, got = float(jm(samples)["loss"]), float(pm(samples)["loss"])
    assert abs(got - want) <= 1e-4, (got, want)


def _wide_tiny_opt(monkeypatch, rows):
    monkeypatch.setitem(JaxOPT.OPT_CONFIGS, "tiny",
                        functools.partial(jopt.opt_tiny_config, vocab_size=rows))
    monkeypatch.setitem(BLIP2_MR_OPT.OPT_CONFIGS, "tiny",
                        functools.partial(topt.opt_tiny_config, vocab_size=rows))


def _opt_pair(rows=None, monkeypatch=None):
    if rows:
        _wide_tiny_opt(monkeypatch, rows)
    cfg = dict(opt_model="tiny", img_size=28, vit_model="tiny", task="lora", num_beams=2,
               max_new_tokens=6, compute_dtype="float32",
               tokenizer_path=str(DATA / "opt_bpe"))
    jm = JaxOPT(**cfg, scan_layers=False, init_params=False)
    params = _redraw(jax.eval_shape(jm.init_params, jax.random.PRNGKey(0)), 5)
    jm.params = jax.tree.map(jnp.asarray, params)
    pm = BLIP2_MR_OPT(**cfg, init_params=False, device="cpu")
    pm.load_state_dict(state_dict_from_jax(params), strict=True)
    return jm, pm


def test_opt_under_bpe_equals_jax(monkeypatch):
    """OPT's BPE through ``prepare_opt_batch``: the same prompt ids (the
    answers end in ``</s>``, id 2), loss within 1e-4, identical spans."""
    jm, pm = _opt_pair(768, monkeypatch)
    assert pm.answer_ids == jm.answer_ids
    assert pm.annoying_numbers_replacement_dict == jm.annoying_numbers_replacement_dict
    assert pm.opt_config.vocab_size == jm.opt_config.vocab_size == 768
    samples = _samples(t=2)
    batch_p = pm.prepare_opt_batch(samples)
    batch_j = jm.prepare_opt_batch(samples)
    for key in ("vid_ids", "end_ids", "text_ids", "answer_ids", "answer_mask"):
        np.testing.assert_array_equal(np.asarray(batch_p[key]), np.asarray(batch_j[key]))
    last = batch_p["answer_mask"].sum(axis=1) - 1
    assert (batch_p["answer_ids"][np.arange(2), last] == 2).all()
    real = JaxOPT.prepare_opt_batch

    def keep_uint8(self, samples, need_targets=True):  # the JAX package casts to float32
        return dict(real(self, samples, need_targets), frames=np.asarray(samples["video"]))

    monkeypatch.setattr(JaxOPT, "prepare_opt_batch", keep_uint8)
    want, got = float(jm(samples)["loss"]), float(pm(samples)["loss"])
    assert abs(got - want) <= 1e-4, (got, want)
    jout, pout = jm.generate(samples), pm.generate(samples)
    assert pout["prediction"] == jout["prediction"]


def test_tiny_opt_vocab_under_bpe():
    """At the tiny OPT's 256 rows the BPE fixture's ids run past the table:
    NaN in the JAX package, ``IndexError`` in the port."""
    jm, pm = _opt_pair()
    assert pm.opt_config.vocab_size == jm.opt_config.vocab_size == 256
    samples = _samples(t=2)
    assert pm.prepare_opt_batch(samples)["text_ids"].max() >= 256
    assert not np.isfinite(float(jm(samples)["loss"]))
    with pytest.raises(IndexError):
        pm(samples)


def test_port_reads_the_directories_jax_reads():
    """The port's tokenizer under each model is its own reader, not
    ``transformers``; the JAX model's is ``transformers``'."""
    for name in (*T5_DIRS, "opt_bpe"):
        pm = BLIP2_MR(**TINY, tokenizer_path=str(DATA / name), init_params=False,
                      device="cpu")
        assert type(pm.tokenizer).__module__ == "mr_blip_tpu_torch.text.tokenizer"
        assert not hasattr(pm.tokenizer, "_tok")


def test_server_tokenizes_through_the_reader():
    """``MomentRetrievalServer`` over the model under the fixture tokenizer:
    the rows of a two-request batch equal ``generate`` on those rows."""
    from mr_blip_tpu_torch.serving.server import MomentRetrievalServer
    from tests.test_torch_serving import _request, _samples

    _, pm = _pair("fixture_t5")
    reqs = [_request(i, duration=124.0) for i in range(2)]
    with MomentRetrievalServer(pm, max_batch=2, max_wait_ms=2000) as srv:
        got = [f.result(timeout=120) for f in [srv.submit(r) for r in reqs]]
    want = pm.generate(_samples(reqs))
    assert [g["raw_prediction"] for g in got] == want["raw_prediction"]
    assert [g["prediction"] for g in got] == want["prediction"]
