"""The port's generate path against the JAX package's, on the CPU.

Beam search on a fixed logits table, the tiny ``BLIP2_MR.generate`` on the
same converted weights and samples (identical predictions), the copied
text modules, and the rule that the port never imports JAX.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from mr_blip_tpu.models import generation as jgen
from mr_blip_tpu.models.blip2_mr import BLIP2_MR as JaxBLIP2_MR
from mr_blip_tpu.models.scan_utils import stack_blip2_mr_params, unstack_blip2_mr_params
from mr_blip_tpu.text import span_grammar as jspan
from mr_blip_tpu.text import timestamps as jts
from mr_blip_tpu.text import tokenizer as jtok
from mr_blip_tpu_torch.models import generation as tgen
from mr_blip_tpu_torch.models.blip2_mr import BLIP2_MR
from mr_blip_tpu_torch.models.convert import state_dict_from_jax
from mr_blip_tpu_torch.text import span_grammar as tspan
from mr_blip_tpu_torch.text import timestamps as tts
from mr_blip_tpu_torch.text import tokenizer as ttok


# ----------------------------------------------------------- beam search
def _logits_table(seed, steps, vocab, eos, eos_boost):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((steps, vocab, vocab)).astype(np.float32) * 2.0
    table[:, :, eos] += eos_boost
    return table


@pytest.mark.parametrize("batch,beams,vocab,max_len,min_new,eos_boost", [
    (2, 3, 11, 7, 0, 0.0),
    (3, 4, 13, 9, 3, 1.5),   # EOS often: early stop and the min-length ban
    (2, 5, 17, 6, 6, 3.0),   # EOS banned for every step
])
def test_beam_search_matches_jax(batch, beams, vocab, max_len, min_new, eos_boost):
    """Logits depend on the step, the fed token and a per-row cache that
    sums the tokens so far, so beam reordering of the cache is exercised."""
    eos = 1
    table = _logits_table(batch * 100 + vocab, max_len, vocab, eos, eos_boost)
    kw = dict(batch_size=batch, num_beams=beams, max_length=max_len,
              min_new_tokens=min_new, eos_token_id=eos, pad_token_id=0,
              decoder_start_token_id=0)

    def jax_step(cache, tokens, position):
        logits = jnp.asarray(table)[position][tokens[:, 0]] + 0.01 * cache
        return logits, cache + tokens.astype(jnp.float32)

    def torch_step(cache, tokens, position):
        logits = torch.from_numpy(table)[position][tokens[:, 0]] + 0.01 * cache
        return logits, cache + tokens.float()

    rows = batch * beams
    want_seqs, want_scores = jgen.beam_search(
        jax_step, jnp.zeros((rows, 1), jnp.float32), **kw)
    got_seqs, got_scores = tgen.beam_search(torch_step, torch.zeros(rows, 1), **kw)
    np.testing.assert_array_equal(got_seqs.numpy(), np.asarray(want_seqs))
    np.testing.assert_allclose(got_scores.numpy(), np.asarray(want_scores), atol=1e-5)


def test_expand_to_beams_matches_jax():
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    np.testing.assert_array_equal(tgen.expand_to_beams(torch.from_numpy(x), 2).numpy(),
                                  np.asarray(jgen.expand_to_beams(jnp.asarray(x), 2)))


# ----------------------------------------------------- tiny end to end
def _samples(video_dtype, b=2, t=4, img=28, seed=0):
    rng = np.random.default_rng(seed)
    duration = [20.0, 30.0, 41.0][:b]
    video = (rng.integers(0, 256, (b, t, img, img, 3), dtype=np.uint8)
             if video_dtype == "uint8"
             else rng.standard_normal((b, t, img, img, 3)).astype(np.float32))
    return {
        "video": video,
        "timestamps": np.stack([np.linspace(0, d, t, endpoint=False) for d in duration]),
        "duration": np.array(duration),
        "query_id": [f"q{i}" for i in range(b)],
        "video_prompt_end": ["<extra_id_0>"] * b,
        "query_prompt": ["Query: a cat jumps\n"] * b,
        "task_prompt": ["Given the video and the query, find the relevant "
                        "windows.\nRelevant windows: "] * b,
        "relevant_windows": ["[[0, 10]]"] * b,
    }


@pytest.fixture(scope="module")
def tiny_pair():
    """JAX and port BLIP2_MR (config of tests/test_blip2_mr.py) on the same
    weights: every leaf redrawn from a numpy seed, so the LoRA deltas count."""
    kw = dict(img_size=28, vit_model="tiny", t5_model="tiny", num_beams=2,
              max_new_tokens=8, task="lora", input_time_format="seconds_integers",
              compute_dtype="float32")
    jm = JaxBLIP2_MR(**kw)
    rng = np.random.default_rng(21)
    flat = traverse_util.flatten_dict(
        jax.tree.map(np.asarray, unstack_blip2_mr_params(jm.params)))
    for key, leaf in flat.items():
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        flat[key] = 1.0 + 0.1 * noise if key[-1] == "scale" else 0.3 * noise
    params = traverse_util.unflatten_dict(flat)
    jm.params = jax.tree.map(jnp.asarray, stack_blip2_mr_params(params))
    port = BLIP2_MR(**kw, device="cpu", init_params=False)
    port.load_state_dict(state_dict_from_jax(params))
    return jm, port


@pytest.mark.parametrize("video_dtype,b,seed", [("float32", 2, 0), ("uint8", 3, 1)])
def test_tiny_generate_identical_to_jax(tiny_pair, video_dtype, b, seed):
    jm, port = tiny_pair
    samples = _samples(video_dtype, b=b, seed=seed)
    want_handle = jm.generate_dispatch(samples)
    want = jm.generate_collect(want_handle)
    got_handle = port.generate_dispatch(samples)
    got = port.generate_collect(got_handle)
    assert got["raw_prediction"] == want["raw_prediction"]
    assert got["prediction"] == want["prediction"]
    assert got["qid"] == want["qid"] and got["duration"] == want["duration"]
    np.testing.assert_array_equal(got_handle["seqs"].numpy(),
                                  np.asarray(want_handle["seqs"]))
    np.testing.assert_allclose(got_handle["scores"].numpy(),
                               np.asarray(want_handle["scores"]), atol=1e-4)


def test_tiny_generate_bf16_runs(tiny_pair):
    """The bf16 compute path on the CPU (plain versions of every kernel)."""
    _, port = tiny_pair
    model = BLIP2_MR(img_size=28, vit_model="tiny", t5_model="tiny", num_beams=2,
                     max_new_tokens=8, min_new_tokens=3, task="lora",
                     compute_dtype="bfloat16", init_params=False, device="cpu")
    model.load_state_dict(port.state_dict())
    handle = model.generate_dispatch(_samples("uint8"))
    out = model.generate_collect(handle)
    assert len(out["prediction"]) == 2
    assert torch.isfinite(handle["scores"]).all()
    for p in out["prediction"]:
        tspan.moment_str_to_list(p)


# ------------------------------------------------------ text module copies
def test_tokenizer_copy_matches():
    jt, tt = jtok.MockT5Tokenizer(), ttok.MockT5Tokenizer()
    texts = ["Query: a cat jumps\n", "[[10, 25], [26, 39]]", "13>17>221<extra_id_0>",
             "Given the video and the query, find the relevant windows.", " 0.5 7 "]
    for text in texts:
        ids = jt.encode(text)
        assert tt.encode(text) == ids
        assert tt.decode(ids, skip_special_tokens=True) == jt.decode(
            ids, skip_special_tokens=True)
    a, b = jt(texts, truncation=True, max_length=9), tt(texts, truncation=True, max_length=9)
    np.testing.assert_array_equal(a.input_ids, b.input_ids)
    np.testing.assert_array_equal(a.attention_mask, b.attention_mask)
    assert type(ttok.load_tokenizer(None)).__name__ == "MockT5Tokenizer"


@pytest.mark.parametrize("fmt", jts.TIME_FORMATS)
def test_timestamps_copy_matches(fmt):
    tok = jtok.MockT5Tokenizer()
    annoying, spacy = jts.find_annoying_numbers(tok, 200)
    assert tts.find_annoying_numbers(tok, 200) == (annoying, spacy)
    repl = jts.find_annoying_numbers_replacement_dict(annoying)
    assert tts.find_annoying_numbers_replacement_dict(annoying) == repl
    ts = np.stack([np.linspace(0, d, 7, endpoint=False) for d in (20.0, 151.3)])
    dur = np.array([20.0, 151.3])
    assert (tts.format_timestamps(fmt, ts, dur, repl)
            == jts.format_timestamps(fmt, ts, dur, repl))


def test_span_grammar_copy_matches():
    strings = ["[[10, 25]]", "[[10, 25], [30, 41]]", "[[10, 25", "garbage", "",
               "[[0.5, 0.75]]", "[[3, 1]]", "[[-1, -1]]"]
    for s in strings:
        assert tspan.post_process(s) == jspan.post_process(s)
        assert tspan.moment_str_to_list(s) == jspan.moment_str_to_list(s)
    preds = [tspan.post_process(s) for s in strings[:3]]
    for fmt in ("relative_integers", "relative_floats"):
        assert (tspan.convert_to_absolute_time(preds, [20.0, 30.0, 40.0], fmt)
                == jspan.convert_to_absolute_time(preds, [20.0, 30.0, 40.0], fmt))


# --------------------------------------------------------- import rules
def test_port_imports_no_jax_or_triton():
    """Nor pyyaml, scikit-learn, transformers, tokenizers, sentencepiece,
    regex, peft or safetensors, which the card's machine lacks: the configs
    are read, models built under the committed Flan-T5-shaped and OPT BPE
    tokenizer directories, ``port_weights`` run with ``--tokenizer-path``,
    the scorer, gates and asset-day modules imported, and every module of the
    evaluation, train and serving entry points imported (data and sequence
    parallelism with them), the grounded-QA and TAL tasks, the OPT variant,
    ``blip2_fmr``, tensor and pipeline parallelism (``dryrun_multichip``), the
    checkpoint import (``models/port.py``, ``port_weights``), metrics, datasets
    and video reader with them, the BLIP-v1 zoo (ViT, MED, the wrappers, the
    caption and retrieval tasks, the image datasets and processors, WordPiece,
    the caption metrics; no PIL until a RandAugment op runs), the CLIP and
    ALBEF families (CLIP BPE, both CLIP towers, ALBEF, their wrappers and
    the BLIP-v1 ones) and models built by ``load_model``."""
    code = (
        "import sys\n"
        "import mr_blip_tpu_torch\n"
        "import mr_blip_tpu_torch.models.blip2_mr, mr_blip_tpu_torch.models.convert\n"
        "import mr_blip_tpu_torch.ops.flash_attention, mr_blip_tpu_torch.ops._cuda\n"
        "import mr_blip_tpu_torch.profile_inference\n"
        "import mr_blip_tpu_torch.runners.train_state, mr_blip_tpu_torch.common.optims\n"
        "import mr_blip_tpu_torch.models.layers, mr_blip_tpu_torch.ops.layer_norm\n"
        "import mr_blip_tpu_torch.ops.int8_matmul, mr_blip_tpu_torch.models.quantize\n"
        "import mr_blip_tpu_torch.profile_int8_kernels\n"
        "import mr_blip_tpu_torch.ops.attention, mr_blip_tpu_torch.models.generation\n"
        "import mr_blip_tpu_torch.models.blip2_mr_module, mr_blip_tpu_torch.models.eva_vit\n"
        "import mr_blip_tpu_torch.evaluate, mr_blip_tpu_torch.models.base\n"
        "import mr_blip_tpu_torch.common.config, mr_blip_tpu_torch.common.config_validator\n"
        "import mr_blip_tpu_torch.common.dist, mr_blip_tpu_torch.common.logger\n"
        "import mr_blip_tpu_torch.common.utils, mr_blip_tpu_torch.common.yaml_subset\n"
        "import mr_blip_tpu_torch.datasets.builders, mr_blip_tpu_torch.datasets.loader\n"
        "import mr_blip_tpu_torch.datasets.synthetic, mr_blip_tpu_torch.datasets.video_reader\n"
        "import mr_blip_tpu_torch.metrics, mr_blip_tpu_torch.metrics.simple\n"
        "import mr_blip_tpu_torch.processors, mr_blip_tpu_torch.tasks\n"
        "import mr_blip_tpu_torch.runners.runner_base\n"
        "import mr_blip_tpu_torch.train, mr_blip_tpu_torch.runners.runner_iter\n"
        "import mr_blip_tpu_torch.common.preempt, mr_blip_tpu_torch.common.tracking\n"
        "import mr_blip_tpu_torch.tasks.vqa, mr_blip_tpu_torch.metrics.grounded_qa\n"
        "import mr_blip_tpu_torch.native.build, mr_blip_tpu_torch.datasets.mr_datasets\n"
        "import mr_blip_tpu_torch.models.opt, mr_blip_tpu_torch.models.blip2_mr_opt\n"
        "import mr_blip_tpu_torch.tasks.temporal_action_localization\n"
        "import mr_blip_tpu_torch.metrics.span_ops\n"
        "import mr_blip_tpu_torch.parallel, mr_blip_tpu_torch.parallel.mesh\n"
        "import mr_blip_tpu_torch.parallel.tensor\n"
        "import mr_blip_tpu_torch.serving, mr_blip_tpu_torch.serving.server\n"
        "import mr_blip_tpu_torch.serve, mr_blip_tpu_torch.models\n"
        "import mr_blip_tpu_torch.models.port, mr_blip_tpu_torch.port_weights\n"
        "import mr_blip_tpu_torch.models.blip2_fmr\n"
        "import mr_blip_tpu_torch.text.tokenizer_json, mr_blip_tpu_torch.text.bpe\n"
        "import mr_blip_tpu_torch.text.precompiled_charsmap\n"
        "import mr_blip_tpu_torch.text.vocab_facts, mr_blip_tpu_torch.standalone_eval\n"
        "import mr_blip_tpu_torch.asset_gates, mr_blip_tpu_torch.asset_day\n"
        "import mr_blip_tpu_torch.parallel.pipeline, mr_blip_tpu_torch.models.t5_pipeline\n"
        "import mr_blip_tpu_torch.dryrun_multichip\n"
        "import mr_blip_tpu_torch.models.vit, mr_blip_tpu_torch.models.med\n"
        "import mr_blip_tpu_torch.models.blip_v1, mr_blip_tpu_torch.models.zoo_wrappers\n"
        "import mr_blip_tpu_torch.tasks.captioning, mr_blip_tpu_torch.tasks.retrieval\n"
        "import mr_blip_tpu_torch.datasets.image_datasets\n"
        "import mr_blip_tpu_torch.processors.image_processors\n"
        "import mr_blip_tpu_torch.processors.randaugment\n"
        "import mr_blip_tpu_torch.text.wordpiece, mr_blip_tpu_torch.metrics.caption_metrics\n"
        "import mr_blip_tpu_torch.text.clip_bpe, mr_blip_tpu_torch.models.clip\n"
        "import mr_blip_tpu_torch.models.clip_resnet, mr_blip_tpu_torch.models.albef\n"
        "from mr_blip_tpu_torch.models import load_model\n"
        "load_model('blip2_mr', 'tiny', device='cpu')\n"
        "load_model('blip2_fmr', 'tiny', device='cpu')\n"
        "load_model('blip_caption', 'tiny', device='cpu')\n"
        "load_model('blip_retrieval', 'tiny', device='cpu')\n"
        "for name in ('clip', 'albef_nlvr_model', 'albef_retrieval', 'albef_pretrain',\n"
        "             'albef_classification', 'blip_classification', 'blip_nlvr', 'blip_vqa',\n"
        "             'blip_feature_extractor', 'blip_image_text_matching', 'blip_pretrain'):\n"
        "    load_model(name, 'tiny', device='cpu')\n"
        "load_model('clip', 'RN50', device='cpu', model_size='RN50')\n"
        "tok = 'tests/data/torch_tokenizer/'\n"
        "m = load_model('blip2_mr', 'tiny', device='cpu', tokenizer_path=tok + 'flan_t5')\n"
        "assert m.answer_ids == [71, 272, 205, 309, 262], m.answer_ids\n"
        "assert m.tokenizer.encode('[[10, 25]]')[-1] == 1\n"
        "from mr_blip_tpu_torch.models.blip2_mr_opt import BLIP2_MR_OPT\n"
        "m = BLIP2_MR_OPT(opt_model='tiny', vit_model='tiny', img_size=28, device='cpu', "
        "tokenizer_path=tok + 'opt_bpe')\n"
        "assert m.tokenizer.encode('Query')[0] == 2\n"
        "import tempfile, os\n"
        "from mr_blip_tpu_torch import port_weights\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    port_weights.main(['--model-type', 'tiny', '--device', 'cpu', "
        "'--tokenizer-path', tok + 'fixture_t5', '--output', os.path.join(d, 'x.pth')])\n"
        "from mr_blip_tpu_torch.common.config import Config\n"
        "Config(cfg_path='configs/projects/eval/anet_TAL.yaml')\n"
        "Config(cfg_path='configs/projects/eval/opt_charades.yaml')\n"
        "Config(cfg_path='configs/projects/eval/qvh.yaml')\n"
        "Config(cfg_path='configs/projects/train/qvh.yaml')\n"
        "Config(cfg_path='configs/projects/eval/nextGQA.yaml')\n"
        "Config(cfg_path='configs/projects/eval/nextQA.yaml')\n"
        "Config(cfg_path='configs/projects/zoo/caption_coco_eval.yaml')\n"
        "Config(cfg_path='configs/projects/zoo/ret_coco_eval.yaml')\n"
        "Config(cfg_path='configs/projects/zoo/ret_flickr_eval.yaml')\n"
        "Config(cfg_path='configs/projects/zoo/clip_ret_coco_eval.yaml')\n"
        "Config(cfg_path='configs/projects/zoo/clip_ret_flickr_eval.yaml')\n"
        "Config(cfg_path='configs/projects/zoo/nlvr_eval.yaml')\n"
        "from mr_blip_tpu_torch.datasets.video_reader import VideoReader\n"
        "VideoReader('synthetic://8x16x16').get_batch_async([0, 1]).result()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'triton', 'mr_blip_tpu', 'yaml', 'sklearn', "
        "'transformers', 'peft', 'safetensors', 'tokenizers', 'sentencepiece', 'regex', "
        "'PIL')]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          cwd=Path(__file__).resolve().parent.parent)
    assert proc.returncode == 0, proc.stderr


# ------------------------------------------------------------- profiling
def test_trace_summary_counts_overlap_once(tmp_path):
    """Device time is the union of the device intervals, so the busy share
    of a trace cannot exceed 1; host events only widen the span."""
    from mr_blip_tpu_torch.profile_inference import trace_summary

    def ev(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}

    trace = tmp_path / "t.json"
    trace.write_text(json.dumps({"traceEvents": [
        ev("cpu_op", "aten::mm", 0, 100),
        ev("kernel", "a", 10, 20), ev("kernel", "b", 20, 20),  # overlap: 10..40
        ev("gpu_memcpy", "Memcpy HtoD", 35, 10),               # extends to 45
        ev("kernel", "a", 60, 10),                             # 60..70
        {"ph": "i", "name": "marker", "ts": 500},               # not an interval
    ]}))
    got = trace_summary(trace)
    assert got["device_s"] == pytest.approx(45e-6)
    assert got["span_s"] == pytest.approx(100e-6)
    assert got["busy"] == pytest.approx(0.45)
    assert got["kernels"] == 4
    assert got["top"] == [["a", 2, pytest.approx(0.03)], ["b", 1, pytest.approx(0.02)]]
