"""The BLIP2_MR variants and ``blip2_fmr`` against the JAX package, on the CPU.

The tiny configuration in fp32 (the kernels' plain versions), the JAX model
and the port on the same weights (``init_params_fast``'s tree redrawn from a
numpy seed, converted by ``state_dict_from_jax``): the ``only_frames`` task,
``interleave_data=False``, ``frame_token_aggregation="mean"`` and
``fast_gelu`` give the JAX loss within 1e-4 and its spans
string for string; ``blip2_fmr`` its per-frame scores within 1e-4, the same
yes/no answers and moments, and its loss within 1e-4.

Two differences of the JAX package, each shown here (ROADMAP Queue 3,
known differences): its non-interleaved encoder bias counts 32 tokens a
frame whatever the Q-Former gives, so at the tiny Q-Former's 4 queries its
``generate`` fails the encoder's length check (the comparisons hand its
encoder no cached bias: it then computes the same bias in the graph); and
``blip2_fmr``'s ``_prepare`` casts uint8 frames to float32, so the
comparisons hand the JAX model the uint8 frames (``_jax_keeps_uint8``).
The JAX constructor applies ``fast_gelu`` to the EVA ViT-g only; its tiny
ViT is rebuilt with the tanh GELU for the comparison.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

import mr_blip_tpu  # noqa: F401
from mr_blip_tpu.models.blip2_fmr import Blip2FMR as JaxFMR
from mr_blip_tpu.models.blip2_mr import BLIP2_MR as JaxBLIP2_MR
from mr_blip_tpu.models.blip2_mr_module import Blip2MRModule as JaxModule
from mr_blip_tpu_torch.models import load_model
from mr_blip_tpu_torch.models.blip2_fmr import Blip2FMR
from mr_blip_tpu_torch.models.blip2_mr import BLIP2_MR
from mr_blip_tpu_torch.models.convert import state_dict_from_jax

TINY = dict(img_size=28, vit_model="tiny", t5_model="tiny", num_beams=2,
            max_new_tokens=8, compute_dtype="float32")
VARIANTS = {
    "only_frames": dict(task="lora_only_frames"),
    "noninterleaved": dict(task="lora", interleave_data=False),
    "mean": dict(task="lora", frame_token_aggregation="mean"),
    "fast_gelu": dict(task="lora", fast_gelu=True),
}


@pytest.fixture(scope="module")
def params():
    """The tiny model's tree, every leaf redrawn (LoRA deltas count)."""
    jm = JaxBLIP2_MR(**TINY, task="lora", init_params=False, scan_layers=False)
    tree = jax.tree.map(np.asarray, jm.init_params_fast(jax.random.PRNGKey(0),
                                                        dtype=jnp.float32))
    rng = np.random.default_rng(23)
    flat = traverse_util.flatten_dict(tree)
    for key, leaf in flat.items():
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        flat[key] = 1.0 + 0.1 * noise if key[-1] == "scale" else 0.3 * noise
    return traverse_util.unflatten_dict(flat)


def _samples(b=2, t=6, seed=0):
    rng = np.random.default_rng(seed)
    duration = [24.0, 31.0][:b]
    return {
        "video": rng.integers(0, 256, (b, t, 28, 28, 3), dtype=np.uint8),
        "timestamps": np.stack([np.linspace(0, d, t, endpoint=False) for d in duration]),
        "duration": np.array(duration),
        "query_id": [f"q{i}" for i in range(b)],
        "video_prompt_end": ["<extra_id_0>"] * b,
        "query_prompt": ["Query: a cat jumps\n", "Query: someone opens a door\n"][:b],
        "task_prompt": ["Given the video and the query, find the relevant "
                        "windows.\nRelevant windows: "] * b,
        "relevant_windows": ["[[0, 10]]", "[[4, 12], [20, 30]]"][:b],
        "loc_input": ["Question: a cat jumps? Is this frame relevant?",
                      "Question: someone opens a door?"][:b],
        "qa_output": ["_".join(["yes", "no", "no"] * (t // 3))] * b,
    }


def _pair(params, jax_cls=JaxBLIP2_MR, port_cls=BLIP2_MR, **kw):
    jm = jax_cls(**TINY, **kw, init_params=False, scan_layers=False)
    if kw.get("fast_gelu"):
        jm.vit_config = dataclasses.replace(jm.vit_config, fast_gelu=True)
        jm.module = JaxModule(vit_config=jm.vit_config, qformer_config=jm.qformer_config,
                              t5_config=jm.t5_config, compute_dtype=jm.compute_dtype,
                              decode_cache_len=jm.max_new_tokens)
    jm.params = jax.tree.map(jnp.asarray, params)
    pm = port_cls(**TINY, **kw, init_params=False, device="cpu")
    pm.load_state_dict(state_dict_from_jax(params))
    return jm, pm


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variant_loss_and_spans_equal_jax(params, variant, monkeypatch):
    kw = VARIANTS[variant]
    jm, pm = _pair(params, **kw)
    samples = _samples()
    want = float(jm(samples)["loss"])
    got = float(pm(samples)["loss"])
    assert abs(got - want) <= 1e-4, (got, want)
    # The JAX package's non-interleaved bias counts 32 tokens a frame
    # (see test_noninterleaved_bias_length): its encoder computes the bias.
    monkeypatch.setattr(JaxBLIP2_MR, "_encoder_bias_for", lambda self, batch: None)
    jout, pout = jm.generate(samples), pm.generate(samples)
    assert pout["raw_prediction"] == jout["raw_prediction"]
    assert pout["prediction"] == jout["prediction"]
    batch = pm.prepare_mr_batch(samples, need_targets=False)
    assert ("int_mask" in batch) == pm.interleaved
    tokens = 1 if kw.get("frame_token_aggregation") else 4
    assert pm.module.tokens_per_frame == tokens
    if variant == "only_frames":
        assert pm.tokenizer.batch_decode(batch["vid_ids"])[0].startswith("<vid>")
        assert pm.tokenizer.batch_decode(batch["end_ids"])[0].startswith("<extra_id_0>")
    if variant == "fast_gelu":
        exact = BLIP2_MR(**TINY, task="lora", init_params=False, device="cpu")
        exact.load_state_dict(pm.state_dict())
        tensors = pm._to_device(batch)
        with torch.no_grad():
            assert not torch.equal(pm.frames_to_t5(tensors), exact.frames_to_t5(tensors))


@pytest.mark.parametrize("variant", ["only_frames", "noninterleaved"])
def test_noninterleaved_bias_length(params, variant):
    """The port's cached bias has the encoder's length; the JAX package's
    counts 32 tokens a frame (``mr_blip_tpu/models/blip2_mr.py:646``), 4 at
    the tiny Q-Former, and its encoder refuses it."""
    jm, pm = _pair(params, **VARIANTS[variant])
    samples = _samples()
    batch = pm.prepare_mr_batch(samples, need_targets=False)
    tensors = pm._to_device(batch)
    with torch.no_grad():
        embeds, _ = pm.encoder_input(tensors, pm.frames_to_t5(tensors))
    assert pm._encoder_bias_for(batch).shape[-1] == embeds.shape[1]
    jbias = jm._encoder_bias_for({k: v for k, v in jm.prepare_mr_batch(
        samples, need_targets=False).items() if k != "video_prompt"})
    text = batch["vid_ids"].shape[1] + batch["end_ids"].shape[1] + batch["text_ids"].shape[1]
    assert embeds.shape[1] == -(-(text + 6 * 4) // 8) * 8
    assert jbias.shape[-1] == -(-(text + 6 * 32) // 8) * 8
    with pytest.raises(AssertionError):
        jm.generate(samples)


def test_aggregation_settings(params):
    with pytest.raises(ValueError, match="frame_token_aggregation"):
        BLIP2_MR(**TINY, frame_token_aggregation="max", device="cpu")
    # every int8 rebuild keeps the aggregation (one token a frame)
    _, pm = _pair(params, **VARIANTS["mean"])
    pm.quantize_for_inference()
    assert pm.module.tokens_per_frame == 1 and pm.vit_config.int8_matmul
    out = pm.generate(_samples())
    assert len(out["prediction"]) == 2


@pytest.fixture
def _jax_keeps_uint8(monkeypatch):
    real = JaxFMR._prepare

    def keep(self, samples, with_targets):
        batch = real(self, samples, with_targets)
        assert batch["frames"].dtype == np.float32  # the JAX package's cast
        batch["frames"] = np.asarray(samples["video"])
        return batch

    monkeypatch.setattr(JaxFMR, "_prepare", keep)


def test_fmr_scores_predictions_and_loss_equal_jax(params, _jax_keeps_uint8):
    jm, pm = _pair(params, jax_cls=JaxFMR, port_cls=Blip2FMR, task="lora")
    samples = _samples()
    jscores = np.asarray(jm.generate(samples)["yes_score"])
    # a threshold in the widest gap between the scores, so that frames fall
    # on both sides of it
    s = np.sort(jscores.ravel())
    i = int(np.argmax(np.diff(s)))
    jm.threshold = pm.threshold = float(s[i] + s[i + 1]) / 2
    jout, pout = jm.generate(samples), pm.generate(samples)
    assert float(np.abs(pout["yes_score"] - jout["yes_score"]).max()) <= 1e-4
    assert pout["pred_ans"] == jout["pred_ans"]
    assert 0 < int(np.sum(pout["pred_ans"])) < jscores.size
    assert pout["prediction"] == jout["prediction"]
    assert (pm.yes_id, pm.no_id) == (jm.yes_id, jm.no_id)
    want, got = float(jm(samples)["loss"]), float(pm(samples)["loss"])
    assert abs(got - want) <= 1e-4, (got, want)


def test_load_model_builds_blip2_fmr():
    model = load_model("blip2_fmr", "tiny", device="cpu")
    assert isinstance(model, Blip2FMR) and model.frame_prefix == "Frame: "
    out = model.generate(_samples(b=1, t=3))
    assert out["yes_score"].shape == (1, 3) and np.isfinite(out["yes_score"]).all()
