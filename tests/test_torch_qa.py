"""The port's bias-free flash attention, ViT gates and two-stage grounded QA
against the JAX package's, on the CPU.

Tiny configs in fp32; inputs and weights drawn with numpy from a seed and
handed to both packages. A wrapper takes its kernel's plain version for a CPU
tensor, so these tests hold the plain versions (against the JAX kernel bodies
in Pallas interpret mode), the dispatch, the Python around the kernels and
the QA entry points; the CUDA kernel itself is held on the card by
``chip_smoke.py``. Tolerances: 1e-5 for one fp32 op, 1e-4 for a module or a
model (sums in another order; 1e-3 for the whole vocabulary's logits over
eight cached decode steps, whose largest magnitudes are ~10), 0.02 for bf16 outputs (the bar the kernels are held to on the card:
the JAX kernel rounds q·D^-½ and the unnormalized probabilities to bf16, the
plain version the normalized ones, and a causal row over a few keys reaches
|value| 2-4, where one bf16 step is 0.0156; both lie within 0.01 of the fp32
result), integers and strings identical.
"""

import dataclasses
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from jax.experimental import pallas as pl

import mr_blip_tpu.ops.flash_attention as jfa
from mr_blip_tpu.models import eva_vit as jvit
from mr_blip_tpu.models import generation as jgen
from mr_blip_tpu.models import quantize as jquant
from mr_blip_tpu.models.blip2_mr import BLIP2_MR as JaxBLIP2_MR
from mr_blip_tpu.ops.attention import xla_attention as jax_xla_attention
from mr_blip_tpu_torch.models import eva_vit
from mr_blip_tpu_torch.models import generation as tgen
from mr_blip_tpu_torch.models.blip2_mr import BLIP2_MR
from mr_blip_tpu_torch.models.convert import state_dict_from_jax
from mr_blip_tpu_torch.ops import attention as tattn
from mr_blip_tpu_torch.ops import flash_attention as tfa
from mr_blip_tpu_torch.ops import int8_matmul as tint8


def _t(a):
    return torch.from_numpy(np.array(a))


def _interpreted():
    """The JAX flash wrappers run their Pallas kernel bodies in interpret
    mode, as tests/test_attention.py runs them on the CPU."""
    orig = pl.pallas_call
    return mock.patch.object(
        jfa.pl, "pallas_call", lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))


def _qkv(seed, b, n, m, h, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, n, h, d), dtype=np.float32),
            rng.standard_normal((b, m, h, d), dtype=np.float32),
            rng.standard_normal((b, m, h, d), dtype=np.float32))


# --------------------------------------------------- kernel 4's plain version
FLASH_CASES = [
    # n, m, causal: square, rectangular, causal, ragged 300 keys
    (128, 128, False), (128, 128, True), (300, 300, False), (300, 300, True),
    (128, 300, False), (130, 300, True), (300, 64, False),
]


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", None)])
@pytest.mark.parametrize("n,m,causal", FLASH_CASES)
def test_flash_reference_matches_jax_kernel(n, m, causal, dtype, tol):
    """``tol``: max |diff|; in bf16 one ulp at the output's largest magnitude
    (0.004 where it is 0.6, without ``causal``; 0.016 where it is 3)."""
    q, k, v = _qkv(n + m, 2, n, m, 2, 64)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    with _interpreted():
        want = jfa.flash_attention(*(jnp.asarray(a).astype(jdt) for a in (q, k, v)),
                                   causal=causal, block_q=128, block_k=128)
    got = tfa.flash_attention(*(_t(a).to(tdt) for a in (q, k, v)), causal=causal)
    assert got.dtype == tdt and got.shape == (2, n, 2, 64)
    want = np.asarray(want, np.float32)
    if tol is None:
        tol = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)


def test_flash_reference_strided_views_of_packed_qkv():
    """The ViT hands over the q/k/v views of one packed projection."""
    rng = np.random.default_rng(5)
    qkv = _t(rng.standard_normal((2, 40, 3, 2, 8), dtype=np.float32))
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert not q.is_contiguous()
    got = tfa.flash_attention(q, k, v)
    want = tfa._qkv_packed_reference(qkv.reshape(2, 40, -1), 2, 8)
    np.testing.assert_allclose(got.reshape(2, 40, -1).numpy(), want.numpy(), atol=1e-6)
    # What the launcher would hand the kernel: the views as they are.
    for view in (q, k, v):
        assert tfa._kernel_view(view).data_ptr() == view.data_ptr()
    odd = _t(rng.standard_normal((2, 40, 2, 9), dtype=np.float32))[..., :8]
    assert tfa._kernel_view(odd).is_contiguous()  # misaligned rows are copied


@pytest.mark.parametrize("causal", [False, True])
def test_flash_gradient_matches_jax(causal):
    """The backward recomputes the plain version, as JAX's custom VJP does
    (tests/test_attention.py::test_backward_matches_xla)."""
    x = np.random.default_rng(4).standard_normal((1, 128, 2, 32), dtype=np.float32)
    with _interpreted():
        want = jax.grad(lambda a: jfa.flash_attention(
            a, a, a, causal=causal, block_q=64, block_k=64).sum())(jnp.asarray(x))
    leaf = _t(x).requires_grad_()
    tfa.flash_attention(leaf, leaf, leaf, causal=causal).sum().backward()
    np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_function_carries_gradients(causal):
    """A launcher's output has no autograd history: through ``_Flash``, with
    the launcher swapped for a CPU stand-in, q, k and v get the plain
    version's gradients."""
    def launch(q, k, v, causal):
        with torch.no_grad():
            return tfa._flash_reference(q, k, v, causal)

    rng = np.random.default_rng(6)
    leaves = [_t(a).requires_grad_() for a in _qkv(6, 2, 20, 33, 2, 8)]
    assert launch(*leaves, causal).grad_fn is None  # the fault a Function cures
    got = tfa._Flash.apply(*leaves, causal, launch)
    want = tfa._flash_reference(*leaves, causal)
    g = _t(rng.standard_normal(want.shape).astype(np.float32))
    for a, b in zip(torch.autograd.grad(got, leaves, g),
                    torch.autograd.grad(want, leaves, g)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_flash_attention_refuses_masks_and_bad_shapes():
    q, k, v = (_t(a) for a in _qkv(7, 1, 8, 8, 2, 8))
    with pytest.raises(NotImplementedError, match="causal masking only"):
        tfa.flash_attention(q, k, v, mask=torch.ones(1, 1, 8, 8, dtype=torch.bool))
    with pytest.raises(ValueError, match="do not match"):
        tfa.flash_attention(q, k[:, :, :1], v)
    with pytest.raises(ValueError, match="head dim"):
        tfa._check_head_dim(104)
    assert tfa.flash_attention.launches == 0  # no launch on the CPU


# ------------------------------------------------------------------ dispatch
@pytest.fixture
def backend():
    """Sets the port's attention backend and restores "auto" after."""
    yield tattn.set_attention_backend
    tattn.set_attention_backend("auto")


@pytest.mark.parametrize("name", ["auto", "xla", "flash"])
def test_attention_backends_agree_without_bias_or_mask(backend, name):
    q, k, v = (_t(a) for a in _qkv(8, 2, 260, 40, 2, 8))
    want = jax_xla_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v)))
    backend(name)
    got = tattn.dot_product_attention(q, k, v)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_flash_backend_refuses_mask_and_bias(backend):
    q, k, v = (_t(a) for a in _qkv(9, 1, 12, 12, 2, 8))
    mask = torch.ones(1, 1, 1, 12, dtype=torch.bool)
    bias = torch.zeros(1, 2, 12, 12)
    backend("flash")
    with pytest.raises(NotImplementedError, match="causal masking only"):
        tattn.dot_product_attention(q, k, v, mask=mask)
    with pytest.raises(NotImplementedError, match="no bias"):
        tattn.dot_product_attention(q, k, v, bias=bias)
    backend("xla")
    tattn.dot_product_attention(q, k, v, bias=bias, mask=mask)
    with pytest.raises(ValueError, match="auto, xla or flash"):
        backend("pallas")


def test_flash_backend_routes_to_flash_attention(backend, monkeypatch):
    calls = []
    monkeypatch.setattr(tfa, "flash_attention",
                        lambda q, k, v, mask=None: calls.append(mask) or q)
    q = torch.zeros(1, 4, 1, 8)
    tattn.dot_product_attention(q, q, q)
    assert not calls  # "auto" keeps a CPU tensor on the plain path
    backend("flash")
    tattn.dot_product_attention(q, q, q)
    assert calls == [None]
    # Active dropout forces the plain path under every backend, as in JAX.
    tattn.dot_product_attention(q, q, q, dropout_rate=0.5)
    assert calls == [None]


# ----------------------------------------------------------------- ViT gates
def test_packed_qkv_bound_is_the_jax_package_s():
    bound = eva_vit._PACKED_QKV_MAX_BYTES
    assert bound == 4 * 1024 * 1024
    for img, fits in ((224, True), (364, False)):
        cfg = eva_vit.eva_vit_g_config(img_size=img)
        n = cfg.num_patches + 1
        assert n == {224: 257, 364: 677}[img]
        assert (n * 3 * cfg.embed_dim * 2 <= bound) is fits


def _vit_case(seed=1):
    cfg = jvit.vit_tiny_config()
    images = np.random.default_rng(0).standard_normal((3, 28, 28, 3)).astype(np.float32)
    params = jvit.EvaViT(cfg, jnp.float32).init(jax.random.PRNGKey(0),
                                                jnp.asarray(images))["params"]
    return cfg, _redraw(params, seed, std=0.1), images


def _redraw(params, seed, std=0.3):
    rng = np.random.default_rng(seed)
    flat = traverse_util.flatten_dict(jax.tree.map(np.asarray, params))
    for key, leaf in flat.items():
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        flat[key] = 1.0 + 0.1 * noise if key[-1] == "scale" else std * noise
    return traverse_util.unflatten_dict(flat)


def _counted(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)
    monkeypatch.setattr(module, name,
                        lambda *a, **kw: calls.append(name) or fn(*a, **kw))
    return calls


@pytest.mark.parametrize("kernel_takes", [False, True])
@pytest.mark.parametrize("bound", [4 * 1024 * 1024, 0])
def test_float_vit_matches_jax_on_both_sides_of_the_gate(monkeypatch, bound, kernel_takes):
    """``kernel_takes``: the gate's type term answers as for a bf16 tensor on
    the card, and the packed-QKV kernel's plain version stands in for its
    launcher, so that the bound alone decides the route."""
    monkeypatch.setattr(eva_vit, "_PACKED_QKV_MAX_BYTES", bound)
    if kernel_takes:
        monkeypatch.setattr(eva_vit, "_packed_kernel_takes", lambda qkv: True)
        monkeypatch.setattr(
            eva_vit, "flash_attention_qkv_packed",
            lambda qkv, heads: tfa._qkv_packed_reference(
                qkv, heads, qkv.shape[-1] // (3 * heads)))
    packed = _counted(monkeypatch, eva_vit, "flash_attention_qkv_packed")
    split = _counted(monkeypatch, eva_vit, "dot_product_attention")
    cfg, params, images = _vit_case()
    want = jvit.EvaViT(cfg, jnp.float32).apply({"params": params}, jnp.asarray(images))
    port = eva_vit.EvaViT(eva_vit.vit_tiny_config())
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got = port(_t(images))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    if kernel_takes and bound:
        assert len(packed) == cfg.depth and not split
    else:
        # Past the bound, and for a CPU tensor whatever the bound, the split views.
        assert not packed and len(split) == cfg.depth


@pytest.mark.parametrize("bound,route", [(4 * 1024 * 1024, "fused"), (0, "split")])
def test_int8_vit_matches_jax_on_both_sides_of_the_gate(monkeypatch, bound, route):
    """Above the bound the int8 block is ``w8a8_linear`` -> attention ->
    ``w8a8_linear``, the route the JAX ViT takes on the CPU (padded to 8
    tokens there, unpadded here). Bars of the int8 ViT test: cosine >= 0.999
    per token, 2 bf16 ulps at the output's largest magnitude."""
    monkeypatch.setattr(eva_vit, "_PACKED_QKV_MAX_BYTES", bound)
    fused = _counted(monkeypatch, eva_vit, "w8a8_attn_block")
    linear = _counted(monkeypatch, eva_vit, "w8a8_linear")
    attention = _counted(monkeypatch, eva_vit, "dot_product_attention")
    cfg, params, images = _vit_case()
    qparams = jquant.quantize_vit_params(params)
    want = np.asarray(jvit.EvaViT(dataclasses.replace(cfg, int8_matmul=True),
                                  jnp.float32).apply({"params": qparams},
                                                     jnp.asarray(images)), np.float32)
    port = eva_vit.EvaViT(dataclasses.replace(eva_vit.vit_tiny_config(), int8_matmul=True))
    port.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, qparams)),
                         strict=True)
    with torch.no_grad():
        got = port(_t(images))
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    if route == "fused":
        assert len(fused) == cfg.depth and not linear and not attention
    else:
        assert not fused and len(linear) == 2 * cfg.depth and len(attention) == cfg.depth
    got = got.float().numpy().astype(np.float64)
    cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1)
                                  * np.linalg.norm(want, axis=-1))
    assert cos.min() >= 0.999
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert np.abs(got - want).max() / ulp <= 2


def test_split_int8_route_refuses_padded_tokens(monkeypatch):
    monkeypatch.setattr(eva_vit, "_PACKED_QKV_MAX_BYTES", 0)
    cfg = dataclasses.replace(eva_vit.vit_tiny_config(), int8_matmul=True)
    attn = eva_vit.ViTAttention(cfg)
    norm = ("ln", torch.ones(32), torch.zeros(32), 1e-6)
    with pytest.raises(NotImplementedError, match="padded tokens"):
        attn(torch.zeros(1, 8, 32, dtype=torch.bfloat16), norm=norm, n_valid=5)
    assert tint8.w8a8_linear.launches == 0


# -------------------------------------------------------------- greedy decode
@pytest.mark.parametrize("min_new,eos_boost", [(0, 0.0), (8, 3.0), (0, 3.0), (3, 1.5)])
def test_greedy_decode_with_scores_matches_jax(min_new, eos_boost):
    """Logits depend on the step, the fed token and a per-row cache; with
    the EOS boost rows finish early and must emit pad from then on."""
    batch, vocab, max_len, eos = 3, 13, 9, 1
    rng = np.random.default_rng(vocab + min_new)
    table = rng.standard_normal((max_len, vocab, vocab)).astype(np.float32) * 2.0
    table[:, :, eos] += eos_boost
    kw = dict(batch_size=batch, max_length=max_len, min_new_tokens=min_new,
              eos_token_id=eos, pad_token_id=0, decoder_start_token_id=0)

    def jax_step(cache, tokens, position):
        logits = jnp.asarray(table)[position][tokens[:, 0]] + 0.01 * cache
        return logits, cache + tokens.astype(jnp.float32)

    def torch_step(cache, tokens, position):
        logits = torch.from_numpy(table)[position][tokens[:, 0]] + 0.01 * cache
        return logits, cache + tokens.float()

    want_seqs, want_scores = jgen.greedy_decode_with_scores(
        jax_step, jnp.zeros((batch, 1), jnp.float32), vocab_size=vocab, **kw)
    got_seqs, got_scores = tgen.greedy_decode_with_scores(
        torch_step, torch.zeros(batch, 1), **kw)
    np.testing.assert_array_equal(got_seqs.numpy(), np.asarray(want_seqs))
    assert got_scores.shape == (max_len, batch, vocab) and got_scores.dtype == torch.float32
    np.testing.assert_allclose(got_scores.numpy(), np.asarray(want_scores), atol=1e-4)
    if eos_boost and not min_new:
        assert (got_seqs.numpy() == 0).any()  # a finished row emitted pad


# ------------------------------------------------------------ QA, tiny models
TINY = dict(img_size=28, vit_model="tiny", t5_model="tiny", num_beams=2,
            max_new_tokens=8, input_time_format="seconds_integers",
            compute_dtype="float32", num_frames_for_answer=2)
QA_TASKS = ("lora_QA_with_localizer", "lora_QA", "lora_QA_oracle_localizer")


def _qa_samples(b=3, t=6, img=28, seed=0, video_dtype="uint8"):
    rng = np.random.default_rng(seed)
    duration = [20.0, 30.0, 41.0][:b]
    video = (rng.integers(0, 256, (b, t, img, img, 3), dtype=np.uint8)
             if video_dtype == "uint8"
             else rng.standard_normal((b, t, img, img, 3)).astype(np.float32))
    options = "Option A: a cat. Option B: a dog. Option C: a bird. Option D: a fish. " \
              "Option E: a horse."
    return {
        "video": video,
        "timestamps": np.stack([np.linspace(0, d, t, endpoint=False) for d in duration]),
        "duration": np.array(duration),
        "question_id": [f"q{i}" for i in range(b)],
        "video_prompt_end": ["<extra_id_0>"] * b,
        "query_prompt": ["Query: what jumps?\n"] * b,
        "task_prompt": ["Given the video and the query, find the relevant "
                        "windows.\nRelevant windows: "] * b,
        "qa_input": [f"Question: what jumps? {options} Answer: "] * b,
        "qa_output": ["A", "C", "E"][:b],
        "relevant_windows": np.array([[[2.0, 9.0]], [[10.0, 29.0]], [[30.0, 35.0]]][:b]),
    }


@pytest.fixture(scope="module")
def qa_weights():
    """Both JAX parameter trees of a tiny QA model, every leaf redrawn from a
    numpy seed (so the LoRA deltas and the two T5 stacks all differ)."""
    jm = JaxBLIP2_MR(**TINY, task=QA_TASKS[0], scan_layers=False)
    return _redraw(jm.params, 21), _redraw(jm.answerer_params, 22)


def _pair(qa_weights, task, **kw):
    params, answerer = qa_weights
    jm = JaxBLIP2_MR(**dict(TINY, **kw), task=task, scan_layers=False, init_params=False)
    jm.params = jax.tree.map(jnp.asarray, params)
    jm.answerer_params = jax.tree.map(jnp.asarray, answerer)
    port = BLIP2_MR(**dict(TINY, **kw), task=task, init_params=False, device="cpu")
    port.load_state_dict(state_dict_from_jax(params, answerer), strict=True)
    return jm, port


def test_state_dict_from_jax_takes_the_answerer_tree(qa_weights):
    params, answerer = qa_weights
    sd = state_dict_from_jax(params, answerer)
    main = state_dict_from_jax(params)
    assert set(sd) - set(main) == {"answerer_" + k for k in main if k.startswith("t5.")}
    key = "t5.encoder.block.0.self_attention.q.lora_a"
    np.testing.assert_array_equal(
        sd["answerer_" + key].numpy(),
        answerer["t5"]["encoder"]["block_0"]["self_attention"]["q"]["lora_a"])
    assert not torch.equal(sd["answerer_" + key], sd[key])
    # A model of another task has no answerer to load it into.
    mr = BLIP2_MR(**TINY, task="lora", init_params=False, device="cpu")
    with pytest.raises(RuntimeError, match="answerer_t5"):
        mr.load_state_dict(sd, strict=True)
    mr.load_state_dict(main, strict=True)


def test_answer_ids_and_flags_match_jax(qa_weights):
    for task in QA_TASKS + ("lora",):
        jm = JaxBLIP2_MR(**TINY, task=task, scan_layers=False, init_params=False)
        port = BLIP2_MR(**TINY, task=task, init_params=False, device="cpu")
        assert port.answer_ids == jm.answer_ids and len(set(port.answer_ids)) == 5
        assert (port.is_qa, port.use_localizer, port.use_oracle_localizer) == (
            jm.is_qa, jm.use_localizer, jm.use_oracle_localizer)
        assert hasattr(port.module, "answerer_t5") is port.is_qa


def test_qa_encoder_input_matches_jax(qa_weights):
    jm, port = _pair(qa_weights, QA_TASKS[0])
    rng = np.random.default_rng(3)
    d = port.t5_config.d_model
    frames = rng.standard_normal((2, 6, d)).astype(np.float32)
    ids = rng.integers(2, 60, (2, 5))
    mask = np.array([[1, 1, 1, 1, 1], [1, 1, 1, 0, 0]])
    want_e, want_m = jm.module.apply(
        {"params": {**jm.params, "t5": jm.answerer_params["t5"]}},
        jnp.asarray(frames), jnp.asarray(ids), jnp.asarray(mask),
        method="qa_encoder_input")
    got_e, got_m = port.module.qa_encoder_input(_t(frames), _t(ids), _t(mask),
                                                t5=port.answerer)
    assert got_e.shape == (2, 16, d)  # 11 positions padded to a multiple of 8
    np.testing.assert_allclose(got_e.detach().numpy(), np.asarray(want_e), atol=1e-6)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    # The main T5's embedding gives another text part.
    other, _ = port.module.qa_encoder_input(_t(frames), _t(ids), _t(mask))
    assert not torch.allclose(other, got_e)


MOMENT_CASES = [
    ["[[2, 9]]", "[[10, 29]]", "[[30, 35]]"],
    ["[[-1, -1]]", "[[5, 99]]", "[[40, 45]]"],      # none; end past the duration
    ["[[9, 2]]", "[[0, 0]]", "[[12, 12], [1, 2]]"],  # start >= end; first window only
    ["garbage", "[[3.5, 7.25]]", "[[0, 41]]"],
]


@pytest.mark.parametrize("video_dtype", ["uint8", "float32"])
@pytest.mark.parametrize("n_frames", [2, 4, 9])
@pytest.mark.parametrize("moments", MOMENT_CASES)
def test_relevant_frames_match_jax(qa_weights, moments, n_frames, video_dtype):
    jm, port = _pair(qa_weights, QA_TASKS[0])
    samples = _qa_samples(video_dtype=video_dtype, seed=n_frames)
    want_m, want_f = jm.get_relevant_frames(samples, moments, n_frames)
    got_m, got_f = port.get_relevant_frames(samples, moments, n_frames)
    assert got_m == want_m
    assert got_f.dtype == want_f.dtype == np.dtype(video_dtype)
    assert got_f.shape == (3, n_frames, 28, 28, 3)
    np.testing.assert_array_equal(got_f, want_f)
    want_crop = jm.extract_frames(samples, want_m, n_frames)
    np.testing.assert_array_equal(port.extract_frames(samples, want_m, n_frames), want_crop)
    # Frames a loader put on the device are cropped as a tensor, where they lie.
    on_device = port.extract_frames(
        dict(samples, video=torch.from_numpy(samples["video"])), want_m, n_frames)
    assert isinstance(on_device, torch.Tensor)
    np.testing.assert_array_equal(on_device.numpy(), want_crop)


@pytest.mark.parametrize("video_dtype,b,seed", [("uint8", 3, 0), ("float32", 2, 1)])
@pytest.mark.parametrize("task", QA_TASKS)
def test_tiny_videoqa_generate_matches_jax(qa_weights, task, video_dtype, b, seed):
    """Predictions and moments identical; the answerer's step-1 A-E logits
    (what the prediction is the argmax of) within 1e-4."""
    jm, port = _pair(qa_weights, task)
    samples = _qa_samples(b=b, seed=seed, video_dtype=video_dtype)
    want = jm.videoQA_generate(samples)
    got = port.videoQA_generate(samples)
    assert got["output_text"] == want["output_text"]
    assert all(p in range(5) for p in got["output_text"])
    assert got["relevant_moments"] == want["relevant_moments"]
    assert got["qid"] == want["qid"] and list(got["answer"]) == list(want["answer"])
    # The JAX wrapper's own scores, through its jitted answerer.
    frames = np.asarray(samples["video"])  # relevant_frames were set on a copy
    handle = jm.videoQA_redecode(jm.videoQA_dispatch(samples))
    enc = jm.tokenizer(list(samples["qa_input"]), truncation=True,
                       max_length=jm.max_txt_len)
    seqs, scores = jm._jit_qa_answer(
        {**jm.params, "t5": jm.answerer_params["t5"]}, handle["frames"],
        enc.input_ids, enc.attention_mask, b, 8)
    want_logits = np.asarray(scores)[1][:, jm.answer_ids]
    assert set(got) == set(want)  # the JAX package's keys, no other
    got_seqs, got_scores = port._qa_answer_scores(
        dict(samples, relevant_frames=handle["frames"]))
    got_logits = got_scores[1][:, port.answer_ids].numpy()
    np.testing.assert_allclose(got_logits, want_logits, atol=1e-4)
    assert got_logits.shape == (b, 5) and frames.dtype == np.dtype(video_dtype)
    assert got["output_text"] == np.argmax(got_logits, axis=-1).tolist()
    np.testing.assert_array_equal(got_seqs.numpy(), np.asarray(seqs))
    np.testing.assert_allclose(got_scores.numpy(), np.asarray(scores), atol=1e-3)
    if task == QA_TASKS[2]:
        assert got["relevant_moments"] == [[[2.0, 9.0], [10.0, 29.0], [30.0, 35.0]][:b]]


def test_videoqa_three_steps_equal_generate(qa_weights):
    _, port = _pair(qa_weights, QA_TASKS[0])
    samples = _qa_samples()
    handle = port.videoQA_dispatch(samples)
    assert "loc" in handle and "question_id" in handle["samples"]
    handle = port.videoQA_redecode(handle)
    assert handle["frames"].shape == (3, 2, 28, 28, 3) and handle["frames"].dtype == np.uint8
    out = port.videoQA_collect(handle)
    whole = port.videoQA_generate(samples)
    assert out["output_text"] == whole["output_text"]
    assert out["relevant_moments"] == whole["relevant_moments"]
    assert "relevant_frames" not in samples  # the caller's dict is left alone
    assert not port.module.training


@pytest.mark.parametrize("task", QA_TASKS[:2])
def test_forward_qa_loss_matches_jax(qa_weights, task):
    jm, port = _pair(qa_weights, task)
    samples = _qa_samples(seed=2)
    want = float(jm.forward_QA(samples)["loss"])
    got = port(samples)["loss"]
    assert got.ndim == 0 and abs(float(got) - want) <= 1e-4


def test_forward_qa_gradients_reach_only_the_answerer_lora(qa_weights):
    """The JAX package's policy under a QA task: the main T5's LoRA tensors
    (and the Q-Former side unless ``qformer_freeze``) train, the answerer's
    never do (its tree is in no train state). So the answerer's loss
    (``forward_QA``) reaches no trainable tensor under
    ``qformer_freeze_lora_QA_with_localizer``, and only the Q-Former side
    under ``lora_QA``, where JAX's gradient of it is zero on every T5 leaf."""
    _, port = _pair(qa_weights, "qformer_freeze_lora_QA_with_localizer")
    mask = port.trainable_mask()
    trainable = {n for n, m in mask.items() if m}
    assert trainable and all(n.startswith("t5.") and "lora_" in n for n in trainable)
    assert len(trainable) == sum("lora_" in n and n.startswith("answerer_t5.")
                                 for n in mask)
    port.set_trainable()
    assert not port(_qa_samples(seed=2))["loss"].requires_grad
    # Without qformer_freeze the Q-Former side trains too, as in the JAX
    # policy, and the answerer's loss reaches it and no T5 tensor.
    _, unfrozen = _pair(qa_weights, "lora_QA")
    names = {n.split(".")[0] for n, m in unfrozen.trainable_mask().items() if m}
    assert names == {"t5", "qformer", "t5_proj", "ln_vision"}
    unfrozen.set_trainable()
    unfrozen(_qa_samples(seed=2))["loss"].backward()
    params = dict(unfrozen.module.named_parameters())
    with_grad = {n.split(".")[0] for n, p in params.items()
                 if p.grad is not None and float(p.grad.abs().max()) > 0}
    assert with_grad == {"qformer", "t5_proj", "ln_vision"}


def test_mr_generate_of_a_qa_model_is_the_localizer_s(qa_weights):
    """``generate`` of a QA model runs the main T5: equal to the JAX
    package's, whatever the answerer holds."""
    jm, port = _pair(qa_weights, QA_TASKS[0])
    samples = dict(_qa_samples(seed=4), query_id=["a", "b", "c"])
    samples["relevant_windows"] = ["[[0, 10]]"] * 3
    want, got = jm.generate(samples), port.generate(samples)
    assert got["raw_prediction"] == want["raw_prediction"]
    assert got["prediction"] == want["prediction"]


@pytest.mark.parametrize("task", [QA_TASKS[0], QA_TASKS[2]])
def test_resample_frames_redecodes_as_jax(qa_weights, task):
    """``resample_frames=True`` (once refused by the constructor): the
    answerer's frames are re-decoded from ``video_path`` inside the
    localizer's (or the oracle's) window, with the JAX package's moments,
    frames and answers."""
    jm, port = _pair(qa_weights, task, resample_frames=True)
    assert port.resample_frames and jm.resample_frames
    samples = dict(_qa_samples(seed=6), video_path=[
        f"synthetic://{int(d * 2)}x40x48@2.0#{i}" for i, d in enumerate((20.0, 30.0, 41.0))])
    handle = port.videoQA_redecode(port.videoQA_dispatch(samples))
    assert "pending" in handle
    moments = handle["moments"]
    want_m, want_f = jm.get_relevant_frames_resampled(samples, moments, 2)
    got = port.videoQA_collect(handle)
    assert handle["frames"].dtype == np.uint8 and handle["frames"].shape == (3, 2, 28, 28, 3)
    np.testing.assert_array_equal(handle["frames"], want_f)
    want = jm.videoQA_generate(samples)
    assert got["output_text"] == want["output_text"]
    assert [[float(x) for x in m] for m in got["relevant_moments"][0]] == [
        [float(x) for x in m] for m in want["relevant_moments"][0]]


def test_qa_crop_takes_frames_already_on_the_device(qa_weights):
    """Frames a PrefetchLoader put on the device (a tensor) give the answers
    and moments numpy frames give, when the answerer's frames are cropped
    from them (no ``resample_frames``)."""
    _, port = _pair(qa_weights, QA_TASKS[0])
    samples = _qa_samples(seed=7)
    want = port.videoQA_generate(samples)
    got = port.videoQA_generate(dict(samples, video=torch.from_numpy(samples["video"])))
    assert got["output_text"] == want["output_text"]
    assert got["relevant_moments"] == want["relevant_moments"]


def test_qa_model_quantizes_both_t5_stacks(qa_weights):
    """``quantize_for_inference`` converts the answerer's T5 with the main
    one, as the JAX wrapper does; the int8 QA pipeline then answers with the
    JAX package's letters on these samples."""
    jm, port = _pair(qa_weights, QA_TASKS[0])
    port.quantize_for_inference()
    jm.quantize_for_inference()
    want_sd = state_dict_from_jax(jax.tree.map(np.asarray, jm.params),
                                  jax.tree.map(np.asarray, jm.answerer_params))
    got_sd = port.state_dict()
    assert set(got_sd) == set(want_sd)
    for key, want in want_sd.items():
        if key.endswith("kernel_q"):
            assert torch.equal(got_sd[key], want), key
    cfg = port.t5_config
    assert cfg.int8_encoder and cfg.int8_decode and cfg.int8_cross_cache
    assert "answerer_t5.encoder.block.0.ff.wi_0.kernel_q" in got_sd
    samples = _qa_samples(seed=5)
    got = port.videoQA_generate(samples)
    assert all(p in range(5) for p in got["output_text"])
    _, scores = port._qa_answer_scores(dict(samples, relevant_frames=samples["video"]))
    assert np.isfinite(scores[1][:, port.answer_ids].numpy()).all()
