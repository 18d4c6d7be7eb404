"""The port's modules against the JAX package's, tiny configs, fp32, CPU.

Each JAX module is initialized, every parameter is redrawn from a numpy
seed (so zero-initialized leaves such as the EVA q/v biases and the LoRA B
matrices take part), converted with ``state_dict_from_jax`` and loaded
strictly into the port; both then run on the same numpy inputs. Tolerance
1e-4, the bar of the repo's torch parity tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from mr_blip_tpu.models import eva_vit as jvit
from mr_blip_tpu.models import qformer as jqf
from mr_blip_tpu.models import t5 as jt5
from mr_blip_tpu.models.blip2_mr import BLIP2_MR as JaxBLIP2_MR
from mr_blip_tpu.models.scan_utils import (
    stack_blip2_mr_params,
    unstack_blip2_mr_params,
)
from mr_blip_tpu_torch.models import eva_vit, qformer, t5
from mr_blip_tpu_torch.models.blip2_mr import BLIP2_MR
from mr_blip_tpu_torch.models.convert import state_dict_from_jax
from mr_blip_tpu_torch.models.generation import expand_to_beams

ATOL = 1e-4


def _redraw(params, seed):
    """Every leaf redrawn: norm scales near 1, everything else N(0, 0.1)."""
    rng = np.random.default_rng(seed)
    flat = traverse_util.flatten_dict(jax.tree.map(np.asarray, params))
    for key, leaf in flat.items():
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        flat[key] = 1.0 + 0.1 * noise if key[-1] == "scale" else 0.1 * noise
    return traverse_util.unflatten_dict(flat)


def _load(module, params):
    sd = state_dict_from_jax(params)
    assert len(sd) == len(jax.tree.leaves(params))  # every leaf consumed once
    module.load_state_dict(sd, strict=True)
    return module.eval()


def _t(a):
    return torch.from_numpy(np.array(a))


def test_eva_vit_matches_jax():
    cfg = jvit.vit_tiny_config()
    rng = np.random.default_rng(0)
    images = rng.standard_normal((3, 28, 28, 3)).astype(np.float32)
    jmod = jvit.EvaViT(cfg, jnp.float32)
    params = _redraw(jmod.init(jax.random.PRNGKey(0), jnp.asarray(images))["params"], 1)
    want = jmod.apply({"params": params}, jnp.asarray(images))
    port = _load(eva_vit.EvaViT(eva_vit.vit_tiny_config()), params)
    with torch.no_grad():
        got = port(_t(images))
    assert got.shape == (3, cfg.num_patches + 1, cfg.embed_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("n_tokens", [9, 257])
def test_qformer_matches_jax(n_tokens):
    cfg = jqf.qformer_tiny_config(32)
    rng = np.random.default_rng(1)
    states = rng.standard_normal((3, n_tokens, 32)).astype(np.float32)
    jmod = jqf.QFormer(cfg, jnp.float32)
    params = _redraw(jmod.init(jax.random.PRNGKey(0), jnp.asarray(states))["params"], 2)
    want = jmod.apply({"params": params}, jnp.asarray(states))
    port = _load(qformer.QFormer(qformer.qformer_tiny_config(32)), params)
    with torch.no_grad():
        got = port(_t(states))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def _t5_pair(seed=3, batch=2, enc_len=13, cache_len=6):
    jcfg = jt5.t5_tiny_config(vocab_size=64, lora_rank=8)
    jmod = jt5.T5ForConditionalGeneration(jcfg, jnp.float32, decode_cache_len=cache_len)
    rng = np.random.default_rng(seed)
    embeds = rng.standard_normal((batch, enc_len, jcfg.d_model)).astype(np.float32)
    mask = np.ones((batch, enc_len), np.int32)
    mask[1, enc_len - 4:] = 0
    ids = jnp.asarray(rng.integers(0, 64, (batch, 2)))
    params = _redraw(
        jmod.init(jax.random.PRNGKey(0), jnp.asarray(embeds), ids)["params"], seed + 1)
    port = _load(t5.T5ForConditionalGeneration(t5.t5_tiny_config(vocab_size=64,
                                                                 lora_rank=8)), params)
    return jcfg, jmod, params, port, embeds, mask


@pytest.mark.parametrize("cached_bias", [False, True])
def test_t5_encoder_matches_jax(cached_bias):
    jcfg, jmod, params, port, embeds, mask = _t5_pair()
    n = embeds.shape[1]
    bias_j = bias_t = None
    if cached_bias:
        table = params["encoder"]["rel_bias"]["rel_embedding"]
        bias_j = jt5.materialize_encoder_relpos_bias(jnp.asarray(table), n)
        bias_t = t5.materialize_encoder_relpos_bias(_t(table), n)
        np.testing.assert_array_equal(bias_t.numpy(), np.asarray(bias_j))
    want = jmod.apply({"params": params}, jnp.asarray(embeds), mask=jnp.asarray(mask),
                      position_bias=bias_j, method="encode")
    with torch.no_grad():
        got = port.encode(_t(embeds), _t(mask), position_bias=bias_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def _jax_cache(jmod, params, enc, rows):
    """The JAX decode cache as BLIP2_MR builds it: one pass creates the
    cross K/V, then the self-attention slots are zeroed."""
    _, vars0 = jmod.apply({"params": params}, jnp.zeros((rows, 1), jnp.int32), enc,
                          method="decode", decode=True,
                          decode_position=jnp.int32(0), mutable=["cache"])

    def zero_self(path, leaf):
        if any("cross_attention" in str(p) for p in path):
            return leaf
        return jnp.zeros_like(leaf)

    return jax.tree_util.tree_map_with_path(zero_self, vars0["cache"])


def test_t5_cached_decode_steps_match_jax():
    """Two cached decoder steps with beam-expanded rows (B=2, K=3) over
    encoder states at B rows, against the JAX decoder."""
    jcfg, jmod, params, port, embeds, mask = _t5_pair()
    beams, cache_len = 3, 6
    enc_j = jmod.apply({"params": params}, jnp.asarray(embeds),
                       mask=jnp.asarray(mask), method="encode")
    cache_j = _jax_cache(jmod, params, enc_j, 2 * beams)
    with torch.no_grad():
        enc_t = port.encode(_t(embeds), _t(mask))
        cross_kv = port.decoder.cross_kv(enc_t)
        cache_t = port.decoder.init_cache(2 * beams, cache_len, torch.float32, "cpu")
    rng = np.random.default_rng(9)
    for position in range(2):
        tokens = rng.integers(0, 64, (2 * beams, 1)).astype(np.int32)
        want, upd = jmod.apply(
            {"params": params, "cache": cache_j}, jnp.asarray(tokens), enc_j,
            encoder_mask=jnp.asarray(mask), method="decode", decode=True,
            decode_position=jnp.int32(position), mutable=["cache"])
        cache_j = upd["cache"]
        with torch.no_grad():
            got = port.decode_step(_t(tokens), position, cache_t, cross_kv, _t(mask))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_beam_folded_cross_attention_matches_expanded():
    """Cross K/V kept at B rows (queries of the K beams folded into the
    length) equals K/V expanded to B*K rows: the sqrt(d_kv) pre-scale must
    hold on the folded path."""
    _, _, _, port, embeds, mask = _t5_pair(seed=5)
    beams = 4
    rng = np.random.default_rng(11)
    tokens = _t(rng.integers(0, 64, (2 * beams, 1)))
    with torch.no_grad():
        enc = port.encode(_t(embeds), _t(mask))
        folded = port.decode_step(
            tokens, 0, port.decoder.init_cache(2 * beams, 4, torch.float32, "cpu"),
            port.decoder.cross_kv(enc), _t(mask))
        expanded = port.decode_step(
            tokens, 0, port.decoder.init_cache(2 * beams, 4, torch.float32, "cpu"),
            port.decoder.cross_kv(expand_to_beams(enc, beams)),
            expand_to_beams(_t(mask), beams))
    np.testing.assert_allclose(folded.numpy(), expanded.numpy(), atol=1e-5)


def _tiny_pair(seed=0):
    kw = dict(img_size=28, vit_model="tiny", t5_model="tiny", num_beams=2,
              max_new_tokens=8, task="lora", compute_dtype="float32")
    jm = JaxBLIP2_MR(**kw)
    params = _redraw(unstack_blip2_mr_params(jm.params), seed)
    port = BLIP2_MR(**kw, device="cpu", init_params=False)
    port.load_state_dict(state_dict_from_jax(params))
    return jm, params, port


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_encode_frames_matches_jax(dtype):
    """ViT -> ln_vision -> Q-Former -> t5_proj, with the uint8 frames
    CLIP-normalized on the device side."""
    jm, params, port = _tiny_pair(seed=6)
    rng = np.random.default_rng(12)
    if dtype == "uint8":
        frames = rng.integers(0, 256, (2, 3, 28, 28, 3), dtype=np.uint8)
    else:
        frames = rng.standard_normal((2, 3, 28, 28, 3)).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, stack_blip2_mr_params(params))
    want = jm.module.apply({"params": jparams}, jnp.asarray(frames),
                           method="encode_frames")
    with torch.no_grad():
        got = port.module.encode_frames(_t(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_converter_consumes_every_leaf_and_rejects_unknown():
    _, params, port = _tiny_pair()
    sd = state_dict_from_jax(params)
    assert len(sd) == len(jax.tree.leaves(params)) == len(port.state_dict())
    params["t5_proj"]["Dense_0"]["kernel_q"] = np.zeros((2, 2), np.int8)
    with pytest.raises(ValueError, match="kernel_q"):
        state_dict_from_jax(params)


def test_init_params_draws_like_init_params_fast():
    """The port's random init follows the JAX wrapper's
    ``init_params_fast(mode="random")`` in the unscanned layout: the same
    tensors are ones, every other tensor is N(0, 0.02), from the seed."""
    kw = dict(img_size=28, vit_model="tiny", t5_model="tiny", num_beams=2,
              max_new_tokens=8, task="lora", compute_dtype="float32")
    jm = JaxBLIP2_MR(**kw, scan_layers=False, init_params=False)
    fast = jm.init_params_fast(jax.random.PRNGKey(0), dtype=jnp.float32)
    want = state_dict_from_jax(unstack_blip2_mr_params(fast))
    port = BLIP2_MR(**kw, device="cpu", seed=3)
    got = port.state_dict()
    assert got.keys() == want.keys()
    for key, w in want.items():
        g = got[key]
        assert g.shape == w.shape, key
        if bool((w == 1).all()):
            assert bool((g == 1).all()), key
        else:
            assert not bool((g == 1).any()), key
    drawn = torch.cat([g.flatten() for key, g in got.items()
                       if not bool((want[key] == 1).all())])
    assert abs(float(drawn.mean())) < 1e-3
    assert abs(float(drawn.std()) - 0.02) < 1e-3
    again = BLIP2_MR(**kw, device="cpu", seed=3).state_dict()
    assert all(torch.equal(again[k], got[k]) for k in got)
