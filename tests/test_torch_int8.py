"""The port's int8 inference path against the JAX package's, on the CPU.

The four W8A8 functions' plain versions against the JAX kernel bodies run
in Pallas interpret mode (bar: 2 bf16 ulps; the per-row int8 values and
scales bit-equal), the quantizers against the JAX ones on the same float
weights (int8 bit-equal, scales to 1 fp32 ulp), the int8 modules against the
JAX modules, and ``quantize_for_inference().generate`` as a whole.

The JAX modules reach ``w8a8_linear`` / ``w8a8_mlp`` / ``w8a8_mlp_gated``
without ``interpret``, which off the TPU takes their jnp references; those
round to bf16 before the residual add, the kernels after. The port follows
the kernels, so the ``interpreted`` fixture makes the JAX modules run the
kernel bodies in interpret mode. The JAX models are built unscanned
(``scan_layers=False``): the scanned int8 stacks round their input to bf16
first, the unrolled ones and the port do not.
"""

import dataclasses
import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

import mr_blip_tpu.ops.int8_matmul as jint8
from mr_blip_tpu.models import eva_vit as jvit
from mr_blip_tpu.models import qformer as jqf
from mr_blip_tpu.models import quantize as jquant
from mr_blip_tpu.models import t5 as jt5
from mr_blip_tpu.models.blip2_mr import BLIP2_MR as JaxBLIP2_MR
from mr_blip_tpu_torch.models import eva_vit, layers, qformer, t5
from mr_blip_tpu_torch.models import quantize as tquant
from mr_blip_tpu_torch.models.blip2_mr import BLIP2_MR
from mr_blip_tpu_torch.models.convert import state_dict_from_jax
from mr_blip_tpu_torch.ops import int8_matmul as tint8

ULPS = 2  # bf16 ulps between a plain version and the JAX kernel body


@pytest.fixture
def interpreted(monkeypatch):
    """The JAX modules' W8A8 calls run the Pallas kernel bodies (interpret
    mode) instead of the off-TPU jnp references."""
    for name in ("w8a8_linear", "w8a8_mlp", "w8a8_mlp_gated"):
        monkeypatch.setattr(
            jint8, name, functools.partial(getattr(jint8, name), interpret=True))


def _t(a):
    return torch.from_numpy(np.array(a))


def _bf(a):
    return _t(np.asarray(a, np.float32)).to(torch.bfloat16)


def _ordered(bits):
    """bf16 bit patterns (sign-magnitude) -> integers in value order."""
    return torch.where(bits < 0, -(bits & 0x7FFF), bits)


def _ulps(got: torch.Tensor, want) -> int:
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert tuple(got.shape) == tuple(want.shape)
    g = _ordered(got.contiguous().view(torch.int16).int())
    w = _ordered(_bf(want).view(torch.int16).int())
    return int((g - w).abs().max())


def _qw(rng, k, n, scale=0.1):
    w = rng.standard_normal((k, n)).astype(np.float32) * scale
    s = (np.maximum(np.abs(w).max(0), 1e-8) / 127.0).astype(np.float32)
    return np.clip(np.round(w / s), -127, 127).astype(np.int8), s


def _norm_pair(kind, rng, k):
    if kind is None:
        return None, None
    ls = (1 + 0.1 * rng.standard_normal(k)).astype(np.float32)
    lb = (0.1 * rng.standard_normal(k)).astype(np.float32) if kind == "ln" else None
    jn = (kind, jnp.asarray(ls), None if lb is None else jnp.asarray(lb), 1e-6)
    tn = (kind, _t(ls), None if lb is None else _t(lb), 1e-6)
    return jn, tn


def _redraw(params, seed, std=0.1):
    rng = np.random.default_rng(seed)
    flat = traverse_util.flatten_dict(jax.tree.map(np.asarray, params))
    for key, leaf in flat.items():
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        flat[key] = 1.0 + 0.1 * noise if key[-1] == "scale" else std * noise
    return traverse_util.unflatten_dict(flat)


def _cosine_rows(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    num = (got * want).sum(-1)
    return num / (np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))


def _max_diff_in_ulps_of_max(got, want) -> float:
    """max |got - want| in bf16 ulps of the largest |want|: the bar for a
    whole module, where an element near zero has an ulp of its own far
    below the rounding steps upstream."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    return float(np.abs(got - want).max() / ulp)


# ------------------------------------------------- plain versions vs kernels
def test_pick_block_copy_matches():
    for n in (64, 128, 640, 1280, 2048, 5120, 6144, 6145, 10240):
        for default in (640, 1408, 1536):
            assert tint8._pick_block(n, default) == jint8._pick_block(n, default)
    assert tint8._pick_block(6144, 1536) == 1536
    assert tint8._pick_block(5120, 640) == 640


def test_quant_rows_bit_equal():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((33, 96)).astype(np.float32) * 3
    x[5] = 0.0  # the 1e-6 floor of the scale
    x[7, :4] = [0.5, 1.5, 2.5, -2.5]  # ties after the division round to even
    x[7, 4] = 127.0
    x[7, 5:] = 0.0
    qj, sj = jint8._quant_rows(jnp.asarray(x))
    qt, st = tint8._quant_rows(_t(x))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert qt[7, :5].tolist() == [0, 2, 2, -2, 127]


@pytest.mark.parametrize("norm", [None, "ln", "rms"])
@pytest.mark.parametrize("has_bias,has_residual", [(True, True), (False, False),
                                                   (True, False)])
def test_w8a8_linear_matches_jax_kernel(norm, has_bias, has_residual):
    rng = np.random.default_rng(1)
    m, k, n = 37, 64, 256  # ragged M against block_m 16, two N blocks
    x = jnp.asarray(rng.standard_normal((m, k)), jnp.bfloat16)
    wq, sw = _qw(rng, k, n)
    bias = rng.standard_normal(n).astype(np.float32) if has_bias else None
    res = (jnp.asarray(rng.standard_normal((m, n)), jnp.bfloat16)
           if has_residual else None)
    jn, tn = _norm_pair(norm, rng, k)
    want = jint8.w8a8_linear(
        x, jnp.asarray(wq), jnp.asarray(sw), None if bias is None else jnp.asarray(bias),
        norm=jn, residual=res, block_m=16, block_n=128, interpret=True)
    got = tint8.w8a8_linear(_bf(x), _t(wq), _t(sw), None if bias is None else _t(bias),
                            norm=tn, residual=None if res is None else _bf(res))
    assert _ulps(got, want) <= ULPS


@pytest.mark.parametrize("norm", [None, "ln"])
@pytest.mark.parametrize("has_residual", [True, False])
def test_w8a8_mlp_matches_jax_kernel(norm, has_residual):
    rng = np.random.default_rng(2)
    m, d, h = 21, 64, 384  # three hidden chunks of 128
    x = jnp.asarray(rng.standard_normal((m, d)), jnp.bfloat16)
    w1q, s1 = _qw(rng, d, h)
    w2q, s2 = _qw(rng, h, d)
    b1 = (0.1 * rng.standard_normal(h)).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(d)).astype(np.float32)
    res = jnp.asarray(rng.standard_normal((m, d)), jnp.bfloat16) if has_residual else None
    jn, tn = _norm_pair(norm, rng, d)
    weights = (w1q, s1, b1, w2q, s2, b2)
    want = jint8.w8a8_mlp(x, *map(jnp.asarray, weights), norm=jn, residual=res,
                          block_m=16, block_h=128, interpret=True)
    got = tint8.w8a8_mlp(_bf(x), *map(_t, weights), norm=tn,
                         residual=None if res is None else _bf(res), block_h=128)
    assert _ulps(got, want) <= ULPS


@pytest.mark.parametrize("norm", [None, "rms"])
@pytest.mark.parametrize("has_residual", [True, False])
def test_w8a8_mlp_gated_matches_jax_kernel(norm, has_residual):
    rng = np.random.default_rng(3)
    m, d, h = 19, 64, 256  # two hidden chunks of 128
    x = jnp.asarray(rng.standard_normal((m, d)), jnp.bfloat16)
    w0q, s0 = _qw(rng, d, h)
    w1q, s1 = _qw(rng, d, h)
    woq, so = _qw(rng, h, d)
    res = jnp.asarray(rng.standard_normal((m, d)), jnp.bfloat16) if has_residual else None
    jn, tn = _norm_pair(norm, rng, d)
    weights = (w0q, s0, w1q, s1, woq, so)
    want = jint8.w8a8_mlp_gated(x, *map(jnp.asarray, weights), norm=jn, residual=res,
                                block_m=16, block_h=128, interpret=True)
    got = tint8.w8a8_mlp_gated(_bf(x), *map(_t, weights), norm=tn,
                               residual=None if res is None else _bf(res), block_h=128)
    assert _ulps(got, want) <= ULPS


def _attn_block_case(seed, b=2, n=16, c=64, garbage=None, n_valid=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n, c)).astype(np.float32)
    if garbage is not None:
        x[:, n_valid:] = garbage
    wqkv, sqkv = _qw(rng, c, 3 * c)
    wproj, sproj = _qw(rng, c, c)
    qb = (0.1 * rng.standard_normal(3 * c)).astype(np.float32)
    qb[c:2 * c] = 0.0  # the k bias is identically zero
    pb = (0.1 * rng.standard_normal(c)).astype(np.float32)
    jn, tn = _norm_pair("ln", rng, c)
    return jnp.asarray(x, jnp.bfloat16), (wqkv, sqkv, qb, wproj, sproj, pb), jn, tn


@pytest.mark.parametrize("n_valid", [0, 13])
def test_w8a8_attn_block_matches_jax_kernel(n_valid):
    """With ``n_valid`` 13 of 16 the pad rows hold large garbage, which must
    neither reach the valid rows nor differ from the JAX kernel's own. (The
    two frameworks sum p·v in other orders; with some seeds that moves one
    attention output by a bf16 ulp across a requantization step, and one
    row of the output by more than the bar. This seed has no such tie.)"""
    x, weights, jn, tn = _attn_block_case(6, garbage=300.0, n_valid=n_valid)
    want = jint8.w8a8_attn_block(x, *map(jnp.asarray, weights), norm=jn, num_heads=4,
                                 n_valid=n_valid, interpret=True)
    got = tint8.w8a8_attn_block(_bf(x), *map(_t, weights), norm=tn, num_heads=4,
                                n_valid=n_valid)
    valid = n_valid or x.shape[1]
    assert _ulps(got[:, :valid], want[:, :valid]) <= ULPS
    if n_valid:
        other, *_ = _attn_block_case(6, garbage=-7e3, n_valid=n_valid)
        moved = tint8.w8a8_attn_block(_bf(other), *map(_t, weights), norm=tn,
                                      num_heads=4, n_valid=n_valid)
        assert torch.equal(moved[:, :n_valid], got[:, :n_valid])


def test_w8a8_attn_block_follows_kernel_not_reference():
    """The kernel scales q by bf16(D^-1/2) in bf16; the JAX off-TPU reference
    scales in fp32. At head dim 88 (D^-1/2 is not a bf16 number) the two
    differ, and the plain version must side with the kernel."""
    x, weights, jn, tn = _attn_block_case(5, b=1, n=8, c=176)
    kernel = jint8.w8a8_attn_block(x, *map(jnp.asarray, weights), norm=jn, num_heads=2,
                                   interpret=True)
    got = tint8.w8a8_attn_block(_bf(x), *map(_t, weights), norm=tn, num_heads=2)
    assert _ulps(got, kernel) <= ULPS


def test_wrappers_refuse_grad_and_bad_norm():
    rng = np.random.default_rng(6)
    wq, sw = _qw(rng, 32, 32)
    x = torch.randn(4, 32, dtype=torch.bfloat16, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward only"):
        tint8.w8a8_linear(x, _t(wq), _t(sw))
    with pytest.raises(RuntimeError, match="forward only"):
        tint8.w8a8_mlp(x, _t(wq), _t(sw), torch.zeros(32), _t(wq), _t(sw), torch.zeros(32))
    with pytest.raises(RuntimeError, match="forward only"):
        tint8.w8a8_mlp_gated(x, _t(wq), _t(sw), _t(wq), _t(sw), _t(wq), _t(sw))
    with pytest.raises(RuntimeError, match="forward only"):
        tint8.w8a8_attn_block(
            torch.randn(1, 4, 32, dtype=torch.bfloat16, requires_grad=True),
            *map(_t, _qw(rng, 32, 96)), None, _t(wq), _t(sw), None,
            norm=("ln", torch.ones(32), torch.zeros(32), 1e-6), num_heads=2)
    with torch.no_grad():  # no graph is built: the same call goes through
        assert tint8.w8a8_linear(x, _t(wq), _t(sw)).shape == (4, 32)
    with pytest.raises(ValueError, match="norm kind"):
        tint8.w8a8_linear(x.detach(), _t(wq), _t(sw),
                          norm=("batch", torch.ones(32), None, 1e-6))
    with pytest.raises(ValueError, match="LayerNorm"):
        tint8.w8a8_attn_block(x.detach()[None], *map(_t, _qw(rng, 32, 96)), None, _t(wq),
                              _t(sw), None, norm=("rms", torch.ones(32), None, 1e-6),
                              num_heads=2)


def test_kernel_layout_survives_module_moves():
    """``kernel_q`` is (in, out) with the input axis contiguous, and stays so
    through ``load_state_dict`` and ``Module.to``."""
    holder = layers.QDenseParams(48, 16)
    assert holder.kernel_q.shape == (48, 16) and holder.kernel_q.stride() == (1, 48)
    q = torch.arange(48 * 16, dtype=torch.int32).remainder(120).to(torch.int8).reshape(48, 16)
    holder.load_state_dict({"kernel_q": q, "kernel_scale": torch.ones(16),
                            "bias": torch.zeros(16)})
    holder = holder.to(torch.device("cpu"))
    assert holder.kernel_q.stride() == (1, 48) and torch.equal(holder.kernel_q, q)
    assert tint8.k_major(q).stride() == (1, 48) and torch.equal(tint8.k_major(q), q)


# ------------------------------------------------------------- quantizers
def _assert_quantized_equal(got_sd, want_sd):
    """int8 tensors bit-equal and in the kernels' layout, scales within one
    fp32 ulp, everything else equal."""
    assert got_sd.keys() == want_sd.keys()
    for key, want in want_sd.items():
        got = got_sd[key]
        assert got.shape == want.shape and got.dtype == want.dtype, key
        if key.endswith("kernel_q"):
            assert got.dtype == torch.int8 and got.stride() == (1, got.shape[0]), key
            assert torch.equal(got, want), key
        elif key.endswith("kernel_scale"):
            ulp = torch.abs(torch.nextafter(want, want + 1) - want)
            assert bool(((got - want).abs() <= ulp).all()), key
        else:
            assert torch.equal(got, want), key


def _jax_sd(tree):
    return state_dict_from_jax(jax.tree.map(np.asarray, tree))


def _vit_params(seed=1):
    cfg = jvit.vit_tiny_config()
    images = np.random.default_rng(0).standard_normal((3, 28, 28, 3)).astype(np.float32)
    jmod = jvit.EvaViT(cfg, jnp.float32)
    params = _redraw(jmod.init(jax.random.PRNGKey(0), jnp.asarray(images))["params"], seed)
    return cfg, params, images


def _qformer_params(seed=2, n_tokens=9):
    cfg = jqf.qformer_tiny_config(32)
    states = np.random.default_rng(1).standard_normal((3, n_tokens, 32)).astype(np.float32)
    jmod = jqf.QFormer(cfg, jnp.float32)
    params = _redraw(jmod.init(jax.random.PRNGKey(0), jnp.asarray(states))["params"], seed)
    return cfg, params, states


def _t5_params(seed=4, batch=2, enc_len=13, cache_len=6):
    cfg = jt5.t5_tiny_config(vocab_size=64, lora_rank=8)
    jmod = jt5.T5ForConditionalGeneration(cfg, jnp.float32, decode_cache_len=cache_len)
    rng = np.random.default_rng(3)
    embeds = rng.standard_normal((batch, enc_len, cfg.d_model)).astype(np.float32)
    mask = np.ones((batch, enc_len), np.int32)
    mask[1, enc_len - 4:] = 0
    ids = jnp.asarray(rng.integers(0, 64, (batch, 2)))
    params = _redraw(jmod.init(jax.random.PRNGKey(0), jnp.asarray(embeds), ids)["params"],
                     seed)
    return cfg, params, embeds, mask


def test_quantize_vit_params_matches_jax():
    _, params, _ = _vit_params()
    got = tquant.quantize_vit_params(_jax_sd(params))
    want = _jax_sd(jquant.quantize_vit_params(params))
    _assert_quantized_equal(got, want)
    assert "blocks.0.attn.qkv.kernel_q" in got and "blocks.1.mlp.fc2.bias" in got
    assert "blocks.0.attn.qkv.weight" not in got and "patch_embed.weight" in got
    port = eva_vit.EvaViT(dataclasses.replace(eva_vit.vit_tiny_config(), int8_matmul=True))
    port.load_state_dict(want, strict=True)


def test_quantize_qformer_cross_params_matches_jax():
    _, params, _ = _qformer_params()
    got = tquant.quantize_qformer_cross_params(_jax_sd(params))
    want = _jax_sd(jquant.quantize_qformer_cross_params(params))
    _assert_quantized_equal(got, want)
    packed = got["layer.0.cross_attention.kv_packed.kernel_q"]
    assert packed.shape == (32, 64)  # key columns, then value columns
    assert got["layer.0.cross_attention.kv_packed.bias"].shape == (64,)
    assert "layer.0.cross_attention.key.weight" not in got
    assert "layer.0.self_attention.key.weight" in got  # self-attention stays float
    port = qformer.QFormer(dataclasses.replace(qformer.qformer_tiny_config(32),
                                               int8_cross=True))
    port.load_state_dict(want, strict=True)


def test_quantize_t5_encoder_params_matches_jax_and_merges_lora():
    _, params, _, _ = _t5_params()
    float_sd = _jax_sd(params)
    got = tquant.quantize_t5_encoder_params(float_sd, lora_alpha=8.0)
    want = _jax_sd(jquant.quantize_t5_encoder_params(params, lora_alpha=8.0))
    _assert_quantized_equal(got, want)
    attn = "encoder.block.0.self_attention."
    assert got[attn + "qkv_packed.kernel_q"].shape == (32, 96)
    assert not any("lora" in k for k in got if k.startswith("encoder."))
    assert any("lora" in k for k in got if k.startswith("decoder."))
    # The packed q columns are the quantized merged weight, not the base one.
    merged = (float_sd[attn + "q.weight"].t()
              + float_sd[attn + "q.lora_a"] @ float_sd[attn + "q.lora_b"] * (8.0 / 8))
    dequant = (got[attn + "qkv_packed.kernel_q"].float()
               * got[attn + "qkv_packed.kernel_scale"])[:, :32]
    assert float((dequant - merged).abs().max()) <= float(merged.abs().max()) / 127
    base_err = float((dequant - float_sd[attn + "q.weight"].t()).abs().max())
    assert base_err > float(merged.abs().max()) / 127
    port = t5.T5ForConditionalGeneration(
        t5.t5_tiny_config(vocab_size=64, lora_rank=8, int8_encoder=True))
    port.load_state_dict(want, strict=True)


def test_quantize_t5_decoder_params_matches_jax():
    _, params, _, _ = _t5_params()
    got = tquant.quantize_t5_decoder_params(_jax_sd(params))
    want = _jax_sd(jquant.quantize_t5_decoder_params(params))
    _assert_quantized_equal(got, want)
    assert "lm_head.kernel_q" in got and "lm_head.lora_a" in got
    assert "decoder.block.1.cross_attention.k.kernel_q" in got
    assert "encoder.block.0.self_attention.q.weight" in got  # encoder untouched
    port = t5.T5ForConditionalGeneration(
        t5.t5_tiny_config(vocab_size=64, lora_rank=8, int8_decode=True,
                          int8_cross_cache=True))
    port.load_state_dict(want, strict=True)


def test_quantizers_take_bf16_stored_weights():
    """Frozen weights are stored in bf16 on the card: the quantizers upcast
    and give what the fp32 copy of the same values gives."""
    _, params, _ = _vit_params()
    sd = {k: v.to(torch.bfloat16) for k, v in _jax_sd(params).items()}
    got = tquant.quantize_vit_params(sd)
    want = tquant.quantize_vit_params({k: v.float() for k, v in sd.items()})
    for key in want:
        if key.endswith(("kernel_q", "kernel_scale")):
            assert torch.equal(got[key], want[key]), key
    assert got["blocks.0.attn.proj.bias"].dtype == torch.float32


# ---------------------------------------------------------------- modules
def test_quantized_dense_matches_jax():
    from mr_blip_tpu.models.layers import Dense as JDense

    rng = np.random.default_rng(7)
    x = rng.standard_normal((5, 24)).astype(np.float32)
    wq, sw = _qw(rng, 24, 40)
    tree = {"kernel_q": wq, "kernel_scale": sw,
            "bias": rng.standard_normal(40).astype(np.float32),
            "lora_a": 0.1 * rng.standard_normal((24, 8)).astype(np.float32),
            "lora_b": 0.1 * rng.standard_normal((8, 40)).astype(np.float32)}
    want = JDense(40, compute_dtype=jnp.float32, lora_rank=8, quantize=True).apply(
        {"params": jax.tree.map(jnp.asarray, tree)}, jnp.asarray(x))
    port = layers.Dense(24, 40, lora_rank=8, quantize=True)
    port.load_state_dict(_jax_sd(tree), strict=True)
    assert "weight" not in port.state_dict()
    assert not any(n.startswith("kernel") for n, _ in port.named_parameters())
    with torch.no_grad():
        got = port(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_int8_eva_vit_matches_jax(interpreted):
    """The JAX ViT on the CPU runs the unfused chain (``w8a8_linear`` ->
    attention -> ``w8a8_linear``, padded to 8 tokens with ``n_valid``), the
    port the fused block's plain version, unpadded: bars cosine >= 0.999 per
    token and 2 bf16 ulps at the output's largest magnitude."""
    cfg, params, images = _vit_params()
    qparams = jquant.quantize_vit_params(params)
    want = jvit.EvaViT(dataclasses.replace(cfg, int8_matmul=True), jnp.float32).apply(
        {"params": qparams}, jnp.asarray(images))
    port = eva_vit.EvaViT(dataclasses.replace(eva_vit.vit_tiny_config(), int8_matmul=True))
    port.load_state_dict(_jax_sd(qparams), strict=True)
    with torch.no_grad():
        got = port(_t(images))
    assert got.dtype == torch.bfloat16 and got.shape == (3, cfg.num_patches + 1, 32)
    want = np.asarray(want, np.float32)
    assert _cosine_rows(got.float().numpy(), want).min() >= 0.999
    assert _max_diff_in_ulps_of_max(got.float().numpy(), want) <= 2


@pytest.mark.parametrize("states_dtype", ["float32", "bfloat16"])
def test_int8_qformer_matches_jax(interpreted, states_dtype):
    """bf16 states are what the int8 ViT hands over under any compute dtype;
    the query stream must stay in the compute dtype (fp32 here)."""
    cfg, params, states = _qformer_params()
    qparams = jquant.quantize_qformer_cross_params(params)
    states_j = jnp.asarray(states, jnp.dtype(states_dtype))
    want = jqf.QFormer(dataclasses.replace(cfg, int8_cross=True), jnp.float32).apply(
        {"params": qparams}, states_j)
    port = qformer.QFormer(dataclasses.replace(qformer.qformer_tiny_config(32),
                                               int8_cross=True)).eval()
    port.load_state_dict(_jax_sd(qparams), strict=True)
    with torch.no_grad():
        got = port(_t(np.asarray(states_j, np.float32)).to(getattr(torch, states_dtype)))
    assert got.dtype == torch.float32
    # bf16 K/V and probabilities: the two frameworks sum p·v in other orders.
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), atol=2e-3)


def test_int8_t5_encoder_matches_jax(interpreted):
    cfg, params, embeds, mask = _t5_params()
    qparams = jquant.quantize_t5_encoder_params(params)
    jmod = jt5.T5ForConditionalGeneration(
        dataclasses.replace(cfg, int8_encoder=True), jnp.float32, decode_cache_len=6)
    want = jmod.apply({"params": qparams}, jnp.asarray(embeds), mask=jnp.asarray(mask),
                      method="encode")
    port = t5.T5ForConditionalGeneration(
        t5.t5_tiny_config(vocab_size=64, lora_rank=8, int8_encoder=True)).eval()
    port.load_state_dict(_jax_sd(qparams), strict=True)
    with torch.no_grad():
        got = port.encode(_t(embeds), _t(mask))
    # The W8A8 blocks emit bf16; the final norm keeps it.
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    # Two blocks, each within 2 bf16 ulps of the residual stream's scale.
    assert _max_diff_in_ulps_of_max(got.float().numpy(), np.asarray(want, np.float32)) <= 4
    assert _cosine_rows(got.float().numpy(), np.asarray(want, np.float32)).min() >= 0.9999
    port.train()
    with pytest.raises(RuntimeError, match="inference"):
        port.encode(_t(embeds), _t(mask))


def test_int8_decoder_and_cross_cache_match_jax():
    """Weight-only int8 decoder with the int8 cross-attention cache: the
    cache's int8 tensors and scales, and two beam-expanded cached steps."""
    cfg, params, embeds, mask = _t5_params()
    beams, cache_len = 3, 6
    qparams = jquant.quantize_t5_decoder_params(params)
    jcfg = dataclasses.replace(cfg, int8_decode=True, int8_cross_cache=True)
    jmod = jt5.T5ForConditionalGeneration(jcfg, jnp.float32, decode_cache_len=cache_len)
    enc_j = jmod.apply({"params": qparams}, jnp.asarray(embeds), mask=jnp.asarray(mask),
                       method="encode")
    _, vars0 = jmod.apply({"params": qparams}, jnp.zeros((2 * beams, 1), jnp.int32), enc_j,
                          method="decode", decode=True, decode_position=jnp.int32(0),
                          mutable=["cache"])
    cache_j = jax.tree_util.tree_map_with_path(
        lambda path, leaf: leaf if any("cross_attention" in str(p) for p in path)
        else jnp.zeros_like(leaf), vars0["cache"])
    port = t5.T5ForConditionalGeneration(t5.t5_tiny_config(
        vocab_size=64, lora_rank=8, int8_decode=True, int8_cross_cache=True)).eval()
    port.load_state_dict(_jax_sd(qparams), strict=True)
    with torch.no_grad():
        enc_t = port.encode(_t(embeds), _t(mask))
        cross_kv = port.decoder.cross_kv(enc_t)
        cache_t = port.decoder.init_cache(2 * beams, cache_len, torch.float32, "cpu")
    np.testing.assert_allclose(enc_t.numpy(), np.asarray(enc_j), atol=1e-4)
    for i, (k, v, k_scale, v_scale) in enumerate(cross_kv):
        want = cache_j["decoder"][f"block_{i}"]["cross_attention"]
        assert k.dtype == torch.int8 and v.dtype == torch.int8
        assert k_scale.shape == (2, 1, 32)  # per (batch row, channel)
        np.testing.assert_array_equal(k.numpy(), np.asarray(want["cached_key"]))
        np.testing.assert_array_equal(v.numpy(), np.asarray(want["cached_value"]))
        np.testing.assert_allclose(k_scale.numpy(), np.asarray(want["cached_key_scale"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(v_scale.numpy(), np.asarray(want["cached_value_scale"]),
                                   rtol=1e-6)
    rng = np.random.default_rng(9)
    for position in range(2):
        tokens = rng.integers(0, 64, (2 * beams, 1)).astype(np.int32)
        want, upd = jmod.apply(
            {"params": qparams, "cache": cache_j}, jnp.asarray(tokens), enc_j,
            encoder_mask=jnp.asarray(mask), method="decode", decode=True,
            decode_position=jnp.int32(position), mutable=["cache"])
        cache_j = upd["cache"]
        with torch.no_grad():
            got = port.decode_step(_t(tokens), position, cache_t, cross_kv, _t(mask))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


# ------------------------------------------------------- the slice as a whole
def _samples(video_dtype, b, seed, t=4, img=28):
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


TINY = dict(img_size=28, vit_model="tiny", t5_model="tiny", num_beams=2,
            max_new_tokens=8, task="lora", input_time_format="seconds_integers",
            compute_dtype="float32")


@pytest.fixture(scope="module")
def tiny_float():
    """The JAX wrapper (unscanned) with every leaf redrawn from a numpy seed,
    and the port's float state_dict of the same weights."""
    jm = JaxBLIP2_MR(**TINY, scan_layers=False)
    params = _redraw(jm.params, 21)
    jm.params = jax.tree.map(jnp.asarray, params)
    return jm, state_dict_from_jax(params)


def _port(state_dict, compute_dtype="float32"):
    port = BLIP2_MR(**dict(TINY, compute_dtype=compute_dtype), init_params=False,
                    device="cpu")
    port.load_state_dict(state_dict)
    return port


@pytest.fixture(scope="module")
def tiny_int8(tiny_float):
    jm, float_sd = tiny_float
    port = _port(float_sd).quantize_for_inference()
    jm_q = JaxBLIP2_MR(**TINY, scan_layers=False)
    jm_q.params = jm.params
    jm_q.quantize_for_inference()
    return jm_q, port


def test_quantize_for_inference_layout_matches_jax(tiny_int8):
    jm_q, port = tiny_int8
    want = _jax_sd(jm_q.params)
    _assert_quantized_equal(port.state_dict(), want)
    assert port.vit_config.int8_matmul and port.qformer_config.int8_cross
    cfg = port.t5_config
    assert cfg.int8_encoder and cfg.int8_decode and cfg.int8_cross_cache
    assert port.module.t5_config is cfg and not port.module.training
    assert not any(p.requires_grad for p in port.module.parameters())


# Samples whose beams are no near-tie: the JAX ViT on the CPU runs the
# unfused chain and its bf16 attention products sum in another order than
# PyTorch's, a few bf16 ulps that move the beam scores by up to 3e-3. With
# ("float32", 2, 0) two beams lie closer than that and swap; the comparison
# of the sequences is exact for the samples below.
@pytest.mark.parametrize("video_dtype,b,seed", [("uint8", 3, 1), ("float32", 3, 3),
                                                ("uint8", 2, 4)])
def test_tiny_int8_generate_identical_to_jax(tiny_int8, interpreted, video_dtype, b, seed):
    jm_q, port = tiny_int8
    samples = _samples(video_dtype, b, seed)
    want_handle = jm_q.generate_dispatch(samples)
    want = jm_q.generate_collect(want_handle)
    got_handle = port.generate_dispatch(samples)
    got = port.generate_collect(got_handle)
    np.testing.assert_array_equal(got_handle["seqs"].numpy(),
                                  np.asarray(want_handle["seqs"]))
    assert got["raw_prediction"] == want["raw_prediction"]
    assert got["prediction"] == want["prediction"]
    np.testing.assert_allclose(got_handle["scores"].numpy(),
                               np.asarray(want_handle["scores"]), atol=5e-3)


def test_tiny_int8_stages_match_jax(tiny_int8, interpreted):
    """Frame features and encoder states of the two int8 models."""
    jm_q, port = tiny_int8
    batch = port.prepare_mr_batch(_samples("uint8", 2, 0), need_targets=False)
    tensors = port._to_device(batch)
    with torch.no_grad():
        frames_t = port.frames_to_t5(tensors)
        enc_t, _ = port.encode_t5(tensors, frames_t, port._encoder_bias_for(batch))
    frames_j = jm_q.module.apply({"params": jm_q.params}, jnp.asarray(batch["frames"]),
                                 method="encode_frames")

    def encode(module, frames):
        embeds, attn = module.assemble_encoder_input(frames, *[
            jnp.asarray(batch[k]) for k in ("time_ids", "src_type", "src_idx", "int_mask",
                                            "end_ids", "end_mask", "text_ids", "text_mask")])
        return module.encode(embeds, attn)

    enc_j = jm_q.module.apply({"params": jm_q.params}, frames_j, method=encode)
    frames_j, enc_j = np.asarray(frames_j, np.float32), np.asarray(enc_j, np.float32)
    np.testing.assert_allclose(frames_t.numpy(), frames_j, atol=0.02 * np.abs(frames_j).max())
    assert _cosine_rows(enc_t.float().numpy(), enc_j).min() >= 0.999


def test_int8_fidelity_against_float(tiny_float):
    """The JAX package's gates, on the port alone: int8 against its own
    float path, cosine > 0.99 for the ViT and the encoder outputs and
    > 0.999 for the int8 cross K/V cache against the float K/V."""
    _, float_sd = tiny_float
    flt, q8 = _port(float_sd), _port(float_sd).quantize_for_inference()
    batch = flt.prepare_mr_batch(_samples("uint8", 3, 2), need_targets=False)
    tensors = flt._to_device(batch)
    bias = flt._encoder_bias_for(batch)

    def cos(a, b):
        a, b = a.float().flatten(), b.float().flatten()
        return float(a @ b / (a.norm() * b.norm()))

    with torch.no_grad():
        frames = tensors["frames"].reshape((-1,) + tensors["frames"].shape[2:]).float()
        assert cos(q8.module.visual_encoder(frames), flt.module.visual_encoder(frames)) > 0.99
        # The same frame features into both encoders, then the same encoder
        # states into both cross K/V projections.
        feats = flt.frames_to_t5(tensors)
        enc_f, _ = flt.encode_t5(tensors, feats, bias)
        enc_q, _ = q8.encode_t5(tensors, feats, bias)
        assert cos(enc_q, enc_f) > 0.99
        kv_f = flt.module.t5.decoder.cross_kv(enc_f)
        kv_q = q8.module.t5.decoder.cross_kv(enc_f)
    for (k_f, v_f), (k_q, v_q, k_s, v_s) in zip(kv_f, kv_q):
        assert cos(k_q.float() * k_s, k_f) > 0.999
        assert cos(v_q.float() * v_s, v_f) > 0.999


def test_tiny_int8_generate_bf16_runs(tiny_float):
    """The bf16 compute path of the int8 mode on the CPU (plain versions)."""
    from mr_blip_tpu_torch.text.span_grammar import moment_str_to_list

    _, float_sd = tiny_float
    model = _port(float_sd, "bfloat16").quantize_for_inference()
    handle = model.generate_dispatch(_samples("uint8", 2, 0))
    out = model.generate_collect(handle)
    assert len(out["prediction"]) == 2 and torch.isfinite(handle["scores"]).all()
    for p in out["prediction"]:
        moment_str_to_list(p)


@pytest.mark.parametrize("method", ["quantize_vit", "quantize_qformer", "quantize_encoder",
                                    "quantize_for_decode", "quantize_for_inference"])
def test_quantize_twice_raises(tiny_float, method):
    _, float_sd = tiny_float
    port = _port(float_sd)
    assert getattr(port, method)() is port
    with pytest.raises(RuntimeError, match="already quantized"):
        getattr(port, method)()


def test_quantize_keeps_the_encoder_bias_cache(tiny_float):
    _, float_sd = tiny_float
    port = _port(float_sd)
    batch = port.prepare_mr_batch(_samples("uint8", 2, 0), need_targets=False)
    bias = port._encoder_bias_for(batch)
    port.quantize_for_inference()  # the rel-pos table is untouched
    assert port._encoder_bias_for(batch) is bias


def test_device_defaults_to_the_card():
    """Entry points run on the card unless the caller asks for the CPU."""
    assert inspect.signature(BLIP2_MR.__init__).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            BLIP2_MR(**TINY)
