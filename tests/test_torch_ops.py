"""The port's ops against the JAX package's, on the CPU in fp32.

Each kernel's plain PyTorch version (what the wrapper runs for a CPU
tensor) is held against the JAX kernel body run in Pallas interpret mode,
on the same numpy-seeded inputs. The CUDA kernels themselves are held
against these plain versions on the card by ``chip_smoke.py``.
"""

import unittest.mock as mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from mr_blip_tpu.ops import attention as jattn
from mr_blip_tpu.ops import flash_attention as jfa
from mr_blip_tpu.ops.layer_norm import _fused_layer_norm
from mr_blip_tpu.ops.relpos import materialize_relpos_bias as jax_relpos_bias
from mr_blip_tpu.ops.relpos import relative_position_bucket as jax_bucket
from mr_blip_tpu_torch.ops import flash_attention as tfa
from mr_blip_tpu_torch.ops.attention import dot_product_attention, xla_attention
from mr_blip_tpu_torch.ops.layer_norm import fused_layer_norm
from mr_blip_tpu_torch.ops.relpos import materialize_relpos_bias, relative_position_bucket


def _t(a):
    return torch.from_numpy(np.array(a))


def _interpret_pallas():
    """Patch the flash module's pallas_call to interpret mode (CPU)."""
    orig = pl.pallas_call
    return mock.patch.object(
        jfa.pl, "pallas_call",
        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))


@pytest.mark.parametrize("rows,d,eps", [(300, 256, 1e-6), (77, 1408, 1e-5),
                                        (64, 768, 1e-12)])
def test_layer_norm_plain_matches_pallas(rows, d, eps):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((rows, d)) * 3 + 1.5).astype(np.float32)
    scale = rng.standard_normal(d).astype(np.float32)
    bias = rng.standard_normal(d).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = _fused_layer_norm(jnp.asarray(x), jnp.asarray(scale),
                                 jnp.asarray(bias), eps)
    before = fused_layer_norm.launches
    got = fused_layer_norm(_t(x).reshape(rows, 1, d), _t(scale), _t(bias), eps)
    assert fused_layer_norm.launches == before  # CPU: plain version, no launch
    np.testing.assert_allclose(got.reshape(rows, d).numpy(), np.asarray(want),
                               atol=1e-5)


@pytest.mark.parametrize("n,n_valid", [(65, 0), (24, 17)])
def test_qkv_packed_plain_matches_pallas(n, n_valid):
    rng = np.random.default_rng(2)
    b, h, d = 2, 4, 88
    qkv = rng.standard_normal((b, n, 3 * h * d)).astype(np.float32)
    if n_valid:
        qkv[:, n_valid:] *= 7.0
    with pltpu.force_tpu_interpret_mode():
        want = jfa._flash_qkv_packed(jnp.asarray(qkv), h, d, n_valid)
    got = tfa.flash_attention_qkv_packed(_t(qkv), h, n_valid=n_valid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("n,tail_masked", [(200, True), (130, False), (256, True)])
def test_flash_bias_plain_matches_pallas(n, tail_masked):
    rng = np.random.default_rng(3)
    b, h, d = 2, 4, 64
    q, k, v = (rng.standard_normal((b, n, h, d)).astype(np.float32) for _ in range(3))
    bias = rng.standard_normal((1, h, n, n)).astype(np.float32)
    mask = np.ones((b, n), np.int8)
    if tail_masked:
        mask[0, n - 37:] = 0
        mask[1, n // 2:] = 0
    with _interpret_pallas():
        want = jfa.flash_attention_bias(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias),
            jnp.asarray(mask), block_q=128, block_k=128)
    got = tfa.flash_attention_bias(_t(q), _t(k), _t(v), _t(bias), _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_flash_bias_rejects_bad_shapes():
    q = torch.zeros(1, 8, 2, 8)
    with pytest.raises(ValueError, match="bias"):
        tfa.flash_attention_bias(q, q, q, torch.zeros(2, 2, 8, 8))
    with pytest.raises(ValueError, match="kv_mask"):
        tfa.flash_attention_bias(q, q, q, torch.zeros(1, 2, 8, 8),
                                 torch.ones(1, 7))
    with pytest.raises(ValueError, match="n_valid"):
        tfa.flash_attention_qkv_packed(torch.zeros(1, 4, 12), 2, n_valid=5)


@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("num_buckets,max_distance", [(32, 128), (16, 64)])
def test_relative_position_bucket_bit_exact(bidirectional, num_buckets, max_distance):
    rel = np.arange(-9000, 9000, dtype=np.int32)
    want = np.asarray(jax_bucket(jnp.asarray(rel), bidirectional, num_buckets,
                                 max_distance))
    got = relative_position_bucket(_t(rel), bidirectional, num_buckets, max_distance)
    np.testing.assert_array_equal(got.numpy(), want)


def test_materialize_relpos_bias_bit_exact():
    rng = np.random.default_rng(4)
    table = rng.standard_normal((32, 4)).astype(np.float32)
    pos_q, pos_k = np.arange(5, 40), np.arange(300)
    want = jax_relpos_bias(jnp.asarray(table), jnp.asarray(pos_q),
                           jnp.asarray(pos_k), True, 32, 128)
    got = materialize_relpos_bias(_t(table), _t(pos_q), _t(pos_k), True, 32, 128)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n,m,use_bias,mask_kind", [
    (7, 11, True, "keys"), (300, 300, True, "keys"), (5, 9, False, "full"),
    (4, 6, True, "row_all_masked"),
])
def test_dot_product_attention_matches_jax(n, m, use_bias, mask_kind):
    rng = np.random.default_rng(5)
    b, h, d = 2, 3, 16
    q = rng.standard_normal((b, n, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, m, h, d)).astype(np.float32) for _ in range(2))
    bias = rng.standard_normal((1, h, n, m)).astype(np.float32) if use_bias else None
    if mask_kind == "full":
        mask = rng.random((b, 1, n, m)) > 0.3
    else:
        mask = np.ones((b, 1, 1, m), bool)
        mask[0, ..., m // 2:] = False
        if mask_kind == "row_all_masked":
            mask[1] = False
    want = jattn.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        bias=None if bias is None else jnp.asarray(bias), mask=jnp.asarray(mask))
    got = dot_product_attention(_t(q), _t(k), _t(v),
                                bias=None if bias is None else _t(bias),
                                mask=_t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    np.testing.assert_allclose(
        got.numpy(),
        xla_attention(_t(q), _t(k), _t(v), None if bias is None else _t(bias),
                      _t(mask)).numpy(), atol=0)
