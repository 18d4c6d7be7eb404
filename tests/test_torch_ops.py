"""The port's ops against the JAX package's, on the CPU in fp32.

Each kernel's plain PyTorch version (what the wrapper runs for a CPU
tensor) is held against the JAX kernel body run in Pallas interpret mode,
on the same numpy-seeded inputs. The CUDA kernels themselves are held
against these plain versions on the card by ``chip_smoke.py``.
"""

import unittest.mock as mock

import jax
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


# ------------------------------------------------ gradients (train path)
def _flash_bias_inputs(n, seed, b=2, h=2, d=16):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, n, h, d)).astype(np.float32) for _ in range(3))
    bias = rng.standard_normal((1, h, n, n)).astype(np.float32)
    mask = np.ones((b, n), np.int8)
    mask[1, n - 20:] = 0  # a masked key tail
    return q, k, v, bias, mask


@pytest.mark.parametrize("n", [128, 96])
def test_flash_bias_fwd_stats_reference_matches_pallas(n):
    """Kernel 5's plain version against ``_flash_bias_fwd_stats`` (through
    the JAX VJP forward, which pads the ragged tail) in interpret mode."""
    q, k, v, bias, mask = _flash_bias_inputs(n, 8)
    with _interpret_pallas():
        out_j, res = jfa._flash_bias_vjp_fwd(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias),
            jnp.asarray(mask), 64, 64, False)
    lse_j = np.asarray(res[-1])[:, :, 0, :n]
    out_t, lse_t = tfa.flash_bias_fwd_stats(_t(q), _t(k), _t(v), _t(bias), _t(mask))
    assert tfa.flash_bias_fwd_stats.launches == 0
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-5)
    np.testing.assert_allclose(lse_t.numpy(), lse_j, atol=1e-5)


@pytest.mark.parametrize("bias_grad", [False, True])
@pytest.mark.parametrize("n", [128, 96])
def test_flash_bias_backward_matches_pallas(n, bias_grad):
    """The custom VJP's CPU path (plain versions of kernels 5-8) against
    ``jax.grad`` of the Pallas ``flash_attention_bias`` in interpret mode."""
    q, k, v, bias, mask = _flash_bias_inputs(n, 9)

    def loss_j(q, k, v, b):
        out = jfa.flash_attention_bias(q, k, v, b, jnp.asarray(mask), block_q=64,
                                       block_k=64, bias_grad=bias_grad)
        return (out * jnp.cos(out)).sum()

    with _interpret_pallas():
        want = jax.grad(loss_j, argnums=(0, 1, 2, 3))(
            *(jnp.asarray(a) for a in (q, k, v, bias)))
    leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    leaves.append(_t(bias).requires_grad_(bias_grad))  # JAX's flag, in torch
    out = tfa.flash_attention_bias(*leaves, _t(mask))
    (out * torch.cos(out)).sum().backward()
    for name, leaf, w in zip(("q", "k", "v"), leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), atol=1e-4,
                                   err_msg=f"d{name}")
    if bias_grad:
        np.testing.assert_allclose(leaves[3].grad.numpy(), np.asarray(want[3]),
                                   atol=1e-4)
    else:  # JAX returns zeros; the port gives the bias no gradient
        assert leaves[3].grad is None and not np.asarray(want[3]).any()


def test_flash_bias_function_gradcheck():
    """``torch.autograd.gradcheck`` in float64 on the Function's CPU path,
    with a masked key tail and a fully masked batch row."""
    rng = np.random.default_rng(10)
    b, n, h, d = 3, 6, 2, 4
    q, k, v = (torch.from_numpy(rng.standard_normal((b, n, h, d)))
               .requires_grad_() for _ in range(3))
    bias = torch.from_numpy(rng.standard_normal((1, h, n, n))).requires_grad_()
    mask = torch.ones(b, n, dtype=torch.int8)
    mask[1, 4:] = 0
    mask[2] = 0
    assert torch.autograd.gradcheck(
        lambda q, k, v, bias: tfa.flash_attention_bias(q, k, v, bias, mask),
        (q, k, v, bias))


def _detached(fn):
    """A CPU stand-in for a kernel launcher: the plain version's values with
    no autograd history, as a kernel that writes through ctypes returns."""
    def launch(*args, **kw):
        with torch.no_grad():
            out = fn(*args, **kw)
        return tuple(o.detach() for o in out) if isinstance(out, tuple) else out.detach()
    return launch


def test_kernel_wrappers_carry_gradients():
    """A launcher's output has no autograd history, so a wrapper that
    returned it (as all three did before they became Functions) gives the
    weights before it no gradient and raises no error. Through the
    Functions, with the launchers swapped for CPU stand-ins, the gradients
    equal the plain versions'."""
    from mr_blip_tpu_torch.ops import layer_norm as tln

    rng = np.random.default_rng(11)
    x = _t(rng.standard_normal((5, 3, 32)).astype(np.float32)).requires_grad_()
    w = _t(rng.standard_normal(32).astype(np.float32)).requires_grad_()
    bvec = _t(rng.standard_normal(32).astype(np.float32)).requires_grad_()
    launch = _detached(tln._ln_reference)
    assert launch(x.reshape(-1, 32), w, bvec, 1e-6).grad_fn is None  # the fault
    got = tln._FusedLayerNorm.apply(x.reshape(-1, 32), w, bvec, 1e-6, launch)
    want = tln._ln_reference(x.reshape(-1, 32), w, bvec, 1e-6)
    g = _t(rng.standard_normal(want.shape).astype(np.float32))
    for a, b_ in zip(torch.autograd.grad(got, (x, w, bvec), g),
                     torch.autograd.grad(want, (x, w, bvec), g)):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), atol=1e-5)

    qkv = _t(rng.standard_normal((2, 9, 3 * 2 * 8)).astype(np.float32)).requires_grad_()
    launch = _detached(tfa._qkv_packed_reference)
    assert launch(qkv, 2, 8, 7).grad_fn is None
    got = tfa._QkvPacked.apply(qkv, 2, 8, 7, launch)
    want = tfa._qkv_packed_reference(qkv, 2, 8, 7)
    g = _t(rng.standard_normal(want.shape).astype(np.float32))
    np.testing.assert_allclose(torch.autograd.grad(got, qkv, g)[0].numpy(),
                               torch.autograd.grad(want, qkv, g)[0].numpy(), atol=1e-5)

    q, k, v, bias, mask = _flash_bias_inputs(40, 12, h=2, d=8)
    leaves = [_t(a).requires_grad_() for a in (q, k, v, bias)]
    ops = [_detached(f) for f in tfa._FLASH_BIAS_OPS]
    assert ops[0](*leaves, _t(mask))[0].grad_fn is None
    got = tfa._FlashBias.apply(*leaves, _t(mask), *ops)
    want = tfa._flash_bias_fwd_stats_reference(*leaves, _t(mask))[0]
    g = _t(rng.standard_normal(want.shape).astype(np.float32))
    for a, b_ in zip(torch.autograd.grad(got, leaves, g),
                     torch.autograd.grad(want, leaves, g)):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), atol=1e-5)


@pytest.mark.parametrize("rows,d,eps", [(40, 128, 1e-6), (7, 768, 1e-12)])
def test_layer_norm_gradients_match_jax(rows, d, eps):
    """LayerNorm's autograd gradients, through the wrapper's CPU path and
    through the Function's recompute backward, against ``jax.vjp`` of the
    Pallas custom VJP in interpret mode."""
    from mr_blip_tpu_torch.ops import layer_norm as tln

    rng = np.random.default_rng(13)
    x = (rng.standard_normal((rows, d)) * 2 + 0.5).astype(np.float32)
    scale = rng.standard_normal(d).astype(np.float32)
    bias = rng.standard_normal(d).astype(np.float32)
    g = rng.standard_normal((rows, d)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda a, s, b: _fused_layer_norm(a, s, b, eps),
                         jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
        want = vjp(jnp.asarray(g))
    for route in ("wrapper", "function"):
        leaves = [_t(a).requires_grad_() for a in (x, scale, bias)]
        if route == "wrapper":
            out = fused_layer_norm(*leaves, eps)
        else:
            out = tln._FusedLayerNorm.apply(*leaves, eps, _detached(tln._ln_reference))
        got = torch.autograd.grad(out, leaves, _t(g))
        for a, w in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=1e-4,
                                       err_msg=route)


@pytest.mark.parametrize("n,n_valid", [(17, 0), (24, 19)])
def test_qkv_packed_gradients_match_jax(n, n_valid):
    rng = np.random.default_rng(14)
    b, h, d = 2, 2, 88
    qkv = rng.standard_normal((b, n, 3 * h * d)).astype(np.float32)
    g = rng.standard_normal((b, n, h * d)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda a: jfa._flash_qkv_packed(a, h, d, n_valid),
                         jnp.asarray(qkv))
        (want,) = vjp(jnp.asarray(g))
    for route in ("wrapper", "function"):
        leaf = _t(qkv).requires_grad_()
        if route == "wrapper":
            out = tfa.flash_attention_qkv_packed(leaf, h, n_valid=n_valid)
        else:
            out = tfa._QkvPacked.apply(leaf, h, d, n_valid,
                                       _detached(tfa._qkv_packed_reference))
        (got,) = torch.autograd.grad(out, leaf, _t(g))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   err_msg=route)


def test_attention_dropout_forces_plain_path_and_draws_from_generator():
    rng = np.random.default_rng(15)
    q, k, v = (_t(rng.standard_normal((2, 6, 2, 8)).astype(np.float32)) for _ in range(3))
    plain = dot_product_attention(q, k, v)
    gen = torch.Generator().manual_seed(3)
    a = dot_product_attention(q, k, v, dropout_rate=0.5, generator=gen)
    gen.manual_seed(3)
    b = dot_product_attention(q, k, v, dropout_rate=0.5, generator=gen)
    assert torch.equal(a, b) and not torch.allclose(a, plain)
    # the dropped probabilities, rescaled, average back to the plain output
    gen.manual_seed(4)
    mean = torch.stack([dot_product_attention(q, k, v, dropout_rate=0.5,
                                              generator=gen) for _ in range(400)]).mean(0)
    np.testing.assert_allclose(mean.numpy(), plain.numpy(), atol=0.15)
