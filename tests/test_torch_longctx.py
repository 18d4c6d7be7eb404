"""The port's long-context path (``relpos_in_kernel``) against the JAX
package's, on the CPU in fp32.

The plain versions of the four rel-pos flash kernels (what the wrappers run
for a CPU tensor) are held against the JAX kernel bodies run in Pallas
interpret mode, the way ``tests/test_attention.py::TestFlashRelpos`` runs
them (block 64, 16 buckets, max distance 32, so that 384 positions cover the
far-past, near and far-future segments and 200 the ragged tail), on the same
numpy-seeded inputs; then the dispatch, the T5 encoder (float and int8) and
the ``BLIP2_MR(relpos_in_kernel=True)`` wrapper as a whole. The CUDA kernels
themselves are held against the plain versions on the card by
``chip_smoke.py``.
"""

import dataclasses
import functools
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from jax.experimental import pallas as pl

import mr_blip_tpu.ops.int8_matmul as jint8
from mr_blip_tpu.models import quantize as jquant
from mr_blip_tpu.models import t5 as jt5
from mr_blip_tpu.models.blip2_mr import BLIP2_MR as JaxBLIP2_MR
from mr_blip_tpu.ops import flash_attention as jfa
from mr_blip_tpu.ops.attention import relpos_attention as jattn_relpos
from mr_blip_tpu.ops.attention import xla_attention as jax_xla_attention
from mr_blip_tpu.ops.relpos import materialize_relpos_bias as jax_relpos_bias
from mr_blip_tpu.ops.relpos import relative_position_bucket as jax_bucket
from mr_blip_tpu_torch.models import t5
from mr_blip_tpu_torch.models.blip2_mr import BLIP2_MR
from mr_blip_tpu_torch.models.convert import state_dict_from_jax
from mr_blip_tpu_torch.models.layers import Dropout
from mr_blip_tpu_torch.ops import attention as tattn
from mr_blip_tpu_torch.ops import flash_attention as tfa
from mr_blip_tpu_torch.ops.relpos import clamped_bucket_table

NB, MAXD = 16, 32  # buckets and max distance of the kernel-level tests
ATOL = 1e-4  # the bar of the repo's torch parity tests


def _t(a):
    return torch.from_numpy(np.array(a))


def _interpret_pallas():
    """Patch the flash module's pallas_call to interpret mode (CPU)."""
    orig = pl.pallas_call
    return mock.patch.object(
        jfa.pl, "pallas_call",
        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))


@pytest.fixture
def interpreted(monkeypatch):
    """The JAX modules' W8A8 calls run the Pallas kernel bodies (interpret
    mode) instead of the off-TPU jnp references, as the port's plain
    versions follow the kernels."""
    for name in ("w8a8_linear", "w8a8_mlp", "w8a8_mlp_gated"):
        monkeypatch.setattr(
            jint8, name, functools.partial(getattr(jint8, name), interpret=True))


def _relpos_inputs(n, seed, b=2, h=2, d=16, masked=(1, 30)):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, n, h, d)).astype(np.float32) for _ in range(3))
    table = rng.standard_normal((h, NB)).astype(np.float32)
    mask = np.ones((b, n), np.int8)
    mask[masked[0], n - masked[1]:] = 0  # a ragged key tail in one batch row
    return q, k, v, table, mask


def _jax_materialized(table, n):
    return jax_relpos_bias(jnp.asarray(table).T, jnp.arange(n), jnp.arange(n),
                           bidirectional=True, num_buckets=NB, max_distance=MAXD)


# --------------------------------------------------------------- the buckets
@pytest.mark.parametrize("num_buckets,max_distance", [(32, 128), (16, 32), (8, 1023)])
def test_clamped_bucket_table_equals_jax_bucket(num_buckets, max_distance):
    """Looking the clamped relative position up in the table gives the JAX
    bucket of the unclamped one, bit for bit, over [-5000, 5000]."""
    lut = clamped_bucket_table(num_buckets, max_distance)
    assert lut.shape == (2 * max_distance + 1,) and lut.dtype == torch.int32
    rel = np.arange(-5000, 5001)
    want = np.asarray(jax_bucket(jnp.asarray(rel), bidirectional=True,
                                 num_buckets=num_buckets, max_distance=max_distance))
    got = lut[_t(rel).clamp(-max_distance, max_distance) + max_distance].numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() == num_buckets - 1


# --------------------------------------------- kernel 9's far/near split
def _tile_class(q0, k0, thresholds, rows=64, keys=64):
    """Kernel 9's class of a consumer's tile of ``rows`` queries from q0 and
    ``keys`` keys from k0, as ``softmax_tile`` (csrc/attention_tile_sm90.cuh)
    and the dQ pass of kernels 10-11 (``ds_of_tile_rel``,
    csrc/backward_tile_sm90.cuh) decide it from the wrapper's thresholds:
    "past" or "future" (one bias value for the whole tile) or "near" (a
    lookup per score)."""
    past, future = thresholds
    if k0 + keys - 1 - q0 <= past:
        return "past"
    if k0 - (q0 + rows - 1) >= future:
        return "future"
    return "near"


def _tile_class_dkv(kw, t0, thresholds, keys=64, queries=64):
    """Kernel 12's class of a consumer's tile of ``keys`` owned keys from kw
    by ``queries`` streamed queries from t0, as ``pds_of_tile_rel``
    (csrc/backward_tile_sm90.cuh) decides it: key - query spans
    [kw - (t0 + queries - 1), kw + keys - 1 - t0]."""
    past, future = thresholds
    if kw + keys - 1 - t0 <= past:
        return "past"
    if kw - (t0 + queries - 1) >= future:
        return "future"
    return "near"


@pytest.mark.parametrize("orientation", ["dq", "dkv"])
@pytest.mark.parametrize("n", [257, 300, 1037, 2049, 8000])
@pytest.mark.parametrize("num_buckets,max_distance", [(32, 128), (16, 32)])
def test_relpos_far_tiles_hold_one_bucket(n, num_buckets, max_distance, orientation):
    """Every 64 x 64 tile that a kernel classes far (from the far thresholds
    its wrapper computes) holds one JAX bucket over all its valid (query,
    key) pairs, the bucket of its side; every tile with two buckets is
    classed near; at 8,000 a row of tiles has at most 7 near ones. "dq":
    owned queries, streamed keys (kernel 9 and the dQ pass of kernels 10-11);
    "dkv": owned keys, streamed queries (the dK/dV pass of kernel 12)."""
    thresholds = tfa.relpos_far_thresholds(num_buckets, max_distance)
    rel = np.arange(-(n - 1), n)
    bucket = np.asarray(jax_bucket(jnp.asarray(rel), bidirectional=True,
                                   num_buckets=num_buckets, max_distance=max_distance))
    far_past, far_future = bucket[0], bucket[-1]  # rel -(n-1) and n-1
    lut = clamped_bucket_table(num_buckets, max_distance).numpy()
    assert (lut[0], lut[-1]) == (far_past, far_future)
    most_near = 0
    for r0 in range(0, n, 64):  # the consumer's owned rows
        near = 0
        for c0 in range(0, n, 64):  # the streamed tile
            q0, k0 = (r0, c0) if orientation == "dq" else (c0, r0)
            # the valid pairs' key - query: one contiguous range
            lo = k0 - min(q0 + 63, n - 1)
            hi = min(k0 + 63, n - 1) - q0
            seen = set(bucket[lo + n - 1:hi + n].tolist())
            kind = (_tile_class(q0, k0, thresholds) if orientation == "dq"
                    else _tile_class_dkv(k0, q0, thresholds))
            if kind == "near":
                near += 1
            else:
                assert seen == {far_past if kind == "past" else far_future}, (q0, k0)
            if len(seen) > 1:
                assert kind == "near", (q0, k0)
        most_near = max(most_near, near)
    if n == 8000 and num_buckets == 32:
        assert most_near <= 7


def test_relpos_far_thresholds_of_the_t5_buckets():
    """At T5's 32 buckets and max distance 128 the last log bucket starts at
    a distance of 91 on either side, so a tile is far from 91 + 126 = 217
    positions off the diagonal rather than 128 + 126."""
    assert tfa.relpos_far_thresholds(32, 128) == (-91, 91)


@pytest.mark.parametrize("n", [256, 300])
def test_fp32_relpos_attention_matches_jax(n):
    """fp32 (the parity mode) on the CPU: the dispatch's plain route and the
    custom VJP's (kernel 9's plain version) against JAX's relpos_attention in
    fp32 on the same inputs, to 1e-4."""
    q, k, v, table, mask = _relpos_inputs(n, 21, h=4, d=64)
    want = np.asarray(jattn_relpos(*(jnp.asarray(a) for a in (q, k, v, table)),
                                   kv_mask=jnp.asarray(mask), num_buckets=NB,
                                   max_distance=MAXD))
    got = tattn.relpos_attention(_t(q), _t(k), _t(v), _t(table), kv_mask=_t(mask),
                                 num_buckets=NB, max_distance=MAXD)
    leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    got_vjp = tfa.flash_attention_relpos(*leaves, _t(table), _t(mask), NB, MAXD)
    assert got.dtype == got_vjp.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    np.testing.assert_allclose(got_vjp.detach().numpy(), want, atol=ATOL)


# ------------------------------------- plain versions against the JAX kernels
@pytest.mark.parametrize("n", [384, 200])
def test_relpos_fwd_stats_plain_matches_pallas(n):
    """Kernel 9's plain version, output and logsumexp, against
    ``_flash_relpos_fwd_stats`` (through the JAX VJP forward, which pads the
    ragged tail) in interpret mode (2e-3, the JAX tests' bar) and against
    the JAX materialized-bias reference (1e-4)."""
    q, k, v, table, mask = _relpos_inputs(n, 8)
    with _interpret_pallas():
        out_j, res = jfa._flash_relpos_vjp_fwd(
            *(jnp.asarray(a) for a in (q, k, v, table, mask)), NB, MAXD, 64, 64, False)
    lse_j = np.asarray(res[-1])[:, :, 0, :n]
    before = tfa.flash_relpos_fwd_stats.launches
    out_t, lse_t = tfa.flash_relpos_fwd_stats(_t(q), _t(k), _t(v), _t(table), _t(mask),
                                              NB, MAXD)
    assert tfa.flash_relpos_fwd_stats.launches == before  # CPU: plain, no launch
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(lse_t.numpy(), lse_j, rtol=2e-3, atol=2e-3)
    want = jax_xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             bias=_jax_materialized(table, n),
                             mask=jnp.asarray(mask, bool)[:, None, None, :])
    np.testing.assert_allclose(out_t.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(
        tfa.flash_attention_relpos(_t(q), _t(k), _t(v), _t(table), _t(mask), NB,
                                   MAXD).numpy(), out_t.numpy(), atol=0)


@pytest.mark.parametrize("table_grad", [False, True])
@pytest.mark.parametrize("n", [384, 200])
def test_relpos_backward_plain_matches_pallas(n, table_grad):
    """The custom VJP's CPU path (plain versions of kernels 9-12) against
    ``jax.grad`` of the Pallas ``flash_attention_relpos`` in interpret mode
    (2e-3) and of the JAX materialized-bias reference (1e-4): dq, dk, dv,
    and dtable when the table trains (JAX's ``table_grad``)."""
    q, k, v, table, mask = _relpos_inputs(n, 9 + table_grad, masked=(table_grad, 15))
    mask4 = jnp.asarray(mask, bool)[:, None, None, :]

    def loss_flash(q, k, v, t):
        out = jfa.flash_attention_relpos(q, k, v, t, jnp.asarray(mask), num_buckets=NB,
                                         max_distance=MAXD, block_q=64, block_k=64,
                                         table_grad=table_grad)
        return (out * jnp.cos(out)).sum()

    def loss_xla(q, k, v, t):
        out = jax_xla_attention(q, k, v, bias=_jax_materialized(t, n), mask=mask4)
        return (out * jnp.cos(out)).sum()

    args = tuple(jnp.asarray(a) for a in (q, k, v, table))
    with _interpret_pallas():
        want_flash = jax.grad(loss_flash, argnums=(0, 1, 2, 3))(*args)
    want_xla = jax.grad(loss_xla, argnums=(0, 1, 2, 3))(*args)
    leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    leaves.append(_t(table).requires_grad_(table_grad))  # JAX's flag, in torch
    out = tfa.flash_attention_relpos(*leaves, _t(mask), NB, MAXD)
    (out * torch.cos(out)).sum().backward()
    names = ("q", "k", "v", "table") if table_grad else ("q", "k", "v")
    for name, leaf, wf, wx in zip(names, leaves, want_flash, want_xla):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(wf), rtol=2e-3,
                                   atol=2e-3, err_msg=f"d{name} vs the kernel body")
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(wx), rtol=ATOL,
                                   atol=ATOL, err_msg=f"d{name} vs materialized")
    if not table_grad:  # JAX returns zeros; the port gives the table no gradient
        assert leaves[3].grad is None and not np.asarray(want_flash[3]).any()


def test_relpos_function_gradcheck():
    """``torch.autograd.gradcheck`` in float64 on the Function's CPU path,
    with a masked key tail and a fully masked batch row, the table too."""
    rng = np.random.default_rng(10)
    b, n, h, d = 3, 7, 2, 4
    q, k, v = (torch.from_numpy(rng.standard_normal((b, n, h, d)))
               .requires_grad_() for _ in range(3))
    table = torch.from_numpy(rng.standard_normal((h, 8))).requires_grad_()
    mask = torch.ones(b, n, dtype=torch.int8)
    mask[1, 4:] = 0
    mask[2] = 0

    def fn(q, k, v, table):
        return tfa._FlashRelpos.apply(q, k, v, table, mask, 8, 3, *tfa._FLASH_RELPOS_OPS)

    assert torch.autograd.gradcheck(fn, (q, k, v, table))
    out = fn(q, k, v, table)
    assert not out[2].any()  # the fully masked row gives zeros


# ------------------------------------------------------------ the custom VJP
def _detached(fn, calls, name):
    """A CPU stand-in for a kernel launcher: the plain version's values with
    no autograd history, as a kernel that writes through ctypes returns;
    counts its calls."""
    def launch(*args, **kw):
        calls[name] = calls.get(name, 0) + 1
        with torch.no_grad():
            out = fn(*args, **kw)
        return tuple(o.detach() for o in out) if isinstance(out, tuple) else out.detach()
    return launch


@pytest.mark.parametrize("table_trains", [False, True])
def test_flash_relpos_function_carries_gradients(table_trains):
    """Through ``_FlashRelpos`` with the launchers swapped for CPU stand-ins
    the gradients of q, k and v equal the plain path's, the table gets one
    exactly when it requires grad, and kernel 11's stand-in is picked only
    then (kernel 10's otherwise)."""
    q, k, v, table, mask = _relpos_inputs(70, 12, h=2, d=8, masked=(0, 9))
    leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    leaves.append(_t(table).requires_grad_(table_trains))
    calls = {}
    names = ("fwd", "dq", "dq_dtable", "dkv")
    ops = [_detached(f, calls, nm) for f, nm in zip(tfa._FLASH_RELPOS_OPS, names)]
    assert ops[0](*leaves, _t(mask), NB, MAXD)[0].grad_fn is None
    calls.clear()
    got = tfa._FlashRelpos.apply(*leaves, _t(mask), NB, MAXD, *ops)
    want = tattn.relpos_attention(*leaves, kv_mask=_t(mask), num_buckets=NB,
                                  max_distance=MAXD)  # CPU: materialized, plain
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), atol=1e-5)
    g = _t(np.random.default_rng(13).standard_normal(want.shape).astype(np.float32))
    needs = leaves if table_trains else leaves[:3]
    for a, b_ in zip(torch.autograd.grad(got, needs, g),
                     torch.autograd.grad(want, needs, g)):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), atol=1e-5)
    assert calls == {"fwd": 1, "dkv": 1, ("dq_dtable" if table_trains else "dq"): 1}


def test_flash_attention_relpos_casts_the_table_in_the_graph():
    """The model's (num_buckets, H) parameter arrives transposed and maybe in
    bf16; the gradient flows back through the transpose and the cast."""
    q, k, v, table, mask = _relpos_inputs(40, 14, masked=(1, 5))
    param = _t(table.T.copy()).to(torch.bfloat16).requires_grad_()
    out = tfa.flash_attention_relpos(_t(q), _t(k), _t(v), param.T, _t(mask), NB, MAXD)
    out.sum().backward()
    assert param.grad.shape == (NB, 2) and param.grad.dtype == torch.bfloat16
    assert bool(param.grad.abs().max() > 0)


# --------------------------------------------------------------- the dispatch
def test_relpos_attention_dispatch(monkeypatch):
    """Short sequences, the CPU and active dropout take the plain path
    (materialized bias); a long CUDA-like call goes to the kernel route,
    which raises on q_len != k_len while the dispatch itself falls back to
    the plain path for it, as in JAX."""
    q, k, v, table, mask = (_t(a) for a in _relpos_inputs(300, 15))
    routed = []
    monkeypatch.setattr(tfa, "flash_attention_relpos",
                        lambda *a, **kw: routed.append(kw) or a[0])
    want = tfa._flash_relpos_fwd_stats_reference(q, k, v, table, mask, NB, MAXD)[0]
    kw = dict(kv_mask=mask, num_buckets=NB, max_distance=MAXD)
    got = tattn.relpos_attention(q, k, v, table, **kw)  # CPU -> plain
    assert not routed
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)

    class OnCard(torch.Tensor):  # a CPU tensor that says it lies on the card
        is_cuda = True

    qc = q.as_subclass(OnCard)
    assert tattn.relpos_attention(qc, k, v, table, **kw) is qc and len(routed) == 1
    assert routed[0] == kw
    short = q[:, :255].as_subclass(OnCard)
    tattn.relpos_attention(short, k[:, :255], v[:, :255], table, kv_mask=mask[:, :255],
                           num_buckets=NB, max_distance=MAXD)  # short -> plain
    gen = torch.Generator().manual_seed(0)
    dropped = tattn.relpos_attention(qc, k, v, table, dropout_rate=0.5, generator=gen,
                                     **kw)  # active dropout -> plain
    assert not torch.allclose(dropped, want)
    rect = tattn.relpos_attention(qc, k[:, :290], v[:, :290], table,
                                  kv_mask=mask[:, :290], num_buckets=NB,
                                  max_distance=MAXD)  # q_len != k_len -> plain
    assert rect.shape == q.shape and len(routed) == 1
    monkeypatch.undo()
    with pytest.raises(ValueError, match="self-attention only"):
        tfa.flash_attention_relpos(q, k[:, :290], v[:, :290], table, None, NB, MAXD)
    with pytest.raises(ValueError, match="table must be"):
        tfa.flash_attention_relpos(q, k, v, table.T, None, NB, MAXD)
    with pytest.raises(ValueError, match="kv_mask must be"):
        tfa.flash_attention_relpos(q, k, v, table, mask[:, :10], NB, MAXD)


# ------------------------------------------------------------- the T5 encoder
def _redraw(params, seed, std=0.1):
    """Every leaf redrawn: norm scales near 1, everything else N(0, std)."""
    rng = np.random.default_rng(seed)
    flat = traverse_util.flatten_dict(jax.tree.map(np.asarray, params))
    for key, leaf in flat.items():
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        flat[key] = 1.0 + std * noise if key[-1] == "scale" else std * noise
    return traverse_util.unflatten_dict(flat)


def _t5_params(seed=4, batch=2, enc_len=21):
    cfg = jt5.t5_tiny_config(vocab_size=64, lora_rank=8)
    jmod = jt5.T5ForConditionalGeneration(cfg, jnp.float32, decode_cache_len=6)
    rng = np.random.default_rng(3)
    embeds = rng.standard_normal((batch, enc_len, cfg.d_model)).astype(np.float32)
    mask = np.ones((batch, enc_len), np.int32)
    mask[1, enc_len - 4:] = 0
    ids = jnp.asarray(rng.integers(0, 64, (batch, 2)))
    params = _redraw(jmod.init(jax.random.PRNGKey(0), jnp.asarray(embeds), ids)["params"],
                     seed)
    return cfg, params, embeds, mask


def _jax_sd(tree):
    return state_dict_from_jax(jax.tree.map(np.asarray, tree))


def test_t5_encoder_relpos_in_kernel_matches_jax_and_the_default():
    """The float encoder with ``relpos_in_kernel`` against the JAX encoder
    with the flag and the same converted weights, and against the port's own
    materialized-bias default; the flag adds no parameter, so
    ``state_dict_from_jax`` consumes the same leaves either way."""
    cfg, params, embeds, mask = _t5_params()
    jmod = jt5.T5ForConditionalGeneration(
        dataclasses.replace(cfg, relpos_in_kernel=True), jnp.float32, decode_cache_len=6)
    want = jax.jit(lambda p: jmod.apply({"params": p}, jnp.asarray(embeds),
                                        mask=jnp.asarray(mask), method="encode"))(params)
    sd = _jax_sd(params)
    outs = {}
    for flag in (True, False):
        port = t5.T5ForConditionalGeneration(t5.t5_tiny_config(
            vocab_size=64, lora_rank=8, relpos_in_kernel=flag)).eval()
        assert set(port.state_dict()) == set(sd)
        port.load_state_dict(sd, strict=True)
        with torch.no_grad():
            outs[flag] = port.encode(_t(embeds), _t(mask)).numpy()
    np.testing.assert_allclose(outs[True], np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(outs[True], outs[False], atol=ATOL)
    # A bias handed in wins over the flag, as in JAX.
    flagged = t5.T5ForConditionalGeneration(t5.t5_tiny_config(
        vocab_size=64, lora_rank=8, relpos_in_kernel=True)).eval()
    flagged.load_state_dict(sd, strict=True)
    with torch.no_grad():
        zero_bias = torch.zeros(1, cfg.num_heads, embeds.shape[1], embeds.shape[1])
        with_bias = flagged.encode(_t(embeds), _t(mask), position_bias=zero_bias).numpy()
    assert np.abs(with_bias - outs[True]).max() > 1e-3


def test_t5_encoder_relpos_table_gradient_matches_jax():
    """Full finetuning (lora_rank 0): the rel-pos table's gradient through
    the ``relpos_in_kernel`` encoder equals JAX's."""
    cfg = jt5.t5_tiny_config(vocab_size=64, relpos_in_kernel=True)
    jmod = jt5.T5ForConditionalGeneration(cfg, jnp.float32, decode_cache_len=6)
    rng = np.random.default_rng(5)
    embeds = rng.standard_normal((2, 19, cfg.d_model)).astype(np.float32)
    mask = np.ones((2, 19), np.int32)
    mask[0, 15:] = 0
    ids = jnp.asarray(rng.integers(0, 64, (2, 2)))
    params = _redraw(jmod.init(jax.random.PRNGKey(0), jnp.asarray(embeds), ids)["params"], 6)
    params = jax.tree.map(jnp.asarray, params)

    def loss_j(p):
        enc = jmod.apply({"params": p}, jnp.asarray(embeds), mask=jnp.asarray(mask),
                         method="encode")
        return (enc * jnp.cos(enc)).sum()

    grads = jax.jit(jax.grad(loss_j))(params)
    want = np.asarray(grads["encoder"]["rel_bias"]["rel_embedding"])
    port = t5.T5ForConditionalGeneration(t5.t5_tiny_config(
        vocab_size=64, relpos_in_kernel=True)).eval()
    port.load_state_dict(_jax_sd(params), strict=True)
    port.requires_grad_(False)
    table = port.encoder.rel_bias.rel_embedding.requires_grad_()
    enc = port.encode(_t(embeds), _t(mask))
    (enc * torch.cos(enc)).sum().backward()
    assert np.abs(want).max() > 1e-3
    np.testing.assert_allclose(table.grad.numpy(), want, rtol=ATOL, atol=ATOL)


def test_int8_t5_encoder_relpos_in_kernel_matches_jax(interpreted):
    """The W8A8 encoder takes the same branch: with the flag it equals the
    JAX int8 encoder with the flag, and its own materialized-bias run."""
    cfg, params, embeds, mask = _t5_params()
    qparams = jquant.quantize_t5_encoder_params(params)
    jmod = jt5.T5ForConditionalGeneration(
        dataclasses.replace(cfg, int8_encoder=True, relpos_in_kernel=True), jnp.float32,
        decode_cache_len=6)
    want = np.asarray(jmod.apply({"params": qparams}, jnp.asarray(embeds),
                                 mask=jnp.asarray(mask), method="encode"), np.float32)
    outs = {}
    for flag in (True, False):
        port = t5.T5ForConditionalGeneration(t5.t5_tiny_config(
            vocab_size=64, lora_rank=8, int8_encoder=True, relpos_in_kernel=flag)).eval()
        port.load_state_dict(_jax_sd(qparams), strict=True)
        with torch.no_grad():
            outs[flag] = port.encode(_t(embeds), _t(mask))
        assert outs[flag].dtype == torch.bfloat16
    got = outs[True].float().numpy()
    # Two blocks, each within 2 bf16 ulps of the residual stream's scale (the
    # bar of the int8 encoder's own parity test).
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert np.abs(got - want).max() <= 4 * ulp
    # In fp32 math from the same int8 products the two bias routes agree.
    assert np.abs(got - outs[False].float().numpy()).max() <= 2 * ulp


# ------------------------------------------------------- the slice as a whole
TINY = dict(img_size=28, vit_model="tiny", t5_model="tiny", num_beams=2,
            max_new_tokens=8, task="lora", input_time_format="seconds_integers",
            compute_dtype="float32")


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


def _no_dropout(model):
    for m in model.module.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    return model


def _pair(seed, **kw):
    """JAX and port ``BLIP2_MR(relpos_in_kernel=True)`` (tiny, fp32, unscanned
    JAX layout) on the same redrawn weights."""
    jm = JaxBLIP2_MR(**dict(TINY, **kw), relpos_in_kernel=True, scan_layers=False)
    params = _redraw(jm.params, seed)
    jm.params = jax.tree.map(jnp.asarray, params)
    port = BLIP2_MR(**dict(TINY, **kw), relpos_in_kernel=True, init_params=False,
                    device="cpu")
    port.load_state_dict(state_dict_from_jax(params))
    return jm, _no_dropout(port)


@pytest.fixture(scope="module")
def long_pair():
    return _pair(21)


def _assert_same_generate(jm, port, samples):
    want_handle = jm.generate_dispatch(samples)
    want = jm.generate_collect(want_handle)
    got_handle = port.generate_dispatch(samples)
    got = port.generate_collect(got_handle)
    np.testing.assert_array_equal(got_handle["seqs"].numpy(),
                                  np.asarray(want_handle["seqs"]))
    assert got["raw_prediction"] == want["raw_prediction"]
    assert got["prediction"] == want["prediction"]
    return got_handle, want_handle


@pytest.mark.parametrize("video_dtype,b,seed", [("uint8", 3, 1), ("float32", 3, 3)])
def test_tiny_long_generate_identical_to_jax(long_pair, video_dtype, b, seed):
    jm, port = long_pair
    assert port.t5_config.relpos_in_kernel and jm.t5_config.relpos_in_kernel
    got, want = _assert_same_generate(jm, port, _samples(video_dtype, b, seed))
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]),
                               atol=ATOL)
    assert not port._enc_bias_cache  # no (1, H, L, L) tensor was built


def test_tiny_long_generate_equals_the_materialized_default(long_pair):
    """The flag changes the route, not the function: a port model without it
    generates the same beams from the same weights, and caches a bias."""
    _, port = long_pair
    plain = BLIP2_MR(**TINY, init_params=False, device="cpu")
    plain.load_state_dict(port.state_dict())
    samples = _samples("uint8", 2, 4)
    got, want = port.generate_dispatch(samples), plain.generate_dispatch(samples)
    assert torch.equal(got["seqs"], want["seqs"])
    np.testing.assert_allclose(got["scores"].numpy(), want["scores"].numpy(), atol=ATOL)
    assert plain._enc_bias_cache and not port._enc_bias_cache


@pytest.mark.parametrize("video_dtype,b,seed", [("uint8", 3, 1), ("uint8", 2, 4)])
def test_tiny_long_int8_generate_identical_to_jax(interpreted, video_dtype, b, seed):
    """``quantize_for_inference()`` keeps the flag, and the int8 model
    generates the JAX int8 model's spans (samples whose beams are no
    near-tie, as in the int8 tests; scores to 5e-3 as there)."""
    jm, port = _pair(21)
    jm.quantize_for_inference()
    port.quantize_for_inference()
    cfg = port.t5_config
    assert cfg.relpos_in_kernel and cfg.int8_encoder and port.module.t5.cfg is cfg
    got, want = _assert_same_generate(jm, port, _samples(video_dtype, b, seed))
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]),
                               atol=5e-3)
    assert not port._enc_bias_cache


def test_long_context_model_defaults_to_the_card():
    """Without a device argument the model is built on the card, and raises
    where there is none, under ``relpos_in_kernel`` as without it."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            BLIP2_MR(**TINY, relpos_in_kernel=True)
    port = BLIP2_MR(**TINY, relpos_in_kernel=True, init_params=False, device="cpu")
    assert port.device.type == "cpu" and port.module.t5.encoder.cfg.relpos_in_kernel


def test_tiny_long_train_step_matches_jax():
    """Loss and every LoRA gradient of one train step of the
    ``relpos_in_kernel`` model against JAX's (1e-4, the bars of the train
    tests); the frozen table gets no gradient and no bias is cached."""
    jm, port = _pair(22, task="qformer_freeze_lora")
    samples = _samples("uint8", 3, 5)
    batch = jm.prepare_mr_batch(samples)
    batch.pop("video_prompt")
    (loss_want, _), grads = jax.jit(jax.value_and_grad(
        lambda p: jm._loss_fn(p, batch, None), has_aux=True))(jm.params)
    want = state_dict_from_jax(jax.tree.map(np.asarray, grads))
    port.set_trainable()
    loss = port.loss(port.prepare_mr_batch(samples))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_want), atol=ATOL)
    params = dict(port.module.named_parameters())
    trained = [n for n, p in params.items() if p.requires_grad]
    assert trained and all("lora_" in n for n in trained)
    for name in trained:
        np.testing.assert_allclose(params[name].grad.numpy(), want[name].numpy(),
                                   atol=ATOL, err_msg=name)
    assert params["t5.encoder.rel_bias.rel_embedding"].grad is None
    assert not port._enc_bias_cache
