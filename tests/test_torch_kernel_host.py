"""The host side of the hand-written kernels, on the CPU.

The CUDA sources compile only on the card; what surrounds them here is
Python that the CPU reaches: the ctypes signatures against the C entries in
``csrc/``, the wrappers' choice of C entry by dtype and the arguments they
pass (through a stand-in library that records the call), the backward
kernels' C entries by dtype and what they refuse, the fp32 biased
dispatch (the plain function on a CPU tensor, equal to JAX's), a module
that imports with no CUDA toolkit, LayerNorm's kernel by width and
alignment, the W8A8 GELU and gated MLPs' workspaces (no fp32 hidden on
the tile route), cluster plans and routes by chunk width, the W8A8 linear's
column plan and the shapes it launches, and the attention block's workspace
and head dims.
"""

import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mr_blip_tpu.ops import attention as jattn
from mr_blip_tpu_torch.ops import _cuda
from mr_blip_tpu_torch.ops import flash_attention as tfa
from mr_blip_tpu_torch.ops import int8_matmul as tint8
from mr_blip_tpu_torch.ops import layer_norm as tln
from mr_blip_tpu_torch.ops.attention import dot_product_attention

_ENTRY = re.compile(r'extern "C" int (mrb_\w+)\(([^)]*)\)', re.S)


def _c_entries():
    """name -> parameter count of every C entry in csrc/*.cu."""
    entries = {}
    for src in sorted(_cuda.CSRC.glob("*.cu")):
        for name, params in _ENTRY.findall(src.read_text()):
            entries[name] = len(params.split(","))
    return entries


def test_c_signatures_match_the_sources():
    entries = _c_entries()
    assert entries.keys() == _cuda._SIGNATURES.keys()
    for name, argtypes in _cuda._SIGNATURES.items():
        assert len(argtypes) == entries[name], name


class _Recorder:
    """A stand-in for the kernel library: records each call, returns 0."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.fixture
def recorder(monkeypatch):
    lib = _Recorder()
    monkeypatch.setattr(_cuda, "library", lambda: lib)
    monkeypatch.setattr(_cuda, "stream_ptr", lambda device: 0)
    return lib


@pytest.mark.parametrize("dtype,suffix", [(torch.bfloat16, "bf16"),
                                          (torch.float32, "f32")])
def test_biased_kernel_entry_by_dtype(recorder, dtype, suffix):
    b, n, h, d = 2, 264, 4, 64
    q, k, v = (torch.zeros(b, n, h, d, dtype=dtype) for _ in range(3))
    bias = torch.zeros(1, h, n, n, dtype=dtype)
    mask = torch.ones(b, n, dtype=torch.bool)
    before = tfa.flash_attention_bias.launches
    out = tfa._flash_bias_cuda(q, k, v, bias, mask)
    assert out.dtype == dtype and out.shape == q.shape
    assert tfa.flash_attention_bias.launches == before + 1
    (name, args), = recorder.calls
    assert name == f"mrb_flash_bias_attention_{suffix}"
    assert args[6:11] == (b, n, n, h, d) and args[11] == pytest.approx(d ** -0.5)
    # The key mask goes in as int8, whatever the caller's dtype.
    assert args[4] != mask.data_ptr()


@pytest.mark.parametrize("bad", ["float16", "bias_dtype", "strided_bias"])
def test_biased_kernel_refuses_what_it_does_not_take(recorder, bad):
    b, n, h, d = 2, 264, 4, 64
    dtype = torch.float16 if bad == "float16" else torch.float32
    q, k, v = (torch.zeros(b, n, h, d, dtype=dtype) for _ in range(3))
    bias = torch.zeros(1, h, n, n, dtype=dtype)
    if bad == "bias_dtype":
        bias = bias.to(torch.bfloat16)
    elif bad == "strided_bias":
        bias = torch.zeros(1, h, n, n + 8, dtype=dtype)[..., :n]
    before = tfa.flash_attention_bias.launches
    with pytest.raises((TypeError, ValueError)):
        tfa._flash_bias_cuda(q, k, v, bias, None)
    assert not recorder.calls and tfa.flash_attention_bias.launches == before


# The backward C entries: name -> (the wrapper's CUDA half, output count).
_BWD = {"dq": (tfa._flash_bias_bwd_dq_cuda, 1),
        "dq_dbias": (tfa._flash_bias_bwd_dq_dbias_cuda, 2),
        "dkv": (tfa._flash_bias_bwd_dkv_cuda, 2)}
_BWD_WRAPPERS = {"dq": tfa.flash_bias_bwd_dq, "dq_dbias": tfa.flash_bias_bwd_dq_dbias,
                 "dkv": tfa.flash_bias_bwd_dkv}


def _bwd_operands(dtype, b=2, n=264, m=272, h=4, d=64):
    q, dout = (torch.zeros(b, n, h, d, dtype=dtype) for _ in range(2))
    k, v = (torch.zeros(b, m, h, d, dtype=dtype) for _ in range(2))
    bias = torch.zeros(1, h, n, m, dtype=dtype)
    mask = torch.ones(b, m, dtype=torch.int8)
    lse, delta = (torch.zeros(b, h, n) for _ in range(2))
    return [q, k, v, bias, mask, dout, lse, delta]


@pytest.mark.parametrize("kernel", sorted(_BWD))
@pytest.mark.parametrize("dtype,suffix", [(torch.bfloat16, "bf16"),
                                          (torch.float32, "f32")])
def test_backward_kernel_entry_by_dtype(recorder, kernel, dtype, suffix):
    """Each backward wrapper reaches its C entry of q's dtype with the
    operands, outputs, (B, N, M, H, D) and the scale where the C signature
    has them, and counts one launch."""
    b, n, m, h, d = 2, 264, 272, 4, 64
    ops = _bwd_operands(dtype, b, n, m, h, d)
    launch, n_out = _BWD[kernel]
    before = _BWD_WRAPPERS[kernel].launches
    outs = launch(*ops)
    outs = outs if isinstance(outs, tuple) else (outs,)
    assert _BWD_WRAPPERS[kernel].launches == before + 1
    (name, args), = recorder.calls
    assert name == f"mrb_flash_bias_bwd_{kernel}_{suffix}"
    assert len(args) == len(_cuda._SIGNATURES[name])
    assert args[:8] == tuple(t.data_ptr() for t in ops)
    assert args[8:8 + n_out] == tuple(t.data_ptr() for t in outs)
    assert args[8 + n_out:13 + n_out] == (b, n, m, h, d)
    assert args[13 + n_out] == pytest.approx(d ** -0.5)
    shapes = {"dq": [(b, n, h, d)], "dq_dbias": [(b, n, h, d), (1, h, n, m)],
              "dkv": [(b, m, h, d), (b, m, h, d)]}[kernel]
    assert [tuple(t.shape) for t in outs] == shapes
    assert [t.dtype for t in outs] == [dtype] + (
        [torch.float32] if kernel == "dq_dbias" else [dtype] * (n_out - 1))


@pytest.mark.parametrize("bad", ["float16", "bias_dtype", "strided_dout"])
def test_backward_refuses_what_it_does_not_take(recorder, bad):
    """A float16 call, a bias of another dtype than q, and a non-contiguous
    dO raise before any C entry is called, in each backward wrapper."""
    for kernel, (launch, _) in _BWD.items():
        ops = _bwd_operands(torch.float16 if bad == "float16" else torch.float32)
        if bad == "bias_dtype":
            ops[3] = ops[3].to(torch.bfloat16)
        elif bad == "strided_dout":
            ops[5] = ops[5].transpose(1, 2).contiguous().transpose(1, 2)
            assert not ops[5].is_contiguous()
        before = _BWD_WRAPPERS[kernel].launches
        with pytest.raises((TypeError, ValueError)):
            launch(*ops)
        assert not recorder.calls and _BWD_WRAPPERS[kernel].launches == before


def _flash_bias_backward(dtype, bias_grad):
    """One _FlashBias forward (the plain version) and backward through the
    backward wrappers' CUDA halves."""
    ops = _bwd_operands(dtype, n=264, m=264)
    q, k, v, bias, mask = ops[:5]
    leaves = [t.requires_grad_() for t in (q, k, v)]
    bias.requires_grad_(bias_grad)
    out = tfa._FlashBias.apply(*leaves, bias, mask,
                               tfa._flash_bias_fwd_stats_reference,
                               *(launch for launch, _ in _BWD.values()))
    return torch.autograd.grad(out, leaves + ([bias] if bias_grad else []),
                               torch.ones_like(out))


@pytest.mark.parametrize("bias_grad", [False, True])
def test_flash_bias_backward_reaches_the_fp32_entries(recorder, bias_grad):
    """An fp32 backward no longer raises: it reaches kernel 6 (or 7 when the
    bias needs a gradient) and kernel 8 in their fp32 instantiations."""
    grads = _flash_bias_backward(torch.float32, bias_grad)
    dq = "dq_dbias" if bias_grad else "dq"
    assert [name for name, _ in recorder.calls] == [
        f"mrb_flash_bias_bwd_{dq}_f32", "mrb_flash_bias_bwd_dkv_f32"]
    assert all(g.dtype == torch.float32 for g in grads)


def test_flash_bias_backward_refuses_float16(recorder):
    """A float16 backward still raises, before any C entry is called."""
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        _flash_bias_backward(torch.float16, False)
    assert not recorder.calls


def test_kernel4_takes_packed_views_uncopied(recorder):
    """The ViT's q/k/v views of the packed projection go to the C entry as
    they are: their own data pointers and strides."""
    b, n, h, d = 2, 300, 4, 88
    qkv = torch.zeros(b, n, 3 * h * d, dtype=torch.bfloat16)
    q, k, v = qkv.view(b, n, 3, h, d).unbind(2)
    tfa._flash_cuda(q, k, v, causal=True)
    (name, args), = recorder.calls
    assert name == "mrb_flash_attention"
    assert args[:3] == (q.data_ptr(), k.data_ptr(), v.data_ptr())
    assert args[4:9] == (b, n, n, h, d)
    assert args[9:18] == (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    assert args[18:20] == (1, 0)  # causal, not fp32


@pytest.mark.parametrize("n", [256, 300])
def test_fp32_biased_dispatch_is_plain_on_cpu_and_matches_jax(n):
    """At 256 queries and more a biased fp32 call with a key-only mask is
    the biased kernel's on the card; on the CPU it stays the plain function
    (no launch) and equals JAX's."""
    rng = np.random.default_rng(11)
    b, h, d = 2, 4, 64
    q, k, v = (rng.standard_normal((b, n, h, d)).astype(np.float32) for _ in range(3))
    bias = rng.standard_normal((1, h, n, n)).astype(np.float32)
    mask = np.ones((b, 1, 1, n), bool)
    mask[1, ..., n - 41:] = False
    want = jattn.dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       bias=jnp.asarray(bias), mask=jnp.asarray(mask))
    before = tfa.flash_attention_bias.launches
    got = dot_product_attention(*(torch.from_numpy(x) for x in (q, k, v, bias, mask)))
    assert tfa.flash_attention_bias.launches == before
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_flash_module_imports_without_a_toolkit(tmp_path):
    """Importing the kernel wrappers builds and loads nothing: no nvcc on
    the PATH, no CUDA toolkit, and the library is still unloaded after."""
    code = ("import mr_blip_tpu_torch.ops.flash_attention as fa\n"
            "from mr_blip_tpu_torch.ops import _cuda\n"
            "assert _cuda.library.cache_info().currsize == 0\n"
            "print(fa.MAX_HEAD_DIM)\n")
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path))
    root = str(_cuda._PKG.parent)
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == str(tfa.MAX_HEAD_DIM)


# ------------------------------------------------- kernel 2 (packed QKV, ViT)
def test_kernel2_wrapper_passes_the_same_arguments(recorder):
    """The packed-QKV wrapper reaches its C entry with the packed tensor, the
    (B, N, H*D) output, (B, N, H, D), n_valid and the scale, as before the
    kernel moved to the Hopper tile, and counts one launch."""
    b, n, h, d, n_valid = 3, 264, 4, 88, 257
    qkv = torch.zeros(b, n, 3 * h * d, dtype=torch.bfloat16)
    before = tfa.flash_attention_qkv_packed.launches
    out = tfa._qkv_packed_cuda(qkv, h, d, n_valid)
    assert tfa.flash_attention_qkv_packed.launches == before + 1
    (name, args), = recorder.calls
    assert name == "mrb_qkv_packed_attention_bf16"
    assert len(args) == len(_cuda._SIGNATURES[name])
    assert args[:7] == (qkv.data_ptr(), out.data_ptr(), b, n, h, d, n_valid)
    assert args[7] == pytest.approx(d ** -0.5) and args[8] == 0
    assert out.shape == (b, n, h * d) and out.dtype == torch.bfloat16


@pytest.mark.parametrize("n,n_valid,path", [
    (257, 0, "resident"), (264, 257, "resident"), (50, 0, "resident"),
    (320, 0, "resident"), (330, 320, "resident"), (321, 0, "streaming"),
    (496, 0, "streaming"), (677, 0, "streaming")])
def test_kernel2_path_by_shape(n, n_valid, path):
    """The host's mirror of the C entry's choice: K/V resident up to as many
    key tiles of valid keys as the source's KV_TILES, streamed above."""
    src = (_cuda.CSRC / "attention_tile_sm90.cuh").read_text()
    tiles = int(re.search(r"constexpr int KV_TILES = (\d+);", src).group(1))
    assert tiles == tfa.QKV_RESIDENT_KEY_TILES
    assert tfa.qkv_packed_path(n, n_valid) == path


# --------------------------------------- kernels 9-12 (in-kernel rel-pos bias)
# name -> (the wrapper's CUDA half, the wrapper, output count)
_RELPOS = {"fwd_stats": (tfa._flash_relpos_fwd_stats_cuda, tfa.flash_relpos_fwd_stats, 2),
           "bwd_dq": (tfa._flash_relpos_bwd_dq_cuda, tfa.flash_relpos_bwd_dq, 1),
           "bwd_dq_dtable": (tfa._flash_relpos_bwd_dq_dtable_cuda,
                             tfa.flash_relpos_bwd_dq_dtable, 3),
           "bwd_dkv": (tfa._flash_relpos_bwd_dkv_cuda, tfa.flash_relpos_bwd_dkv, 2)}
_NB, _MAXD = 32, 128


def _relpos_operands(kernel, dtype, b=2, n=300, h=4, d=64):
    q, k, v, dout = (torch.zeros(b, n, h, d, dtype=dtype) for _ in range(4))
    table = torch.zeros(h, _NB)
    mask = torch.ones(b, n, dtype=torch.int8)
    if kernel == "fwd_stats":
        return [q, k, v, table, mask, _NB, _MAXD]
    lse, delta = (torch.zeros(b, h, n) for _ in range(2))
    return [q, k, v, table, mask, dout, lse, delta, _NB, _MAXD]


@pytest.mark.parametrize("kernel", sorted(_RELPOS))
@pytest.mark.parametrize("dtype,suffix", [(torch.bfloat16, "bf16"),
                                          (torch.float32, "f32")])
def test_relpos_kernel_entry_by_dtype(recorder, kernel, dtype, suffix):
    """Kernel 9 and the three rel-pos backward wrappers reach the C entry of
    q's dtype with its full argument list (kernel 9: the far thresholds the
    wrapper computes from the bucket table) and count one launch."""
    b, n, h, d = 2, 300, 4, 64
    ops = _relpos_operands(kernel, dtype, b, n, h, d)
    launch, wrapper, n_out = _RELPOS[kernel]
    before = wrapper.launches
    launch(*ops)
    assert wrapper.launches == before + 1
    (name, args), = recorder.calls
    assert name == f"mrb_flash_{'relpos_' + kernel}_{suffix}"
    assert len(args) == len(_cuda._SIGNATURES[name])
    n_in = 6 if kernel == "fwd_stats" else 9
    assert args[:4] == tuple(t.data_ptr() for t in ops[:4])
    shapes = args[n_in + n_out:]
    assert shapes[:6] == (b, n, h, d, _NB, _MAXD)
    if kernel == "fwd_stats":
        assert shapes[6:8] == tfa.relpos_far_thresholds(_NB, _MAXD)
    assert shapes[-2] == pytest.approx(d ** -0.5) and shapes[-1] == 0


@pytest.mark.parametrize("kernel", ["bwd_dq", "bwd_dq_dtable", "bwd_dkv"])
@pytest.mark.parametrize("dtype,suffix", [(torch.bfloat16, "bf16"),
                                          (torch.float32, "f32")])
def test_relpos_backward_far_thresholds_by_dtype(recorder, kernel, dtype, suffix):
    """The bf16 rel-pos backward entries (kernels 10-12 on the Hopper
    backward tile, with its far/near tile split) receive the far thresholds
    the wrapper computes from the bucket table, as past and future after nb
    and maxd; the fp32 entries' argument lists have none."""
    ops = _relpos_operands(kernel, dtype)
    launch, _, n_out = _RELPOS[kernel]
    launch(*ops)
    (name, args), = recorder.calls
    shapes = args[9 + n_out:]
    assert shapes[:6] == tuple(ops[0].shape) + (_NB, _MAXD)
    if suffix == "bf16":
        assert shapes[6:8] == tfa.relpos_far_thresholds(_NB, _MAXD) == (-91, 91)
        assert len(shapes) == 10
    else:
        assert len(shapes) == 8


@pytest.mark.parametrize("n", [1, 40, 64, 65, 257, 8000])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_relpos_dtable_workspace_holds_every_partial(recorder, monkeypatch, n, dtype):
    """The workspace kernel 11's wrapper hands its C entry holds every partial
    sum the entry documents it writes: in bf16 one per (batch row, 64-row
    half of each 128-query block, head, bucket), the halves past N included
    (at N <= 64 a block's second half owns no row and writes zeros); in fp32
    one per (batch row, 128-query block, head, bucket)."""
    b, h = 2, 2
    made = {}
    real_empty = torch.empty

    def empty(*args, **kw):
        t = real_empty(*args, **kw)
        made[t.data_ptr()] = t
        return t

    monkeypatch.setattr(torch, "empty", empty)
    ops = _relpos_operands("bwd_dq_dtable", dtype, b=b, n=n, h=h)
    tfa._flash_relpos_bwd_dq_dtable_cuda(*ops)
    (name, args), = recorder.calls
    partial = made[args[11]]  # after the 9 operands, dq and dtable
    blocks = -(-n // 128)
    writes = b * (2 * blocks if dtype == torch.bfloat16 else blocks) * h * _NB
    assert partial.dtype == torch.float32 and partial.is_contiguous()
    assert partial.numel() >= writes


@pytest.mark.parametrize("kernel", sorted(_RELPOS))
def test_relpos_kernels_refuse_float16(recorder, kernel):
    launch, wrapper, _ = _RELPOS[kernel]
    before = wrapper.launches
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        launch(*_relpos_operands(kernel, torch.float16))
    assert not recorder.calls and wrapper.launches == before


@pytest.mark.parametrize("table_grad", [False, True])
def test_flash_relpos_backward_reaches_the_fp32_entries(recorder, table_grad):
    """An fp32 backward through ``_FlashRelpos`` reaches kernel 10 (11 when
    the table trains) and kernel 12 in their fp32 instantiations; float16
    raises before any C entry."""
    q, k, v, table, mask = _relpos_operands("fwd_stats", torch.float32, n=264)[:5]
    leaves = [t.requires_grad_() for t in (q, k, v)]
    table.requires_grad_(table_grad)
    fwd = tfa._flash_relpos_fwd_stats_reference
    out = tfa._FlashRelpos.apply(*leaves, table, mask, _NB, _MAXD, fwd,
                                 tfa._flash_relpos_bwd_dq_cuda,
                                 tfa._flash_relpos_bwd_dq_dtable_cuda,
                                 tfa._flash_relpos_bwd_dkv_cuda)
    grads = torch.autograd.grad(out, leaves + ([table] if table_grad else []),
                                torch.ones_like(out))
    dq = "dq_dtable" if table_grad else "dq"
    assert [name for name, _ in recorder.calls] == [
        f"mrb_flash_relpos_bwd_{dq}_f32", "mrb_flash_relpos_bwd_dkv_f32"]
    assert all(g.dtype == torch.float32 for g in grads)
    q16, k16, v16 = (t.detach().half() for t in (q, k, v))
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        tfa._flash_relpos_bwd_dq_cuda(q16, k16, v16, table.detach(), mask, q16,
                                      torch.zeros(2, 4, 264), torch.zeros(2, 4, 264),
                                      _NB, _MAXD)
    assert len(recorder.calls) == 2


# ------------------------------------------------------------- LayerNorm
def _ln_operands(rows, d, x_offset=0, weight_offset=0):
    """bf16 x (rows, d) and fp32 weight and bias, each starting `offset`
    elements into its buffer (an offset of 1 leaves it off 16-byte
    alignment)."""
    x = torch.zeros(rows * d + x_offset, dtype=torch.bfloat16)[x_offset:].view(rows, d)
    w, b = (torch.zeros(d + weight_offset)[weight_offset:] for _ in range(2))
    return x, w, b


@pytest.mark.parametrize("d,x_offset,weight_offset,kernel", [
    (1408, 0, 0, "row1408"), (768, 0, 0, "row768"), (1024, 0, 0, "vec8"),
    (100, 0, 0, "scalar"), (1408, 0, 1, "vec8"), (1408, 1, 0, "scalar"),
    (768, 1, 1, "scalar")])
def test_layer_norm_kernel_by_width(recorder, d, x_offset, weight_offset, kernel):
    """The register kernels take their own width with every operand 16-byte
    aligned; another width that is a multiple of 8, or unaligned weights,
    the generic 16-byte kernel; unaligned rows or an odd width the scalar
    one. One launch, counted, with the kernel's id."""
    rows = 37
    x, w, b = _ln_operands(rows, d, x_offset, weight_offset)
    before = tln.fused_layer_norm.launches
    out = tln._layer_norm_cuda(x, w, b, 1e-6)
    assert out.shape == x.shape and out.dtype == torch.bfloat16
    assert tln.fused_layer_norm.launches == before + 1
    (name, args), = recorder.calls
    assert name == "mrb_layer_norm_bf16"
    assert len(args) == len(_cuda._SIGNATURES[name])
    assert args[4:6] == (rows, d) and args[7] == tln._LN_KERNELS[kernel]


@pytest.mark.parametrize("bad", ["float32", "strided", "weight_dtype", "weight_shape"])
def test_layer_norm_kernel_refuses_what_it_does_not_take(recorder, bad):
    x, w, b = _ln_operands(16, 768)
    if bad == "float32":
        x = x.float()
    elif bad == "strided":
        x = torch.zeros(16, 2 * 768, dtype=torch.bfloat16)[:, :768]
    elif bad == "weight_dtype":
        w = w.to(torch.bfloat16)
    else:
        b = torch.zeros(767)
    before = tln.fused_layer_norm.launches
    with pytest.raises((TypeError, ValueError)):
        tln._layer_norm_cuda(x, w, b, 1e-12)
    assert not recorder.calls and tln.fused_layer_norm.launches == before


# ---------------------------------------------------- the W8A8 GELU MLP
def _mlp_operands(m, d, h):
    x, r = (torch.zeros(m, d, dtype=torch.bfloat16) for _ in range(2))
    w1 = tint8.k_major(torch.zeros(d, h, dtype=torch.int8))
    w2 = tint8.k_major(torch.zeros(h, d, dtype=torch.int8))
    s1, b1, s2, b2 = torch.ones(h), torch.zeros(h), torch.ones(d), torch.zeros(d)
    norm = ("ln", torch.ones(d), torch.zeros(d), 1e-6)
    return x, r, (w1, s1, b1, w2, s2, b2), norm


def _spy(monkeypatch, module, name):
    """Record what ``module.name`` returns."""
    made = []
    real = getattr(module, name)

    def spy(*args):
        made.append(real(*args))
        return made[-1]

    monkeypatch.setattr(module, name, spy)
    return made


@pytest.mark.parametrize("m", [1, 300])
def test_w8a8_mlp_workspace_holds_no_fp32_hidden(recorder, monkeypatch, m):
    """Kernel 14's workspace is xq (M, D) int8, sa (M), hq (M, H) int8 and sh
    (M, H / block_h) fp32, passed in that order, then the shape and fc1's
    cluster size: fc1 requantizes its hidden in its epilogue."""
    d, h = 1408, 6144
    made = _spy(monkeypatch, tint8, "_mlp_workspace")
    x, r, weights, norm = _mlp_operands(m, d, h)
    before = tint8.w8a8_mlp.launches
    out = tint8._w8a8_mlp_cuda(x, *weights, norm, r, tint8.DEFAULT_BLOCK_H)
    assert out.shape == (m, d) and tint8.w8a8_mlp.launches == before + 1
    (name, args), = recorder.calls
    assert name == "mrb_w8a8_mlp" and len(args) == len(_cuda._SIGNATURES[name])
    (ws,) = made
    assert [(t.dtype, tuple(t.shape)) for t in ws] == [
        (torch.int8, (m, d)), (torch.float32, (m,)), (torch.int8, (m, h)),
        (torch.float32, (m, h // 1536))]
    assert list(args[13:17]) == [t.data_ptr() for t in ws]
    assert args[17:22] == (m, d, h, 1536, 8)
    assert tint8._mlp_plan(h, 1536) == (192, 8)


def _gated_operands(m, d, h):
    x, r = (torch.zeros(m, d, dtype=torch.bfloat16) for _ in range(2))
    w0, w1 = (tint8.k_major(torch.zeros(d, h, dtype=torch.int8)) for _ in range(2))
    wo = tint8.k_major(torch.zeros(h, d, dtype=torch.int8))
    weights = (w0, torch.ones(h), w1, torch.ones(h), wo, torch.ones(d))
    return x, r, weights, ("rms", torch.ones(d), None, 1e-6)


def test_gated_mlp_keeps_its_fp32_hidden(recorder, monkeypatch):
    """The chain route (the tiny T5's hidden of 256 in chunks of 128, which
    no cluster of 80-column gated fc1 tiles covers) keeps its fp32 hidden:
    xq, sa, h32, hq, sh, passed in that order to the chain's C entry."""
    m, d, h = 19, 64, 256
    made = _spy(monkeypatch, tint8, "_chain_workspace")
    x = torch.zeros(m, d, dtype=torch.bfloat16)
    w, s = tint8.k_major(torch.zeros(d, h, dtype=torch.int8)), torch.ones(h)
    wo = tint8.k_major(torch.zeros(h, d, dtype=torch.int8))
    tint8._w8a8_mlp_gated_cuda(x, w, s, w, s, wo, torch.ones(d), None, None, 128)
    (name, args), = recorder.calls
    assert name == "mrb_w8a8_mlp_gated_chain" and len(args) == len(_cuda._SIGNATURES[name])
    (ws,) = made
    assert [(t.dtype, tuple(t.shape)) for t in ws] == [
        (torch.int8, (m, d)), (torch.float32, (m,)), (torch.float32, (m, h)),
        (torch.int8, (m, h)), (torch.float32, (m, 2))]
    assert list(args[13:18]) == [t.data_ptr() for t in ws]


@pytest.mark.parametrize("m", [19, 300])
def test_w8a8_mlp_gated_workspace_holds_no_fp32_hidden(recorder, monkeypatch, m):
    """Kernel 15 at Flan-T5-XL's widths: its workspace is xq (M, D) int8, sa
    (M), hq (M, H) int8 and sh (M, H / 640) fp32, passed in that order, then
    the shape, the chunk width and the gated fc1's cluster size: gate and up
    requantize in the epilogue of their one product."""
    d, h = 2048, 5120
    made = _spy(monkeypatch, tint8, "_mlp_workspace")
    x, r, weights, norm = _gated_operands(m, d, h)
    before = tint8.w8a8_mlp_gated.launches
    out = tint8._w8a8_mlp_gated_cuda(x, *weights, norm, r, tint8.DEFAULT_GATED_BLOCK_H)
    assert out.shape == (m, d) and tint8.w8a8_mlp_gated.launches == before + 1
    (name, args), = recorder.calls
    assert name == "mrb_w8a8_mlp_gated" and len(args) == len(_cuda._SIGNATURES[name])
    (ws,) = made
    assert [(t.dtype, tuple(t.shape)) for t in ws] == [
        (torch.int8, (m, d)), (torch.float32, (m,)), (torch.int8, (m, h)),
        (torch.float32, (m, h // 640))]
    assert list(args[13:17]) == [t.data_ptr() for t in ws]
    assert args[17:22] == (m, d, h, 640, 8)
    assert tint8._mlp_plan(h, 640, tint8.GATED_TILE) == (80, 8)


@pytest.mark.parametrize("hdim,block_h", [(5120, 640), (10240, 640), (640, 640)])
def test_gated_mlp_plan_covers_every_chunk_once(hdim, block_h):
    """The gated fc1's clusters of 80-column blocks (Flan-T5-XL's and -XXL's
    chunks of 640, and one chunk of 640) cover each hidden column once,
    every cluster inside one chunk and within the portable cluster size."""
    tile, cluster = tint8._mlp_plan(hdim, block_h, tint8.GATED_TILE)
    assert tile == tint8.GATED_TILE and 1 <= cluster <= tint8.MAX_FC1_CLUSTER
    assert tile * cluster == block_h
    columns = [chunk * block_h + rank * tile + c for chunk in range(hdim // block_h)
               for rank in range(cluster) for c in range(tile)]
    assert sorted(columns) == list(range(hdim))


@pytest.mark.parametrize("hdim,block_h,chunk,route", [
    (5120, 640, 640, "tile"), (10240, 640, 640, "tile"), (640, 640, 640, "tile"),
    (256, 128, 128, "chain"), (2048, 640, 512, "chain"), (64, 640, 64, "chain")])
def test_gated_mlp_route_by_shape(recorder, hdim, block_h, chunk, route):
    """The gated MLP's route is chosen by the chunk ``_pick_block`` gives,
    before any launch and with no raise for any width the first version
    took: 640-column chunks on the tile (a cluster of 8 gated fc1 blocks),
    the tiny T5's chunks of 128 and 64, and Flan-T5-base's 512, on the
    chain."""
    assert tint8._pick_block(hdim, block_h) == chunk
    assert tint8._mlp_route(hdim, chunk, tint8.GATED_TILE) == route
    m, d = 4, 64
    x, r, weights, norm = _gated_operands(m, d, hdim)
    before = tint8.w8a8_mlp_gated.launches
    out = tint8._w8a8_mlp_gated_cuda(x, *weights, norm, r, block_h)
    assert out.shape == (m, d) and tint8.w8a8_mlp_gated.launches == before + 1
    (name, args), = recorder.calls
    assert len(args) == len(_cuda._SIGNATURES[name])
    if route == "tile":
        assert name == "mrb_w8a8_mlp_gated"
        assert args[17:22] == (m, d, hdim, chunk, chunk // tint8.GATED_TILE)
    else:
        assert name == "mrb_w8a8_mlp_gated_chain" and args[18:22] == (m, d, hdim, chunk)


@pytest.mark.parametrize("hdim,block_h", [(6144, 1536), (1536, 1536), (3072, 768),
                                          (192, 192), (768, 384)])
def test_mlp_plan_covers_every_chunk_once(hdim, block_h):
    """fc1's clusters of 192-column blocks cover each hidden column once,
    every cluster inside one chunk and within the portable cluster size."""
    tile, cluster = tint8._mlp_plan(hdim, block_h)
    assert tile == tint8.FC1_TILE and 1 <= cluster <= tint8.MAX_FC1_CLUSTER
    assert tile * cluster == block_h
    columns = [chunk * block_h + rank * tile + c for chunk in range(hdim // block_h)
               for rank in range(cluster) for c in range(tile)]
    assert sorted(columns) == list(range(hdim))


@pytest.mark.parametrize("hdim,block_h,chunk,route", [
    (384, 128, 128, "chain"), (640, 640, 640, "chain"), (6144, 1000, 768, "tile"),
    (3072, 3072, 3072, "chain"), (1152, 576, 384, "tile"), (384, 192, 128, "chain")])
def test_mlp_plan_raises_for_a_chunk_it_cannot_cover(recorder, hdim, block_h, chunk, route):
    """A chunk that is not 1 to 8 tiles of 192 (or whose chunks are not whole
    128-column K tiles of fc2) has no cluster plan. The JAX kernel computes
    every one of these widths (after ``_pick_block``), and so does the card:
    the chunk ``_pick_block`` gives runs fc1's clusters where they cover it,
    else the chain route, with no raise."""
    with pytest.raises(ValueError):
        tint8._mlp_plan(hdim, block_h)
    assert tint8._pick_block(hdim, block_h) == chunk
    assert tint8._mlp_route(hdim, chunk) == route
    m, d = 4, 64
    x, r, weights, norm = _mlp_operands(m, d, hdim)
    before = tint8.w8a8_mlp.launches
    out = tint8._w8a8_mlp_cuda(x, *weights, norm, r, block_h)
    assert out.shape == (m, d) and tint8.w8a8_mlp.launches == before + 1
    (name, args), = recorder.calls
    assert len(args) == len(_cuda._SIGNATURES[name])
    if route == "tile":
        assert name == "mrb_w8a8_mlp"
        assert args[17:22] == (m, d, hdim, chunk, tint8._mlp_plan(hdim, chunk)[1])
    else:
        assert name == "mrb_w8a8_mlp_chain" and args[18:22] == (m, d, hdim, chunk)


@pytest.mark.parametrize("m,d,h,block_h", [(300, 32, 64, 1536), (19, 128, 384, 128),
                                           (5, 1408, 3072, 3072)])
def test_w8a8_mlp_chain_route_keeps_its_fp32_hidden(recorder, monkeypatch, m, d, h, block_h):
    """The chain route's workspace is xq (M, D) int8, sa (M), h32 (M, H) fp32,
    hq (M, H) int8 and sh (M, H / chunk), passed in that order, then the
    shape and the chunk width (the tiny ViT's hidden of 64 is one chunk)."""
    made = _spy(monkeypatch, tint8, "_chain_workspace")
    x, r, weights, norm = _mlp_operands(m, d, h)
    tint8._w8a8_mlp_cuda(x, *weights, norm, r, block_h)
    (name, args), = recorder.calls
    chunk = tint8._pick_block(h, block_h)
    assert name == "mrb_w8a8_mlp_chain" and len(args) == len(_cuda._SIGNATURES[name])
    (ws,) = made
    assert [(t.dtype, tuple(t.shape)) for t in ws] == [
        (torch.int8, (m, d)), (torch.float32, (m,)), (torch.float32, (m, h)),
        (torch.int8, (m, h)), (torch.float32, (m, h // chunk))]
    assert list(args[13:18]) == [t.data_ptr() for t in ws]
    assert args[18:22] == (m, d, h, chunk)


# ------------------------------------------------------- the W8A8 linear
@pytest.mark.parametrize("n,tn", [(1408, 176), (1536, 192), (2048, 192), (4224, 192),
                                  (6144, 192), (96, 192), (64, 192)])
def test_linear_plan_covers_every_column_once(n, tn):
    """The GEMM tile's column tiles cover [0, N) once: every tile but a
    ragged last one whole, that one cut at N."""
    width, tiles = tint8._linear_plan(n)
    assert width == tn and width in tint8.LINEAR_TILES
    columns = [c for i in range(tiles) for c in range(i * width, (i + 1) * width) if c < n]
    assert columns == list(range(n)) and (tiles - 1) * width < n


def _linear_operands(m, k, n, kind, has_bias, has_residual):
    x = torch.zeros(m, k, dtype=torch.bfloat16)
    wq = tint8.k_major(torch.zeros(k, n, dtype=torch.int8))
    bias = torch.zeros(n) if has_bias else None
    res = torch.zeros(m, n, dtype=torch.bfloat16) if has_residual else None
    norm = None if kind is None else (kind, torch.ones(k), torch.zeros(k) if kind == "ln"
                                      else None, 1e-6)
    return x, wq, torch.ones(n), bias, norm, res


@pytest.mark.parametrize("m,k,n,kind,has_bias,has_residual", [
    (61680, 1408, 1536, None, True, False), (8224, 2048, 6144, "rms", False, False),
    (8224, 2048, 2048, None, False, True), (3, 1408, 4224, "ln", True, False),
    (7, 32, 96, "ln", True, False), (5, 64, 64, None, False, True), (1, 16, 8, None, True, True)])
def test_w8a8_linear_launches_every_shape_it_took(recorder, m, k, n, kind, has_bias,
                                                  has_residual):
    """Every (K, N) with K % 16 == 0 and N % 8 == 0 launches the one C entry,
    the tiny configs' widths too, with the column tile of ``_linear_plan``."""
    x, wq, sw, bias, norm, res = _linear_operands(m, k, n, kind, has_bias, has_residual)
    before = tint8.w8a8_linear.launches
    out = tint8._w8a8_linear_cuda(x, wq, sw, bias, norm, res)
    assert out.shape == (m, n) and tint8.w8a8_linear.launches == before + 1
    (name, args), = recorder.calls
    assert name == "mrb_w8a8_linear" and len(args) == len(_cuda._SIGNATURES[name])
    assert args[3] == {None: 0, "ln": 1, "rms": 2}[kind]
    assert args[12:16] == (m, k, n, tint8._linear_plan(n)[0])
    assert (args[7] is None) == (bias is None) and (args[8] is None) == (res is None)


# ---------------------------------------------- the W8A8 attention block
@pytest.mark.parametrize("b,n,c,heads,n_valid", [(2, 264, 1408, 16, 257), (3, 257, 1408, 16, 0),
                                                 (1, 9, 64, 8, 0), (2, 17, 96, 1, 16),
                                                 (1, 400, 1408, 16, 0)])
def test_w8a8_attn_block_passes_its_workspace(recorder, monkeypatch, b, n, c, heads, n_valid):
    """Kernel 16's workspace is xq (B N, C) int8, sa (B N), qkv (B N, 3C)
    bf16 and attn (B N, C) bf16, in that order; then the shape, bf16(D^-1/2)
    and the GEMM tile's column widths of qkv and proj. Head dims 8 to 96
    (multiples of 8) launch."""
    made = _spy(monkeypatch, tint8, "_attn_block_workspace")
    x = torch.zeros(b, n, c, dtype=torch.bfloat16)
    wqkv = tint8.k_major(torch.zeros(c, 3 * c, dtype=torch.int8))
    wproj = tint8.k_major(torch.zeros(c, c, dtype=torch.int8))
    ones = torch.ones
    before = tint8.w8a8_attn_block.launches
    out = tint8._w8a8_attn_block_cuda(x, wqkv, ones(3 * c), ones(3 * c), wproj, ones(c),
                                      ones(c), ones(c), ones(c), 1e-6, heads, n_valid)
    assert out.shape == x.shape and tint8.w8a8_attn_block.launches == before + 1
    (name, args), = recorder.calls
    assert name == "mrb_w8a8_attn_block" and len(args) == len(_cuda._SIGNATURES[name])
    (ws,) = made
    rows = b * n
    assert [(t.dtype, tuple(t.shape)) for t in ws] == [
        (torch.int8, (rows, c)), (torch.float32, (rows,)), (torch.bfloat16, (rows, 3 * c)),
        (torch.bfloat16, (rows, c))]
    assert list(args[11:15]) == [t.data_ptr() for t in ws]
    hd = c // heads
    assert args[15:20] == (b, n, c, heads, n_valid)
    assert args[20] == float(torch.tensor(hd ** -0.5, dtype=torch.bfloat16))
    assert args[21:23] == (tint8._linear_plan(3 * c)[0], tint8._linear_plan(c)[0])


@pytest.mark.parametrize("c,heads", [(64, 16), (208, 2), (1408, 11)])
def test_w8a8_attn_block_refuses_head_dims_it_does_not_take(recorder, c, heads):
    """Head dims that are not a multiple of 8 up to 96 raise before any
    launch (4, 104, 128)."""
    x = torch.zeros(1, 9, c, dtype=torch.bfloat16)
    wqkv = tint8.k_major(torch.zeros(c, 3 * c, dtype=torch.int8))
    wproj = tint8.k_major(torch.zeros(c, c, dtype=torch.int8))
    ones = torch.ones
    before = tint8.w8a8_attn_block.launches
    with pytest.raises(ValueError):
        tint8._w8a8_attn_block_cuda(x, wqkv, ones(3 * c), ones(3 * c), wproj, ones(c),
                                    ones(c), ones(c), ones(c), 1e-6, heads, 0)
    assert not recorder.calls and tint8.w8a8_attn_block.launches == before
