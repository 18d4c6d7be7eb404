"""The host side of the hand-written flash kernels, on the CPU.

The CUDA sources compile only on the card; what surrounds them here is
Python that the CPU reaches: the ctypes signatures against the C entries in
``csrc/``, the wrappers' choice of C entry by dtype and the arguments they
pass (through a stand-in library that records the call), the fp32 biased
dispatch (the plain function on a CPU tensor, equal to JAX's), and a module
that imports with no CUDA toolkit.
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
