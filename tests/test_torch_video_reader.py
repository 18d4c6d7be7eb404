"""The port's FFmpeg video reader against the JAX package's, on the CPU.

Mirrors ``tests/test_video_decode.py``. It skips only where ``pkg-config``
finds no FFmpeg or the FFmpeg build has no encoder for a codec; a failing
``g++`` or a library that does not load fails. On h264 (B-frames, GOP 30)
and mpeg4 clips from ``write_test_video``, the port's ``VideoReader`` and
the JAX package's return bit-equal uint8 frames for random, sequential and
stepped ``get_batch``, ``get_window``, their async forms through the decode
pool and many jobs in flight; ``pts_map_info`` agrees. The port's library is
built from ``mr_blip_tpu_torch/native/video_decoder.cpp`` into the
git-ignored ``_build/``. Without FFmpeg a file URI raises an error that
names it, and ``synthetic://`` still works.
"""

import contextlib
import fcntl
import functools
import hashlib
import io
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from mr_blip_tpu_torch.datasets import video_reader as tvr
from mr_blip_tpu_torch.native import build as tbuild

REPO = Path(__file__).resolve().parent.parent


@functools.lru_cache(maxsize=1)
def _loaded_readers():
    from mr_blip_tpu.datasets import video_reader as jvr
    from mr_blip_tpu.native import build as jbuild

    tvr._lib()
    # The JAX package's build writes its library in place, so a parallel
    # test worker could load it half written. Build its source here instead,
    # once under a file lock, to a temporary name renamed into place, and
    # load that: its build returns a library path that is current as it is.
    cflags, libs = tbuild.ffmpeg_flags()
    digest = hashlib.sha256(" ".join(cflags + libs).encode())
    digest.update(Path(jbuild.SOURCE).read_bytes())
    lib = tbuild.BUILD_ROOT / "jax" / digest.hexdigest()[:16] / "libvideodecoder.so"
    lib.parent.mkdir(parents=True, exist_ok=True)
    in_place = jbuild.LIB
    with open(lib.parent / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not lib.exists():
                jbuild.LIB = f"{lib}.{os.getpid()}.tmp"
                jbuild.build(force=True)
                os.replace(jbuild.LIB, lib)
            jbuild.LIB = str(lib)
            jvr._lib()
        finally:
            jbuild.LIB = in_place
    return jvr


def native_readers():
    """The JAX package's reader module, with both decoder libraries built
    and loaded; skips only where pkg-config finds no FFmpeg."""
    try:
        tbuild.ffmpeg_flags()
    except tbuild.FFmpegUnavailable as e:
        pytest.skip(str(e))
    return _loaded_readers()


@contextlib.contextmanager
def encoder_or_skip(codec):
    """Skips where this FFmpeg build has no ``codec`` encoder (the writer's
    code -1); any other failure fails the test."""
    try:
        with contextlib.redirect_stderr(io.StringIO()):
            yield
    except IOError as e:
        if not str(e).endswith("failed: -1"):
            raise
        pytest.skip(f"this FFmpeg build has no {codec} encoder: {e}")


@pytest.fixture(scope="module", params=["mpeg4", "libx264"])
def clip(request, tmp_path_factory):
    """(path, frames, fps, width, height) of a clip the port's writer encodes."""
    native_readers()
    codec = request.param
    if codec == "mpeg4":
        path, n, fps, w, h, gop = "clip.avi", 40, 10.0, 64, 48, 8
    else:
        path, n, fps, w, h, gop = "clip.mp4", 120, 10.0, 128, 96, 30
    path = str(tmp_path_factory.mktemp("vid") / path)
    with encoder_or_skip(codec):
        tvr.write_test_video(path, w=w, h=h, n_frames=n, fps=fps, gop=gop, codec=codec)
    return path, n, fps, w, h


def _pair(path, **kw):
    return tvr.VideoReader(path, **kw), native_readers().VideoReader(path, **kw)


def _both(path, fn, **kw):
    port, jax_ = _pair(path, **kw)
    try:
        return fn(port), fn(jax_)
    finally:
        port.close()
        jax_.close()


def _pattern_residual(frame, k, w, h):
    """Mean |decoded luma - analytic pattern| for frame index k (as in
    tests/test_video_decode.py): ~3 for the right frame, >12 for an
    off-by-one."""
    rgb = frame.astype(np.float64)
    luma = 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
    pat = ((np.arange(w)[None, :] * 3 + np.arange(h)[:, None] + k * 16)
           & 0xFF).astype(np.float64)
    a = np.vstack([pat.ravel(), np.ones(pat.size)]).T
    coef, *_ = np.linalg.lstsq(a, luma.ravel(), rcond=None)
    return float(np.abs(a @ coef - luma.ravel()).mean())


def test_metadata_equal_jax(clip):
    path, n, fps, w, h = clip
    got, want = _both(path, lambda vr: (len(vr), vr.get_avg_fps(), vr.duration,
                                        vr.pts_map_info()))
    assert got == want
    assert got[0] == n and got[1] == fps
    assert got[3][0]  # the exact pts map


@pytest.mark.parametrize("order", ["random", "sequential", "stepped"])
def test_get_batch_bit_equal_jax(clip, order):
    path, n, fps, w, h = clip
    idx = {"random": [n - 20, 3, n // 2 + 4, n // 2 - 1, n // 2 + 1, n - 1, 0],
           "sequential": list(range(n)),
           "stepped": list(range(2, n, 7))}[order]
    got, want = _both(path, lambda vr: vr.get_batch(idx))
    assert got.dtype == np.uint8 and got.shape == (len(idx), h, w, 3)
    np.testing.assert_array_equal(got, want)
    for i, k in enumerate(idx):
        assert _pattern_residual(got[i], k, w, h) < 8.0, f"frame {k}"


def test_get_batch_one_frame_at_a_time_bit_equal_jax(clip):
    """Forward decode with the non-reference discard catch-up engaged."""
    path, n, fps, w, h = clip
    ks = [0, n // 5, n // 2 - 2, 3 * n // 4, n - 1]
    got, want = _both(path, lambda vr: [vr.get_batch([k])[0] for k in ks])
    np.testing.assert_array_equal(np.stack(got), np.stack(want))


def test_get_window_bit_equal_jax(clip):
    path, n, fps, w, h = clip
    got, want = _both(path, lambda vr: vr.get_window(0.5, 2.5, max_n=64))
    assert got.shape == (int(2.0 * fps), h, w, 3)
    np.testing.assert_array_equal(got, want)
    assert _pattern_residual(got[0], int(0.5 * fps), w, h) < 8.0


def test_async_equals_sync_and_jax(clip):
    path, n, fps, w, h = clip
    idx = [0, n // 2 + 1, n // 2 + 1, n // 4, n - 1, n // 3]
    port, jax_ = _pair(path)
    got = port.get_batch_async(idx).result()
    want = jax_.get_batch_async(idx).result()
    window = port.get_window_async(0.5, 2.5, max_n=64).result()
    window_jax = jax_.get_window_async(0.5, 2.5, max_n=64).result()
    port.close()
    jax_.close()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(window, window_jax)
    sync = tvr.VideoReader(path)
    np.testing.assert_array_equal(got, sync.get_batch(idx))
    np.testing.assert_array_equal(window, sync.get_window(0.5, 2.5, max_n=64))
    sync.close()


def test_many_jobs_in_flight_equal_jax(clip):
    """A batch per reader submitted before any is collected: the pool's
    workers decode concurrently, each result equal to the JAX reader's."""
    path, n, fps, w, h = clip
    jobs = []
    for k in range(6):
        vr = tvr.VideoReader(path, width=28, height=28)
        idx = [k, k + 5, 2 * k, n - 1 - k]
        jobs.append((vr, idx, vr.get_batch_async(idx)))
    for vr, idx, ticket in jobs:
        got = ticket.result()
        want, = _both(path, lambda r: r.get_batch(idx), width=28, height=28)[1:]
        assert got.shape == (4, 28, 28, 3)
        np.testing.assert_array_equal(got, want)
        vr.close()


def test_pts_cache_reuse_and_clear(clip):
    """A reopened clip is indexed from the cached pts map, as in JAX."""
    path, n, fps, w, h = clip
    lib = tvr._lib()
    lib.vd_pts_cache_clear()
    assert lib.vd_pts_cache_size() == 0
    first = tvr.VideoReader(path)
    assert lib.vd_pts_cache_size() == 1
    info = first.pts_map_info()
    first.close()
    again = tvr.VideoReader(path)
    assert lib.vd_pts_cache_size() == 1 and again.pts_map_info() == info
    got = again.get_batch([n // 2 + 1])
    again.close()
    want, = _both(path, lambda vr: vr.get_batch([n // 2 + 1]))[1:]
    np.testing.assert_array_equal(got, want)
    lib.vd_pts_cache_clear()
    assert lib.vd_pts_cache_size() == 0
    with pytest.raises(IOError, match="cannot open video"):
        tvr.VideoReader(str(Path(path).with_name("no_such_clip.mp4")))


def test_synthetic_gives_immediate_tickets():
    vr = tvr.VideoReader("synthetic://16x32x32@10.0#3", width=20, height=24)
    want = vr.get_batch([0, 5, 9])
    ticket = vr.get_batch_async([0, 5, 9])
    assert isinstance(ticket, tvr._ImmediateTicket)
    np.testing.assert_array_equal(ticket.result(), want)
    assert want.shape == (3, 24, 20, 3) and want.dtype == np.uint8
    window = vr.get_window_async(0.2, 0.6)
    assert isinstance(window, tvr._ImmediateTicket)
    np.testing.assert_array_equal(window.result(), vr.get_window(0.2, 0.6))
    assert vr.pts_map_info() == (False, 0)
    vr.close()


def test_synthetic_equals_jax():
    from mr_blip_tpu.datasets.video_reader import VideoReader as JaxReader

    uri = "synthetic://40x48x64@5.0#7"
    got, want = tvr.VideoReader(uri, width=28, height=28), JaxReader(uri, width=28, height=28)
    assert (len(got), got.get_avg_fps()) == (len(want), want.get_avg_fps())
    np.testing.assert_array_equal(got.get_batch([0, 3, 39]), want.get_batch([0, 3, 39]))
    np.testing.assert_array_equal(got.get_window(1.0, 3.0), want.get_window(1.0, 3.0))


def test_file_uri_without_ffmpeg_raises_naming_it(monkeypatch, tmp_path):
    """pkg-config finding no FFmpeg: opening a file raises FFmpegUnavailable
    naming FFmpeg; synthetic:// still reads."""
    monkeypatch.setattr(tbuild, "PACKAGES", ("libavformat-not-installed",))
    tvr._lib.cache_clear()
    try:
        with pytest.raises(tbuild.FFmpegUnavailable, match="FFmpeg"):
            tvr.VideoReader(str(tmp_path / "clip.mp4"))
        with pytest.raises(tbuild.FFmpegUnavailable, match="FFmpeg"):
            tvr.write_test_video(str(tmp_path / "clip.avi"))
        vr = tvr.VideoReader("synthetic://8x16x16")
        assert vr.get_batch_async([1, 2]).result().shape == (2, 16, 16, 3)
    finally:
        tvr._lib.cache_clear()


def test_import_builds_nothing_and_synthetic_needs_no_toolchain(tmp_path):
    """With no pkg-config and no g++ on the PATH, the reader imports and
    serves synthetic:// videos; a file URI raises naming FFmpeg."""
    code = (
        "import numpy as np\n"
        "from mr_blip_tpu_torch.datasets import video_reader as v\n"
        "from mr_blip_tpu_torch.native import build\n"
        "r = v.VideoReader('synthetic://8x16x16@4.0#1')\n"
        "assert r.get_batch([0, 7]).shape == (2, 16, 16, 3)\n"
        "try:\n"
        "    v.VideoReader('clip.mp4')\n"
        "except build.FFmpegUnavailable as e:\n"
        "    assert 'FFmpeg' in str(e), e\n"
        "else:\n"
        "    raise SystemExit('a file URI opened without FFmpeg')\n"
    )
    env = dict(os.environ, PATH=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stderr


def test_library_builds_into_the_ignored_build_dir():
    native_readers()
    path = Path(tbuild.build())
    assert path.name == "libvideodecoder.so"
    assert path.parent.parent == REPO / "mr_blip_tpu_torch" / "_build" / "native"
    assert tbuild.SOURCE == REPO / "mr_blip_tpu_torch" / "native" / "video_decoder.cpp"
    assert "mr_blip_tpu_torch/_build/" in (REPO / ".gitignore").read_text().split()
    # The port's decoder is the JAX package's source, byte for byte.
    assert tbuild.SOURCE.read_bytes() == (
        REPO / "mr_blip_tpu" / "native" / "video_decoder.cpp").read_bytes()
