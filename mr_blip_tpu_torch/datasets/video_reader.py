"""VideoReader: random-access frame decode through the native FFmpeg library
(the port's copy of ``mr_blip_tpu/datasets/video_reader.py``).

API mirrors what the reference gets from decord
(``lavis/datasets/data_utils.py:38-83``): ``len(vr)`` = frame count,
``vr.get_avg_fps()``, ``vr.get_batch(indices) -> (T, H, W, C) uint8``;
plus ``get_window(t0, t1)`` used by the grounded-QA re-decode path
(reference PyAV ``get_frames``, blip2_mr_models/utils.py:532-606), and the
async forms of both, served by a process-wide pool of C++ decode threads.

A ``synthetic://{frames}x{h}x{w}[@fps][#seed]`` scheme serves deterministic
generated frames without any file I/O (tests, benchmarks,
``chip_smoke.py``); its async calls return an immediate ticket. The native
library (``native/video_decoder.cpp``) is built with ``g++`` at the first
file open (``native/build.py``); where ``pkg-config`` finds no FFmpeg,
opening a file raises ``native.build.FFmpegUnavailable``.
"""

from __future__ import annotations

import ctypes
import functools
import os
import re
import threading
from typing import Sequence

import numpy as np


@functools.lru_cache(maxsize=1)
def _lib():
    from mr_blip_tpu_torch.native.build import build

    lib = ctypes.CDLL(build())
    lib.vd_open_ex.restype = ctypes.c_void_p
    lib.vd_open_ex.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.vd_pts_cache_size.restype = ctypes.c_longlong
    lib.vd_pts_cache_size.argtypes = []
    lib.vd_pts_cache_clear.argtypes = []
    lib.vd_has_pts_map.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong),
    ]
    lib.vd_info.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.vd_get_batch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
        ctypes.POINTER(ctypes.c_ubyte),
    ]
    lib.vd_get_window.argtypes = [
        ctypes.c_void_p, ctypes.c_double, ctypes.c_double, ctypes.c_int,
        ctypes.POINTER(ctypes.c_ubyte), ctypes.POINTER(ctypes.c_int),
    ]
    lib.vd_close.argtypes = [ctypes.c_void_p]
    lib.vd_write_test_video_codec.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.c_int, ctypes.c_char_p,
    ]
    lib.vpool_create.restype = ctypes.c_void_p
    lib.vpool_create.argtypes = [ctypes.c_int]
    lib.vpool_submit_batch.restype = ctypes.c_longlong
    lib.vpool_submit_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong),
        ctypes.c_int, ctypes.POINTER(ctypes.c_ubyte),
    ]
    lib.vpool_submit_window.restype = ctypes.c_longlong
    lib.vpool_submit_window.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_double, ctypes.c_double,
        ctypes.c_int, ctypes.POINTER(ctypes.c_ubyte),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.vpool_wait.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    return lib


@functools.lru_cache(maxsize=1)
def _pool():
    """Process-global native decode pool (MRBLIP_DECODE_THREADS, default 4)."""
    n = int(os.environ.get("MRBLIP_DECODE_THREADS", "4"))
    return _lib().vpool_create(n)


class DecodeTicket:
    """Pending async decode; ``result()`` blocks until the C++ worker is
    done and returns the frames. The output buffer and the reader handle
    are kept alive by this object until then."""

    def __init__(self, ticket, out, reader, n_out=None):
        self._ticket = ticket
        self._out = out
        self._reader = reader  # keepalive: handle must outlive the job
        self._n_out = n_out
        self._done = False

    def result(self) -> np.ndarray:
        if self._done:
            return self._out
        r = _lib().vpool_wait(_pool(), self._ticket)
        self._done = True
        if r != 0:
            raise IOError(f"async decode failed: {r}")
        if self._n_out is not None:
            self._out = self._out[: self._n_out.value].copy()
        return self._out


class _ImmediateTicket:
    def __init__(self, frames):
        self._frames = frames

    def result(self):
        return self._frames


_SYNTH_RE = re.compile(
    r"^synthetic://(?P<frames>\d+)x(?P<h>\d+)x(?P<w>\d+)(@(?P<fps>[\d.]+))?"
    r"(#(?P<seed>\d+))?$"
)


class SyntheticVideo:
    """Deterministic generated clip: frame k is a phase-k gradient."""

    def __init__(self, n_frames, h, w, fps=30.0, seed=0, out_w=-1, out_h=-1):
        self.n_frames = n_frames
        self.h = out_h if out_h > 0 else h
        self.w = out_w if out_w > 0 else w
        self.fps = fps
        self.seed = seed

    def __len__(self):
        return self.n_frames

    def get_avg_fps(self):
        return self.fps

    def get_batch(self, indices):
        indices = np.asarray(indices, np.int64)
        y = np.arange(self.h)[:, None]
        x = np.arange(self.w)[None, :]
        frames = np.stack(
            [((x * 3 + y + (int(k) + self.seed) * 16) % 256) for k in indices]
        ).astype(np.uint8)
        return np.repeat(frames[..., None], 3, axis=-1)

    def get_window(self, t0, t1, max_n=1024):
        i0 = max(int(t0 * self.fps), 0)
        i1 = min(int(np.ceil(t1 * self.fps)), self.n_frames)
        idx = list(range(i0, min(i1, i0 + max_n)))
        return self.get_batch(idx) if idx else self.get_batch([0])[:0]


class VideoReader:
    """Native FFmpeg-backed reader; one handle per (path, size), rescaled
    to RGB with SWS_BICUBIC."""

    def __init__(self, uri: str, width: int = -1, height: int = -1):
        self._native = None
        m = _SYNTH_RE.match(str(uri))
        if m:
            self._impl = SyntheticVideo(
                int(m["frames"]), int(m["h"]), int(m["w"]),
                fps=float(m["fps"] or 30.0), seed=int(m["seed"] or 0),
                out_w=width, out_h=height,
            )
            return
        self._impl = None
        lib = _lib()
        self._native = lib.vd_open_ex(str(uri).encode(), width, height, 0)
        if not self._native:
            raise IOError(f"cannot open video: {uri}")
        fps = ctypes.c_double()
        nf = ctypes.c_longlong()
        dur = ctypes.c_double()
        w = ctypes.c_int()
        h = ctypes.c_int()
        lib.vd_info(self._native, ctypes.byref(fps), ctypes.byref(nf),
                    ctypes.byref(dur), ctypes.byref(w), ctypes.byref(h))
        self._fps = fps.value
        self._nframes = int(nf.value)
        self.duration = dur.value
        self._w, self._h = w.value, h.value
        self._lock = threading.Lock()

    def __len__(self):
        return self._impl.n_frames if self._impl else self._nframes

    def get_avg_fps(self):
        return self._impl.fps if self._impl else self._fps

    def get_batch(self, indices: Sequence[int]) -> np.ndarray:
        if self._impl:
            return self._impl.get_batch(indices)
        idx = np.ascontiguousarray(np.asarray(indices, np.int64))
        out = np.empty((len(idx), self._h, self._w, 3), np.uint8)
        with self._lock:
            r = _lib().vd_get_batch(
                self._native,
                idx.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
                len(idx),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            )
        if r != 0:
            raise IOError(f"vd_get_batch failed: {r}")
        return out

    def get_window(self, t0: float, t1: float, max_n: int = 1024) -> np.ndarray:
        if self._impl:
            return self._impl.get_window(t0, t1, max_n)
        out = np.empty((max_n, self._h, self._w, 3), np.uint8)
        n_out = ctypes.c_int()
        with self._lock:
            r = _lib().vd_get_window(
                self._native, t0, t1, max_n,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
                ctypes.byref(n_out),
            )
        if r != 0:
            raise IOError(f"vd_get_window failed: {r}")
        return out[: n_out.value].copy()

    # -------------------------------------------------- async (decode-ahead)
    # One in-flight job per reader (the handle carries decode state); the
    # C++ pool decodes while Python prepares or waits on other samples.
    # The grounded-QA re-decode of the predicted windows submits a whole
    # batch's windows before it waits on any (the reference decodes them one
    # after another, blip2_mr.py:1167-1230).

    def get_batch_async(self, indices: Sequence[int]):
        if self._impl:
            return _ImmediateTicket(self._impl.get_batch(indices))
        idx = np.ascontiguousarray(np.asarray(indices, np.int64))
        out = np.empty((len(idx), self._h, self._w, 3), np.uint8)
        ticket = _lib().vpool_submit_batch(
            _pool(), self._native,
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)), len(idx),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        )
        if ticket <= 0:
            raise IOError(f"vpool_submit_batch failed: {ticket}")
        return DecodeTicket(ticket, out, self)

    def get_window_async(self, t0: float, t1: float, max_n: int = 1024):
        if self._impl:
            return _ImmediateTicket(self._impl.get_window(t0, t1, max_n))
        out = np.empty((max_n, self._h, self._w, 3), np.uint8)
        n_out = ctypes.c_int()
        ticket = _lib().vpool_submit_window(
            _pool(), self._native, t0, t1, max_n,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            ctypes.byref(n_out),
        )
        if ticket <= 0:
            raise IOError(f"vpool_submit_window failed: {ticket}")
        return DecodeTicket(ticket, out, self, n_out=n_out)

    def pts_map_info(self):
        """(has_exact_map, n_keyframes): whether this handle indexes frames
        through the demux-built pts map (and not avg-fps arithmetic), and
        how many seek points it knows."""
        if self._impl:
            return (False, 0)
        nk = ctypes.c_longlong()
        has = _lib().vd_has_pts_map(self._native, ctypes.byref(nk))
        return (has == 1, int(nk.value))

    def close(self):
        if self._native:
            _lib().vd_close(self._native)
            self._native = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def write_test_video(path: str, w=128, h=96, n_frames=60, fps=10.0, gop=8,
                     codec="mpeg4"):
    """Encode a deterministic synthetic clip. ``gop`` sets keyframe spacing
    (benchmarks pass web-video GOPs of 30-300 so that random-access seeks pay
    the real decode-forward cost; tests keep the cheap default).
    ``codec="libx264"`` produces H.264 with B-frames (what QVHighlights and
    Charades videos are); use an ``.mp4`` path for it."""
    r = _lib().vd_write_test_video_codec(
        str(path).encode(), w, h, n_frames, fps, gop, codec.encode())
    if r != 0:
        raise IOError(f"vd_write_test_video failed: {r}")
    return path
