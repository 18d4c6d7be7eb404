"""VideoReader, the ``synthetic://`` scheme only (the port's counterpart of
``mr_blip_tpu/datasets/video_reader.py``).

``synthetic://{frames}x{h}x{w}[@fps][#seed]`` serves deterministic generated
frames with no file I/O (tests, benchmarks, ``chip_smoke.py``), through the
API the reference gets from decord: ``len(vr)`` = frame count,
``vr.get_avg_fps()`` and ``vr.get_batch(indices) -> (T, H, W, C) uint8``.
A file URI raises ``NotImplementedError``: the
FFmpeg reader (the C++ decoder of ``mr_blip_tpu/native/``) is not ported
yet (ROADMAP Queue 1 item 3).
"""

from __future__ import annotations

import re
from typing import Sequence

import numpy as np

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
    """One handle per (uri, size); ``synthetic://`` only."""

    def __init__(self, uri: str, width: int = -1, height: int = -1):
        m = _SYNTH_RE.match(str(uri))
        if not m:
            raise NotImplementedError(
                f"cannot read {uri!r}: only synthetic:// videos are read by the "
                "port; the FFmpeg reader (mr_blip_tpu/native/) is not ported yet "
                "(ROADMAP Queue 1 item 3)")
        self._impl = SyntheticVideo(
            int(m["frames"]), int(m["h"]), int(m["w"]),
            fps=float(m["fps"] or 30.0), seed=int(m["seed"] or 0),
            out_w=width, out_h=height,
        )

    def __len__(self):
        return self._impl.n_frames

    def get_avg_fps(self):
        return self._impl.fps

    def get_batch(self, indices: Sequence[int]) -> np.ndarray:
        return self._impl.get_batch(indices)

    def close(self):
        pass
