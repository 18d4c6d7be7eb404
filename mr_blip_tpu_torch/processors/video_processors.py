"""Video processors: decode + sample + augment + normalize (the port's copy
of ``mr_blip_tpu/processors/video_processors.py``; the videos come from
``datasets/video_reader.py``, which reads ``synthetic://`` only).

Semantics follow the reference (``lavis/processors/blip_processors.py:287-395``):

* train (``blip2_video_train``): random interval sampling, RandomResizedCrop
  (scale 0.5-1.0), CLIP mean/std normalization;
* eval (``blip_video_eval``): uniform midpoint sampling, direct resize (done
  by the decoder's bicubic scaler, like decord's height/width args),
  CLIP normalization.

TPU-first deviations: frames flow as (T, H, W, C) channels-last (NHWC maps
onto the patch-conv matmul directly), and the crop's final resize is
bilinear (numpy) rather than torchvision bicubic — a training-time
augmentation distribution difference only; the deterministic eval path uses
the same bicubic scaling as the reference.  Set ``normalize=False`` to emit
uint8 and fold normalization into the on-device preprocessing.
"""

from __future__ import annotations

import random as rnd
from typing import Optional, Sequence

import numpy as np

from mr_blip_tpu_torch import MAX_INT
from mr_blip_tpu_torch.common.registry import registry
from mr_blip_tpu_torch.datasets.sampling import sample_frame_indices
from mr_blip_tpu_torch.datasets.video_reader import VideoReader

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def load_video(
    video_path: str,
    n_frms: int = MAX_INT,
    height: int = -1,
    width: int = -1,
    sampling: str = "uniform",
    clip_proposal: Optional[Sequence[float]] = None,
    rng: Optional[rnd.Random] = None,
):
    """Decode sampled frames: returns ((T, H, W, C) uint8, indices, fps).

    Same contract as reference ``load_video`` (data_utils.py:30-85) apart
    from the channels-last layout.
    """
    vr = VideoReader(video_path, width=width, height=height)
    indices = sample_frame_indices(
        vlen=len(vr), fps=vr.get_avg_fps(), n_frms=n_frms,
        sampling=sampling, clip_proposal=clip_proposal, rng=rng,
    )
    frames = vr.get_batch(indices)
    fps = vr.get_avg_fps()
    vr.close()
    return frames, indices, fps


def _resize_bilinear(frames: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Vectorized bilinear resize for (T, H, W, C) arrays."""
    t, h, w, c = frames.shape
    if (h, w) == (out_h, out_w):
        return frames.astype(np.float32)
    ys = (np.arange(out_h) + 0.5) * h / out_h - 0.5
    xs = (np.arange(out_w) + 0.5) * w / out_w - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0, 1).astype(np.float32)[None, :, None, None]
    wx = np.clip(xs - x0, 0, 1).astype(np.float32)[None, None, :, None]
    f = frames.astype(np.float32)
    top = f[:, y0][:, :, x0] * (1 - wx) + f[:, y0][:, :, x1] * wx
    bot = f[:, y1][:, :, x0] * (1 - wx) + f[:, y1][:, :, x1] * wx
    return top * (1 - wy) + bot * wy


def normalize_clip(frames: np.ndarray, mean=CLIP_MEAN, std=CLIP_STD) -> np.ndarray:
    f = frames.astype(np.float32) / 255.0
    return (f - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def random_resized_crop(
    frames: np.ndarray,
    out_size: int,
    scale=(0.5, 1.0),
    ratio=(3.0 / 4.0, 4.0 / 3.0),
    rng: Optional[rnd.Random] = None,
) -> np.ndarray:
    """torchvision-style RandomResizedCrop applied consistently across T."""
    rng = rng or rnd
    t, h, w, c = frames.shape
    area = h * w
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
        aspect = np.exp(rng.uniform(*log_ratio))
        cw = int(round(np.sqrt(target_area * aspect)))
        ch = int(round(np.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            y = rng.randint(0, h - ch)
            x = rng.randint(0, w - cw)
            crop = frames[:, y : y + ch, x : x + cw]
            return _resize_bilinear(crop, out_size, out_size)
    # fallback: center crop of the shorter side
    s = min(h, w)
    y, x = (h - s) // 2, (w - s) // 2
    return _resize_bilinear(frames[:, y : y + s, x : x + s], out_size, out_size)


class BlipVideoBaseProcessor:
    def __init__(self, mean=None, std=None, n_frms=MAX_INT, normalize=True):
        self.mean = mean if mean is not None else CLIP_MEAN
        self.std = std if std is not None else CLIP_STD
        self.n_frms = n_frms
        self.do_normalize = normalize

    def _finish(self, frames: np.ndarray) -> np.ndarray:
        if self.do_normalize:
            return normalize_clip(frames, self.mean, self.std)
        # normalize=False contract: emit uint8, ALWAYS. A float output in
        # the 0-255 domain would skip the model's dtype-keyed on-device
        # normalization and silently feed unnormalized inputs. The crop
        # path interpolates in float; re-quantizing to bytes costs
        # <0.5/255 per channel (augmentation-path only).
        if frames.dtype == np.uint8:
            return frames
        return np.clip(np.round(frames), 0, 255).astype(np.uint8)


@registry.register_processor("blip2_video_train")
class Blip2VideoTrainProcessor(BlipVideoBaseProcessor):
    def __init__(
        self, image_size=364, mean=None, std=None, min_scale=0.5,
        max_scale=1.0, n_frms=MAX_INT, normalize=True, seed=None,
    ):
        super().__init__(mean, std, n_frms, normalize)
        self.image_size = image_size
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.rng = rnd.Random(seed) if seed is not None else rnd

    def __call__(self, vpath, clip_proposal=None):
        frames, indices, fps = load_video(
            video_path=vpath, n_frms=self.n_frms,
            height=self.image_size, width=self.image_size,
            sampling="random", clip_proposal=clip_proposal, rng=self.rng,
        )
        frames = random_resized_crop(
            frames, self.image_size, scale=(self.min_scale, self.max_scale),
            rng=self.rng,
        )
        return self._finish(frames), indices, fps

    @classmethod
    def from_config(cls, cfg=None):
        cfg = cfg or {}
        return cls(
            image_size=cfg.get("image_size", 364),
            mean=cfg.get("mean"), std=cfg.get("std"),
            min_scale=cfg.get("min_scale", 0.5),
            max_scale=cfg.get("max_scale", 1.0),
            n_frms=cfg.get("n_frms", MAX_INT),
            normalize=cfg.get("normalize", True),
        )


@registry.register_processor("blip_video_eval")
class BlipVideoEvalProcessor(BlipVideoBaseProcessor):
    def __init__(self, image_size=256, mean=None, std=None, n_frms=MAX_INT,
                 normalize=True):
        super().__init__(mean, std, n_frms, normalize)
        self.image_size = image_size

    def __call__(self, vpath, clip_proposal=None):
        frames, indices, fps = load_video(
            video_path=vpath, n_frms=self.n_frms,
            height=self.image_size, width=self.image_size,
            sampling="uniform", clip_proposal=clip_proposal,
        )
        return self._finish(frames), indices, fps

    @classmethod
    def from_config(cls, cfg=None):
        cfg = cfg or {}
        return cls(
            image_size=cfg.get("image_size", 256),
            mean=cfg.get("mean"), std=cfg.get("std"),
            n_frms=cfg.get("n_frms", MAX_INT),
            normalize=cfg.get("normalize", True),
        )
