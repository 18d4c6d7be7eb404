"""Image processors of the zoo paths (the port's copy of the image half of
``mr_blip_tpu/processors/image_processors.py``; numpy, host side).

Counterparts of the reference ``lavis/processors/{blip_processors(image
half),clip_processors}.py``:

* ``blip_image_train`` / ``blip2_image_train``: RandomResizedCrop
  (scale 0.5-1.0) + horizontal flip + RandAugment(2, 5, the 10-op BLIP
  list) + CLIP normalization (blip_processors.py:150-185);
* ``blip_image_eval``: resize + normalize;
* ``clip_image_train`` / ``clip_image_eval``: CLIP's own recipe —
  RandomResizedCrop scale 0.9-1.0 / resize-shorter-side + center crop
  (clip_processors.py:20-75).

The ALPRO video and GPT dialogue processors wait for their families
(ROADMAP Queue 1). All numpy, channels-last; images flow as (H, W, C)
float32.
"""

from __future__ import annotations

import random as rnd

import numpy as np

from mr_blip_tpu_torch.common.registry import registry
from mr_blip_tpu_torch.processors.randaugment import BLIP_AUGS, RandomAugment
from mr_blip_tpu_torch.processors.text_processors import BaseProcessor
from mr_blip_tpu_torch.processors.video_processors import (
    CLIP_MEAN,
    CLIP_STD,
    _resize_bilinear,
    normalize_clip,
    random_resized_crop,
)


def _center_crop(img: np.ndarray, size: int) -> np.ndarray:
    h, w = img.shape[:2]
    y, x = max(0, (h - size) // 2), max(0, (w - size) // 2)
    return img[y:y + size, x:x + size]


def _resize_shorter(img: np.ndarray, size: int) -> np.ndarray:
    h, w = img.shape[:2]
    if h < w:
        nh, nw = size, int(round(w * size / h))
    else:
        nh, nw = int(round(h * size / w)), size
    return _resize_bilinear(img[None], nh, nw)[0]


class _ImageBase(BaseProcessor):
    def __init__(self, mean=None, std=None):
        self.mean = mean if mean is not None else CLIP_MEAN
        self.std = std if std is not None else CLIP_STD

    def _norm(self, img: np.ndarray) -> np.ndarray:
        return normalize_clip(img[None].astype(np.float32), self.mean,
                              self.std)[0]


@registry.register_processor("blip_image_train")
class BlipImageTrainProcessor(_ImageBase):
    def __init__(self, image_size=384, mean=None, std=None, min_scale=0.5,
                 max_scale=1.0, seed=None):
        super().__init__(mean, std)
        self.image_size = image_size
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.rng = rnd.Random(seed) if seed is not None else rnd
        self.augment = RandomAugment(
            2, 5, augs=BLIP_AUGS,
            rng=np.random.default_rng(seed) if seed is not None else None,
        )

    def __call__(self, img: np.ndarray) -> np.ndarray:
        frames = np.asarray(img, np.float32)[None]
        frames = random_resized_crop(
            frames, self.image_size,
            scale=(self.min_scale, self.max_scale), rng=self.rng,
        )
        if self.rng.random() < 0.5:
            frames = frames[:, :, ::-1]
        out = self.augment(np.clip(frames[0], 0, 255))
        return self._norm(out)

    @classmethod
    def from_config(cls, cfg=None):
        cfg = cfg or {}
        return cls(image_size=cfg.get("image_size", 384),
                   mean=cfg.get("mean"), std=cfg.get("std"),
                   min_scale=cfg.get("min_scale", 0.5),
                   max_scale=cfg.get("max_scale", 1.0))


@registry.register_processor("blip2_image_train")
class Blip2ImageTrainProcessor(BlipImageTrainProcessor):
    def __init__(self, image_size=364, **kw):
        super().__init__(image_size=image_size, **kw)


@registry.register_processor("blip_image_eval")
class BlipImageEvalProcessor(_ImageBase):
    def __init__(self, image_size=384, mean=None, std=None):
        super().__init__(mean, std)
        self.image_size = image_size

    def __call__(self, img: np.ndarray) -> np.ndarray:
        out = _resize_bilinear(
            np.asarray(img, np.float32)[None], self.image_size,
            self.image_size,
        )[0]
        return self._norm(out)

    @classmethod
    def from_config(cls, cfg=None):
        cfg = cfg or {}
        return cls(image_size=cfg.get("image_size", 384),
                   mean=cfg.get("mean"), std=cfg.get("std"))


@registry.register_processor("clip_image_train")
class ClipImageTrainProcessor(_ImageBase):
    """CLIP's own train recipe: RandomResizedCrop scale 0.9-1.0."""

    def __init__(self, image_size=224, mean=None, std=None, min_scale=0.9,
                 max_scale=1.0, seed=None):
        super().__init__(mean, std)
        self.image_size = image_size
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.rng = rnd.Random(seed) if seed is not None else rnd

    def __call__(self, img: np.ndarray) -> np.ndarray:
        frames = np.asarray(img, np.float32)[None]
        out = random_resized_crop(
            frames, self.image_size,
            scale=(self.min_scale, self.max_scale), rng=self.rng,
        )[0]
        return self._norm(out)

    @classmethod
    def from_config(cls, cfg=None):
        cfg = cfg or {}
        return cls(image_size=cfg.get("image_size", 224),
                   mean=cfg.get("mean"), std=cfg.get("std"),
                   min_scale=cfg.get("min_scale", 0.9),
                   max_scale=cfg.get("max_scale", 1.0))


@registry.register_processor("clip_image_eval")
class ClipImageEvalProcessor(_ImageBase):
    """Resize shorter side then center crop (reference clip_processors)."""

    def __init__(self, image_size=224, mean=None, std=None):
        super().__init__(mean, std)
        self.image_size = image_size

    def __call__(self, img: np.ndarray) -> np.ndarray:
        out = _center_crop(
            _resize_shorter(np.asarray(img, np.float32), self.image_size),
            self.image_size,
        )
        return self._norm(out)

    @classmethod
    def from_config(cls, cfg=None):
        cfg = cfg or {}
        return cls(image_size=cfg.get("image_size", 224),
                   mean=cfg.get("mean"), std=cfg.get("std"))
