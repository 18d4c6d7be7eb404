"""RandAugment for the BLIP image-training pipeline (the port's copy of
``mr_blip_tpu/processors/randaugment.py``; PIL is imported when an op runs,
so the eval path and a host without PIL import this module).

Counterpart of the reference ``lavis/processors/randaugment.py``
(cv2-based): same op vocabulary, selection rule (N ops sampled uniformly,
each applied with p=0.5 at magnitude M) and level->argument scalings
(enhance 0.1..1.9, shear +-0.3, translate +-10 px, rotate +-30 deg,
solarize /256, posterize /4 bits). Ops are implemented with PIL
(cv2 is not in this image) — geometrically/semantically equivalent but not
bit-identical to the cv2 kernels; this is a TRAINING AUGMENTATION
distribution, not an eval-path transform, so only distributional
equivalence matters (SURVEY §7 hard part (f)).
"""

from __future__ import annotations

import numpy as np

MAX_LEVEL = 10
TRANSLATE_CONST = 10
REPLACE_VALUE = (128, 128, 128)


def _pil():
    from PIL import Image, ImageEnhance, ImageOps

    return Image, ImageEnhance, ImageOps


def _to_pil(img: np.ndarray):
    return _pil()[0].fromarray(np.asarray(img, np.uint8))


def _affine(img, coeffs):
    Image = _pil()[0]
    return _to_pil(img).transform(
        img.shape[1::-1] if isinstance(img, np.ndarray) else img.size,
        Image.AFFINE, coeffs, resample=Image.BILINEAR,
        fillcolor=REPLACE_VALUE,
    )


def identity_func(img, rng):
    return img


def autocontrast_func(img, rng):
    return np.asarray(_pil()[2].autocontrast(_to_pil(img)))


def equalize_func(img, rng):
    return np.asarray(_pil()[2].equalize(_to_pil(img)))


def rotate_func(img, rng, level):
    Image = _pil()[0]
    degree = (level / MAX_LEVEL) * 30
    if rng.random() < 0.5:
        degree = -degree
    return np.asarray(_to_pil(img).rotate(
        degree, resample=Image.BILINEAR, fillcolor=REPLACE_VALUE))


def solarize_func(img, rng, level):
    thresh = int((level / MAX_LEVEL) * 256)
    return np.asarray(_pil()[2].solarize(_to_pil(img), min(thresh, 255)))


def _enhance(kind):
    def f(img, rng, level):
        factor = (level / MAX_LEVEL) * 1.8 + 0.1
        return np.asarray(getattr(_pil()[1], kind)(_to_pil(img)).enhance(factor))
    return f


color_func = _enhance("Color")
contrast_func = _enhance("Contrast")
brightness_func = _enhance("Brightness")
sharpness_func = _enhance("Sharpness")


def shear_x_func(img, rng, level):
    factor = (level / MAX_LEVEL) * 0.3
    if rng.random() > 0.5:
        factor = -factor
    return np.asarray(_affine(img, (1, factor, 0, 0, 1, 0)))


def shear_y_func(img, rng, level):
    factor = (level / MAX_LEVEL) * 0.3
    if rng.random() > 0.5:
        factor = -factor
    return np.asarray(_affine(img, (1, 0, 0, factor, 1, 0)))


def translate_x_func(img, rng, level):
    offset = (level / MAX_LEVEL) * TRANSLATE_CONST
    if rng.random() > 0.5:
        offset = -offset
    return np.asarray(_affine(img, (1, 0, offset, 0, 1, 0)))


def translate_y_func(img, rng, level):
    offset = (level / MAX_LEVEL) * TRANSLATE_CONST
    if rng.random() > 0.5:
        offset = -offset
    return np.asarray(_affine(img, (1, 0, 0, 0, 1, offset)))


def posterize_func(img, rng, level):
    bits = int((level / MAX_LEVEL) * 4)
    return np.asarray(_pil()[2].posterize(_to_pil(img), max(1, bits)))


FUNC_DICT = {
    "Identity": identity_func,
    "AutoContrast": autocontrast_func,
    "Equalize": equalize_func,
    "Rotate": rotate_func,
    "Solarize": solarize_func,
    "Color": color_func,
    "Contrast": contrast_func,
    "Brightness": brightness_func,
    "Sharpness": sharpness_func,
    "ShearX": shear_x_func,
    "ShearY": shear_y_func,
    "TranslateX": translate_x_func,
    "TranslateY": translate_y_func,
    "Posterize": posterize_func,
}

LEVELED = {k for k in FUNC_DICT
           if k not in ("Identity", "AutoContrast", "Equalize")}

BLIP_AUGS = [  # reference blip_processors.py:164-180
    "Identity", "AutoContrast", "Brightness", "Sharpness", "Equalize",
    "ShearX", "ShearY", "TranslateX", "TranslateY", "Rotate",
]


class RandomAugment:
    """Sample N ops, apply each with probability 0.5 at magnitude M
    (reference RandomAugment.get_random_ops)."""

    def __init__(self, N=2, M=10, augs=None, rng=None):
        self.N = N
        self.M = M
        self.augs = list(augs) if augs else list(FUNC_DICT)
        self.rng = rng or np.random.default_rng()

    def __call__(self, img: np.ndarray) -> np.ndarray:
        img = np.asarray(img, np.uint8)
        ops = self.rng.choice(self.augs, self.N)
        for name in ops:
            if self.rng.random() > 0.5:
                continue
            fn = FUNC_DICT[str(name)]
            if str(name) in LEVELED:
                img = np.asarray(fn(img, self.rng, self.M), np.uint8)
            else:
                img = np.asarray(fn(img, self.rng), np.uint8)
        return img
