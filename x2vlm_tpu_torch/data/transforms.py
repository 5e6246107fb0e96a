"""Host-side image transforms, NHWC output (the port's copy of
x2vlm_tpu/data/transforms.py; reference dataset/__init__.py:33-75 and
dataset/randaugment.py).

Every transform takes the PIL image data/imageio.py decodes and runs the
JAX package's PIL code, so both packages give equal arrays for the same
``random`` draws. Pillow is imported where a transform runs
(data/imageio.pil). ``box_transform`` is the region stream's: it only
augments, the crop and the flip being done box-aware by the stream.
"""

from __future__ import annotations

import random
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

from x2vlm_tpu_torch.data.imageio import pil

__all__ = [
    "CLIP_MEAN", "CLIP_STD", "normalize", "to_uint8", "random_resized_crop",
    "hflip", "RandomAugment", "DEFAULT_AUGS", "BOX_AUGS", "pretrain_transform",
    "train_transform", "box_transform", "test_transform",
]

CLIP_MEAN = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)


def normalize(img) -> np.ndarray:
    """PIL RGB -> normalized float32 NHWC array (H, W, 3)."""
    x = np.asarray(img.convert("RGB"), np.float32) / 255.0
    return (x - CLIP_MEAN) / CLIP_STD


def to_uint8(img) -> np.ndarray:
    """PIL RGB -> raw uint8 (H, W, 3); normalization happens on the device
    (ops/layers.PatchEmbed's uint8 path)."""
    return np.asarray(img.convert("RGB"), np.uint8)


def random_resized_crop(img, size: int, scale: Tuple[float, float] = (0.2, 1.0),
                        ratio: Tuple[float, float] = (3 / 4, 4 / 3),
                        rng: Optional[random.Random] = None):
    rng = rng or random
    bicubic = pil().BICUBIC
    w, h = img.size
    area = w * h
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
        aspect = float(np.exp(rng.uniform(*log_ratio)))
        cw = int(round(np.sqrt(target_area * aspect)))
        ch = int(round(np.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            x0 = rng.randint(0, w - cw)
            y0 = rng.randint(0, h - ch)
            return img.crop((x0, y0, x0 + cw, y0 + ch)).resize((size, size), bicubic)
    s = min(w, h)   # fallback: center crop
    x0, y0 = (w - s) // 2, (h - s) // 2
    return img.crop((x0, y0, x0 + s, y0 + s)).resize((size, size), bicubic)


def hflip(img):
    return img.transpose(pil().FLIP_LEFT_RIGHT)


def _aug(name: str, img, v: float):
    """One RandomAugment op at value ``v``."""
    Image = pil()
    from PIL import ImageEnhance, ImageOps

    return {
        "Identity": lambda: img,
        "AutoContrast": lambda: ImageOps.autocontrast(img),
        "Equalize": lambda: ImageOps.equalize(img),
        "Brightness": lambda: ImageEnhance.Brightness(img).enhance(v),
        "Sharpness": lambda: ImageEnhance.Sharpness(img).enhance(v),
        "ShearX": lambda: img.transform(img.size, Image.AFFINE, (1, v, 0, 0, 1, 0)),
        "ShearY": lambda: img.transform(img.size, Image.AFFINE, (1, 0, 0, v, 1, 0)),
        "TranslateX": lambda: img.transform(img.size, Image.AFFINE,
                                            (1, 0, v * img.size[0], 0, 1, 0)),
        "TranslateY": lambda: img.transform(img.size, Image.AFFINE,
                                            (1, 0, 0, 0, 1, v * img.size[1])),
        "Rotate": lambda: img.rotate(v),
    }[name]()


# name -> (lo, hi) of the op's value; magnitude m gives lo + (hi - lo) m / 10
_AUG_RANGES = {
    "Identity": (0, 0), "AutoContrast": (0, 0), "Equalize": (0, 0),
    "Brightness": (0.1, 1.9), "Sharpness": (0.1, 1.9),
    "ShearX": (-0.3, 0.3), "ShearY": (-0.3, 0.3),
    "TranslateX": (-0.3, 0.3), "TranslateY": (-0.3, 0.3), "Rotate": (-30, 30),
}
DEFAULT_AUGS = ["Identity", "AutoContrast", "Equalize", "Brightness", "Sharpness",
                "ShearX", "ShearY", "TranslateX", "TranslateY", "Rotate"]
BOX_AUGS = ["Identity", "AutoContrast", "Equalize", "Brightness", "Sharpness"]


class RandomAugment:
    """2 random ops of ``augs`` at magnitude 7/10 (reference
    randaugment.py:310-339)."""

    n, m = 2, 7

    def __init__(self, rng: Optional[random.Random] = None,
                 augs: Sequence[str] = tuple(DEFAULT_AUGS)):
        self.rng = rng or random
        self.augs = list(augs)

    def __call__(self, img):
        for name in [self.rng.choice(self.augs) for _ in range(self.n)]:
            lo, hi = _AUG_RANGES[name]
            img = _aug(name, img, lo + (hi - lo) * (self.m / 10.0))
        return img


def pretrain_transform(image_res: int, rng: Optional[random.Random] = None,
                       as_float: bool = True) -> Callable:
    """``as_float=False`` emits uint8 and leaves normalization to the device
    (PatchEmbed's uint8 path)."""
    aug = RandomAugment(rng)
    rng = rng or random

    def f(img):
        img = random_resized_crop(img, image_res, scale=(0.2, 1.0), rng=rng)
        if rng.random() < 0.5:
            img = hflip(img)
        img = aug(img)
        return normalize(img) if as_float else to_uint8(img)

    return f


def train_transform(image_res: int, rng: Optional[random.Random] = None,
                    with_hflip: bool = True):
    """Random resized crop, a flip (not with ``with_hflip=False``: the
    captioning set keeps left and right), RandomAugment, normalise."""
    aug = RandomAugment(rng)
    rng = rng or random

    def f(img):
        img = random_resized_crop(img, image_res, scale=(0.5, 1.0), rng=rng)
        if with_hflip and rng.random() < 0.5:
            img = hflip(img)
        return normalize(aug(img))

    return f


def box_transform(rng: Optional[random.Random] = None):
    """The region stream's transform: ``BOX_AUGS`` only, normalised (the
    stream crops and flips with the boxes)."""
    aug = RandomAugment(rng, augs=BOX_AUGS)

    def f(img):
        return normalize(aug(img))

    return f


def test_transform(image_res: int):
    def f(img):
        return normalize(img.convert("RGB").resize((image_res, image_res), pil().BICUBIC))

    return f
