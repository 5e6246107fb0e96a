"""Image decoding for the data streams (the port's counterpart of
x2vlm_tpu/data/imageio.py and of the PIL decode in data/pretrain.py).

An image decodes as the JAX package decodes it,
``PIL.Image.open(...).convert("RGB")``, so both packages give equal arrays.
Pillow is imported where an image is decoded, and its absence raises an
error that names it.
"""

from __future__ import annotations

import io
import os

from x2vlm_tpu_torch.core.io import hopen

__all__ = ["decode_image", "open_image", "pil"]


def pil():
    """The ``PIL.Image`` module, set up as the JAX package's data/pretrain.py
    sets it (truncated images load, no pixel-count cap)."""
    try:
        from PIL import Image, ImageFile
    except ImportError as e:
        raise ImportError("decoding and transforming images needs Pillow, which is not "
                          "installed") from e
    ImageFile.LOAD_TRUNCATED_IMAGES = True
    Image.MAX_IMAGE_PIXELS = None
    return Image


def decode_image(data: bytes):
    """Encoded bytes as an RGB PIL image."""
    return pil().open(io.BytesIO(data)).convert("RGB")


def open_image(path: str, root: str = ""):
    """``root/path`` decoded as :func:`decode_image` does."""
    if root:
        path = os.path.join(root, path)
    with hopen(path, "rb") as f:
        return decode_image(f.read())
