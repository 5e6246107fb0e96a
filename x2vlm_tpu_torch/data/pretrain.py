"""Pretraining data streams (the port's counterpart of
x2vlm_tpu/data/pretrain.py): the image-text and the text-only JSONL
streams over the sharded line reader, emitting fixed-shape numpy samples.

A broken sample (an undecodable image, a missing key) is skipped and
counted in ``broken``, as in the JAX package; and once
``max_consecutive_broken`` samples in a row have broken (a batch's worth,
as the launcher sets it) the stream raises instead of spinning, so a
missing decoder cannot turn into a stream that never yields. The region
and video streams come with ROADMAP items A5 and A8; the JAX package's
native decode path is not ported.
"""

from __future__ import annotations

import random
from base64 import b64decode
from typing import Callable, Dict, Iterator, Optional

import numpy as np

from x2vlm_tpu_torch.data.imageio import decode_image, open_image
from x2vlm_tpu_torch.data.streaming import DistLineReader
from x2vlm_tpu_torch.data.tokenization import TextPreprocessor

__all__ = ["ImageTextStream", "TextStream", "BrokenStreamError"]


class BrokenStreamError(RuntimeError):
    """Every one of the last ``max_consecutive_broken`` samples was broken."""


def _choose_caption(caption, rng) -> str:
    if isinstance(caption, list):
        return rng.choice(caption)
    return caption


class _StreamBase:
    def __init__(self, reader: DistLineReader, text_pre: TextPreprocessor,
                 rng: Optional[random.Random] = None, max_consecutive_broken: int = 128):
        self.reader = reader
        self.text_pre = text_pre
        self.rng = rng or random.Random()
        self.broken = 0
        self.max_consecutive_broken = max_consecutive_broken
        self._in_a_row = 0

    def _samples(self, make: Callable[[dict], Dict]) -> Iterator[Dict]:
        for ann in self.reader.iter_json():
            try:
                sample = make(ann)
            except Exception as e:  # noqa: BLE001 -- any broken sample is skipped and counted
                self.broken += 1
                self._in_a_row += 1
                if self._in_a_row >= self.max_consecutive_broken:
                    raise BrokenStreamError(
                        f"{type(self).__name__}: the last {self._in_a_row} samples were "
                        f"broken ({self.broken} in all); the last: "
                        f"{type(e).__name__}: {e}") from e
                continue
            self._in_a_row = 0
            yield sample


class ImageTextStream(_StreamBase):
    """JSONL {image_key: b64|path, caption_key: str|[str]} -> multimodal MLM
    samples (reference ImageTextJsonDataset:131-287)."""

    def __init__(self, reader, text_pre, transform: Callable,
                 image_key: str = "binary", caption_key: str = "desc",
                 is_image_rpath: bool = False, rng=None, max_consecutive_broken: int = 128):
        super().__init__(reader, text_pre, rng, max_consecutive_broken)
        self.transform = transform
        self.image_key = image_key
        self.caption_key = caption_key
        self.is_image_rpath = is_image_rpath

    def _sample(self, ann: dict) -> Dict:
        if self.is_image_rpath:
            img = open_image(ann[self.image_key])
        else:
            img = decode_image(b64decode(ann[self.image_key]))
        image = np.asarray(self.transform(img))
        caption = _choose_caption(ann[self.caption_key], self.rng)
        ids, atts, ids_masked, pos, labels = self.text_pre(caption, with_masking=True)
        return {"image": image, "text_ids": ids, "text_atts": atts,
                "text_ids_masked": ids_masked, "masked_pos": pos, "masked_ids": labels}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self._samples(self._sample)


class TextStream(_StreamBase):
    """Text-only MLM stream (reference TextJsonDataset:663-785)."""

    def __init__(self, reader, text_pre, caption_key: str = "text", rng=None,
                 max_consecutive_broken: int = 128):
        super().__init__(reader, text_pre, rng, max_consecutive_broken)
        self.caption_key = caption_key

    def _sample(self, ann: dict) -> Dict:
        caption = _choose_caption(ann[self.caption_key], self.rng)
        ids, atts, ids_masked, pos, labels = self.text_pre(caption, with_masking=True)
        return {"text_ids": ids, "text_atts": atts, "text_ids_masked": ids_masked,
                "masked_pos": pos, "masked_ids": labels}

    def __iter__(self):
        return self._samples(self._sample)
