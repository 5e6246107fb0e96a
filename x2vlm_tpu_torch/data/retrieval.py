"""Retrieval fine-tune datasets (the port's copy of
x2vlm_tpu/data/retrieval.py; reference dataset/retrieval_dataset.py).

- ``RetrievalTrainDataset``: (image, caption, idx) where idx identifies the
  image so duplicate captions of one image count as positives in ITC/ITM.
- ``RetrievalEvalDataset``: all texts + all images with txt2img / img2txt
  tables for the two-stage eval protocol.

Annotations: JSON list of {"image": path, "caption": str | [str], "image_id"}.
Images decode as data/imageio.py decodes them; with ``use_native_decode``
the eval's image batches decode in one call of the native data plane
(``data/native.NativeDecoder``: bicubic resize and normalise, the test
transform), falling back to PIL where the library is unavailable or an
item of the batch is broken, as in the JAX package.
"""

from __future__ import annotations

import json
import os
import random
from typing import Callable, Dict, List, Optional

import numpy as np

from x2vlm_tpu_torch.core.io import hopen
from x2vlm_tpu_torch.data.imageio import open_image
from x2vlm_tpu_torch.data.tokenization import TextPreprocessor

__all__ = ["RetrievalTrainDataset", "RetrievalEvalDataset"]


def _load_annotations(ann_files) -> List[dict]:
    if isinstance(ann_files, str):
        ann_files = [ann_files]
    ann = []
    for f in ann_files:
        with hopen(f, "r") as fh:
            ann.extend(json.load(fh))
    return ann


class RetrievalTrainDataset:
    def __init__(self, ann_files, transform: Callable, image_root: str,
                 text_preprocessor: TextPreprocessor,
                 rng: Optional[random.Random] = None):
        self.ann = _load_annotations(ann_files)
        self.transform = transform
        self.image_root = image_root
        self.text_pre = text_preprocessor
        self.rng = rng or random
        self.img_ids: Dict = {}
        n = 0
        for a in self.ann:
            img_id = a["image_id"] if "image_id" in a else a["image"]
            if img_id not in self.img_ids:
                self.img_ids[img_id] = n
                n += 1

    def __len__(self):
        return len(self.ann)

    def __getitem__(self, index: int):
        a = self.ann[index]
        img = open_image(a["image"], self.image_root)
        image = self.transform(img)
        caption = a["caption"]
        if isinstance(caption, list):
            caption = self.rng.choice(caption)
        text_ids, text_atts = self.text_pre(caption)
        img_id = a["image_id"] if "image_id" in a else a["image"]
        return {
            "image": image.astype(np.float32),
            "text_ids": text_ids,
            "text_atts": text_atts,
            "idx": np.int32(self.img_ids[img_id]),
        }


class RetrievalEvalDataset:
    def __init__(self, ann_file, transform: Callable, image_root: str,
                 text_preprocessor: TextPreprocessor, use_native_decode: bool = False,
                 image_res: int = 0):
        self.ann = _load_annotations(ann_file)
        self.transform = transform
        self.image_root = image_root
        self.text_pre = text_preprocessor
        self.native = None
        if use_native_decode:
            from x2vlm_tpu_torch.data.native import NativeDecoder, native_available

            if image_res <= 0:
                raise ValueError("use_native_decode requires image_res")
            if native_available():
                self.native = NativeDecoder(image_res, filter="bicubic")
        self.texts: List[str] = []
        self.images: List[str] = []
        self.txt2img: Dict[int, int] = {}
        self.img2txt: Dict[int, List[int]] = {}
        ti = 0
        for ii, a in enumerate(self.ann):
            self.images.append(a["image"])
            self.img2txt[ii] = []
            caps = a["caption"] if isinstance(a["caption"], list) else [a["caption"]]
            for cap in caps:
                self.texts.append(cap)
                self.img2txt[ii].append(ti)
                self.txt2img[ti] = ii
                ti += 1

    def n_images(self):
        return len(self.images)

    def n_texts(self):
        return len(self.texts)

    def image_batch(self, indices) -> np.ndarray:
        if self.native is not None:
            raws = []
            for i in indices:
                with hopen(os.path.join(self.image_root, self.images[i]), "rb") as f:
                    raws.append(f.read())
            out, ok = self.native.decode_raw(raws)
            if ok.all():
                return out
        out = [self.transform(open_image(self.images[i], self.image_root)) for i in indices]
        return np.stack(out).astype(np.float32)

    def text_batch(self, indices):
        ids, atts = [], []
        for i in indices:
            a, b = self.text_pre(self.texts[i])
            ids.append(a)
            atts.append(b)
        return np.stack(ids), np.stack(atts)
