"""Fine-tune datasets of the grounding and NLVR2 tasks (the port's copy of
``NLVRDataset``, ``GroundingTrainDataset`` and ``GroundingEvalDataset`` in
x2vlm_tpu/data/finetune.py; reference dataset/nlvr_dataset.py and
dataset/grounding_dataset.py:89-147).

Each sample is a dict of numpy arrays of fixed shape. The grounding train
set crops at random around the box, flips (not a caption naming left or
right, with ``careful_hflip``), resizes and renormalises the target to
cxcywh in [0, 1]; its ``random`` draws come in the JAX package's order,
so both packages give equal samples from equal seeds.
"""

from __future__ import annotations

import math
import random
from typing import Optional

import numpy as np

from x2vlm_tpu_torch.data.imageio import open_image, pil
from x2vlm_tpu_torch.data.retrieval import _load_annotations
from x2vlm_tpu_torch.data.transforms import hflip

__all__ = ["NLVRDataset", "GroundingTrainDataset", "GroundingEvalDataset"]


class NLVRDataset:
    """ann: {images: [im0, im1], sentence, label: 'True'|'False'}."""

    def __init__(self, ann_files, transform, image_root, text_pre):
        self.ann = _load_annotations(ann_files)
        self.transform = transform
        self.image_root = image_root
        self.text_pre = text_pre

    def __len__(self):
        return len(self.ann)

    def __getitem__(self, index):
        a = self.ann[index]
        im0 = open_image(a["images"][0], self.image_root)
        im1 = open_image(a["images"][1], self.image_root)
        ids, atts = self.text_pre(a["sentence"])
        label = 1 if str(a["label"]).lower() == "true" else 0
        return {"image0": self.transform(im0).astype(np.float32),
                "image1": self.transform(im1).astype(np.float32),
                "text_ids": ids, "text_atts": atts,
                "labels": np.int32(label)}


class GroundingTrainDataset:
    """RefCOCO-style lines {image, bbox: [x, y, w, h] pixels, text}: a
    random crop that keeps the box, a flip, the resize to ``image_res`` and
    the cxcywh target; ``box_aug`` augments and normalises."""

    def __init__(self, ann_files, box_aug, image_root, text_pre, image_res: int,
                 careful_hflip: bool = True, rng: Optional[random.Random] = None):
        self.ann = _load_annotations(ann_files)
        self.box_aug = box_aug
        self.image_root = image_root
        self.text_pre = text_pre
        self.image_res = image_res
        self.careful_hflip = careful_hflip
        self.rng = rng or random

    def __len__(self):
        return len(self.ann)

    def __getitem__(self, index):
        rng = self.rng
        a = self.ann[index]
        img = open_image(a["image"], self.image_root)
        W, H = img.size
        x, y, w, h = a["bbox"]
        caption = a["text"]

        x0 = rng.randint(0, int(math.floor(x)))
        y0 = rng.randint(0, int(math.floor(y)))
        x1 = rng.randint(min(int(math.ceil(x + w)), W), W)
        y1 = rng.randint(min(int(math.ceil(y + h)), H), H)
        img = img.crop((x0, y0, x1, y1))
        W2, H2 = img.size
        x, y = x - x0, y - y0

        if rng.random() < 0.5 and not (
                self.careful_hflip and ("left" in caption or "right" in caption)):
            img = hflip(img)
            x = (W2 - x) - w

        sx = self.image_res / W2
        sy = self.image_res / H2
        x, w = x * sx, w * sx
        y, h = y * sy, h * sy
        img = img.resize((self.image_res, self.image_res), pil().BICUBIC)
        image = self.box_aug(img).astype(np.float32)
        ids, atts = self.text_pre(caption)
        target = np.asarray([(x + w / 2) / self.image_res, (y + h / 2) / self.image_res,
                             w / self.image_res, h / self.image_res], np.float32)
        return {"image": image, "text_ids": ids, "text_atts": atts, "target_bbox": target}


class GroundingEvalDataset:
    """RefCOCO-style lines {image, text, ref_id}: the test transform, the
    ``ref_id`` the evaluation looks its box up by."""

    def __init__(self, ann_files, transform, image_root, text_pre):
        self.ann = _load_annotations(ann_files)
        self.transform = transform
        self.image_root = image_root
        self.text_pre = text_pre

    def __len__(self):
        return len(self.ann)

    def __getitem__(self, index):
        a = self.ann[index]
        img = open_image(a["image"], self.image_root)
        ids, atts = self.text_pre(a["text"])
        return {"image": self.transform(img).astype(np.float32),
                "text_ids": ids, "text_atts": atts, "ref_id": np.int64(a["ref_id"])}
