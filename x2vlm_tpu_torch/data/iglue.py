"""The multilingual IGLUE fine-tune datasets (the port's copy of
x2vlm_tpu/data/iglue.py; reference wit_dataset.py, xflickrco_dataset.py,
xvnli_dataset.py and the MARVL handling of nlvr_dataset.py).

Each maps its task's annotation schema onto an interface the port already
runs: WIT and xFlickrCO the retrieval eval tables and train samples
(``n_images`` / ``image_batch`` / ``text_batch`` / ``txt2img`` /
``img2txt``), XVNLI classification samples (three labels) and MARVL
NLVR2-style two-image samples. Images decode with the port's PIL
``open_image`` / ``decode_image``, as the JAX package decodes them, so both
packages give equal samples.
"""

from __future__ import annotations

import base64
import json
import os
import random
from typing import Dict, List, Optional

import numpy as np

from x2vlm_tpu_torch.data.imageio import decode_image, open_image
from x2vlm_tpu_torch.data.tokenization import TextPreprocessor

__all__ = ["WITRetrievalDataset", "XFlickrCODataset", "XVNLIDataset", "MARVLDataset"]


def _read_jsonl(files) -> List[dict]:
    if isinstance(files, str):
        files = [files]
    out = []
    for f in files:
        with open(f) as fh:
            for line in fh:
                line = line.strip()
                if line:
                    out.append(json.loads(line))
    return out


class _RetrievalTables:
    """The retrieval eval interface over ``self.texts`` and ``_image(i)``."""

    def image_batch(self, indices) -> np.ndarray:
        return np.stack([self.transform(self._image(i)) for i in indices]).astype(np.float32)

    def text_batch(self, indices):
        ids, atts = [], []
        for i in indices:
            a, b = self.text_pre(self.texts[i])
            ids.append(a)
            atts.append(b)
        return np.stack(ids), np.stack(atts)

    def n_texts(self) -> int:
        return len(self.texts)


class WITRetrievalDataset(_RetrievalTables):
    """WIT: JSONL lines ``{image_content: base64, image_url,
    caption_reference_description}`` (reference wit_dataset.py:25-98), the
    lines without a caption dropped; one caption an image. The image is in
    the line, so there is no image root."""

    def __init__(self, ann_files, transform, text_pre: TextPreprocessor):
        self.ann = [a for a in _read_jsonl(ann_files) if a.get("caption_reference_description")]
        self.transform = transform
        self.text_pre = text_pre
        self.texts = [a["caption_reference_description"] for a in self.ann]
        self.txt2img = {i: i for i in range(len(self.ann))}
        self.img2txt = {i: [i] for i in range(len(self.ann))}

    def n_images(self) -> int:
        return len(self.ann)

    def _image(self, i):
        return decode_image(base64.b64decode(self.ann[i]["image_content"]))

    def __len__(self) -> int:
        return len(self.ann)

    def __getitem__(self, index):
        ids, atts = self.text_pre(self.texts[index])
        return {"image": self.transform(self._image(index)).astype(np.float32),
                "text_ids": ids, "text_atts": atts, "idx": np.int32(index)}


class XFlickrCODataset(_RetrievalTables):
    """xFlickrCO: JSONL lines ``{sentences: [...], id, img_path}`` (reference
    xflickrco_dataset.py:21-76), lines of one ``id`` sharing an image. A
    train sample is one sentence; the eval tables list every sentence."""

    def __init__(self, ann_files, transform, image_root, text_pre,
                 rng: Optional[random.Random] = None):
        self.transform = transform
        self.image_root = image_root
        self.text_pre = text_pre
        self.rng = rng or random
        self.images: List[str] = []
        self.texts: List[str] = []
        self.txt2img: Dict[int, int] = {}
        self.img2txt: Dict[int, List[int]] = {}
        self.rows = []
        img_ids: Dict = {}
        for a in _read_jsonl(ann_files):
            if a["id"] not in img_ids:
                img_ids[a["id"]] = len(self.images)
                self.images.append(a["img_path"])
                self.img2txt[img_ids[a["id"]]] = []
            ii = img_ids[a["id"]]
            for s in a["sentences"]:
                ti = len(self.texts)
                self.texts.append(s)
                self.txt2img[ti] = ii
                self.img2txt[ii].append(ti)
                self.rows.append({"caption": s, "img_index": ii})

    def n_images(self) -> int:
        return len(self.images)

    def _image(self, ii):
        return open_image(os.path.join(self.image_root, self.images[ii]))

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, index):
        r = self.rows[index]
        ids, atts = self.text_pre(r["caption"])
        return {"image": self.transform(self._image(r["img_index"])).astype(np.float32),
                "text_ids": ids, "text_atts": atts, "idx": np.int32(r["img_index"])}


class XVNLIDataset:
    """XVNLI: JSONL lines ``{Flikr30kID, sentence2, gold_label}`` -> 3-way
    classification (reference xvnli_dataset.py:13-55); lines whose label is
    none of ``LABELS`` are dropped. The image is ``<Flikr30kID>.jpg`` under
    the image root."""

    LABELS = {"contradiction": 0, "entailment": 1, "neutral": 2}

    def __init__(self, ann_files, transform, image_root, text_pre):
        self.ann = [a for a in _read_jsonl(ann_files) if a.get("gold_label") in self.LABELS]
        self.transform = transform
        self.image_root = image_root
        self.text_pre = text_pre

    def __len__(self) -> int:
        return len(self.ann)

    def __getitem__(self, index):
        a = self.ann[index]
        img = open_image(os.path.join(self.image_root, a["Flikr30kID"] + ".jpg"))
        ids, atts = self.text_pre(a["sentence2"])
        return {"image": self.transform(img).astype(np.float32), "text_ids": ids,
                "text_atts": atts, "labels": np.int32(self.LABELS[a["gold_label"]])}


class MARVLDataset:
    """MARVL: NLVR2-style two-image reasoning in five languages; JSONL lines
    ``{left_img, right_img, caption, label}`` or in the NLVR2 form
    ``{images: [left, right], sentence, label}``; ``label`` true (a bool or
    the string, any case) is 1. ``image_root=None`` reads the annotation's
    paths as they are (reference dataset/__init__.py:318-322)."""

    def __init__(self, ann_files, transform, image_root, text_pre):
        self.ann = _read_jsonl(ann_files)
        self.transform = transform
        self.image_root = image_root
        self.text_pre = text_pre

    def __len__(self) -> int:
        return len(self.ann)

    def _open(self, rpath):
        return open_image(os.path.join(self.image_root, rpath) if self.image_root else rpath)

    def __getitem__(self, index):
        a = self.ann[index]
        if "images" in a:
            left, right, caption = a["images"][0], a["images"][1], a["sentence"]
        else:
            left, right, caption = a["left_img"], a["right_img"], a["caption"]
        ids, atts = self.text_pre(caption)
        label = 1 if (a["label"] is True or str(a["label"]).lower() == "true") else 0
        return {"image0": self.transform(self._open(left)).astype(np.float32),
                "image1": self.transform(self._open(right)).astype(np.float32),
                "text_ids": ids, "text_atts": atts, "labels": np.int32(label)}
