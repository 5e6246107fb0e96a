"""Fine-tune datasets of the VQA, grounding, NLVR2 and captioning tasks (the
port's copy of ``VQATrainDataset``, ``vqa_collate``, ``VQAEvalDataset``,
``tokenize_answers``, ``NLVRDataset``, ``GroundingTrainDataset``,
``GroundingEvalDataset`` and the three captioning sets in
x2vlm_tpu/data/finetune.py; reference dataset/vqa_dataset.py,
dataset/nlvr_dataset.py, dataset/grounding_dataset.py:89-147 and
dataset/captioning_dataset.py:99-230).

Each sample is a dict of numpy arrays of fixed shape. A VQA batch has a
fixed ``answers_per_batch`` answer rows: the questions' answers flattened,
cut to that many by a seeded draw or padded with rows of weight 0. The
grounding train set crops at random around the box, flips (not a caption
naming left or right, with ``careful_hflip``), resizes and renormalises
the target to cxcywh in [0, 1]. The captioning train set encodes a caption
for UniLM's MLM (whole-word masks after the prompt, a tril attention
matrix; ``fg_free``: a [MASK] inserted before each masked token, both at
its position, the [MASK] columns hidden). The ``random`` draws come in the JAX
package's order, so both packages give equal samples from equal seeds.
"""

from __future__ import annotations

import json
import math
import os
import random
from typing import Dict, Optional, Sequence

import numpy as np

from x2vlm_tpu_torch.core.io import hopen
from x2vlm_tpu_torch.data.imageio import open_image, pil
from x2vlm_tpu_torch.data.loader import collate
from x2vlm_tpu_torch.data.masking import TextMaskingGenerator
from x2vlm_tpu_torch.data.retrieval import _load_annotations
from x2vlm_tpu_torch.data.tokenization import pre_caption
from x2vlm_tpu_torch.data.transforms import hflip

__all__ = ["VQATrainDataset", "VQAEvalDataset", "vqa_collate", "tokenize_answers",
           "NLVRDataset", "GroundingTrainDataset", "GroundingEvalDataset",
           "CaptioningTrainDataset", "CaptioningSCSTDataset", "CaptioningEvalDataset"]


def tokenize_answers(answers: Sequence[str], tokenizer, max_tokens: int):
    """Answer list -> (A, L) int32 ids / atts: CLS, the answer's pieces, SEP,
    padded to ``max_tokens`` (the rank-answer protocol, reference VQA.py:78)."""
    ids, atts = [], []
    for a in answers:
        toks = [tokenizer.cls_token] + tokenizer.tokenize(a)
        toks = toks[: max_tokens - 1] + [tokenizer.sep_token]
        ii = tokenizer.convert_tokens_to_ids(toks)
        pad = max_tokens - len(ii)
        ids.append(ii + [tokenizer.pad_token_id] * pad)
        atts.append([1] * len(ii) + [0] * pad)
    return np.asarray(ids, np.int32), np.asarray(atts, np.int32)


class _VQAImages:
    """The image of a VQA line: ``image_roots`` one root, or a dict from
    the line's ``dataset`` ("vqa" by default; Visual Genome lines say "vg")
    to its root."""

    def _image_path(self, a) -> str:
        if isinstance(self.image_roots, str):
            return os.path.join(self.image_roots, a["image"])
        return os.path.join(self.image_roots[a.get("dataset", "vqa")], a["image"])

    def _question(self, a):
        image = self.transform(open_image(self._image_path(a))).astype(np.float32)
        q_ids, q_atts = self.text_pre(a["question"])
        return {"image": image, "question_ids": q_ids, "question_atts": q_atts}


class VQATrainDataset(_VQAImages):
    """Lines {image, question, answer: [..], (weight | dataset)}: without
    ``weight`` the duplicate answers merge, each weighted count / len (10
    human answers give count / 10; reference vqa_dataset.py:92-156)."""

    def __init__(self, ann_files, transform, image_roots, text_pre, tokenizer,
                 answer_max_tokens: int = 10, rng: Optional[random.Random] = None):
        self.ann = _load_annotations(ann_files)
        self.transform = transform
        self.image_roots = image_roots
        self.text_pre = text_pre
        self.tokenizer = tokenizer
        self.answer_max_tokens = answer_max_tokens
        self.rng = rng or random

    def __len__(self):
        return len(self.ann)

    def __getitem__(self, index):
        a = self.ann[index]
        out = self._question(a)
        answers = a["answer"] if isinstance(a["answer"], list) else [a["answer"]]
        if "weight" in a:
            weights = list(a["weight"])
        else:
            uniq: Dict[str, float] = {}
            for ans in answers:
                uniq[ans] = uniq.get(ans, 0.0) + 1.0 / len(answers)
            answers, weights = list(uniq.keys()), list(uniq.values())
        out["answers"], out["answer_atts"] = tokenize_answers(answers, self.tokenizer,
                                                              self.answer_max_tokens)
        out["weights"] = np.asarray(weights, np.float32)
        return out


def vqa_collate(samples: Sequence[Dict], answers_per_batch: int,
                rng: Optional[random.Random] = None) -> Dict[str, np.ndarray]:
    """A VQA train batch: the questions stacked, their answers flattened to
    ``answers_per_batch`` rows with ``answer_weights`` and ``answer_index``
    (each row's question). More rows are cut to a sorted ``rng.sample``;
    fewer are padded with weight-0 rows whose first key stays visible, so
    no attention row is wholly masked."""
    rng = rng or random.Random(0)
    base = collate([{k: s[k] for k in ("image", "question_ids", "question_atts")}
                    for s in samples])
    ans_ids, ans_atts, weights, index = [], [], [], []
    for qi, s in enumerate(samples):
        for j in range(s["answers"].shape[0]):
            ans_ids.append(s["answers"][j])
            ans_atts.append(s["answer_atts"][j])
            weights.append(s["weights"][j])
            index.append(qi)
    if len(ans_ids) > answers_per_batch:
        keep = sorted(rng.sample(range(len(ans_ids)), answers_per_batch))
        ans_ids = [ans_ids[i] for i in keep]
        ans_atts = [ans_atts[i] for i in keep]
        weights = [weights[i] for i in keep]
        index = [index[i] for i in keep]
    while len(ans_ids) < answers_per_batch:
        ans_ids.append(np.zeros_like(ans_ids[0]))
        ans_atts.append(np.zeros_like(ans_atts[0]))
        ans_atts[-1][0] = 1
        weights.append(0.0)
        index.append(0)
    base["answer_ids"] = np.stack(ans_ids)
    base["answer_atts"] = np.stack(ans_atts)
    base["answer_weights"] = np.asarray(weights, np.float32)
    base["answer_index"] = np.asarray(index, np.int32)
    return base


class VQAEvalDataset(_VQAImages):
    """Test lines {image, question, question_id, (answer)}; the answer list
    (``answer_list_file``, a JSON list) tokenised once as ``answer_ids`` /
    ``answer_atts``."""

    def __init__(self, ann_files, transform, image_roots, text_pre, tokenizer,
                 answer_list_file: Optional[str] = None, answer_max_tokens: int = 10):
        self.ann = _load_annotations(ann_files)
        self.transform = transform
        self.image_roots = image_roots
        self.text_pre = text_pre
        self.answer_list = None
        if answer_list_file:
            with hopen(answer_list_file, "r") as f:
                self.answer_list = json.load(f)
            self.answer_ids, self.answer_atts = tokenize_answers(
                self.answer_list, tokenizer, answer_max_tokens)

    def __len__(self):
        return len(self.ann)

    def gt_answers(self) -> Dict[int, list]:
        """question_id -> the human answers, for the lines that carry them
        (a test-std split carries none)."""
        out = {}
        for i, a in enumerate(self.ann):
            if "answer" in a:
                ans = a["answer"] if isinstance(a["answer"], list) else [a["answer"]]
                out[int(a.get("question_id", i))] = ans
        return out

    def __getitem__(self, index):
        a = self.ann[index]
        out = self._question(a)
        out["question_id"] = np.int64(a.get("question_id", index))
        return out


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


class CaptioningTrainDataset:
    """COCO captioning with UniLM MLM preprocessing (reference
    captioning_dataset.py:99-202): the standard encoding (tril attention)
    or ``fg_free`` (a [MASK] before each masked token, both at its
    position; the [MASK] columns hidden from every other row)."""

    def __init__(self, ann_files, transform, image_root, tokenizer, *, prompt: str = "",
                 max_tokens: int = 25, max_masks: int = 12, mask_prob: float = 0.5,
                 fg_free: bool = False, rng: Optional[random.Random] = None):
        self.ann = _load_annotations(ann_files)
        self.transform = transform
        self.image_root = image_root
        self.tokenizer = tokenizer
        self.prompt_tokens = tokenizer.tokenize(prompt) if prompt else []
        self.max_tokens = max_tokens
        self.max_masks = max_masks
        self.fg_free = fg_free
        self.rng = rng or random.Random()
        self.mask_generator = TextMaskingGenerator(tokenizer, mask_prob, max_masks,
                                                   mask_whole_word=True, rng=self.rng)
        self.pad_id = tokenizer.pad_token_id
        self.mask_token = tokenizer.mask_token

    def __len__(self):
        return len(self.ann)

    @property
    def seq_len(self):
        return self.max_tokens + (self.max_masks if self.fg_free else 0)

    def _tokens(self, caption):
        toks = self.tokenizer.tokenize(pre_caption(caption, self.max_tokens))
        toks = ([self.tokenizer.cls_token] + self.prompt_tokens + toks
                + [self.tokenizer.sep_token])
        return toks[: self.max_tokens]

    def preprocess(self, caption: str) -> Dict[str, np.ndarray]:
        tok = self.tokenizer
        toks = self._tokens(caption)
        masked, masked_pos = self.mask_generator(list(toks),
                                                 num_source_tokens=len(self.prompt_tokens))
        if not self.fg_free:
            ids = tok.convert_tokens_to_ids(toks)
            masked_ids = [ids[p] for p in masked_pos]
            L = self.max_tokens
            ids_masked = tok.convert_tokens_to_ids(masked)
            ids_masked += [self.pad_id] * (L - len(ids_masked))
            atts = np.tril(np.ones((L, L), np.int32))
            position_ids = np.arange(L, dtype=np.int32)
        else:
            masked_set = set(masked_pos)
            tokens_masked, positions, masked_pos, masked_ids = [], [], [], []
            for p, t in enumerate(toks):
                if p in masked_set:
                    masked_pos.append(len(tokens_masked))
                    tokens_masked += [self.mask_token, t]
                    positions += [p, p]
                    masked_ids.append(tok.convert_tokens_to_ids(t))
                else:
                    tokens_masked.append(t)
                    positions.append(p)
            L = self.max_tokens + self.max_masks
            atts = np.tril(np.ones((L, L), np.int32))
            for p in masked_pos:
                atts[:, p] = 0
                atts[p, p] = 1
            ids_masked = tok.convert_tokens_to_ids(tokens_masked)
            ids_masked += [self.pad_id] * (L - len(ids_masked))
            nxt = len(toks)
            positions += list(range(nxt, nxt + L - len(positions)))
            position_ids = np.asarray(positions, np.int32)
        n_mask = len(masked_pos)
        pad_m = self.max_masks - n_mask
        return {
            "text_ids_masked": np.asarray(ids_masked, np.int32),
            "text_atts_matrix": atts,
            "position_ids": position_ids,
            "masked_pos": np.asarray(list(masked_pos) + [0] * pad_m, np.int32),
            "masked_ids": np.asarray(list(masked_ids) + [-100] * pad_m, np.int32),
            "masked_weight": np.asarray([1.0] * n_mask + [0.0] * pad_m, np.float32),
        }

    def __getitem__(self, index):
        a = self.ann[index]
        img = open_image(a["image"], self.image_root)
        caption = a["caption"]
        if isinstance(caption, list):
            caption = self.rng.choice(caption)
        out = self.preprocess(caption)
        out["image"] = self.transform(img).astype(np.float32)
        return out


class CaptioningSCSTDataset:
    """The SCST set (reference captioning_dataset.py:230
    ``coco_karpathy_train_scst``): one row per image, sorted by path, with
    every ground-truth caption as a reward reference."""

    def __init__(self, ann_files, transform, image_root):
        by_image: Dict[str, list] = {}
        for a in _load_annotations(ann_files):
            caps = a["caption"] if isinstance(a["caption"], list) else [a["caption"]]
            by_image.setdefault(a["image"], []).extend(str(c) for c in caps)
        self.items = sorted(by_image.items())
        self.transform = transform
        self.image_root = image_root

    def __len__(self):
        return len(self.items)

    def __getitem__(self, index):
        path, captions = self.items[index]
        img = open_image(path, self.image_root)
        return {"image": self.transform(img).astype(np.float32), "captions": captions}


class CaptioningEvalDataset:
    """The captioning test set: an image and its ``image_id`` (the number at
    the end of a COCO file name, else the line's index)."""

    def __init__(self, ann_files, transform, image_root):
        self.ann = _load_annotations(ann_files)
        self.transform = transform
        self.image_root = image_root

    def __len__(self):
        return len(self.ann)

    def __getitem__(self, index):
        a = self.ann[index]
        img = open_image(a["image"], self.image_root)
        image_id = a.get("image_id", index)
        if isinstance(image_id, str) and "_" in image_id:
            image_id = int(image_id.split("_")[-1].split(".")[0])
        return {"image": self.transform(img).astype(np.float32), "image_id": np.int64(image_id)}
