"""Video fine-tune datasets (the port's copy of x2vlm_tpu/data/video.py;
reference dataset/vqa_dataset.py: msrvtt_qa_dataset:159, msvd_qa_dataset:275,
next_qa_mc_dataset:651, and the video rows of retrieval_dataset for
itr_coco_msrvtt).

A video is a directory of frame images (read in sorted order) or a list of
frame paths, under ``video_root``; ``sample_frame_ids`` picks ``frame_len``
of them (training: a random frame of each segment; eval: its middle).
``load_frames`` returns float32 (F, H, W, 3), as the JAX package does. The
``random`` draws come in the JAX package's order, so both packages give
equal samples from equal seeds.
"""

from __future__ import annotations

import json
import os
import random
from typing import Dict, List, Optional, Sequence

import numpy as np

from x2vlm_tpu_torch.data.imageio import open_image
from x2vlm_tpu_torch.data.pretrain import sample_frame_ids
from x2vlm_tpu_torch.data.retrieval import _load_annotations
from x2vlm_tpu_torch.data.tokenization import TextPreprocessor

__all__ = ["VideoQADataset", "VideoRetrievalDataset", "NextQAMCDataset", "load_frames"]


def load_frames(frame_source, transform, frame_len: int, training: bool, rng=None,
                video_root: str = "") -> np.ndarray:
    """``frame_len`` frames of a video (a directory of ordered frame images,
    or a list of paths) through ``transform`` -> float32 (F, H, W, 3)."""
    if isinstance(frame_source, str):
        path = os.path.join(video_root, frame_source)
        frames = [os.path.join(path, f) for f in sorted(os.listdir(path))]
    else:
        frames = [os.path.join(video_root, f) for f in frame_source]
    ids = sample_frame_ids(len(frames), frame_len, training, rng)
    return np.stack([transform(open_image(frames[i])) for i in ids]).astype(np.float32)


def _video_id(a: dict):
    return a.get("video_id", a["video"] if isinstance(a["video"], str)
                 else json.dumps(a["video"]))


class VideoQADataset:
    """Answer-list video QA (MSRVTT / MSVD): ann {video, question, answer};
    the label is the answer's index in ``answer_list`` (-100, ignored by the
    loss and never right in the accuracy, when it is not there)."""

    def __init__(self, ann_files, transform, video_root: str, text_pre: TextPreprocessor,
                 answer_list: Sequence[str], frame_len: int = 5, training: bool = True,
                 rng: Optional[random.Random] = None):
        self.ann = _load_annotations(ann_files)
        self.transform = transform
        self.video_root = video_root
        self.text_pre = text_pre
        self.answer_to_id = {a: i for i, a in enumerate(answer_list)}
        self.frame_len = frame_len
        self.training = training
        self.rng = rng or random

    def __len__(self):
        return len(self.ann)

    def __getitem__(self, index):
        a = self.ann[index]
        frames = load_frames(a["video"], self.transform, self.frame_len, self.training,
                             self.rng, self.video_root)
        ids, atts = self.text_pre(a["question"])
        label = self.answer_to_id.get(str(a.get("answer", "")), -100)
        return {"image": frames, "text_ids": ids, "text_atts": atts,
                "labels": np.int32(label)}


class VideoRetrievalDataset:
    """Video-text retrieval (itr_coco_msrvtt): the two-stage eval protocol of
    image retrieval over (F, H, W, 3) videos (``n_images`` / ``image_batch``
    / ``n_texts`` / ``text_batch``, ``txt2img`` / ``img2txt``), and as a
    train set rows {image (F, H, W, 3), text_ids, text_atts, idx} with one
    ``idx`` per distinct video (``video_id``, else the video itself)."""

    def __init__(self, ann_files, transform, video_root: str, text_pre: TextPreprocessor,
                 frame_len: int = 5, training: bool = False, rng=None):
        self.ann = _load_annotations(ann_files)
        self.transform = transform
        self.video_root = video_root
        self.text_pre = text_pre
        self.frame_len = frame_len
        self.training = training
        self.rng = rng or random
        self.vid_ids: Dict = {}
        for a in self.ann:
            self.vid_ids.setdefault(_video_id(a), len(self.vid_ids))
        self.texts: List[str] = []
        self.videos: List = []
        self.txt2img: Dict[int, int] = {}
        self.img2txt: Dict[int, List[int]] = {}
        for vi, a in enumerate(self.ann):
            self.videos.append(a["video"])
            self.img2txt[vi] = []
            for cap in a["caption"] if isinstance(a["caption"], list) else [a["caption"]]:
                self.img2txt[vi].append(len(self.texts))
                self.txt2img[len(self.texts)] = vi
                self.texts.append(cap)

    def __len__(self):
        return len(self.ann)

    def __getitem__(self, index):
        a = self.ann[index]
        frames = load_frames(a["video"], self.transform, self.frame_len, self.training,
                             self.rng, self.video_root)
        caption = a["caption"]
        if isinstance(caption, list):
            caption = self.rng.choice(caption) if self.training else caption[0]
        ids, atts = self.text_pre(caption)
        return {"image": frames, "text_ids": ids, "text_atts": atts,
                "idx": np.int32(self.vid_ids[_video_id(a)])}

    def n_images(self):
        return len(self.videos)

    def n_texts(self):
        return len(self.texts)

    def image_batch(self, indices) -> np.ndarray:
        return np.stack([load_frames(self.videos[i], self.transform, self.frame_len,
                                     self.training, self.rng, self.video_root)
                         for i in indices])

    def text_batch(self, indices):
        pairs = [self.text_pre(self.texts[i]) for i in indices]
        return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])


class NextQAMCDataset:
    """NExT-QA multiple choice (reference next_qa_mc_dataset,
    vqa_dataset.py:651): ``num_options`` (question + option) text rows a
    sample, ``option_ids`` / ``option_atts`` (K, L), and the right option's
    index as ``labels``."""

    def __init__(self, ann_files, transform, video_root: str, text_pre: TextPreprocessor,
                 frame_len: int = 5, num_options: int = 5, training: bool = True, rng=None):
        self.ann = _load_annotations(ann_files)
        self.transform = transform
        self.video_root = video_root
        self.text_pre = text_pre
        self.frame_len = frame_len
        self.num_options = num_options
        self.training = training
        self.rng = rng or random

    def __len__(self):
        return len(self.ann)

    def __getitem__(self, index):
        a = self.ann[index]
        frames = load_frames(a["video"], self.transform, self.frame_len, self.training,
                             self.rng, self.video_root)
        rows = [self.text_pre(f"{a['question']} {a['options'][i]}")
                for i in range(self.num_options)]
        return {"image": frames, "option_ids": np.stack([r[0] for r in rows]),
                "option_atts": np.stack([r[1] for r in rows]),
                "labels": np.int32(a["answer"])}
