"""Dataset factory (the port's counterpart of x2vlm_tpu/data/factory.py,
``create_dataset``): task name + config -> (train_dataset, eval_dataset).

The fine-tune datasets of every task the launcher runs: retrieval and the
IGLUE retrieval sets (``xretrieval``, ``wit``, ``xflickrco``), VQA and
xGQA, NLVR2 and MARVL, XVNLI, grounding, captioning and the video ones
(video QA, NExT-QA multiple choice, video retrieval). A ``test_file`` dict
gives one eval dataset a split or language (``{lang: dataset}``). MARVL
trains on English NLVR2; its ``en`` test set is NLVR2 on ``image_root``,
the other languages ``MARVLDataset`` on ``marvl_image_root`` (the
annotations' paths as they are without one). Pretraining streams are
built by the launcher."""

from __future__ import annotations

import json
import random
from typing import Optional, Tuple

from x2vlm_tpu_torch.data import transforms as T
from x2vlm_tpu_torch.data.tokenization import TextPreprocessor, build_tokenizer

__all__ = ["create_dataset"]


def _per_split(files, build):
    if isinstance(files, dict):
        return {k: build(v) for k, v in files.items()}
    return build(files)


def create_dataset(task: str, config, evaluate: bool = False, tokenizer=None,
                   rng: Optional[random.Random] = None
                   ) -> Tuple[Optional[object], Optional[object]]:
    tokenizer = tokenizer or build_tokenizer(config["text_encoder"])
    res = config["image_res"]
    pre = TextPreprocessor(tokenizer, max_tokens=config.get("max_tokens", 40),
                           max_words=config.get("max_words", config.get("max_tokens", 40)))
    train_tf = T.train_transform(res, rng=rng)
    test_tf = T.test_transform(res)
    rng = rng or random

    if task in ("retrieval", "xretrieval", "xre", "itr_coco", "itr_flickr"):
        from x2vlm_tpu_torch.data.retrieval import RetrievalEvalDataset, RetrievalTrainDataset

        ev = _per_split(config["test_file"], lambda f: RetrievalEvalDataset(
            f, test_tf, config["image_root"], pre))
        if evaluate:
            return None, ev
        return RetrievalTrainDataset(config["train_file"], train_tf, config["image_root"],
                                     pre, rng=rng), ev

    if task in ("vqa", "xgqa"):
        from x2vlm_tpu_torch.data.finetune import VQAEvalDataset, VQATrainDataset

        root = config.get("vqa_root", config.get("image_root"))
        if config.get("vg_root"):   # Visual Genome lines say dataset: "vg"
            root = {"vqa": root, "vg": config["vg_root"]}
        a_max = config.get("answer_max_tokens", 10)

        def build_eval(f):
            # a [path, answer list] pair names the split's own answer list
            # (xGQA's languages)
            ans = config.get("answer_list")
            if isinstance(f, (list, tuple)) and len(f) == 2 and \
                    isinstance(f[1], str) and f[1].endswith(".json"):
                f, ans = f[0], f[1]
            return VQAEvalDataset(f, test_tf, root, pre, tokenizer, answer_list_file=ans,
                                  answer_max_tokens=a_max)

        ev = _per_split(config["test_file"], build_eval)
        if evaluate:
            return None, ev
        return VQATrainDataset(config["train_file"], train_tf, root, pre, tokenizer,
                               answer_max_tokens=a_max, rng=rng), ev

    if task == "nlvr":
        from x2vlm_tpu_torch.data.finetune import NLVRDataset

        ev = _per_split(config["test_file"], lambda f: NLVRDataset(
            f, test_tf, config["image_root"], pre))
        if evaluate:
            return None, ev
        return NLVRDataset(config["train_file"], train_tf, config["image_root"], pre), ev

    if task == "marvl":
        from x2vlm_tpu_torch.data.finetune import NLVRDataset
        from x2vlm_tpu_torch.data.iglue import MARVLDataset

        def build_marvl(f, lang=None):
            if lang == "en":
                return NLVRDataset(f, test_tf, config["image_root"], pre)
            return MARVLDataset(f, test_tf, config.get("marvl_image_root"), pre)

        files = config["test_file"]
        ev = ({k: build_marvl(v, lang=k) for k, v in files.items()}
              if isinstance(files, dict) else build_marvl(files))
        if evaluate:
            return None, ev
        return NLVRDataset(config["train_file"], train_tf, config["image_root"], pre), ev

    if task == "xvnli":
        from x2vlm_tpu_torch.data.iglue import XVNLIDataset

        ev = _per_split(config["test_file"], lambda f: XVNLIDataset(
            f, test_tf, config["image_root"], pre))
        if evaluate:
            return None, ev
        return XVNLIDataset(config["train_file"], train_tf, config["image_root"], pre), ev

    if task == "xflickrco":
        from x2vlm_tpu_torch.data.iglue import XFlickrCODataset

        ev = _per_split(config["test_file"], lambda f: XFlickrCODataset(
            f, test_tf, config["image_root"], pre))
        if evaluate:
            return None, ev
        return XFlickrCODataset(config["train_file"], train_tf, config["image_root"], pre,
                                rng=rng), ev

    if task == "wit":
        from x2vlm_tpu_torch.data.iglue import WITRetrievalDataset

        ev = _per_split(config["test_file"], lambda f: WITRetrievalDataset(f, test_tf, pre))
        if evaluate:
            return None, ev
        return WITRetrievalDataset(config["train_file"], train_tf, pre), ev

    if task in ("grounding", "refcoco_bbox"):
        from x2vlm_tpu_torch.data.finetune import GroundingEvalDataset, GroundingTrainDataset

        ev = GroundingEvalDataset(config["test_file"], test_tf, config["image_root"], pre)
        if evaluate:
            return None, ev
        return GroundingTrainDataset(
            config["train_file"], T.box_transform(rng=rng), config["image_root"], pre,
            image_res=res, careful_hflip=config.get("careful_hflip", True), rng=rng), ev

    if task in ("captioning", "coco_captioning_mlm"):
        from x2vlm_tpu_torch.data.finetune import CaptioningEvalDataset, CaptioningTrainDataset

        ev = CaptioningEvalDataset(config["test_file"], test_tf, config["image_root"])
        if evaluate:
            return None, ev
        return CaptioningTrainDataset(
            config["train_file"], T.train_transform(res, rng=rng, with_hflip=False),
            config["image_root"], tokenizer, prompt=config.get("prompt", ""),
            max_tokens=config.get("max_tokens", 25), max_masks=config.get("max_masks", 12),
            mask_prob=config.get("mask_prob", 0.5), fg_free=config.get("fg_free", False),
            rng=rng), ev

    if task in ("video_qa", "vqa_msrvtt", "vqa_msvd"):
        from x2vlm_tpu_torch.data.video import VideoQADataset

        with open(config["answer_list"]) as f:
            answers = json.load(f)
        kw = dict(video_root=config["video_root"], text_pre=pre, answer_list=answers,
                  frame_len=config.get("frame_len", 5))
        ev = _per_split(config["test_file"], lambda f: VideoQADataset(
            f, test_tf, training=False, **kw))
        if evaluate:
            return None, ev
        # the JAX factory passes no rng here: the train set draws from `random`
        return VideoQADataset(config["train_file"], train_tf, **kw), ev

    if task in ("next_qa_mc", "video_qa_mc"):
        from x2vlm_tpu_torch.data.video import NextQAMCDataset

        kw = dict(video_root=config["video_root"], text_pre=pre,
                  frame_len=config.get("frame_len", 5), num_options=config.get("num_options", 5))
        ev = _per_split(config["test_file"], lambda f: NextQAMCDataset(
            f, test_tf, training=False, **kw))
        if evaluate:
            return None, ev
        return NextQAMCDataset(config["train_file"], train_tf, training=True, rng=rng, **kw), ev

    if task in ("video_retrieval", "itr_coco_msrvtt"):
        from x2vlm_tpu_torch.data.video import VideoRetrievalDataset

        frame_len = config.get("frame_len", 5)
        ev = _per_split(config["test_file"], lambda f: VideoRetrievalDataset(
            f, test_tf, config["video_root"], pre, frame_len=frame_len))
        if evaluate:
            return None, ev
        return VideoRetrievalDataset(config["train_file"], train_tf, config["video_root"], pre,
                                     frame_len=frame_len, training=True, rng=rng), ev

    raise ValueError(f"unknown dataset task {task!r}")
