"""Dataset factory (the port's counterpart of x2vlm_tpu/data/factory.py,
``create_dataset``): task name + config -> (train_dataset, eval_dataset).

The port builds the retrieval, NLVR2 and grounding datasets; the launcher
(run.py) refuses the JAX factory's other tasks before they reach here,
naming the ROADMAP queue item each comes with. Pretraining streams are
built by the launcher."""

from __future__ import annotations

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
    if task not in ("retrieval", "itr_coco", "itr_flickr", "nlvr", "grounding",
                    "refcoco_bbox"):
        raise NotImplementedError(f"dataset task {task!r}: the port builds the retrieval, "
                                  f"NLVR2 and grounding datasets (ROADMAP queue A6 / A8 "
                                  f"bring the others)")
    tokenizer = tokenizer or build_tokenizer(config["text_encoder"])
    res = config["image_res"]
    pre = TextPreprocessor(tokenizer, max_tokens=config.get("max_tokens", 40),
                           max_words=config.get("max_words", config.get("max_tokens", 40)))
    train_tf = T.train_transform(res, rng=rng)
    test_tf = T.test_transform(res)
    rng = rng or random

    if task == "nlvr":
        from x2vlm_tpu_torch.data.finetune import NLVRDataset

        ev = _per_split(config["test_file"], lambda f: NLVRDataset(
            f, test_tf, config["image_root"], pre))
        if evaluate:
            return None, ev
        return NLVRDataset(config["train_file"], train_tf, config["image_root"], pre), ev

    if task in ("grounding", "refcoco_bbox"):
        from x2vlm_tpu_torch.data.finetune import GroundingEvalDataset, GroundingTrainDataset

        ev = GroundingEvalDataset(config["test_file"], test_tf, config["image_root"], pre)
        if evaluate:
            return None, ev
        return GroundingTrainDataset(
            config["train_file"], T.box_transform(rng=rng), config["image_root"], pre,
            image_res=res, careful_hflip=config.get("careful_hflip", True), rng=rng), ev

    from x2vlm_tpu_torch.data.retrieval import RetrievalEvalDataset, RetrievalTrainDataset

    ev = _per_split(config["test_file"], lambda f: RetrievalEvalDataset(
        f, test_tf, config["image_root"], pre))
    if evaluate:
        return None, ev
    return RetrievalTrainDataset(config["train_file"], train_tf, config["image_root"], pre,
                                 rng=rng), ev
