"""Caption generation over an eval set (the port's counterpart of
x2vlm_tpu/tasks/captioning.py; reference Captioning_MLM.py:74-103): the
captions ``evalkit.caption`` scores."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from x2vlm_tpu_torch.models.captioning import beam_search_generate_device
from x2vlm_tpu_torch.tasks.finetune import padded_batches

__all__ = ["generate_captions", "prompt_ids"]


def prompt_ids(tokenizer, prompt: str = "") -> List[int]:
    """[CLS] and the prompt's pieces, the ids every caption starts from."""
    return tokenizer.convert_tokens_to_ids(
        [tokenizer.cls_token] + (tokenizer.tokenize(prompt) if prompt else []))


def generate_captions(model, dataset, tokenizer, *, device, prompt: str = "",
                      num_beams: int = 3, min_length: int = 5, max_length: int = 20,
                      length_penalty: float = 0.0, batch_size: int = 16) -> List[Dict]:
    """[{image_id, caption}] for every image of ``dataset``
    (``CaptioningEvalDataset``): the beam search over batches of
    ``batch_size`` images (the last padded with copies of its last sample,
    whose captions are dropped), decoded without the special tokens."""
    ids = prompt_ids(tokenizer, prompt)
    results: List[Dict] = []
    for samples, rows in padded_batches(dataset, batch_size):
        image = torch.from_numpy(np.stack([s["image"] for s in rows])).to(device)
        seqs = beam_search_generate_device(
            model, image, ids, mask_token_id=tokenizer.mask_token_id,
            eos_token_id=tokenizer.sep_token_id, num_beams=num_beams,
            min_length=min_length, max_length=max_length, length_penalty=length_penalty)
        results += [{"image_id": int(s["image_id"]),
                     "caption": tokenizer.decode(seqs[j], skip_special_tokens=True)}
                    for j, s in enumerate(samples)]
    return results
