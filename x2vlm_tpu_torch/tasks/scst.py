"""Self-critical sequence training (SCST) for captioning, one step (the
port's counterpart of x2vlm_tpu/tasks/scst.py; the reference declares a
``--scst`` flag, Captioning_MLM.py:272, with no loop behind it):

1. ``num_samples`` caption rollouts an image on the card
   (``sample_generate_captioning``);
2. CIDEr-D advantages with a leave-one-out baseline (train/scst.py);
3. one policy-gradient step: the advantage-weighted NLL of the sampled
   captions under the UniLM factorisation (each token predicted from a
   [MASK] at its position with tril visibility: the dataset's FG-free
   encoding with mask probability 1).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from x2vlm_tpu_torch.models.captioning import sample_generate_captioning
from x2vlm_tpu_torch.train.scst import scst_rewards

__all__ = ["build_scst_batch", "scst_train_step"]


def _encode_row(token_ids: List[int], prompt_ids: List[int], *, mask_token_id: int,
                sep_token_id: int, pad_token_id: int, L: int,
                max_masks: int) -> Dict[str, np.ndarray]:
    """The FG-free UniLM encoding of one sampled caption with every caption
    token and the closing [SEP] a target (``max_masks`` at most): a [MASK]
    before each, both at its position."""
    toks = list(prompt_ids) + list(token_ids) + [sep_token_id]
    n_src = len(prompt_ids)
    seq: List[int] = []
    pos: List[int] = []
    masked_pos: List[int] = []
    masked_ids: List[int] = []
    for p, tok in enumerate(toks):
        if p >= n_src and len(masked_pos) < max_masks:
            masked_pos.append(len(seq))
            seq.append(mask_token_id)
            pos.append(p)
            masked_ids.append(tok)
        seq.append(tok)
        pos.append(p)
    seq, pos = seq[:L], pos[:L]
    atts = np.tril(np.ones((L, L), np.int32))
    for mp in masked_pos:
        if mp < L:
            atts[:, mp] = 0
            atts[mp, mp] = 1
    pad = L - len(seq)
    seq = seq + [pad_token_id] * pad
    nxt = (pos[-1] + 1) if pos else 0
    pos = pos + list(range(nxt, nxt + pad))
    pad_m = max_masks - len(masked_pos)
    # a caption longer than L leaves masked slots past the cut row: weight 0,
    # so the clamped gather never trains on the wrong row
    weight = [1.0 if mp < L else 0.0 for mp in masked_pos] + [0.0] * pad_m
    masked_pos = [min(mp, L - 1) for mp in masked_pos] + [0] * pad_m
    return {"text_ids_masked": np.asarray(seq, np.int32),
            "text_atts_matrix": atts,
            "position_ids": np.asarray(pos, np.int32),
            "masked_pos": np.asarray(masked_pos, np.int32),
            "masked_ids": np.asarray(masked_ids + [-100] * pad_m, np.int32),
            "masked_weight": np.asarray(weight, np.float32)}


def build_scst_batch(images: torch.Tensor, sampled: Sequence[List[int]],
                     advantages: np.ndarray, prompt_ids: List[int], *, mask_token_id: int,
                     sep_token_id: int, pad_token_id: int,
                     max_length: int) -> Dict[str, torch.Tensor]:
    """images (B, ...) on the card; ``sampled``: B * k token lists,
    image-major; ``advantages`` (B * k,). The policy-gradient step's batch
    on the images' device: rows of ``len(prompt_ids) + 2 * (max_length +
    1)`` tokens, each image repeated k times, ``sample_weights`` the
    advantages."""
    k = len(sampled) // images.shape[0]
    max_masks = max_length + 1                      # caption tokens + [SEP]
    L = len(prompt_ids) + 2 * max_masks
    rows = [_encode_row(s, prompt_ids, mask_token_id=mask_token_id,
                        sep_token_id=sep_token_id, pad_token_id=pad_token_id, L=L,
                        max_masks=max_masks) for s in sampled]
    dev = images.device
    batch = {key: torch.from_numpy(np.stack([r[key] for r in rows])) for key in rows[0]}
    batch = {key: (v.long() if v.dtype == torch.int32 else v).to(dev)
             for key, v in batch.items()}
    batch["image"] = images.repeat_interleave(k, dim=0)
    batch["sample_weights"] = torch.as_tensor(np.asarray(advantages, np.float32), device=dev)
    return batch


def scst_train_step(model, step_fn, images: torch.Tensor, references: Sequence[List[str]],
                    tokenizer, generator: Optional[torch.Generator] = None, *,
                    prompt_ids: List[int], num_samples: int = 5, max_length: int = 20,
                    temperature: float = 1.0, step_generators=()):
    """One SCST step: rollouts drawn from ``generator``, their CIDEr-D
    advantages, then ``step_fn(batch, *step_generators)`` (a
    ``make_train_step`` step). Returns (metrics, sampled captions)."""
    sampled = sample_generate_captioning(
        model, images, prompt_ids, generator, mask_token_id=tokenizer.mask_token_id,
        eos_token_id=tokenizer.sep_token_id, num_samples=num_samples, max_length=max_length,
        temperature=temperature)
    captions = [tokenizer.decode(s, skip_special_tokens=True) for s in sampled]
    adv = scst_rewards(captions, list(references), num_samples_per_image=num_samples)
    batch = build_scst_batch(images, sampled, adv, prompt_ids,
                             mask_token_id=tokenizer.mask_token_id,
                             sep_token_id=tokenizer.sep_token_id,
                             pad_token_id=tokenizer.pad_token_id, max_length=max_length)
    return step_fn(batch, *step_generators), captions
