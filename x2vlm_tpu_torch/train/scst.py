"""Self-critical sequence training criterion (the port's copy of
x2vlm_tpu/train/scst.py; reference utils/__init__.py:17-98
``ScstRewardCriterion``): reward = the CIDEr-D of a sampled caption less a
baseline (the greedy caption, or the mean of the image's other samples)."""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from x2vlm_tpu_torch.evalkit.caption import cider_d

__all__ = ["scst_rewards", "scst_loss_weights"]


def scst_rewards(sampled: Sequence[str], references: Sequence[List[str]],
                 baseline: Optional[Sequence[str]] = None,
                 num_samples_per_image: int = 1) -> np.ndarray:
    """Per-sample advantage (N * k,) fp32. ``sampled``: N * k captions, k a
    image, image-major; ``references``: N reference lists; ``baseline``: N
    greedy captions, or None for the leave-one-out mean of the k samples
    (reference :52-76)."""
    k = num_samples_per_image
    n = len(references)
    if len(sampled) != n * k:
        raise ValueError(f"{len(sampled)} sampled captions for {n} images x {k} samples")
    scores = np.asarray([cider_d([sampled[i * k + j]], [references[i]])
                         for i in range(n) for j in range(k)], np.float32).reshape(n, k)
    if baseline is not None:
        base = np.asarray([cider_d([b], [r]) for b, r in zip(baseline, references)],
                          np.float32)[:, None]
    elif k == 1:
        base = np.zeros((n, 1), np.float32)
    else:
        base = (scores.sum(axis=1, keepdims=True) - scores) / (k - 1)
    return (scores - base).reshape(-1)


def scst_loss_weights(rewards: np.ndarray) -> np.ndarray:
    """The per-sample weights of the NLL: loss = mean(advantage * NLL)."""
    return rewards.astype(np.float32)
