"""Classification accuracy over an eval set (the port's counterpart of
x2vlm_tpu/tasks/classification.py; reference NLVR.py:73-96)."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from x2vlm_tpu_torch.tasks.finetune import padded_batches

__all__ = ["evaluate_classification"]


@torch.inference_mode()
def evaluate_classification(model, dataset, *, device, batch_size: int = 32,
                            label_key: str = "labels") -> Dict[str, float]:
    """``{accuracy: percent, n}`` of argmax(``model.predict(batch)``)
    against ``label_key``. The batch holds every key of a sample but the
    label, as the JAX function's does (NLVR's predict reads image0 /
    image1; multiple choice's image, option_ids and option_atts; a video
    batch's image is (B, F, H, W, 3))."""
    model.eval()
    correct = total = 0
    for samples, rows in padded_batches(dataset, batch_size):
        batch = {k: torch.from_numpy(np.stack([s[k] for s in rows])).to(device)
                 for k in rows[0] if k != label_key}
        preds = model.predict(batch).argmax(-1).cpu().numpy()
        for j, s in enumerate(samples):
            total += 1
            correct += int(preds[j] == int(s[label_key]))
    return {"accuracy": 100.0 * correct / max(total, 1), "n": total}
