"""Grounding prediction over an eval set (the port's counterpart of
x2vlm_tpu/tasks/grounding.py; reference Grounding_bbox.py:72-92): the boxes
``evalkit.grounding`` scores."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from x2vlm_tpu_torch.tasks.finetune import padded_batches

__all__ = ["predict_grounding"]


@torch.inference_mode()
def predict_grounding(model, dataset, *, device, batch_size: int = 32) -> List[Dict]:
    """[{ref_id, pred: normalised cxcywh}] for every sample of ``dataset``
    (``GroundingEvalDataset``), from ``model.predict`` (``XVLMForGrounding``)."""
    model.eval()
    results: List[Dict] = []
    for samples, rows in padded_batches(dataset, batch_size):
        image, ids, atts = (torch.from_numpy(np.stack([s[k] for s in rows])).to(device)
                            for k in ("image", "text_ids", "text_atts"))
        coords = model.predict(image, ids, atts).cpu().numpy()
        results += [{"ref_id": int(s["ref_id"]), "pred": coords[j].tolist()}
                    for j, s in enumerate(samples)]
    return results
