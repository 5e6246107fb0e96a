"""Grounding evaluation (the port's copy of the bbox half of
x2vlm_tpu/evalkit/grounding.py): IoU >= 0.5 accuracy per RefCOCO split
(reference dataset/utils.py:363-400 ``grounding_eval_bbox``) and on a VLUE
test set (dataset/utils.py:403-437 ``grounding_eval_bbox_vlue``, reached
with the ``vlue_test`` knob).

Predictions are normalised cxcywh in the model's square input frame;
ground-truth boxes are pixel xywh in the original image. A prediction is
scaled by the original (W, H), as the reference does. The VLUE
mask-scoring evaluation (``grounding_eval_vlue``) is not ported: no
launcher path reaches it (ROADMAP A6a).
"""

from __future__ import annotations

import json
from typing import Dict, Iterable

__all__ = ["iou_xyxy", "cxcywh_norm_to_xyxy_pixels", "grounding_eval_bbox",
           "grounding_eval_bbox_vlue"]


def iou_xyxy(a, b) -> float:
    ax0, ay0, ax1, ay1 = a
    bx0, by0, bx1, by1 = b
    ix0, iy0 = max(ax0, bx0), max(ay0, by0)
    ix1, iy1 = min(ax1, bx1), min(ay1, by1)
    iw, ih = max(ix1 - ix0, 0.0), max(iy1 - iy0, 0.0)
    inter = iw * ih
    union = (ax1 - ax0) * (ay1 - ay0) + (bx1 - bx0) * (by1 - by0) - inter
    return inter / union if union > 0 else 0.0


def cxcywh_norm_to_xyxy_pixels(coord, width: int, height: int):
    cx, cy, w, h = coord
    cx, w = cx * width, w * width
    cy, h = cy * height, h * height
    return [cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2]


def grounding_eval_bbox(results: Iterable[Dict], refs: Dict[int, Dict]) -> Dict[str, float]:
    """results: [{ref_id, pred: normalised cxcywh}]; refs: ref_id ->
    {split: 'testA' | 'testB' | 'val', bbox: [x, y, w, h] pixels, width,
    height}. Returns ``{split}_acc`` in percent for each split."""
    correct = {"testA": 0, "testB": 0, "val": 0}
    total = {"testA": 0, "testB": 0, "val": 0}
    for r in results:
        ref = refs.get(int(r["ref_id"]))
        if ref is None:
            continue
        split = ref["split"]
        x, y, w, h = ref["bbox"]
        pred = cxcywh_norm_to_xyxy_pixels(r["pred"], ref["width"], ref["height"])
        total[split] = total.get(split, 0) + 1
        if iou_xyxy(pred, [x, y, x + w, y + h]) >= 0.5:
            correct[split] = correct.get(split, 0) + 1
    return {f"{s}_acc": 100.0 * correct.get(s, 0) / max(total.get(s, 0), 1) for s in total}


def _load_ref_map(test_json):
    """VLUE test annotations (a path or the list of {ref_id, bbox: xywh
    pixels, height, width}) -> ref_id -> annotation."""
    if isinstance(test_json, str):
        with open(test_json) as f:
            test_json = json.load(f)
    return {s["ref_id"]: s for s in test_json}


def grounding_eval_bbox_vlue(results: Iterable[Dict], test_json) -> Dict[str, float]:
    """IoU >= 0.5 accuracy on one split against the test json's own
    {bbox, width, height}: ``{'score': fraction}``, as the reference."""
    ref_map = _load_ref_map(test_json)
    correct = total = 0
    for r in results:
        ref = ref_map[r["ref_id"]]
        x, y, w, h = ref["bbox"]
        pred = cxcywh_norm_to_xyxy_pixels(r["pred"], ref["width"], ref["height"])
        total += 1
        if iou_xyxy(pred, [x, y, x + w, y + h]) >= 0.5:
            correct += 1
    return {"score": correct / max(total, 1)}
