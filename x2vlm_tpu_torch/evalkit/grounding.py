"""Grounding evaluation (the port's copy of
x2vlm_tpu/evalkit/grounding.py): IoU >= 0.5 accuracy per RefCOCO split
(reference dataset/utils.py:363-400 ``grounding_eval_bbox``) and the VLUE
test-set variants, reached with the ``vlue_test`` knob: bbox
(dataset/utils.py:403-437 ``grounding_eval_bbox_vlue``) and mask scoring
over candidate detections (dataset/utils.py:318-360
``grounding_eval_vlue``: the predicted map resized bicubic to the image,
each detection scored by the map's sum inside it over its area to the
``alpha``). The RLE-mask protocol is ``evalkit/refer.py``.

Predictions are normalised cxcywh in the model's square input frame;
ground-truth boxes are pixel xywh in the original image. A prediction is
scaled by the original (W, H), as the reference does.
"""

from __future__ import annotations

import json
from typing import Dict, Iterable

import numpy as np

__all__ = ["iou_xyxy", "cxcywh_norm_to_xyxy_pixels", "grounding_eval_bbox",
           "grounding_eval_bbox_vlue", "grounding_eval_vlue"]


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


def _cubic_kernel(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Keys' cubic-convolution kernel with a = -0.75 (torch
    ``F.interpolate``'s bicubic), over |x|."""
    x = np.abs(x)
    return np.where(x <= 1, (a + 2) * x ** 3 - (a + 3) * x ** 2 + 1,
                    np.where(x < 2, a * (x ** 3 - 5 * x ** 2 + 8 * x - 4), 0.0))


def _resize_bicubic(mask: np.ndarray, height: int, width: int) -> np.ndarray:
    """Separable bicubic resize as torch ``F.interpolate(mode='bicubic',
    align_corners=False)``: src = (dst + 0.5) * scale - 0.5, the taps
    clamped at the edges; float64."""
    def axis_matrix(n_src, n_dst):
        src = (np.arange(n_dst) + 0.5) * (n_src / n_dst) - 0.5
        base = np.floor(src).astype(int)
        m = np.zeros((n_dst, n_src), np.float64)
        for tap in (-1, 0, 1, 2):
            idx = np.clip(base + tap, 0, n_src - 1)
            np.add.at(m, (np.arange(n_dst), idx), _cubic_kernel(src - (base + tap)))
        return m

    mh, mw = axis_matrix(mask.shape[0], height), axis_matrix(mask.shape[1], width)
    return mh @ mask.astype(np.float64) @ mw.T


def grounding_eval_vlue(results: Iterable[Dict], test_json, alpha: float,
                        mask_size: int = 24) -> Dict[str, float]:
    """VLUE mask scoring: each result's ``pred`` a (mask_size x mask_size)
    map, resized to the image; the detection of ``dets`` (xywh pixels) with
    the largest sum(map inside it) / area ** alpha is the prediction, and it
    scores when its IoU with the ref's ``bbox`` is >= 0.5.
    ``{'score': fraction}``."""
    ref_map = _load_ref_map(test_json)
    correct = total = 0
    for r in results:
        ref = ref_map[r["ref_id"]]
        h, w = int(ref["height"]), int(ref["width"])
        mask = _resize_bicubic(np.asarray(r["pred"], np.float64).reshape(mask_size, mask_size),
                               h, w)
        best, pred_box = 0.0, None
        for det in ref["dets"]:
            x, y, dw, dh = det[:4]
            score = mask[int(y): int(y + dh), int(x): int(x + dw)].sum() / (dw * dh) ** alpha
            if score > best:
                best, pred_box = score, det[:4]
        gx, gy, gw, gh = ref["bbox"]
        total += 1
        if pred_box is not None:
            px, py, pw, ph = pred_box
            if iou_xyxy([px, py, px + pw, py + ph], [gx, gy, gx + gw, gy + gh]) >= 0.5:
                correct += 1
    return {"score": correct / max(total, 1)}
