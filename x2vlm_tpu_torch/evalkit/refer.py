"""RefCOCO mask-scoring evaluation (the port's copy of
x2vlm_tpu/evalkit/refer.py; reference dataset/utils.py:270-315
``grounding_eval`` and the refTools REFER API, which lean on pycocotools'
C extension).

COCO RLE read here with numpy alone: the compressed string (6-bit chunks at
chr(48 + x), 0x20 a continuation, counts from the third on delta-coded
against the count two back) and the plain counts list, runs laid out
column-major; the mask IoU; and the score of a predicted box by the IoU of
the box, drawn as a mask, with the referred object's mask.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Union

import numpy as np

from x2vlm_tpu_torch.evalkit.grounding import cxcywh_norm_to_xyxy_pixels

__all__ = ["rle_decode", "mask_iou", "grounding_eval_mask"]


def _decode_rle_string(s: Union[str, bytes]) -> List[int]:
    """pycocotools' compressed RLE string -> its run counts."""
    if isinstance(s, str):
        s = s.encode()
    counts: List[int] = []
    i = 0
    while i < len(s):
        x = k = 0
        more = True
        while more:
            c = s[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def rle_decode(rle: Dict) -> np.ndarray:
    """{'size': [h, w], 'counts': str | bytes | list} -> (h, w) uint8 mask."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = _decode_rle_string(counts)
    flat = np.zeros(h * w, np.uint8)
    pos, val = 0, 0
    for c in counts:
        if val:
            flat[pos: pos + c] = 1
        pos += c
        val ^= 1
    return flat.reshape(w, h).T


def mask_iou(a: np.ndarray, b: np.ndarray) -> float:
    inter = np.logical_and(a, b).sum()
    union = np.logical_or(a, b).sum()
    return float(inter) / float(union) if union else 0.0


def grounding_eval_mask(results: Iterable[Dict], refs: Dict[int, Dict],
                        iou_thresh: float = 0.5) -> Dict[str, float]:
    """results: [{ref_id, pred: normalised cxcywh}]; refs: ref_id ->
    {split, rle: a COCO RLE, width, height}. A prediction scores when its
    box, drawn as a mask (rounded, clipped to the image), has an IoU with
    the referred mask of at least ``iou_thresh``. Returns ``{split}_acc``
    in percent for each split seen."""
    correct: Dict[str, int] = {}
    total: Dict[str, int] = {}
    for r in results:
        ref = refs.get(int(r["ref_id"]))
        if ref is None:
            continue
        split = ref["split"]
        gt = rle_decode(ref["rle"])
        h, w = gt.shape
        x0, y0, x1, y1 = cxcywh_norm_to_xyxy_pixels(r["pred"], ref.get("width", w),
                                                    ref.get("height", h))
        box = np.zeros_like(gt)
        x0, y0 = max(int(round(x0)), 0), max(int(round(y0)), 0)
        x1, y1 = min(int(round(x1)), w), min(int(round(y1)), h)
        if x1 > x0 and y1 > y0:
            box[y0:y1, x0:x1] = 1
        total[split] = total.get(split, 0) + 1
        if mask_iou(box, gt) >= iou_thresh:
            correct[split] = correct.get(split, 0) + 1
    return {f"{s}_acc": 100.0 * correct.get(s, 0) / max(total.get(s, 0), 1) for s in total}
