"""Box operations (the port's copy of x2vlm_tpu/ops/box.py; reference
models/box_ops.py). Plain tensor functions: the JAX package runs no kernel
here either.

Boxes are (..., 4); cxcywh = (center_x, center_y, w, h), xyxy = (x0, y0, x1, y1),
normalised to [0, 1].
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = [
    "box_cxcywh_to_xyxy",
    "box_xyxy_to_cxcywh",
    "box_area",
    "box_iou",
    "generalized_box_iou",
    "elementwise_box_iou",
    "elementwise_generalized_box_iou",
]


def box_cxcywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1)


def box_xyxy_to_cxcywh(boxes: torch.Tensor) -> torch.Tensor:
    x0, y0, x1, y1 = boxes.unbind(-1)
    return torch.stack([(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0], dim=-1)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of xyxy boxes, shape (...,)."""
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def _inter_union(boxes1, boxes2, lt, rb):
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter, box_area(boxes1) + box_area(boxes2) - inter


def _hull(lt, rb):
    wh = (rb - lt).clamp(min=0)
    return wh[..., 0] * wh[..., 1]


def box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pairwise IoU between (N, 4) and (M, 4) xyxy boxes -> ((N, M) iou, (N, M) union)."""
    b1, b2 = boxes1[:, None], boxes2[None, :]
    inter, union = _inter_union(b1, b2, torch.maximum(b1[..., :2], b2[..., :2]),
                                torch.minimum(b1[..., 2:], b2[..., 2:]))
    return inter / union, union


def generalized_box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise GIoU (https://giou.stanford.edu/), (N, M). Boxes must be valid
    xyxy (x1 >= x0, y1 >= y0); callers guard degenerate boxes."""
    iou, union = box_iou(boxes1, boxes2)
    b1, b2 = boxes1[:, None], boxes2[None, :]
    hull = _hull(torch.minimum(b1[..., :2], b2[..., :2]), torch.maximum(b1[..., 2:], b2[..., 2:]))
    return iou - (hull - union) / hull


def elementwise_box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Row-wise IoU between equal-shaped (..., 4) xyxy boxes: the diagonal of
    :func:`box_iou` without the (N, N) matrix."""
    inter, union = _inter_union(boxes1, boxes2, torch.maximum(boxes1[..., :2], boxes2[..., :2]),
                                torch.minimum(boxes1[..., 2:], boxes2[..., 2:]))
    return inter / union


def elementwise_generalized_box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Row-wise GIoU for equal-shaped (..., 4) xyxy boxes (the diagonal of
    :func:`generalized_box_iou`)."""
    inter, union = _inter_union(boxes1, boxes2, torch.maximum(boxes1[..., :2], boxes2[..., :2]),
                                torch.minimum(boxes1[..., 2:], boxes2[..., 2:]))
    hull = _hull(torch.minimum(boxes1[..., :2], boxes2[..., :2]),
                 torch.maximum(boxes1[..., 2:], boxes2[..., 2:]))
    return inter / union - (hull - union) / hull
