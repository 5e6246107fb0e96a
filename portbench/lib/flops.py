"""Model FLOPs of X2-VLM's pretraining step and retrieval pass, counted
from the configuration's widths and the batch's shapes.

A matmul of (m, k) by (k, n) counts 2 m k n. Counted: every projection,
the attention products (QK^T and PV, 4 S_q S_kv C a layer), the MLP, the
heads (the MLM decoder over the vocabulary at the masked positions). The
fusion layers' cross-attention projects an image row's keys and values
once per distinct image row the pass attends to. A training step counts
its forward three times (forward and backward); recomputation is not
counted. Element-wise work (LayerNorm, softmax, GELU) is not counted.
"""

from __future__ import annotations

from typing import Dict

__all__ = ["vision_fwd", "text_fwd", "fusion_fwd", "pretrain_step", "retrieval_pass"]


def vision_fwd(v: Dict, images: int) -> float:
    C, p = v["width"], v["patch_size"]
    n = (v["image_res"] // p) ** 2
    S = n + 1
    hidden = int(C * v["mlp_ratio"])
    layer = 2 * S * C * 3 * C + 4 * S * S * C + 2 * S * C * C + 4 * S * C * hidden
    return images * (2.0 * n * 3 * p * p * C + v["depth"] * layer)


def _text_layer(t: Dict, S: int) -> float:
    D, I = t["hidden"], t["intermediate"]
    return 2 * S * D * 3 * D + 4 * S * S * D + 2 * S * D * D + 4 * S * D * I


def text_fwd(t: Dict, rows: int, S: int) -> float:
    return float(rows * t["fusion_layer"] * _text_layer(t, S))


def fusion_fwd(t: Dict, v: Dict, rows: int, S: int, image_rows: int, S_img: int) -> float:
    """The fusion layers over ``rows`` text rows of ``S`` tokens, attending
    to ``image_rows`` distinct image rows of ``S_img`` tokens."""
    D, Cv = t["hidden"], v["width"]
    cross_rows = 2 * S * D * D * 2 + 4 * S * S_img * D
    kv = 2 * S_img * Cv * D * 2
    n = t["layers"] - t["fusion_layer"]
    return float(n * (rows * (_text_layer(t, S) + cross_rows) + image_rows * kv))


def _head(D: int, out: int, rows: int) -> float:
    return 2.0 * rows * (D * 2 * D + 2 * D * out)


def _stream_fwd(m: Dict, images: int, rows: int, kv_rows: int, S: int, masks: int,
                bbox_rows: int = 0) -> float:
    v, t = m["vision"], m["text"]
    S_img = (v["image_res"] // v["patch_size"]) ** 2 + 1
    D = t["hidden"]
    f = vision_fwd(v, images)
    f += text_fwd(t, 2 * rows, S)
    f += 2.0 * rows * (v["width"] + D) * m["embed_dim"]
    f += fusion_fwd(t, v, 4 * rows, S, kv_rows, S_img)
    f += _head(D, 2, 3 * rows)
    f += 2.0 * rows * masks * (D * D + D * t["vocab"])
    if bbox_rows:
        f += fusion_fwd(t, v, bbox_rows, S, images, S_img) + _head(D, 4, bbox_rows)
    return f


def pretrain_step(m: Dict, traffic: Dict) -> float:
    """A step of the image stream (B images, B texts) and the region stream
    (B_r region rows over ``max_images`` images): 3 x the forward."""
    S, M = traffic["max_tokens"], traffic["max_masks"]
    img = traffic["image_batch"]
    reg, imgs = traffic["region_batch"], traffic["max_images"]
    f = _stream_fwd(m, img, img, img, S, M)
    f += _stream_fwd(m, imgs, reg, reg, S, M, bbox_rows=reg)
    return 3.0 * f


def retrieval_pass(m: Dict, n_images: int, n_texts: int, S: int, pairs: int) -> float:
    """Encode the gallery, then the ITM rerank of ``pairs`` pairs (each
    image's keys and values once a pass), forward only."""
    v, t = m["vision"], m["text"]
    S_img = (v["image_res"] // v["patch_size"]) ** 2 + 1
    f = vision_fwd(v, n_images) + text_fwd(t, n_texts, S)
    f += 2.0 * (n_images * v["width"] + n_texts * t["hidden"]) * m["embed_dim"]
    f += fusion_fwd(t, v, pairs, S, n_images, S_img) + _head(t["hidden"], 2, pairs)
    return f
