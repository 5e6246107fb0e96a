"""The plain attention core (counterpart of x2vlm_tpu/ops/attention.py).

Layout **(B, H, S, D)**: q (B, H, Sq, D); k, v (B, H, Skv, D); bias
broadcastable to (B, H, Sq, Skv); key_mask (B, Skv), nonzero = attend; or an
explicit boolean mask broadcastable to (B, H, Sq, Skv). Logits and softmax
are fp32; a masked logit is -1e30, so a row whose every key is masked stays
finite (it averages the values).

This is the path for the shapes neither hand-written kernel takes (see
``layers.MultiHeadAttention``); the kernels' own plain versions live beside
them in ``flash_attention.py`` and ``tiny_attention.py``.
"""

from __future__ import annotations

import collections
from typing import Optional

import torch

__all__ = ["dot_product_attention", "make_attention_mask", "dropout_multiplier", "wide",
           "NEG_INF"]

NEG_INF = -1e30  # large-but-finite: keeps fully-masked rows NaN-free


def wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the kernels' plain versions' working dtype: fp32 for bf16 and
    fp32, float64 as it is (a float64 case then holds an autograd wrapper
    to autograd with no fp32 rounding on either side)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def make_attention_mask(key_mask: Optional[torch.Tensor], q_len: int,
                        causal: bool = False, kv_len: Optional[int] = None,
                        device=None) -> Optional[torch.Tensor]:
    """A (B|1, 1, Sq, Skv) boolean mask from a (B, Skv) key mask and/or
    causality; key c is visible to query r iff c <= r + Skv - Sq. The
    causal part is made on ``device`` (default: the key mask's)."""
    mask = None
    if kv_len is None:
        kv_len = key_mask.shape[1] if key_mask is not None else q_len
    if key_mask is not None:
        mask = (key_mask != 0)[:, None, None, :].expand(
            key_mask.shape[0], 1, q_len, kv_len)
    if causal:
        if device is None and key_mask is not None:
            device = key_mask.device
        tri = torch.ones(q_len, kv_len, dtype=torch.bool, device=device).tril(
            diagonal=kv_len - q_len)[None, None]
        mask = tri if mask is None else (mask & tri)
    return mask


def dropout_multiplier(shape, rate: float, generator: Optional[torch.Generator],
                       dtype: torch.dtype, device) -> torch.Tensor:
    """Attention-probability dropout as a multiplier: 0 with probability
    ``rate``, else 1/(1-rate), drawn from the explicit ``generator``."""
    u = torch.rand(shape, generator=generator, device=device)
    keep = torch.full((), 1.0 / (1.0 - rate), dtype=dtype, device=device)
    return torch.where(u >= rate, keep, torch.zeros((), dtype=dtype, device=device))


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    bias: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    key_mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    scale: Optional[float] = None,
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
    training: bool = False,
) -> torch.Tensor:
    """Scaled dot-product attention with ``torch.matmul``; returns
    (B, H, Sq, D) in q's dtype. Dropout is active only with ``training``.
    ``dot_product_attention.calls`` counts the calls, and ``.calls_by_shape``
    them by (B, Sq, Skv), so a run can show that a path took the kernels
    instead, or which of its shapes did not."""
    Sq, D = q.shape[2], q.shape[3]
    dot_product_attention.calls += 1
    dot_product_attention.calls_by_shape[(q.shape[0], Sq, k.shape[2])] += 1
    if scale is None:
        scale = D ** -0.5
    if mask is None and (key_mask is not None or causal):
        mask = make_attention_mask(key_mask, Sq, causal=causal, kv_len=k.shape[2],
                                   device=q.device)
    # fp32 logits from the inputs' values (bf16 x bf16 products are exact in
    # fp32), as the reference's preferred_element_type=float32 einsum
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias.float()
    if mask is not None:
        logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    if training and dropout_rate > 0.0:
        probs = probs * dropout_multiplier(probs.shape, dropout_rate, generator,
                                           torch.float32, probs.device)
    return torch.matmul(probs.to(q.dtype), v)


dot_product_attention.calls = 0
dot_product_attention.calls_by_shape = collections.Counter()
