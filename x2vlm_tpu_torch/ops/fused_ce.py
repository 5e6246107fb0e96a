"""Fused vocabulary cross-entropy (counterpart of x2vlm_tpu/ops/fused_ce.py):
the tied-decoder matmul and the softmax cross-entropy in one autograd
Function that never holds the (N, vocab) fp32 logits at once.

The vocab axis is processed in chunks of 7680: the forward streams a running
(max, sumexp, label logit, logit sum) across chunks; the backward recomputes
each chunk's logits from the saved activations and emits that chunk's
gradients immediately. The chunk matmuls are ``torch.matmul`` (the JAX
package leaves them to XLA; there is no Pallas kernel here).

Smoothing keeps the JAX package's form (its README deviation 6): the mass s
is spread uniformly over all V classes, loss += s * (lse - mean logit),
not the reference's s/(V-2).
"""

from __future__ import annotations

from typing import List, Tuple

import torch

__all__ = ["fused_vocab_ce_weighted", "fused_vocab_ce", "softmax_ce", "CHUNK"]

CHUNK = 7680  # vocab chunk width (the JAX package's _CHUNK)


def softmax_ce(logits: torch.Tensor, labels: torch.Tensor,
               ignore_index: int = -100) -> torch.Tensor:
    """Plain fp32 mean CE over non-ignored labels (HF CrossEntropyLoss
    semantics). Materializes the logits: use :func:`fused_vocab_ce` for a
    vocab-sized last axis."""
    logits = logits.float()
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return nll.sum() / valid.sum().clamp(min=1)


def _chunks(v: int) -> List[Tuple[int, int]]:
    return [(s, min(s + CHUNK, v)) for s in range(0, v, CHUNK)]


def _chunk_logits(h: torch.Tensor, table_c: torch.Tensor,
                  bias_c: torch.Tensor) -> torch.Tensor:
    """(N, D) x (Vc, D) -> (N, Vc) fp32 logits of one chunk: the product in
    h's dtype (fp32 accumulation), the bias added in fp32."""
    return torch.matmul(h, table_c.to(h.dtype).t()).float() + bias_c.float()


class _FusedVocabCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, table, bias, labels, weights, smoothing):
        n = h.shape[0]
        v = table.shape[0]
        safe = labels.long().clamp(0, v - 1)
        weights = weights.float()
        m = torch.full((n,), float("-inf"), device=h.device)
        s = torch.zeros(n, device=h.device)
        lbl = torch.zeros(n, device=h.device)
        logit_sum = torch.zeros(n, device=h.device)
        for lo, hi in _chunks(v):
            logits = _chunk_logits(h, table[lo:hi], bias[lo:hi])
            nm = torch.maximum(m, logits.max(dim=-1).values)
            s = s * torch.exp(m - nm) + torch.exp(logits - nm[:, None]).sum(-1)
            m = nm
            in_chunk = (safe >= lo) & (safe < hi)
            idx = (safe - lo).clamp(0, hi - lo - 1)
            got = torch.gather(logits, 1, idx[:, None])[:, 0]
            lbl = torch.where(in_chunk, got, lbl)
            if smoothing:
                logit_sum = logit_sum + logits.sum(-1)
        lse = m + torch.log(s)
        rows = (1.0 - smoothing) * (lse - lbl)
        if smoothing:
            rows = rows + smoothing * (lse - logit_sum / v)
        ctx.save_for_backward(h, table, bias, safe, weights, lse)
        ctx.smoothing = smoothing
        return (weights * rows).sum()

    @staticmethod
    def backward(ctx, g):
        h, table, bias, safe, weights, lse = ctx.saved_tensors
        smoothing = ctx.smoothing
        v = table.shape[0]
        # d loss / d logits[i, c] = (softmax - (1-s) onehot - s/V) * w[i]
        w = g * weights
        dh = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
        dtable, dbias = [], []
        for lo, hi in _chunks(v):
            table_c = table[lo:hi]
            logits = _chunk_logits(h, table_c, bias[lo:hi])
            dl = torch.exp(logits - lse[:, None])
            in_chunk = (safe >= lo) & (safe < hi)
            idx = (safe - lo).clamp(0, hi - lo - 1)
            onehot = torch.zeros_like(dl).scatter_(1, idx[:, None],
                                                   in_chunk[:, None].float())
            dl = dl - (1.0 - smoothing) * onehot
            if smoothing:
                dl = dl - smoothing / v
            dl = dl * w[:, None]
            dl_c = dl.to(h.dtype)
            dh += torch.matmul(dl_c, table_c.to(h.dtype)).float()
            dtable.append(torch.matmul(dl_c.t(), h).float())
            dbias.append(dl.sum(0))
        return (dh.to(h.dtype), torch.cat(dtable).to(table.dtype),
                torch.cat(dbias).to(bias.dtype), None, None, None)


def fused_vocab_ce_weighted(h: torch.Tensor, table: torch.Tensor, bias: torch.Tensor,
                            labels: torch.Tensor, weights: torch.Tensor,
                            smoothing: float = 0.0) -> torch.Tensor:
    """``sum_i weights[i] * loss_i`` over the rows of softmax(h @ table.T +
    bias), with loss_i = (1-s)(lse_i - logit_label_i) + s(lse_i -
    mean_logit_i). h (N, D) in the compute dtype; table (V, D) the tied
    embedding (fp32 parameter); bias (V,); labels (N,), clamped into range
    (rows to drop carry weight 0); weights (N,) fp32, no gradient. Returns
    an fp32 scalar."""
    return _FusedVocabCE.apply(h, table, bias, labels, weights, float(smoothing))


def fused_vocab_ce(h: torch.Tensor, table: torch.Tensor, bias: torch.Tensor,
                   labels: torch.Tensor, valid: torch.Tensor,
                   ignore_index: int = -100, smoothing: float = 0.0) -> torch.Tensor:
    """Mean CE over the valid rows (``valid`` AND ``labels != ignore_index``),
    HF CrossEntropyLoss semantics: sum(nll * valid) / max(count, 1); with
    ``smoothing`` the label-smoothed CE, same mean."""
    valid = valid & (labels != ignore_index)
    count = valid.sum().clamp(min=1).float()
    return fused_vocab_ce_weighted(h, table, bias, labels, valid.float() / count, smoothing)
