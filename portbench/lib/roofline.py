"""Peaks of the chip and each attention kernel's least time (its bound).

The peaks are the NVIDIA H100 SXM data sheet's dense rates at the full
700 W. A kernel's bound is the larger of its operations over the bf16
peak and its bytes over the HBM bandwidth, each input byte read once and
each output byte written once, whatever the kernel reads again. The
operation and byte counts are the port's attention kernels' (K1-K6), from
the shapes of a call alone:

- K1 flash forward: 4 B H Sq Skv D operations; q, k, v, out, bias, lse
  (and the key mask, a byte a key);
- K2 / K3 / K4 flash backward (dQ; dK and dV; dBias): 6 / 8 / 4 B H Sq Skv D
  operations; each reads q, k, v, dout, bias, lse and delta, and writes
  dq / dk and dv / the bias gradient in fp32;
- K5 tiny forward: 4 B H Sq Skv D; q, k, v, out, the fp32 probabilities
  when training keeps them, the dropout multiplier, the key mask;
- K6 tiny backward: 8 B H Sq Skv D; q, k, v, dout, probabilities and
  multiplier read, dq, dk, dv written.
"""

from __future__ import annotations

from typing import Optional, Tuple

__all__ = ["HBM_BYTES_PER_S", "BF16_FLOP_PER_S", "bound_ms", "nbytes", "flash_fwd",
           "flash_bwd", "tiny_fwd", "tiny_bwd"]

HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory (data sheet)
BF16_FLOP_PER_S = 989e12     # H100 SXM dense bf16 tensor-core peak (data sheet)


def bound_ms(nbytes: float, flops: float, peak: float = BF16_FLOP_PER_S
             ) -> Tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    """Bytes of the tensors given (None counts 0); a tensor may be given
    as (shape, element size)."""
    total = 0
    for t in tensors:
        if t is None:
            continue
        if isinstance(t, tuple):
            shape, size = t
            n = 1
            for d in shape:
                n *= d
            total += n * size
        else:
            total += t.numel() * t.element_size()
    return total


def _mask_bytes(key_mask) -> int:
    return 0 if key_mask is None else key_mask.numel()


def flash_fwd(q, k, v, bias=None, key_mask=None) -> Tuple[float, float]:
    """(bytes, operations) of one K1 launch; q (B, H, Sq, D), k / v (B, H, Skv, D)."""
    B, H, Sq, D = q.shape
    Skv = k.shape[2]
    lse = ((B, H, Sq, 1), 4)
    return (nbytes(q, k, v, q, bias, lse) + _mask_bytes(key_mask),
            4.0 * B * H * Sq * Skv * D)


def flash_bwd(q, k, v, bias=None, key_mask=None, dbias: bool = True) -> dict:
    """{kernel: (bytes, operations)} of one backward call: "dq" (K2),
    "dkv" (K3) and, with a bias whose gradient is wanted, "dbias" (K4)."""
    B, H, Sq, D = q.shape
    Skv = k.shape[2]
    lse = ((B, H, Sq, 1), 4)
    read = nbytes(q, k, v, q, bias, lse, lse) + _mask_bytes(key_mask)
    ops = float(B * H * Sq * Skv * D)
    out = {"dq": (read + nbytes(q), 6 * ops), "dkv": (read + nbytes(k, v), 8 * ops)}
    if bias is not None and dbias:
        out["dbias"] = (read + bias.shape[0] * H * Sq * Skv * 4, 4 * ops)
    return out


def tiny_fwd(q, k, v, num_heads: int, key_mask=None, dmask=None,
             return_probs: bool = False) -> Tuple[float, float]:
    """(bytes, operations) of one K5 launch; q (B, Sq, H*D), k / v (B, Skv, H*D)."""
    B, Sq, HD = q.shape
    Skv = k.shape[1]
    probs = ((B, Sq, HD // (HD // num_heads) * Skv), 4) if return_probs else None
    return (nbytes(q, k, v, q, probs, dmask) + _mask_bytes(key_mask),
            4.0 * B * num_heads * Sq * Skv * (HD // num_heads))


def tiny_bwd(q, k, v, num_heads: int, dmask=None,
             probs: Optional[object] = None) -> Tuple[float, float]:
    """(bytes, operations) of one K6 launch."""
    B, Sq, HD = q.shape
    Skv = k.shape[1]
    if probs is None:
        probs = ((B, Sq, num_heads * Skv), 4)
    return (nbytes(q, k, v, q, probs, dmask) + nbytes(q, k, v),
            8.0 * B * num_heads * Sq * Skv * (HD // num_heads))
