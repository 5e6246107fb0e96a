"""Flash attention forward over (B, H, S, D) tensors — the BEiT-2 vision
self-attention with its trained relative-position bias.

Counterpart of x2vlm_tpu/ops/flash_attention.py. Three functions:

- :func:`flash_attention_fwd` is the kernel's wrapper: for CUDA tensors it
  launches the hand-written Hopper kernel (``csrc/flash_attention_fwd.cu``)
  or raises; for CPU tensors it runs :func:`flash_attention_reference`.
  It returns ``(out, lse)``; ``lse`` (B, H, Sq, 1) fp32 is what the backward
  of the training slice will read. ``flash_attention_fwd.launches`` counts
  kernel launches.
- :func:`flash_attention_reference` is the plain PyTorch version of the same
  function (counterpart of ``_xla_attention``).
- :func:`flash_attention` is the public entry (same signature as the JAX
  one), returning ``out``.

The kernel has no backward yet: on CUDA, inputs that require grad raise.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from x2vlm_tpu_torch.ops import _build
from x2vlm_tpu_torch.ops.attention import NEG_INF, make_attention_mask

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_reference",
           "flash_supported"]

_DTYPES = _build.DTYPE_CODES
_HEAD_DIMS = (64, 128, 192, 256)


def flash_supported(q: torch.Tensor, k: torch.Tensor) -> bool:
    """The dispatch rule of the JAX package: flash for image-stream-length
    sequences (Sq and Skv >= 128) at head dims the kernel takes."""
    B, H, Sq, D = q.shape
    return (D in _HEAD_DIMS and q.dtype in _DTYPES
            and Sq >= 128 and k.shape[2] >= 128)


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    key_mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    scale: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch flash forward: fp32 logits and softmax, probabilities
    cast to q's dtype before P @ V. Returns (out, lse)."""
    Sq, Skv = q.shape[2], k.shape[2]
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias.float()
    if key_mask is not None or causal:
        mask = make_attention_mask(key_mask, Sq, causal=causal, kv_len=Skv,
                                   device=q.device)
        logits = logits.masked_fill(~mask, NEG_INF)
    lse = torch.logsumexp(logits, dim=-1, keepdim=True)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(probs, v), lse


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    key_mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    scale: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention forward; returns (out (B, H, Sq, D), lse (B, H, Sq, 1)).

    q (B, H, Sq, D); k, v (B, H, Skv, D); bias broadcastable to
    (B, H, Sq, Skv) with batch/head dims of size 1 or full; key_mask (B, Skv),
    nonzero = attend. ``scale`` multiplies the fp32 logits."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, bias, key_mask, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd: unsupported device {q.device}")
    _build.check_no_grad(q, k, v, bias)
    B, H, Sq, D = q.shape
    Skv = k.shape[2]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_fwd takes f32 or bf16 q/k/v of one "
                        f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd: head dim {D} not in {_HEAD_DIMS}")
    if k.shape != (B, H, Skv, D) or v.shape != k.shape:
        raise ValueError(f"flash_attention_fwd: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)} do not match")
    for t in (k, v, bias, key_mask):
        if t is not None and t.device != q.device:
            raise ValueError("flash_attention_fwd: operands on different devices")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()

    bias_ptr, bias_kind, strides = None, 0, (0, 0, 0)
    if bias is not None:
        if bias.dim() != 4 or bias.shape[0] not in (1, B) or \
                bias.shape[1] not in (1, H) or tuple(bias.shape[2:]) != (Sq, Skv):
            raise ValueError(f"flash_attention_fwd: bias {tuple(bias.shape)} does "
                             f"not broadcast as (1|{B}, 1|{H}, {Sq}, {Skv})")
        if bias.dtype not in _build.OPERAND_KINDS:
            raise TypeError(f"flash_attention_fwd: bias dtype {bias.dtype}")
        if bias.stride(3) != 1:
            bias = bias.contiguous()
        bias_ptr, bias_kind = bias.data_ptr(), _build.OPERAND_KINDS[bias.dtype]
        strides = (0 if bias.shape[0] == 1 else bias.stride(0),
                   0 if bias.shape[1] == 1 else bias.stride(1), bias.stride(2))
    km_ptr = None
    if key_mask is not None:
        if tuple(key_mask.shape) != (B, Skv):
            raise ValueError(f"flash_attention_fwd: key_mask {tuple(key_mask.shape)} "
                             f"is not ({B}, {Skv})")
        key_mask = (key_mask != 0).to(torch.uint8).contiguous()
        km_ptr = key_mask.data_ptr()

    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq, 1), dtype=torch.float32, device=q.device)
    lib = _build.load("flash_attention_fwd")
    fn = lib.x2_flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_longlong] * 3 + \
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr, bias_kind,
                 *strides, km_ptr, out.data_ptr(), lse.data_ptr(),
                 B, H, Sq, Skv, D, _DTYPES[q.dtype], int(causal), float(scale),
                 stream)
    _build.check(lib, err, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    bias: Optional[torch.Tensor] = None,
    key_mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Flash attention over (B, H, S, D) tensors; ``scale`` defaults to D^-0.5."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return flash_attention_fwd(q, k, v, bias, key_mask, causal, scale)[0]
