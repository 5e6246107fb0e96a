"""Dynamic W8A8 int8 matmul — the projections and FFN matmuls of the int8
serving path — as two kernels: a per-token int8 quantization of the
activations, and the int8 product with its dequantize / bias / GELU
epilogue.

Counterpart of x2vlm_tpu/ops/int8_matmul.py (and of ``quantize_act`` in
x2vlm_tpu/ops/quant.py). The functions:

- :func:`quantize_act` is the quantize kernel's wrapper: for CUDA tensors
  it launches ``quantize_rows_kernel`` of ``csrc/int8_matmul.cu`` or
  raises; for CPU tensors it runs :func:`quantize_act_reference`. Returns
  ``(xq int8 (..., K), sx fp32 (..., 1))``.
- :func:`int8_matmul` is the GEMM kernel's wrapper: ``(..., K) -> (..., N)``
  against an int8 ``wq`` (N, K) (the nn.Linear layout) with per-row scales
  ``sw`` (N,). Given ``xq`` and ``sx`` it takes them as they are (q/k/v
  share one quantization of their input); else it quantizes ``x`` first
  through :func:`quantize_act`. For CPU tensors it runs
  :func:`int8_matmul_reference`, the counterpart of ``int8_matmul_xla``.
- Each wrapper's ``.launches`` counts its kernel launches and
  ``.launches_by_shape`` splits them by (M, K) / (M, K, N).
- :data:`GEMM_PLAN` and :func:`gemm_smem_bytes` mirror the GEMM's tile
  plan and shared memory, fixed in the source (``x2_int8_matmul_plan``,
  ``x2_int8_matmul_smem_bytes``): a block of 384 threads, one TMA producer
  warp and two ``wgmma`` consumer warpgroups that take 128 x 128 output
  tiles in turns, a persistent grid of one block an SM.

The TPU kernel fuses both steps: it quantizes a row block on the first N
tile of its sequential grid and keeps the int8 rows in VMEM across the N
sweep. CUDA blocks share no scratch, so the port runs the quantization once
as its own kernel; the two together are that kernel's port. There is no
autograd Function: the path only serves (``round`` has no gradient).
"""

from __future__ import annotations

import collections
import ctypes
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from x2vlm_tpu_torch.ops import _build

__all__ = ["ACTS", "GEMM_DESIGN", "GEMM_PLAN", "SMEM_LIMIT", "gemm_smem_bytes", "int8_matmul",
           "int8_matmul_reference", "int8_scale", "quantize_act", "quantize_act_reference",
           "typed_lib"]

ACTS = {None: 0, "gelu": 1, "gelu_fast": 2}   # codes of csrc/int8_matmul.cu `Act`
_DTYPES = _build.DTYPE_CODES

# The GEMM kernel's design and plan (csrc/int8_matmul.cu BM, BN, BK,
# kStages, kEpiBytes; x2_int8_matmul_plan gives them in this order).
GEMM_DESIGN = "wgmma_tma"
GEMM_PLAN = {"block_m": 128, "block_n": 128, "block_k": 128, "stages": 5, "epi_bytes": 128}
SMEM_LIMIT = 232448       # shared memory one block may use on an H100


def gemm_smem_bytes(plan: dict = GEMM_PLAN) -> int:
    """The GEMM's dynamic shared memory a block (``kGemmSmem``): 1024 bytes
    of slack to align the ring for the 128-byte swizzle, ``stages`` stages
    of (block_m + block_n) x block_k int8, then for each of the two
    consumer warpgroups the output staging of a tile's block_m rows
    (``epi_bytes`` + 16 bytes a row) and their fp32 scales with the tile's
    block_n scales and biases, two 8-byte mbarriers a stage and the
    consumers' two turn mbarriers. It depends on no shape: every launch
    takes the same block."""
    ring = plan["stages"] * (plan["block_m"] + plan["block_n"]) * plan["block_k"]
    return (1024 + ring + 2 * plan["block_m"] * (plan["epi_bytes"] + 16)
            + 2 * (plan["block_m"] + 2 * plan["block_n"]) * 4 + (2 * plan["stages"] + 2) * 8)


# the C entry points' signatures, set once per loaded library by typed_lib
_SIGNATURES = {
    "x2_int8_quantize": ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
                         ctypes.c_int),
    "x2_int8_matmul": ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
                       ctypes.c_int),
    "x2_int8_matmul_smem_bytes": ([], ctypes.c_longlong),
    "x2_int8_matmul_plan": ([ctypes.c_int], ctypes.c_int),
}


def typed_lib(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` with the argument and result types of the int8 C functions
    it exports set, once per library object (``_build.typed``)."""
    return _build.typed(lib, _SIGNATURES)


def int8_scale(amax: torch.Tensor) -> torch.Tensor:
    """max(amax, 1e-6) / 127 as an IEEE division on every device. (PyTorch's
    CUDA kernels multiply by the reciprocal of a Python-number divisor,
    which rounds differently; the JAX package and the kernel divide.)"""
    return amax.clamp_min(1e-6) / torch.tensor(127.0, device=amax.device)


def quantize_act_reference(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token symmetric int8 quantization: (x_int8, scale fp32 (..., 1))."""
    xf = x.float()
    sx = int8_scale(xf.abs().amax(dim=-1, keepdim=True))
    return torch.round(xf / sx).to(torch.int8), sx


def _gelu_fast(x: torch.Tensor) -> torch.Tensor:
    # the constants and the order of int8_matmul.py `_gelu_fast`
    return 0.5 * x * (1.0 + torch.tanh(0.7978845608028654 *
                                       (x + 0.044715 * x * x * x)))


def _apply_act(act: Optional[str], x: torch.Tensor) -> torch.Tensor:
    if act == "gelu_fast":
        return _gelu_fast(x)
    if act == "gelu":
        return F.gelu(x)      # erf; the JAX tanh-polynomial form is within 4.8e-7
    return x


def int8_matmul_reference(
    x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
    bias: Optional[torch.Tensor] = None, *, act: Optional[str] = None,
    out_dtype: torch.dtype = torch.bfloat16,
    xq: Optional[torch.Tensor] = None, sx: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch int8 matmul. The int8 products are summed in float64,
    which is exact here (|sum| <= 127^2 K < 2^53) and runs on both devices
    (CUDA has no int8 matmul in PyTorch outside ``torch._int_mm``)."""
    if xq is None:
        xq, sx = quantize_act_reference(x)
    K = xq.shape[-1]
    acc = torch.matmul(xq.reshape(-1, K).double(), wq.double().t()).to(torch.int32)
    out = acc.float() * sx.reshape(-1, 1).float() * sw.reshape(1, -1).float()
    if bias is not None:
        out = out + bias.float()
    return _apply_act(act, out).to(out_dtype).reshape(*xq.shape[:-1], -1)


def _check_cuda(name: str, *tensors) -> None:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    for t in tensors:
        if t is not None and t.device != dev:
            raise ValueError(f"{name}: operands on different devices")


def quantize_act(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token int8 quantization; returns (xq int8 (..., K), sx fp32
    (..., 1)). See module doc."""
    if x.device.type == "cpu":
        return quantize_act_reference(x)
    _check_cuda("quantize_act", x)
    if x.dtype not in _DTYPES:
        raise TypeError(f"quantize_act takes f32 or bf16, got {x.dtype}")
    K = x.shape[-1]
    M = math.prod(x.shape[:-1])
    if M == 0 or K == 0:
        raise ValueError(f"quantize_act: empty input {tuple(x.shape)}")
    lib = typed_lib(_build.load("int8_matmul"))
    x2 = x.reshape(M, K).contiguous()
    xq = torch.empty((M, K), dtype=torch.int8, device=x.device)
    sx = torch.empty((M,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.x2_int8_quantize(x2.data_ptr(), xq.data_ptr(), sx.data_ptr(), M, K,
                                   _DTYPES[x.dtype], stream)
    _build.check(lib, err, "int8 quantize")
    quantize_act.launches += 1
    quantize_act.launches_by_shape[(M, K)] += 1
    return xq.reshape(*x.shape[:-1], K), sx.reshape(*x.shape[:-1], 1)


quantize_act.launches = 0
quantize_act.launches_by_shape = collections.Counter()


def int8_matmul(
    x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
    bias: Optional[torch.Tensor] = None, *, act: Optional[str] = None,
    out_dtype: torch.dtype = torch.bfloat16,
    xq: Optional[torch.Tensor] = None, sx: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``x (..., K)`` times int8 ``wq (N, K)`` with dynamic per-token
    quantization and the dequantize / fp32 bias / ``act`` epilogue; returns
    (..., N) in ``out_dtype``. ``act`` is None, "gelu" (erf) or
    "gelu_fast" (tanh). See module doc."""
    if act not in ACTS:
        raise ValueError(f"int8_matmul: act {act!r} is not one of {list(ACTS)}")
    if x.device.type == "cpu":
        return int8_matmul_reference(x, wq, sw, bias, act=act, out_dtype=out_dtype,
                                     xq=xq, sx=sx)
    if out_dtype not in _DTYPES:
        raise TypeError(f"int8_matmul: out_dtype {out_dtype} is not f32 or bf16")
    if wq.dim() != 2 or wq.dtype != torch.int8:
        raise TypeError(f"int8_matmul: wq must be (N, K) int8, got "
                        f"{tuple(wq.shape)} {wq.dtype}")
    N, K = wq.shape
    if x.shape[-1] != K or K % 16:
        raise ValueError(f"int8_matmul: x {tuple(x.shape)} against wq {tuple(wq.shape)}: "
                         f"K must match and be a multiple of 16")
    if sw.numel() != N or (bias is not None and bias.numel() != N):
        raise ValueError(f"int8_matmul: sw / bias must hold {N} values")
    if (xq is None) != (sx is None):
        raise ValueError("int8_matmul: give both xq and sx, or neither")
    if xq is None:
        xq, sx = quantize_act(x)
    elif xq.dtype != torch.int8 or xq.shape != x.shape:
        raise ValueError(f"int8_matmul: xq {tuple(xq.shape)} {xq.dtype} does not "
                         f"quantize x {tuple(x.shape)}")
    _check_cuda("int8_matmul", x, xq, sx, wq, sw, bias)
    lead = xq.shape[:-1]
    M = math.prod(lead)
    if M == 0 or sx.numel() != M:
        raise ValueError(f"int8_matmul: {M} rows, sx holds {sx.numel()}")
    lib = typed_lib(_build.load("int8_matmul"))
    xq2 = _build.aligned(xq.reshape(M, K))
    wq = _build.aligned(wq)
    sx = sx.reshape(M).float().contiguous()
    sw = sw.reshape(N).float().contiguous()
    if bias is not None:
        bias = bias.reshape(N).float().contiguous()
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.x2_int8_matmul(xq2.data_ptr(), sx.data_ptr(), wq.data_ptr(), sw.data_ptr(),
                                 None if bias is None else bias.data_ptr(), out.data_ptr(),
                                 M, N, K, ACTS[act], _DTYPES[out_dtype], stream)
    _build.check(lib, err, "int8_matmul")
    int8_matmul.launches += 1
    int8_matmul.launches_by_shape[(M, K, N)] += 1
    return out.reshape(*lead, N)


int8_matmul.launches = 0
int8_matmul.launches_by_shape = collections.Counter()
