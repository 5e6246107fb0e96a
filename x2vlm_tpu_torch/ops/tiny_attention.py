"""Short-query multi-head attention on the projection layout — text
self-attention (Sq = Skv ~ 40) and the fusion layers' cross-attention to the
image stream (Sq ~ 40, Skv ~ 200) — forward and backward.

Counterpart of x2vlm_tpu/ops/tiny_attention.py. The functions:

- :func:`tiny_attention_fwd` is the forward kernel's wrapper: for CUDA
  tensors it launches the hand-written Hopper kernel
  (``csrc/tiny_attention_fwd.cu``) or raises; for CPU tensors it runs
  :func:`tiny_attention_reference`. It returns ``(out, probs)``: the fp32
  pre-dropout probabilities (B, Sq, H*Skv) when ``return_probs`` (the
  backward reads them), else None.
- :func:`tiny_attention_bwd` is the backward kernel's wrapper
  (``csrc/tiny_attention_bwd.cu``); for CPU tensors it runs
  :func:`tiny_attention_bwd_reference`. It also takes the forward's
  ``out``, from which the key-tiled tensor-core kernel takes its softmax
  row sums, rowsum(g * out).
- Each wrapper's ``.launches`` counts its kernel launches,
  ``.launches_by_shape`` splits them by (B, Sq, Skv), ``.launches_by_heads``
  by H and ``.launches_by_route`` by route.
- :func:`tiny_attention_reference` / :func:`tiny_attention_bwd_reference`
  are the plain PyTorch versions (counterparts of ``_xla_reference`` and of
  the math of ``_bwd_kernel``).
- :func:`tiny_block_attention` is the public entry (the JAX name), which
  draws the dropout multiplier from an explicit generator when training.
  When a gradient is needed it goes through an autograd Function that runs
  the forward with ``return_probs=True`` and saves (q, k, v, probs, dmask),
  as the JAX ``_tiny_vjp_fwd`` does, and the output; otherwise it calls the
  forward alone.

Each CUDA source holds two hand-written kernels, and :func:`tiny_route`
picks one by dtype and head dim (the C side keeps the same rule):
``"tensor_core"`` for bf16 with D % 16 == 0 and D <= 128 (the main path:
mma.sync on bf16 tiles staged by cp.async) and ``"cuda_core"`` for fp32 at
any D and bf16 at other D (fp32 arithmetic, which keeps fp32 inputs at fp32
accuracy). The choice is a dispatch between two kernels, not a fallback: a
failed build or launch raises on either route.

Each route walks the keys one of two ways, by :func:`tiny_walk` (the C side
keeps the same rule): ``"resident"``, a block holding its head's whole K
and V (and in the backward the whole probability block) in shared memory,
wherever the CUDA-core resident kernels of both directions fit (up to 257
keys at Sq = 40, D = 64); else ``"tiled"``, the block walking the keys in
tiles with shared memory that does not grow with Skv (Sq <= 64, D <= 128;
the fusion cross-attention at 384 px, 40 x 584). :func:`tiny_supported`,
the layers' dispatch rule, admits every short-query shape one of the walks
takes.

I/O is the projection layout: q (B, Sq, H*D), k/v (B, Skv, H*D), out
(B, Sq, H*D). q is multiplied by ``scale`` in q's dtype, as the reference's
``qw * scale`` does; the backward returns the gradient of the unscaled q.
Sequence lengths need no padding.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Optional, Tuple

import torch

from x2vlm_tpu_torch.ops import _build
from x2vlm_tpu_torch.ops.attention import NEG_INF, dropout_multiplier, wide

__all__ = ["CUDA_CORE", "RESIDENT", "ROUTE_CODES", "TENSOR_CORE", "TILED", "WALK_CODES",
           "tiny_attention_bwd", "tiny_attention_bwd_reference", "tiny_attention_fwd",
           "tiny_attention_reference", "tiny_block_attention", "tiny_route", "tiny_supported",
           "tiny_walk", "smem_bytes", "bwd_smem_bytes", "tiled_smem_bytes",
           "tiled_bwd_smem_bytes", "typed_lib"]

MAX_QUERY_LEN = 64  # the dispatch rule's short-query bound
_DTYPES = _build.DTYPE_CODES
_SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper
_MAX_HEAD_DIM = 256   # the backward kernel's per-lane accumulators
_WARPS = 8            # warps per block in csrc/tiny_attention_fwd.cu (CUDA-core route)
_BWD_WARPS = 16       # and in csrc/tiny_attention_bwd.cu
_TILED_MAX_SQ, _TILED_MAX_D = 64, 128   # x2::kTinyTiledMaxSq / kTinyTiledMaxD
_TC_KEY_TILE = 64     # keys a tiled tensor-core block stages at a time (tc::kKeyTile)
_TC_FWD_STAGES = 3    # key tiles in the tiled tensor-core forward's ring (tc::kStages)
_TC_BWD_STAGES = 2    # and in the backward's (tc::kBwdStages)
_TC_FWD_WARPS = 4     # warps of a tiled tensor-core forward block, one a row tile (tc::kWarps)
_TC_SCRATCH_LW = 20   # row stride (words) of a forward warp's 16 x 16 P block (tc::kScratchLW)
_TC_PLANE_LD = _TC_KEY_TILE + 8   # row stride (elements) of the backward's dL / Pu planes
_CC_KEY_TILE = 32     # and a tiled CUDA-core block, one a lane (kTileKeys)
CUDA_CORE, TENSOR_CORE = _build.CUDA_CORE, _build.TENSOR_CORE
ROUTE_CODES = _build.ROUTE_CODES   # x2::TinyRoute in csrc/common.cuh
RESIDENT, TILED = "resident", "tiled"
WALK_CODES = {RESIDENT: 0, TILED: 1}   # x2::TinyWalk in csrc/common.cuh


def tiny_route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel a launch takes: the tensor cores for bf16 with a head dim
    that is a multiple of 16 up to 128, the CUDA cores otherwise. The same
    rule as ``x2::tiny_route`` in csrc/common.cuh (chip_smoke.py holds the
    two equal)."""
    if dtype == torch.bfloat16 and head_dim % 16 == 0 and 0 < head_dim <= 128:
        return TENSOR_CORE
    return CUDA_CORE


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def _tile_ld(head_dim: int) -> int:
    """Row stride (elements) of a tensor-core route's bf16 shared tile:
    D when D % 64 == 0 (16-byte chunks XOR-swizzled by row), else D + 8
    (``x2::tile_ld`` in csrc/common.cuh)."""
    return head_dim if head_dim % 64 == 0 else head_dim + 8


def smem_bytes(Skv: int, head_dim: int, route: str = CUDA_CORE) -> int:
    """Shared memory one forward block takes. CUDA cores: one head's K (row
    stride D+1) and V in fp32, one probability row and one query row per
    warp. Tensor cores: K and V in bf16 (Skv padded to 16 rows) and an fp32
    logit bias per key. The formulas of ``smem_bytes`` / ``tc::smem_bytes``
    in csrc/tiny_attention_fwd.cu (chip_smoke.py holds them equal)."""
    if route == TENSOR_CORE:
        return 2 * 2 * _round16(Skv) * _tile_ld(head_dim) + 4 * _round16(Skv)
    return 4 * (Skv * (head_dim + 1) + Skv * head_dim + _WARPS * Skv
                + _WARPS * head_dim)


def bwd_smem_bytes(Sq: int, Skv: int, head_dim: int, route: str = CUDA_CORE) -> int:
    """Shared memory one backward block takes. CUDA cores: one head's K and
    V (row stride D+1) in fp32, reused for g and the scaled q; the (Sq, Skv)
    fp32 dL and P * dm; four g rows per warp. Tensor cores: K, V, g and the
    scaled q in bf16 (rows padded to 16), and one 32-bit word per (query
    row, key) that holds P and then the bf16 dL and P * dm (rows of the
    padded Skv + 4 words). The formulas of
    ``smem_bytes`` / ``tc::smem_bytes`` in csrc/tiny_attention_bwd.cu
    (chip_smoke.py holds them equal)."""
    if route == TENSOR_CORE:
        sq, skv = _round16(Sq), _round16(Skv)
        return 2 * (2 * skv + 2 * sq) * _tile_ld(head_dim) + 4 * sq * (skv + 4)
    kv = 2 * Skv * (head_dim + 1)
    gq = 2 * Sq * head_dim
    return 4 * (max(kv, gq) + 2 * Sq * Skv + _BWD_WARPS * 4 * head_dim)


def _key_rows_words(elem_bytes: int) -> int:
    """Row stride (words) of a 64-key ``x2::KeyRows`` block: 64 keys plus
    the 16-byte chunk a row's shift may reach into."""
    return 4 * (64 // (16 // elem_bytes) + 1)


def tiled_smem_bytes(Sq: int, head_dim: int, route: str = CUDA_CORE) -> int:
    """Shared memory one forward block of the key-tiled walk takes, whatever
    Skv. CUDA cores: a K tile (row stride D+1) and a V tile of 32 keys in
    fp32, the block's scaled query rows and output sums, one probability
    row of the tile per warp. Tensor cores, the most a block takes (the
    two walks with an fp32 multiplier): a ring of 3 stages, each a K and a
    V tile of 64 keys in bf16, the tile's key-mask bytes and the
    multiplier's rows; each warp's 16 x 16 fp32 probability block.
    ``tiled_smem_bytes`` / ``tc::tiled_smem_bytes`` in
    csrc/tiny_attention_fwd.cu (chip_smoke.py holds them equal)."""
    if route == TENSOR_CORE:
        stage = (2 * 2 * _TC_KEY_TILE * _tile_ld(head_dim) + 4 * _key_rows_words(1)
                 + 4 * _round16(Sq) * _key_rows_words(4))
        return _TC_FWD_STAGES * stage + 4 * _TC_FWD_WARPS * 16 * _TC_SCRATCH_LW
    return 4 * (_CC_KEY_TILE * (2 * head_dim + 1) + 2 * Sq * head_dim
                + _WARPS * _CC_KEY_TILE)


def tiled_bwd_smem_bytes(Sq: int, head_dim: int, route: str = CUDA_CORE) -> int:
    """Shared memory one backward block of the key-tiled walk takes,
    whatever Skv. CUDA cores: K and V tiles of 32 keys (row stride D+1), g,
    the scaled q and the dQ sums, and the tile's dL and P * dm columns, all
    fp32. Tensor cores, the most a block takes (an fp32 multiplier): a ring
    of 2 stages, each a K and a V tile of 64 keys in bf16 and the tile's
    multiplier rows; g and the scaled q in bf16 (rows padded to 16); the
    bf16 dL and P * dm planes (rows of 72 elements); one row sum a query
    row. ``tiled_smem_bytes`` / ``tc::tiled_smem_bytes`` in
    csrc/tiny_attention_bwd.cu (chip_smoke.py holds them equal)."""
    if route == TENSOR_CORE:
        sq, ld = _round16(Sq), _tile_ld(head_dim)
        stage = 2 * 2 * _TC_KEY_TILE * ld + 4 * sq * _key_rows_words(4)
        return (_TC_BWD_STAGES * stage + 2 * 2 * sq * (ld + _TC_PLANE_LD)
                + 4 * _TILED_MAX_SQ)
    return 4 * (2 * _CC_KEY_TILE * (head_dim + 1) + 3 * Sq * head_dim
                + 2 * Sq * _CC_KEY_TILE)


def tiny_walk(Sq: int, Skv: int, head_dim: int) -> str:
    """How both kernels walk the keys at (Sq, Skv, D): ``"resident"`` where
    the CUDA-core resident kernels of the forward and the backward fit one
    block's shared memory (which bounds the tensor-core ones), else
    ``"tiled"``. The same rule as ``x2::tiny_walk`` in csrc/common.cuh
    (chip_smoke.py holds the two equal)."""
    if (head_dim <= _MAX_HEAD_DIM and smem_bytes(Skv, head_dim) <= _SMEM_LIMIT
            and bwd_smem_bytes(Sq, Skv, head_dim) <= _SMEM_LIMIT):
        return RESIDENT
    return TILED


def _walk_ok(Sq: int, Skv: int, head_dim: int) -> bool:
    return (tiny_walk(Sq, Skv, head_dim) == RESIDENT
            or (Sq <= _TILED_MAX_SQ and head_dim <= _TILED_MAX_D))


def tiny_supported(Sq: int, Skv: int, head_dim: int) -> bool:
    """Dispatch rule: short queries (Sq <= 64, the JAX rule's bound) that one
    of the walks takes: any Skv at D <= 128 (tiled past the resident
    shapes), and the resident shapes up to D = 256. Every shape the JAX
    ``tiny_supported`` admits is admitted; the JAX rule's VMEM budget and
    its H*D >= 256 gate are Mosaic limits the port does not have."""
    return Sq <= MAX_QUERY_LEN and _walk_ok(Sq, Skv, head_dim)


def _check_cuda(name: str, q: torch.Tensor) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")


@functools.lru_cache(maxsize=256)
def _dtype_scale(scale: float, dtype: torch.dtype) -> float:
    """``scale`` rounded to ``dtype`` (the reference casts it before the
    multiply); cached, so a launch builds no tensor for it."""
    return float(torch.tensor(scale, dtype=dtype))


# the C entry points' signatures, set once per loaded library by typed_lib
_SIGNATURES = {
    "x2_tiny_attention_fwd": ([ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_void_p] * 2
                              + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p],
                              ctypes.c_int),
    "x2_tiny_attention_bwd": ([ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_void_p] * 5
                              + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p],
                              ctypes.c_int),
    "x2_tiny_attention_smem_bytes": ([ctypes.c_int] * 3, ctypes.c_longlong),
    "x2_tiny_attention_bwd_smem_bytes": ([ctypes.c_int] * 4, ctypes.c_longlong),
    "x2_tiny_attention_route": ([ctypes.c_int] * 2, ctypes.c_int),
    "x2_tiny_attention_walk": ([ctypes.c_int] * 3, ctypes.c_int),
    "x2_tiny_attention_tiled_smem_bytes": ([ctypes.c_int] * 3, ctypes.c_longlong),
    "x2_tiny_attention_bwd_tiled_smem_bytes": ([ctypes.c_int] * 3, ctypes.c_longlong),
}


def typed_lib(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` with the argument and result types of the tiny attention C
    functions it exports set, once per library object (``_build.typed``)."""
    return _build.typed(lib, _SIGNATURES)


def tiny_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
    key_mask: Optional[torch.Tensor] = None,
    dmask: Optional[torch.Tensor] = None,
    scale: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch tiny attention; returns (out, probs f32 pre-dropout)."""
    B, Sq, HD = q.shape
    Skv = k.shape[1]
    H = num_heads
    D = HD // H
    qs = q * _dtype_scale(scale, q.dtype)
    q4 = qs.view(B, Sq, H, D).transpose(1, 2)
    k4 = k.view(B, Skv, H, D).transpose(1, 2)
    v4 = v.view(B, Skv, H, D).transpose(1, 2)
    logits = torch.matmul(wide(q4), wide(k4).transpose(-1, -2))
    if key_mask is not None:
        krow = torch.where(key_mask != 0, 0.0, NEG_INF).to(logits.dtype)
        logits = logits + krow[:, None, None, :]
    p = torch.softmax(logits, dim=-1)                     # (B, H, Sq, Skv)
    probs = p.transpose(1, 2).reshape(B, Sq, H * Skv)
    if dmask is not None:
        p = p * wide(dmask.view(B, Sq, H, Skv).transpose(1, 2))
    out = torch.matmul(p.to(v.dtype), v4)                 # (B, H, Sq, D)
    return out.transpose(1, 2).reshape(B, Sq, HD), probs


def tiny_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
    key_mask: Optional[torch.Tensor] = None,
    dmask: Optional[torch.Tensor] = None,
    scale: float = 1.0,
    return_probs: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Tiny attention forward; returns (out, probs or None). See module doc."""
    if q.device.type == "cpu":
        out, probs = tiny_attention_reference(q, k, v, num_heads, key_mask,
                                              dmask, scale)
        return out, (probs if return_probs else None)
    _check_cuda("tiny_attention_fwd", q)
    B, Sq, HD = q.shape
    Skv = k.shape[1]
    H = num_heads
    if HD % H:
        raise ValueError(f"tiny_attention_fwd: width {HD} not divisible by {H} heads")
    D = HD // H
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"tiny_attention_fwd takes f32 or bf16 q/k/v of one "
                        f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if k.shape != (B, Skv, HD) or v.shape != k.shape:
        raise ValueError(f"tiny_attention_fwd: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)} do not match")
    for t in (k, v, key_mask, dmask):
        if t is not None and t.device != q.device:
            raise ValueError("tiny_attention_fwd: operands on different devices")
    if key_mask is not None and tuple(key_mask.shape) != (B, Skv):
        raise ValueError(f"tiny_attention_fwd: key_mask {tuple(key_mask.shape)} "
                         f"is not ({B}, {Skv})")
    if dmask is not None and (tuple(dmask.shape) != (B, Sq, H * Skv)
                              or dmask.dtype not in _build.OPERAND_KINDS):
        raise ValueError(f"tiny_attention_fwd: dmask {tuple(dmask.shape)} "
                         f"{dmask.dtype} is not ({B}, {Sq}, {H * Skv}) f32/bf16")
    route, walk = tiny_route(q.dtype, D), tiny_walk(Sq, Skv, D)
    if not _walk_ok(Sq, Skv, D):
        raise ValueError(f"tiny_attention_fwd: Sq={Sq}, Skv={Skv}, D={D} is past the "
                         f"resident shapes and the key-tiled walk takes Sq <= "
                         f"{_TILED_MAX_SQ}, D <= {_TILED_MAX_D}")
    lib = typed_lib(_build.load("tiny_attention_fwd"))
    q, k, v = (_build.aligned(t) for t in (q, k, v))
    km_ptr = None
    if key_mask is not None:
        key_mask = (key_mask != 0).to(torch.uint8).contiguous()
        km_ptr = key_mask.data_ptr()
    dm_ptr, dm_kind = None, 0
    if dmask is not None:
        dmask = _build.aligned(dmask)
        dm_ptr, dm_kind = dmask.data_ptr(), _build.OPERAND_KINDS[dmask.dtype]
    out = torch.empty_like(q)
    probs = torch.empty((B, Sq, H * Skv), dtype=torch.float32,
                        device=q.device) if return_probs else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.x2_tiny_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), km_ptr, dm_ptr, dm_kind,
            out.data_ptr(), None if probs is None else probs.data_ptr(),
            B, Sq, Skv, H, D, _DTYPES[q.dtype], _dtype_scale(scale, q.dtype), stream)
    _build.check(lib, err, "tiny_attention_fwd")
    tiny_attention_fwd.launches += 1
    tiny_attention_fwd.launches_by_shape[(B, Sq, Skv)] += 1
    tiny_attention_fwd.launches_by_heads[H] += 1
    tiny_attention_fwd.launches_by_route[route] += 1
    tiny_attention_fwd.launches_by_walk[walk] += 1
    return out, probs


tiny_attention_fwd.launches = 0
tiny_attention_fwd.launches_by_shape = collections.Counter()
tiny_attention_fwd.launches_by_heads = collections.Counter()
tiny_attention_fwd.launches_by_route = collections.Counter()
tiny_attention_fwd.launches_by_walk = collections.Counter()


def tiny_attention_bwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, probs: torch.Tensor,
    dmask: Optional[torch.Tensor], g: torch.Tensor, num_heads: int,
    scale: float = 1.0, *, out: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch tiny backward from the forward's fp32 probabilities:
    returns (dq, dk, dv) on the projection layout, dq for the unscaled q.
    dL and P * dm are cast to the input dtype before their products, as the
    JAX ``_bwd_kernel`` casts them; products accumulate in fp32. The
    softmax backward's row sums are rowsum(dP * dm * P); given the
    forward's ``out``, rowsum(g * out) in fp32 over its stored values
    instead, as the key-tiled tensor-core kernel takes them."""
    B, Sq, HD = q.shape
    Skv = k.shape[1]
    H = num_heads
    D = HD // H
    dt = q.dtype
    s = _dtype_scale(scale, dt)
    heads = lambda t, n: wide(t.view(B, n, H, D).transpose(1, 2))
    qs4 = heads(q * s, Sq)
    k4, v4, g4 = heads(k, Skv), heads(v, Skv), heads(g, Sq)
    p = wide(probs.view(B, Sq, H, Skv).transpose(1, 2))       # (B, H, Sq, Skv)
    dm = None if dmask is None else wide(dmask.view(B, Sq, H, Skv).transpose(1, 2))
    pu = p if dm is None else p * dm
    dv4 = torch.matmul(wide(pu.to(dt)).transpose(-1, -2), g4)
    dp = torch.matmul(g4, v4.transpose(-1, -2))
    if dm is not None:
        dp = dp * dm
    rows = (dp * p).sum(-1, keepdim=True) if out is None else \
        (g4 * heads(out, Sq)).sum(-1, keepdim=True)
    dl = wide((p * (dp - rows)).to(dt))
    dqs4 = torch.matmul(dl, k4).to(dt)
    dk4 = torch.matmul(dl.transpose(-1, -2), qs4)
    merge = lambda t, n: t.transpose(1, 2).reshape(B, n, HD)
    return (merge(dqs4 * s, Sq).to(dt), merge(dk4, Skv).to(k.dtype),
            merge(dv4, Skv).to(v.dtype))


def tiny_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, probs: torch.Tensor,
    dmask: Optional[torch.Tensor], g: torch.Tensor, num_heads: int,
    scale: float = 1.0, *, out: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Tiny attention backward; returns (dq, dk, dv). ``probs`` is the
    forward's fp32 pre-dropout probabilities, ``dmask`` its dropout
    multiplier (or None), ``g`` the output gradient, ``out`` the forward's
    output: the key-tiled tensor-core kernel takes its softmax-backward row
    sums as rowsum(g * out) (equal to rowsum(dP * dm * P), since out =
    (P * dm) . V); the other kernels and the plain version ignore it. See
    module doc."""
    if q.device.type == "cpu":
        return tiny_attention_bwd_reference(q, k, v, probs, dmask, g, num_heads, scale)
    _check_cuda("tiny_attention_bwd", q)
    B, Sq, HD = q.shape
    Skv = k.shape[1]
    H = num_heads
    if HD % H:
        raise ValueError(f"tiny_attention_bwd: width {HD} not divisible by {H} heads")
    D = HD // H
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"tiny_attention_bwd takes f32 or bf16 q/k/v of one "
                        f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if k.shape != (B, Skv, HD) or v.shape != k.shape or g.shape != q.shape:
        raise ValueError(f"tiny_attention_bwd: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} g {tuple(g.shape)} "
                         f"do not match")
    if probs.shape != (B, Sq, H * Skv) or probs.dtype != torch.float32:
        raise ValueError(f"tiny_attention_bwd: probs {tuple(probs.shape)} "
                         f"{probs.dtype} is not ({B}, {Sq}, {H * Skv}) f32")
    for t in (k, v, probs, dmask, g, out):
        if t is not None and t.device != q.device:
            raise ValueError("tiny_attention_bwd: operands on different devices")
    if out.shape != q.shape or out.dtype != q.dtype:
        raise ValueError(f"tiny_attention_bwd: out {tuple(out.shape)} {out.dtype} is not "
                         f"q's {tuple(q.shape)} {q.dtype}")
    if dmask is not None and (tuple(dmask.shape) != (B, Sq, H * Skv)
                              or dmask.dtype not in _build.OPERAND_KINDS):
        raise ValueError(f"tiny_attention_bwd: dmask {tuple(dmask.shape)} "
                         f"{dmask.dtype} is not ({B}, {Sq}, {H * Skv}) f32/bf16")
    route, walk = tiny_route(q.dtype, D), tiny_walk(Sq, Skv, D)
    if not _walk_ok(Sq, Skv, D):
        raise ValueError(f"tiny_attention_bwd: Sq={Sq}, Skv={Skv}, D={D} is past the "
                         f"resident shapes and the key-tiled walk takes Sq <= "
                         f"{_TILED_MAX_SQ}, D <= {_TILED_MAX_D}")
    lib = typed_lib(_build.load("tiny_attention_bwd"))
    q, k, v, probs, out = (_build.aligned(t) for t in (q, k, v, probs, out))
    g = _build.aligned(g.to(q.dtype))
    dm_ptr, dm_kind = None, 0
    if dmask is not None:
        dmask = _build.aligned(dmask)
        dm_ptr, dm_kind = dmask.data_ptr(), _build.OPERAND_KINDS[dmask.dtype]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.x2_tiny_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), probs.data_ptr(), dm_ptr, dm_kind,
            g.data_ptr(), out.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, Sq, Skv, H, D, _DTYPES[q.dtype], _dtype_scale(scale, q.dtype), stream)
    _build.check(lib, err, "tiny_attention_bwd")
    tiny_attention_bwd.launches += 1
    tiny_attention_bwd.launches_by_shape[(B, Sq, Skv)] += 1
    tiny_attention_bwd.launches_by_heads[H] += 1
    tiny_attention_bwd.launches_by_route[route] += 1
    tiny_attention_bwd.launches_by_walk[walk] += 1
    return dq, dk, dv


tiny_attention_bwd.launches = 0
tiny_attention_bwd.launches_by_shape = collections.Counter()
tiny_attention_bwd.launches_by_heads = collections.Counter()
tiny_attention_bwd.launches_by_route = collections.Counter()
tiny_attention_bwd.launches_by_walk = collections.Counter()


class _TinyAttention(torch.autograd.Function):
    """Forward kernel with the fp32 probabilities kept; backward kernel.
    Saves (q, k, v, probs, dmask), as the JAX ``_tiny_vjp_fwd`` does, and
    the output, from which the key-tiled backward takes its row sums."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, dmask, num_heads, scale):
        out, probs = tiny_attention_fwd(q, k, v, num_heads, key_mask, dmask, scale,
                                        return_probs=True)
        ctx.save_for_backward(q, k, v, probs, dmask, out)
        ctx.num_heads, ctx.scale = num_heads, scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, probs, dmask, out = ctx.saved_tensors
        dq, dk, dv = tiny_attention_bwd(q, k, v, probs, dmask, g, ctx.num_heads,
                                        ctx.scale, out=out)
        return dq, dk, dv, None, None, None, None


def tiny_block_attention(
    qw: torch.Tensor, kw: torch.Tensor, vw: torch.Tensor, *,
    num_heads: int,
    key_mask: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
    training: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Multi-head attention on projection-layout inputs; returns (B, Sq, H*D).

    Attention-probability dropout (``training`` and ``dropout_rate > 0``) is
    a multiplier drawn from ``generator`` and passed to the kernel (and kept
    for the backward). Differentiable in qw, kw, vw when grad is enabled."""
    B, Sq, HD = qw.shape
    if scale is None:
        scale = (HD // num_heads) ** -0.5
    dmask = None
    if training and dropout_rate > 0.0:
        dmask = dropout_multiplier((B, Sq, num_heads * kw.shape[1]), dropout_rate,
                                   generator, qw.dtype, qw.device)
    if torch.is_grad_enabled() and (qw.requires_grad or kw.requires_grad
                                    or vw.requires_grad):
        return _TinyAttention.apply(qw, kw, vw, key_mask, dmask, num_heads, scale)
    return tiny_attention_fwd(qw, kw, vw, num_heads, key_mask, dmask, scale)[0]
