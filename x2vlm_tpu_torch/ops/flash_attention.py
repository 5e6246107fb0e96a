"""Flash attention over (B, H, S, D) tensors — the BEiT-2 vision
self-attention with its trained relative-position bias — forward and
backward.

Counterpart of x2vlm_tpu/ops/flash_attention.py. The functions:

- :func:`flash_attention_fwd` is the forward kernel's wrapper: for CUDA
  tensors it launches the hand-written Hopper kernel
  (``csrc/flash_attention_fwd.cu``) or raises; for CPU tensors it runs
  :func:`flash_attention_reference`. It returns ``(out, lse)``; ``lse``
  (B, H, Sq, 1) fp32 is what the backward reads. ``flash_attention_fwd.
  launches`` counts kernel launches, ``.launches_by_route`` by route.
- :func:`flash_attention_bwd` is the backward kernels' wrapper (dQ, dK/dV
  and dBias, ``csrc/flash_attention_bwd.cu``); for CPU tensors it runs
  :func:`flash_attention_bwd_reference`. ``flash_attention_bwd.launches``
  counts the launches of each kernel ("dq", "dkv", "dbias"),
  ``.launches_by_route`` by (kernel, route).
- :func:`flash_attention_reference` / :func:`flash_attention_bwd_reference`
  are the plain PyTorch versions (counterparts of ``_xla_attention`` and of
  the math of ``_flash_backward``).
- :func:`flash_attention` is the public entry (same signature as the JAX
  one), returning ``out``. When a gradient is needed it goes through an
  autograd Function that saves (q, k, v, bias, key_mask, out, lse), as the
  JAX ``_flash_fwd`` does; otherwise it calls the forward alone.

The forward, dQ, dK/dV and dBias have two hand-written kernels each, and
:func:`flash_route` picks one by dtype and head dim (the C side keeps the
same rule): ``"tensor_core"`` for bf16 at D = 64 (the main path: mma.sync
on bf16 tiles staged by cp.async, P and dS in registers) and
``"cuda_core"`` for fp32 at any D and bf16 at the other head dims (fp32
arithmetic). The choice is a dispatch, not a fallback: a failed build or
launch raises on either route. On the tensor cores dBias sums a
batch-shared bias's gradient over :func:`dbias_groups` groups of batch rows
in parallel, then adds the groups' partial sums in a fixed order, so it is
the same bit for bit from run to run.

A masked or causally hidden logit is a constant, so its dS is 0, also on a
row whose every key is hidden (there the forward averaged V, so P = 1/Skv).
The Pallas ``_dq_kernel`` gives such a row dS = (1/n)(dP - delta); the port
follows the plain / XLA semantics that the JAX package computes off the TPU.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Optional, Tuple

import torch

from x2vlm_tpu_torch.ops import _build
from x2vlm_tpu_torch.ops.attention import NEG_INF, make_attention_mask

__all__ = ["BWD_KERNELS", "bwd_smem_bytes", "dbias_groups", "flash_attention",
           "flash_attention_bwd", "flash_attention_bwd_reference", "flash_attention_fwd",
           "flash_attention_reference", "flash_route", "flash_supported", "fwd_smem_bytes",
           "typed_lib"]

_DTYPES = _build.DTYPE_CODES
_HEAD_DIMS = (64, 128, 192, 256)
_DEAD_LSE = -1e29  # lse of a row with no visible key (every logit is -1e30)
CUDA_CORE, TENSOR_CORE = _build.CUDA_CORE, _build.TENSOR_CORE
BWD_KERNELS = {"dq": 0, "dkv": 1, "dbias": 2}   # `Which` in csrc/flash_attention_bwd.cu
_TC_TILE = 64   # rows of a tensor-core block's tile and of a walked tile
_DBIAS_BLOCKS = 384   # blocks the tensor-core dBias grid aims at (`kDBiasBlocks`)


def flash_route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel a forward, dQ, dK/dV or dBias launch takes: the tensor
    cores for bf16 at head dim 64, the CUDA cores otherwise. The same rule
    as ``x2::flash_route`` in csrc/common.cuh (chip_smoke.py holds the two
    equal)."""
    return TENSOR_CORE if dtype == torch.bfloat16 and head_dim == 64 else CUDA_CORE


def _tc_tile_words(head_dim: int, bias_kind: int) -> Tuple[int, int]:
    """(elements of a row of a bf16 tile, words of one staged 64 x 64 bias
    tile (rows of 36 words for bf16, 68 for fp32)) on the tensor-core route,
    which runs only at head dim 64 (there is no tensor-core kernel of
    another head dim to size)."""
    if head_dim != 64:
        raise ValueError(f"the flash kernels' tensor-core route runs at head dim 64, "
                         f"not {head_dim}")
    return head_dim, {0: 0, 1: 68, 2: 36}[bias_kind] * _TC_TILE


def fwd_smem_bytes(head_dim: int, route: str = CUDA_CORE, bias_kind: int = 0) -> int:
    """Shared memory one forward block takes with a bias of ``bias_kind``
    (``_build.OPERAND_KINDS``; 0 = none). CUDA cores: 64-row fp32 tiles of
    Q and K (row stride D+1), V, and the probabilities (row stride 65); the
    bias is read from device memory. Tensor cores (head dim 64 only): the
    bf16 Q tile and two stages of K, V and the 64 x 64 bias tile. The
    formulas of ``fwd_smem`` in csrc/flash_attention_fwd.cu (chip_smoke.py
    holds them equal)."""
    if route == TENSOR_CORE:
        ld, bias_words = _tc_tile_words(head_dim, bias_kind)
        return 2 * 5 * _TC_TILE * ld + 4 * 2 * bias_words
    return 4 * (2 * 64 * (head_dim + 1) + 64 * head_dim + 64 * 65)


def bwd_smem_bytes(kernel: str, head_dim: int, route: str = CUDA_CORE,
                   bias_kind: int = 0) -> int:
    """Shared memory one block of backward ``kernel`` ("dq", "dkv", "dbias")
    takes with a bias of ``bias_kind`` (``_build.OPERAND_KINDS``; 0 = none).
    CUDA cores: tiles of BQ query rows and BKV keys (64, or 32 above D =
    128) of Q, dO, K and V in fp32 (row stride D+1), plus dS (dQ) or P^T and
    dS^T (dK/dV); the bias is read from device memory. Tensor cores (head
    dim 64 only), dQ and dK/dV: six 64-row bf16 tiles (the block's own two
    and two stages of the walked two), two stages of a 64 x 64 bias tile
    and, for dK/dV, of the walked queries' fp32 lse and delta; dBias: two
    stages of its four bf16 tiles (Q, dO, K, V of one batch row) and of
    their fp32 lse and delta, and one bias tile (staged once a block). The
    formulas of ``smem_bytes`` in csrc/flash_attention_bwd.cu (chip_smoke.py
    holds them equal)."""
    if route == TENSOR_CORE:
        ld, bias_words = _tc_tile_words(head_dim, bias_kind)
        if kernel == "dbias":
            return 2 * 2 * 4 * _TC_TILE * ld + 4 * 2 * 2 * _TC_TILE + 4 * bias_words
        return (2 * 6 * _TC_TILE * ld + 4 * 2 * bias_words
                + (4 * 2 * 2 * _TC_TILE if kernel == "dkv" else 0))
    bq = 64 if head_dim <= 128 else 32
    staged = 4 * bq * (head_dim + 1)
    return 4 * (staged + {"dq": 1, "dkv": 2, "dbias": 0}[kernel] * bq * (bq + 1))


def dbias_groups(batch: int, tiles: int, heads: int) -> int:
    """Groups of batch rows the tensor-core dBias kernel sums a
    batch-shared bias's gradient over, in parallel: enough that its grid
    (``tiles`` = 64-row query tiles x 64-key tiles, times ``heads``, times
    the groups) has about ``_DBIAS_BLOCKS`` blocks, at most one group a
    batch row. The same rule as ``tc::dbias_groups`` in
    csrc/flash_attention_bwd.cu (chip_smoke.py holds the two equal)."""
    per_group = tiles * heads
    return max(1, min(batch, -(-_DBIAS_BLOCKS // per_group)))


def _dbias_launch_groups(route: str, B: int, H: int, Sq: int, Skv: int, bias_b: int) -> int:
    """The groups a dBias launch writes (``dbias_groups_of`` in
    csrc/flash_attention_bwd.cu): B for a per-batch bias, one group a batch
    row; :func:`dbias_groups` on the tensor cores for a batch-shared bias;
    else 1 (the CUDA-core kernel sums the batch in one block)."""
    if bias_b == B:
        return B
    if route != TENSOR_CORE:
        return 1
    tiles = -(-Sq // _TC_TILE) * -(-Skv // _TC_TILE)
    return dbias_groups(B, tiles, H)


# the C entry points' signatures, set once per loaded library by typed_lib
_OPERANDS = [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_longlong] * 3
_SIGNATURES = {
    "x2_flash_attention_fwd": (_OPERANDS + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
                               + [ctypes.c_float, ctypes.c_void_p], ctypes.c_int),
    "x2_flash_attention_fwd_route": ([ctypes.c_int] * 2, ctypes.c_int),
    "x2_flash_attention_fwd_smem_bytes": ([ctypes.c_int] * 3, ctypes.c_longlong),
    "x2_flash_attention_bwd_dq": (_OPERANDS + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                                  + [ctypes.c_float, ctypes.c_void_p], ctypes.c_int),
    "x2_flash_attention_bwd_dkv": (_OPERANDS + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                                   + [ctypes.c_float, ctypes.c_void_p], ctypes.c_int),
    "x2_flash_attention_bwd_dbias": (_OPERANDS + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
                                     + [ctypes.c_float, ctypes.c_void_p], ctypes.c_int),
    "x2_flash_attention_bwd_route": ([ctypes.c_int] * 2, ctypes.c_int),
    "x2_flash_attention_bwd_smem_bytes": ([ctypes.c_int] * 4, ctypes.c_longlong),
    "x2_flash_attention_bwd_dbias_groups": ([ctypes.c_int] * 3, ctypes.c_int),
}


def typed_lib(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` with the argument and result types of the flash attention C
    functions it exports set, once per library object (``_build.typed``)."""
    return _build.typed(lib, _SIGNATURES)


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


def _kernel_operands(name, q, k, v, bias, key_mask):
    """Check the operands a CUDA kernel takes; returns q, k, v, the bias
    (unit stride on its last dim, 16-byte aligned), its pointer, kind and (batch, head, row)
    strides, and the uint8 key mask (or None)."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    B, H, Sq, D = q.shape
    Skv = k.shape[2]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name} takes f32 or bf16 q/k/v of one "
                        f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"{name}: head dim {D} not in {_HEAD_DIMS}")
    if k.shape != (B, H, Skv, D) or v.shape != k.shape:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)} do not match")
    for t in (k, v, bias, key_mask):
        if t is not None and t.device != q.device:
            raise ValueError(f"{name}: operands on different devices")
    bias_ptr, bias_kind, strides = None, 0, (0, 0, 0)
    if bias is not None:
        if bias.dim() != 4 or bias.shape[0] not in (1, B) or \
                bias.shape[1] not in (1, H) or tuple(bias.shape[2:]) != (Sq, Skv):
            raise ValueError(f"{name}: bias {tuple(bias.shape)} does "
                             f"not broadcast as (1|{B}, 1|{H}, {Sq}, {Skv})")
        if bias.dtype not in _build.OPERAND_KINDS:
            raise TypeError(f"{name}: bias dtype {bias.dtype}")
        if bias.stride(3) != 1 or bias.data_ptr() % 16:
            bias = bias.clone(memory_format=torch.contiguous_format)
        bias_ptr, bias_kind = bias.data_ptr(), _build.OPERAND_KINDS[bias.dtype]
        strides = (0 if bias.shape[0] == 1 else bias.stride(0),
                   0 if bias.shape[1] == 1 else bias.stride(1), bias.stride(2))
    if key_mask is not None:
        if tuple(key_mask.shape) != (B, Skv):
            raise ValueError(f"{name}: key_mask {tuple(key_mask.shape)} "
                             f"is not ({B}, {Skv})")
        key_mask = (key_mask != 0).to(torch.uint8).contiguous()
    return q, k, v, (bias, bias_ptr, bias_kind, strides), key_mask


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
    q, k, v, (bias, bias_ptr, bias_kind, strides), key_mask = _kernel_operands(
        "flash_attention_fwd", q, k, v, bias, key_mask)
    B, H, Sq, D = q.shape
    Skv = k.shape[2]
    km_ptr = None if key_mask is None else key_mask.data_ptr()
    lib = typed_lib(_build.load("flash_attention_fwd"))
    q, k, v = (_build.aligned(t) for t in (q, k, v))

    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq, 1), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.x2_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr, bias_kind, *strides, km_ptr,
            out.data_ptr(), lse.data_ptr(), B, H, Sq, Skv, D, _DTYPES[q.dtype], int(causal),
            float(scale), stream)
    _build.check(lib, err, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    flash_attention_fwd.launches_by_route[flash_route(q.dtype, D)] += 1
    return out, lse


flash_attention_fwd.launches = 0
flash_attention_fwd.launches_by_route = collections.Counter()


def flash_attention_bwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    bias: Optional[torch.Tensor], key_mask: Optional[torch.Tensor],
    out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
    causal: bool = False, scale: float = 1.0, need_dbias: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch flash backward: P recomputed from ``lse``,
    delta = rowsum(dO * O), dS = P * (dO.V^T - delta) and 0 where a key is
    hidden; P and dS cast to the input dtype before their products, as the
    JAX kernels cast them. Returns (dq, dk, dv, dbias or None); dbias has the
    bias's shape and dtype (summed over broadcast batch / head dims)."""
    Sq, Skv = q.shape[2], k.shape[2]
    dt = q.dtype
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias.float()
    p = torch.exp(logits - lse)
    dead = lse < _DEAD_LSE                 # no visible key: the forward averaged V
    p = torch.where(dead, torch.full_like(p, 1.0 / Skv), p)
    visible = None                         # (B|1, 1, Sq, Skv): the keys each query sees
    if key_mask is not None or causal:
        visible = make_attention_mask(key_mask, Sq, causal=causal, kv_len=Skv,
                                      device=q.device)
        p = torch.where(visible | dead, p, torch.zeros_like(p))
    delta = (dout.float() * out.float()).sum(-1, keepdim=True)
    dp = torch.matmul(dout.float(), v.float().transpose(-1, -2))
    ds = p * (dp - delta)
    ds = torch.where(dead, torch.zeros_like(ds), ds)
    if visible is not None:
        ds = torch.where(visible, ds, torch.zeros_like(ds))
    dsc = ds.to(dt).float()
    dq = (torch.matmul(dsc, k.float()) * scale).to(dt)
    dk = (torch.matmul(dsc.transpose(-1, -2), q.float()) * scale).to(k.dtype)
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), dout.float()).to(v.dtype)
    dbias = None
    if bias is not None and need_dbias:
        dims = [i for i in (0, 1) if bias.shape[i] == 1 and ds.shape[i] != 1]
        dbias = (ds.sum(dim=dims, keepdim=True) if dims else ds).to(bias.dtype)
    return dq, dk, dv, dbias


def _bwd_launchers(q, k, v, bias, key_mask, out, lse, dout, causal, scale):
    """Check the backward's operands; returns ``{"dq", "dkv", "dbias"}`` ->
    a function that launches that kernel on the current stream and returns
    its outputs ("dbias" only with a bias; its output is (Bb, H, Sq, Skv)
    fp32, before the head sum and the cast)."""
    q, k, v, (bias, bias_ptr, bias_kind, strides), key_mask = _kernel_operands(
        "flash_attention_bwd", q, k, v, bias, key_mask)
    B, H, Sq, D = q.shape
    Skv = k.shape[2]
    if dout.shape != q.shape or out.shape != q.shape or lse.shape != (B, H, Sq, 1):
        raise ValueError(f"flash_attention_bwd: dout {tuple(dout.shape)}, out "
                         f"{tuple(out.shape)}, lse {tuple(lse.shape)} do not match "
                         f"q {tuple(q.shape)}")
    lib = typed_lib(_build.load("flash_attention_bwd"))
    route = flash_route(q.dtype, D)
    q, k, v = (_build.aligned(t) for t in (q, k, v))
    dout = _build.aligned(dout.to(q.dtype))
    lse = lse.float().contiguous()
    delta = (dout.float() * out.float()).sum(-1).contiguous()   # (B, H, Sq)
    km_ptr = None if key_mask is None else key_mask.data_ptr()
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr, bias_kind, *strides,
              km_ptr, dout.data_ptr(), lse.data_ptr(), delta.data_ptr())
    tail = (H, Sq, Skv, D, _DTYPES[q.dtype], int(causal), float(scale))

    # the default argument keeps every operand alive while a launcher exists
    def call(name, *args, _operands=(q, k, v, bias, key_mask, dout, lse, delta)):
        fn = getattr(lib, f"x2_flash_attention_bwd_{name}")
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = fn(*common, *args, *tail, stream)
        _build.check(lib, err, f"flash_attention_bwd {name}")
        flash_attention_bwd.launches[name] += 1
        flash_attention_bwd.launches_by_route[(name, route)] += 1

    def dq():
        dq_ = torch.empty_like(q)
        call("dq", dq_.data_ptr(), B)
        return dq_

    def dkv():
        dk_, dv_ = torch.empty_like(k), torch.empty_like(v)
        call("dkv", dk_.data_ptr(), dv_.data_ptr(), B)
        return dk_, dv_

    def dbias():
        bias_b = bias.shape[0]
        db = torch.empty((bias_b, H, Sq, Skv), dtype=torch.float32, device=q.device)
        groups = _dbias_launch_groups(route, B, H, Sq, Skv, bias_b)
        # the groups' partial sums, added in order by the kernel's second pass
        partial = torch.empty((groups, H, Sq, Skv), dtype=torch.float32,
                              device=q.device) if groups > bias_b else None
        call("dbias", db.data_ptr(), None if partial is None else partial.data_ptr(),
             groups, bias_b, B)
        return db

    launchers = {"dq": dq, "dkv": dkv}
    if bias is not None:
        launchers["dbias"] = dbias
    return launchers


def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    bias: Optional[torch.Tensor], key_mask: Optional[torch.Tensor],
    out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
    causal: bool = False, scale: float = 1.0, need_dbias: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Flash attention backward; returns (dq, dk, dv, dbias or None).

    The operands of :func:`flash_attention_fwd` plus its ``out`` and ``lse``
    and the output gradient ``dout``. Launches the dQ and dK/dV kernels, and
    the dBias kernel when ``need_dbias`` and a bias is given; dbias has the
    bias's shape and dtype. delta = rowsum(dO * O) is a torch reduction, as
    the JAX package computes it outside its kernels."""
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, bias, key_mask, out, lse, dout,
                                             causal, scale, need_dbias)
    launch = _bwd_launchers(q, k, v, bias, key_mask, out, lse, dout, causal, scale)
    dq = launch["dq"]()
    dk, dv = launch["dkv"]()
    dbias = None
    if bias is not None and need_dbias:
        db = launch["dbias"]()
        if bias.shape[1] == 1 and q.shape[1] > 1:
            db = db.sum(dim=1, keepdim=True)   # head-shared bias: outside the kernel
        dbias = db.to(bias.dtype)
    return dq, dk, dv, dbias


flash_attention_bwd.launches = collections.Counter()
flash_attention_bwd.launches_by_route = collections.Counter()


class _FlashAttention(torch.autograd.Function):
    """Forward kernel with lse saved; backward kernels. Saves (q, k, v,
    bias, key_mask, out, lse), as the JAX ``_flash_fwd`` does."""

    @staticmethod
    def forward(ctx, q, k, v, bias, key_mask, causal, scale):
        out, lse = flash_attention_fwd(q, k, v, bias, key_mask, causal, scale)
        ctx.save_for_backward(q, k, v, bias, key_mask, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, key_mask, out, lse = ctx.saved_tensors
        need_dbias = bias is not None and ctx.needs_input_grad[3]
        dq, dk, dv, dbias = flash_attention_bwd(q, k, v, bias, key_mask, out, lse, dout,
                                                ctx.causal, ctx.scale, need_dbias)
        return dq, dk, dv, dbias, None, None, None


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    bias: Optional[torch.Tensor] = None,
    key_mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Flash attention over (B, H, S, D) tensors; ``scale`` defaults to D^-0.5.

    Differentiable in q, k, v and bias. Without grad autograd records no
    node, so what the forward saves is released with its output."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _FlashAttention.apply(q, k, v, bias, key_mask, causal, scale)
