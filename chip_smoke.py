#!/usr/bin/env python3
"""Drive the PyTorch port (``x2vlm_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--profile DIR]

Run from the repository root, on a machine with a CUDA card and ``nvcc``.
Phases (any failure exits non-zero and prints no result line):

1. build every CUDA kernel of the port from ``x2vlm_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together);
2. hold each kernel (flash forward, dQ, dK/dV, dBias; tiny forward and
   backward) against its plain PyTorch version on the card: at the main
   paths' shapes in bf16, with fp32 plain as truth and the rule
   kernel_err <= max(4 x plain_bf16_err, 1e-3 x max|truth|), and over the
   rest of each kernel's contract (key masks, fully masked rows, causal,
   Sq != Skv, per-batch and head-shared bias, dropout multiplier, fp32,
   other head dims: for the tiny kernels each one the tensor-core route
   builds, 16 to 128) at small shapes; time the kernel, its plain version and
   one PyTorch library call (SDPA forward or backward) with CUDA events,
   the card running ahead of the host (the flash forward at B=128 and at
   the step's B=32; the flash backward beside two SDPA backwards, dq/dk/dv
   with the bias as a constant and all four gradients; dBias must be the
   same bit for bit in two launches). The tiny kernels (``tiny_route``) and
   the four flash kernels (``flash_route``) have two routes: the main
   paths' bf16 D=64 launches must take the tensor-core route, fp32 and bf16
   at other head dims the CUDA-core route; the C route rules, each route's
   shared-memory formulas and the dBias group count must equal the Python
   ones;
3. the serving path: X2VLM-base at 224 px with weights drawn from
   ``--seed`` serves ``encode_images`` (128 images), ``encode_texts`` (128
   texts of 40 tokens, some padded) and ``itm_score`` (128 pairs) through
   ``RetrievalServer``; the launch counts of each request are read and
   checked (12 flash per image batch, 12 tiny per text batch, 12 tiny per
   rerank batch, every flash and tiny launch on the tensor-core route),
   outputs are checked for shape and finiteness, and the requests are
   timed; the same weights on the port's CPU path in fp32 for 2 rows,
   against the card's rows;
4. K7, the int8 matmul (its quantize and GEMM kernels), at every shape of
   the int8 serving path and over its contract (M off every tile, 3-D
   input, no bias, each activation, fp32 in and out, zero rows, an
   outlier, odd N, K off the 64-byte tile): (xq, sx) and, without an
   activation, the output must equal the plain version bit for bit; with
   one, within 1e-6 x max|out| in fp32 and one bf16 ulp (2^-7 x max|out|)
   in bf16. Timed beside its plain version, ``torch._int_mm`` on the same
   int8 operands and the bf16 ``F.linear`` of the float path;
5. the int8 serving path: X2VLM-base with ``quant_int8`` and the tanh GELU
   on both towers (``bench.py``'s ``X2VLM_BENCH=int8`` variant), loaded
   from phase 3's state dict, serves the same requests; launches checked
   (K7 GEMM / quantize 48 / 48 per image batch, 72 / 48 per text batch,
   60 / 42 per rerank batch; attention as in phase 3), int8 against bf16
   with the same weights and GELU (feature cosine >= 0.99), card int8
   against the port's CPU fp32 int8 path on 2 rows, requests timed beside
   the bf16 ones;
6. the training path: X2VLM-base pretraining steps (ITC + ITM + MLM,
   AdamW, ``lr_schedule(1e-4, 1000, 100)``) at B=32, 40 tokens, 12 masked,
   uint8 images, the config's dropouts on; the launch counts of one step
   are read and checked (12 flash forward / dQ / dK-dV / dBias, all on the
   tensor-core route; tiny forward and backward 12 + 6 at
   40x40 and 6 at 40x200, all on the tensor-core route), the losses and
   the gradient norm must be finite, the step is timed (median of 7 after
   2 warm-up steps) with its peak device memory; then the same weights
   with dropout off at B=2 and injected hard negatives, card bf16 against
   the port's CPU fp32 path: losses, and gradient cosines >= 0.99.

Prints the card's name and power limit (``nvidia-smi``), one JSON line of
kernels (with their launches on the three main paths), and as its last line
``{"ok": true, "device": {...}}``. ``--profile DIR`` also writes
torch.profiler tables of one round of requests, one int8 round and one
train step to ``DIR/chip_smoke_profile.txt``,
``DIR/chip_smoke_int8_profile.txt`` and ``DIR/chip_smoke_train_profile.txt``,
each with a last line of the attention kernels' device time and launches.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from x2vlm_tpu_torch.models import XVLMConfig, XVLMForPretrain, XVLMForRetrieval
from x2vlm_tpu_torch.ops import _build
from x2vlm_tpu_torch.ops.flash_attention import (
    BWD_KERNELS, _HEAD_DIMS as FLASH_HEAD_DIMS, _bwd_launchers,
    bwd_smem_bytes as flash_bwd_smem_bytes, dbias_groups, flash_attention_bwd,
    flash_attention_bwd_reference, flash_attention_fwd, flash_attention_reference, flash_route,
    fwd_smem_bytes as flash_fwd_smem_bytes, typed_lib as flash_typed_lib,
)
from x2vlm_tpu_torch.ops.int8_matmul import (
    int8_matmul, int8_matmul_reference, int8_scale, quantize_act, quantize_act_reference,
)
from x2vlm_tpu_torch.ops.quant import quantize_weight
from x2vlm_tpu_torch.ops.tiny_attention import (
    ROUTE_CODES, TENSOR_CORE,
    bwd_smem_bytes as tiny_bwd_smem_bytes,
    smem_bytes as tiny_smem_bytes, tiny_attention_bwd, tiny_attention_bwd_reference,
    tiny_attention_fwd, tiny_attention_reference, tiny_route, typed_lib,
)
from x2vlm_tpu_torch.serving import RetrievalServer
from x2vlm_tpu_torch.train import create_optimizer, lr_schedule, make_train_step, param_labels

HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory (data sheet)
BF16_FLOP_PER_S = 989e12     # H100 SXM dense bf16 tensor-core peak (data sheet)
INT8_OP_PER_S = 1979e12      # H100 SXM dense int8 tensor-core peak (data sheet)
FP32_FLOP_PER_S = 67e12      # H100 SXM fp32 outside the tensor cores (data sheet)
BATCH, TEXT_LEN = 128, 40          # serving requests
N_IMG = 197                        # image stream at 224 px; 200 once padded to 8
# (label, M, K, N, act) of every int8 matmul of the int8 serving path at B=128
INT8_SHAPES = (("vision qkv", BATCH * N_IMG, 768, 2304, None),
               ("vision proj", BATCH * N_IMG, 768, 768, None),
               ("vision fc1", BATCH * N_IMG, 768, 3072, "gelu_fast"),
               ("vision fc2", BATCH * N_IMG, 3072, 768, None),
               ("text q/k/v/out", BATCH * TEXT_LEN, 768, 768, None),
               ("text fc1", BATCH * TEXT_LEN, 768, 3072, "gelu_fast"),
               ("text fc2", BATCH * TEXT_LEN, 3072, 768, None),
               ("fusion cross k/v", BATCH * 200, 768, 768, None))
INT8_REPLACES = "x2vlm_tpu/ops/int8_matmul.py:63"
TRAIN_BATCH, N_MASKED = 32, 12     # the pretraining step (bench.py:104-121)
TINY_REPLACES = {"tiny_attention_fwd": "x2vlm_tpu/ops/tiny_attention.py:88",
                 "tiny_attention_bwd": "x2vlm_tpu/ops/tiny_attention.py:135"}
FLASH_BWD_REPLACES = {"dq": "x2vlm_tpu/ops/flash_attention.py:368",
                      "dkv": "x2vlm_tpu/ops/flash_attention.py:413",
                      "dbias": "x2vlm_tpu/ops/flash_attention.py:480"}

FAILURES = []


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    FAILURES.append(msg)
    log(f"FAIL {msg}")


def bound_ms(nbytes: float, flops: float, peak: float = BF16_FLOP_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def time_ms(fn, inner: int = 10, reps: int = 7, warmup: int = 2,
            host_ahead: bool = False) -> float:
    """Median over ``reps`` of the per-call device time of ``inner``
    back-to-back calls, from CUDA events. ``host_ahead`` first queues a
    ~10 ms spin on the stream, so the host enqueues the calls before the
    card reaches them and a call shorter than its Python wrapper (or than
    an autograd backward's host work) is timed on the card, not on the
    host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if host_ahead:
            torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def rule_bf16(name, kernel_out, plain_bf16_out, truth) -> float:
    """kernel_err <= max(4 x plain_bf16_err, 1e-3 x max|truth|) (the rule
    of tools/verify_kernels.py)."""
    ek = max_err(kernel_out, truth)
    ex = max_err(plain_bf16_out, truth)
    bound = max(4.0 * ex, 1e-3 * max(truth.float().abs().max().item(), 1e-6))
    ok = math.isfinite(ek) and ek <= bound
    log(f"check {name}: kernel_err={ek:.3e} plain_bf16_err={ex:.3e} "
        f"bound={bound:.3e} {'OK' if ok else 'FAIL'}")
    if not ok:
        fail(f"{name}: kernel error {ek:.3e} above {bound:.3e}")
    return ek


def rule_f32(name, kernel_out, truth) -> float:
    """fp32 kernel against fp32 plain: sums in another order only."""
    ek = max_err(kernel_out, truth)
    bound = 1e-4 * max(truth.float().abs().max().item(), 1.0)
    ok = math.isfinite(ek) and ek <= bound
    log(f"check {name}: kernel_err={ek:.3e} bound={bound:.3e} {'OK' if ok else 'FAIL'}")
    if not ok:
        fail(f"{name}: kernel error {ek:.3e} above {bound:.3e}")
    return ek


def flash_inputs(gen, dev, B, H, Sq, Skv, D, dtype, bias_shape=None):
    q = torch.randn(B, H, Sq, D, generator=gen, device=dev) * D ** -0.5
    k = torch.randn(B, H, Skv, D, generator=gen, device=dev)
    v = torch.randn(B, H, Skv, D, generator=gen, device=dev)
    bias = None if bias_shape is None else \
        torch.randn(*bias_shape, generator=gen, device=dev)
    cast = lambda t: None if t is None else t.to(dtype)
    return cast(q), cast(k), cast(v), cast(bias)


def tiny_inputs(gen, dev, B, Sq, Skv, H, D, dtype):
    q = torch.randn(B, Sq, H * D, generator=gen, device=dev)
    k = torch.randn(B, Skv, H * D, generator=gen, device=dev)
    v = torch.randn(B, Skv, H * D, generator=gen, device=dev)
    return q.to(dtype), k.to(dtype), v.to(dtype)


def as_f32(*ts):
    return [None if t is None else t.float() for t in ts]


def expect_flash_fwd_route(tag, before, dtype, D, n=1) -> None:
    """The flash forward launches since ``before`` were ``n``, all on
    ``flash_route(dtype, D)``."""
    want = {flash_route(dtype, D): n}
    got = route_delta(flash_attention_fwd, before)
    if got != want:
        fail(f"{tag}: flash forward launches by route {got}, expected {want}")


def check_flash(gen, dev):
    """K1 at the serving (B=128) and training (B=32) shapes in bf16 (checked
    and timed with the card ahead of the host, beside SDPA), then over the
    contract at small shapes on both routes. Returns an entry per shape."""
    entries = []
    H, S, D = 12, 197, 64
    for B, path in ((BATCH, "serving"), (TRAIN_BATCH, "train_step")):
        q, k, v, bias = flash_inputs(gen, dev, B, H, S, S, D, torch.bfloat16, (1, H, S, S))
        before = dict(flash_attention_fwd.launches_by_route)
        out, lse = flash_attention_fwd(q, k, v, bias)
        expect_flash_fwd_route(f"flash_attention_fwd B{B}", before, q.dtype, D)
        p_out, p_lse = flash_attention_reference(q, k, v, bias)
        t_out, t_lse = flash_attention_reference(*as_f32(q, k, v, bias))
        route = flash_route(q.dtype, D)
        err = rule_bf16(f"flash_attention_fwd out B{B} H{H} S{S} D{D} bias(1,H,S,S) bf16 "
                        f"({route})", out, p_out, t_out)
        rule_bf16(f"flash_attention_fwd lse B{B} H{H} S{S} D{D} ({route})", lse, p_lse, t_lse)
        ms = time_ms(lambda: flash_attention_fwd(q, k, v, bias), host_ahead=True)
        plain_ms = time_ms(lambda: flash_attention_reference(q, k, v, bias), inner=2, reps=5,
                           host_ahead=True)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias,
                                                                scale=1.0), host_ahead=True)
        b_ms, b_by = bound_ms(nbytes(q, k, v, out, bias, lse), 4.0 * B * H * S * S * D)
        entries.append(dict(
            name="flash_attention_fwd", shape=f"B{B} H{H} S{S} D{D} bias(1,{H},{S},{S}) bf16",
            route="cuda", source="x2vlm_tpu_torch/csrc/flash_attention_fwd.cu",
            replaces="x2vlm_tpu/ops/flash_attention.py:174", max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
            flash_route=route, path=path))
        log(f"time flash_attention_fwd B{B}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        del q, k, v, bias, out, lse, p_out, p_lse, t_out, t_lse

    # the rest of the contract, at small shapes: bf16 at D = 64 on the
    # tensor cores (D = 128 / 256 on the CUDA cores), fp32 on the CUDA cores
    for name, (B, H, Sq, Skv, D, bias_shape, masked, causal, f32_bias) in {
        "bias(B,H) D128": (3, 2, 150, 150, 128, (3, 2, 150, 150), False, False, False),
        "key_mask+fully_masked_row D64": (3, 2, 130, 130, 64, None, True, False, False),
        "causal bias(1,H) D64": (2, 3, 200, 200, 64, (1, 3, 200, 200), False, True, False),
        "cross Sq100 Skv300 key_mask D64": (2, 2, 100, 300, 64, None, True, False, False),
        "bias(1,1) D256": (2, 2, 70, 129, 256, (1, 1, 70, 129), False, False, False),
        "ragged 130x129 bias(1,H) D64": (2, 3, 130, 129, 64, (1, 3, 130, 129), False, False,
                                         False),
        "bias(B,H) D64": (3, 2, 150, 150, 64, (3, 2, 150, 150), False, False, False),
        "bias(1,1) D64 70x129": (2, 2, 70, 129, 64, (1, 1, 70, 129), False, False, False),
        "fp32 bias(1,H) D64": (2, 2, 197, 197, 64, (1, 2, 197, 197), False, False, True),
        "fp32 bias(1,H) causal key_mask D64 150x160": (2, 2, 150, 160, 64, (1, 2, 150, 160),
                                                       True, True, True),
        "no bias D64": (2, 2, 197, 197, 64, None, False, False, False),
        "197x200 (off every tile) bias(1,H) key_mask D64": (2, 2, 197, 200, 64, (1, 2, 197, 200),
                                                            True, False, False),
        "causal Sq150 Skv100 (rows with no key) D64": (2, 2, 150, 100, 64, None, False, True,
                                                       False),
    }.items():
        km = None
        if masked:
            km = (torch.rand(B, Skv, generator=gen, device=dev) > 0.3).to(torch.int32)
            km[1] = 0
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, bias = flash_inputs(gen, dev, B, H, Sq, Skv, D, dtype, bias_shape)
            if f32_bias:
                bias = bias.float()
            tag = f"flash_attention_fwd {name} {str(dtype)[6:]} ({flash_route(dtype, D)})"
            before = dict(flash_attention_fwd.launches_by_route)
            out, lse = flash_attention_fwd(q, k, v, bias, km, causal, D ** -0.5)
            expect_flash_fwd_route(tag, before, dtype, D)
            t_out, t_lse = flash_attention_reference(*as_f32(q, k, v, bias), km, causal,
                                                     D ** -0.5)
            # a row with no visible key has lse ~ -1e30 in both; compare the rest
            hide = lambda t: torch.where(t_lse < -1e29, 0.0, t)
            if dtype == torch.bfloat16:
                p_out, p_lse = flash_attention_reference(q, k, v, bias, km, causal, D ** -0.5)
                rule_bf16(tag, out, p_out, t_out)
                rule_bf16(tag + " lse", hide(lse), hide(p_lse), hide(t_lse))
            else:
                rule_f32(tag, out, t_out)
                rule_f32(tag + " lse", hide(lse), hide(t_lse))
            if not bool((lse < -1e29).eq(t_lse < -1e29).all()):
                fail(f"{tag}: the rows with no visible key differ from the plain version's")
    return entries


def tiny_operands(gen, dev, B, Sq, Skv, H, D, dtype, mask, drop):
    """q/k/v, an int32 key mask (None; "pad": the 197 -> 200 pad of the image
    stream, or per-row text lengths when Sq == Skv; "half": row 0's second
    half; "full_row": random, with batch row 1 wholly masked) and a dropout
    multiplier (1/0.9 or 0, in ``dtype``) when ``drop``."""
    q, k, v = tiny_inputs(gen, dev, B, Sq, Skv, H, D, dtype)
    km = None
    if mask == "pad":
        km = torch.ones(B, Skv, dtype=torch.int32, device=dev)
        if Skv == Sq:   # padded texts
            lens = torch.randint(5, Skv + 1, (B,), generator=gen, device=dev)
            km = (torch.arange(Skv, device=dev)[None] < lens[:, None]).to(torch.int32)
        else:           # the 197 -> 200 pad of the image stream
            km[:, 197:] = 0
    elif mask == "half":
        km = torch.ones(B, Skv, dtype=torch.int32, device=dev)
        km[0, Skv // 2:] = 0
    elif mask == "full_row":
        km = (torch.rand(B, Skv, generator=gen, device=dev) > 0.3).to(torch.int32)
        km[1] = 0
    dm = None
    if drop:
        keep = torch.rand(B, Sq, H * Skv, generator=gen, device=dev) >= 0.1
        dm = torch.where(keep, 1.0 / 0.9, 0.0).to(dtype)
    return q, k, v, km, dm


def route_delta(fn, before) -> dict:
    return {r: n - before.get(r, 0) for r, n in fn.launches_by_route.items()
            if n != before.get(r, 0)}


def expect_route(tag, fn, before, dtype, D) -> None:
    """The launches since ``before`` all took ``tiny_route(dtype, D)``."""
    want = tiny_route(dtype, D)
    got = route_delta(fn, before)
    if set(got) != {want}:
        fail(f"{tag}: launches by route {got}, expected {want} only")


def check_tiny_rules() -> None:
    """The C route rule and each route's shared-memory formulas are the
    Python ones (the dispatch and the wrappers' checks rely on them)."""
    fwd = typed_lib(_build.load("tiny_attention_fwd"))
    bwd = typed_lib(_build.load("tiny_attention_bwd"))
    for dtype in (torch.float32, torch.bfloat16):
        for D in (8, 16, 24, 32, 48, 64, 96, 100, 128, 144, 256):
            want = ROUTE_CODES[tiny_route(dtype, D)]
            for lib in (fwd, bwd):
                got = lib.x2_tiny_attention_route(_build.DTYPE_CODES[dtype], D)
                if got != want:
                    fail(f"tiny route rule: {dtype} D={D}: kernel {got}, python {want}")
    for route, code in ROUTE_CODES.items():
        for Skv, D in ((40, 64), (200, 64), (197, 64), (420, 64), (421, 64), (97, 128),
                       (27, 32), (7, 128), (9, 256), (33, 16), (77, 48), (61, 96), (45, 112)):
            c_bytes = fwd.x2_tiny_attention_smem_bytes(Skv, D, code)
            if c_bytes != tiny_smem_bytes(Skv, D, route):
                fail(f"tiny smem formula ({route}): Skv={Skv} D={D}: kernel {c_bytes}, "
                     f"python {tiny_smem_bytes(Skv, D, route)}")
        for Sq, Skv, D in ((40, 40, 64), (40, 200, 64), (40, 257, 64), (64, 209, 64),
                           (13, 27, 32), (1, 7, 128), (1, 197, 64), (5, 9, 256), (17, 33, 16),
                           (40, 77, 48), (24, 61, 96), (9, 45, 112)):
            c_bytes = bwd.x2_tiny_attention_bwd_smem_bytes(Sq, Skv, D, code)
            if c_bytes != tiny_bwd_smem_bytes(Sq, Skv, D, route):
                fail(f"tiny bwd smem formula ({route}): Sq={Sq} Skv={Skv} D={D}: kernel "
                     f"{c_bytes}, python {tiny_bwd_smem_bytes(Sq, Skv, D, route)}")


def tiny_entry(name, shape, key, err, ms, plain_ms, b_ms, b_by, lib_ms, **extra):
    src = "fwd" if name == "tiny_attention_fwd" else "bwd"
    return dict(name=name, shape=shape, route="cuda",
                source=f"x2vlm_tpu_torch/csrc/tiny_attention_{src}.cu",
                replaces=TINY_REPLACES[name], key=key, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                tiny_route=TENSOR_CORE, **extra)


def check_tiny(gen, dev):
    """K5 at the serving path's two shapes in bf16, and with the training
    operands at 40x200 (checked and timed, the card running ahead of the
    host), then over the contract at small shapes on both routes."""
    entries = []
    H, D = 12, 64
    scale = D ** -0.5
    for label, Sq, Skv, train_ops in (("text self-attention", TEXT_LEN, TEXT_LEN, False),
                                      ("fusion cross-attention", TEXT_LEN, 200, False),
                                      ("fusion self-attention, training operands",
                                       TEXT_LEN, TEXT_LEN, True),
                                      ("fusion cross-attention, training operands",
                                       TEXT_LEN, 200, True)):
        q, k, v, km, dm = tiny_operands(gen, dev, BATCH, Sq, Skv, H, D, torch.bfloat16,
                                        "pad", train_ops)
        before = dict(tiny_attention_fwd.launches_by_route)
        out, probs = tiny_attention_fwd(q, k, v, H, km, dm, scale, return_probs=train_ops)
        expect_route(f"tiny_attention_fwd {label}", tiny_attention_fwd, before,
                     torch.bfloat16, D)
        p_out, p_probs = tiny_attention_reference(q, k, v, H, km, dm, scale=scale)
        t_out, t_probs = tiny_attention_reference(*as_f32(q, k, v), H, km,
                                                  None if dm is None else dm.float(),
                                                  scale=scale)
        ops = "key_mask dropout probs" if train_ops else "key_mask"
        tag = f"tiny_attention_fwd {label} B{BATCH} {Sq}x{Skv} H{H} D{D} bf16"
        err = rule_bf16(tag, out, p_out, t_out)
        if train_ops:
            err = max(err, rule_bf16(tag + " probs", probs, p_probs, t_probs))
        ms = time_ms(lambda: tiny_attention_fwd(q, k, v, H, km, dm, scale,
                                                return_probs=train_ops), host_ahead=True)
        plain_ms = time_ms(lambda: tiny_attention_reference(q, k, v, H, km, dm, scale=scale),
                           inner=3, reps=5, host_ahead=True)
        views = [t.view(BATCH, t.shape[1], H, D).transpose(1, 2) for t in (q, k, v)]
        amask = (km != 0)[:, None, None, :]
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            *views, attn_mask=amask, scale=scale), host_ahead=True)
        b_ms, b_by = bound_ms(nbytes(q, k, v, out, probs, dm) + km.numel(),
                              4.0 * BATCH * H * Sq * Skv * D)
        log(f"time tiny_attention_fwd {label}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms (no dropout, no probabilities), "
            f"bound {b_ms:.4f} ms ({b_by})")
        entries.append(tiny_entry(
            "tiny_attention_fwd", f"B{BATCH} {Sq}x{Skv} H{H} D{D} {ops} bf16",
            (BATCH, Sq, Skv), err, ms, plain_ms, b_ms, b_by, lib_ms,
            main_path_launches="train_step" if train_ops else "all"))

    # the rest of the contract, at small shapes: bf16 on the tensor cores
    # (D = 256 on the CUDA cores), fp32 on the CUDA cores
    for name, (B, Sq, Skv, H, D, mask) in {
        "non-multiple-of-8 13x27 D32": (3, 13, 27, 4, 32, "half"),
        "no mask 64x420 D64": (2, 64, 420, 2, 64, None),
        "1x7 D128": (2, 1, 7, 3, 128, "half"),
        "fully masked row 40x200 D64": (3, 40, 200, 2, 64, "full_row"),
        "40x197 D64 (Skv off the 16-key tile) fp32 multiplier": (2, 40, 197, 3, 64, "half"),
        "80x50 D64 (two row tiles a warp)": (2, 80, 50, 2, 64, "half"),
        # the other tensor-core head dims: one k-step, odd k-step counts, padded tiles
        "17x33 D16": (2, 17, 33, 3, 16, "half"),
        "40x77 D48": (2, 40, 77, 2, 48, "full_row"),
        "24x61 D96": (2, 24, 61, 2, 96, "half"),
        "9x45 D112": (2, 9, 45, 2, 112, "half"),
        "5x9 D256": (2, 5, 9, 2, 256, "half"),
    }.items():
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, km, dm = tiny_operands(gen, dev, B, Sq, Skv, H, D, dtype, mask, True)
            dm = torch.where(dm != 0, 1.25, 0.0).to(
                torch.float32 if name.endswith("fp32 multiplier") else dtype)
            before = dict(tiny_attention_fwd.launches_by_route)
            out, probs = tiny_attention_fwd(q, k, v, H, km, dm, scale=D ** -0.5,
                                            return_probs=True)
            # and without the probabilities (on the tensor cores: one walk)
            out1, _ = tiny_attention_fwd(q, k, v, H, km, dm, scale=D ** -0.5)
            tag = f"tiny_attention_fwd {name} {str(dtype)[6:]} ({tiny_route(dtype, D)})"
            expect_route(tag, tiny_attention_fwd, before, dtype, D)
            t_out, t_probs = tiny_attention_reference(*as_f32(q, k, v), H, km, dm.float(),
                                                      scale=D ** -0.5)
            if dtype == torch.bfloat16:
                p_out, p_probs = tiny_attention_reference(q, k, v, H, km, dm,
                                                          scale=D ** -0.5)
                rule_bf16(tag, out, p_out, t_out)
                rule_bf16(tag + " probs", probs, p_probs, t_probs)
                rule_bf16(tag + " without probs", out1, p_out, t_out)
            else:
                rule_f32(tag, out, t_out)
                rule_f32(tag + " probs", probs, t_probs)
                rule_f32(tag + " without probs", out1, t_out)
            if mask == "full_row":   # P = 1 / Skv over the real keys
                uniform = probs.view(B, Sq, H, Skv)[1]
                u_err = (uniform - 1.0 / Skv).abs().max().item()
                if not u_err <= 1e-6 / Skv:
                    fail(f"{tag}: a fully masked row's P is off 1/Skv by {u_err:.3e}")
    return entries


def _sdpa_bwd_ms(q, k, v, mask, dout, scale, host_ahead=False, mask_grad=True):
    """One SDPA forward + autograd.grad, timed on the backward alone: the
    backward of a graph kept with retain_graph. A float mask is a bias whose
    gradient is asked for unless ``mask_grad`` is False (then dq, dk, dv
    only). Returns ms or None with the reason logged (a yardstick only: the
    port never calls SDPA)."""
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    m = mask
    if mask is not None and mask.dtype != torch.bool and mask_grad:
        m = mask.detach().requires_grad_()
        leaves.append(m)
    try:
        with torch.inference_mode(False), torch.enable_grad():
            o = F.scaled_dot_product_attention(*leaves[:3], attn_mask=m, scale=scale)
            return time_ms(lambda: torch.autograd.grad(o, leaves, dout, retain_graph=True),
                           inner=5, reps=5, host_ahead=host_ahead)
    except RuntimeError as e:   # no SDPA backend takes these operands
        log(f"sdpa backward not timed: {str(e).splitlines()[0][:200]}")
        return None


def check_flash_bwd_rules() -> None:
    """The C route rule of the four flash kernels, each route's
    shared-memory formulas and the dBias group count are the Python ones."""
    fwd = flash_typed_lib(_build.load("flash_attention_fwd"))
    lib = flash_typed_lib(_build.load("flash_attention_bwd"))
    for dtype in (torch.float32, torch.bfloat16):
        for D in (16, 32, 48, 64, 96, 128, 192, 256):
            want = ROUTE_CODES[flash_route(dtype, D)]
            for which, c_lib in (("fwd", fwd), ("bwd", lib)):
                got = getattr(c_lib, f"x2_flash_attention_{which}_route")(
                    _build.DTYPE_CODES[dtype], D)
                if got != want:
                    fail(f"flash {which} route rule: {dtype} D={D}: kernel {got}, "
                         f"python {want}")

    def py_smem(formula, *args):   # -1, as in C, where the route runs no kernel
        try:
            return formula(*args)
        except ValueError:
            return -1

    for route, code in ROUTE_CODES.items():
        for D in FLASH_HEAD_DIMS:
            for kind in (0, *_build.OPERAND_KINDS.values()):
                c_bytes = fwd.x2_flash_attention_fwd_smem_bytes(D, code, kind)
                py_bytes = py_smem(flash_fwd_smem_bytes, D, route, kind)
                if c_bytes != py_bytes:
                    fail(f"flash fwd smem formula ({route}, bias kind {kind}): D={D}: "
                         f"kernel {c_bytes}, python {py_bytes}")
                for kernel, which in BWD_KERNELS.items():
                    c_bytes = lib.x2_flash_attention_bwd_smem_bytes(which, D, code, kind)
                    py_bytes = py_smem(flash_bwd_smem_bytes, kernel, D, route, kind)
                    if c_bytes != py_bytes:
                        fail(f"flash bwd smem formula ({kernel}, {route}, bias kind {kind}): "
                             f"D={D}: kernel {c_bytes}, python {py_bytes}")
    for B in (1, 2, 3, 7, 32, 128, 1000):
        for tiles in (1, 4, 16, 25, 400):
            for H in (1, 2, 12, 16):
                c_groups = lib.x2_flash_attention_bwd_dbias_groups(B, tiles, H)
                if c_groups != dbias_groups(B, tiles, H):
                    fail(f"dbias groups: B={B} tiles={tiles} H={H}: kernel {c_groups}, "
                         f"python {dbias_groups(B, tiles, H)}")


def flash_bwd_route_delta(before) -> dict:
    now = flash_attention_bwd.launches_by_route
    return {f"{k}/{r}": n - before.get((k, r), 0) for (k, r), n in now.items()
            if n != before.get((k, r), 0)}


def expect_flash_bwd_route(tag, before, dtype, D, with_dbias) -> None:
    """The dQ, dK/dV and (with a bias) dBias launches since ``before`` took
    ``flash_route``, one each."""
    route = flash_route(dtype, D)
    want = {f"dq/{route}": 1, f"dkv/{route}": 1}
    if with_dbias:
        want[f"dbias/{route}"] = 1
    got = flash_bwd_route_delta(before)
    if got != want:
        fail(f"{tag}: launches by route {got}, expected {want}")


def check_flash_bwd(gen, dev):
    """K2/K3/K4 at the training step's shape in bf16 (checked and timed with
    the card ahead of the host, beside two SDPA backward yardsticks), then
    over the contract at small shapes on both routes."""
    B, H, S, D = TRAIN_BATCH, 12, 197, 64
    q, k, v, bias = flash_inputs(gen, dev, B, H, S, S, D, torch.bfloat16, (1, H, S, S))
    dout = torch.randn(B, H, S, D, generator=gen, device=dev).to(torch.bfloat16)
    out, lse = flash_attention_fwd(q, k, v, bias)
    before = dict(flash_attention_bwd.launches_by_route)
    got = flash_attention_bwd(q, k, v, bias, None, out, lse, dout)
    expect_flash_bwd_route("flash_attention_bwd main shape", before, torch.bfloat16, D, True)
    p_out, p_lse = flash_attention_reference(q, k, v, bias)
    plain = flash_attention_bwd_reference(q, k, v, bias, None, p_out, p_lse, dout)
    tq, tk, tv, tb, tdo = as_f32(q, k, v, bias, dout)
    t_out, t_lse = flash_attention_reference(tq, tk, tv, tb)
    truth = flash_attention_bwd_reference(tq, tk, tv, tb, None, t_out, t_lse, tdo)
    errs = {}
    for label, a, p, t in zip(("dq", "dk", "dv", "dbias"), got, plain, truth):
        errs[label] = rule_bf16(f"flash_attention_bwd {label} B{B} H{H} S{S} D{D} "
                                f"bias(1,H,S,S) bf16 ({flash_route(q.dtype, D)})", a, p, t)

    launch = _bwd_launchers(q, k, v, bias, None, out, lse, dout, False, 1.0)
    # dBias sums the batch in a fixed order (no atomics): bit-identical run to run
    db1, db2 = launch["dbias"](), launch["dbias"]()
    same = torch.equal(db1, db2)
    log(f"check flash_attention_bwd dbias B{B} bit-identical across two launches: {same}")
    if not same:
        fail(f"flash_attention_bwd dbias: two launches differ by {max_err(db1, db2):.3e}")
    del db1, db2
    plain_ms = time_ms(lambda: flash_attention_bwd_reference(q, k, v, bias, None, out, lse,
                                                             dout), inner=2, reps=5,
                       host_ahead=True)
    lib_all = _sdpa_bwd_ms(q, k, v, bias, dout, 1.0, host_ahead=True)
    lib_qkv = _sdpa_bwd_ms(q, k, v, bias, dout, 1.0, host_ahead=True, mask_grad=False)
    read = nbytes(q, k, v, dout, bias, lse) + lse.numel() * 4   # + delta
    ops = float(B * H * S * S * D)
    shape = f"B{B} H{H} S{S} D{D} bias(1,{H},{S},{S}) bf16"
    entries, ms_of = [], {}
    for name, kern, wbytes, flops, err in (
            ("flash_attention_bwd_dq", "dq", nbytes(q), 6 * ops, errs["dq"]),
            ("flash_attention_bwd_dkv", "dkv", nbytes(k, v), 8 * ops,
             max(errs["dk"], errs["dv"])),
            ("flash_attention_bwd_dbias", "dbias", H * S * S * 4, 4 * ops, errs["dbias"])):
        ms_of[kern] = ms = time_ms(launch[kern], host_ahead=True)
        b_ms, b_by = bound_ms(read + wbytes, flops)
        lib_ms, lib_cover = (lib_all, "dq+dk+dv+dbias") if kern == "dbias" else \
            (lib_qkv, "dq+dk+dv")
        log(f"time {name}: kernel {ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        entries.append(dict(
            name=name, shape=shape, route="cuda",
            source="x2vlm_tpu_torch/csrc/flash_attention_bwd.cu",
            replaces=FLASH_BWD_REPLACES[kern], max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
            plain_and_library_cover=f"plain: dq+dk+dv+dbias; library: {lib_cover}",
            flash_route=flash_route(q.dtype, D)))
    fmt = lambda x: x if x is None else round(x, 4)
    log(f"time flash_attention_bwd plain (all three) {plain_ms:.4f} ms, sdpa backward "
        f"dq+dk+dv {fmt(lib_qkv)} ms, dq+dk+dv+dbias {fmt(lib_all)} ms")
    if lib_qkv:
        log(f"flash backward K2 + K3 {ms_of['dq'] + ms_of['dkv']:.4f} ms against sdpa "
            f"backward dq+dk+dv {lib_qkv:.4f} ms: factor "
            f"{(ms_of['dq'] + ms_of['dkv']) / lib_qkv:.3f}")

    # the rest of the contract, at small shapes, with scale = D^-0.5: bf16
    # at D = 64 on the tensor cores (D = 128 / 192 / 256 on the CUDA cores),
    # fp32 on the CUDA cores
    for name, (B, H, Sq, Skv, D, bias_shape, masked, causal, f32_bias) in {
        "bias(B,H) D128": (3, 2, 150, 150, 128, (3, 2, 150, 150), False, False, False),
        "bias(1,1) D256 130x129": (2, 3, 130, 129, 256, (1, 1, 130, 129), False, False, False),
        "key_mask+fully_masked_row D192": (3, 2, 130, 130, 192, None, True, False, False),
        "causal bias(1,H)": (2, 3, 200, 200, 64, (1, 3, 200, 200), False, True, False),
        "cross Sq100 Skv300 key_mask": (2, 2, 100, 300, 64, None, True, False, False),
        "key_mask+fully_masked_row D64": (3, 2, 130, 130, 64, None, True, False, False),
        "ragged 130x129 bias(1,H) D64": (2, 3, 130, 129, 64, (1, 3, 130, 129), False, False,
                                         False),
        "bias(B,H) D64": (3, 2, 150, 150, 64, (3, 2, 150, 150), False, False, False),
        "bias(1,1) D64 70x129": (2, 2, 70, 129, 64, (1, 1, 70, 129), False, False, False),
        "fp32 bias(1,H) D64": (2, 2, 197, 197, 64, (1, 2, 197, 197), False, False, True),
        "fp32 bias(1,H) causal key_mask D64 150x160": (2, 2, 150, 160, 64, (1, 2, 150, 160),
                                                       True, True, True),
        "no bias D64": (2, 2, 197, 197, 64, None, False, False, False),
        "197x200 (off every tile) bias(1,H) key_mask D64": (2, 2, 197, 200, 64, (1, 2, 197, 200),
                                                            True, False, False),
        "causal Sq150 Skv100 (rows with no key) D64": (2, 2, 150, 100, 64, None, False, True,
                                                       False),
    }.items():
        km = None
        if masked:
            km = (torch.rand(B, Skv, generator=gen, device=dev) > 0.3).to(torch.int32)
            km[1] = 0
        sc = D ** -0.5
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, bias = flash_inputs(gen, dev, B, H, Sq, Skv, D, dtype, bias_shape)
            if f32_bias:
                bias = bias.float()
            dout = torch.randn(B, H, Sq, D, generator=gen, device=dev).to(dtype)
            out, lse = flash_attention_fwd(q, k, v, bias, km, causal, sc)
            tag = f"flash_attention_bwd {name} {str(dtype)[6:]} ({flash_route(dtype, D)})"
            before = dict(flash_attention_bwd.launches_by_route)
            got = flash_attention_bwd(q, k, v, bias, km, out, lse, dout, causal, sc)
            expect_flash_bwd_route(tag, before, dtype, D, bias is not None)
            tq, tk, tv, tb, tdo = as_f32(q, k, v, bias, dout)
            t_out, t_lse = flash_attention_reference(tq, tk, tv, tb, km, causal, sc)
            truth = flash_attention_bwd_reference(tq, tk, tv, tb, km, t_out, t_lse, tdo,
                                                  causal, sc)
            if dtype == torch.bfloat16:
                p_out, p_lse = flash_attention_reference(q, k, v, bias, km, causal, sc)
                plain = flash_attention_bwd_reference(q, k, v, bias, km, p_out, p_lse,
                                                      dout, causal, sc)
            for i, label in enumerate(("dq", "dk", "dv", "dbias")):
                if truth[i] is None:
                    continue
                if dtype == torch.bfloat16:
                    rule_bf16(f"{tag} {label}", got[i], plain[i], truth[i])
                else:
                    rule_f32(f"{tag} {label}", got[i], truth[i])
    return entries


def check_tiny_bwd(gen, dev):
    """K6 at the training step's three shapes in bf16 with key mask and
    dropout multiplier (checked and timed, the card running ahead of the
    host), then over the contract on both routes."""
    entries = []
    H, D = 12, 64
    scale = D ** -0.5
    for label, B, Sq, Skv in (("text self-attention", 2 * TRAIN_BATCH, TEXT_LEN, TEXT_LEN),
                              ("fusion self-attention", 4 * TRAIN_BATCH, TEXT_LEN, TEXT_LEN),
                              ("fusion cross-attention", 4 * TRAIN_BATCH, TEXT_LEN, 200)):
        q, k, v, km, dm = tiny_operands(gen, dev, B, Sq, Skv, H, D, torch.bfloat16, "pad",
                                        True)
        g = torch.randn(B, Sq, H * D, generator=gen, device=dev).to(torch.bfloat16)
        _, probs = tiny_attention_fwd(q, k, v, H, km, dm, scale, return_probs=True)
        before = dict(tiny_attention_bwd.launches_by_route)
        got = tiny_attention_bwd(q, k, v, probs, dm, g, H, scale)
        expect_route(f"tiny_attention_bwd {label}", tiny_attention_bwd, before,
                     torch.bfloat16, D)
        _, p_probs = tiny_attention_reference(q, k, v, H, km, dm, scale)
        plain = tiny_attention_bwd_reference(q, k, v, p_probs, dm, g, H, scale)
        tq, tk, tv, tg, tdm = as_f32(q, k, v, g, dm)
        _, t_probs = tiny_attention_reference(tq, tk, tv, H, km, tdm, scale)
        truth = tiny_attention_bwd_reference(tq, tk, tv, t_probs, tdm, tg, H, scale)
        err = max(rule_bf16(f"tiny_attention_bwd {lab} {label} B{B} {Sq}x{Skv} H{H} "
                            f"D{D} key_mask dropout bf16", a, p, t)
                  for lab, a, p, t in zip(("dq", "dk", "dv"), got, plain, truth))
        ms = time_ms(lambda: tiny_attention_bwd(q, k, v, probs, dm, g, H, scale),
                     host_ahead=True)
        plain_ms = time_ms(lambda: tiny_attention_bwd_reference(q, k, v, probs, dm, g, H,
                                                                scale), inner=3, reps=5,
                           host_ahead=True)
        views = [t.view(B, t.shape[1], H, D).transpose(1, 2) for t in (q, k, v)]
        lib_ms = _sdpa_bwd_ms(*views, (km != 0)[:, None, None, :],
                              g.view(B, Sq, H, D).transpose(1, 2), scale, host_ahead=True)
        b_ms, b_by = bound_ms(nbytes(q, k, v, g, probs, dm) + nbytes(q, k, v),
                              8.0 * B * H * Sq * Skv * D)
        log(f"time tiny_attention_bwd {label}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, sdpa backward {lib_ms} ms, bound {b_ms:.4f} ms ({b_by})")
        entries.append(tiny_entry(
            "tiny_attention_bwd", f"B{B} {Sq}x{Skv} H{H} D{D} key_mask dropout bf16",
            (B, Sq, Skv), err, ms, plain_ms, b_ms, b_by, lib_ms))

    for name, (B, Sq, Skv, H, D, mask, drop) in {
        "non-multiple-of-8 13x27 D32": (3, 13, 27, 4, 32, "half", True),
        "no mask 64x209 D64": (2, 64, 209, 2, 64, None, True),
        "1x7 D128 no dropout": (2, 1, 7, 3, 128, "half", False),
        "fully masked row 40x200 D64": (3, 40, 200, 2, 64, "full_row", True),
        "40x197 D64 (Skv off the 16-key tile)": (2, 40, 197, 3, 64, "half", True),
        "40x120 D128 fp32 multiplier": (2, 40, 120, 2, 128, "half", True),
        "80x50 D64 (two row tiles a warp)": (2, 80, 50, 2, 64, "half", True),
        # the other tensor-core head dims: one k-step, odd k-step counts, padded tiles
        "17x33 D16": (2, 17, 33, 3, 16, "half", True),
        "40x77 D48": (2, 40, 77, 2, 48, "full_row", True),
        "24x61 D96 no dropout": (2, 24, 61, 2, 96, "half", False),
        "9x45 D112": (2, 9, 45, 2, 112, "half", True),
        "5x9 D256": (2, 5, 9, 2, 256, "half", True),
    }.items():
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, km, dm = tiny_operands(gen, dev, B, Sq, Skv, H, D, dtype, mask, drop)
            if dm is not None:
                dm = torch.where(dm != 0, 1.25, 0.0).to(
                    torch.float32 if name.endswith("fp32 multiplier") else dtype)
            g = torch.randn(B, Sq, H * D, generator=gen, device=dev).to(dtype)
            _, probs = tiny_attention_fwd(q, k, v, H, km, dm, D ** -0.5, return_probs=True)
            before = dict(tiny_attention_bwd.launches_by_route)
            got = tiny_attention_bwd(q, k, v, probs, dm, g, H, D ** -0.5)
            tag = f"tiny_attention_bwd {name} {str(dtype)[6:]} ({tiny_route(dtype, D)})"
            expect_route(tag, tiny_attention_bwd, before, dtype, D)
            tq, tk, tv, tg, tdm = as_f32(q, k, v, g, dm)
            _, t_probs = tiny_attention_reference(tq, tk, tv, H, km, tdm, D ** -0.5)
            truth = tiny_attention_bwd_reference(tq, tk, tv, t_probs, tdm, tg, H, D ** -0.5)
            if dtype == torch.bfloat16:
                _, p_probs = tiny_attention_reference(q, k, v, H, km, dm, D ** -0.5)
                plain = tiny_attention_bwd_reference(q, k, v, p_probs, dm, g, H,
                                                     D ** -0.5)
            for i, label in enumerate(("dq", "dk", "dv")):
                if dtype == torch.bfloat16:
                    rule_bf16(f"{tag} {label}", got[i], plain[i], truth[i])
                else:
                    rule_f32(f"{tag} {label}", got[i], truth[i])
    return entries


def int8_inputs(gen, dev, lead, K, N, with_bias=True, dtype=torch.bfloat16):
    """Activations ~ N(0, 1) (a LayerNorm's output), an fp32 weight (N, K)
    ~ N(0, 0.02) quantized per output row, an fp32 bias."""
    x = torch.randn(*lead, K, generator=gen, device=dev).to(dtype)
    w = torch.randn(N, K, generator=gen, device=dev) * 0.02
    bias = torch.randn(N, generator=gen, device=dev) * 0.02 if with_bias else None
    wq, sw = quantize_weight(w)
    return x, w, wq, sw, bias


def rule_int8(name, got, plain, act) -> float:
    """K7 against its plain version: bit-equal without an activation; with
    one, within 1e-6 x max|out| in fp32, and within one bf16 ulp (2^-7 x
    max|out|) in bf16, where an fp32 difference of an ulp in the GELU can
    round the other way."""
    err = max_err(got, plain)
    if act is None:
        bound, ok = 0.0, got.shape == plain.shape and torch.equal(got, plain)
    else:
        scale = plain.float().abs().max().item()
        bound = (1e-6 if got.dtype == torch.float32 else 2.0 ** -7) * scale
        ok = got.shape == plain.shape and math.isfinite(err) and err <= bound
    log(f"check {name}: max_abs_err={err:.3e} bound={bound:.3e} {'OK' if ok else 'FAIL'}")
    if not ok:
        fail(f"{name}: error {err:.3e} above {bound:.3e} (or shapes differ)")
    return err


def check_quantized(name, xq, sx, x) -> bool:
    p_xq, p_sx = quantize_act_reference(x)
    ok = (xq.shape == p_xq.shape and sx.shape == p_sx.shape
          and torch.equal(xq, p_xq) and torch.equal(sx, p_sx))
    n_diff = int((xq != p_xq).sum()) if xq.shape == p_xq.shape else -1
    log(f"check int8 quantize {name}: xq / sx bit-equal: {ok} ({n_diff} int8 values differ)")
    if not ok:
        fail(f"int8 quantize {name}: (xq, sx) differ from the plain version")
    return ok


def _int_mm_ms(xq, wq):
    """cuBLASLt's int8 product (int32 out, no epilogue) through
    ``torch._int_mm`` on the same operands: a yardstick only, the port
    never calls it. Returns ms or None with the reason logged."""
    try:
        torch._int_mm(xq, wq.t())
        return time_ms(lambda: torch._int_mm(xq, wq.t()), host_ahead=True)
    except RuntimeError as e:
        log(f"torch._int_mm not timed: {str(e).splitlines()[0][:200]}")
        return None


def check_int8(gen, dev):
    """K7 at every shape of the int8 serving path, bf16 in (checked and
    timed), then over the contract at small shapes. Returns the entries of
    the GEMM kernel by (M, K, N) and of the quantize kernel by (M, K)."""
    gemm_entries, quant_entries = [], {}
    for label, M, K, N, act in INT8_SHAPES:
        x, w, wq, sw, bias = int8_inputs(gen, dev, (M,), K, N)
        xq, sx = quantize_act(x)
        q_ok = check_quantized(f"{label} M{M} K{K}", xq, sx, x)
        errs = []
        for out_dtype in (torch.bfloat16, torch.float32):
            got = int8_matmul(x, wq, sw, bias, act=act, out_dtype=out_dtype, xq=xq, sx=sx)
            plain = int8_matmul_reference(x, wq, sw, bias, act=act, out_dtype=out_dtype,
                                          xq=xq, sx=sx)
            errs.append(rule_int8(f"int8_matmul {label} M{M} K{K} N{N} act={act} "
                                  f"out {str(out_dtype)[6:]}", got, plain, act))
        ms = time_ms(lambda: int8_matmul(x, wq, sw, bias, act=act, xq=xq, sx=sx),
                     host_ahead=True)
        plain_ms = time_ms(lambda: int8_matmul_reference(x, wq, sw, bias, act=act, xq=xq,
                                                         sx=sx), inner=2, reps=5,
                           host_ahead=True)
        lib_ms = _int_mm_ms(xq, wq)
        wb, bb = w.to(torch.bfloat16), bias.to(torch.bfloat16)
        lin_ms = time_ms(lambda: F.linear(x, wb, bb), host_ahead=True)
        b_ms, b_by = bound_ms(nbytes(xq, sx, wq, sw, bias) + 2 * M * N, 2.0 * M * N * K,
                              INT8_OP_PER_S)
        log(f"time int8_matmul {label} M{M} K{K} N{N}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, torch._int_mm {lib_ms} ms, bf16 F.linear {lin_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by})")
        gemm_entries.append(dict(
            name="int8_matmul", shape=f"{label} M{M} K{K} N{N} act={act} bf16 out",
            route="cuda", source="x2vlm_tpu_torch/csrc/int8_matmul.cu",
            replaces=INT8_REPLACES, key=(M, K, N), max_abs_err=max(errs), ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
            library="torch._int_mm (int32 product only)", bf16_linear_ms=lin_ms))
        if (M, K) not in quant_entries:
            q_ms = time_ms(lambda: quantize_act(x), host_ahead=True)
            qp_ms = time_ms(lambda: quantize_act_reference(x), inner=3, reps=5,
                            host_ahead=True)
            qb_ms, qb_by = bound_ms(nbytes(x, xq, sx), 4.0 * M * K, FP32_FLOP_PER_S)
            log(f"time int8 quantize M{M} K{K}: kernel {q_ms:.4f} ms, plain {qp_ms:.4f} ms, "
                f"bound {qb_ms:.4f} ms ({qb_by})")
            quant_entries[(M, K)] = dict(
                name="int8_quantize", shape=f"M{M} K{K} bf16", route="cuda",
                source="x2vlm_tpu_torch/csrc/int8_matmul.cu", replaces=INT8_REPLACES,
                key=(M, K), max_abs_err=0.0 if q_ok else float("nan"), ms=q_ms,
                plain_ms=qp_ms, bound_ms=qb_ms, bound_by=qb_by, library_ms=None)
        del x, w, wq, sw, bias, xq, sx, got, plain

    # the rest of the contract, at small shapes; here the wrapper quantizes
    # x itself (the path without a shared (xq, sx))
    bf, f32 = torch.bfloat16, torch.float32
    for name, (lead, K, N, act, with_bias, in_dt, out_dt) in {
        "M200 bias": ((200,), 768, 768, None, True, bf, bf),
        "M197 gelu_fast fp32 out": ((197,), 768, 3072, "gelu_fast", True, bf, f32),
        "3-D (4, 50) gelu": ((4, 50), 768, 768, "gelu", True, bf, bf),
        "no bias fp32 in and out": ((130,), 3072, 768, None, False, f32, f32),
        "zero rows and an outlier": ((64,), 768, 768, None, True, bf, bf),
        "N77 K784 gelu fp32 out": ((33,), 784, 77, "gelu", True, bf, f32),
        "M1 N130 gelu_fast fp32 in": ((1,), 64, 130, "gelu_fast", True, f32, bf),
    }.items():
        x, _, wq, sw, bias = int8_inputs(gen, dev, lead, K, N, with_bias, in_dt)
        if name.startswith("zero rows"):
            x[::7] = 0.0
            x[3, 5] = 1000.0
        xq, sx = quantize_act(x)
        check_quantized(name, xq, sx, x)
        got = int8_matmul(x, wq, sw, bias, act=act, out_dtype=out_dt)
        plain = int8_matmul_reference(x, wq, sw, bias, act=act, out_dtype=out_dt)
        rule_int8(f"int8_matmul {name} {tuple(lead)} K{K} N{N} act={act}", got, plain, act)
        if name.startswith("zero rows"):
            zero_ok = bool((xq[::7] == 0).all()) and bool(
                (sx[::7] == int8_scale(torch.zeros((), device=dev))).all())
            if not zero_ok:
                fail("int8 quantize: an all-zero row is not xq = 0, sx = 1e-6 / 127")
    return gemm_entries, list(quant_entries.values())


def reset_counts() -> None:
    flash_attention_fwd.launches = 0
    flash_attention_fwd.launches_by_route.clear()
    flash_attention_bwd.launches.clear()
    flash_attention_bwd.launches_by_route.clear()
    for fn in (tiny_attention_fwd, tiny_attention_bwd, int8_matmul, quantize_act):
        fn.launches = 0
        fn.launches_by_shape.clear()
    for fn in (tiny_attention_fwd, tiny_attention_bwd):
        fn.launches_by_route.clear()


def train_counts():
    """Launches of every kernel since the last reset: flash by kernel, tiny
    by (B, Sq, Skv)."""
    return {"flash_attention_fwd": flash_attention_fwd.launches,
            **{f"flash_attention_bwd_{k}": flash_attention_bwd.launches[k]
               for k in ("dq", "dkv", "dbias")},
            "tiny_attention_fwd": collections.Counter(tiny_attention_fwd.launches_by_shape),
            "tiny_attention_bwd": collections.Counter(tiny_attention_bwd.launches_by_shape),
            "tiny_routes": {"tiny_attention_fwd": dict(tiny_attention_fwd.launches_by_route),
                            "tiny_attention_bwd": dict(tiny_attention_bwd.launches_by_route)},
            "flash_fwd_routes": dict(flash_attention_fwd.launches_by_route),
            "flash_bwd_routes": flash_bwd_route_delta({})}


def counts():
    """(flash, tiny, int8 GEMM, int8 quantize) launches since the last reset."""
    return (flash_attention_fwd.launches, tiny_attention_fwd.launches,
            int8_matmul.launches, quantize_act.launches)


def serve(server, images, ids, atts):
    """The main path, one request of each program; the launch counts are
    set to 0 just before each request and read just after it. Returns the
    outputs, the counts of each request and the launches by shape of the
    tiny and the two int8 kernels over the three."""
    per_request = {}
    by_shape = {"tiny": collections.Counter(), "int8_matmul": collections.Counter(),
                "int8_quantize": collections.Counter(), "tiny_route": collections.Counter(),
                "flash_route": collections.Counter()}

    def run(name, fn, *inputs):
        reset_counts()
        out = fn(*inputs)
        torch.cuda.synchronize()
        per_request[name] = counts()
        by_shape["tiny"].update(tiny_attention_fwd.launches_by_shape)
        by_shape["tiny_route"].update(tiny_attention_fwd.launches_by_route)
        by_shape["flash_route"].update(flash_attention_fwd.launches_by_route)
        by_shape["int8_matmul"].update(int8_matmul.launches_by_shape)
        by_shape["int8_quantize"].update(quantize_act.launches_by_shape)
        return out

    img_embeds, img_feat = run("encode_images", server.encode_images, images)
    txt_embeds, txt_feat = run("encode_texts", server.encode_texts, ids, atts)
    scores = run("itm_score", server.itm_score, img_embeds, txt_embeds, atts)
    return (img_embeds, img_feat, txt_embeds, txt_feat, scores), per_request, by_shape


def want_launches(cfg, quant: bool):
    """(flash, tiny, int8 GEMM, int8 quantize) launches of each request.
    X2VLM-base: 12 BEiT-2 blocks (int8: fused qkv, proj, fc1, fc2, each
    quantizing its input); 12 text layers (q/k/v sharing one quantization,
    out, fc1, fc2); 6 fusion layers with a self- and a cross-attention each
    (q/k/v, out twice, the cross K/V source quantized once, fc1, fc2)."""
    depth, n_text = cfg.vision.depth, cfg.text.fusion_layer
    n_fusion = cfg.text.num_layers - cfg.text.fusion_layer
    q = int(quant)
    return {"encode_images": (depth, 0, 4 * depth * q, 4 * depth * q),
            "encode_texts": (0, n_text, 6 * n_text * q, 4 * n_text * q),
            "itm_score": (0, 2 * n_fusion, 10 * n_fusion * q, 7 * n_fusion * q)}


def check_flash_fwd_routes(tag, routes, n) -> None:
    """The ``n`` K1 launches of a main path all took the tensor-core route."""
    log(f"flash forward launches by route ({tag}): {json.dumps(routes)}")
    if routes != {TENSOR_CORE: n}:
        fail(f"{tag}: flash_attention_fwd launches by route {routes}, expected "
             f"{ {TENSOR_CORE: n} }")


def check_tiny_routes(tag, routes) -> None:
    """Every K5 / K6 launch of a main path took the tensor-core route."""
    log(f"tiny launches by route ({tag}): {json.dumps(routes)}")
    for name, by_route in routes.items():
        if not by_route or set(by_route) != {TENSOR_CORE}:
            fail(f"{tag}: {name} launches by route {by_route}, expected {TENSOR_CORE} only")


def check_round(tag, cfg, outs, per_request, want) -> None:
    """Launches, shapes and finiteness of one round of requests."""
    log(f"launches per request ({tag}; flash, tiny, int8 GEMM, int8 quantize): "
        f"{json.dumps(per_request)}")
    for req, n in want.items():
        if tuple(per_request[req]) != n:
            fail(f"{tag} {req}: launches {per_request[req]}, expected {n}")
    img_embeds, img_feat, txt_embeds, txt_feat, scores = outs
    n_img = cfg.vision.num_patches + 1
    expect_shapes = {"image_embeds": (img_embeds, (BATCH, n_img, cfg.vision.embed_dim)),
                     "image_feat": (img_feat, (BATCH, cfg.embed_dim)),
                     "text_embeds": (txt_embeds, (BATCH, TEXT_LEN, cfg.text.hidden_size)),
                     "text_feat": (txt_feat, (BATCH, cfg.embed_dim)),
                     "itm_score": (scores, (BATCH,))}
    for name, (t, shape) in expect_shapes.items():
        if tuple(t.shape) != shape or not bool(torch.isfinite(t).all()):
            fail(f"{tag} {name}: shape {tuple(t.shape)} (want {shape}), "
                 f"finite={bool(torch.isfinite(t).all())}")
    log(f"peak device memory of one round of requests ({tag}): "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def time_requests(server, requests, outs):
    images, ids, atts = requests
    img_embeds, _, txt_embeds = outs[:3]
    return {
        "encode_images": time_ms(lambda: server.encode_images(images), inner=1, reps=5),
        "encode_texts": time_ms(lambda: server.encode_texts(ids, atts), inner=1, reps=5),
        "itm_score": time_ms(lambda: server.itm_score(img_embeds, txt_embeds, atts),
                             inner=1, reps=5),
    }


# kernel symbols of each wrapper in a profile (tensor-core route first)
KERNEL_NAMES = {"flash_attention_fwd": ("flash_fwd_kernel",),
                "tiny_attention_fwd": ("tc::fwd_kernel", "tiny_fwd_kernel"),
                "tiny_attention_bwd": ("tc::bwd_kernel", "tiny_bwd_kernel"),
                "flash_attention_bwd_dq": ("tc::dq_kernel", "flash_bwd_dq_kernel"),
                "flash_attention_bwd_dkv": ("tc::dkv_kernel", "flash_bwd_dkv_kernel"),
                "flash_attention_bwd_dbias": ("tc::dbias_kernel", "tc::dbias_sum_kernel",
                                              "flash_bwd_dbias_kernel")}


def write_profile(args, smi, prof, fname, rows) -> None:
    """The profiler table and the attention kernels' device time (both
    routes) to ``args.profile/fname``; both logged."""
    averages = prof.key_averages()
    kernels = {}
    for e in averages:
        for name, symbols in KERNEL_NAMES.items():
            if any(sym in e.key for sym in symbols):
                t = kernels.setdefault(name, {"device_ms": 0.0, "launches": 0})
                t["device_ms"] += getattr(e, "self_device_time_total",
                                          getattr(e, "self_cuda_time_total", 0.0)) / 1e3
                t["launches"] += e.count
    tiny_line = f"attention kernels in this profile ({fname}): {json.dumps(kernels)}"
    table = averages.table(sort_by="cuda_time_total", row_limit=rows)
    os.makedirs(args.profile, exist_ok=True)
    with open(os.path.join(args.profile, fname), "w") as f:
        f.write(f"{smi}\n{table}\n{tiny_line}\n")
    log(table[:8000])
    log(tiny_line)


def profile_round(args, smi, server, requests, fname) -> None:
    if not args.profile:
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        serve(server, *requests)
    write_profile(args, smi, prof, fname, 30)


def against_cpu(tag, cfg, cpu_state, outs, requests, n: int = 2) -> None:
    """The same weights on the port's CPU path in fp32 for ``n`` rows:
    feature cosine >= 0.99, ITM error <= 0.05 + 5% of the score scale."""
    images, ids, atts = (t[:n].cpu() for t in requests)
    cpu_model = XVLMForRetrieval(cfg, dtype=torch.float32, device="cpu", seed=None)
    cpu_model.load_state_dict(cpu_state)
    with torch.inference_mode():
        c_img, c_ifeat = cpu_model.encode_images(images)
        c_txt, c_tfeat = cpu_model.encode_texts(ids, atts)
        c_score = cpu_model.itm_score(c_img, c_txt, atts)
    e2e = {}
    for name, card, ref in zip(("image_embeds", "image_feat", "text_embeds", "text_feat",
                                "itm_score"), outs, (c_img, c_ifeat, c_txt, c_tfeat, c_score)):
        card = card[:n].float().cpu()
        e2e[name] = {"max_abs_err": max_err(card, ref),
                     "max_abs_ref": ref.abs().max().item()}
        if name.endswith("feat"):
            e2e[name]["min_cosine"] = F.cosine_similarity(card, ref, dim=-1).min().item()
    log(f"{tag} vs CPU fp32 ({n} rows): {json.dumps(e2e)}")
    for name in ("image_feat", "text_feat"):
        if not e2e[name]["min_cosine"] >= 0.99:
            fail(f"{tag} {name}: cosine to the fp32 CPU path "
                 f"{e2e[name]['min_cosine']:.5f} < 0.99")
    itm = e2e["itm_score"]
    if not itm["max_abs_err"] <= 0.05 + 0.05 * itm["max_abs_ref"]:
        fail(f"{tag} itm_score: error to the fp32 CPU path {itm['max_abs_err']:.4f}")


def int8_phase(args, dev, state, cpu_state, requests, smi):
    """The int8 serving path (bench.py's X2VLM_BENCH=int8 variant: quant_int8
    and the tanh GELU on both towers) with the bf16 phase's weights, beside
    the bf16 model with the same weights and GELU. Returns the launches of
    each int8 request and by shape."""
    base = XVLMConfig.base()

    def variant(quant):
        return dataclasses.replace(
            base, vision=dataclasses.replace(base.vision, act="gelu_fast", quant_int8=quant),
            text=dataclasses.replace(base.text, act="gelu_fast", quant_int8=quant))

    qcfg = variant(True)
    servers = {}
    for tag, cfg in (("int8", qcfg), ("bf16 gelu_fast", variant(False))):
        m = XVLMForRetrieval(cfg, dtype=torch.bfloat16, device=dev, seed=None)
        m.load_state_dict(state)
        servers[tag] = RetrievalServer(m)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    outs, per_request, by_shape = serve(servers["int8"], *requests)
    check_round("int8", qcfg, outs, per_request, want_launches(qcfg, quant=True))
    check_tiny_routes("int8 serving", {"tiny_attention_fwd": dict(by_shape["tiny_route"])})
    check_flash_fwd_routes("int8 serving", dict(by_shape["flash_route"]), qcfg.vision.depth)

    # int8 against bf16, the same weights and GELU, every row
    f_outs, _, _ = serve(servers["bf16 gelu_fast"], *requests)
    cmp = {name: F.cosine_similarity(outs[i].float(), f_outs[i].float(), dim=-1).min().item()
           for i, name in ((1, "image_feat"), (3, "text_feat"))}
    cmp["itm_max_abs_diff"] = max_err(outs[4], f_outs[4])
    cmp["itm_max_abs_bf16"] = f_outs[4].abs().max().item()
    log(f"card int8 vs card bf16 (same weights, gelu_fast, {BATCH} rows): {json.dumps(cmp)}")
    for name in ("image_feat", "text_feat"):
        if not cmp[name] >= 0.99:
            fail(f"int8 {name}: min cosine to the bf16 path {cmp[name]:.5f} < 0.99")

    # requests timed in turns: int8, bf16, bf16, int8
    times = collections.defaultdict(list)
    for tag in ("int8", "bf16 gelu_fast", "bf16 gelu_fast", "int8"):
        for req, ms in time_requests(servers[tag], requests,
                                     outs if tag == "int8" else f_outs).items():
            times[(tag, req)].append(ms)
    req_ms = {f"{tag} {req}": [round(x, 3) for x in v] for (tag, req), v in times.items()}
    log(f"request ms (B={BATCH}, CUDA events, median of 5 in each of two turns, in the "
        f"order int8, bf16, bf16, int8; both with gelu_fast): {json.dumps(req_ms)}")
    profile_round(args, smi, servers["int8"], requests, "chip_smoke_int8_profile.txt")

    against_cpu("card int8", qcfg, cpu_state, outs, requests)
    del servers, outs, f_outs
    return per_request, by_shape


def train_batch(gen, dev, cfg, B):
    """A pretraining batch as bench.py's: uint8 images, 40-token texts of
    lengths 5-40 (row 0 full), 12 masked positions inside each text."""
    res, V = cfg.vision.image_res, cfg.text.vocab_size
    lens = torch.randint(5, TEXT_LEN + 1, (B,), generator=gen, device=dev)
    lens[0] = TEXT_LEN
    atts = (torch.arange(TEXT_LEN, device=dev)[None] < lens[:, None]).to(torch.int32)
    ids = torch.randint(1, V, (B, TEXT_LEN), generator=gen, device=dev) * atts
    pos = (torch.rand(B, N_MASKED, generator=gen, device=dev) * lens[:, None]).long()
    masked = ids.scatter(1, pos, 103)                       # [MASK]
    return {"image": torch.randint(0, 256, (B, res, res, 3), generator=gen,
                                   device=dev).to(torch.uint8),
            "text_ids": ids, "text_atts": atts, "text_ids_masked": masked,
            "masked_pos": pos, "masked_ids": torch.gather(ids, 1, pos)}


def cosine_params(cfg):
    """Gradients held to the CPU path: through K2/K3 (qkv), K4 (the rel-pos
    table), K6 in a text and a fusion cross-attention layer, the tied MLM
    decoder and ITC."""
    return ("base.vision_encoder.blocks.0.attn.qkv.weight",
            "base.vision_encoder.blocks.0.attn.relative_position_bias_table",
            "base.text_encoder.bert.encoder.layer.0.attention.self.query.weight",
            f"base.text_encoder.bert.encoder.layer.{cfg.text.fusion_layer}"
            ".crossattention.self.key.weight",
            "base.text_encoder.bert.embeddings.word_embeddings.weight",
            "base.temp")


def train_phase(args, dev, gen, smi):
    """The second main path: X2VLM-base pretraining steps (ITC + ITM + MLM,
    AdamW) at B=32 with the config's dropouts on. Returns the launches of
    one step by kernel."""
    cfg = XVLMConfig.base()
    t0 = time.perf_counter()
    model = XVLMForPretrain(cfg, dtype=torch.bfloat16, device=dev, seed=args.seed)
    opt = create_optimizer(model, lr_schedule(1e-4, 1000, 100),
                           labels=param_labels(model.named_parameters(),
                                               cfg.text.fusion_layer))
    step = make_train_step(model, opt)
    batch = train_batch(gen, dev, cfg, TRAIN_BATCH)
    itm_gen = torch.Generator(device=dev)
    itm_gen.manual_seed(args.seed + 1)
    drop_gen = torch.Generator(device=dev)
    drop_gen.manual_seed(args.seed + 2)
    torch.cuda.synchronize()
    log(f"train model: X2VLM-base pretrain, {sum(p.numel() for p in model.parameters())} "
        f"params, built in {time.perf_counter() - t0:.1f} s")

    # the main path: one step, the counts set to 0 just before and read after
    reset_counts()
    metrics = step(batch, itm_gen, drop_gen)
    torch.cuda.synchronize()
    launches = train_counts()
    shown = {k: v if isinstance(v, int) else {str(s): n for s, n in v.items()}
             for k, v in launches.items()}
    log(f"launches per train step: {json.dumps(shown)}")
    n_fusion = cfg.text.num_layers - cfg.text.fusion_layer
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
                 "flash_attention_bwd_dbias"):
        if launches[name] != cfg.vision.depth:
            fail(f"train step: {name} launched {launches[name]} times, "
                 f"expected {cfg.vision.depth}")
    n_img = cfg.vision.num_patches + 1
    n_img += -n_img % 8                  # the fusion pass pads the image stream
    want_tiny = {(2 * TRAIN_BATCH, TEXT_LEN, TEXT_LEN): cfg.text.fusion_layer,
                 (4 * TRAIN_BATCH, TEXT_LEN, TEXT_LEN): n_fusion,
                 (4 * TRAIN_BATCH, TEXT_LEN, n_img): n_fusion}
    for name in ("tiny_attention_fwd", "tiny_attention_bwd"):
        if dict(launches[name]) != want_tiny:
            fail(f"train step: {name} launches {dict(launches[name])}, expected {want_tiny}")
    check_tiny_routes("train step", launches["tiny_routes"])
    check_flash_fwd_routes("train step", launches["flash_fwd_routes"], cfg.vision.depth)
    want_routes = {f"{k}/{TENSOR_CORE}": cfg.vision.depth for k in ("dq", "dkv", "dbias")}
    if launches["flash_bwd_routes"] != want_routes:
        fail(f"train step: flash backward launches by route {launches['flash_bwd_routes']}, "
             f"expected {want_routes}")
    vals = {k: v.item() for k, v in metrics.items()}
    log(f"train step 1 metrics: {json.dumps(vals)}")
    if not all(math.isfinite(v) for v in vals.values()):
        fail(f"train step: non-finite metrics {vals}")

    # step time: 2 warm-up steps, then the median of 7, CUDA events
    for _ in range(2):
        step(batch, itm_gen, drop_gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for _ in range(7):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        m = step(batch, itm_gen, drop_gen)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        losses.append(m["loss_total"].item())
    step_ms = statistics.median(times)
    log(f"train step ms (B={TRAIN_BATCH}, CUDA events, median of 7 after 2 warm-up): "
        f"{step_ms:.3f} [{min(times):.3f}-{max(times):.3f}]; samples/s "
        f"{TRAIN_BATCH / step_ms * 1e3:.1f}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; loss_total per step "
        f"{[round(x, 4) for x in losses]}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"train steps: non-finite loss_total {losses}")

    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step(batch, itm_gen, drop_gen)
            torch.cuda.synchronize()
        write_profile(args, smi, prof, "chip_smoke_train_profile.txt", 40)

    # the same weights, dropout off, B=2, injected negatives: card bf16
    # against the port's CPU fp32 path, losses and gradients
    n = 2
    small = {k: v[:n] for k, v in batch.items()}
    neg = (torch.tensor([1, 0]), torch.tensor([1, 0]))
    cpu_model = XVLMForPretrain(cfg, dtype=torch.float32, device="cpu", seed=None)
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    grads, card_losses = {}, {}
    for tag, m, b, ng in (("card", model, small, tuple(t.to(dev) for t in neg)),
                          ("cpu", cpu_model, {k: v.cpu() for k, v in small.items()}, neg)):
        m.eval()
        m.zero_grad(set_to_none=True)
        losses = m(b, neg_idx=ng)
        sum(losses.values()).backward()
        card_losses[tag] = {k: v.item() for k, v in losses.items()}
        params = dict(m.named_parameters())
        grads[tag] = {k: params[k].grad.detach().double().cpu().reshape(-1)
                      for k in cosine_params(cfg)}
    cos = {k: F.cosine_similarity(grads["card"][k], grads["cpu"][k], dim=0).item()
           for k in cosine_params(cfg)}
    log(f"train card bf16 vs CPU fp32 (B={n}, dropout off, injected negatives): losses "
        f"{json.dumps(card_losses)}; gradient cosine {json.dumps(cos)}")
    for k, c in cos.items():
        if not c >= 0.99:
            fail(f"train gradient {k}: cosine to the fp32 CPU path {c:.5f} < 0.99")
    for k, ref in card_losses["cpu"].items():
        if not abs(card_losses["card"][k] - ref) <= 0.05 + 0.02 * abs(ref):
            fail(f"train {k}: card {card_losses['card'][k]:.5f} vs CPU fp32 {ref:.5f}")
    del model, opt, cpu_model
    torch.cuda.empty_cache()
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", metavar="DIR",
                    help="write torch.profiler tables of one round of requests and "
                         "one train step to DIR")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this script runs the port "
              "on the GPU", file=sys.stderr)
        return 2
    return run(args, torch.device("cuda", 0))


def run(args, dev: torch.device) -> int:
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    log(smi)

    secs = _build.build()
    log(f"build: {json.dumps({k: round(v, 1) for k, v in secs.items()})}")
    for name in _build.KERNELS:
        log(f"ptxas {name}:\n{_build.ptxas_report(name)}")

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    with torch.inference_mode():
        flash_entries = check_flash(gen, dev)
        check_tiny_rules()
        tiny_entries = check_tiny(gen, dev)
    with torch.no_grad():
        check_flash_bwd_rules()
        flash_bwd_entries = check_flash_bwd(gen, dev)
        tiny_bwd_entries = check_tiny_bwd(gen, dev)
    torch.cuda.empty_cache()

    # ---- the main path: X2VLM-base retrieval serving at full width ----
    cfg = XVLMConfig.base()
    t0 = time.perf_counter()
    model = XVLMForRetrieval(cfg, dtype=torch.bfloat16, device=dev, seed=args.seed)
    server = RetrievalServer(model)
    res = cfg.vision.image_res
    images = torch.randint(0, 256, (BATCH, res, res, 3), generator=gen,
                           device=dev).to(torch.uint8)
    ids = torch.randint(1, cfg.text.vocab_size, (BATCH, TEXT_LEN), generator=gen,
                        device=dev)
    lens = torch.randint(5, TEXT_LEN + 1, (BATCH,), generator=gen, device=dev)
    lens[0] = TEXT_LEN
    atts = (torch.arange(TEXT_LEN, device=dev)[None] < lens[:, None]).to(torch.int32)
    ids = ids * atts
    requests = (images, ids, atts)
    torch.cuda.synchronize()
    log(f"model: X2VLM-base 224px, {sum(p.numel() for p in model.parameters())} "
        f"params, built in {time.perf_counter() - t0:.1f} s")

    torch.cuda.reset_peak_memory_stats()
    outs, per_request, by_shape = serve(server, *requests)
    check_round("bf16", cfg, outs, per_request, want_launches(cfg, quant=False))
    check_tiny_routes("bf16 serving", {"tiny_attention_fwd": dict(by_shape["tiny_route"])})
    check_flash_fwd_routes("bf16 serving", dict(by_shape["flash_route"]), cfg.vision.depth)
    req_ms = time_requests(server, requests, outs)
    log(f"request ms (B={BATCH}, CUDA events, median of 5): "
        f"{json.dumps({k: round(v, 3) for k, v in req_ms.items()})}")
    log(f"throughput: images/s {BATCH / req_ms['encode_images'] * 1e3:.1f}, "
        f"texts/s {BATCH / req_ms['encode_texts'] * 1e3:.1f}, "
        f"itm pairs/s {BATCH / req_ms['itm_score'] * 1e3:.1f}, encode pairs/s "
        f"{BATCH / (req_ms['encode_images'] + req_ms['encode_texts']) * 1e3:.1f}")
    profile_round(args, smi, server, requests, "chip_smoke_profile.txt")

    # ---- the same weights on the port's CPU path, fp32, 2 rows ----
    state = model.state_dict()
    cpu_state = {k: v.cpu() for k, v in state.items()}
    against_cpu("card bf16", cfg, cpu_state, outs, requests)
    del server, model, outs
    torch.cuda.empty_cache()

    # ---- the int8 serving path, the same weights ----
    with torch.inference_mode():
        int8_gemm_entries, int8_quant_entries = check_int8(gen, dev)
    torch.cuda.empty_cache()
    q_per_request, q_by_shape = int8_phase(args, dev, state, cpu_state, requests, smi)
    del state, cpu_state
    torch.cuda.empty_cache()

    # ---- the second main path: X2VLM-base pretraining steps ----
    train = train_phase(args, dev, gen, smi)

    # launches on the main paths: bf16 serving requests, one train step,
    # int8 serving requests
    def entry(e, serving, training, int8=0):
        e = {k: v for k, v in e.items() if k != "key"}
        return dict(e, launches=serving + training + int8,
                    launches_by_path={"serving": serving, "train_step": training,
                                      "int8_serving": int8})

    kernels = []
    for e in flash_entries:   # B=128 on the serving paths, B=32 in the train step
        serving = e.pop("path") == "serving"
        kernels.append(entry(e, sum(p[0] for p in per_request.values()) if serving else 0,
                             0 if serving else train["flash_attention_fwd"],
                             sum(p[0] for p in q_per_request.values()) if serving else 0))
    for e in tiny_entries:
        serving = e.pop("main_path_launches") == "all"
        kernels.append(entry(e, by_shape["tiny"][e["key"]] if serving else 0,
                             train["tiny_attention_fwd"][e["key"]],
                             q_by_shape["tiny"][e["key"]] if serving else 0))
    for e in flash_bwd_entries:
        kernels.append(entry(e, 0, train[e["name"]]))
    for e in tiny_bwd_entries:
        kernels.append(entry(e, 0, train["tiny_attention_bwd"][e["key"]]))
    for e in int8_gemm_entries:
        kernels.append(entry(e, 0, 0, q_by_shape["int8_matmul"][e["key"]]))
    for e in int8_quant_entries:
        kernels.append(entry(e, 0, 0, q_by_shape["int8_quantize"][e["key"]]))
    for e in kernels:
        if e["launches"] == 0:
            fail(f"{e['name']} ({e['shape']}) was not launched on the main path")
    log(f"seconds: {time.perf_counter() - t_start:.1f}")
    if FAILURES:
        log(f"chip_smoke: {len(FAILURES)} failure(s): {FAILURES}")
        return 1
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0

if __name__ == "__main__":
    sys.exit(main())
