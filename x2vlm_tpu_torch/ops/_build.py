"""Build, load and guard the hand-written CUDA kernels (``x2vlm_tpu_torch/csrc``).

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
its own shared library with a plain C interface and loaded with ``ctypes``.
A library is named by a hash of its source, the shared headers and the
flags, under ``build/x2vlm_tpu_torch/`` at the repository root, so an
unchanged kernel is compiled once per checkout. Nothing is built at import
time: the first launch builds what it needs, and :func:`build` compiles
several kernels at once, one ``nvcc`` process each, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

__all__ = ["CUDA_CORE", "DTYPE_CODES", "KERNELS", "OPERAND_KINDS", "ROUTE_CODES", "TENSOR_CORE",
           "aligned", "build", "check", "load", "nvcc_path", "ptxas_report", "typed"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "x2vlm_tpu_torch"
KERNELS = ("flash_attention_fwd", "flash_attention_bwd", "tiny_attention_fwd",
           "tiny_attention_bwd", "int8_matmul")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo")
# Codes of the C interface (csrc/common.cuh): the element type of q/k/v/out
# (x2::DType) and the type of an optional operand (x2::OperandKind; 0 = absent).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
OPERAND_KINDS = {torch.float32: 1, torch.bfloat16: 2}
# The two kernels of an attention op that has a route rule (x2::TinyRoute):
# fp32 arithmetic on the CUDA cores, or bf16 mma.sync on the tensor cores.
CUDA_CORE, TENSOR_CORE = "cuda_core", "tensor_core"
ROUTE_CODES = {CUDA_CORE: 0, TENSOR_CORE: 1}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "",
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin); "
        "the CUDA kernels are compiled on the machine with the card")


def _lib_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    if not src.is_file():
        raise FileNotFoundError(f"kernel source {src} is missing")
    h = hashlib.sha256()
    for part in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(part.name.encode())
        h.update(part.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile the named kernels that are not built yet, in parallel.

    Returns the seconds each compile took (0.0 for one already built).
    Raises with nvcc's output if any compile fails. The compiler is looked
    up once a call, at the first kernel that needs it, and not at all when
    every library is built: each lookup may find another file, and one
    that is rewritten between two lookups must not reach a compile that
    is already reading it."""
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    secs: Dict[str, float] = {}
    nvcc = None
    for name in names:
        out = _lib_path(name)
        if out.is_file():
            secs[name] = 0.0
            continue
        nvcc = nvcc or nvcc_path()
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failures = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"--- nvcc {name} (exit {proc.returncode}) ---\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return secs


def ptxas_report(name: str) -> str:
    """The registers / shared memory / spill lines ptxas printed for ``name``."""
    log = _lib_path(name).with_suffix(".log")
    if not log.is_file():
        return ""
    return "\n".join(line.strip() for line in log.read_text().splitlines()
                     if "Compiling entry" in line or "Used" in line or "spill" in line)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            lib.x2_error_string.argtypes = [ctypes.c_int]
            lib.x2_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def typed(lib: ctypes.CDLL, signatures) -> ctypes.CDLL:
    """``lib`` with the argument and result types of the C functions in
    ``signatures`` (name -> (argtypes, restype)) that it exports set, once
    per library: the library object itself carries the mark, so a new
    library is typed even if it reuses the address of one that was freed."""
    if not getattr(lib, "_x2_typed", False):
        for name, (argtypes, restype) in signatures.items():
            if hasattr(lib, name):
                getattr(lib, name).argtypes = argtypes
                getattr(lib, name).restype = restype
        lib._x2_typed = True
    return lib


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous, its data 16-byte aligned (the kernels' cp.async and
    vector loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error (its ``cudaGetLastError()``)."""
    if err != 0:
        msg = lib.x2_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{what} kernel failed: CUDA error {err} ({msg})")

