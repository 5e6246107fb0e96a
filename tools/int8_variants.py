#!/usr/bin/env python3
"""Time patched copies of K7, the int8 quantize and GEMM kernels
(``x2vlm_tpu_torch/csrc/int8_matmul.cu``), against the source as it stands,
on one NVIDIA GPU, at the eight GEMM shapes and five quantize shapes of the
int8 serving path at B=128 (``chip_smoke.INT8_SHAPES``: bf16 in and out,
the shape's bias and activation).

    python3 tools/int8_variants.py base stages_4 tanhf parent

Run from the repository root on a machine with the card and ``nvcc``. Each
variant named on the command line is the source with the text patches of
``VARIANTS`` applied (a patch whose text is not found exactly once stops the
script); ``parent`` is the kernel source of another tree instead, the one
unpacked under ``build/parent/`` (``git archive``), whose C entry points
take the same arguments. Every variant's library is built with the port's
own flags, all at once, and loaded in place of the port's. The script
prints each variant's ptxas lines, the card's name and power limit, and per
variant and shape the kernel's time (CUDA events, the card ahead of the
host) and its largest difference from the plain version (0 means bit-equal
where the shape has no activation), for two rounds, the second in the
reverse order of variants. ``PLANS`` gives the plan (``GEMM_PLAN``) each
variant's source fixes; ``tests/test_torch_int8_plan.py`` checks on the
CPU that every patch still applies and that every plan fits in one block's
shared memory.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from x2vlm_tpu_torch.ops import _build  # noqa: E402
from x2vlm_tpu_torch.ops import int8_matmul as im  # noqa: E402

SRC, COMMON = "int8_matmul.cu", "common.cuh"
PARENT_CSRC = Path(_build.BUILD_DIR).parent / "parent" / "x2vlm_tpu_torch" / "csrc"


def _const(name, old, new):
    return (f"constexpr {name} = {old};", f"constexpr {name} = {new};")


# name -> [(its text, the replacement)] in int8_matmul.cu
_TANH = "(1.0f + tanh_exp(0.7978845608028654f * (v + 0.044715f * v * v * v)))"
_ACT_HEAD = "template <int kAct>\n__device__ __forceinline__ float apply_act(float v) {"
VARIANTS = {
    "base": [],
    "stages_3": [_const("int kStages", 5, 3)],
    "stages_4": [_const("int kStages", 5, 4)],
    # 256-byte pieces of an output row staged at a time (half the named barriers); 4 stages fit
    "epi_256_stages_4": [_const("int kEpiBytes", 128, 256), _const("int kStages", 5, 4)],
    # the tanh GELU's cost: its tanh replaced by the identity (wrong results in fc1)
    "gelu_no_tanh": [(_TANH, "(1.0f + 0.7978845608028654f * (v + 0.044715f * v * v * v))")],
    # the tanh GELU with CUDA's tanhf (as the plain version's torch.tanh)
    "tanhf": [(_TANH, _TANH.replace("tanh_exp(", "tanhf("))],
    # the tanh GELU with the one-instruction tanh.approx.f32 (2^-11 relative error)
    "tanh_approx": [(_TANH, _TANH.replace("tanh_exp(", "tanh_approx(")),
                    (_ACT_HEAD,
                     "__device__ __forceinline__ float tanh_approx(float x) {\n"
                     "  float y;\n"
                     "  asm(\"tanh.approx.f32 %0, %1;\" : \"=f\"(y) : \"f\"(x));\n"
                     "  return y;\n"
                     "}\n\n" + _ACT_HEAD)],
}
# name -> the GEMM plan its source fixes (im.GEMM_PLAN's keys)
PLANS = {name: dict(im.GEMM_PLAN, **changes) for name, changes in {
    "base": {}, "stages_3": {"stages": 3}, "stages_4": {"stages": 4},
    "epi_256_stages_4": {"epi_bytes": 256, "stages": 4},
    "gelu_no_tanh": {}, "tanhf": {}, "tanh_approx": {}}.items()}


def patched_sources(name: str) -> dict:
    """{source file: its text} of variant ``name``: the kernel source with
    the variant's patches applied and the shared header, or the parent
    tree's two files for ``parent``."""
    if name == "parent":
        return {f: (PARENT_CSRC / f).read_text() for f in (SRC, COMMON)}
    srcs = {f: (_build.CSRC / f).read_text() for f in (SRC, COMMON)}
    for old, new in VARIANTS[name]:
        if srcs[SRC].count(old) != 1:
            raise RuntimeError(f"variant {name}: patch text found {srcs[SRC].count(old)} times "
                               f"in {SRC}, not once:\n{old}")
        srcs[SRC] = srcs[SRC].replace(old, new)
    return srcs


def build_variants(names):
    """Compile every variant's library at once; returns name -> library."""
    procs = {}
    for name in names:
        vdir = _build.BUILD_DIR / f"int8_variant_{name}"
        vdir.mkdir(parents=True, exist_ok=True)
        for fname, text in patched_sources(name).items():
            (vdir / fname).write_text(text)
        out = str(vdir / "int8_matmul.so")
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(vdir), "-o", out,
               str(vdir / SRC)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), out)
    libs = {}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        print(f"--- {name} rc={proc.returncode}")
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} failed to build:\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry" in line and ("gemm" in line or "quantize" in line):
                props = [x.strip() for x in lines[i + 1:i + 4] if "spill" in x or "Used" in x]
                print(f"{line.split('_Z')[-1][:60]}: " + " | ".join(props))
            elif "warning" in line.lower() or "Potential Performance" in line:
                print(line)
        lib = ctypes.CDLL(out)
        lib.x2_error_string.argtypes = [ctypes.c_int]
        lib.x2_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def main(names) -> int:
    unknown = [n for n in names if n not in VARIANTS and n != "parent"]
    if not names or unknown:
        print(f"int8_variants: name variants of {sorted(VARIANTS) + ['parent']}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("int8_variants: no CUDA device is visible", file=sys.stderr)
        return 2
    libs = build_variants(names)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip())
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    res = {}
    with torch.inference_mode():
        cases = []
        for label, M, K, N, act in cs.INT8_SHAPES:
            x, _, wq, sw, bias = cs.int8_inputs(gen, dev, (M,), K, N)
            xq, sx = im.quantize_act_reference(x)
            plain = im.int8_matmul_reference(x, wq, sw, bias, act=act, xq=xq, sx=sx)
            cases.append((label, M, K, N, act, x, wq, sw, bias, xq, sx, plain))
        for rnd in range(2):
            order = list(libs.items())
            for name, lib in order if rnd == 0 else order[::-1]:
                _build._LIBS["int8_matmul"] = lib
                quant_seen = set()
                for label, M, K, N, act, x, wq, sw, bias, xq, sx, plain in cases:
                    run = lambda: im.int8_matmul(x, wq, sw, bias, act=act, xq=xq, sx=sx)
                    ms = cs.time_ms(run, host_ahead=True)
                    res.setdefault((name, f"gemm {label}"), []).append(
                        (round(ms, 4), cs.max_err(run(), plain)))
                    if act is not None and rnd == 0:   # rule_int8's fp32 bound, 1e-6 x max|out|
                        got = im.int8_matmul(x, wq, sw, bias, act=act, out_dtype=torch.float32,
                                             xq=xq, sx=sx)
                        ref = im.int8_matmul_reference(x, wq, sw, bias, act=act,
                                                       out_dtype=torch.float32, xq=xq, sx=sx)
                        bound = 1e-6 * ref.abs().max().item()
                        print(f"{name} gemm {label} fp32 out: max_abs_err "
                              f"{cs.max_err(got, ref):.3e}, rule_int8 bound {bound:.3e}")
                    if (M, K) not in quant_seen:
                        quant_seen.add((M, K))
                        qms = cs.time_ms(lambda: im.quantize_act(x), host_ahead=True)
                        qx, qs = im.quantize_act(x)
                        same = torch.equal(qx, xq) and torch.equal(qs, sx)
                        res.setdefault((name, f"quantize M{M} K{K}"), []).append(
                            (round(qms, 4), 0.0 if same else float("nan")))
    for (name, what), runs in res.items():
        print(f"{name:17s} {what:28s} (ms, err vs plain) per round: {runs}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
