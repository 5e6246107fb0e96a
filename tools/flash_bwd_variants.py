#!/usr/bin/env python3
"""Time patched copies of the flash attention backward's tensor-core dQ and
dK/dV kernels (``x2vlm_tpu_torch/csrc/flash_attention_bwd.cu``) against the
source as it stands, on one NVIDIA GPU, at the training step's shape (B=32,
H=12, S=197, D=64, bf16), each with a bf16 bias (1, H, S, S), the same bias
in fp32 and no bias.

    python3 tools/flash_bwd_variants.py base exp2f min_blocks_2

Run from the repository root on a machine with the card and ``nvcc``. Each
variant named on the command line is the source with the text patches of
``VARIANTS`` applied (a patch whose text is not found exactly once stops the
script); every variant is built with the port's own flags, all at once, and
loaded in place of the kernel library. The script prints each variant's
ptxas lines of the tensor-core instances for a bf16 bias, the card's name
and power limit, and per variant and bias the dQ and dK/dV times (CUDA
events, the card ahead of the host) and the largest error against the plain
version, for two rounds (the second in the reverse order of variants).
``tests/test_torch_flash_route.py`` checks on the CPU that every patch
still applies to the source.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from x2vlm_tpu_torch.ops import _build  # noqa: E402
from x2vlm_tpu_torch.ops import flash_attention as fa  # noqa: E402

# name -> [(text of the source, its replacement)]
VARIANTS = {
    "base": [],
    # exp2f keeps results below 2^-126 that ex2.approx.ftz flushes to 0
    "exp2f": [('asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));', "y = exp2f(x);")],
    # fewer or more blocks an SM: the register cap of __launch_bounds__
    "min_blocks_2": [("constexpr int kMinBlocks = 3;", "constexpr int kMinBlocks = 2;")],
    "min_blocks_4": [("constexpr int kMinBlocks = 3;", "constexpr int kMinBlocks = 4;")],
    # the bias read per element from device memory (L2), not staged as tiles
    "bias_per_element": [
        ("    if constexpr (kBias != 0) {\n      const char* src",
         "    if constexpr (false) {\n      const char* src"),
        ("const float bv = kBias != 0 ? BT::at(Bt, rr[R], j, shift[R]) * kLog2e : 0.f;",
         "const float bv = kBias != 0 && kc < Skv && qr[R] < Sq ? x2::load_operand("
         "a.bias, kBias, bbase + qr[R] * a.bias_sq + kc) * kLog2e : 0.f;"),
        ("const float bv = kBias != 0 ? BT::at(Bt, j, kj[R], shift) * kLog2e : 0.f;",
         "const float bv = kBias != 0 && row_ok && kin[R] ? x2::load_operand("
         "a.bias, kBias, bbase + qr * a.bias_sq + kc[R]) * kLog2e : 0.f;"),
    ],
    # the key mask and causal tests made at run time in every instance, as
    # if there were no kMask instances without them
    "mask_runtime": [
        ("(!kMask || km == nullptr || km[kc] != 0)", "(km == nullptr || km[kc] != 0)"),
        ("(!kMask || !a.causal || kc <= qr[R] + Skv - Sq)", "(!a.causal || kc <= qr[R] + Skv - Sq)"),
        ("(!kMask || !a.causal || kc[R] <= qr + Skv - Sq)", "(!a.causal || kc[R] <= qr + Skv - Sq)"),
    ],
    # P and dS cut to one multiply (wrong results): what the rest costs
    "no_elementwise": [
        ("""              const bool vis =
                  live[R] && kok && (!kMask || !a.causal || kc <= qr[R] + Skv - Sq);
              const float bv = kBias != 0 ? BT::at(Bt, rr[R], j, shift[R]) * kLog2e : 0.f;
              const float p = ex2(fmaf(s[i], scale2, bv) - lse2[R]);
              s[i] = vis ? p * (dp[i] - delta[R]) : 0.f;  // dS""",
         "              s[i] = s[i] * dp[i];"),
        ("""              const bool vis = row_ok && !dead && kok[R] &&
                               (!kMask || !a.causal || kc[R] <= qr + Skv - Sq);
              const float bv = kBias != 0 ? BT::at(Bt, j, kj[R], shift) * kLog2e : 0.f;
              const float p = ex2(fmaf(s[i], scale2, bv) - lse_r * kLog2e);
              const float pv = vis ? p : (dead && kin[R] ? inv_skv : 0.f);
              dp[i] = vis ? p * (dp[i] - delta_r) : 0.f;  // dS^T
              s[i] = pv;                                  // P^T""",
         "              dp[i] = dp[i] * s[i];"),
    ],
}


def patched_source(name: str) -> str:
    src = (_build.CSRC / "flash_attention_bwd.cu").read_text()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name}: patch text found {src.count(old)} times:\n{old}")
        src = src.replace(old, new)
    return src


def build_variants(names):
    """Compile every variant at once; returns name -> loaded library."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src = _build.BUILD_DIR / f"variant_{name}.cu"
        src.write_text(patched_source(name))
        out = str(_build.BUILD_DIR / f"variant_{name}.so")
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", out,
               str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), out)
    libs = {}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        print(f"--- {name} rc={proc.returncode}")
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} failed to build:\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            # the tensor-core instances with a bf16 bias (template <64, 2, kMask>)
            if "Compiling entry" in line and "2tc" in line and "ILi64ELi2E" in line:
                kernel = "dq" if "dq_kernel" in line else "dkv"
                mask = "masked" if "ELb1E" in line else "unmasked"
                props = [x.strip() for x in lines[i + 1:i + 4] if "spill" in x or "Used" in x]
                print(f"{kernel} {mask}: " + " | ".join(props))
        lib = ctypes.CDLL(out)
        lib.x2_error_string.argtypes = [ctypes.c_int]
        lib.x2_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def main(names) -> int:
    unknown = [n for n in names if n not in VARIANTS]
    if not names or unknown:
        print(f"flash_bwd_variants: name variants of {sorted(VARIANTS)}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("flash_bwd_variants: no CUDA device is visible", file=sys.stderr)
        return 2
    libs = build_variants(names)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip())
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    B, H, S, D = 32, 12, 197, 64
    q, k, v, bias = cs.flash_inputs(gen, dev, B, H, S, S, D, torch.bfloat16, (1, H, S, S))
    dout = torch.randn(B, H, S, D, generator=gen, device=dev).to(torch.bfloat16)
    res = {}
    with torch.no_grad():
        out, lse = fa.flash_attention_fwd(q, k, v, bias)
        biases = {"bf16": bias, "f32": bias.float(), "none": None}
        ref = {bn: fa.flash_attention_bwd_reference(q, k, v, b, None, out, lse, dout)
               for bn, b in biases.items()}
        for rnd in range(2):
            order = list(libs.items())
            for name, lib in order if rnd == 0 else order[::-1]:
                _build._LIBS["flash_attention_bwd"] = lib
                for bn, b in biases.items():
                    launch = fa._bwd_launchers(q, k, v, b, None, out, lse, dout, False, 1.0)
                    dq = launch["dq"]()
                    dk, dv = launch["dkv"]()
                    err = max(cs.max_err(a, r) for a, r in zip((dq, dk, dv), ref[bn]))
                    t = [cs.time_ms(launch[kk], host_ahead=True) for kk in ("dq", "dkv")]
                    res.setdefault((name, bn), []).append(
                        (round(t[0], 4), round(t[1], 4), round(err, 4)))
    for (name, bn), runs in res.items():
        print(f"{name:16s} bias={bn:5s} dq/dkv ms, err vs plain: {runs}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
