#!/usr/bin/env python3
"""Time patched copies of the flash attention kernels' tensor-core route
(``x2vlm_tpu_torch/csrc/flash_attention_fwd.cu``, ``flash_attention_bwd.cu``
and the helpers they share in ``common.cuh``) against the sources as they
stand, on one NVIDIA GPU, at the main paths' shapes (H=12, S=197, D=64,
bf16): the forward at the serving batch (B=128) and the step's (B=32), dQ,
dK/dV and dBias at the step's, each with a bf16 bias (1, H, S, S), the same
bias in fp32 and no bias.

    python3 tools/flash_bwd_variants.py base exp2f min_blocks_2

Run from the repository root on a machine with the card and ``nvcc``. Each
variant named on the command line is the sources with the text patches of
``VARIANTS`` applied (a patch whose text is not found as many times as it
says stops the script), and ``PY_OVERRIDES`` set on
``x2vlm_tpu_torch.ops.flash_attention`` while it is timed; both kernel
libraries of every variant are built with the port's own flags, all at
once, and loaded in place of the port's. The script prints each variant's
ptxas lines of the tensor-core instances for a bf16 bias, the card's name
and power limit, and per variant and bias each kernel's time (CUDA events,
the card ahead of the host) and its largest error against the plain
version, for two rounds (the second in the reverse order of variants).
``tests/test_torch_flash_route.py`` checks on the CPU that every patch
still applies to the sources.
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

FWD, BWD, COMMON = "flash_attention_fwd.cu", "flash_attention_bwd.cu", "common.cuh"
LIBS = ("flash_attention_fwd", "flash_attention_bwd")
_MASK_BWD = ("(!kMask || km == nullptr || km[kc] != 0)", "(km == nullptr || km[kc] != 0)")
_CAUSAL = ("(!kMask || !a.causal || kc <= qr[R] + Skv - Sq)",
           "(!a.causal || kc <= qr[R] + Skv - Sq)")
_BIAS_ROW = ("const float bv = kBias != 0 ? BT::at(Bt, rr[R], j, shift[R]) * kLog2e : 0.f;",
             "const float bv = kBias != 0 && kc < Skv && qr[R] < Sq ? x2::load_operand("
             "a.bias, kBias, bbase + qr[R] * a.bias_sq + kc) * kLog2e : 0.f;")

# name -> [(source file, its text, the replacement[, times the text is found])]
VARIANTS = {
    "base": [],
    # exp2f keeps results below 2^-126 that ex2.approx.ftz flushes to 0
    "exp2f": [(COMMON, 'asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));',
               "y = exp2f(x);")],
    # fewer or more blocks an SM: the register cap of __launch_bounds__
    "min_blocks_2": [(f, "constexpr int kMinBlocks = 3;", "constexpr int kMinBlocks = 2;")
                     for f in (FWD, BWD)],
    "min_blocks_4": [(f, "constexpr int kMinBlocks = 3;", "constexpr int kMinBlocks = 4;")
                     for f in (FWD, BWD)],
    # the bias read per element from device memory (L2), not staged as tiles
    "bias_per_element": [
        (COMMON, "    if constexpr (kBias != 0) {\n      const char* src",
         "    if constexpr (false) {\n      const char* src"),
        (FWD, *_BIAS_ROW),
        (BWD, *_BIAS_ROW),
        (BWD, "const float bv = kBias != 0 ? BT::at(Bt, j, kj[R], shift) * kLog2e : 0.f;",
         "const float bv = kBias != 0 && row_ok && kin[R] ? x2::load_operand("
         "a.bias, kBias, bbase + qr * a.bias_sq + kc[R]) * kLog2e : 0.f;"),
        (BWD, "bl[gi][i] = BT::at(Bias, rr[R], j, shift[R]) * kLog2e;",
         "bl[gi][i] = qr[R] < Sq && c0 + j < Skv ? x2::load_operand(a.bias, kBias, "
         "bbase + qr[R] * a.bias_sq + c0 + j) * kLog2e : 0.f;"),
    ],
    # the key mask and causal tests made at run time in every instance, as
    # if there were no kMask instances without them
    "mask_runtime": [
        (BWD, *_MASK_BWD, 2),
        (BWD, *_CAUSAL, 2),
        (BWD, "(!kMask || !a.causal || kc[R] <= qr + Skv - Sq)",
         "(!a.causal || kc[R] <= qr + Skv - Sq)"),
        (BWD, "kMask && a.key_mask != nullptr ? a.key_mask", "a.key_mask != nullptr ? a.key_mask"),
        (FWD, "!kMask || km == nullptr || !kin || km[kc] != 0",
         "km == nullptr || !kin || km[kc] != 0"),
        (FWD, *_CAUSAL),
        (FWD, "const uint8_t* km = kMask && a.key_mask != nullptr",
         "const uint8_t* km = a.key_mask != nullptr"),
    ],
    # P and dS of dQ and dK/dV cut to one multiply (wrong results): what the rest costs
    "no_elementwise": [
        (BWD, """              const bool vis =
                  live[R] && kok && (!kMask || !a.causal || kc <= qr[R] + Skv - Sq);
              const float bv = kBias != 0 ? BT::at(Bt, rr[R], j, shift[R]) * kLog2e : 0.f;
              const float p = ex2(fmaf(s[i], scale2, bv) - lse2[R]);
              s[i] = vis ? p * (dp[i] - delta[R]) : 0.f;  // dS""",
         "              s[i] = s[i] * dp[i];"),
        (BWD, """              const bool vis = row_ok && !dead && kok[R] &&
                               (!kMask || !a.causal || kc[R] <= qr + Skv - Sq);
              const float bv = kBias != 0 ? BT::at(Bt, j, kj[R], shift) * kLog2e : 0.f;
              const float p = ex2(fmaf(s[i], scale2, bv) - lse_r * kLog2e);
              const float pv = vis ? p : (dead && kin[R] ? inv_skv : 0.f);
              dp[i] = vis ? p * (dp[i] - delta_r) : 0.f;  // dS^T
              s[i] = pv;                                  // P^T""",
         "              dp[i] = dp[i] * s[i];"),
    ],
    # the dBias grid's target block count (the batch groups of a shared bias)
    **{f"dbias_blocks_{n}": [(BWD, f"constexpr int kDBiasBlocks = {fa._DBIAS_BLOCKS};",
                              f"constexpr int kDBiasBlocks = {n};")]
       for n in (192, 384, 768, 1536, 3072) if n != fa._DBIAS_BLOCKS},
    # dBias folded into dQ: dQ also writes each batch row's fp32 dS (set by
    # x2_set_ds_out), which a sum over the batch then reads back ("dq+sum")
    "dbias_in_dq": [
        (BWD, "enum Which { kDQ = 0, kDKV = 1, kDBias = 2 };",
         "enum Which { kDQ = 0, kDKV = 1, kDBias = 2 };\n__device__ float* g_ds_out = nullptr;"),
        (BWD, "              s[i] = vis ? p * (dp[i] - delta[R]) : 0.f;  // dS",
         "              s[i] = vis ? p * (dp[i] - delta[R]) : 0.f;  // dS\n"
         "              if (g_ds_out != nullptr && qr[R] < Sq && kc < Skv)\n"
         "                g_ds_out[(bh * Sq + qr[R]) * Skv + kc] = s[i];"),
        (BWD, "extern \"C\" int x2_flash_attention_bwd_dbias_groups(int B, int tiles, int H) {",
         "extern \"C\" int x2_set_ds_out(void* p) {\n"
         "  return static_cast<int>(cudaMemcpyToSymbol(g_ds_out, &p, sizeof(p)));\n}\n"
         "extern \"C\" int x2_flash_attention_bwd_dbias_groups(int B, int tiles, int H) {"),
    ],
}
# name -> {attribute of x2vlm_tpu_torch.ops.flash_attention: value while timed}
PY_OVERRIDES = {name: {"_DBIAS_BLOCKS": int(name.rsplit("_", 1)[1])}
                for name in VARIANTS if name.startswith("dbias_blocks_")}


def patched_sources(name: str) -> dict:
    """{source file: its text with variant ``name``'s patches applied} for
    the two kernel sources and the shared header."""
    srcs = {f: (_build.CSRC / f).read_text() for f in (FWD, BWD, COMMON)}
    for fname, old, new, *times in VARIANTS[name]:
        want = times[0] if times else 1
        if srcs[fname].count(old) != want:
            raise RuntimeError(f"variant {name}: patch text found {srcs[fname].count(old)} "
                               f"times in {fname}, not {want}:\n{old}")
        srcs[fname] = srcs[fname].replace(old, new)
    return srcs


def build_variants(names):
    """Compile both libraries of every variant at once; returns name ->
    {library name: loaded library}."""
    procs = {}
    for name in names:
        vdir = _build.BUILD_DIR / f"variant_{name}"
        vdir.mkdir(parents=True, exist_ok=True)
        for fname, text in patched_sources(name).items():
            (vdir / fname).write_text(text)
        for lib in LIBS:
            out = str(vdir / f"{lib}.so")
            cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(vdir), "-o", out,
                   str(vdir / f"{lib}.cu")]
            procs[(name, lib)] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                   stderr=subprocess.STDOUT, text=True), out)
    libs = {}
    for (name, lib_name), (proc, out) in procs.items():
        log, _ = proc.communicate()
        print(f"--- {name} {lib_name} rc={proc.returncode}")
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} ({lib_name}) failed to build:\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            # the tensor-core instances with a bf16 bias (template <64, 2, kMask>)
            if "Compiling entry" in line and "2tc" in line and "ILi64ELi2E" in line:
                kernel = next(k for k in ("flash_fwd", "dq", "dkv", "dbias") if k in line)
                mask = "masked" if "ELb1E" in line else "unmasked"
                props = [x.strip() for x in lines[i + 1:i + 4] if "spill" in x or "Used" in x]
                print(f"{kernel} {mask}: " + " | ".join(props))
        lib = ctypes.CDLL(out)
        lib.x2_error_string.argtypes = [ctypes.c_int]
        lib.x2_error_string.restype = ctypes.c_char_p
        libs.setdefault(name, {})[lib_name] = lib
    return libs


def _fwd_case(gen, dev, B):
    H, S, D = 12, 197, 64
    q, k, v, bias = cs.flash_inputs(gen, dev, B, H, S, S, D, torch.bfloat16, (1, H, S, S))
    biases = {"bf16": bias, "f32": bias.float(), "none": None}
    ref = {bn: fa.flash_attention_reference(q, k, v, b)[0] for bn, b in biases.items()}
    return q, k, v, biases, ref


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
    res = {}
    with torch.no_grad():
        serve = _fwd_case(gen, dev, cs.BATCH)
        q, k, v, biases, fwd_ref = step = _fwd_case(gen, dev, cs.TRAIN_BATCH)
        dout = torch.randn(q.shape, generator=gen, device=dev).to(torch.bfloat16)
        outs = {bn: fa.flash_attention_reference(q, k, v, b) for bn, b in biases.items()}
        ref = {bn: fa.flash_attention_bwd_reference(q, k, v, b, None, *outs[bn], dout)
               for bn, b in biases.items()}
        ds = None
        if "dbias_in_dq" in libs:   # every batch row's dS, which dQ writes in that variant
            ds = torch.empty(q.shape[0], q.shape[1], q.shape[2], k.shape[2], device=dev)
            setter = libs["dbias_in_dq"]["flash_attention_bwd"].x2_set_ds_out
            setter.argtypes, setter.restype = [ctypes.c_void_p], ctypes.c_int
            if setter(ds.data_ptr()) != 0:
                raise RuntimeError("x2_set_ds_out failed")
        for rnd in range(2):
            order = list(libs.items())
            for name, variant_libs in order if rnd == 0 else order[::-1]:
                _build._LIBS.update(variant_libs)
                saved = {a: getattr(fa, a) for a in PY_OVERRIDES.get(name, {})}
                for attr, value in PY_OVERRIDES.get(name, {}).items():
                    setattr(fa, attr, value)
                for bn in biases:
                    row = {}
                    for label, (fq, fk, fv, fb, fr) in (("fwd B128", serve), ("fwd B32", step)):
                        run = lambda: fa.flash_attention_fwd(fq, fk, fv, fb[bn])
                        row[label] = (cs.time_ms(run, host_ahead=True),
                                      cs.max_err(run()[0], fr[bn]))
                    out, lse = outs[bn]
                    launch = fa._bwd_launchers(q, k, v, biases[bn], None, out, lse, dout,
                                               False, 1.0)
                    for kern in launch:
                        got = launch[kern]()
                        want = ref[bn][3] if kern == "dbias" else ref[bn][0]
                        if kern == "dkv":
                            got, want = got[0], ref[bn][1]
                        row[kern] = (cs.time_ms(launch[kern], host_ahead=True),
                                     cs.max_err(got, want))
                    if name == "dbias_in_dq" and biases[bn] is not None:
                        fold = lambda: (launch["dq"](), ds.sum(0, keepdim=True))
                        row["dq+sum"] = (cs.time_ms(fold, host_ahead=True),
                                         cs.max_err(fold()[1], ref[bn][3]))
                    res.setdefault((name, bn), []).append(
                        {kk: (round(t, 4), round(e, 4)) for kk, (t, e) in row.items()})
                for attr, value in saved.items():
                    setattr(fa, attr, value)
    for (name, bn), runs in res.items():
        print(f"{name:18s} bias={bn:5s} (ms, err vs plain) per kernel: {runs}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
