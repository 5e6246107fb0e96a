#!/usr/bin/env python3
"""Time patched copies of the tiny attention kernels' key-tiled tensor-core
walk (``tc::fwd_tiled_kernel`` in ``x2vlm_tpu_torch/csrc/tiny_attention_fwd.cu``
and ``tc::bwd_tiled_kernel`` in ``tiny_attention_bwd.cu``) on one NVIDIA GPU,
at the 384 px fusion cross-attention's 40 x 584 shapes (``SHAPES``: H=12,
D=64, bf16, the 577 -> 584 key mask): the forward with the training operands
(a bf16 dropout multiplier, the fp32 probabilities written) at B=96 and B=32,
serving (no multiplier, no probabilities) at B=1024 and B=512, and the
backward at B=96 and B=32.

    python3 tools/tiny_variants.py parent base base parent
    python3 tools/tiny_variants.py base no_dm no_p_stores

Run from the repository root on a machine with the card and ``nvcc``. The
names of ``VARIANTS`` patch this tree's sources; ``parent`` builds the
sources of the tree unpacked under ``build/parent/`` (``git archive``) as
they are (its C entry points must take the arguments this tree's take).
A patch whose text is not found exactly once stops the script.
Both kernel libraries of every variant are built with the port's own
flags, all at once, and loaded in place of the port's while the variant is
timed. Prints each variant's ptxas lines of the
key-tiled tensor-core instances at D=64, the card's name and power limit,
and per variant and shape the kernel's time (CUDA events, the card ahead of
the host) and its largest difference from the plain version (probabilities
and dQ / dK / dV included), for two rounds, the second in the reverse order
of variants (so ``parent base`` times parent, change, change, parent).
``tests/test_torch_tiny_route.py`` checks on the CPU that every patch of
``VARIANTS`` still applies.
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
from x2vlm_tpu_torch.ops import tiny_attention as ta  # noqa: E402

FWD, BWD, COMMON = "tiny_attention_fwd.cu", "tiny_attention_bwd.cu", "common.cuh"
LIBS = ("tiny_attention_fwd", "tiny_attention_bwd")
PARENT_CSRC = Path(_build.BUILD_DIR).parent / "parent" / "x2vlm_tpu_torch" / "csrc"
# (label, B, training operands) of the timed shapes, all 40 x 584, H=12, D=64
SHAPES = (("fwd B96 tr.", 96, True), ("fwd B32 tr.", 32, True),
          ("fwd B1024 serving", 1024, False), ("fwd B512 serving", 512, False),
          ("bwd B96", 96, True), ("bwd B32", 32, True))

# name -> [(source file, its text, the replacement)] of this tree's kernels
VARIANTS = {
    "base": [],
    # a 2-stage forward ring (one tile in flight while one is computed)
    "fwd_stages_2": [(FWD, "constexpr int kStages = 3;", "constexpr int kStages = 2;")],
    # a 3-stage backward ring (1 block an SM at 40 x 584)
    "bwd_stages_3": [(BWD, "constexpr int kBwdStages = 2;", "constexpr int kBwdStages = 3;")],
    # the multiplier neither staged nor read (taken as 1; wrong results with dropout)
    "no_dm": [
        (FWD, "        if constexpr (kDm) {\n          if (dm16)\n            DmRows16::stage",
         "        if constexpr (false) {\n          if (dm16)\n            DmRows16::stage"),
        (FWD, "    const int rr = r0 + g + 8 * R, j = 16 * gi + 8 * T + 2 * t;\n",
         "    return make_float2(1.f, 1.f);\n    const int rr = r0 + g + 8 * R, j = 16 * gi + 8 * T + 2 * t;\n"),
        (BWD, "      if constexpr (kDm) {\n        if (dm16)\n          DmRows16::stage",
         "      if constexpr (false) {\n        if (dm16)\n          DmRows16::stage"),
        (BWD, "          if constexpr (kDm) {\n            const unsigned* drow",
         "          if constexpr (false) {\n            const unsigned* drow"),
    ],
    # the fp32 probabilities never stored
    "no_p_stores": [(FWD, "        store_p(t0 + 16 * gi, c);\n", "")],
    # pass 1 computes on whatever its slots hold: no K tile loaded for it
    "no_fwd_pass1_loads": [(FWD, "    if (s < nsteps) {\n      const int slot = s % kStages",
                            "    if (s < nsteps && full(s)) {\n      const int slot = s % kStages")],
    # only the first kStages - 1 steps load (later steps compute on those tiles): the math alone
    "no_loads": [(FWD, "    if (s < nsteps) {\n      const int slot = s % kStages",
                  "    if (s < kStages - 1) {\n      const int slot = s % kStages")],
    # the serving walk's math left out (zeros out): the ring, barriers and stores alone
    "serve_no_math": [(FWD, "    } else if constexpr (kOnePass) {  // the tile's groups; one rescale",
                       "    } else if constexpr (kOnePass) {\n    } else if constexpr (kOnePass) {")],
    # the backward's dQ units left out (dQ wrong): what phase B's dQ costs
    "no_dq": [(BWD, "      if (unit >= NR * kDqUnits) continue;\n      const int rt = unit / kDqUnits, dc = unit % kDqUnits;\n      for (int gi",
               "      if (true) continue;\n      const int rt = unit / kDqUnits, dc = unit % kDqUnits;\n      for (int gi")],
}


def patched_sources(name: str) -> dict:
    """{source file: its text} of variant ``name``: the two kernel sources
    and the shared header, the parent tree's or this tree's with the
    variant's patches applied."""
    if name == "parent":
        return {f: (PARENT_CSRC / f).read_text() for f in (FWD, BWD, COMMON)}
    srcs = {f: (_build.CSRC / f).read_text() for f in (FWD, BWD, COMMON)}
    for fname, old, new in VARIANTS[name]:
        if srcs[fname].count(old) != 1:
            raise RuntimeError(f"variant {name}: patch text found {srcs[fname].count(old)} "
                               f"times in {fname}, not once:\n{old}")
        srcs[fname] = srcs[fname].replace(old, new)
    return srcs


def build_variants(names):
    """Compile both libraries of every variant at once; returns name ->
    {library name: loaded library}."""
    procs = {}
    for name in dict.fromkeys(names):
        vdir = _build.BUILD_DIR / f"tiny_variant_{name}"
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
        for i, line in enumerate(lines):   # the key-tiled tensor-core instances at D=64
            if "Compiling entry" in line and "tiled" in line and "2tc" in line \
                    and "ILi64E" in line:
                props = [x.strip() for x in lines[i + 1:i + 4] if "spill" in x or "Used" in x]
                print(f"{line.split('[')[-1].split(']')[0]}: " + " | ".join(props))
        lib = ctypes.CDLL(out)
        lib.x2_error_string.argtypes = [ctypes.c_int]
        lib.x2_error_string.restype = ctypes.c_char_p
        libs.setdefault(name, {})[lib_name] = lib
    return libs


def _case(gen, dev, B, train):
    """Operands at 40 x 584 and the plain version's forward (and backward)."""
    H, D, Sq, Skv = 12, 64, cs.TEXT_LEN, 584
    q, k, v, km, dm = cs.tiny_operands(gen, dev, B, Sq, Skv, H, D, torch.bfloat16, "pad",
                                       train)
    out, probs = ta.tiny_attention_reference(q, k, v, H, km, dm, D ** -0.5)
    g = torch.randn(q.shape, generator=gen, device=dev).to(torch.bfloat16) if train else None
    grads = ta.tiny_attention_bwd_reference(q, k, v, probs, dm, g, H, D ** -0.5) \
        if train else None
    return dict(q=q, k=k, v=v, km=km, dm=dm, g=g, out=out, probs=probs, grads=grads, H=H,
                scale=D ** -0.5)


def _run(label, c):
    """(time ms, largest difference from the plain version) of one shape."""
    q, k, v, km, dm, H, sc = c["q"], c["k"], c["v"], c["km"], c["dm"], c["H"], c["scale"]
    if label.startswith("fwd"):
        train = dm is not None
        fn = lambda: ta.tiny_attention_fwd(q, k, v, H, km, dm, sc, return_probs=train)
        out, probs = fn()
        err = cs.max_err(out, c["out"])
        if train:
            err = max(err, cs.max_err(probs, c["probs"]))
        return cs.time_ms(fn, host_ahead=True), err
    out, probs = ta.tiny_attention_fwd(q, k, v, H, km, dm, sc, return_probs=True)
    fn = lambda: ta.tiny_attention_bwd(q, k, v, probs, dm, c["g"], H, sc, out=out)
    err = max(cs.max_err(a, b) for a, b in zip(fn(), c["grads"]))
    return cs.time_ms(fn, host_ahead=True), err


def main(names) -> int:
    known = set(VARIANTS) | {"parent"}
    unknown = [n for n in names if n not in known]
    if not names or unknown:
        print(f"tiny_variants: name variants of {sorted(known)}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("tiny_variants: no CUDA device is visible", file=sys.stderr)
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
        cases = {}
        for label, B, train in SHAPES:
            key = (B, train)
            if key not in cases:
                cases[key] = _case(gen, dev, B, train)
        for rnd in range(2):
            order = list(dict.fromkeys(names))
            for name in order if rnd == 0 else order[::-1]:
                _build._LIBS.update(libs[name])
                for label, B, train in SHAPES:
                    ms, err = _run(label, cases[(B, train)])
                    res.setdefault((name, label), []).append((round(ms, 4), round(err, 5)))
    for (name, label), runs in res.items():
        print(f"{name:16s} {label:18s} (ms, err vs plain) per round: {runs}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
