#!/usr/bin/env python3
"""Plant faults in copies of the port and read ``chip_smoke.py``'s phase-8
hold on the 384 px model (``fusion_384_readings`` and
``fusion_384_faults``) for each, on one NVIDIA GPU.

    python3 tools/fusion384_faults.py [--seed N] [variant ...]

Run from the repository root on a machine with the card and ``nvcc``. Each
variant (every one of ``VARIANTS`` when none is named) is a copy of
``x2vlm_tpu_torch/``, ``configs/`` and ``chip_smoke.py`` in a temporary
directory with the variant's text patches applied (a patch whose text is
not found exactly once stops the script). In a process of its own, all
variants at once, the copy builds its forward kernels and scores 2 random
images against 4 random texts with X2VLM-base at 384 px
(``configs/finetune/retrieval_flickr_base.yaml``), weights drawn from
``--seed``, on the card in bf16 and fp32 and on the CPU in fp32, as phase 8
does with its fine-tuned weights. Prints the card's name and power limit
and one JSON line per variant: the readings and what the hold finds wrong.
Exits 0 only if the variants of ``EXPECT_PASS`` pass the hold and every
other variant fails it.
``tests/test_torch_tiny_route.py`` checks on the CPU that every patch
still applies to the sources.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPIED = ("x2vlm_tpu_torch", "configs", "chip_smoke.py")
XVLM = "x2vlm_tpu_torch/models/xvlm.py"
FWD = "x2vlm_tpu_torch/csrc/tiny_attention_fwd.cu"
TINY = "x2vlm_tpu_torch/ops/tiny_attention.py"

# name -> [(file under the root, its text, the replacement)]
VARIANTS = {
    "base": [],
    # the model's 577 -> 584 padding keys left unmasked: Python that the
    # card and the CPU reference share, so the hold cannot see it (the CPU
    # tests hold the port's padding to the JAX package's)
    "model_pad_unmasked": [(XVLM, "image_atts = F.pad(image_atts, (0, pad))",
                            "image_atts = F.pad(image_atts, (0, pad), value=1)")],
    # the wrapper hands the kernels no key mask: the padding keys visible on
    # the card only, on both routes
    "wrapper_mask_dropped": [(TINY, "        km_ptr = key_mask.data_ptr()\n",
                              "        km_ptr = None\n")],
    # the tensor-core key-tiled forward ignores the key mask
    "tc_mask_ignored": [(FWD, ": (key_mask != nullptr && mb[j] == 0 ? x2::kNegInf : 0.f);",
                         ": 0.f;")],
    # the tensor-core key-tiled forward (serving walk) skips its first 64 keys
    "tc_tile_dropped": [(FWD, "    if (!active) continue;\n    const int slot = s % kStages",
                         "    if (!active || (kOnePass && s == 0)) continue;\n"
                         "    const int slot = s % kStages")],
    # the CUDA-core key-tiled forward leaves its first 32 keys out of P . V
    "cc_tile_dropped": [(FWD, "for (int t0 = 0; t0 < Skv; t0 += kTileKeys) {  // pass 2",
                         "for (int t0 = kTileKeys; t0 < Skv; t0 += kTileKeys) {  // pass 2")],
}
# the variants the hold must pass: the sources, and the fault it cannot see
EXPECT_PASS = ("base", "model_pad_unmasked")


def patched_sources(variant: str, root: str = ROOT) -> dict:
    """{file: its text with the variant's patches} of every file a patch
    of any variant touches."""
    files = sorted({f for patches in VARIANTS.values() for f, _, _ in patches})
    texts = {f: open(os.path.join(root, f)).read() for f in files}
    for f, old, new in VARIANTS[variant]:
        n = texts[f].count(old)
        if n != 1:
            raise ValueError(f"{variant}: {f} holds the patch text {n} times, not once")
        texts[f] = texts[f].replace(old, new)
    return texts


def make_copy(variant: str, dest: str) -> None:
    for part in COPIED:
        src = os.path.join(ROOT, part)
        if os.path.isdir(src):
            shutil.copytree(src, os.path.join(dest, part),
                            ignore=shutil.ignore_patterns("__pycache__"))
        else:
            shutil.copy2(src, os.path.join(dest, part))
    for f, text in patched_sources(variant).items():
        with open(os.path.join(dest, f), "w") as fh:
            fh.write(text)


def child(seed: int) -> None:
    """In a variant's copy (the working directory): the readings and the
    hold's findings as one JSON line."""
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    import chip_smoke as cs
    from x2vlm_tpu_torch.factory import xvlm_config_from_yaml
    from x2vlm_tpu_torch.models import XVLMForRetrieval
    from x2vlm_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(2)
    _build.build(("flash_attention_fwd", "tiny_attention_fwd"))
    mcfg = xvlm_config_from_yaml(cs.shipped_config(cs.RETRIEVAL_CONFIG))
    state = XVLMForRetrieval(mcfg, dtype=torch.float32, device="cpu", seed=seed).state_dict()
    rng = np.random.default_rng(seed)
    res = mcfg.vision.image_res
    images = torch.from_numpy(rng.standard_normal((2, res, res, 3)).astype(np.float32))
    ids = np.zeros((4, cs.TEXT_LEN), np.int64)
    atts = np.zeros((4, cs.TEXT_LEN), np.int64)
    for i, n in enumerate((12, cs.TEXT_LEN, 25, 7)):
        ids[i, :n] = rng.integers(1000, 30522, n)
        ids[i, 0], ids[i, n - 1] = 101, 102
        atts[i, :n] = 1
    readings = cs.fusion_384_readings(state, mcfg, images, torch.from_numpy(ids),
                                      torch.from_numpy(atts), torch.device("cuda", 0))
    print(json.dumps({"readings": readings, "faults": cs.fusion_384_faults(readings)}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", help=f"any of {sorted(VARIANTS)} (default all)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        child(args.seed)
        return 0
    names = args.variants or list(VARIANTS)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip() or smi.stderr.strip(), flush=True)
    with tempfile.TemporaryDirectory(prefix="fusion384_") as tmp:
        procs = {}
        for name in names:
            dest = os.path.join(tmp, name)
            os.makedirs(dest)
            make_copy(name, dest)
            procs[name] = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--child", "--seed",
                 str(args.seed)], cwd=dest, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
        ok = True
        for name, proc in procs.items():
            out, _ = proc.communicate()
            lines = out.strip().splitlines()
            try:
                result = json.loads(lines[-1])
            except (IndexError, json.JSONDecodeError):
                print(f"{name}: no result (exit {proc.returncode}):\n{out[-3000:]}")
                ok = False
                continue
            print(json.dumps({"variant": name, **result}), flush=True)
            ok &= (not result["faults"]) == (name in EXPECT_PASS)
    print(f"as expected: {', '.join(EXPECT_PASS)} pass the hold, every other variant fails it"
          if ok else "FAIL: a variant passed or failed the hold against expectation")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
