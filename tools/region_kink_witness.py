#!/usr/bin/env python3
"""Read how the region step's gradients depend on where its box targets sit
against the kinks of the L1 and GIoU losses, on one NVIDIA GPU.

    python3 tools/region_kink_witness.py [--seed N] [--batches N]

Run from the repository root on a machine with the card and ``nvcc``.
``chip_smoke.py``'s phase 6 holds the region step on the card in bf16 to
the port's CPU fp32 path by gradient cosines (>= 0.99). Both losses have
kinks: the L1 loss where a predicted coordinate (cx, cy, w, h) meets the
target's, the GIoU loss where a predicted edge meets a target edge (the
intersection's and the enclosing box's min / max) or where the boxes stop
overlapping. A target within the card's bf16 rounding of a kink flips a
sign of the gradient between the card and the CPU path, with no kernel at
fault. This script shows that on the CPU path alone.

X2VLM-base (``XVLMForPretrain``, weights drawn from ``--seed``) on the CPU
in fp32 and on the card in bf16 with the same weights. The region batch is
phase 6's (``chip_smoke.region_hold_batch``), drawn ``--batches`` times
from seeds ``seed``, ``seed + 1``, ...; for each, the CPU boxes and the
kink margins of phase 6's former fixed targets (each row's own box, as the
rows' bitmaps draw it): the least distance of a loss row's predicted
coordinate from the target's (L1; its kinks always turn the gradient) and
of a predicted edge or overlap bound from the target's (GIoU; a kink there
turns it only where the term is live). For the batches with the least and
the largest L1 margin, and for three sets of targets (the fixed
ones; the fixed ones with each non-degenerate loss row's cx put 5e-4 above
the CPU prediction's, on an L1 kink; ``chip_smoke.off_kink_targets``, which
phase 6 uses), the gradient cosines of ``chip_smoke.region_cosine_params``:
the CPU path against itself with every target coordinate moved by -1e-3
(``cpu_moved``) and the card in bf16 against the CPU path (``card``).
Prints the card's name and power limit and one JSON line per reading.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from x2vlm_tpu_torch.models import XVLMConfig, XVLMForPretrain  # noqa: E402
from x2vlm_tpu_torch.ops import _build  # noqa: E402
from x2vlm_tpu_torch.ops import box as box_ops  # noqa: E402

MOVE = 1e-3          # the CPU path against itself: every target coordinate moved by -MOVE
ON_KINK = 5e-4       # the on-kink targets' cx: this far above the CPU prediction's


def fixed_targets(cfg) -> torch.Tensor:
    """Phase 6's former fixed targets: each row's own box in cxcywh (the
    image for the full-image row), the degenerate row's width negated."""
    side = cfg.vision.image_res // cfg.vision.patch_size
    target = torch.tensor([[0.5, 0.5, 1.0, 1.0]]).repeat(len(cs.REGION_HOLD_BOXES), 1)
    for r, b in enumerate(cs.REGION_HOLD_BOXES):
        if b is not None:
            x, y, w, h = b
            target[r] = torch.tensor([x + w / 2, y + h / 2, w, h]) / side
    target[cs.REGION_HOLD_DEGENERATE, 2] *= -1
    return target


def loss_rows():
    """The rows the bbox losses keep (not the full-image row)."""
    return [r for r, b in enumerate(cs.REGION_HOLD_BOXES) if b is not None]


def kink_margins(pred: torch.Tensor, target: torch.Tensor) -> dict:
    """The least distance of a kept row's predicted coordinate from the
    target's (``l1``) and, for the rows whose boxes are not degenerate, of a
    predicted edge from the target edge it is compared with or of an
    overlap bound from zero (``giou``)."""
    l1, giou = [], []
    for r in loss_rows():
        p, t = pred[r].double(), target[r].double()
        l1 += (p - t).abs().tolist()
        pb, tb = (box_ops.box_cxcywh_to_xyxy(x[None])[0] for x in (p, t))
        if (pb[2:] < pb[:2]).any() or (tb[2:] < tb[:2]).any():
            continue
        giou += (pb - tb).abs().tolist()
        giou += [abs(pb[2] - tb[0]).item(), abs(tb[2] - pb[0]).item(),
                 abs(pb[3] - tb[1]).item(), abs(tb[3] - pb[1]).item()]
    return {"l1": min(l1), "giou": min(giou)}


def cosines(a: dict, b: dict) -> dict:
    return {k: F.cosine_similarity(a[k], b[k], dim=0).item() for k in a}


def witness(cfg, dev, seed: int, batches: int, smi: str) -> list:
    """The readings (module doc) with X2VLM weights of ``cfg`` drawn from
    ``seed``, the bf16 model on ``dev``; each is printed and returned."""
    cpu = XVLMForPretrain(cfg, dtype=torch.float32, device="cpu", seed=seed)
    card = XVLMForPretrain(cfg, dtype=torch.bfloat16, device=dev, seed=None)
    card.load_state_dict(cpu.state_dict())
    cpu.eval()
    fixed = fixed_targets(cfg)

    scan = []
    gen = torch.Generator(device=dev)
    for i in range(batches):
        gen.manual_seed(seed + i)
        batch = cs.region_hold_batch(gen, dev, cfg)
        pred = cs.region_boxes(cpu, batch)
        scan.append((kink_margins(pred, fixed), i, batch, pred))
    scan.sort(key=lambda x: x[0]["l1"])
    readings = [{"fixed_target_margins": {i: m for m, i, _, _ in scan}}]
    print(json.dumps(readings[-1]), flush=True)

    for margin, i, batch, pred in (scan[0], scan[-1]):
        kinked = fixed.clone()
        for r in loss_rows():
            if r != cs.REGION_HOLD_DEGENERATE:
                kinked[r, 0] = pred[r, 0] + ON_KINK
        off = cs.off_kink_targets(pred)
        off[cs.REGION_HOLD_DEGENERATE, 2] *= -1
        for name, target in (("fixed", fixed), ("on_kink", kinked), ("off_kink", off)):
            batch["target_bbox"] = target.to(dev)
            _, g_cpu = cs.region_step_grads(cpu, batch, cfg)
            _, g_card = cs.region_step_grads(card, batch, cfg)
            batch["target_bbox"] = (target - MOVE).to(dev)
            _, g_moved = cs.region_step_grads(cpu, batch, cfg)
            readings.append({"batch": i, "targets": name, "margins": kink_margins(pred, target),
                             "cpu_moved": cosines(g_moved, g_cpu),
                             "card": cosines(g_card, g_cpu), "device": smi})
            print(json.dumps(readings[-1]), flush=True)
    return readings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batches", type=int, default=96)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("region_kink_witness: no CUDA device is visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _build.build()
    witness(XVLMConfig.base(), torch.device("cuda", 0), args.seed, args.batches, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
