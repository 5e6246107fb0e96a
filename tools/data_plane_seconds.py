#!/usr/bin/env python3
"""Host seconds of the port's pretraining data streams, in the steady state,
on the native data plane (``x2vlm_tpu_torch/data/native.py``) against PIL.

    python3 tools/data_plane_seconds.py [--batches N] [--rounds N] [--out FILE]

Run from the repository root; it needs no card. Writes, from a fixed seed,
the corpora ``chip_smoke.py``'s phases 7 and 18 read (256 px PNG lines in
base64, region lines with 1-6 boxes), then builds the streams the launcher
builds for ``configs/pretrain/x2vlm_base_1b.yaml`` at 224 px: its image
stream (128 images a batch, 30 tokens) and its region stream (64 rows over
26 images, ``region_collate``), each once with the native transforms and
once with PIL's. A batch's seconds are the host's time to draw and collate
it (the launcher's prefetch thread does this beside the step); the first
batch of each stream is left out (its readers and transforms start), and
the next ``--batches`` are timed. The two decoders run in turns (PIL,
native, native, PIL, ... for ``--rounds`` rounds), and the medians are
printed as one JSON line, with the host's CPU model and core count. Where
the native library does not build, it says why and times PIL alone.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import random
import statistics
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402
from x2vlm_tpu_torch.data import native, transforms as T  # noqa: E402
from x2vlm_tpu_torch.data.loader import collate  # noqa: E402
from x2vlm_tpu_torch.data.pretrain import (  # noqa: E402
    ImageTextStream, RegionTextStream, region_collate,
)
from x2vlm_tpu_torch.data.streaming import DistLineReader  # noqa: E402
from x2vlm_tpu_torch.data.tokenization import BertWordPiece, TextPreprocessor  # noqa: E402

RES, PATCH = 224, 16
IMAGE_BATCH, TEXT_LEN = cs.PRETRAIN_BATCH, cs.B1B_LEN
REGION_ROWS, REGION_IMAGES = cs.B1B_REGION_ROWS, cs.B1B_REGION_IMAGES


def cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor()


def corpora(root: str):
    rng = np.random.default_rng(20)
    tok_dir, words = cs.write_vocab(root, rng)
    images = os.path.join(root, "images.jsonl")
    with open(images, "w") as f:
        for _ in range(2 * IMAGE_BATCH):
            f.write(json.dumps({"binary": __import__("base64").b64encode(
                cs.random_png(rng, 256)).decode(), "desc": cs.caption(rng, words)}) + "\n")
    regions = os.path.join(root, "regions.jsonl")
    cs.write_region_corpus(regions, rng, words)
    return tok_dir, images, regions


def streams(tok_dir: str, images: str, regions: str, use_native: bool):
    """(name, batch iterator) of the image and region streams."""
    tok = BertWordPiece(os.path.join(tok_dir, "vocab.txt"))
    rng, box_rng, region_rng = random.Random(0), random.Random(1), random.Random(2)
    pre = TextPreprocessor(tok, max_tokens=TEXT_LEN, max_words=TEXT_LEN, max_masks=12,
                           rng=rng)
    if use_native:
        tf = native.NativeTrainTransform(RES, rng=rng)
        box_tf = native.NativeBoxTransform(RES, rng=box_rng)
    else:
        tf = T.pretrain_transform(RES, rng=rng, as_float=False)
        box_tf = T.box_transform(box_rng)
    image = iter(ImageTextStream(DistLineReader([images], seed=0), pre, tf, caption_key="desc",
                                 rng=rng, max_consecutive_broken=IMAGE_BATCH))
    region = iter(RegionTextStream(DistLineReader([regions], seed=0), pre, box_tf,
                                   image_res=RES, patch_size=PATCH, rng=rng,
                                   max_consecutive_broken=REGION_IMAGES))

    def image_batches():
        while True:
            yield collate([next(image) for _ in range(IMAGE_BATCH)])

    def region_batches():
        while True:
            yield region_collate([next(region) for _ in range(REGION_IMAGES)], REGION_ROWS,
                                 REGION_IMAGES, region_rng)

    return {"image": image_batches(), "region": region_batches()}


def timed(batches, n: int) -> list:
    next(batches)                       # start-up: readers and transforms
    out = []
    for _ in range(n):
        t = time.perf_counter()
        next(batches)
        out.append(time.perf_counter() - t)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", help="also write the JSON line to this file")
    args = ap.parse_args(argv)
    reason = native.unavailable_reason()
    kinds = ["pil", "native"] if reason is None else ["pil"]
    if reason is not None:
        print(f"native dataplane: unavailable ({reason})", flush=True)
    with tempfile.TemporaryDirectory(prefix="data_plane_") as root:
        paths = corpora(root)
        secs = {k: {"image": [], "region": []} for k in kinds}
        order = []
        for r in range(args.rounds):
            order += kinds if r % 2 == 0 else kinds[::-1]
        for kind in order:
            for name, batches in streams(*paths, use_native=kind == "native").items():
                secs[kind][name] += timed(batches, args.batches)
    result = {"host": {"cpu": cpu_model(), "cores": len(os.sched_getaffinity(0))},
              "turns": order, "batch": {"image": f"{IMAGE_BATCH} images at {RES} px",
                                        "region": f"{REGION_ROWS} rows over {REGION_IMAGES}"
                                                  f" images at {RES} px"},
              "seconds_median": {k: {n: statistics.median(v) for n, v in s.items()}
                                 for k, s in secs.items()},
              "seconds": secs}
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
