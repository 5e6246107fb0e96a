"""Seeded weights, made on the device in a few large calls.

Every parameter of a :func:`reference.x2vlm.param_spec` is a view into one
float32 buffer: the "normal" and "ln" parameters are drawn by one
``normal_`` call from a ``torch.Generator`` on the device seeded with the
run's seed, the constants are filled. The same seed gives the same weights,
so a check after the window makes them again instead of keeping a copy.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

__all__ = ["make_weights", "STD", "GAMMA", "TEMP"]

STD = 0.02     # the std of every drawn parameter
GAMMA = 0.1    # BEiT-2's LayerScale init
TEMP = 0.07    # the ITC temperature


def make_weights(spec: List[Tuple[str, Tuple[int, ...], str]], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    sizes = [math.prod(shape) for _, shape, _ in spec]
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    drawn = [kind in ("normal", "ln") for _, _, kind in spec]
    n_drawn = sum(s for s, d in zip(sizes, drawn) if d)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (2 ** 63))
    flat[:n_drawn].normal_(0.0, STD, generator=gen)
    out, lo_d, lo_c = {}, 0, n_drawn
    for (name, shape, kind), size, d in zip(spec, sizes, drawn):
        if d:
            t = flat[lo_d:lo_d + size]
            lo_d += size
            if kind == "ln":
                t.add_(1.0)
        else:
            t = flat[lo_c:lo_c + size]
            lo_c += size
            t.fill_(GAMMA if kind == "gamma" else TEMP)
        out[name] = t.view(shape)
    return out
