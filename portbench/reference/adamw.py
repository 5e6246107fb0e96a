"""AdamW as X2-VLM pretrains with it, in plain PyTorch: the reference's
optimizer.

One step, over float32 parameters by name:

1. the global gradient norm, and the clip to ``clip`` (g * clip / norm
   when the norm is at or above it);
2. Adam moments (b1 0.9, b2 0.98), bias-corrected with the step count
   after the increment; eps outside the square root;
3. + weight_decay * p, except on parameters of rank <= 1, the LayerScale
   gammas, the CLS token, the temperature and the relative-position tables;
4. * the parameter's learning-rate scale (``lr_mult`` on the parameters
   that start fresh);
5. * -lr(step count before the increment), a linear warmup then a linear
   decay: the first update has lr 0;
6. the temperature clamped into [0.001, 0.5].
"""

from __future__ import annotations

from typing import Dict, Iterable

import torch

__all__ = ["AdamWRef", "decays", "linear_schedule"]


def linear_schedule(base_lr: float, total_steps: int, warmup_steps: int):
    def lr(step: int) -> float:
        if step < warmup_steps:
            return base_lr * step / max(warmup_steps, 1)
        frac = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
        return base_lr * max(0.0, 1.0 - frac)
    return lr


def decays(name: str, shape) -> bool:
    last = name.rsplit(".", 1)[-1]
    if len(shape) <= 1 or last in ("temp", "cls_token", "gamma_1", "gamma_2"):
        return False
    return "relative_position_bias_table" not in name and "pos_embed" not in last


class AdamWRef:
    def __init__(self, params: Dict[str, torch.Tensor], lr, *, weight_decay: float,
                 clip: float, fresh: Iterable[str] = (), lr_mult: float = 1.0,
                 b1: float = 0.9, b2: float = 0.98, eps: float = 1e-8):
        self.p = params
        self.lr, self.wd, self.clip = lr, weight_decay, clip
        self.b1, self.b2, self.eps = b1, b2, eps
        fresh = set(fresh)
        self.scale = {n: (lr_mult if n in fresh else 1.0) for n in params}
        self.mu = {n: torch.zeros_like(t) for n, t in params.items()}
        self.nu = {n: torch.zeros_like(t) for n, t in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> float:
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).float()
        factor = 1.0 if norm < self.clip else self.clip / norm
        lr = self.lr(self.count)
        self.count += 1
        bc1, bc2 = 1.0 - self.b1 ** self.count, 1.0 - self.b2 ** self.count
        for n, p in self.p.items():
            g = grads[n] * factor
            self.mu[n].mul_(self.b1).add_(g * (1.0 - self.b1))
            self.nu[n].mul_(self.b2).add_(g * g * (1.0 - self.b2))
            u = (self.mu[n] / bc1) / (torch.sqrt(self.nu[n] / bc2) + self.eps)
            if self.wd and decays(n, p.shape):
                u = u + self.wd * p
            new = p - lr * self.scale[n] * u
            if n == "temp":
                new = new.clamp(0.001, 0.5)
            p.copy_(new)
        return float(norm)
