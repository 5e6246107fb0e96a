"""Optimizer and learning-rate schedule (counterpart of
x2vlm_tpu/train/optim.py), written for ``nn.Module`` parameter names.

AdamW with the reference's group structure, as the JAX package's optax
chain computes it, in this order:

1. ``clip_by_global_norm``: g <- g if |g| < max else (g / |g|) * max;
2. Adam (b1 0.9, b2 0.98, eps 1e-8 outside the square root, bias-corrected
   with the count after the increment);
3. + weight_decay * p on the leaves the decay mask selects;
4. * the group scale (vision / text / cross / other / fresh);
5. * -lr(count before the increment): optax's ``scale_by_learning_rate``
   reads its step count before updating it, so with warmup the first
   update has lr = 0;
6. the temperature is projected into [0.001, 0.5] after the update.

The decay mask follows the JAX names leaf for leaf: no decay on biases,
LayerNorm scales, LayerScale gammas, ``temp``, ``cls_token``, relative
position tables, the vision towers' position tables (ViT's ``pos_embed``,
CLIP's ``pos_embed.weight``: the JAX leaf of both is ``pos_embed``), any
name whose last part holds ``pos_embed`` (the video frame positions
``absolute_frame_pos_embed``, the JAX leaf ``frame_pos_embed``) and
anything of rank <= 1; BERT's ``position_embeddings`` IS decayed (its JAX
leaf is ``embedding``), and so is the resampler's ``time_pos_emb``.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch
from torch import nn

__all__ = ["AdamW", "create_optimizer", "is_no_decay", "lr_schedule", "param_labels"]


def lr_schedule(base_lr: float, total_steps: int, warmup_steps: float = 0,
                min_rate: float = 0.0) -> Callable[[int], float]:
    """Linear warmup then linear decay to ``min_rate * base_lr``; a warmup
    in (0, 1) is a fraction of ``total_steps``."""
    if 0 < warmup_steps < 1:
        warmup_steps = int(total_steps * warmup_steps)
    warmup_steps = int(warmup_steps)

    def schedule(step: int) -> float:
        step = float(step)
        if step < warmup_steps:
            return base_lr * step / max(warmup_steps, 1)
        frac = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
        return base_lr * max(min_rate, 1.0 - (1.0 - min_rate) * frac)

    return schedule


def is_no_decay(name: str, param: torch.Tensor) -> bool:
    """The JAX package's no-decay rule, by the port's (reference) names."""
    last = name.rsplit(".", 1)[-1]
    if last in ("temp", "cls_token", "gamma_1", "gamma_2") or "pos_embed" in last:
        return True
    if "relative_position_bias_table" in name or name.endswith(".pos_embed.weight"):
        return True
    return param.dim() <= 1


def _strip(name: str) -> str:
    """The name inside the composition core (a task head keeps it under
    ``base.``)."""
    return name[len("base."):] if name.startswith("base.") else name


def param_labels(named_params: Iterable[Tuple[str, torch.Tensor]], fusion_layer: int,
                 fresh_names: Iterable[str] = (),
                 fresh_prefixes: Iterable[str] = ()) -> Dict[str, str]:
    """name -> 'vision' | 'text' | 'cross' | 'other' | 'fresh', as the JAX
    ``param_labels``: text-tower layers (BERT's or XLM-R's) below
    ``fusion_layer`` are text, the rest cross; the MLM head (the JAX
    ``mlm_head``, outside the text encoder there) is other, and so is the
    Plus base's standalone ``cross_encoder`` (the JAX rule looks for
    ``text_encoder/layer_`` only). ``fresh_names`` / ``fresh_prefixes``
    (names inside the composition core) take the ``lr_mult`` group."""
    fresh = set(fresh_names)
    prefixes = tuple(fresh_prefixes)
    labels = {}
    for name, _ in named_params:
        rel = _strip(name)
        if rel in fresh or any(rel.startswith(p) for p in prefixes):
            lab = "fresh"
        elif rel.startswith("vision_encoder."):
            lab = "vision"
        elif rel.startswith(("text_encoder.bert.encoder.layer.",
                             "text_encoder.roberta.encoder.layer.")):
            layer = int(rel.split(".")[4])
            lab = "text" if layer < fusion_layer else "cross"
        elif rel.startswith(("text_encoder.bert.", "text_encoder.roberta.")):
            lab = "text"
        else:
            lab = "other"
        labels[name] = lab
    return labels


class AdamW:
    """The optax chain of the module doc over named parameters, updated in
    place with ``torch._foreach`` ops per (decay, group scale) group.
    :meth:`step` reads each parameter's ``.grad`` (None counts as zeros) and
    returns the global gradient norm before clipping (a device scalar)."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.Tensor]],
                 schedule: Callable[[int], float], *, weight_decay: float = 0.01,
                 clip_grad_norm: Optional[float] = 1.0, b1: float = 0.9, b2: float = 0.98,
                 eps: float = 1e-8, group_scale: Optional[Dict[str, float]] = None,
                 labels: Optional[Dict[str, str]] = None):
        named = [(n, p) for n, p in named_params if p.requires_grad]
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.schedule = schedule
        self.weight_decay, self.clip = weight_decay, clip_grad_norm
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        scale = group_scale or {}
        groups: Dict[Tuple[bool, float], List[int]] = {}
        for i, (n, p) in enumerate(named):
            s = 1.0 if labels is None else float(scale.get(labels[n], 1.0))
            groups.setdefault((not is_no_decay(n, p), s), []).append(i)
        self.groups = sorted(groups.items())
        temp = [i for i, n in enumerate(self.names)
                if n.rsplit(".", 1)[-1] == "temp" and self.params[i].dim() == 0]
        self.temp_index = temp[0] if temp else None

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]
        g_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        if self.clip is not None:
            trigger = g_norm < self.clip
            one = torch.ones_like(g_norm)
            grads = torch._foreach_div(grads, torch.where(trigger, one, g_norm))
            torch._foreach_mul_(grads, torch.where(trigger, one, one * self.clip))
        lr = self.schedule(self.count)      # the count before this update
        self.count += 1
        b1, b2 = self.b1, self.b2
        bc1, bc2 = 1.0 - b1 ** self.count, 1.0 - b2 ** self.count
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1.0 - b1))
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(torch._foreach_mul(grads, grads),
                                                        1.0 - b2))
        for (decay, scale), idx in self.groups:
            ps = [self.params[i] for i in idx]
            den = torch._foreach_div([self.nu[i] for i in idx], bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, self.eps)
            u = torch._foreach_div([self.mu[i] for i in idx], bc1)
            torch._foreach_div_(u, den)
            if decay and self.weight_decay:
                torch._foreach_add_(u, torch._foreach_mul(ps, self.weight_decay))
            if scale != 1.0:
                torch._foreach_mul_(u, scale)
            torch._foreach_mul_(u, -lr)
            for i, ui in zip(idx, u):
                if i == self.temp_index:
                    p = self.params[i]
                    ui.copy_((p + ui).clamp(0.001, 0.5) - p)
            torch._foreach_add_(ps, u)
        return g_norm


def create_optimizer(model: nn.Module, schedule: Callable[[int], float], *,
                     weight_decay: float = 0.01, clip_grad_norm: Optional[float] = 1.0,
                     b1: float = 0.9, b2: float = 0.98, eps: float = 1e-8,
                     lr_mult: float = 1.0, vision_lr_scale: float = 1.0,
                     text_lr_scale: float = 1.0, cross_lr_scale: float = 1.0,
                     labels: Optional[Dict[str, str]] = None) -> AdamW:
    """AdamW over ``model``'s parameters with the reference's groups;
    ``labels`` from :func:`param_labels` (None: one group)."""
    return AdamW(model.named_parameters(), schedule, weight_decay=weight_decay,
                 clip_grad_norm=clip_grad_norm, b1=b1, b2=b2, eps=eps,
                 group_scale={"vision": vision_lr_scale, "text": text_lr_scale,
                              "cross": cross_lr_scale, "other": 1.0, "fresh": lr_mult},
                 labels=labels)
