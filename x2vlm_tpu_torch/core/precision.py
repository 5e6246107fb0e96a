"""The dtype policy and an fp16 loss scaler (the port's counterpart of
x2vlm_tpu/core/precision.py; reference accelerators/apex_ddp_accelerator.py:
79-89, Apex AMP).

The port keeps fp32 parameters and computes in bf16, with LayerNorm
statistics and softmax in fp32 (:data:`DEFAULT_POLICY`). bf16 has fp32's
exponent range, so no step scales its loss. :class:`DynamicLossScale` is
there for fp16 parity runs: Apex's dynamic scaler within the bounds the
reference configures (max 1024, min 1; configs/pretrain/x2vlm_base_4m.yaml
``FP16_LOSS_SCALE``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

__all__ = ["Policy", "DEFAULT_POLICY", "FP32_POLICY", "cast_floating", "DynamicLossScale",
           "all_finite"]


@dataclasses.dataclass(frozen=True)
class Policy:
    """Parameters kept in ``param_dtype``, matmuls and activations in
    ``compute_dtype``, normalisation statistics and softmax in
    ``norm_dtype``."""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    norm_dtype: torch.dtype = torch.float32

    def cast_to_compute(self, tree):
        return cast_floating(tree, self.compute_dtype)

    def cast_to_param(self, tree):
        return cast_floating(tree, self.param_dtype)


DEFAULT_POLICY = Policy()
FP32_POLICY = Policy(compute_dtype=torch.float32)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _map(fn, tree):
    if isinstance(tree, dict):
        return type(tree)((k, _map(fn, v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def cast_floating(tree, dtype: torch.dtype):
    """Every floating tensor of a nested dict / list / tuple in ``dtype``;
    other leaves as they are."""
    return _map(lambda x: x.to(dtype) if torch.is_tensor(x) and x.is_floating_point() else x,
                tree)


@dataclasses.dataclass
class DynamicLossScale:
    """Apex's dynamic loss scaling: the scale doubles (up to ``max_scale``)
    after ``growth_interval`` good steps in a row and halves (down to
    ``min_scale``) on a step whose gradients are not all finite, which the
    caller then skips. The scale and the count are device tensors, so
    :meth:`update` needs no host sync."""

    scale: torch.Tensor
    good_steps: torch.Tensor
    growth_interval: int = 2000
    max_scale: float = 1024.0
    min_scale: float = 1.0

    @classmethod
    def create(cls, init_scale: float = 1024.0, growth_interval: int = 2000,
               device: Any = None) -> "DynamicLossScale":
        return cls(scale=torch.tensor(init_scale, dtype=torch.float32, device=device),
                   good_steps=torch.tensor(0, dtype=torch.int32, device=device),
                   growth_interval=growth_interval)

    def scale_loss(self, loss: torch.Tensor) -> torch.Tensor:
        return loss * self.scale.to(loss.dtype)

    def unscale_grads(self, grads):
        inv = 1.0 / self.scale
        return _map(lambda g: g * inv.to(g.dtype), grads)

    def update(self, grads_finite: torch.Tensor) -> "DynamicLossScale":
        grads_finite = torch.as_tensor(grads_finite, device=self.scale.device)
        grow = (self.good_steps + 1) >= self.growth_interval
        scale = torch.where(
            grads_finite,
            torch.where(grow, torch.clamp(self.scale * 2.0, max=self.max_scale), self.scale),
            torch.clamp(self.scale * 0.5, min=self.min_scale))
        good = torch.where(grads_finite & ~grow, self.good_steps + 1,
                           torch.zeros_like(self.good_steps))
        return dataclasses.replace(self, scale=scale, good_steps=good)


def all_finite(tree) -> torch.Tensor:
    """A bool tensor: every floating leaf of ``tree`` holds finite values
    only (True for a tree without one)."""
    finite = [torch.isfinite(x).all() for x in _leaves(tree)
              if torch.is_tensor(x) and x.is_floating_point()]
    return torch.stack(finite).all() if finite else torch.tensor(True)
