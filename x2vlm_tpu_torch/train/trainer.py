"""The train step (counterpart of x2vlm_tpu/train/trainer.py).

``make_train_step(model, optimizer)`` returns ``step(batch, generator,
dropout_generator) -> metrics``: the model in train mode, forward, the
weighted total loss, backward, the optimizer update. ``generator`` draws
the ITM hard negatives and ``dropout_generator`` every dropout mask, so a
step is reproducible from the two generators' states.

``accum_steps > 1`` splits the batch along its first dim into that many
microbatches, sums their gradients and divides by ``accum_steps`` (the JAX
package's scan). In-batch losses (ITC, ITM negatives) then see
microbatch-local negatives, as in the reference's accumulation.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import nn

from x2vlm_tpu_torch.train.optim import AdamW

__all__ = ["make_train_step"]


def _total_loss(losses: Dict[str, torch.Tensor],
                weights: Optional[Dict[str, float]] = None) -> torch.Tensor:
    """Sum of the losses (fp32), each times its weight (default 1)."""
    total = 0.0
    for k, v in losses.items():
        total = total + (1.0 if weights is None else weights.get(k, 1.0)) * v.float()
    return total


def make_train_step(model: nn.Module, optimizer: AdamW, *,
                    loss_weights: Optional[Dict[str, float]] = None,
                    accum_steps: int = 1) -> Callable[..., Dict[str, torch.Tensor]]:
    """One optimizer step per call. The metrics are the losses (means over
    the microbatches), ``loss_total`` and the pre-clip ``grad_norm``, as
    device scalars. The averaged gradients stay in ``.grad`` until the next
    step."""

    def step(batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None,
             dropout_generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        model.train()
        for p in optimizer.params:
            p.grad = None
        n = accum_steps
        rows = next(v.shape[0] for v in batch.values() if torch.is_tensor(v))
        if rows % n:
            raise ValueError(f"batch of {rows} rows does not split into {n} microbatches")
        mb_rows = rows // n
        sums: Dict[str, torch.Tensor] = {}
        for i in range(n):
            mb = {k: v[i * mb_rows:(i + 1) * mb_rows] if torch.is_tensor(v) else v
                  for k, v in batch.items()}
            losses = model(mb, generator, dropout_generator)
            losses["loss_total"] = _total_loss(losses, loss_weights)
            losses["loss_total"].backward()
            for k, v in losses.items():
                sums[k] = sums.get(k, 0.0) + v.detach().float()
        if n > 1:
            torch._foreach_div_([p.grad for p in optimizer.params if p.grad is not None], n)
        metrics = {k: v / n for k, v in sums.items()}
        metrics["grad_norm"] = optimizer.step()
        return metrics

    return step
