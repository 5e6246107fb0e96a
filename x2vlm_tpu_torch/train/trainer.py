"""The train step (counterpart of x2vlm_tpu/train/trainer.py).

A step is :func:`make_grad_fn` on each part of the step (its loss times a
weight, backward into the same ``.grad``) and one :func:`make_apply_grads`
after the last part: one AdamW step, one clip over the summed gradient, as
the JAX ``make_grad_fn`` / ``make_apply_grads`` sum their gradient trees.
The multi-stream step of pretraining takes one part per stream, weighted by
its ``iter_perc``.

Data parallelism (core/mesh.py): each rank runs the parts on its own rows
inside ``mesh.data_parallel``, where the losses see the global batch, and
:func:`make_apply_grads` replaces every ``.grad`` by its mean over the
ranks before the optimizer's clip, so the clip and the update see the
global gradient, as in the JAX step. The all-reduce is explicit (flat
buckets, ``mesh.all_reduce_grads``), not DDP's hooks: a step runs one
backward per stream and microbatch into the same ``.grad``, and the
streams leave different parameters unused (the bbox head off the region
stream, the vision tower on the text streams), so one reduce after the
last backward is both the cheaper and the simpler schedule. The returned
losses are their means over the ranks, the global-batch values.

``make_train_step(model, optimizer)`` returns ``step(batch, generator,
dropout_generator) -> metrics`` for one stream. ``generator`` draws the ITM
hard negatives and ``dropout_generator`` every dropout mask, so a step is
reproducible from the two generators' states. ``accum_steps > 1`` splits
the batch along its first dim into that many microbatches, each a part
weighted ``1 / accum_steps`` (the JAX package's scan). In-batch losses
(ITC, ITM negatives) then see microbatch-local negatives, as in the
reference's accumulation.

A VQA batch (one with ``answer_index``: its answer rows are not its
questions) splits by question (:func:`split_batch`): microbatch i takes
questions ``[i * mb, (i + 1) * mb)`` and every answer row, those of its own
questions with their weights and the index rebased, the rest at weight 0
pointing at its first question. Every microbatch keeps the batch's shapes
of answer rows, and since ``loss_vqa`` sums the weighted answer losses over
the question count, the accumulated step's loss and gradient are the
unsplit step's up to summation order: ``accumulate_steps`` only caps
memory, as the JAX launcher documents it. (The JAX step splits every leaf
along its first dim, so a microbatch's ``answer_index`` still counts the
whole batch's questions and reads out of range.) Any other batch whose
tensors differ in rows raises.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
from torch import nn

from x2vlm_tpu_torch.core import mesh
from x2vlm_tpu_torch.train.optim import AdamW

__all__ = ["make_train_step", "make_grad_fn", "make_apply_grads", "split_batch"]

# the per-answer-row keys of a VQA train batch (data/finetune.vqa_collate)
ANSWER_KEYS = ("answer_ids", "answer_atts", "answer_weights", "answer_index")


def _total_loss(losses: Dict[str, torch.Tensor],
                weights: Optional[Dict[str, float]] = None) -> torch.Tensor:
    """Sum of the losses (fp32), each times its weight (default 1)."""
    total = 0.0
    for k, v in losses.items():
        total = total + (1.0 if weights is None else weights.get(k, 1.0)) * v.float()
    return total


def make_grad_fn(model: nn.Module, *, loss_weights: Optional[Dict[str, float]] = None,
                 loss_scale: float = 1.0, apply_kwargs: Optional[Dict] = None
                 ) -> Callable[..., Dict[str, torch.Tensor]]:
    """One stream's part of the multi-stream step: ``grad_fn(batch,
    generator, dropout_generator)`` runs the model in train mode (with
    ``apply_kwargs``, e.g. ``ret_match_loss``) and adds the gradient of
    ``loss_scale`` times the weighted total into each parameter's
    ``.grad``. Returns the losses unscaled (device scalars), with
    ``loss_total`` the scaled total, as the JAX ``make_grad_fn``."""
    kwargs = dict(apply_kwargs or {})

    def grad_fn(batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None,
                dropout_generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        model.train()
        with mesh.data_parallel():
            losses = model(batch, generator, dropout_generator, **kwargs)
            total = loss_scale * _total_loss(losses, loss_weights)
            total.backward()
        out = {k: v.detach().float() for k, v in losses.items()}
        out["loss_total"] = total.detach()
        return _rank_mean(out)

    return grad_fn


def _rank_mean(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The scalars' means over the ranks (one all-reduce); at world 1 as
    they are."""
    world = mesh.process_count()
    if world == 1:
        return metrics
    stacked = torch.stack([metrics[k] for k in metrics])
    torch.distributed.all_reduce(stacked)
    return dict(zip(metrics, (stacked / world).unbind()))


def make_apply_grads(optimizer: AdamW) -> Callable[[], torch.Tensor]:
    """``apply_grads()``: one optimizer step over the summed ``.grad`` of
    the streams, averaged over the ranks first, which it then clears for
    the next step. Returns the pre-clip gradient norm."""

    def apply_grads() -> torch.Tensor:
        mesh.all_reduce_grads(optimizer.params)
        g_norm = optimizer.step()
        for p in optimizer.params:
            p.grad = None
        return g_norm

    return apply_grads


def _split_rows(batch: Dict[str, torch.Tensor], keys, n: int, what: str):
    """(rows of ``keys``' tensors, rows a microbatch) for ``n`` microbatches;
    raises unless they all have one row count that ``n`` divides."""
    rows = {batch[k].shape[0] for k in keys}
    if len(rows) != 1:
        raise ValueError(f"accumulation splits {what} along their first dim; this batch's "
                         f"tensors have {sorted(rows)} rows")
    rows = rows.pop()
    if rows % n:
        raise ValueError(f"batch of {rows} rows does not split into {n} microbatches")
    return rows, rows // n


def split_batch(batch: Dict[str, torch.Tensor], n: int) -> List[Dict[str, torch.Tensor]]:
    """``batch`` as ``n`` microbatches along its first dim; a VQA batch (with
    ``answer_index``) by question, every microbatch holding all the answer
    rows, those of other questions at weight 0 (module docstring)."""
    if n == 1:
        return [batch]
    tensors = [k for k, v in batch.items() if torch.is_tensor(v)]
    if "answer_index" not in batch:
        _, mb = _split_rows(batch, tensors, n, "every tensor")
        return [{k: v[i * mb:(i + 1) * mb] if torch.is_tensor(v) else v
                 for k, v in batch.items()} for i in range(n)]
    _, mb = _split_rows(batch, [k for k in tensors if k not in ANSWER_KEYS], n,
                        "the question tensors")
    index = batch["answer_index"]
    out = []
    for i in range(n):
        lo = i * mb
        own = (index >= lo) & (index < lo + mb)
        part = {k: v[lo:lo + mb] if torch.is_tensor(v) and k not in ANSWER_KEYS else v
                for k, v in batch.items()}
        part["answer_weights"] = torch.where(own, batch["answer_weights"],
                                             torch.zeros_like(batch["answer_weights"]))
        part["answer_index"] = torch.where(own, index - lo, torch.zeros_like(index))
        out.append(part)
    return out


def make_train_step(model: nn.Module, optimizer: AdamW, *,
                    loss_weights: Optional[Dict[str, float]] = None,
                    accum_steps: int = 1) -> Callable[..., Dict[str, torch.Tensor]]:
    """One optimizer step per call: :func:`make_grad_fn` on each microbatch
    with ``loss_scale = 1 / accum_steps``, then :func:`make_apply_grads`.
    The metrics are the losses (means over the microbatches),
    ``loss_total`` and the pre-clip ``grad_norm``, as device scalars."""
    grad_fn = make_grad_fn(model, loss_weights=loss_weights, loss_scale=1.0 / accum_steps)
    apply_grads = make_apply_grads(optimizer)

    def step(batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None,
             dropout_generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        for p in optimizer.params:
            p.grad = None
        n = accum_steps
        sums: Dict[str, torch.Tensor] = {}
        for mb in split_batch(batch, n):
            for k, v in grad_fn(mb, generator, dropout_generator).items():
                sums[k] = sums.get(k, 0.0) + v
        metrics = {k: v if k == "loss_total" else v / n for k, v in sums.items()}
        metrics["grad_norm"] = apply_grads()
        return metrics

    return step
