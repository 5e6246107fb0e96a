"""Fine-tune epoch loop (the port's counterpart of
x2vlm_tpu/tasks/finetune.py; reference Retrieval.py:218-282): epochs from
a resume point, an eval after each (from ``start_eval`` on), a JSON-lines
``log.txt``, a save every epoch and the best epoch kept aside; and the
fixed-size batches the map-style evals run on."""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Optional

from x2vlm_tpu_torch.train.metrics import MetricLogger

__all__ = ["train_epochs", "append_log", "padded_batches"]


def append_log(output_dir: str, record: Dict):
    """One JSON line in ``output_dir/log.txt``."""
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "log.txt"), "a") as f:
        f.write(json.dumps(record) + "\n")


def padded_batches(dataset, batch_size: int):
    """(samples, rows) per batch of ``dataset`` in order: the last batch's
    rows padded with copies of its last sample, as the JAX eval loops pad
    it, so every call has ``batch_size`` rows; the copies' outputs are
    dropped."""
    n = len(dataset)
    for lo in range(0, n, batch_size):
        samples = [dataset[i] for i in range(lo, min(lo + batch_size, n))]
        yield samples, samples + [samples[-1]] * (batch_size - len(samples))


def train_epochs(step_fn: Callable[[Dict, int], Dict], loader, *, num_epochs: int,
                 start_epoch: int = 0, eval_fn: Optional[Callable[[], Dict]] = None,
                 eval_start_epoch: int = 0, metric_key: Optional[str] = None,
                 output_dir: Optional[str] = None,
                 save_fn: Optional[Callable[[int, bool], None]] = None,
                 log_every: int = 50) -> Optional[Dict]:
    """Run epochs ``start_epoch`` .. ``num_epochs - 1``. ``step_fn(batch,
    step)`` takes one host batch; ``save_fn(epoch, best)`` runs after each
    epoch, ``best`` when its eval beat every earlier one by ``metric_key``.
    Returns the last epoch's record."""
    best = float("-inf")
    record = None
    steps_per_epoch = len(loader)
    for epoch in range(start_epoch, num_epochs):
        logger = MetricLogger()
        if hasattr(loader, "set_epoch"):
            loader.set_epoch(epoch)
        for i, batch in enumerate(logger.log_every(iter(loader), log_every,
                                                   header=f"Epoch {epoch}:",
                                                   total=steps_per_epoch)):
            metrics = step_fn(batch, epoch * steps_per_epoch + i)
            logger.update(**metrics)
        record = {"epoch": epoch, **logger.to_dict()}
        is_best = False
        if eval_fn is not None and epoch >= eval_start_epoch:
            eval_metrics = eval_fn()
            record.update({f"eval_{k}": v for k, v in eval_metrics.items()})
            if metric_key and eval_metrics.get(metric_key, float("-inf")) > best:
                best = eval_metrics[metric_key]
                is_best = True
        if save_fn:
            save_fn(epoch, is_best)
        if output_dir:
            append_log(output_dir, record)
    return record
