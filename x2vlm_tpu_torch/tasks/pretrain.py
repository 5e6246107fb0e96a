"""Mixed-stream pretraining loop (the port's counterpart of
x2vlm_tpu/tasks/pretrain.py; reference Pretrain.py:189-423).

As in the JAX package:

- every stream with a loader is drawn every iteration; its loss is weighted
  by the config's ``iter_perc`` (a loss weight, not a draw probability);
- ``aux_iter_perc`` is a probability: with it the image batch is replaced
  by a clean-data (aux) batch; when an aux stream exists, noisy image
  batches never compute the matching loss;
- the video stream (5-D frame batches through the image stream's losses)
  takes the image batch's matching-loss flag: when a noisy image batch was
  drawn beside an aux stream, the video batch computes no matching loss
  either; ``video_aux_iter_perc`` replaces the video batch by a video-aux
  batch the same way, drawn from the same rng after the image draw;
- ``stop_calc_itm`` turns the matching loss off from that step on, on the
  image and the region streams;
- the region stream adds the bbox losses (L1 + GIoU); with
  ``regions_use_bbox_only`` its ITC / ITM / MLM weigh 0, and
  ``calc_image_bbox_loss`` keeps its full-image rows in the bbox losses;
- the parallel-text (mtext) stream drives the CCLM TTC / TTM / TLM
  objectives (reference Pretrain.py:238-247): its batch has no image,
  which routes it to ``XVLMPlusForPretrain.forward_para_text``, and its
  metrics are prefixed ``mtext_``;
- the streams' gradients are summed in ``.grad`` and applied in one
  optimizer step (``train/trainer.py`` ``make_grad_fn`` /
  ``make_apply_grads``).

Randomness: each step draws its hard negatives and dropout masks from
generators seeded by (seed, step, stream), as the JAX loop folds the step
into its key (stream 4 for the parallel text, as the JAX loop folds 4),
so a resumed run draws what the uninterrupted one would.
"""

from __future__ import annotations

import random
from typing import Callable, Dict, Iterator, Optional

import torch
from torch import nn

from x2vlm_tpu_torch.train.metrics import MetricLogger
from x2vlm_tpu_torch.train.trainer import make_apply_grads, make_grad_fn

__all__ = ["PretrainStreams", "pretrain_loop", "step_generators"]


class PretrainStreams:
    """Per-stream infinite batch iterators, their loss weights (``iter_perc``),
    the aux replacement probabilities (``aux_iter_perc``,
    ``video_aux_iter_perc``) and ``regions_use_bbox_only``."""

    def __init__(self, image: Iterator, region: Optional[Iterator] = None,
                 text: Optional[Iterator] = None, aux: Optional[Iterator] = None,
                 video: Optional[Iterator] = None, video_aux: Optional[Iterator] = None,
                 mtext: Optional[Iterator] = None,
                 image_weight: float = 1.0, region_weight: float = 1.0,
                 text_weight: float = 1.0, video_weight: float = 1.0,
                 mtext_weight: float = 1.0, aux_perc: float = 0.0,
                 video_aux_perc: float = 0.0, regions_use_bbox_only: bool = False,
                 rng: Optional[random.Random] = None):
        self.image = image
        self.region = region
        self.text = text
        self.mtext = mtext
        self.mtext_weight = mtext_weight
        self.aux = aux
        self.video = video
        self.video_aux = video_aux
        self.image_weight = image_weight
        self.region_weight = region_weight
        self.text_weight = text_weight
        self.video_weight = video_weight
        self.aux_perc = aux_perc
        self.video_aux_perc = video_aux_perc
        self.regions_use_bbox_only = regions_use_bbox_only
        self.rng = rng or random.Random(0)


def step_generators(device, seed: int, step: int, stream: int):
    """(negatives generator, dropout generator) of one stream at one step."""
    gens = []
    for i in range(2):
        g = torch.Generator(device=device)
        g.manual_seed(((seed * 1_000_003 + step) * 8 + stream) * 2 + i)
        gens.append(g)
    return tuple(gens)


def pretrain_loop(
    model: nn.Module,
    optimizer,
    streams: PretrainStreams,
    *,
    num_steps: int,
    seed: int,
    to_device: Callable[[Dict], Dict],
    stop_calc_itm_after: Optional[int] = None,
    calc_image_bbox_loss: bool = False,
    start_step: int = 0,
    log_every: int = 50,
    logger: Optional[MetricLogger] = None,
    checkpoint_fn: Optional[Callable[[int], None]] = None,
    checkpoint_every: int = 0,
    epoch_steps: int = 0,
    epoch_save_frequent: int = 1,
    extra_metrics: Optional[Callable[[], Dict[str, float]]] = None,
) -> MetricLogger:
    """Run mixed iterations from ``start_step`` (resume) to ``num_steps``.

    ``to_device`` turns a host batch (numpy) into the model's tensors.
    ``calc_image_bbox_loss`` keeps the region stream's full-image rows in
    the bbox losses (its ``is_image`` zeroed, the shape kept).
    ``checkpoint_fn(step)`` runs every ``checkpoint_every`` steps
    (``ckpt_frequent_step``), at every ``epoch_save_frequent``-th epoch
    boundary of ``epoch_steps`` steps (``ckpt_frequent``) and after the last
    step. ``extra_metrics()`` adds host counters (the streams' ``broken``)
    to every step's record. Returns the logger."""
    logger = logger or MetricLogger()
    s = streams
    device = next(model.parameters()).device
    image_grads: Dict = {}

    def image_grad_fn(weight, itm):
        if (weight, itm) not in image_grads:
            image_grads[(weight, itm)] = make_grad_fn(
                model, loss_scale=weight, apply_kwargs={"ret_match_loss": itm})
        return image_grads[(weight, itm)]

    # bbox-only regions: ITC / ITM / MLM weigh 0 (reference Pretrain.py:216-220)
    region_weights = ({"loss_itc": 0.0, "loss_itm": 0.0, "loss_mlm": 0.0}
                      if s.regions_use_bbox_only else None)
    grad_region = {itm: make_grad_fn(model, loss_scale=s.region_weight,
                                     loss_weights=region_weights,
                                     apply_kwargs={"ret_bbox_loss": True,
                                                   "ret_match_loss": itm})
                   for itm in (True, False)}
    grad_text = make_grad_fn(model, loss_scale=s.text_weight)
    grad_mtext = make_grad_fn(model, loss_scale=s.mtext_weight)
    apply_grads = make_apply_grads(optimizer)
    for p in optimizer.params:
        p.grad = None

    last_saved = -1
    for it in logger.log_every(range(start_step, num_steps), log_every, header="Pretrain:",
                               total=num_steps):
        calc_itm = stop_calc_itm_after is None or it < stop_calc_itm_after
        if s.aux is not None:
            if s.rng.random() < s.aux_perc:
                batch, itm = next(s.aux), calc_itm
            else:
                batch, itm = next(s.image), False   # noisy: no matching loss
        else:
            batch, itm = next(s.image), calc_itm
        losses = image_grad_fn(s.image_weight, itm)(
            to_device(batch), *step_generators(device, seed, it, 0))
        metrics = {f"image_{k}": v for k, v in losses.items()}
        if s.region is not None:
            rb = dict(next(s.region))
            if calc_image_bbox_loss:
                rb["is_image"] = rb["is_image"] * 0
            losses = grad_region[calc_itm](to_device(rb), *step_generators(device, seed, it, 1))
            metrics.update({f"region_{k}": v for k, v in losses.items()})
        if s.video is not None:
            if s.video_aux is not None and s.rng.random() < s.video_aux_perc:
                vb = next(s.video_aux)
            else:
                vb = next(s.video)
            # the image batch's matching flag, as the JAX loop passes it
            losses = image_grad_fn(s.video_weight, itm)(
                to_device(vb), *step_generators(device, seed, it, 2))
            metrics.update({f"video_{k}": v for k, v in losses.items()})
        if s.text is not None:
            tb = dict(to_device(next(s.text)))
            tb["image"] = None
            losses = grad_text(tb, *step_generators(device, seed, it, 3))
            metrics.update({f"text_{k}": v for k, v in losses.items()})
        if s.mtext is not None:
            mb = dict(to_device(next(s.mtext)))
            mb["image"] = None   # routes the Plus model to forward_para_text
            losses = grad_mtext(mb, *step_generators(device, seed, it, 4))
            metrics.update({f"mtext_{k}": v for k, v in losses.items()})
        metrics["grad_norm"] = apply_grads()
        logger.update(**metrics)
        if extra_metrics is not None:
            logger.update(**extra_metrics())

        if checkpoint_fn:
            step_hit = checkpoint_every and (it + 1) % checkpoint_every == 0
            epoch_hit = (epoch_steps and (it + 1) % epoch_steps == 0
                         and (((it + 1) // epoch_steps) % max(1, epoch_save_frequent) == 0
                              or it + 1 == num_steps))
            if (step_hit or epoch_hit) and last_saved != it + 1:
                checkpoint_fn(it + 1)
                last_saved = it + 1
    if checkpoint_fn and last_saved != num_steps:
        checkpoint_fn(num_steps)
    return logger
