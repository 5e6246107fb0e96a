"""Driver of the pretraining cells: X2-VLM's mixed-stream pretraining step
(image-text and region-text streams) through the port's ``pretrain_loop``.

The traffic file gives the job: the streams' batch sizes, the text lengths,
the masking, the optimizer and schedule (the launcher's YAML keys under
``yaml``) and the size of the pool of host batches. The pool is made from
the seed in the format the port's streams yield (uint8 NHWC images, int32
ids, region bitmaps, boxes) and cycled through the port's ``run.to_device``
in the window, so image decode and tokenisation are outside it.

Set-up builds the model with the launcher's factory, loads the seeded
weights, builds AdamW as the launcher does, and drives the same objects
through steps 0-2 with ``pretrain_loop``: those steps are the ones the
check holds against the reference, and they warm up every shape. The
window continues from step 3 until ``--seconds`` have passed on the host,
then waits for the card.
"""

from __future__ import annotations

import random
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench.lib import compare, flops, trace as trace_lib
from portbench.lib.harness import sync
from portbench.lib.weights import make_weights
from portbench.reference.adamw import AdamWRef, linear_schedule
from portbench.reference.x2vlm import Reference, param_spec, step_seeds, strict_fp32

__all__ = ["Cell", "make_pool", "numbers", "not_compared", "reference_readings",
           "fresh_names", "CHECKED_STEPS"]

CHECKED_STEPS = 3
# leaves whose gradient no ITM hard negative reaches: the ITC projections and
# temperature, the bbox head, the MLM head's transform and bias
DRAW_FREE = ("vision_proj.", "text_proj.", "temp", "bbox_head.",
             "text_encoder.cls.predictions.")
CLS, SEP, MASK, PAD = 101, 102, 103, 0
FIRST_WORD_ID = 1000
STREAMS = ("image", "region")


class WindowClosed(Exception):
    """Raised by the image feed at the start of the step after the last."""


class Feed:
    """The pool's batches from ``start`` on (step s takes batch s mod P),
    until ``stop(steps served)`` says the window is over."""

    def __init__(self, pool: List[Dict], start: int, stop=None):
        self.pool, self.i, self.stop, self.served = pool, start, stop, 0
        self.times: List[float] = []   # the host clock as each step asks

    def __iter__(self):
        return self

    def __next__(self):
        self.times.append(time.time())
        if self.stop is not None and self.stop(self.served):
            raise WindowClosed
        b = self.pool[self.i % len(self.pool)]
        self.i += 1
        self.served += 1
        return b


# ---------- traffic ----------

def _caption(rng, lo, hi, S, vocab, max_masks, mask_prob):
    """(ids, atts, ids_masked, masked_pos, masked_ids) of one caption of
    ``lo``..``hi`` tokens ([CLS] and [SEP] included), padded to ``S``."""
    n = int(rng.integers(lo, hi + 1))
    ids = np.full(S, PAD, np.int32)
    ids[0], ids[n - 1] = CLS, SEP
    ids[1:n - 1] = rng.integers(FIRST_WORD_ID, vocab, n - 2)
    atts = np.zeros(S, np.int32)
    atts[:n] = 1
    k = min(max_masks, max(1, int(round(mask_prob * (n - 2)))))
    pos = np.sort(rng.choice(np.arange(1, n - 1), size=k, replace=False))
    masked = ids.copy()
    r = rng.random(k)
    masked[pos[r < 0.8]] = MASK
    rand = (r >= 0.8) & (r < 0.9)
    masked[pos[rand]] = rng.integers(FIRST_WORD_ID, vocab, int(rand.sum()))
    mpos = np.zeros(max_masks, np.int32)
    mids = np.full(max_masks, -100, np.int32)
    mpos[:k], mids[:k] = pos, ids[pos]
    return ids, atts, masked, mpos, mids


def _texts(rng, rows, lo, hi, tr, vocab):
    cols = [_caption(rng, lo, hi, tr["max_tokens"], vocab, tr["max_masks"], tr["mask_prob"])
            for _ in range(rows)]
    keys = ("text_ids", "text_atts", "text_ids_masked", "masked_pos", "masked_ids")
    return {k: np.stack([c[i] for c in cols]) for i, k in enumerate(keys)}


def make_pool(tr: Dict, vocab: int, seed: int):
    """(image batches, region batches), ``tr["pool"]`` of each, from ``seed``."""
    rng = np.random.default_rng(seed % (2 ** 63))
    res, patch = tr["image_res"], tr["patch_size"]
    grid = res // patch
    images, regions = [], []
    for _ in range(tr["pool"]):
        b = _texts(rng, tr["image_batch"], *tr["caption_tokens"], tr, vocab)
        b["image"] = rng.integers(0, 256, (tr["image_batch"], res, res, 3), dtype=np.uint8)
        images.append(b)
        rows, group = [], []
        for img in range(tr["max_images"]):
            if rng.random() < tr["image_caption_share"]:
                rows.append((np.ones(1 + grid * grid, np.float32),
                             np.array([0.5, 0.5, 1.0, 1.0], np.float32), 1.0))
                group.append(img)
            for _ in range(int(rng.integers(1, tr["max_regions"] + 1))):
                w, h = rng.uniform(0.1, 0.9, 2) * res
                x, y = rng.uniform(0, res - w), rng.uniform(0, res - h)
                atts = np.zeros(1 + grid * grid, np.float32)
                atts[0] = 1
                x0, y0 = min(int(x // patch), grid - 1), min(int(y // patch), grid - 1)
                x1 = max(x0 + 1, min(int(np.ceil((x + w) / patch)), grid))
                y1 = max(y0 + 1, min(int(np.ceil((y + h) / patch)), grid))
                atts[1:].reshape(grid, grid)[y0:y1, x0:x1] = 1
                box = np.array([(x + w / 2) / res, (y + h / 2) / res, w / res, h / res],
                               np.float32)
                rows.append((atts, box, 0.0))
                group.append(img)
        n, B = len(rows), tr["region_batch"]
        keep = list(rng.choice(n, B, replace=False)) if n >= B else \
            list(range(n)) + list(rng.integers(0, n, B - n))
        r = _texts(rng, B, *tr["phrase_tokens"], tr, vocab)
        r["image_atts"] = np.stack([rows[i][0] for i in keep])
        r["target_bbox"] = np.stack([rows[i][1] for i in keep])
        r["is_image"] = np.asarray([rows[i][2] for i in keep], np.float32)
        r["idx_to_group_img"] = np.asarray([group[i] for i in keep], np.int32)
        r["image"] = rng.integers(0, 256, (tr["max_images"], res, res, 3), dtype=np.uint8)
        regions.append(r)
    return images, regions


def fresh_names(spec, fusion_layer: int) -> List[str]:
    """The parameters a start from the published BEiT-2 and BERT weights
    leaves fresh, which take ``lr_mult``: the fusion layers, the heads, the
    projections and the temperature."""
    def loaded(n):
        if n.startswith(("vision_encoder.", "text_encoder.cls.",
                         "text_encoder.bert.embeddings.")):
            return True
        if n.startswith("text_encoder.bert.encoder.layer."):
            return int(n.split(".")[4]) < fusion_layer
        return False
    return [n for n, _, _ in spec if not loaded(n)]


def model_block(config: Dict, tr: Dict) -> Dict:
    """The configuration's model block at the traffic's image size."""
    m = {k: dict(v) if isinstance(v, dict) else v for k, v in config["model"].items()}
    m["vision"]["image_res"] = tr["image_res"]
    return m


def total_steps(tr: Dict) -> int:
    y = tr["yaml"]
    return y["train_dataset_size"] // y["images"]["batch_size"] * y["schedular"]["epochs"]


# ---------- the cell ----------

class Cell:
    """One pretraining cell on one card (module docstring)."""

    def __init__(self, config: Dict, traffic: Dict, seed: int, device):
        self.config, self.tr, self.seed, self.device = config, traffic, seed, device
        self.m = model_block(config, traffic)
        self.spec = param_spec(self.m, "pretrain")
        self.fresh = fresh_names(self.spec, self.m["text"]["fusion_layer"])
        self.samples_per_step = traffic["image_batch"] + traffic["region_batch"]
        self.step_flops = flops.pretrain_step(self.m, traffic)
        self.readings: Dict = {}

    def _yaml(self) -> Dict:
        return {**self.config["yaml"], **self.tr["yaml"], "image_res": self.tr["image_res"]}

    def setup(self) -> None:
        from x2vlm_tpu_torch import run as launcher
        from x2vlm_tpu_torch.factory import build_model
        from x2vlm_tpu_torch.train.metrics import MetricLogger

        self.launcher = launcher
        self.MetricLogger = MetricLogger
        cfg = self._yaml()
        model, mcfg = build_model(cfg, "pretrain", device=self.device, seed=None)
        weights = make_weights(self.spec, self.seed, self.device)
        model.load_state_dict({f"base.{n}": t for n, t in weights.items()}, strict=True)
        del weights
        self.model = model
        self.optimizer = launcher.make_optimizer(cfg, model, total_steps(self.tr),
                                                 mcfg.text.fusion_layer,
                                                 fresh_names=self.fresh)
        vocab = self.m["text"]["vocab"]
        self.pool = make_pool(self.tr, vocab, self.seed)
        self.step = 0
        # steps 0-2, read for the check: step 0's ITC features, the losses,
        # the first gradient (from AdamW's first moment after one step), the
        # change after three
        logger = self._logger()
        seen = record_features(model.base)
        try:
            self._run(1, logger)
        finally:
            del model.base.get_features
        if len(seen) != 2 * len(STREAMS):
            raise RuntimeError(f"step 0 made {len(seen)} ITC feature sets, not "
                               f"{2 * len(STREAMS)}: the check cannot read them")
        self.readings["feat"] = {f"{s}.{kind}": seen[2 * i + j]
                                 for i, s in enumerate(STREAMS)
                                 for j, kind in enumerate(("image", "text"))}
        b1 = self.optimizer.b1
        self.readings["grad"] = {n[len("base."):]: float(m.norm()) / (1.0 - b1)
                                 for n, m in zip(self.optimizer.names, self.optimizer.mu)}
        self.readings["first_grad"] = {
            n[len("base."):]: (m / (1.0 - b1)).cpu()
            for n, m in zip(self.optimizer.names, self.optimizer.mu)
            if n[len("base."):].startswith(DRAW_FREE)}
        self._run(CHECKED_STEPS - 1, logger)
        logger.flush()
        self.readings["loss"] = {
            f"{s}.{k}.{i}": v for key, meter in logger.meters.items()
            for s in STREAMS if key.startswith(f"{s}_loss_") and key != f"{s}_loss_total"
            for k in [key[len(s) + 1:]] for i, v in enumerate(meter.deque)}
        init = make_weights(self.spec, self.seed, self.device)
        params = dict(model.named_parameters())
        self.readings["change"] = {n: float((params[f"base.{n}"].detach() - t).norm())
                                   for n, t in init.items()}
        del init

    def _logger(self):
        import sys
        return self.MetricLogger(print_fn=lambda s: print(s, file=sys.stderr))

    def _run(self, steps=None, logger=None, until=None) -> int:
        """Steps from ``self.step`` on through ``pretrain_loop``: ``steps``
        of them, or until the host clock passes ``until``."""
        from x2vlm_tpu_torch.tasks.pretrain import PretrainStreams, pretrain_loop
        if until is not None:
            stop = lambda served: time.time() >= until
        else:
            stop = lambda served: served >= steps
        image = Feed(self.pool[0], self.step, stop)
        streams = PretrainStreams(image=image, region=Feed(self.pool[1], self.step),
                                  image_weight=1.0, region_weight=1.0,
                                  rng=random.Random(self.seed))
        try:
            pretrain_loop(self.model, self.optimizer, streams,
                          num_steps=total_steps(self.tr), seed=self.seed,
                          to_device=lambda b: self.launcher.to_device(b, self.device),
                          start_step=self.step, logger=logger or self._logger())
        except WindowClosed:
            pass
        # the feed stops a step before serving it: every step served ran
        self.step += image.served
        self.feed_times = image.times
        return image.served

    def window(self, seconds: float) -> Dict:
        sync(self.device)
        t0 = time.time()
        steps = self._run(until=t0 + seconds)
        sync(self.device)
        dt = time.time() - t0
        # the host's seconds from one step's call to the next: the steps
        # are dispatched ahead of the card, so this is the host's pace
        host = np.diff(self.feed_times)
        return {"seconds": dt, "steps": steps, "attempted": steps,
                "counts": {"samples": steps * self.samples_per_step},
                "flops": steps * self.step_flops,
                "host_step_s": {q: float(np.quantile(host, f)) if host.size else 0.0
                                for q, f in (("p10", 0.1), ("p50", 0.5), ("p90", 0.9),
                                             ("max", 1.0))}}

    def trace(self, steps: int = 3):
        restore = trace_lib.annotate(self.optimizer, "step", "portbench.optimizer")
        try:
            with trace_lib.KernelTap() as tap:
                tr = trace_lib.traced(lambda: self._run(steps), tap,
                                      warm=lambda: self._run(1))
        finally:
            restore()
        tr.steps = steps
        return tr

    def release(self) -> None:
        del self.model, self.optimizer
        torch.cuda.empty_cache()

    def check(self) -> Dict:
        """{number: (value, where)} of the program's readings against the
        reference's (:func:`numbers`)."""
        self.ref = reference_readings(self.m, self.tr, self.pool, self.seed, self.device,
                                      self.fresh, first_grad=self.readings["first_grad"])
        return numbers(self.readings, self.ref)


def record_features(base) -> List[torch.Tensor]:
    """Shadow ``base.get_features`` (the program's ITC features, which the
    hard negatives are drawn from) on the instance with a copy that keeps
    each result, in float32 on the host, in the list returned; ``del
    base.get_features`` restores the method."""
    seen: List[torch.Tensor] = []
    method = type(base).get_features

    def recorded(*args, **kwargs):
        f = method(base, *args, **kwargs)
        seen.append(f.detach().float().cpu())
        return f

    base.get_features = recorded
    return seen


# ---------- the reference and the judgement ----------

def _on(batch: Dict, device) -> Dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def reference_readings(m: Dict, tr: Dict, pool, seed: int, device, fresh,
                       lowp: bool = False, first_grad: Optional[Dict] = None) -> Dict:
    """The readings of :meth:`Cell.setup` from the reference (``lowp``: the
    control), over the same steps, batches and seeds; with ``first_grad``
    (the judged side's first gradient of the leaves no hard negative
    reaches, ``DRAW_FREE``) also each such leaf's relative L2 distance of it
    from the reference's (``grad_diff``). The reference's own first gradient
    of those leaves is kept on the host (``first_grad``)."""
    strict_fp32()
    spec = param_spec(m, "pretrain")
    P = {n: t.clone().requires_grad_(True)
         for n, t in make_weights(spec, seed, device).items()}
    init = {n: t.detach().clone() for n, t in P.items()}
    y = tr["yaml"]
    opt = AdamWRef(P, linear_schedule(float(y["optimizer"]["lr"]), total_steps(tr),
                                      int(y["schedular"]["num_warmup_steps"])),
                   weight_decay=float(y["optimizer"]["weight_decay"]),
                   clip=float(y["accelerator"]["CLIP_GRAD_NORM"]), fresh=fresh,
                   lr_mult=float(y["optimizer"]["lr_mult"]))
    ref = Reference(P, m, lowp=lowp)
    out = {"loss": {}, "feat": {}}
    for step in range(CHECKED_STEPS):
        for si, s in enumerate(STREAMS):
            batch = _on(pool[si][step % len(pool[si])], device)
            gens = []
            for sd in step_seeds(seed, step, si):
                g = torch.Generator(device=device)
                g.manual_seed(sd)
                gens.append(g)
            losses = ref.pretrain_losses(batch, gens[0], gens[1], region=(s == "region"))
            if step == 0:
                out["feat"][f"{s}.image"], out["feat"][f"{s}.text"] = (
                    f.float().cpu() for f in ref.last_features)
            total = sum(losses.values())
            total.backward()
            for k, v in losses.items():
                out["loss"][f"{s}.{k}.{step}"] = float(v.detach())
            del losses, total
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for n, p in P.items()}
        opt.step(grads)
        for p in P.values():
            p.grad = None
        if step == 0:
            out["grad"] = {n: float(mu.norm()) / (1.0 - opt.b1) for n, mu in opt.mu.items()}
            g = {n: mu / (1.0 - opt.b1) for n, mu in opt.mu.items() if n.startswith(DRAW_FREE)}
            out["first_grad"] = {n: t.cpu() for n, t in g.items()}
            if first_grad is not None:
                out["grad_diff"] = {n: float((first_grad[n].to(device) - t).norm())
                                    / max(float(t.norm()), 1e-30) for n, t in g.items()}
    out["change"] = {n: float((P[n].detach() - init[n]).norm()) for n in P}
    return out


def numbers(prog: Dict, ref: Dict) -> Dict:
    """The compared numbers, each (value, where): over the checked steps the
    worst and the median relative loss gap; the worst and the median leaf's
    gap of the change's norm; of step 0's ITC features, the worst row's
    relative L2 distance from the reference's (taken before any hard
    negative is drawn, so the rounding moves no draw under them); and,
    where the reference was given the judged side's first gradient of the
    leaves no hard negative reaches (``grad_diff``), the worst such leaf's
    relative L2 distance of it from the reference's."""
    skip = compare.rounding_leaves(ref["grad"])
    out = {"loss_gap": compare.worst_rel_gap(prog["loss"], ref["loss"]),
           "change_gap": compare.worst_leaf_gap(prog["change"], ref["change"], skip),
           "loss_median_gap": compare.median_rel_gap(prog["loss"], ref["loss"]),
           "change_median_gap": compare.median_leaf_gap(prog["change"], ref["change"], skip),
           "feature_gap": max(compare.row_gaps(prog["feat"], ref["feat"]))}
    if "grad_diff" in ref:
        worst = max(ref["grad_diff"], key=ref["grad_diff"].get)
        out["head_grad_diff"] = (ref["grad_diff"][worst], worst)
    return out


def not_compared(prog: Dict, ref: Dict) -> Dict:
    """Readings kept for the record and not compared (no upper reading):
    the worst leaf's gap of the first gradient's norm."""
    skip = compare.rounding_leaves(ref["grad"])
    return {"grad_gap": compare.worst_leaf_gap(prog["grad"], ref["grad"], skip)}
