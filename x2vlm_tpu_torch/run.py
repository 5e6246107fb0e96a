"""The launcher (the port's counterpart of x2vlm_tpu/run.py), for the JAX
launcher's sixteen tasks: ``pretrain``, ``retrieval``, ``video_retrieval``,
``grounding``, ``nlvr``, ``vqa``, ``captioning``, ``video_qa``,
``next_qa_mc``, ``classification`` (its config's ``dataset_type``) and the
IGLUE tasks ``xretrieval``, ``wit``, ``xflickrco``, ``xgqa``, ``marvl`` and
``xvnli``.

Usage:
    python -m x2vlm_tpu_torch.run --task retrieval \\
        --config configs/finetune/retrieval_flickr_base.yaml --output_dir out/ \\
        [--checkpoint x2vlm_base_4m.th] [--evaluate] [--resume] \\
        [--override_cfg "batch_size:64;optimizer.lr:2e-5"] [--device cuda]

The flags are the JAX launcher's, less ``--fsdp`` and ``--output_hdfs``
(multi-GPU and remote storage, ROADMAP A4), plus ``--device`` (default
``cuda``; ``cpu`` runs the plain PyTorch path, as the tests do). One
process, one card.

- ``--checkpoint`` a reference ``.th`` (or a published CLIP / Swin / BEiT-2
  / HF BERT file): imported under the reference names by its flavour, the
  rel-pos tables interpolated to the config's resolution
  (train/checkpoint.py); the parameters it leaves fresh train at
  ``optimizer.lr_mult``. A directory: the parameters of a train state this
  launcher saved (another task's, e.g. a CCLM pretraining state for an IGLUE
  fine-tune, loads its core as a ``.th`` does, the heads it lacks fresh).
  Without it, the vision JSON's ``ckpt`` and the text
  encoder's ``pytorch_model.bin`` initialise the model where they exist.
- ``--resume`` restores the train state in ``output_dir/ckpt`` (parameters,
  AdamW ``mu`` / ``nu`` / ``count``, step) and, for pretraining, the data
  cursors of the streams (image, aux, region, video, video aux, text,
  parallel text), so the run continues where it stopped.
- ``model_type: cclm`` (the Plus / CCLM base, models/xvlm_plus.py) runs
  ``pretrain`` (with the multilingual ``languages`` streams and the
  parallel-text ``mtexts`` stream) and every fine-tune task, the IGLUE
  ones among them; ``is_xvlm_ckpt`` splits an X2-VLM ``.th`` into the Plus
  text tower and cross encoder.
- ``--fewshot <lang>,<shots>`` (IGLUE few-shot) fills the ``{}`` templates
  of ``train_file`` / ``valid_file`` / ``val_file`` / ``test_file``: a path
  of two or more slots takes the parts in order; a path of one slot takes
  the language alone in ``val_file`` / ``test_file`` and the joined
  ``<lang>,<shots>`` in the others (the JAX ``setup``).
- ``--evaluate`` evaluates only (the fine-tune tasks): retrieval's R@k,
  grounding's IoU >= 0.5 accuracy per split (``refs_file``; a VLUE test
  set with ``vlue_test``), NLVR2's accuracy (per split when ``test_file``
  is a dict; MARVL's languages), XVNLI's accuracy, VQA's and xGQA's
  answers ranked over ``answer_list`` (written to ``vqa_result.json``, or
  ``vqa_result_<lang>.json`` a language; the VQAv2 accuracy ``overall`` and
  the exact-match ``acc`` where the test lines carry answers), captioning's beam-search
  captions scored with BLEU-1..4, CIDEr-D (``cider`` picks the best epoch),
  ROUGE-L and METEOR against ``caption_gt_file``; video QA's and NExT-QA's
  accuracy; video retrieval's R@k (``pick_best_t2v`` picks the best epoch
  by text-to-video recall, ``img_r_mean``).
- ``scst: true`` (captioning) fine-tunes with self-critical sequence
  training instead of the MLM loss: sampled rollouts, CIDEr-D advantages.

The config is validated against the JAX package's key registry
(core/config_schema.py). ``native_aug`` picks the pretraining streams'
decoder as the JAX launcher does: ``auto`` (the default) the C++ data
plane (``data/native.py``) when it builds and PIL when it does not,
``true`` the data plane or an error, ``false`` PIL; the pretraining
record's ``data_plane`` names what each stream took. What the port does
not run raises, as in the JAX launcher: ``mixed_in_batch: false`` and
``tokenized: true``.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import time
from typing import Dict, List

import numpy as np
import torch

from x2vlm_tpu_torch.core import config as config_lib
from x2vlm_tpu_torch.core import config_schema
from x2vlm_tpu_torch.data.loader import MapLoader, Prefetcher, batch_indices, collate
from x2vlm_tpu_torch.device import resolve_device
from x2vlm_tpu_torch.factory import build_model, is_plus_config
from x2vlm_tpu_torch.tasks.finetune import append_log, train_epochs
from x2vlm_tpu_torch.tasks.pretrain import step_generators
from x2vlm_tpu_torch.train import create_optimizer, lr_schedule, make_train_step, param_labels
from x2vlm_tpu_torch.train import checkpoint as ckpt_lib

__all__ = ["TASKS", "parse_args", "setup", "fill_fewshot", "make_optimizer",
           "maybe_resume", "load_initial_params", "eval_multi", "finetune", "run_retrieval",
           "run_grounding", "run_nlvr", "SeededLoader", "VQALoader", "run_vqa",
           "run_captioning", "run_classification", "run_pretrain", "main", "to_device"]

TASKS = ("pretrain", "retrieval", "xretrieval", "wit", "xflickrco", "video_retrieval", "vqa",
         "xgqa", "nlvr", "marvl", "grounding", "captioning", "classification", "xvnli",
         "video_qa", "next_qa_mc")
# the dataset types ``run_classification`` runs: video QA over an answer
# list, NExT-QA multiple choice, and XVNLI's three labels
VIDEO_QA_TASKS = ("video_qa", "vqa_msrvtt", "vqa_msvd")
MULTIPLE_CHOICE_TASKS = ("next_qa_mc", "video_qa_mc")
LABEL_TASKS = ("xvnli",)
# --fewshot's path keys; the last two take the language alone in a one-slot
# template
FEWSHOT_KEYS = ("train_file", "valid_file", "val_file", "test_file")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--task", required=True, choices=TASKS)
    p.add_argument("--config", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--checkpoint", default="",
                   help="a reference .th to import, or a train-state directory")
    p.add_argument("--evaluate", action="store_true")
    p.add_argument("--resume", action="store_true",
                   help="resume the train state (+ the pretraining data cursors) from "
                        "output_dir/ckpt")
    p.add_argument("--override_cfg", default="")
    p.add_argument("--seed", default=42, type=int)
    p.add_argument("--bs", default=-1, type=int, help="override batch_size")
    p.add_argument("--epoch", default=-1, type=int, help="override epochs")
    p.add_argument("--wait", default=0, type=int, help="minutes to sleep before starting")
    p.add_argument("--fewshot", default="",
                   help="IGLUE few-shot, <lang>,<shots> (e.g. ar,25): fills the '{}' "
                        "templates of the config's data paths")
    p.add_argument("--lr", default=0.0, type=float, help="override the learning rate")
    p.add_argument("--k_test", default=-1, type=int, help="override the rerank depth")
    p.add_argument("--num_workers", default=-1, type=int,
                   help="override every stream block's num_workers")
    p.add_argument("--pick_best_r1", action="store_true",
                   help="retrieval: track the best checkpoint by mean(txt_r1, img_r1)")
    p.add_argument("--gmt", action="store_true",
                   help="use the machine-translated test set (test_file := gmt_test_file)")
    p.add_argument("--device", default="cuda",
                   help="the card (default) or cpu, the plain PyTorch path")
    return p.parse_args(argv)


def setup(args):
    """The config with the command line's overrides, validated, its
    ``--fewshot`` templates filled, dumped to ``output_dir/config.json``;
    the global RNGs seeded."""
    os.makedirs(args.output_dir, exist_ok=True)
    cfg = config_lib.load_config(args.config, overrides=args.override_cfg)
    config_schema.validate_config(cfg, source=args.config)
    if args.fewshot:
        fill_fewshot(cfg, args.fewshot)
    if args.bs > 0:
        cfg["batch_size"] = args.bs
    if args.epoch > 0:
        cfg["schedular"] = dict(cfg.get("schedular", {}), epochs=args.epoch)
    if args.lr > 0:
        cfg["optimizer"] = dict(cfg.get("optimizer", {}), lr=args.lr)
        cfg["schedular"] = dict(cfg.get("schedular", {}), lr=args.lr)
    if args.k_test > 0:
        cfg["k_test"] = args.k_test
    if args.num_workers > 0:
        for block in ("images", "regions", "videos", "texts", "mtexts"):
            if isinstance(cfg.get(block), dict):
                cfg[block] = dict(cfg[block], num_workers=args.num_workers)
    if args.pick_best_r1:
        cfg["pick_best_r1"] = True
    if args.gmt:
        if "gmt_test_file" not in cfg:
            raise ValueError("--gmt requires `gmt_test_file` in the config")
        cfg["test_file"] = cfg["gmt_test_file"]
    random.seed(args.seed)
    np.random.seed(args.seed)
    torch.manual_seed(args.seed)
    with open(os.path.join(args.output_dir, "config.json"), "w") as f:
        json.dump(cfg.to_dict(), f, indent=1)
    return cfg


def fill_fewshot(cfg, fewshot: str) -> None:
    """``--fewshot <lang>,<shots>``: the ``{}`` templates of ``cfg``'s
    ``FEWSHOT_KEYS`` filled in place (a path or a list of paths; the JAX
    launcher's three variants): two or more slots take the parts in order;
    one slot takes the language alone in ``val_file`` / ``test_file`` and
    the joined string in the others."""
    parts = fewshot.split(",")

    def fill(path, lang_only: bool):
        if not (isinstance(path, str) and "{}" in path):
            return path
        n = path.count("{}")
        if n >= 2:
            return path.format(*parts[:n])
        return path.format(parts[0] if lang_only else fewshot)

    for key in FEWSHOT_KEYS:
        if key in cfg:
            v, lang_only = cfg[key], key in ("val_file", "test_file")
            cfg[key] = [fill(p, lang_only) for p in v] if isinstance(v, list) \
                else fill(v, lang_only)


def make_optimizer(cfg, model, total_steps: int, fusion_layer: int, fresh_names=()):
    """AdamW with the reference's groups (reference optim.py:26-104): the
    base lr, per-tower vision / text / cross lr, ``lr_mult`` on the
    parameters the checkpoint left fresh and, with ``large_lr_for_dec``, on
    the whole VQA decoder (reference model_generation.py:445-447); the
    linear warmup-decay schedule."""
    opt = cfg.get("optimizer", {})
    sched_cfg = cfg.get("schedular", {})
    if str(opt.get("opt", "adamW")).lower() != "adamw":
        raise ValueError(f"unsupported optimizer.opt: {opt.get('opt')!r} (only adamW, as "
                         f"the reference optim.py)")
    if sched_cfg.get("sched", "linear") != "linear":
        raise ValueError(f"unsupported schedular.sched: {sched_cfg.get('sched')!r} "
                         f"(only linear)")
    if cfg.get("flat_optimizer", False):
        raise NotImplementedError("flat_optimizer is not ported (by decision: ROADMAP "
                                  "'Not ported'); drop the key")
    base_lr = float(opt.get("lr", sched_cfg.get("lr", 1e-4)))
    sched = lr_schedule(base_lr, total_steps,
                        warmup_steps=sched_cfg.get("num_warmup_steps", 0.1),
                        min_rate=sched_cfg.get("min_rate", 0.0))
    labels = param_labels(model.named_parameters(), fusion_layer, fresh_names=fresh_names,
                          fresh_prefixes=("text_decoder.",)
                          if cfg.get("large_lr_for_dec", False) else ())
    return create_optimizer(
        model, sched, weight_decay=float(opt.get("weight_decay", 0.01)),
        clip_grad_norm=cfg.get("accelerator", {}).get("CLIP_GRAD_NORM", 1.0),
        lr_mult=float(opt.get("lr_mult", 1.0)),
        vision_lr_scale=float(opt.get("vision_lr", base_lr)) / base_lr,
        text_lr_scale=float(opt.get("text_lr", base_lr)) / base_lr,
        cross_lr_scale=float(opt.get("cross_lr", base_lr)) / base_lr,
        labels=labels)


def maybe_resume(args, model, optimizer):
    """--resume: (step, data cursors) restored from ``output_dir/ckpt``, or
    (0, {}) without --resume or a saved state."""
    if not args.resume:
        return 0, {}
    ckpt_dir = os.path.join(args.output_dir, "ckpt")
    step, data_state = ckpt_lib.restore_train_state(ckpt_dir, model, optimizer)
    if step is None:
        print(f"### --resume: no checkpoint in {ckpt_dir}, starting fresh")
        return 0, {}
    print(f"### resumed train state at step {step}")
    return step, data_state


def load_initial_params(args, cfg, model) -> List[str]:
    """The initial parameters; returns the names (inside the composition
    core) of those left fresh, for the optimizer's ``lr_mult`` group.
    ``--checkpoint`` a file: a whole X2-VLM ``.th`` or a published backbone,
    by its flavour; on a Plus model with ``is_xvlm_ckpt`` an X2-VLM file is
    split into the Plus text tower and cross encoder
    (``xvlm_ckpt_text_num_hidden_layers``; with ``replace_text_encoder``
    the text tower stays fresh), and a cross encoder left wholly fresh
    raises. A directory: the parameters of a train state this launcher
    saved, strict for the same task's; another task's (a pretraining
    model's ``base.`` core) loads as a reference-named state, the heads it
    lacks fresh. Without one: the vision JSON's ``ckpt`` (a raw BEiT-2, CLIP or
    Swin file) and the text encoder's ``pytorch_model.bin`` (HF BERT or
    XLM-R, expanded to the config's layers), where those files exist."""
    mcfg = getattr(model, "base", model).config
    if cfg.get("is_xvlm_ckpt") and not mcfg.is_plus:
        raise ValueError("is_xvlm_ckpt is a Plus / CCLM import knob (the Base -> Plus text "
                         "stack split); this model is not XVLMPlus")
    if not args.checkpoint:
        paths = []
        vc_path = cfg.get("vision_config")
        if vc_path and os.path.exists(vc_path):
            paths.append(config_lib.read_json(vc_path).get("ckpt"))
        paths.append(os.path.join(str(cfg.get("text_encoder", "")), "pytorch_model.bin"))
        state, unused = {}, []
        for path in paths:
            if not path or not os.path.isfile(path):
                continue
            part, left, kind = ckpt_lib.convert_checkpoint_auto(
                ckpt_lib.load_torch_checkpoint(path), vision_cfg=mcfg.vision,
                text_layers=mcfg.text.num_layers, text_fusion_layer=mcfg.text.fusion_layer)
            print(f"### {kind} init from {path} ({len(left)} unused)")
            state.update(part)
            unused += left
        if not state:
            return []
        missing, unexpected = ckpt_lib.load_converted(model, state)
        print(ckpt_lib.import_report(model, missing, sorted(unexpected + unused),
                                     "raw vision / text init"))
        return missing
    if os.path.isdir(args.checkpoint):
        path = os.path.join(args.checkpoint, ckpt_lib.TRAIN_STATE_FILE)
        # memory-mapped: the optimizer state (two thirds of the file) is never read
        state = torch.load(path, map_location="cpu", weights_only=False, mmap=True)
        print(f"### parameters of step {state['step']} from {path}")
        if set(state["params"]) == {n for n, _ in model.named_parameters()}:
            model.load_state_dict(state["params"], strict=True)
            return []
        # another task's state (a pretraining model's ``base.`` core): its
        # reference-named parameters into this model's core, the rest fresh
        sd = {k[len("base."):] if k.startswith("base.") else k: v
              for k, v in state["params"].items()}
        missing, unexpected = ckpt_lib.load_converted(model, sd)
        print(ckpt_lib.import_report(model, missing, unexpected, path))
        return missing
    if not (mcfg.is_plus and cfg.get("is_xvlm_ckpt")):
        missing, unexpected = ckpt_lib.load_reference_checkpoint(model, args.checkpoint)
        print(ckpt_lib.import_report(model, missing, unexpected, args.checkpoint))
        return missing
    sd = ckpt_lib.load_torch_checkpoint(args.checkpoint)
    state, unused, kind = ckpt_lib.convert_checkpoint_auto(
        sd, vision_cfg=mcfg.vision, text_layers=mcfg.text.num_layers,
        text_fusion_layer=mcfg.text.fusion_layer)
    split = kind == "xvlm" and not any(k.startswith("cross_encoder.") for k in state)
    if split:   # Base -> Plus (reference load_pretrained_xvlm)
        state = ckpt_lib.split_imported_to_plus(
            state, xvlm_text_layers=cfg.get("xvlm_ckpt_text_num_hidden_layers"),
            replace_text_encoder=cfg.get("replace_text_encoder", False))
    missing, unexpected = ckpt_lib.load_converted(model, state)
    print(ckpt_lib.import_report(model, missing, sorted(unexpected + unused), args.checkpoint))
    if split:
        core = getattr(model, "base", model)
        cross = [n for n, _ in core.named_parameters() if n.startswith("cross_encoder.")]
        if cross and all(n in set(missing) for n in cross):
            raise ValueError(f"checkpoint import left ['cross_encoder'] entirely fresh, but "
                             f"the config promises it loads from {args.checkpoint} "
                             f"(is_xvlm_ckpt / xvlm_ckpt_text_num_hidden_layers)")
    return missing


def to_device(batch: Dict, device: torch.device) -> Dict:
    """A host batch (numpy) as tensors on ``device``: attention masks int32,
    other integer arrays int64, images and floats as they are."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        if t.dtype == torch.int32 and not k.endswith("atts"):
            t = t.long()
        out[k] = t.to(device, non_blocking=True)
    return out


def eval_multi(eval_one, eval_sets, mean_key=None) -> Dict:
    """``eval_one`` over a {split: dataset} dict, each metric as
    ``{split}_{key}``, and ``mean_key`` averaged over the splits (the JAX
    launcher's ``eval_multi``); a single dataset passes through."""
    if not isinstance(eval_sets, dict):
        return eval_one(eval_sets)
    out, vals = {}, []
    for split, ds in eval_sets.items():
        m = eval_one(ds)
        out.update({f"{split}_{k}": v for k, v in m.items()})
        if mean_key and mean_key in m:
            vals.append(m[mean_key])
    if mean_key and vals:
        out[mean_key] = sum(vals) / len(vals)
    return out


def finetune(args, cfg, device, model, mcfg, train_ds, eval_fn, metric_key, loader=None):
    """The tail every fine-tune task shares (the JAX ``_finetune_common`` and
    ``_train_state_and_loop``): the ``--checkpoint`` import, then either
    ``--evaluate`` (returns the metrics) or the epochs: AdamW with its
    groups, ``--resume``, one step per batch of ``loader`` (default:
    ``batch_size`` samples of ``train_ds``), an eval after each epoch, the
    train state saved every epoch and the best by ``metric_key`` (None:
    none) kept in ``ckpt_best`` (returns the last epoch's record)."""
    fresh = load_initial_params(args, cfg, model)
    if args.evaluate:
        metrics = eval_fn()
        print(metrics)
        append_log(args.output_dir, {"eval": metrics})
        return metrics

    epochs = cfg.get("schedular", {}).get("epochs", 5)
    accum = int(cfg.get("accumulate_steps", 1))
    loader = loader or MapLoader(train_ds, cfg.get("batch_size", 32), seed=args.seed)
    steps_per_epoch = max(1, len(loader))
    optimizer = make_optimizer(cfg, model, steps_per_epoch * epochs,
                               mcfg.text.fusion_layer, fresh_names=fresh)
    resumed_step, _ = maybe_resume(args, model, optimizer)
    start_epoch = min(resumed_step // steps_per_epoch, epochs)
    step = make_train_step(model, optimizer, accum_steps=accum)

    def step_fn(batch, i):
        return step(to_device(batch, device), *step_generators(device, args.seed, i, 0))

    def save_fn(epoch, best):
        n = (epoch + 1) * steps_per_epoch
        ckpt_lib.save_train_state(os.path.join(args.output_dir, "ckpt"), model, optimizer, n)
        if best:
            ckpt_lib.save_train_state(os.path.join(args.output_dir, "ckpt_best"), model,
                                      optimizer, n)

    return train_epochs(step_fn, loader, num_epochs=epochs, start_epoch=start_epoch,
                        eval_fn=eval_fn, eval_start_epoch=int(cfg.get("start_eval", 0)),
                        metric_key=metric_key, output_dir=args.output_dir, save_fn=save_fn)


def run_retrieval(args, cfg, device, task: str = "retrieval"):
    """Fine-tune and / or evaluate with the two-stage ITC -> ITM protocol
    (reference Retrieval.py; XRetrieval.py, WIT.py and xFlickrCO.py for
    ``task`` ``xretrieval``, ``wit`` and ``xflickrco``, averaged over a
    ``test_file`` dict's languages), on images or, with
    ``task="video_retrieval"``, on videos of ``frame_len`` frames."""
    from x2vlm_tpu_torch.data.factory import create_dataset
    from x2vlm_tpu_torch.tasks.retrieval import evaluate_retrieval

    model, mcfg = build_model(cfg, "retrieval", device=device, seed=args.seed)
    train_ds, test_ds = create_dataset(task, cfg, evaluate=args.evaluate,
                                       rng=random.Random(args.seed))
    metric_key = ("img_r_mean" if cfg.get("pick_best_t2v") else
                  "r1_mean" if cfg.get("pick_best_r1") else "r_mean")

    def eval_fn():
        return eval_multi(lambda ds: evaluate_retrieval(
            model, ds, device=device, k_test=cfg.get("k_test", 128),
            batch_images=cfg.get("batch_size_test", 64),
            batch_texts=cfg.get("batch_size_test_text", 256)), test_ds, mean_key=metric_key)

    return finetune(args, cfg, device, model, mcfg, train_ds, eval_fn, metric_key)


def run_grounding(args, cfg, device):
    """Fine-tune and / or evaluate the bbox grounding head (reference
    Grounding_bbox.py): IoU >= 0.5 accuracy per split against ``refs_file``
    (``val_acc`` picks the best epoch), or a VLUE test set's ``score``."""
    from x2vlm_tpu_torch.data.factory import create_dataset
    from x2vlm_tpu_torch.evalkit import grounding_eval_bbox, grounding_eval_bbox_vlue
    from x2vlm_tpu_torch.tasks.grounding import predict_grounding

    model, mcfg = build_model(cfg, "grounding", device=device, seed=args.seed)
    train_ds, test_ds = create_dataset("grounding", cfg, evaluate=args.evaluate,
                                       rng=random.Random(args.seed))
    refs = None
    if cfg.get("refs_file"):
        with open(cfg["refs_file"]) as f:
            refs = {int(k): v for k, v in json.load(f).items()}

    def eval_fn():
        results = predict_grounding(model, test_ds, device=device,
                                    batch_size=cfg.get("batch_size_test", 32))
        if cfg.get("vlue_test"):   # the test json carries its own boxes
            tf = cfg["test_file"]
            return grounding_eval_bbox_vlue(results, tf[0] if isinstance(tf, (list, tuple))
                                            else tf)
        return grounding_eval_bbox(results, refs) if refs else {"n": len(results)}

    metric_key = "score" if cfg.get("vlue_test") else "val_acc" if refs else None
    return finetune(args, cfg, device, model, mcfg, train_ds, eval_fn, metric_key)


def run_nlvr(args, cfg, device, task: str = "nlvr"):
    """Fine-tune and / or evaluate NLVR2 (reference NLVR.py) or, with
    ``task="marvl"``, MARVL (reference MARVL.py: trained on English NLVR2,
    tested on the multilingual sets): one text against two images,
    accuracy (averaged over the splits of a dict ``test_file``)."""
    from x2vlm_tpu_torch.data.factory import create_dataset
    from x2vlm_tpu_torch.tasks.classification import evaluate_classification

    model, mcfg = build_model(cfg, "nlvr", device=device, seed=args.seed)
    train_ds, test_ds = create_dataset(task, cfg, evaluate=args.evaluate,
                                       rng=random.Random(args.seed))

    def eval_fn():
        return eval_multi(lambda ds: evaluate_classification(
            model, ds, device=device, batch_size=cfg.get("batch_size_test", 32)), test_ds,
            mean_key="accuracy")

    return finetune(args, cfg, device, model, mcfg, train_ds, eval_fn, "accuracy")


def run_classification(args, cfg, device, task: str = "classification"):
    """Fine-tune and / or evaluate a classification task (reference
    XVNLI.py, VQA_msrvtt.py / VQA_msvd.py; the JAX ``run_classification``):
    XVNLI's three labels (``num_labels`` 3 unless the config sets it),
    video QA over ``answer_list`` (its length sets ``num_labels``) or
    NExT-QA multiple choice (K options a question); accuracy picks the best
    epoch. ``--task classification`` runs its config's ``dataset_type``
    (XVNLI by default). The train set draws its transforms from the seeded
    data rng, reseeded each epoch (``SeededLoader``), so a resumed run reads
    the whole run's batches."""
    from x2vlm_tpu_torch.data.factory import create_dataset
    from x2vlm_tpu_torch.tasks.classification import evaluate_classification

    if task == "classification":
        task = cfg.get("dataset_type", "xvnli")
    if task in MULTIPLE_CHOICE_TASKS:
        model_task = "multiple_choice"
    elif task in VIDEO_QA_TASKS:
        model_task = "classification"
        with open(cfg["answer_list"]) as f:
            cfg["num_labels"] = len(json.load(f))
    elif task in LABEL_TASKS:
        model_task = "classification"
        cfg.setdefault("num_labels", 3)
    else:
        raise ValueError(f"classification of dataset_type {task!r}: the launcher runs "
                         f"{VIDEO_QA_TASKS + MULTIPLE_CHOICE_TASKS + LABEL_TASKS}")
    data_rng = random.Random(args.seed)
    train_ds, test_ds = create_dataset(task, cfg, evaluate=args.evaluate, rng=data_rng)
    model, mcfg = build_model(cfg, model_task, device=device, seed=args.seed)

    def eval_fn():
        return eval_multi(lambda ds: evaluate_classification(
            model, ds, device=device, batch_size=cfg.get("batch_size_test", 32)), test_ds,
            mean_key="accuracy")

    loader = None
    if not args.evaluate:
        train_ds.rng = data_rng
        loader = SeededLoader(train_ds, cfg.get("batch_size", 32), run_seed=args.seed,
                              data_rng=data_rng)
    return finetune(args, cfg, device, model, mcfg, train_ds, eval_fn, "accuracy",
                    loader=loader)


class SeededLoader(MapLoader):
    """Batches of a map-style train set whose samples draw from one rng
    (``data_rng``: the transform, the caption masking), read in order. At
    each epoch's start ``data_rng`` is reseeded from ``run_seed`` and the
    epoch (epoch 0: ``run_seed`` itself, the JAX launcher's draws), so a
    resumed run reads the batches the whole run read. The batch order is
    the JAX loader's (``MapLoader``'s seed 0, not ``run_seed``)."""

    def __init__(self, dataset, batch_size: int, *, run_seed: int, data_rng: random.Random):
        super().__init__(dataset, batch_size)
        self.run_seed = run_seed
        self.data_rng = data_rng

    def collate(self, samples):
        return collate(samples)

    def __iter__(self):
        epoch = self.epoch
        self.data_rng.seed(self.run_seed if epoch == 0 else f"{self.run_seed}/{epoch}")
        for b in batch_indices(len(self.dataset), self.batch_size, shuffle=self.shuffle,
                               seed=self.seed, epoch=epoch, drop_last=self.drop_last):
            yield self.collate([self.dataset[i] for i in b])


class VQALoader(SeededLoader):
    """``SeededLoader`` batches through ``vqa_collate``, whose answer cut
    draws from ``random.Random(seed * 1000003 + epoch)``, as the JAX
    launcher's."""

    def __init__(self, dataset, batch_size: int, answers_per_batch: int, *, run_seed: int,
                 data_rng: random.Random):
        super().__init__(dataset, batch_size, run_seed=run_seed, data_rng=data_rng)
        self.answers_per_batch = answers_per_batch

    def collate(self, samples):
        from x2vlm_tpu_torch.data.finetune import vqa_collate

        return vqa_collate(samples, self.answers_per_batch, rng=self.cut_rng)

    def __iter__(self):
        self.cut_rng = random.Random(self.run_seed * 1000003 + self.epoch)
        return super().__iter__()


def run_vqa(args, cfg, device, task: str = "vqa"):
    """Fine-tune and / or evaluate VQA (reference VQA.py) or, with
    ``task="xgqa"``, xGQA (reference XGQA.py: a ``test_file`` dict of
    languages, each entry a path or a [path, answer list] pair): the
    decoder's loss over each question's weighted answers; the eval ranks
    ``answer_list`` (``k_test`` answers reranked), writes a result file a
    split, and scores with the VQAv2 protocol (``overall``) where the test
    lines carry several human answers, else the exact match (``acc``)."""
    from x2vlm_tpu_torch.data.factory import create_dataset
    from x2vlm_tpu_torch.evalkit.vqa import exact_match_accuracy, vqa_eval
    from x2vlm_tpu_torch.tasks.vqa import evaluate_vqa

    model, mcfg = build_model(cfg, "vqa", device=device, seed=args.seed)
    data_rng = random.Random(args.seed)
    train_ds, test_ds = create_dataset(task, cfg, evaluate=args.evaluate, rng=data_rng)
    gts0 = (next(iter(test_ds.values())) if isinstance(test_ds, dict) else test_ds).gt_answers()
    metric_key = None
    if gts0:   # the VQAv2 protocol needs several human answers a question
        metric_key = "overall" if max(len(v) for v in gts0.values()) >= 4 else "acc"

    def eval_one(ds):
        results = evaluate_vqa(model, ds, ds.answer_list, ds.answer_ids, ds.answer_atts,
                               device=device, k_test=cfg.get("k_test", 128),
                               batch_size=cfg.get("batch_size_test", 32))
        seen, merged = set(), []
        for r in results:
            if r["question_id"] not in seen:
                seen.add(r["question_id"])
                merged.append(r)
        split = next((k for k, v in test_ds.items() if v is ds), None) \
            if isinstance(test_ds, dict) else None
        with open(os.path.join(args.output_dir,
                               f"vqa_result{f'_{split}' if split else ''}.json"), "w") as f:
            json.dump(merged, f)
        out = {"n": len(merged)}
        gts = ds.gt_answers()
        if gts:
            out.update(vqa_eval(merged, gts))
            out["acc"] = exact_match_accuracy(merged, gts)
        return out

    loader = None
    if not args.evaluate:
        batch_size = cfg.get("batch_size", 32)
        loader = VQALoader(train_ds, batch_size, cfg.get("answers_per_batch", 2 * batch_size),
                           run_seed=args.seed, data_rng=data_rng)
    return finetune(args, cfg, device, model, mcfg, train_ds,
                    lambda: eval_multi(eval_one, test_ds, mean_key=metric_key), metric_key,
                    loader=loader)


def run_captioning(args, cfg, device):
    """Fine-tune and / or evaluate UniLM MLM captioning (reference
    Captioning_MLM.py): the smoothed MLM loss over masked caption slots;
    the eval's beam-search captions scored against ``caption_gt_file``
    (``cider`` picks the best epoch), else counted. With ``scst: true`` the
    fine-tune is self-critical (:func:`_run_captioning_scst`)."""
    from x2vlm_tpu_torch.data.factory import create_dataset
    from x2vlm_tpu_torch.data.tokenization import build_tokenizer
    from x2vlm_tpu_torch.evalkit.caption import caption_eval
    from x2vlm_tpu_torch.tasks.captioning import generate_captions

    model, mcfg = build_model(cfg, "captioning", device=device, seed=args.seed)
    tokenizer = build_tokenizer(cfg["text_encoder"])
    data_rng = random.Random(args.seed)
    train_ds, test_ds = create_dataset("captioning", cfg, evaluate=args.evaluate,
                                       tokenizer=tokenizer, rng=data_rng)
    anns = None
    if cfg.get("caption_gt_file"):
        with open(cfg["caption_gt_file"]) as f:
            anns = {int(k): v for k, v in json.load(f).items()}

    def eval_fn():
        results = generate_captions(
            model, test_ds, tokenizer, device=device, prompt=cfg.get("prompt", ""),
            num_beams=cfg.get("num_beams", 3), min_length=cfg.get("min_length", 5),
            max_length=cfg.get("max_length", 20),
            length_penalty=float(cfg.get("length_penalty", 0.0)),
            batch_size=cfg.get("batch_size_test", 16))
        return caption_eval(results, anns) if anns else {"n": len(results)}

    if cfg.get("scst") and not args.evaluate:
        return _run_captioning_scst(args, cfg, device, model, mcfg, tokenizer,
                                    eval_fn if anns else None)
    loader = None if args.evaluate else SeededLoader(
        train_ds, cfg.get("batch_size", 16), run_seed=args.seed, data_rng=data_rng)
    return finetune(args, cfg, device, model, mcfg, train_ds, eval_fn,
                    "cider" if anns else None, loader=loader)


def _run_captioning_scst(args, cfg, device, model, mcfg, tokenizer, eval_fn):
    """Self-critical fine-tune (the JAX ``_run_captioning_scst``; the
    reference declares ``--scst`` with no loop behind it): per epoch the
    images of the train set (one row an image, the deterministic eval
    transform), shuffled by ``seed + epoch`` on the last epoch's order, in
    whole batches only; each step ``scst_num_samples`` rollouts an image
    and one policy-gradient step; after each epoch the last step's loss
    logged, the train state saved and the eval run. Unlike the JAX loop,
    which reruns every epoch from the restored state, ``--resume`` goes on
    after the last saved epoch (the rollout draws are seeded by the global
    step, so the resumed run reads the whole run's batches)."""
    from x2vlm_tpu_torch.data.finetune import CaptioningSCSTDataset
    from x2vlm_tpu_torch.data.transforms import test_transform
    from x2vlm_tpu_torch.tasks.captioning import prompt_ids
    from x2vlm_tpu_torch.tasks.scst import scst_train_step

    ds = CaptioningSCSTDataset(cfg["train_file"], test_transform(cfg["image_res"]),
                               cfg.get("image_root", cfg.get("image_root_train", "")))
    ids = prompt_ids(tokenizer, cfg.get("prompt", ""))
    bsz = cfg.get("batch_size_scst", cfg.get("batch_size", 8))
    epochs = cfg.get("schedular", {}).get("epochs", 3)
    fresh = load_initial_params(args, cfg, model)
    steps_per_epoch = len(ds) // bsz
    optimizer = make_optimizer(cfg, model, max(1, steps_per_epoch) * epochs,
                               mcfg.text.fusion_layer, fresh_names=fresh)
    _, data_state = maybe_resume(args, model, optimizer)
    step = make_train_step(model, optimizer)
    idx = list(range(len(ds)))
    record = None
    for epoch in range(epochs):
        random.Random(args.seed + epoch).shuffle(idx)
        if epoch < data_state.get("epochs_done", 0):
            continue
        loss = float("nan")
        for i in range(steps_per_epoch):
            rows = [ds[j] for j in idx[i * bsz: (i + 1) * bsz]]
            images = torch.from_numpy(np.stack([r["image"] for r in rows])).to(device)
            n = epoch * steps_per_epoch + i
            metrics, _ = scst_train_step(
                model, step, images, [r["captions"] for r in rows], tokenizer,
                step_generators(device, args.seed, n, 1)[0], prompt_ids=ids,
                num_samples=cfg.get("scst_num_samples", 5),
                max_length=cfg.get("max_length", 20),
                step_generators=step_generators(device, args.seed, n, 0))
            loss = float(metrics["loss_scst"])
        record = {"epoch": epoch, "loss_scst": loss}
        ckpt_lib.save_train_state(os.path.join(args.output_dir, "ckpt"), model, optimizer,
                                  (epoch + 1) * steps_per_epoch, {"epochs_done": epoch + 1})
        if eval_fn is not None:
            record["eval"] = eval_fn()
        append_log(args.output_dir, record)
    return record


class _Tracked:
    """A prefetched stream of (batch, cursor) pairs, handing out the
    batches and keeping the reader cursor after the last one handed out
    (the cursor a resume continues from)."""

    def __init__(self, pairs, depth: int, start_state):
        self.prefetcher = Prefetcher(pairs, depth=depth)
        self._it = iter(self.prefetcher)
        self.cursor = start_state

    def __iter__(self):
        return self

    def __next__(self):
        batch, self.cursor = next(self._it)
        return batch


def _stream_pairs(name: str, stream, rngs, n_samples: int, seed: int, batch_fn=collate):
    """(batch, cursor after it) pairs of ``stream``, a batch being
    ``batch_fn`` of ``n_samples`` samples. Each of ``rngs`` (the stream's
    transform, masking and caption draws; the region stream's box
    transform and collate) is seeded from the cursor at each batch's start,
    so a batch depends only on where it starts and a resumed run reads what
    the uninterrupted one would."""
    it = iter(stream)
    while True:
        s = stream.reader.state()
        at = f"{seed}/{name}/{s['epoch']}/{s['file_idx']}/{s['line_idx']}"
        for i, rng in enumerate(rngs):
            rng.seed(at if i == 0 else f"{at}/{i}")
        samples = [next(it) for _ in range(n_samples)]
        yield batch_fn(samples), stream.reader.state()


def run_pretrain(args, cfg, device):
    """Mixed-stream pretraining: the image-text stream (+ the aux clean-data
    replacement), the region-text stream, the video-frame-text stream (+ its
    aux replacement), the text stream and, for the Plus / CCLM model, the
    parallel-text stream (reference Pretrain.py:255-423); an image or region
    block with ``languages`` reads ``{language: caption}`` captions
    (data/multilingual.py)."""
    from x2vlm_tpu_torch.data import transforms as T
    from x2vlm_tpu_torch.data.multilingual import (
        ImageMultiTextStream, ParaTextStream, RegionMultiTextStream,
    )
    from x2vlm_tpu_torch.data.pretrain import (
        ImageTextStream, RegionTextStream, TextStream, VideoTextStream, region_collate,
    )
    from x2vlm_tpu_torch.data.streaming import DistLineReader
    from x2vlm_tpu_torch.data.tokenization import TextPreprocessor, build_tokenizer
    from x2vlm_tpu_torch.tasks.pretrain import PretrainStreams, pretrain_loop

    if not cfg.get("mixed_in_batch", True):
        raise ValueError("mixed_in_batch: false is not implemented (reference "
                         "Pretrain.py:359 raises too)")
    for block in ("images", "regions", "videos", "texts", "mtexts"):
        if (cfg.get(block) or {}).get("tokenized", False):
            raise ValueError(f"{block}.tokenized: true is not implemented (reference "
                             f"pretrain_dataset.py:147)")
    xcfg = cfg.get("mtexts")
    if xcfg and cfg.get("train_file_mtext") and not is_plus_config(cfg):
        raise ValueError("parallel-text (mtexts) pretraining needs model_type: cclm / "
                         "xvlm_plus")

    model, mcfg = build_model(cfg, "pretrain", device=device, seed=args.seed)
    tokenizer = build_tokenizer(cfg["text_encoder"])
    fresh = load_initial_params(args, cfg, model)

    icfg = dict(cfg.get("images", {}))
    icfg.setdefault("caption_key", "desc")
    sched_cfg = cfg.get("schedular", {})
    steps_per_epoch = cfg.get("train_dataset_size", 10 ** 6) // icfg.get("batch_size", 128)
    total_steps = steps_per_epoch * sched_cfg.get("epochs", 3)
    optimizer = make_optimizer(cfg, model, total_steps, mcfg.text.fusion_layer,
                               fresh_names=fresh)
    start_step, data_state = maybe_resume(args, model, optimizer)

    def preprocessor(rng):
        return TextPreprocessor(
            tokenizer, max_tokens=cfg.get("max_tokens", 40), max_words=cfg.get("max_words", 40),
            max_masks=cfg.get("max_masks", 12), mask_prob=cfg.get("mask_prob", 0.5),
            mask_whole_word=cfg.get("mask_whole_word", True),
            skipgram_prb=cfg.get("skipgram_prb", 0.2), skipgram_size=cfg.get("skipgram_size", 3),
            rng=rng)

    streams: Dict[str, _Tracked] = {}
    counted = []

    def add(name, block, paths, make, n_samples=None, batch_fn=collate, rngs=None,
            pre=preprocessor):
        """``rngs[0]`` is the stream's, the others its transform's own."""
        rngs = rngs or (random.Random(),)
        n = n_samples or block.get("batch_size", 128)
        reader = DistLineReader(paths, seed=args.seed, start_state=data_state.get(name))
        stream = make(reader, pre(rngs[0]), rngs[0], n)
        counted.append(stream)
        pairs = _stream_pairs(name, stream, rngs, n, args.seed, batch_fn)
        streams[name] = _Tracked(pairs, max(1, int(block.get("num_workers", 2))),
                                 data_state.get(name))

    data_plane: Dict[str, str] = {}   # the decoder each stream took: "native" or "pil"

    def native_or_pil(name, native_cls, pil_fallback, rng, num_threads=1):
        """The JAX launcher's dispatch (``native_or_pil``): the C++ transform
        under ``native_aug`` true or auto when the library builds (true
        raises when it does not), else the PIL one. Either draws from
        ``rng``, the stream's transform rng."""
        want = cfg.get("native_aug", "auto")
        if want in (True, "auto"):
            from x2vlm_tpu_torch.data import native
            try:
                tf = getattr(native, native_cls)(cfg["image_res"], rng=rng,
                                                 num_threads=max(1, num_threads))
                data_plane[name] = "native"
                return tf
            except RuntimeError:
                if want is True:
                    raise
        data_plane[name] = "pil"
        return pil_fallback()

    def image_stream(name, blk):
        def make(reader, pre, rng, bs):
            kw = dict(image_key=blk.get("image_key", "binary"), caption_key=blk["caption_key"],
                      is_image_rpath=blk.get("is_image_rpath", False), rng=rng,
                      max_consecutive_broken=bs)
            tf = native_or_pil(
                name, "NativeTrainTransform",
                lambda: T.pretrain_transform(cfg["image_res"], rng=rng, as_float=False), rng)
            if blk.get("languages"):   # CCLM: captions keyed by language
                return ImageMultiTextStream(reader, pre, tf, languages=blk["languages"], **kw)
            return ImageTextStream(reader, pre, tf, **kw)
        return make

    add("image", icfg, cfg["train_file"], image_stream("image", icfg))
    if cfg.get("train_file_aux"):
        aux = dict(icfg, caption_key=icfg.get("aux_caption_key",
                                              icfg.get("caption_key", "caption")))
        add("aux", aux, cfg["train_file_aux"], image_stream("aux", aux))
    rcfg = cfg.get("regions")
    if rcfg and cfg.get("train_file_regions"):
        # as the JAX launcher: the crop and flip box-aware in the stream, the
        # pixels (native) or the augmentation (PIL) by the box transform with
        # its own rng; a batch is region_collate of max_images samples,
        # drawing from the stream's rng
        region_rng, box_rng = random.Random(), random.Random()
        max_images = rcfg.get("max_images", 50)

        def region_stream(reader, pre, rng, n):
            box_tf = native_or_pil("region", "NativeBoxTransform",
                                   lambda: T.box_transform(box_rng), box_rng)
            kw = dict(image_res=mcfg.vision.image_res, patch_size=mcfg.vision.patch_size,
                      max_regions=rcfg.get("max_regions", 5),
                      min_perc_in_image=rcfg.get("min_perc_in_image", 0.5),
                      careful_hflip=rcfg.get("careful_hflip", True),
                      image_key=rcfg.get("image_key", "binary"), rng=rng,
                      max_consecutive_broken=n)
            if rcfg.get("languages"):
                return RegionMultiTextStream(reader, pre, box_tf,
                                             languages=rcfg["languages"],
                                             code_switch=rcfg.get("code_switch", True), **kw)
            return RegionTextStream(reader, pre, box_tf, **kw)

        add("region", rcfg, cfg["train_file_regions"], region_stream, n_samples=max_images,
            batch_fn=lambda samples: region_collate(samples, rcfg.get("batch_size", 128),
                                                    max_images, region_rng),
            rngs=(region_rng, box_rng))
    vcfg = cfg.get("videos")
    if vcfg and cfg.get("train_file_videos"):
        def video_stream(name):
            return lambda reader, pre, rng, n: VideoTextStream(
                reader, pre, native_or_pil(
                    name, "NativeTrainTransform",
                    lambda: T.pretrain_transform(cfg["image_res"], rng=rng, as_float=False),
                    rng, min(int(vcfg.get("num_workers", 2)), os.cpu_count() or 1)),
                frame_len=vcfg.get("frame_len", cfg.get("frame_len", 3)),
                # the reference names the frame list by the block's image_key
                frames_key=vcfg.get("frames_key", vcfg.get("image_key", "frames")),
                caption_key=vcfg.get("caption_key", "caption"),
                is_image_rpath=vcfg.get("is_image_rpath", False),
                combine_continuous_clips=vcfg.get("combine_continuous_clips", False),
                minimum_frames_before_sampling=vcfg.get("mininum_frames_before_sampling", -1),
                rng=rng, max_consecutive_broken=n)

        n_videos = vcfg.get("batch_size", 40)
        add("video", vcfg, cfg["train_file_videos"], video_stream("video"),
            n_samples=n_videos)
        if cfg.get("train_file_videos_aux"):
            add("video_aux", vcfg, cfg["train_file_videos_aux"], video_stream("video_aux"),
                n_samples=n_videos)
    tcfg = cfg.get("texts")
    if tcfg and cfg.get("train_file_text"):
        add("text", tcfg, cfg["train_file_text"],
            lambda reader, pre, rng, bs: TextStream(
                reader, pre, caption_key=tcfg.get("caption_key", "text"), rng=rng,
                max_consecutive_broken=bs))

    if xcfg and cfg.get("train_file_mtext"):
        # CCLM parallel text (reference Pretrain.py:238-247): its own
        # preprocessor at the block's lengths, as the JAX launcher builds it
        def mtext_pre(rng):
            return TextPreprocessor(
                tokenizer, max_tokens=xcfg.get("max_tokens", cfg.get("max_tokens", 64)),
                max_words=xcfg.get("max_words", xcfg.get("max_tokens",
                                                         cfg.get("max_words", 64))),
                max_masks=xcfg.get("max_masks", cfg.get("max_masks", 12)),
                mask_prob=xcfg.get("mask_prob", cfg.get("mask_prob", 0.5)),
                mask_whole_word=cfg.get("mask_whole_word", True),
                skipgram_prb=cfg.get("skipgram_prb", 0.2),
                skipgram_size=cfg.get("skipgram_size", 3), rng=rng)

        add("mtext", xcfg, cfg["train_file_mtext"],
            lambda reader, pre, rng, bs: ParaTextStream(
                reader, pre, key_a=xcfg.get("source_key", "text1"),
                key_b=xcfg.get("target_key", "text2"), rng=rng, max_consecutive_broken=bs),
            pre=mtext_pre)

    print(f"### data plane (native_aug: {cfg.get('native_aug', 'auto')}): "
          f"{json.dumps(data_plane)}")
    ps = PretrainStreams(
        image=streams["image"], region=streams.get("region"), text=streams.get("text"),
        aux=streams.get("aux"), video=streams.get("video"), video_aux=streams.get("video_aux"),
        mtext=streams.get("mtext"),
        image_weight=icfg.get("iter_perc", 1.0),
        region_weight=(rcfg or {}).get("iter_perc", 1.0),
        text_weight=(tcfg or {}).get("iter_perc", 1.0),
        video_weight=(vcfg or {}).get("iter_perc", 1.0),
        mtext_weight=(xcfg or {}).get("iter_perc", 1.0),
        aux_perc=cfg.get("aux_iter_perc", 0.0),
        video_aux_perc=cfg.get("video_aux_iter_perc", 0.0),
        regions_use_bbox_only=cfg.get("regions_use_bbox_only", False),
        rng=random.Random(args.seed))
    ckpt_dir = os.path.join(args.output_dir, "ckpt")

    def checkpoint_fn(step):
        cursors = {k: s.cursor for k, s in streams.items()}
        ckpt_lib.save_train_state(ckpt_dir, model, optimizer, step, data_state=cursors)
        print(f"### saved the train state at step {step} (data cursors {cursors})")

    try:
        logger = pretrain_loop(
            model, optimizer, ps, num_steps=total_steps, seed=args.seed,
            to_device=lambda b: to_device(b, device),
            stop_calc_itm_after=cfg.get("stop_calc_itm"),
            calc_image_bbox_loss=cfg.get("calc_image_bbox_loss", False), start_step=start_step,
            checkpoint_fn=checkpoint_fn, checkpoint_every=cfg.get("ckpt_frequent_step", 50000),
            epoch_steps=steps_per_epoch, epoch_save_frequent=int(cfg.get("ckpt_frequent", 1)),
            extra_metrics=lambda: {"broken": float(sum(s.broken for s in counted))})
    finally:
        for tracked in streams.values():
            tracked.prefetcher.close()
    record = {"pretrain_steps": [start_step, total_steps], **logger.to_dict(),
              "data_plane": data_plane}
    append_log(args.output_dir, record)
    return record


def main(argv=None):
    args = parse_args(argv)
    if args.wait:
        print(f"### waiting {args.wait} minutes", flush=True)
        time.sleep(args.wait * 60)
    cfg = setup(args)
    device = resolve_device(args.device)
    t0 = time.time()
    runners = {"pretrain": run_pretrain, "retrieval": run_retrieval,
               "xretrieval": run_retrieval, "wit": run_retrieval, "xflickrco": run_retrieval,
               "video_retrieval": run_retrieval, "grounding": run_grounding,
               "nlvr": run_nlvr, "marvl": run_nlvr, "vqa": run_vqa, "xgqa": run_vqa,
               "captioning": run_captioning, "classification": run_classification,
               "xvnli": run_classification, "video_qa": run_classification,
               "next_qa_mc": run_classification}
    # the runners shared by several tasks take the task's name
    kw = {} if args.task in ("pretrain", "grounding", "captioning") else {"task": args.task}
    out = runners[args.task](args, cfg, device, **kw)
    print(f"total time: {time.time() - t0:.0f}s")
    return out


if __name__ == "__main__":
    main()
