"""Export a serving bundle (``params.npz`` + ``manifest.json``) for
retrieval, captioning, VQA or grounding: the port's counterpart of
``tools/export_serving.py``.

    python -m x2vlm_tpu_torch.export_serving --task retrieval \\
        --config configs/finetune/retrieval_flickr_clip_base.yaml \\
        --checkpoint ckpt.th --out bundle/ [--batch_images 64] [--batch_texts 256] \\
        [--device cpu]
    python -m x2vlm_tpu_torch.export_serving --selftest

``--checkpoint`` is a reference ``.th`` (or a published backbone file, by
its flavour) or a train-state directory of the port's launcher; without
one the model starts as the launcher's does. ``params.npz`` holds the
parameters under the JAX package's names (``params/base/...``), so the
JAX package's ``load_params_npz`` and the port's servers read the same
file; ``manifest.json`` has the JAX manifest's keys (the captioning ones
``CaptioningServer.from_npz`` reads) and the config echo, with the vision
JSON inlined so the bundle builds its tower anywhere. No ``.jexp`` is
written: those are JAX programs, and the port's servers run the module
(``"artifacts": []``). ``--mesh N`` records ``nr_devices: N`` for
data-parallel serving over N devices (serving.py; the batch sizes are
global and N must divide each). ``--selftest`` exports a tiny CPU bundle of each
kind into a temporary directory, serves it and holds the served outputs to
the model's own.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import Dict, Optional

import numpy as np
import torch

from x2vlm_tpu_torch.convert import to_jax_params
from x2vlm_tpu_torch.core.config import load_config, read_json

__all__ = ["export_bundle", "manifest_config", "main", "selftest"]

TASKS = ("retrieval", "captioning", "vqa", "grounding")


def manifest_config(cfg: Dict) -> Dict:
    """The config echo: the YAML as loaded, the vision JSON inlined."""
    echo = json.loads(json.dumps(dict(cfg), default=str))
    vc_path = cfg.get("vision_config")
    if vc_path and os.path.exists(vc_path):
        echo["vision_config_inline"] = dict(read_json(vc_path))
        echo.pop("vision_config")
    return echo


def export_bundle(model, cfg: Dict, task: str, out_dir: str, *, batch_images: int = 64,
                  batch_texts: int = 256, rerank_pairs: int = 0, k_test: int = 128,
                  n_answers: int = 3128, tokenizer=None, mesh: int = 1) -> Dict:
    """Write ``out_dir/params.npz`` (JAX names) and ``manifest.json`` for
    ``model`` (a port task model) built from ``cfg``, served over ``mesh``
    devices; returns the manifest. Captioning needs ``tokenizer`` (the
    prompt, [MASK] and [SEP] ids)."""
    mesh = max(1, mesh)
    batches = [batch_images] + ([batch_texts, rerank_pairs or batch_texts]
                                if task == "retrieval" else [])
    if any(b % mesh for b in batches):
        raise ValueError(f"--mesh {mesh} must divide the global batch sizes {batches}")
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, "params.npz"), **to_jax_params(model.state_dict()))
    res, mt = cfg["image_res"], cfg.get("max_tokens", 40)
    common = {"artifacts": [], "platforms": [], "nr_devices": mesh, "image_res": res}
    if task == "retrieval":
        manifest = dict(common, batch_images=batch_images, batch_texts=batch_texts,
                        rerank_pairs=rerank_pairs or None, max_tokens=mt,
                        embed_dim=int(model.config.embed_dim))
    elif task == "captioning":
        from x2vlm_tpu_torch.tasks.captioning import prompt_ids

        manifest = dict(common, batch=batch_images,
                        prompt_ids=[int(i) for i in prompt_ids(tokenizer, cfg.get("prompt", ""))],
                        mask_token_id=int(tokenizer.mask_token_id),
                        eos_token_id=int(tokenizer.sep_token_id),
                        num_beams=cfg.get("num_beams", 3), min_length=cfg.get("min_length", 5),
                        max_length=cfg.get("max_length", 20))
    elif task == "vqa":
        manifest = dict(common, batch=batch_images, question_len=mt, n_answers=n_answers,
                        answer_len=cfg.get("answer_max_tokens", 10),
                        k_test=min(k_test, n_answers))
    elif task == "grounding":
        manifest = dict(common, batch=batch_images, max_tokens=mt)
    else:
        raise ValueError(f"unknown task {task!r}")
    manifest["config"] = manifest_config(cfg)
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--selftest", action="store_true")
    ap.add_argument("--task", default="retrieval", choices=TASKS)
    ap.add_argument("--config")
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--out")
    ap.add_argument("--batch_images", type=int, default=64)
    ap.add_argument("--batch_texts", type=int, default=256)
    ap.add_argument("--rerank_pairs", type=int, default=0)
    ap.add_argument("--k_test", type=int, default=128, help="vqa rank depth")
    ap.add_argument("--n_answers", type=int, default=3128,
                    help="vqa answer-vocabulary rows (VQAv2 list = 3128)")
    ap.add_argument("--mesh", type=int, default=0,
                    help="data-parallel serving over N devices (the batch sizes are global)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default="cuda",
                    help="where the model is built: the card (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> Optional[Dict]:
    args = parse_args(argv)
    if args.selftest:
        return selftest()
    if not (args.config and args.out):
        raise SystemExit("--config and --out are required")
    from x2vlm_tpu_torch.device import resolve_device
    from x2vlm_tpu_torch.factory import build_model
    from x2vlm_tpu_torch.run import load_initial_params

    cfg = load_config(args.config)
    device = resolve_device(args.device)
    # a train state fills every parameter: nothing to draw from the seed
    seed = None if os.path.isdir(args.checkpoint) else args.seed
    model, _ = build_model(cfg, args.task, device=device, seed=seed)
    load_initial_params(argparse.Namespace(checkpoint=args.checkpoint), cfg, model)
    tokenizer = None
    if args.task == "captioning":
        from x2vlm_tpu_torch.data.tokenization import build_tokenizer

        tokenizer = build_tokenizer(cfg["text_encoder"])
    manifest = export_bundle(model, cfg, args.task, args.out, batch_images=args.batch_images,
                             batch_texts=args.batch_texts, rerank_pairs=args.rerank_pairs,
                             k_test=args.k_test, n_answers=args.n_answers, tokenizer=tokenizer,
                             mesh=args.mesh)
    print(f"exported {args.task} bundle -> {args.out}")
    return manifest


def _tiny_config(task: str) -> Dict:
    cfg = {"image_res": 32, "patch_size": 16, "max_tokens": 8, "embed_dim": 16,
           "vision_config_inline": {"vision_width": 32, "patch_size": 16,
                                    "num_hidden_layers": 1, "num_attention_heads": 2},
           "text_num_hidden_layers": 2, "text_fusion_start_at": 1,
           "text_config_inline": {"vocab_size": 40, "hidden_size": 32, "num_heads": 2,
                                  "intermediate_size": 64, "max_position_embeddings": 32}}
    if task == "vqa":
        cfg["num_dec_layers"] = 1
    return cfg


def selftest() -> int:
    """Export -> serve -> outputs equal the model's own, for each kind, on
    the CPU at a tiny size."""
    from x2vlm_tpu_torch.factory import build_model
    from x2vlm_tpu_torch import serving

    gen = torch.Generator().manual_seed(0)
    image = torch.randn(2, 32, 32, 3, generator=gen)
    ids = torch.randint(1, 40, (2, 8), generator=gen)
    atts = torch.ones(2, 8, dtype=torch.int32)

    class _Tok:   # the ids a captioning manifest records
        cls_token, mask_token_id, sep_token_id = "[CLS]", 3, 2

        @staticmethod
        def convert_tokens_to_ids(tokens):
            return [1 for _ in tokens]

        @staticmethod
        def tokenize(text):
            return text.split()

    with tempfile.TemporaryDirectory() as d, torch.no_grad():
        for task, server_cls in (("retrieval", serving.RetrievalServer),
                                 ("grounding", serving.GroundingServer),
                                 ("vqa", serving.VQAServer),
                                 ("captioning", serving.CaptioningServer)):
            cfg = _tiny_config(task)
            model, _ = build_model(cfg, task, device="cpu", dtype=torch.float32, seed=1)
            model.eval()
            out = os.path.join(d, task)
            export_bundle(model, cfg, task, out, tokenizer=_Tok)
            path = out if task == "captioning" else os.path.join(out, "params.npz")
            served = server_cls.from_npz(path, dtype=torch.float32, device="cpu").model
            for (name, a), (_, b) in zip(sorted(model.state_dict().items()),
                                         sorted(served.state_dict().items())):
                if not torch.equal(a, b):
                    raise AssertionError(f"{task}: {name} differs after the round trip")
            if task == "retrieval":
                pairs = ((model.encode_images(image)[1], served.encode_images(image)[1]),
                         (model.encode_texts(ids, atts)[1], served.encode_texts(ids, atts)[1]))
            elif task == "grounding":
                pairs = ((model.predict(image, ids, atts), served.predict(image, ids, atts)),)
            else:
                pairs = ((model.get_vision_embeds(image)[0], served.get_vision_embeds(image)[0]),)
            for a, b in pairs:
                if not torch.allclose(a, b, rtol=0, atol=1e-6):
                    raise AssertionError(f"{task}: served outputs differ from the model's")
    print("serving selftest OK: export -> from_npz -> outputs match the model")
    return 0


if __name__ == "__main__":
    result = main()
    sys.exit(result if isinstance(result, int) else 0)
