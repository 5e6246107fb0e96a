"""Config-driven model construction (the port's counterpart of
x2vlm_tpu/factory.py): the YAML schema's vision / text / XVLM keys ->
``XVLMConfig`` and the task's model.

The port builds X2-VLM models on a BEiT-2, CLIP ViT or Swin vision tower
(``use_beit_v2`` / ``use_clip_vit`` / ``use_swin``) and BERT for ``"pretrain"``
(``XVLMForPretrain``), ``"retrieval"`` (``XVLMForRetrieval``),
``"grounding"`` (``XVLMForGrounding``), ``"nlvr"`` (``XVLMForNLVR``) and
``"vqa"`` (``XVLMForVQA``, with the config's ``num_dec_layers`` and
``pad_token_id``), ``"captioning"`` (``XVLMForMLMCaptioning``, with the
config's ``label_smoothing``), ``"classification"``
(``XVLMForClassification`` with the config's ``num_labels``) and
``"multiple_choice"`` (``XVLMForMultipleChoice``); the video keys
(``video_encoding``, ``frame_len``, ``add_frame_pos``, ``resampler_depth``,
``resampler_latents``) as the JAX factory reads them. The RoBERTa / XLM-R
text tower (a ``text_encoder`` path naming ``roberta``) and ``model_type:
cclm | xvlm_plus`` (or ``replace_text_encoder``) build the Plus / CCLM base
(``XVLMPlusConfig`` with ``num_cross_layers``; ``"pretrain"`` builds
``XVLMPlusForPretrain``, every other task its model on the Plus core, as the
JAX ``make_base`` arranges: the IGLUE tasks' ``"retrieval"``, ``"nlvr"``,
``"vqa"`` with the RoBERTa-form decoder and ``"classification"``), which
refuses drop-path as the JAX factory does. ``remat: true`` sets ``remat``
and the YAML's ``remat_policy`` on both towers' configs, as the JAX
factory does (the text config carries them to the fusion, decoder and
cross-encoder stacks); ``text_config_inline`` may set them on the text
tower alone. The JAX presets are kept as they are, also where they are odd:
a ``text_encoder`` naming ``xlm-roberta-large`` takes the ``roberta_base``
preset (width 768) in both factories.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Any, Dict

import torch

from x2vlm_tpu_torch.core.config import Config, read_json
from x2vlm_tpu_torch.models.beit2 import BEiT2Config
from x2vlm_tpu_torch.models.bert import BertConfig
from x2vlm_tpu_torch.models.clip_vit import CLIPViTConfig
from x2vlm_tpu_torch.models.swin import SwinConfig
from x2vlm_tpu_torch.models.xvlm import XVLMConfig, vision_width
from x2vlm_tpu_torch.models.xvlm_plus import XVLMPlusConfig

__all__ = ["vision_config_from_yaml", "text_config_from_yaml", "xvlm_config_from_yaml",
           "is_plus_config", "model_dtype", "build_model"]


def vision_config_from_yaml(config: Dict) -> Any:
    image_res = config["image_res"]
    vc_path = config.get("vision_config")
    vc = read_json(vc_path) if vc_path and os.path.exists(vc_path) else Config(
        config.get("vision_config_inline", {}))
    switches = [k for k in ("use_clip_vit", "use_swin", "use_beit_v2") if config.get(k, False)]
    if len(switches) > 1:
        raise ValueError(f"vision switches are mutually exclusive: {switches}")
    if config.get("use_clip_vit", False):
        return CLIPViTConfig(
            image_res=image_res, patch_size=vc.get("patch_size", 16),
            embed_dim=vc.get("vision_width", 768), depth=vc.get("num_hidden_layers", 12),
            num_heads=vc.get("num_attention_heads", 12),
            intermediate_size=vc.get("intermediate_size", 3072),
            attn_dropout_rate=vc.get("attention_dropout", 0.0),
            act=vc.get("hidden_act", "quick_gelu"),
            # -1 and 0 both mean off (reference configs ship either)
            local_attn_depth=max(0, vc.get("local_attn_depth", 0)))
    if config.get("use_swin", False):
        out = SwinConfig(
            image_res=image_res, patch_size=vc.get("patch_size", 4),
            embed_dim=vc.get("embed_dim", 128), depths=tuple(vc.get("depths", (2, 2, 18, 2))),
            num_heads=tuple(vc.get("num_heads", (4, 8, 16, 32))),
            window_size=vc.get("window_size", 7))
        # the region bitmaps lie on the output token grid: the YAML's
        # patch_size must be Swin's final stride, stem patch x 2^(stages - 1)
        stride = out.patch_size * 2 ** (out.num_layers - 1)
        if config.get("patch_size", stride) != stride:
            raise ValueError(f"use_swin requires patch_size: {stride} (the final-stage "
                             f"token grid), got {config.get('patch_size')}")
        return out
    width = vc.get("vision_width", 768)
    patch = vc.get("patch_size", config.get("patch_size", 16))
    if "num_hidden_layers" in vc or "num_attention_heads" in vc:
        return BEiT2Config(image_res=image_res, patch_size=patch, embed_dim=width,
                           depth=vc.get("num_hidden_layers", 12),
                           num_heads=vc.get("num_attention_heads", 12))
    if width >= 1024:   # the JAX BEiT2Config.large preset
        return BEiT2Config(image_res=image_res, patch_size=patch, embed_dim=1024, depth=24,
                           num_heads=16)
    return BEiT2Config.base(image_res=image_res, patch_size=patch)


def text_config_from_yaml(config: Dict, vision_width: int) -> BertConfig:
    name = str(config.get("text_encoder", "bert-base-uncased")).lower()
    num_layers = config.get("text_num_hidden_layers", 18)
    fusion = config.get("text_fusion_start_at", config.get("text_fusion_layer", num_layers))
    if "xlm-roberta" in name or "roberta" in name:
        out = BertConfig.roberta_base(num_layers=num_layers, fusion_layer=fusion,
                                      encoder_width=vision_width)
    elif "large" in name:   # the JAX BertConfig.bert_large preset
        out = BertConfig(hidden_size=1024, num_heads=16, intermediate_size=4096,
                         num_layers=num_layers, fusion_layer=fusion,
                         encoder_width=vision_width)
    else:
        out = BertConfig.bert_base(num_layers=num_layers, fusion_layer=fusion,
                                   encoder_width=vision_width)
    # hidden dropout, then the stochastic-depth knobs: BertConfig zeroes
    # hidden_dropout whenever text_drop_path_rate > 0 (reference xbert.py:637-641)
    overrides = {}
    if "dropout" in config:
        overrides["hidden_dropout"] = float(config["dropout"])
    if "text_drop_path_rate" in config or "cross_drop_path_rate" in config:
        overrides["text_drop_path_rate"] = float(config.get("text_drop_path_rate", 0.0))
        overrides["cross_drop_path_rate"] = float(config.get("cross_drop_path_rate", 0.0))
    if overrides:
        out = dataclasses.replace(out, **overrides)
    inline = config.get("text_config_inline")
    if inline:
        out = dataclasses.replace(out, **dict(inline))
    return out


def is_plus_config(config: Dict) -> bool:
    """``model_type: cclm | xvlm_plus`` or ``replace_text_encoder``: the Plus
    / CCLM base (the JAX factory's rule)."""
    return config.get("model_type", "") in ("xvlm_plus", "cclm") or \
        bool(config.get("replace_text_encoder", False))


def xvlm_config_from_yaml(config: Dict) -> XVLMConfig:
    vision = vision_config_from_yaml(config)
    text = text_config_from_yaml(config, vision_width(vision))
    # gradient checkpointing per block (the JAX factory's rule): both towers
    if config.get("remat", False):
        policy = config.get("remat_policy")
        vision = dataclasses.replace(vision, remat=True, remat_policy=policy)
        text = dataclasses.replace(text, remat=True, remat_policy=policy)
    common = dict(vision=vision, text=text, embed_dim=config.get("embed_dim", 256),
                  temp=config.get("temp", 0.07), fix_temp=config.get("fix_temp", False),
                  video_encoding=config.get("video_encoding", ""),
                  frame_len=config.get("frame_len", 1),
                  add_frame_pos=config.get("add_frame_pos", False),
                  resampler_depth=config.get("resampler_depth", 2),
                  resampler_latents=config.get("resampler_latents", 64))
    if is_plus_config(config):
        # the reference's Plus stack asserts drop-path away (xvlm.py:1012)
        if config.get("cross_drop_path_rate", 0.0) or config.get("text_drop_path_rate", 0.0):
            raise ValueError("drop-path is not implemented for XVLMPlus / CCLM (reference "
                             "xvlm.py:1012)")
        return XVLMPlusConfig(num_cross_layers=config.get("num_cross_layers", 6), **common)
    return XVLMConfig(**common)


def model_dtype(config: Dict) -> torch.dtype:
    """Compute dtype from accelerator.MIXED_PRECISION: bf16 (default; the
    reference's fp16 levels map to bf16) or no / fp32."""
    mp = str(config.get("accelerator", {}).get("MIXED_PRECISION", "bf16")).lower()
    if mp in ("no", "fp32", "o0"):
        return torch.float32
    if mp in ("bf16", "fp16", "o1", "o2"):
        return torch.bfloat16
    raise ValueError(f"unknown accelerator.MIXED_PRECISION: {mp!r}")


def build_model(config: Dict, task: str, *, device, dtype=None, seed=0):
    """(model, XVLMConfig) for ``task`` ("pretrain" | "retrieval" |
    "grounding" | "nlvr" | "vqa" | "captioning" | "classification" |
    "multiple_choice") on ``device``, its parameters filled from ``seed``
    (None: left for ``load_state_dict``)."""
    from x2vlm_tpu_torch.models import (
        XVLMForClassification, XVLMForGrounding, XVLMForMLMCaptioning,
        XVLMForMultipleChoice, XVLMForNLVR, XVLMForPretrain, XVLMForRetrieval, XVLMForVQA,
        XVLMPlusForPretrain,
    )

    models = {"pretrain": XVLMForPretrain, "retrieval": XVLMForRetrieval,
              "grounding": XVLMForGrounding, "nlvr": XVLMForNLVR,
              "vqa": functools.partial(XVLMForVQA,
                                       num_dec_layers=config.get("num_dec_layers", 6),
                                       pad_token_id=config.get("pad_token_id", 0)),
              "captioning": functools.partial(
                  XVLMForMLMCaptioning, label_smoothing=config.get("label_smoothing", 0.1)),
              "multiple_choice": XVLMForMultipleChoice}
    if task == "classification":
        models[task] = functools.partial(XVLMForClassification,
                                         num_labels=config["num_labels"])
    if task not in models:
        raise ValueError(f"unknown task {task!r}")
    dtype = dtype or model_dtype(config)
    cfg = xvlm_config_from_yaml(config)
    if cfg.is_plus:
        models["pretrain"] = XVLMPlusForPretrain
    return models[task](cfg, dtype=dtype, device=device, seed=seed), cfg
