"""Config-key registry + consumption audit (the port's copy of
x2vlm_tpu/core/config_schema.py: the same registry, so a shipped config
validates the same way in both packages; the consumers named are the JAX
package's, and the port's launcher refuses the keys of tasks and streams it
does not port yet).

Every YAML/JSON key a shipped config may carry is registered here with the
place that consumes it. ``validate_config`` raises on unregistered keys, so a
config knob that nothing reads is a structural impossibility instead of a
silent no-op (the recurring bug class: round 3 ``is_xvlm_ckpt``/``use_clip_vit``,
round 4 ``text_drop_path_rate``/swin ``drop_path_rate``). The launcher
validates at load time; tests/test_config_zoo.py walks every shipped config
AND cross-checks that each registered key really is read by the source.

Keys beginning with ``_`` are user-comment escape hatches and always pass.
"""

from __future__ import annotations

from typing import List, Mapping

__all__ = ["TOP_LEVEL", "BLOCKS", "VISION_JSON", "TEXT_CONFIG_FIELDS", "unknown_keys",
           "validate_config"]

# the fields of the JAX package's BertConfig, the keys ``text_config_inline``
# may carry (the port's factory refuses those it does not build)
TEXT_CONFIG_FIELDS = frozenset((
    "vocab_size", "hidden_size", "num_layers", "fusion_layer", "num_heads",
    "intermediate_size", "max_position_embeddings", "type_vocab_size", "encoder_width",
    "ln_eps", "hidden_dropout", "attn_dropout", "position_offset", "act", "remat",
    "remat_policy", "quant_int8", "embedding_dim", "tie_word_embeddings", "is_decoder",
    "text_drop_path_rate", "cross_drop_path_rate"))

# ---------------------------------------------------------------------------
# value = the consumer ("file_or_func" the key is read in), for auditability.
# "parity:" prefixed entries are accepted-but-inert BY REFERENCE PARITY — the
# reference also reads-and-ignores or hard-asserts them; the consumer noted is
# where this repo validates/acknowledges them.

TOP_LEVEL = {
    # --- model geometry / factory ------------------------------------------
    "image_res": "factory.vision_config_from_yaml",
    "patch_size": "factory.vision_config_from_yaml (+ region patch grid)",
    "vision_config": "factory.vision_config_from_yaml (JSON pointer)",
    "vision_config_inline": "factory.vision_config_from_yaml",
    "use_beit_v2": "factory.vision_config_from_yaml (default branch + "
                   "exclusivity check)",
    "use_clip_vit": "factory.vision_config_from_yaml",
    "use_swin": "factory.vision_config_from_yaml",
    "vision_width": "factory (inline vision config)",
    "text_encoder": "factory.text_config_from_yaml + tokenization + raw init",
    "text_num_hidden_layers": "factory.text_config_from_yaml",
    "text_fusion_start_at": "factory.text_config_from_yaml",
    "text_fusion_layer": "factory.text_config_from_yaml (alias)",
    "text_config_inline": "factory.text_config_from_yaml",
    "text_drop_path_rate": "factory → BertConfig (stochastic depth)",
    "cross_drop_path_rate": "factory → BertConfig (stochastic depth)",
    "dropout": "factory → BertConfig.hidden_dropout",
    "attention_dropout": "factory (clip vision JSON also carries it)",
    "hidden_act": "factory (clip vision JSON also carries it)",
    "num_attention_heads": "factory (inline vision config)",
    "num_hidden_layers": "factory (inline vision config)",
    "intermediate_size": "factory (inline vision config)",
    "depths": "factory (inline swin config)",
    "num_heads": "factory (inline swin config)",
    "window_size": "factory (inline swin config)",
    "embed_dim": "factory.xvlm_config_from_yaml (ITC projection)",
    "temp": "factory.xvlm_config_from_yaml",
    "fix_temp": "factory.xvlm_config_from_yaml",
    "model_type": "factory.xvlm_config_from_yaml (xvlm_plus/cclm)",
    "num_cross_layers": "factory.xvlm_config_from_yaml (Plus)",
    "replace_text_encoder": "factory + checkpoint.split_imported_to_plus",
    "video_encoding": "factory.xvlm_config_from_yaml (avgpool/resampler)",
    "frame_len": "factory + run_pretrain video stream",
    "add_frame_pos": "factory.xvlm_config_from_yaml",
    "resampler_depth": "factory.xvlm_config_from_yaml",
    "resampler_latents": "factory.xvlm_config_from_yaml",
    "remat": "factory.xvlm_config_from_yaml (gradient checkpointing)",
    "remat_policy": "factory.xvlm_config_from_yaml",
    "ckpt": "run.load_initial_params (raw vision init; vision JSONs)",
    # --- text preprocessing --------------------------------------------------
    "max_tokens": "run_pretrain TextPreprocessor / retrieval example",
    "max_words": "run_pretrain TextPreprocessor",
    "max_masks": "run_pretrain TextPreprocessor",
    "mask_prob": "run_pretrain TextPreprocessor",
    "mask_whole_word": "run_pretrain TextPreprocessor",
    "skipgram_prb": "run_pretrain TextPreprocessor",
    "skipgram_size": "run_pretrain TextPreprocessor",
    # --- data locations / streams -------------------------------------------
    "train_file": "run_pretrain / data.factory",
    "train_file_aux": "run_pretrain (clean-data aux stream)",
    "train_file_regions": "run_pretrain",
    "train_file_videos": "run_pretrain",
    "train_file_videos_aux": "run_pretrain",
    "train_file_text": "run_pretrain",
    "train_file_mtext": "run_pretrain (CCLM para-text)",
    "test_file": "data.factory",
    "image_root": "data.factory",
    "image_root_train": "data.factory (SCST)",
    "vqa_root": "data.factory (vqa)",
    "vg_root": "data.factory (vqa; dataset:'vg' rows)",
    "video_root": "data.factory (video tasks)",
    "marvl_image_root": "data.factory (marvl)",
    "images": "run_pretrain stream block",
    "regions": "run_pretrain stream block",
    "videos": "run_pretrain stream block",
    "texts": "run_pretrain stream block",
    "mtexts": "run_pretrain stream block (CCLM)",
    "train_dataset_size": "run_pretrain steps_per_epoch",
    "dataset_type": "data.factory (video qa variants)",
    "answer_list": "data.factory (vqa eval answers)",
    "answer_max_tokens": "data.factory (vqa)",
    "answers_per_batch": "run_vqa collate",
    "careful_hflip": "data.factory grounding/region transforms",
    "fg_free": "data.factory captioning (FG-free UniLM)",
    "prompt": "run_captioning / scst",
    "caption_gt_file": "run_captioning eval",
    "refs_file": "run_grounding eval",
    "num_labels": "factory.build_model (classification)",
    "num_options": "data.factory (multiple choice)",
    "num_dec_layers": "factory.build_model (vqa decoder)",
    "pad_token_id": "factory.build_model (vqa decoder)",
    "label_smoothing": "factory.build_model (captioning)",
    # --- training schedule / optimizer ---------------------------------------
    "batch_size": "runners (effective per-step batch)",
    "batch_size_test": "runners (eval batch)",
    "batch_size_test_text": "retrieval eval (text-side batch)",
    "batch_size_scst": "run_captioning scst",
    "accumulate_steps": "run (microbatch split inside one step)",
    "optimizer": "run.make_optimizer block",
    "schedular": "run.make_optimizer block (sic, reference spelling)",
    "accelerator": "run.make_optimizer + factory.model_dtype block",
    "flat_optimizer": "run.make_optimizer (fused flat AdamW override)",
    "native_aug": "run_pretrain image_transform (C++ decode+augment; "
                  "auto|true|false)",
    "large_lr_for_dec": "run (decoder subtree → lr_mult group)",
    "ckpt_frequent": "run_pretrain (epoch-boundary save cadence)",
    "ckpt_frequent_step": "run_pretrain (step save cadence)",
    "start_eval": "tasks.finetune.train_epochs (skip early evals)",
    "k_test": "retrieval/vqa rerank depth",
    "scst": "run_captioning (self-critical fine-tune)",
    "scst_num_samples": "tasks.scst",
    "stop_calc_itm": "run_pretrain (ITM NaN-guard schedule)",
    "calc_image_bbox_loss": "run_pretrain (bbox loss on full-image rows)",
    "mixed_in_batch": "run_pretrain (validated; mixed step is the only "
                      "implemented path — parity with Pretrain.py:359)",
    "aux_iter_perc": "run_pretrain (clean-data replacement prob)",
    "video_aux_iter_perc": "run_pretrain",
    "regions_use_bbox_only": "run_pretrain (zero itc/itm/mlm on regions)",
    "pick_best_t2v": "run_retrieval (best-ckpt metric)",
    "pick_best_r1": "run_retrieval (best-ckpt metric; --pick_best_r1)",
    "gmt_test_file": "run.setup (--gmt swaps it into test_file)",
    # --- checkpoint import knobs ---------------------------------------------
    "is_xvlm_ckpt": "run.load_initial_params (Base→Plus split)",
    "xvlm_ckpt_text_num_hidden_layers": "run.load_initial_params",
    # --- generation ----------------------------------------------------------
    "num_beams": "run_captioning",
    "min_length": "run_captioning",
    "max_length": "run_captioning",
    "length_penalty": "run_captioning → beam traceback",
    # --- eval variants -------------------------------------------------------
    "vlue_test": "run_grounding (VLUE test-set eval variants)",
}

# stream blocks (images / regions / videos / texts / mtexts)
_STREAM = {
    "image_key": "run_pretrain stream ctor",
    "caption_key": "run_pretrain stream ctor",
    "aux_caption_key": "run_pretrain aux stream",
    "is_image_rpath": "run_pretrain stream ctor",
    "batch_size": "run_pretrain iter_batches",
    "iter_perc": "tasks.pretrain loss weight",
    "num_workers": "run_pretrain Prefetcher depth",
    "tokenized": "run_pretrain (validated false; reference "
                 "pretrain_dataset.py:147 asserts the same)",
    "languages": "run_pretrain multilingual streams",
    "code_switch": "run_pretrain region multilingual stream",
    "max_images": "run_pretrain region collate",
    "max_regions": "run_pretrain region stream",
    "min_perc_in_image": "run_pretrain region stream",
    "careful_hflip": "run_pretrain region stream",
    "frames_key": "run_pretrain video stream",
    "frame_len": "run_pretrain video stream",
    "combine_continuous_clips": "run_pretrain video stream (clip merging)",
    "mininum_frames_before_sampling": "run_pretrain video stream (sic, "
                                      "reference spelling)",
    "use_random_sampling": "parity: read-and-unused in the reference too "
                           "(pretrain_dataset.py:299 assigns, never reads)",
    "max_tokens": "run_pretrain mtext preprocessor",
    "max_words": "run_pretrain mtext preprocessor",
    "max_masks": "run_pretrain mtext preprocessor",
    "mask_prob": "run_pretrain mtext preprocessor",
    "source_key": "run_pretrain ParaTextStream",
    "target_key": "run_pretrain ParaTextStream",
}

BLOCKS = {
    "images": _STREAM,
    "regions": _STREAM,
    "videos": _STREAM,
    "texts": _STREAM,
    "mtexts": _STREAM,
    "optimizer": {
        "opt": "run.make_optimizer (validated: adamW)",
        "lr": "run.make_optimizer",
        "weight_decay": "run.make_optimizer",
        "lr_mult": "run.make_optimizer (fresh-param group)",
        "vision_lr": "run.make_optimizer",
        "text_lr": "run.make_optimizer",
        "cross_lr": "run.make_optimizer",
    },
    "schedular": {
        "sched": "run.make_optimizer (validated: linear)",
        "lr": "run.make_optimizer",
        "epochs": "runners",
        "num_warmup_steps": "train.optim.lr_schedule",
        "min_rate": "train.optim.lr_schedule",
    },
    "accelerator": {
        "MIXED_PRECISION": "factory.model_dtype",
        "CLIP_GRAD_NORM": "run.make_optimizer",
    },
}

# vision config JSON files (configs/config_*.json) / vision_config_inline
VISION_JSON = {
    "ckpt": "run.load_initial_params (raw vision init)",
    "vision_width": "factory.vision_config_from_yaml",
    "image_res": "factory (vision JSONs may restate it; YAML wins)",
    "patch_size": "factory.vision_config_from_yaml",
    "num_hidden_layers": "factory.vision_config_from_yaml",
    "num_attention_heads": "factory.vision_config_from_yaml",
    "intermediate_size": "factory.vision_config_from_yaml (clip)",
    "hidden_act": "factory → CLIPViTConfig.act",
    "attention_dropout": "factory → CLIPViTConfig.attn_dropout_rate",
    "local_attn_depth": "factory → CLIPViTConfig (last-k region-masked "
                        "attention inside the tower)",
    "embed_dim": "factory (swin)",
    "depths": "factory (swin)",
    "num_heads": "factory (swin)",
    "window_size": "factory (swin)",
}


def unknown_keys(cfg: Mapping) -> List[str]:
    """Dotted paths of keys no consumer is registered for."""
    out: List[str] = []
    for k, v in cfg.items():
        if k.startswith("_"):
            continue
        if k == "vision_config_inline":
            if isinstance(v, Mapping):
                out += [f"{k}.{k2}" for k2 in v
                        if k2 not in VISION_JSON and not k2.startswith("_")]
            continue
        if k == "text_config_inline":
            if isinstance(v, Mapping):
                out += [f"{k}.{k2}" for k2 in v
                        if k2 not in TEXT_CONFIG_FIELDS and not k2.startswith("_")]
            continue
        if k not in TOP_LEVEL:
            out.append(k)
            continue
        sub = BLOCKS.get(k)
        if sub is not None and isinstance(v, Mapping):
            out += [f"{k}.{k2}" for k2 in v
                    if k2 not in sub and not k2.startswith("_")]
    return out


def unknown_vision_json_keys(vc: Mapping) -> List[str]:
    return [k for k in vc if k not in VISION_JSON and not k.startswith("_")]


def validate_config(cfg: Mapping, source: str = "config") -> None:
    """Raise on keys nothing consumes — a typo or an unimplemented knob."""
    bad = unknown_keys(cfg)
    if bad:
        raise ValueError(
            f"{source} carries keys nothing in this framework reads: {bad}. "
            "Registered keys live in x2vlm_tpu_torch/core/config_schema.py — "
            "wire the consumer there, or prefix the key with '_' if it is "
            "a comment.")
