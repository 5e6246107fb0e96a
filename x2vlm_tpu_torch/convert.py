"""Carry parameters between the JAX package's layout and the port's.

JAX side: the flat ``'/'``-joined numpy dict that the JAX package's
``serving.save_params_npz`` writes (``params.npz``), or the nested
parameter tree in memory. Port side: the state dict under the reference
X2-VLM checkpoint names. :func:`convert_jax_params` goes from JAX to the
port (the exact inverse of the JAX package's
``train/checkpoint.convert_xvlm_state_dict`` for the modules the port
carries); :func:`to_jax_params` goes back, under the names a JAX task
model's ``init`` gives (``params/base/...`` for the composition core,
``params/{text_decoder,dec_head,cls_head,mc_head}/...`` for the heads a
task keeps beside it).

One table of rules (:func:`_rules`) serves both directions, built from the
layout either side's names show: the vision tower (BEiT-2, CLIP ViT, Swin
or ViT) and its depth, the text stacks' layers (the RoBERTa form's
``text_encoder.roberta`` and ``text_decoder.roberta`` where the JAX tree's
text tower has one token type), the Plus base's ``cross_encoder/layer_j``
(``cross_encoder.encoder.layer.j``) and the heads (the MLM head's and the
answer decoder's ``lm_head`` names in the RoBERTa form, the MLM head's own
decoder when untied). A rule none of whose parameters is
present is skipped, so a partial set (a checkpoint split) converts too. flax kernels
(in, out) are torch Linear weights (out, in); the patch kernel (p, p, in,
C) is the conv weight (C, in, p, p); BEiT-2's and ViT's query / key / value
kernels are the fused ``attn.qkv.weight``.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Mapping, Tuple, Union

import numpy as np
import torch

from x2vlm_tpu_torch.device import resolve_device

__all__ = ["convert_jax_params", "to_jax_params", "load_params_npz", "flatten_params"]

# the JAX task models keep these beside the composition core, not under ``base``
HEAD_LEVEL = ("text_decoder", "dec_head", "cls_head", "mc_head")


def flatten_params(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested parameter dict -> flat ``'/'``-joined numpy dict."""
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten_params(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def load_params_npz(path: Union[str, os.PathLike]) -> Dict[str, np.ndarray]:
    with np.load(path) as flat:
        return {k: flat[k] for k in flat.files}


def _strip_scope(flat: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Drop the ``params/`` collection and the task head's ``base/`` scope."""
    out = {}
    for k, v in flat.items():
        for scope in ("params/", "base/"):
            if k.startswith(scope):
                k = k[len(scope):]
        out[k] = v
    return out


# ---- the layout of a parameter set, read from either side's names ----

def _indices(keys, pattern: str) -> List[int]:
    return sorted({int(m.group(1)) for k in keys if (m := re.match(pattern, k))})


def _layout_from_jax(src: Mapping[str, np.ndarray]) -> dict:
    ks = set(src)
    v = "vision_encoder/"
    if f"{v}class_embedding" in ks:
        vision = "clip"
    elif any(k.startswith(f"{v}stage_") for k in ks):
        vision = "swin"
    elif f"{v}rel_pos_table_0" in ks:
        vision = "beit2"
    elif f"{v}cls_token" in ks:
        vision = "vit"
    else:
        vision = None
    stages = _indices(ks, rf"{v}stage_(\d+)_block_")
    return {
        "vision": vision,
        "depth": len(_indices(ks, rf"{v}block_(\d+)/")),
        "depths": tuple(len(_indices(ks, rf"{v}stage_{s}_block_(\d+)/")) for s in stages),
        "merges": tuple(_indices(ks, rf"{v}merge_(\d+)/")),
        "text": {t: [(i, f"{t}/layer_{i}/cross_attn/query/kernel" in ks)
                     for i in _indices(ks, rf"{t}/layer_(\d+)/")]
                 for t in ("text_encoder", "text_decoder")},
        # the RoBERTa form: one token type (models/bert.py ``roberta_form``)
        "roberta": np.shape(src.get(
            "text_encoder/embeddings/token_type_embeddings/embedding",
            src.get("text_decoder/embeddings/token_type_embeddings/embedding",
                    np.zeros((2, 1)))))[0] == 1,
        "cross": _indices(ks, r"cross_encoder/layer_(\d+)/"),
        "untied": "mlm_head/decoder/kernel" in ks,
        "heads": {h for h in ("mlm_head", "dec_head", "vision_proj", "text_proj", "temp",
                              "itm_head", "bbox_head", "cls_head", "mc_head", "frame_pos_embed")
                  if any(k == h or k.startswith(h + "/") for k in ks)},
        "resampler": len(_indices(ks, r"resampler/attn_(\d+)/")),
    }


def _layout_from_port(keys) -> dict:
    ks = set(keys)
    roberta = any(k.startswith(("text_encoder.roberta.", "text_encoder.lm_head.",
                                "text_decoder.roberta.")) for k in ks)
    stack = "roberta" if roberta else "bert"
    v = r"vision_encoder\."
    if "vision_encoder.class_embedding" in ks:
        vision = "clip"
    elif "vision_encoder.patch_embed.norm.weight" in ks:
        vision = "swin"
    elif "vision_encoder.blocks.0.attn.q_bias" in ks:
        vision = "beit2"
    elif "vision_encoder.cls_token" in ks:
        vision = "vit"
    else:
        vision = None
    stages = _indices(ks, rf"{v}layers\.(\d+)\.blocks\.")
    return {
        "vision": vision,
        "depth": len(_indices(ks, rf"{v}(?:blocks|encoder\.layers)\.(\d+)\.")),
        "depths": tuple(len(_indices(ks, rf"{v}layers\.{s}\.blocks\.(\d+)\."))
                        for s in stages),
        "merges": tuple(_indices(ks, rf"{v}layers\.(\d+)\.downsample\.")),
        "text": {t: [(i, f"{t}.{stack}.encoder.layer.{i}.crossattention.self.query.weight"
                      in ks)
                     for i in _indices(ks, rf"{t}\.{stack}\.encoder\.layer\.(\d+)\.")]
                 for t in ("text_encoder", "text_decoder")},
        "roberta": roberta,
        "cross": _indices(ks, r"cross_encoder\.encoder\.layer\.(\d+)\."),
        "untied": any(k.startswith(("text_encoder.lm_head.decoder.",
                                    "text_encoder.cls.predictions.decoder.")) for k in ks),
        "heads": {h for h, probe in (
            ("mlm_head", "text_encoder.lm_head.dense.weight" if roberta
             else "text_encoder.cls.predictions.transform.dense.weight"),
            ("dec_head", "text_decoder.lm_head.bias" if roberta
             else "text_decoder.cls.predictions.bias"),
            ("vision_proj", "vision_proj.weight"), ("text_proj", "text_proj.weight"),
            ("temp", "temp"), ("itm_head", "itm_head.0.weight"),
            ("bbox_head", "bbox_head.0.weight"), ("cls_head", "cls_head.0.weight"),
            ("mc_head", "mc_head.0.weight"), ("frame_pos_embed", "absolute_frame_pos_embed"))
            if probe in ks},
        "resampler": len(_indices(ks, r"resampler\.attn_(\d+)\.")),
    }


# ---- the rules: (kind, port names, JAX names) ----

def _dense(p: str, j: str):
    return ("dense", (f"{p}.weight", f"{p}.bias"), (f"{j}/kernel", f"{j}/bias"))


def _norm(p: str, j: str):
    return ("copy", (f"{p}.weight", f"{p}.bias"), (f"{j}/scale", f"{j}/bias"))


def _copy(p: str, j: str):
    return ("copy", (p,), (j,))


def _fused_qkv(p: str, j: str, bias: bool):
    """A fused ``qkv`` projection <-> separate query / key / value ones."""
    out = [("qkv", (f"{p}.weight",), tuple(f"{j}/{n}/kernel" for n in ("query", "key",
                                                                          "value")))]
    if bias:
        out.append(("cat", (f"{p}.bias",), tuple(f"{j}/{n}/bias" for n in ("query", "key",
                                                                             "value"))))
    return out


def _vision_rules(lay: dict):
    p, j = "vision_encoder", "vision_encoder"
    kind = lay["vision"]
    if kind in ("beit2", "vit"):
        yield ("conv", (f"{p}.patch_embed.proj.weight",), (f"{j}/patch_embed/kernel",))
        yield _copy(f"{p}.patch_embed.proj.bias", f"{j}/patch_embed/bias")
        yield _copy(f"{p}.cls_token", f"{j}/cls_token")
        yield _norm(f"{p}.{'fc_norm' if kind == 'beit2' else 'norm'}",
                    f"{j}/{'fc_norm' if kind == 'beit2' else 'norm'}")
        if kind == "vit":
            yield _copy(f"{p}.pos_embed", f"{j}/pos_embed")
        for i in range(lay["depth"]):
            b, q = f"{p}.blocks.{i}", f"{j}/block_{i}"
            yield _norm(f"{b}.norm1", f"{q}/norm1")
            yield _norm(f"{b}.norm2", f"{q}/norm2")
            yield from _fused_qkv(f"{b}.attn.qkv", f"{q}/attn", bias=kind == "vit")
            if kind == "beit2":
                yield _copy(f"{b}.attn.q_bias", f"{q}/attn/query/bias")
                yield _copy(f"{b}.attn.v_bias", f"{q}/attn/value/bias")
                yield _copy(f"{b}.attn.relative_position_bias_table",
                            f"{j}/rel_pos_table_{i}")
                yield _copy(f"{b}.gamma_1", f"{q}/gamma_1")
                yield _copy(f"{b}.gamma_2", f"{q}/gamma_2")
            yield _dense(f"{b}.attn.proj", f"{q}/attn/out")
            yield _dense(f"{b}.mlp.fc1", f"{q}/mlp/fc1")
            yield _dense(f"{b}.mlp.fc2", f"{q}/mlp/fc2")
    elif kind == "clip":
        yield ("conv", (f"{p}.patch_embed.weight",), (f"{j}/patch_embed/kernel",))
        yield _copy(f"{p}.class_embedding", f"{j}/class_embedding")
        yield _copy(f"{p}.pos_embed.weight", f"{j}/pos_embed")
        yield _norm(f"{p}.pre_layrnorm", f"{j}/pre_layernorm")
        yield _norm(f"{p}.post_layernorm", f"{j}/post_layernorm")
        for i in range(lay["depth"]):
            b, q = f"{p}.encoder.layers.{i}", f"{j}/block_{i}"
            yield _norm(f"{b}.layer_norm1", f"{q}/layer_norm1")
            yield _norm(f"{b}.layer_norm2", f"{q}/layer_norm2")
            for ours, theirs in (("q_proj", "query"), ("k_proj", "key"), ("v_proj", "value"),
                                 ("out_proj", "out")):
                yield _dense(f"{b}.self_attn.{ours}", f"{q}/attn/{theirs}")
            yield _dense(f"{b}.mlp.fc1", f"{q}/fc1")
            yield _dense(f"{b}.mlp.fc2", f"{q}/fc2")
    elif kind == "swin":
        yield ("conv", (f"{p}.patch_embed.proj.weight",), (f"{j}/patch_embed/kernel",))
        yield _copy(f"{p}.patch_embed.proj.bias", f"{j}/patch_embed/bias")
        yield _norm(f"{p}.patch_embed.norm", f"{j}/patch_norm")
        yield _norm(f"{p}.norm", f"{j}/norm")
        for s, depth in enumerate(lay["depths"]):
            for i in range(depth):
                b, q = f"{p}.layers.{s}.blocks.{i}", f"{j}/stage_{s}_block_{i}"
                yield _norm(f"{b}.norm1", f"{q}/norm1")
                yield _norm(f"{b}.norm2", f"{q}/norm2")
                yield _dense(f"{b}.attn.qkv", f"{q}/attn/qkv")
                yield _dense(f"{b}.attn.proj", f"{q}/attn/proj")
                yield _copy(f"{b}.attn.relative_position_bias_table", f"{q}/attn/rel_pos_table")
                yield _dense(f"{b}.mlp.fc1", f"{q}/mlp/fc1")
                yield _dense(f"{b}.mlp.fc2", f"{q}/mlp/fc2")
        for s in lay["merges"]:
            d, q = f"{p}.layers.{s}.downsample", f"{j}/merge_{s}"
            yield _norm(f"{d}.norm", f"{q}/norm")
            yield ("linear", (f"{d}.reduction.weight",), (f"{q}/reduction/kernel",))


def _layer_rules(p: str, q: str, cross: bool):
    """One post-LN BERT layer: ``p`` its reference prefix, ``q`` its JAX one."""
    for ref, jax_attn, ln, present in (("attention", "self_attn", "attn_ln", True),
                                       ("crossattention", "cross_attn", "cross_ln", cross)):
        if not present:
            continue
        for proj in ("query", "key", "value"):
            yield _dense(f"{p}.{ref}.self.{proj}", f"{q}/{jax_attn}/{proj}")
        yield _dense(f"{p}.{ref}.output.dense", f"{q}/{jax_attn}/out")
        yield _norm(f"{p}.{ref}.output.LayerNorm", f"{q}/{ln}")
    yield _dense(f"{p}.intermediate.dense", f"{q}/mlp/fc1")
    yield _dense(f"{p}.output.dense", f"{q}/mlp/fc2")
    yield _norm(f"{p}.output.LayerNorm", f"{q}/mlp_ln")


def _text_rules(tower: str, layers, stack: str = "bert"):
    e, t = f"{tower}.{stack}.embeddings", f"{tower}/embeddings"
    for n in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        yield _copy(f"{e}.{n}.weight", f"{t}/{n}/embedding")
    yield _norm(f"{e}.LayerNorm", f"{t}/ln")
    for i, cross in layers:
        yield from _layer_rules(f"{tower}.{stack}.encoder.layer.{i}", f"{tower}/layer_{i}", cross)


def _head_rules(heads, roberta: bool = False, untied: bool = False):
    # the LM heads: the MLM head (XLM-R's ``lm_head`` names in the RoBERTa
    # form; its own decoder when untied) and the VQA answer decoder's
    if "mlm_head" in heads:
        if roberta:
            m = "text_encoder.lm_head"
            yield _dense(f"{m}.dense", "mlm_head/transform_dense")
            yield _norm(f"{m}.layer_norm", "mlm_head/transform_ln")
        else:
            m = "text_encoder.cls.predictions"
            yield _dense(f"{m}.transform.dense", "mlm_head/transform_dense")
            yield _norm(f"{m}.transform.LayerNorm", "mlm_head/transform_ln")
        if untied:
            yield _dense(f"{m}.decoder", "mlm_head/decoder")
        else:
            yield _copy(f"{m}.bias", "mlm_head/decoder_bias")
    if "dec_head" in heads:
        if roberta:
            m = "text_decoder.lm_head"
            yield _dense(f"{m}.dense", "dec_head/transform_dense")
            yield _norm(f"{m}.layer_norm", "dec_head/transform_ln")
        else:
            m = "text_decoder.cls.predictions"
            yield _dense(f"{m}.transform.dense", "dec_head/transform_dense")
            yield _norm(f"{m}.transform.LayerNorm", "dec_head/transform_ln")
        yield _copy(f"{m}.bias", "dec_head/decoder_bias")
    for name in ("vision_proj", "text_proj"):
        if name in heads:
            yield _dense(name, name)
    if "temp" in heads:
        yield ("scalar", ("temp",), ("temp",))
    for head in ("itm_head", "bbox_head", "cls_head", "mc_head"):
        if head in heads:
            yield _dense(f"{head}.0", f"{head}/fc1")
            yield _norm(f"{head}.1", f"{head}/ln")
            yield _dense(f"{head}.3", f"{head}/fc2")
    if "frame_pos_embed" in heads:
        yield _copy("absolute_frame_pos_embed", "frame_pos_embed")


def _resampler_rules(depth: int):
    """The Perceiver resampler: its torch names are the JAX ones with
    ``.`` for ``/`` (LayerNorm ``scale`` -> ``weight``; bias-free dense
    kernels transposed)."""
    p, j = "resampler", "resampler"
    yield _copy(f"{p}.latents", f"{j}/latents")
    yield _copy(f"{p}.time_pos_emb", f"{j}/time_pos_emb")
    for i in range(depth):
        a, q = f"{p}.attn_{i}", f"{j}/attn_{i}"
        yield _norm(f"{a}.norm_media", f"{q}/norm_media")
        yield _norm(f"{a}.norm_latents", f"{q}/norm_latents")
        for proj in ("to_q", "to_k", "to_v", "to_out"):
            yield ("linear", (f"{a}.{proj}.weight",), (f"{q}/{proj}/kernel",))
        yield _norm(f"{p}.ff_norm_{i}", f"{j}/ff_norm_{i}")
        for ff in ("ff1", "ff2"):
            yield ("linear", (f"{p}.{ff}_{i}.weight",), (f"{j}/{ff}_{i}/kernel",))
    yield _norm(f"{p}.norm_out", f"{j}/norm_out")


def _rules(lay: dict):
    yield from _vision_rules(lay)
    for tower, layers in lay["text"].items():
        if layers:
            yield from _text_rules(tower, layers, "roberta" if lay["roberta"] else "bert")
    for j in lay["cross"]:   # the Plus base's standalone cross encoder
        yield from _layer_rules(f"cross_encoder.encoder.layer.{j}", f"cross_encoder/layer_{j}",
                                True)
    yield from _head_rules(lay["heads"], lay["roberta"], lay["untied"])
    if lay["resampler"]:
        yield from _resampler_rules(lay["resampler"])


def _to_port(kind: str, src: List[np.ndarray]) -> List[np.ndarray]:
    if kind == "dense":
        return [src[0].T, src[1]]
    if kind == "linear":
        return [src[0].T]
    if kind == "conv":
        return [src[0].transpose(3, 2, 0, 1)]
    if kind == "qkv":
        return [np.concatenate([k.T for k in src])]
    if kind == "cat":
        return [np.concatenate(src)]
    if kind == "scalar":
        return [np.asarray(src[0]).reshape(())]
    return list(src)


def _to_jax(kind: str, src: List[np.ndarray], n_out: int) -> List[np.ndarray]:
    if kind == "dense":
        return [src[0].T, src[1]]
    if kind == "linear":
        return [src[0].T]
    if kind == "conv":
        return [src[0].transpose(2, 3, 1, 0)]
    if kind == "qkv":
        return [w.T for w in np.split(src[0], n_out)]
    if kind == "cat":
        return list(np.split(src[0], n_out))
    if kind == "scalar":
        return [np.asarray(src[0]).reshape(())]
    return list(src)


def _absent(names, src) -> bool:
    """A rule none of whose names is in ``src`` (a partial parameter set: a
    checkpoint split leaves the MLM decoder out) is skipped; a rule only
    part of whose names are there raises."""
    there = [n in src for n in names]
    if any(there) and not all(there):
        raise KeyError(f"only part of {names} is in the parameters")
    return not any(there)


def convert_jax_params(params: Mapping, *, device=None
                       ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """JAX task-model or ``XVLMBase`` params (any vision tower) -> (state
    dict of the port's model under the reference names, on ``device`` (the
    card unless ``device="cpu"``); sorted JAX keys the port does not carry,
    none for these models). The ``params/`` collection and a task head's
    ``base/`` scope are dropped; a head the task keeps beside the core
    (NLVR's and classification's ``cls_head``; multiple choice's
    ``mc_head``; VQA's ``text_decoder`` and ``dec_head``, as
    ``text_decoder.bert.*`` and ``text_decoder.cls.predictions.*``, or
    ``text_decoder.roberta.*`` and ``text_decoder.lm_head.*`` on the Plus /
    CCLM base's XLM-R) stays:
    load the result into the task model itself, or into
    ``XVLMForPretrain.base``."""
    device = resolve_device(device)
    flat = params if all(not isinstance(v, Mapping) for v in params.values()) \
        else flatten_params(params)
    src = _strip_scope(flat)
    layout = _layout_from_jax(src)
    if layout["vision"] is None and not layout["text"]["text_encoder"] and \
            not layout["cross"]:
        raise KeyError("no vision_encoder / text_encoder / cross_encoder parameters in the "
                       "JAX tree")
    sd: Dict[str, np.ndarray] = {}
    for kind, ours, theirs in _rules(layout):
        if _absent(theirs, src):
            continue
        sd.update(zip(ours, _to_port(kind, [np.asarray(src.pop(k)) for k in theirs])))
    state = {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(device)
             for k, v in sd.items()}
    return state, sorted(src)


def to_jax_params(state: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """A port task model's state dict (``XVLMForPretrain``'s ``base.``
    prefix dropped) -> the flat fp32 ``params/...`` dict of its JAX
    counterpart, the layout of a JAX bundle's ``params.npz``. Raises on a
    key no rule carries."""
    src = {k[len("base."):] if k.startswith("base.") else k:
           v.detach().float().cpu().numpy() for k, v in state.items()}
    out: Dict[str, np.ndarray] = {}
    for kind, ours, theirs in _rules(_layout_from_port(src)):
        if _absent(ours, src):
            continue
        vals = _to_jax(kind, [src.pop(k) for k in ours], len(theirs))
        for name, val in zip(theirs, vals):
            scope = "params/" if name.split("/")[0] in HEAD_LEVEL else "params/base/"
            out[scope + name] = np.array(val, dtype=np.float32, order="C")
    if src:
        raise ValueError(f"to_jax_params: no JAX name for {sorted(src)[:8]}")
    return out
