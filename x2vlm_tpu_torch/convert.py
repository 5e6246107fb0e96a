"""Carry the JAX package's parameters into the port.

Input: the flat ``'/'``-joined numpy dict that the JAX package's
``serving.save_params_npz`` writes (``params.npz``), or the nested
parameter tree in memory. Output: the port's state dict, under the
reference X2-VLM checkpoint names (the exact inverse of the JAX package's
``train/checkpoint.convert_xvlm_state_dict`` for the modules the port
carries, the tied MLM head and the VQA answer decoder included): flax
kernels (in, out) become torch Linear weights (out, in), the BEiT-2
query/key/value kernels are fused into ``attn.qkv.weight``, the patch
kernel (p, p, in, C) becomes the conv weight (C, in, p, p).
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Mapping, Tuple, Union

import numpy as np
import torch

from x2vlm_tpu_torch.device import resolve_device

__all__ = ["convert_jax_params", "load_params_npz", "flatten_params"]


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


def _linear(sd, src, dst: str, name: str) -> None:
    sd[f"{name}.weight"] = src.pop(f"{dst}/kernel").T
    sd[f"{name}.bias"] = src.pop(f"{dst}/bias")


def _norm(sd, src, dst: str, name: str) -> None:
    sd[f"{name}.weight"] = src.pop(f"{dst}/scale")
    sd[f"{name}.bias"] = src.pop(f"{dst}/bias")


def _vision(sd, src) -> None:
    sd["vision_encoder.cls_token"] = src.pop("vision_encoder/cls_token")
    sd["vision_encoder.patch_embed.proj.weight"] = \
        src.pop("vision_encoder/patch_embed/kernel").transpose(3, 2, 0, 1)
    sd["vision_encoder.patch_embed.proj.bias"] = src.pop("vision_encoder/patch_embed/bias")
    _norm(sd, src, "vision_encoder/fc_norm", "vision_encoder.fc_norm")
    depth = 1 + max(int(m.group(1)) for k in src
                    if (m := re.match(r"vision_encoder/block_(\d+)/", k)))
    for i in range(depth):
        q, p = f"vision_encoder/block_{i}", f"vision_encoder.blocks.{i}"
        _norm(sd, src, f"{q}/norm1", f"{p}.norm1")
        _norm(sd, src, f"{q}/norm2", f"{p}.norm2")
        sd[f"{p}.attn.qkv.weight"] = np.concatenate(
            [src.pop(f"{q}/attn/{n}/kernel").T for n in ("query", "key", "value")])
        sd[f"{p}.attn.q_bias"] = src.pop(f"{q}/attn/query/bias")
        sd[f"{p}.attn.v_bias"] = src.pop(f"{q}/attn/value/bias")
        _linear(sd, src, f"{q}/attn/out", f"{p}.attn.proj")
        sd[f"{p}.attn.relative_position_bias_table"] = \
            src.pop(f"vision_encoder/rel_pos_table_{i}")
        sd[f"{p}.gamma_1"] = src.pop(f"{q}/gamma_1")
        sd[f"{p}.gamma_2"] = src.pop(f"{q}/gamma_2")
        _linear(sd, src, f"{q}/mlp/fc1", f"{p}.mlp.fc1")
        _linear(sd, src, f"{q}/mlp/fc2", f"{p}.mlp.fc2")


def _text(sd, src, tower: str = "text_encoder") -> None:
    """A BERT stack: the text encoder, or the VQA answer decoder
    (``tower="text_decoder"``)."""
    e, t = f"{tower}/embeddings", f"{tower}.bert.embeddings"
    for n in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        sd[f"{t}.{n}.weight"] = src.pop(f"{e}/{n}/embedding")
    _norm(sd, src, f"{e}/ln", f"{t}.LayerNorm")
    n_layers = 1 + max(int(m.group(1)) for k in src
                       if (m := re.match(rf"{tower}/layer_(\d+)/", k)))
    for i in range(n_layers):
        q, p = f"{tower}/layer_{i}", f"{tower}.bert.encoder.layer.{i}"
        for jax_attn, ref_attn, ln in (("self_attn", "attention", "attn_ln"),
                                       ("cross_attn", "crossattention", "cross_ln")):
            if f"{q}/{jax_attn}/query/kernel" not in src:
                continue
            for proj in ("query", "key", "value"):
                _linear(sd, src, f"{q}/{jax_attn}/{proj}", f"{p}.{ref_attn}.self.{proj}")
            _linear(sd, src, f"{q}/{jax_attn}/out", f"{p}.{ref_attn}.output.dense")
            _norm(sd, src, f"{q}/{ln}", f"{p}.{ref_attn}.output.LayerNorm")
        _linear(sd, src, f"{q}/mlp/fc1", f"{p}.intermediate.dense")
        _linear(sd, src, f"{q}/mlp/fc2", f"{p}.output.dense")
        _norm(sd, src, f"{q}/mlp_ln", f"{p}.output.LayerNorm")


def _heads(sd, src) -> None:
    # the tied LM heads: the MLM head and the VQA answer decoder's
    for head, m in (("mlm_head", "text_encoder.cls.predictions"),
                    ("dec_head", "text_decoder.cls.predictions")):
        if f"{head}/transform_dense/kernel" in src:
            _linear(sd, src, f"{head}/transform_dense", f"{m}.transform.dense")
            _norm(sd, src, f"{head}/transform_ln", f"{m}.transform.LayerNorm")
            sd[f"{m}.bias"] = src.pop(f"{head}/decoder_bias")
    for name in ("vision_proj", "text_proj"):
        if f"{name}/kernel" in src:
            _linear(sd, src, name, name)
    if "temp" in src:
        sd["temp"] = np.asarray(src.pop("temp")).reshape(())
    for head in ("itm_head", "bbox_head", "cls_head"):
        if f"{head}/fc1/kernel" in src:
            _linear(sd, src, f"{head}/fc1", f"{head}.0")
            _norm(sd, src, f"{head}/ln", f"{head}.1")
            _linear(sd, src, f"{head}/fc2", f"{head}.3")


def convert_jax_params(params: Mapping, *, device=None
                       ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """JAX ``XVLMForRetrieval`` / ``XVLMForPretrain`` / ``XVLMForGrounding``
    / ``XVLMForNLVR`` / ``XVLMForVQA`` / ``XVLMBase`` params -> (state dict of the port's
    model under the reference names, on ``device`` (the card unless
    ``device="cpu"``); sorted JAX keys the port does not carry, none for
    these models). The ``params/`` collection and a task head's ``base/``
    scope are dropped, a head the task keeps beside the core (NLVR's
    ``cls_head``; VQA's ``text_decoder`` and ``dec_head``, as
    ``text_decoder.bert.*`` and ``text_decoder.cls.predictions.*``) stays:
    load the result into ``XVLMForRetrieval``, ``XVLMForGrounding``,
    ``XVLMForNLVR`` or ``XVLMForVQA`` itself, or into
    ``XVLMForPretrain.base``."""
    device = resolve_device(device)
    flat = params if all(not isinstance(v, Mapping) for v in params.values()) \
        else flatten_params(params)
    src = _strip_scope(flat)
    sd: Dict[str, np.ndarray] = {}
    _vision(sd, src)
    _text(sd, src)
    if "text_decoder/embeddings/ln/scale" in src:
        _text(sd, src, "text_decoder")
    _heads(sd, src)
    state = {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(device)
             for k, v in sd.items()}
    return state, sorted(src)
