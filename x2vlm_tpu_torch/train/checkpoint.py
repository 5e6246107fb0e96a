"""Checkpoints (the port's counterpart of x2vlm_tpu/train/checkpoint.py):
the reference ``.th`` import and the train state's save / resume.

Import. A released X2-VLM ``.th`` already carries the port's parameter
names (the reference's), so :func:`load_reference_checkpoint` needs no
renaming: it unwraps the file (``model`` / ``module`` / ``state_dict``
containers, ``module.`` prefixes; :func:`load_torch_checkpoint`),
interpolates each BEiT-2 relative-position table to the model's window when
the image resolution differs (:func:`interp_rel_pos_table`, the
reference's geometric-grid bicubic scheme, an own numpy / scipy copy of the
JAX ``_interp_rel_pos_table``), checks shapes and loads with
``load_state_dict(strict=False)``. Keys the model has no place for are
reported as unexpected: the tied MLM decoder (the word-embedding table),
the static relative-position index (rebuilt from the window) and, in a
retrieval model, the MLM and bbox heads (its JAX counterpart has neither:
flax creates a head's parameters only where the task calls it), and in a
grounding or NLVR2 model whatever of the projections, ``temp`` and the
ITM, MLM and bbox heads it does not carry. The bbox head
``bbox_head.{0,1,3}`` loads into a pretraining and a grounding model, a
fine-tuned ``cls_head.{0,1,3}`` into an NLVR2 or a classification model, and
a stage-2 video file's ``absolute_frame_pos_embed`` into a video model of
any frame count (:func:`load_converted`).
Parameters the file lacks stay fresh (NLVR2's ``cls_head`` from a
pretraining file); their names (inside the composition core) are
returned for the optimizer's ``lr_mult`` group, and :func:`import_report`
names the subtrees left wholly fresh, as the JAX launcher's
``_import_report`` does.

Published backbones (own copies of the JAX package's converters, returning
the port's reference-named state dict instead of a flax tree):
:func:`convert_beit2_checkpoint` (a raw BEiT-2 file, its shared
``rel_pos_bias`` table expanded to every block),
:func:`convert_clip_vit_checkpoint` (HF CLIP, ``vision_model.`` /
``embeddings.`` stripped; a 2N-layer file into N layers takes layers 2i +
1), :func:`convert_swin_checkpoint` (timm Swin, each window table resized
to the model's window by :func:`resize_swin_rel_pos_table`) and
:func:`convert_hf_bert_checkpoint` (HF BERT, 12 layers expanded to the
model's 18 with the upper six copied into the fusion slots; HF RoBERTa /
XLM-R, ``roberta.*`` and ``lm_head.*``, under the xroberta names);
:func:`convert_checkpoint_auto` picks one by the file's key flavour, and
:func:`load_reference_checkpoint` goes through it, so a whole X2-VLM file's
CLIP or Swin tower is converted by its own flavour too. A Plus / CCLM file's
cross encoder loads under ``cross_encoder.encoder.layer.{j}`` (its
``cross_encoder.bert.`` form too), and an MLM head loads into the model's
own form of it (``cls.predictions.transform.*`` <-> ``lm_head.{dense,
layer_norm}``, as the JAX converter reads both into one ``mlm_head``); a
fine-tuned VQA file's answer decoder likewise (``text_decoder.bert.`` <->
``text_decoder.roberta.``, its head's ``cls.predictions.transform.*`` or
``lm_head.transform.*`` <-> ``lm_head.{dense, layer_norm}``), and a
fine-tuned ``cls_head`` on either base.
:func:`split_imported_to_plus` is the Base -> Plus surgery of an
X2-VLM file for a Plus model (``is_xvlm_ckpt``).

Train state. :func:`save_train_state` writes the parameters, AdamW's
``mu`` / ``nu`` / ``count``, the step and the data cursors with
``torch.save`` to a temporary file renamed over ``train_state.pt``, so a
crash leaves the previous state whole; :func:`restore_train_state` puts
them back bit for bit.
"""

from __future__ import annotations

import collections
import io
import math
import os
import re
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from x2vlm_tpu_torch.core import mesh
from x2vlm_tpu_torch.core.io import hopen, is_remote

__all__ = ["load_torch_checkpoint", "interp_rel_pos_table", "resize_swin_rel_pos_table",
           "convert_beit2_checkpoint", "convert_clip_vit_checkpoint", "convert_swin_checkpoint",
           "convert_hf_bert_checkpoint", "convert_checkpoint_auto", "load_reference_checkpoint",
           "load_converted", "import_report", "split_imported_to_plus", "save_train_state",
           "restore_train_state", "TRAIN_STATE_FILE"]

TRAIN_STATE_FILE = "train_state.pt"


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A ``.th`` / ``.pth`` file's state dict on the CPU: the
    ``{'model': ...}`` / ``{'module': ...}`` / ``{'state_dict': ...}``
    container unwrapped and ``module.`` prefixes dropped. A remote
    (``hdfs://``, ``gs://``) path streams through ``hopen``'s pipe into
    memory first (reference utils/torch_io.py:14-23)."""
    if is_remote(path):
        with hopen(path, "rb") as reader:
            f = io.BytesIO(reader.read())
    else:
        f = path
    ckpt = torch.load(f, map_location="cpu", weights_only=False)
    for key in ("model", "module", "state_dict"):
        if isinstance(ckpt, dict) and key in ckpt and isinstance(ckpt[key], dict):
            ckpt = ckpt[key]
            break
    return {k.replace("module.", ""): v for k, v in ckpt.items() if torch.is_tensor(v)}


def interp_rel_pos_table(table: np.ndarray, src_window: int, dst_window: int) -> np.ndarray:
    """A BEiT relative-position bias table resized from a (2 sw - 1)^2 grid
    to a (2 dw - 1)^2 grid, the 3 cls rows kept: the source offsets lie on a
    geometric-progression grid whose ratio is bisected so the grid spans the
    target half-width, then each head is interpolated bicubically onto the
    integer target lattice (reference beit2.py:473-604, the JAX
    ``_interp_rel_pos_table``)."""
    from scipy.interpolate import RectBivariateSpline

    src = 2 * src_window - 1
    dst = 2 * dst_window - 1
    n_extra = 3
    heads = table.shape[1]
    body = table[:-n_extra]

    def geometric_progression(a, r, n):
        return a * (1.0 - r ** n) / (1.0 - r)

    left, right = 1.01, 1.5
    while right - left > 1e-6:
        q = (left + right) / 2.0
        if geometric_progression(1, q, src // 2) > dst // 2:
            right = q
        else:
            left = q
    dis = []
    cur = 1.0
    for i in range(src // 2):
        dis.append(cur)
        cur += q ** (i + 1)
    x = np.asarray([-v for v in reversed(dis)] + [0] + dis, np.float64)
    t = dst // 2.0
    dx = np.arange(-t, t + 0.1, 1.0)
    out = np.empty((dst * dst, heads), body.dtype)
    k = min(3, len(x) - 1)   # tiny windows cannot carry a full cubic
    for h in range(heads):
        z = body[:, h].reshape(src, src).astype(np.float64)
        spl = RectBivariateSpline(x, x, z, kx=k, ky=k, s=0)
        out[:, h] = spl(dx, dx).reshape(-1)
    return np.concatenate([out, table[-n_extra:]], axis=0)


def _core(model: nn.Module) -> nn.Module:
    """The composition core that carries the reference names:
    ``XVLMForPretrain`` holds it under ``base``; the retrieval, grounding and
    NLVR2 models are it, their heads beside its modules."""
    return model.base if hasattr(model, "base") else model


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel, a = -0.5."""
    x = np.abs(x)
    near = ((1.5 * x - 2.5) * x) * x + 1.0
    far = ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0
    return np.where(x >= 2.0, 0.0, np.where(x >= 1.0, far, near))


def _cubic_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) weights of a 1-D cubic resize with half-pixel centres,
    the kernel widened by n_in / n_out when shrinking (antialiased), each
    column normalised to sum 1: the rule of ``jax.image.resize(...,
    "cubic")``, in float64."""
    inv_scale = n_in / n_out
    sample = (np.arange(n_out) + 0.5) * inv_scale - 0.5
    w = _keys_cubic((sample[None, :] - np.arange(n_in)[:, None]) / max(inv_scale, 1.0))
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1.0), 0.0)
    return np.where(((sample >= -0.5) & (sample <= n_in - 0.5))[None, :], w, 0.0)


def resize_swin_rel_pos_table(table: np.ndarray, dst_window: int) -> np.ndarray:
    """A Swin relative-position table ((2 sw - 1)^2, heads) resized to
    ((2 dw - 1)^2, heads) on its square lattice (Swin tables have no cls
    rows), as the JAX ``_interp_swin_rel_pos_table`` resizes it (which
    computes in fp32: its result is within ~1e-6 of the table's scale of
    this float64 one). Keys' cubic (a = -0.5), not ``F.interpolate``'s
    bicubic (a = -0.75)."""
    rows, heads = table.shape
    src, dst = math.isqrt(rows), 2 * dst_window - 1
    if src == dst:
        return table
    w = _cubic_weights(src, dst)
    body = table.reshape(src, src, heads).astype(np.float64)
    out = np.einsum("ih,jw,ijc->hwc", w, w, body)
    return out.reshape(dst * dst, heads).astype(table.dtype)


def _tensors(sd: Mapping) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v)) if not torch.is_tensor(v) else v
            for k, v in sd.items()}


def convert_beit2_checkpoint(sd: Mapping, *, depth: int, dst_window: Optional[int] = None
                             ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """A raw BEiT-2 file (``blocks.{i}...``, maybe a shared
    ``rel_pos_bias.relative_position_bias_table``) -> (the vision tower's
    state under ``vision_encoder.``, unused keys): the shared table copied
    to every block, each table interpolated to ``dst_window``, the
    classifier head dropped."""
    sd = _tensors(sd)
    sd.pop("head.weight", None)
    sd.pop("head.bias", None)
    shared = sd.pop("rel_pos_bias.relative_position_bias_table", None)
    if shared is not None:
        for i in range(depth):
            sd.setdefault(f"blocks.{i}.attn.relative_position_bias_table", shared.clone())
    out, unused = {}, []
    for k, v in sd.items():
        m = re.match(r"blocks\.(\d+)\.", k)
        if k.endswith("relative_position_index") or (m and int(m.group(1)) >= depth):
            unused.append(k)
            continue
        if k.endswith("relative_position_bias_table") and dst_window is not None:
            src = int((math.sqrt(v.shape[0] - 3) + 1) / 2)
            if src != dst_window:
                v = torch.from_numpy(interp_rel_pos_table(v.float().numpy(), src, dst_window))
        out["vision_encoder." + k] = v
    return out, sorted(unused)


def convert_clip_vit_checkpoint(sd: Mapping, *, depth: int
                                ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """An OpenAI CLIP vision tower (HF names, raw ``vision_model.`` or
    stripped) -> (the CLIP tower's state under ``vision_encoder.``, unused
    keys). ``depth`` is the model's: a checkpoint of 2 x depth layers loads
    every other layer from 1 (the reference's {1: 0, 3: 1, ...})."""
    norm = {}
    for k, v in _tensors(sd).items():
        if k.startswith("vision_model."):
            k = k[len("vision_model."):]
        if k.startswith("embeddings."):
            k = k[len("embeddings."):]
        k = k.replace("patch_embedding.weight", "patch_embed.weight")
        k = k.replace("position_embedding.weight", "pos_embed.weight")
        k = k.replace("pre_layernorm.", "pre_layrnorm.")
        if k != "position_ids":
            norm[k] = v
    n_src = 1 + max((int(m.group(1)) for k in norm
                     if (m := re.match(r"encoder\.layers\.(\d+)\.", k))), default=-1)
    if n_src in (0, depth):
        src_of = {i: i for i in range(depth)}
    elif n_src == 2 * depth:
        src_of = {2 * i + 1: i for i in range(depth)}
    else:
        raise ValueError(f"CLIP layer-count mismatch: checkpoint has {n_src}, model wants "
                         f"{depth} (only N -> N and 2N -> N every-other init are defined)")
    out, unused = {}, []
    for k, v in norm.items():
        m = re.match(r"encoder\.layers\.(\d+)\.(.*)", k)
        if m:
            i = int(m.group(1))
            if i not in src_of:
                unused.append(k)
                continue
            k = f"encoder.layers.{src_of[i]}.{m.group(2)}"
        elif k == "class_embedding":
            v = v.reshape(-1)
        out["vision_encoder." + k] = v
    return out, sorted(unused)


def convert_swin_checkpoint(sd: Mapping, *, depths: tuple, dst_window: Optional[int] = None
                            ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """A timm Swin file (``layers.{s}.blocks.{b}...``) -> (the Swin tower's
    state under ``vision_encoder.``, unused keys), each block's
    ``relative_position_bias_table`` resized to ``dst_window``
    (:func:`resize_swin_rel_pos_table`); the static index, shift masks and
    classifier head are dropped."""
    out, unused = {}, []
    for k, v in _tensors(sd).items():
        if "attn_mask" in k or "relative_position_index" in k or k.startswith("head."):
            continue
        m = re.match(r"layers\.(\d+)\.blocks\.(\d+)\.", k)
        if m and (int(m.group(1)) >= len(depths) or int(m.group(2)) >= depths[int(m.group(1))]):
            unused.append(k)
            continue
        if k.endswith("relative_position_bias_table") and dst_window is not None:
            v = torch.from_numpy(resize_swin_rel_pos_table(v.float().numpy(), dst_window))
        out["vision_encoder." + k] = v
    return out, sorted(unused)


def _expand_text_layers(sd: Dict[str, torch.Tensor], prefix: str, from_layers: int,
                        to_layers: int) -> Dict[str, torch.Tensor]:
    """12 -> N layers: the upper ``N - 12`` copied into the new slots
    (layers 6-11 -> 12-17 for 18); or 2N -> N, every other layer from 1."""
    pat = re.compile(re.escape(prefix) + r"(\d+)\.(.*)")
    out = {k: v for k, v in sd.items() if not pat.match(k)}
    layers = {}
    for k, v in sd.items():
        if (m := pat.match(k)):
            layers.setdefault(int(m.group(1)), {})[m.group(2)] = v
    if to_layers >= from_layers:
        src_of = {i: i for i in range(from_layers)}
        src_of.update({from_layers + j: from_layers - (to_layers - from_layers) + j
                       for j in range(to_layers - from_layers)})
    elif from_layers == 2 * to_layers:
        src_of = {j: 2 * j + 1 for j in range(to_layers)}
    else:
        raise ValueError(f"text layers {from_layers} -> {to_layers}: only expansion and "
                         f"every-other subsampling are defined")
    for dst, src in src_of.items():
        for rest, v in layers[src].items():
            out[f"{prefix}{dst}.{rest}"] = v.clone() if dst != src else v
    return out


def convert_hf_bert_checkpoint(sd: Mapping, *, to_layers: Optional[int] = None,
                               fusion_layer: int = 12
                               ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """A raw HF BERT file (``bert.*`` / ``cls.*``, or ``embeddings.*`` /
    ``encoder.*``) -> (the text encoder's state under ``text_encoder.``,
    unused keys), its layers expanded to ``to_layers``; the cross-attention
    stays fresh. An HF RoBERTa / XLM-R file (``roberta.*``, ``lm_head.*``)
    -> ``text_encoder.roberta.*`` and ``text_encoder.lm_head.{dense,
    layer_norm, bias, decoder}`` (the bias from ``lm_head.bias``, else
    ``lm_head.decoder.bias``, as the JAX converter takes it)."""
    sd = _tensors(sd)
    roberta = any(k.startswith(("roberta.", "lm_head.")) for k in sd)
    stack = "roberta" if roberta else "bert"
    out, unused = {}, []
    for k, v in sd.items():
        if k.startswith(("bert.", "cls.", "roberta.")):
            out["text_encoder." + k] = v
        elif k.startswith("lm_head."):
            if k not in ("lm_head.bias", "lm_head.decoder.bias"):
                out["text_encoder." + k] = v
        elif k.startswith(("embeddings.", "encoder.")):
            out[f"text_encoder.{stack}." + k] = v
        else:
            unused.append(k)
    bias = sd.get("lm_head.bias", sd.get("lm_head.decoder.bias"))
    if bias is not None:
        out["text_encoder.lm_head.bias"] = bias
        out["text_encoder.lm_head.decoder.bias"] = bias
    prefix = f"text_encoder.{stack}.encoder.layer."
    from_layers = 1 + max((int(m.group(1)) for k in out
                           if (m := re.match(re.escape(prefix) + r"(\d+)\.", k))),
                          default=-1)
    if to_layers is not None and from_layers > 0:
        out = _expand_text_layers(out, prefix, from_layers, to_layers)
    return out, sorted(unused)


def split_imported_to_plus(state: Mapping[str, torch.Tensor], *,
                           xvlm_text_layers: Optional[int] = None,
                           replace_text_encoder: bool = False) -> Dict[str, torch.Tensor]:
    """Base -> Plus surgery on an imported X2-VLM state (the JAX
    ``split_imported_to_plus``): the fused text stack splits into
    text[0:T] / cross_encoder[T:] (``T`` the config's
    ``xvlm_ckpt_text_num_hidden_layers``, 12 when unset). With
    ``replace_text_encoder`` (CCLM: a fresh XLM-R takes the text tower's
    place) the text tower is dropped and the MLM head keeps only its
    vocabulary-independent transform (the reference deletes
    cls.predictions.decoder / bias, xvlm.py:1105-1115)."""
    from x2vlm_tpu_torch.models.xvlm_plus import split_params_to_plus

    n_layers = 1 + max((int(m.group(1)) for k in state
                        if (m := re.match(r"text_encoder\.bert\.encoder\.layer\.(\d+)\.", k))),
                       default=-1)
    out = split_params_to_plus(state, fusion_layer=12 if xvlm_text_layers is None
                               else xvlm_text_layers, num_layers=n_layers,
                               replace_text_encoder=replace_text_encoder)
    if replace_text_encoder:
        out = {k: v for k, v in out.items()
               if not re.match(r"text_encoder\.(cls\.predictions|lm_head)\.(bias|decoder\.)", k)}
    return out


def _is_clip(keys) -> bool:
    return any(k.startswith(("vision_model.", "encoder.layers.")) or
               k.endswith("class_embedding") for k in keys)


def _is_swin(keys) -> bool:
    return any(re.match(r"layers\.\d+\.blocks\.", k) for k in keys)


def _convert_vision_by_flavour(sd: Dict[str, torch.Tensor], vision_cfg
                               ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """A whole X2-VLM file: its ``vision_encoder.*`` keys through the
    converter of their tower's flavour (CLIP: the layer map; Swin: the
    window resize); BEiT-2 keys as they are."""
    vis = {k[len("vision_encoder."):]: v for k, v in sd.items()
           if k.startswith("vision_encoder.")}
    rest = {k: v for k, v in sd.items() if not k.startswith("vision_encoder.")}
    if _is_clip(vis):
        n_src = 1 + max((int(m.group(1)) for k in vis
                         if (m := re.match(r"encoder\.layers\.(\d+)\.", k))), default=-1)
        conv, unused = convert_clip_vit_checkpoint(
            vis, depth=getattr(vision_cfg, "depth", None) or n_src)
    elif _is_swin(vis):
        stage = collections.Counter()
        for k in vis:
            if (m := re.match(r"layers\.(\d+)\.blocks\.(\d+)\.", k)):
                stage[int(m.group(1))] = max(stage[int(m.group(1))], int(m.group(2)) + 1)
        conv, unused = convert_swin_checkpoint(
            vis, depths=tuple(stage[s] for s in sorted(stage)),
            dst_window=getattr(vision_cfg, "window_size", None))
    else:
        return sd, []
    return dict(rest, **conv), ["vision_encoder." + k for k in unused]


def convert_checkpoint_auto(sd: Mapping, *, vision_cfg=None, text_layers: Optional[int] = None,
                            text_fusion_layer: int = 12
                            ) -> Tuple[Dict[str, torch.Tensor], List[str], str]:
    """A state dict's flavour sniffed and converted to the port's reference
    names -> (state, unused keys, kind): ``"xvlm"`` (a whole X2-VLM file:
    ``vision_encoder.*`` / ``text_encoder.*``, its vision keys by their own
    flavour), ``"clip"`` (HF CLIP vision tower), ``"swin"`` (timm Swin),
    ``"beit2"`` (raw BEiT-2) or ``"bert"`` (HF BERT or RoBERTa / XLM-R)."""
    sd = _tensors(sd)
    keys = list(sd)
    window = getattr(vision_cfg, "window", None)
    if any(k.startswith(("vision_encoder.", "text_encoder.")) for k in keys):
        state, unused = _convert_vision_by_flavour(sd, vision_cfg)
        return state, unused, "xvlm"
    if _is_clip(keys):
        return (*convert_clip_vit_checkpoint(sd, depth=getattr(vision_cfg, "depth", 12)),
                "clip")
    if _is_swin(keys):
        return (*convert_swin_checkpoint(
            sd, depths=getattr(vision_cfg, "depths", (2, 2, 18, 2)),
            dst_window=getattr(vision_cfg, "window_size", None)), "swin")
    if any(re.match(r"blocks\.\d+\.", k) for k in keys) or \
            "rel_pos_bias.relative_position_bias_table" in sd:
        return (*convert_beit2_checkpoint(sd, depth=getattr(vision_cfg, "depth", 12),
                                          dst_window=window[0] if window else None), "beit2")
    if any(k.startswith(("bert.", "roberta.", "lm_head.", "encoder.layer.",
                         "embeddings.word_embeddings")) for k in keys):
        return (*convert_hf_bert_checkpoint(sd, to_layers=text_layers,
                                            fusion_layer=text_fusion_layer), "bert")
    raise ValueError("unrecognized checkpoint flavour; expected an X2-VLM .th, a raw CLIP / "
                     "Swin / BEiT-2 vision tower, or an HF BERT / XLM-R state dict (first keys: "
                     f"{sorted(sd)[:5]})")


# the MLM head's two forms of the reference names: BERT's, XLM-R's
_HEAD_NAMES = (("text_encoder.cls.predictions.transform.dense.", "text_encoder.lm_head.dense."),
               ("text_encoder.cls.predictions.transform.LayerNorm.",
                "text_encoder.lm_head.layer_norm."),
               ("text_encoder.cls.predictions.bias", "text_encoder.lm_head.bias"),
               ("text_encoder.cls.predictions.decoder.", "text_encoder.lm_head.decoder."),
               ("text_encoder.lm_head.transform.dense.", "text_encoder.lm_head.dense."),
               ("text_encoder.lm_head.transform.LayerNorm.", "text_encoder.lm_head.layer_norm."),
               ("cross_encoder.bert.encoder.layer.", "cross_encoder.encoder.layer."),
               # the answer decoder's, as the JAX import reads them: its stack
               # under either form's name, its head's transform under
               # ``cls.predictions`` or ``lm_head``
               ("text_decoder.bert.", "text_decoder.roberta."),
               ("text_decoder.cls.predictions.transform.dense.", "text_decoder.lm_head.dense."),
               ("text_decoder.cls.predictions.transform.LayerNorm.",
                "text_decoder.lm_head.layer_norm."),
               ("text_decoder.cls.predictions.bias", "text_decoder.lm_head.bias"),
               ("text_decoder.lm_head.transform.dense.", "text_decoder.lm_head.dense."),
               ("text_decoder.lm_head.transform.LayerNorm.", "text_decoder.lm_head.layer_norm."))


def _own_names(sd: Mapping[str, torch.Tensor], own) -> Dict[str, torch.Tensor]:
    """``sd`` with its MLM head under the form the model has (a Base file's
    BERT head into an XLM-R Plus model, and back), a Plus file's
    ``cross_encoder.bert.`` layers under the model's name, and the VQA
    answer decoder's stack and head under the model's form."""
    out = {}
    for k, v in sd.items():
        if k not in own:
            for a, b in _HEAD_NAMES:
                for src, dst in ((a, b), (b, a)):
                    if k.startswith(src) and (dst + k[len(src):]) in own:
                        k = dst + k[len(src):]
                        break
        out[k] = v
    return out


def load_converted(model: nn.Module, sd: Mapping[str, torch.Tensor]
                   ) -> Tuple[List[str], List[str]]:
    """Load a reference-named state dict into ``model``'s composition core
    (``strict=False``), each BEiT-2 relative-position table interpolated to
    the model's window when its grid differs, and the video frame positions
    ``absolute_frame_pos_embed`` of another frame count merged (the first
    min(frame_len) frames from the file, the others left as they were; the
    parameter counts as loaded, as in the JAX merge). Returns (missing,
    unexpected) as :func:`load_reference_checkpoint`; raises on any other
    shape mismatch."""
    core = _core(model)
    own = core.state_dict()
    load, unexpected = {}, []
    for k, v in _own_names(sd, own).items():
        if k not in own:
            unexpected.append(k)
            continue
        if re.match(r"vision_encoder\.blocks\.\d+\.attn\.relative_position_bias_table$", k) \
                and v.shape != own[k].shape:
            src = int(round((np.sqrt(v.shape[0] - 3) + 1) / 2))
            dst = int(round((np.sqrt(own[k].shape[0] - 3) + 1) / 2))
            v = torch.from_numpy(interp_rel_pos_table(v.float().numpy(), src, dst))
        if k == "absolute_frame_pos_embed" and v.dim() == own[k].dim() == 4 and \
                v.shape[0] == own[k].shape[0] and v.shape[2:] == own[k].shape[2:]:
            # another frame count: the first min(frame_len) frames load, the
            # rest keep their fresh values (reference xvlm.py:603-607)
            n = min(v.shape[1], own[k].shape[1])
            v = torch.cat([v[:, :n].to(own[k]), own[k][:, n:]], dim=1)
        if v.shape != own[k].shape:
            raise ValueError(f"shape mismatch at {k}: checkpoint {tuple(v.shape)}, "
                             f"model {tuple(own[k].shape)}")
        load[k] = v
    core.load_state_dict(load, strict=False)
    names = {n for n, _ in core.named_parameters()}
    missing = sorted(n for n in names if n not in load)
    return missing, sorted(unexpected)


def load_reference_checkpoint(model: nn.Module, path_or_state) -> Tuple[List[str], List[str]]:
    """Load a checkpoint (a path or its state dict) into ``model``: a whole
    X2-VLM ``.th`` or a published backbone, by its flavour
    (:func:`convert_checkpoint_auto`). Returns (missing, unexpected): the
    core's parameter names the file did not fill (left as initialised),
    and the file's keys the model has no place for. Raises on a shape
    mismatch the window interpolation does not explain."""
    sd = (load_torch_checkpoint(path_or_state) if isinstance(path_or_state, str)
          else dict(path_or_state))
    cfg = _core(model).config
    state, unused, _ = convert_checkpoint_auto(
        sd, vision_cfg=cfg.vision, text_layers=cfg.text.num_layers,
        text_fusion_layer=cfg.text.fusion_layer)
    missing, unexpected = load_converted(model, state)
    return missing, sorted(unexpected + unused)


def import_report(model: nn.Module, missing: List[str], unexpected: List[str],
                  source: str) -> str:
    """The per-subtree import summary (the JAX launcher's ``_import_report``):
    the unexpected keys, the missing (fresh) parameters and the top-level
    subtrees left wholly fresh."""
    core = _core(model)
    per_tree = collections.Counter(n.split(".")[0] for n in missing)
    total = collections.Counter(n.split(".")[0] for n, _ in core.named_parameters())
    fresh = sorted(k for k, n in per_tree.items() if n >= total[k])
    lines = [f"### imported {source}: {len(unexpected)} unexpected keys, {len(missing)} "
             f"missing (fresh) params" + (f"; fully-fresh subtrees: {fresh}" if fresh else "")]
    lines += [f"###   {k}: {per_tree[k]} fresh leaves" for k in sorted(per_tree)
              if k not in fresh]
    return "\n".join(lines)


def save_train_state(ckpt_dir: str, model: nn.Module, optimizer, step: int,
                     data_state: Optional[Dict] = None) -> str:
    """Write the train state to ``ckpt_dir/train_state.pt`` (a temporary
    file renamed into place). Returns the path. Every rank calls it: the
    moments of an ``--fsdp`` split are gathered whole first, the main
    process alone writes, and every rank waits at a barrier until the file
    is in place."""
    mu, nu = optimizer.full_moments()
    path = os.path.join(ckpt_dir, TRAIN_STATE_FILE)
    if mesh.is_main_process():
        params = {n: p.detach().cpu() for n, p in model.named_parameters()}
        state = {"params": params,
                 "mu": {n: m.detach().cpu() for n, m in zip(optimizer.names, mu)},
                 "nu": {n: v.detach().cpu() for n, v in zip(optimizer.names, nu)},
                 "count": int(optimizer.count), "step": int(step),
                 "data_state": data_state or {}}
        os.makedirs(ckpt_dir, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(state, tmp)
        os.replace(tmp, path)
    mesh.barrier()
    return path


@torch.no_grad()
def restore_train_state(ckpt_dir: str, model: nn.Module, optimizer
                        ) -> Tuple[Optional[int], Dict]:
    """Put the saved train state back into ``model`` and ``optimizer`` in
    place, on every rank (an ``--fsdp`` split takes its slices of the
    whole moments, so a state loads at any world size). Returns (step,
    data_state), or (None, {}) when ``ckpt_dir`` holds none."""
    path = os.path.join(ckpt_dir, TRAIN_STATE_FILE)
    if not os.path.isfile(path):
        return None, {}
    state = torch.load(path, map_location="cpu", weights_only=False)
    params = dict(model.named_parameters())
    if set(state["params"]) != set(params):
        raise ValueError(f"{path}: its parameters do not match the model's "
                         f"({len(set(state['params']) ^ set(params))} names differ)")
    for n, t in state["params"].items():
        params[n].copy_(t)
    optimizer.load_moments(state["mu"], state["nu"])
    optimizer.count = int(state["count"])
    return int(state["step"]), dict(state.get("data_state") or {})
