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
``bbox_head.{0,1,3}`` loads into a pretraining and a grounding model.
Parameters the file lacks stay fresh (NLVR2's ``cls_head`` from a
pretraining file); their names (inside the composition core) are
returned for the optimizer's ``lr_mult`` group, and :func:`import_report`
names the subtrees left wholly fresh, as the JAX launcher's
``_import_report`` does. The CLIP / Swin / HF-BERT converters and the
Base -> Plus split come with ROADMAP items A7 and A8.

Train state. :func:`save_train_state` writes the parameters, AdamW's
``mu`` / ``nu`` / ``count``, the step and the data cursors with
``torch.save`` to a temporary file renamed over ``train_state.pt``, so a
crash leaves the previous state whole; :func:`restore_train_state` puts
them back bit for bit.
"""

from __future__ import annotations

import collections
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from x2vlm_tpu_torch.core.io import hopen

__all__ = ["load_torch_checkpoint", "interp_rel_pos_table", "load_reference_checkpoint",
           "import_report", "save_train_state", "restore_train_state", "TRAIN_STATE_FILE"]

TRAIN_STATE_FILE = "train_state.pt"


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A ``.th`` / ``.pth`` file's state dict on the CPU: the
    ``{'model': ...}`` / ``{'module': ...}`` / ``{'state_dict': ...}``
    container unwrapped and ``module.`` prefixes dropped."""
    with hopen(path, "rb") as f:
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


def load_reference_checkpoint(model: nn.Module, path_or_state) -> Tuple[List[str], List[str]]:
    """Load a reference ``.th`` (a path or its state dict) into ``model``.
    Returns (missing, unexpected): the core's parameter names the file did
    not fill (left as initialised), and the file's keys the model has no
    place for. Raises on a shape mismatch the window interpolation does not
    explain."""
    sd = (load_torch_checkpoint(path_or_state) if isinstance(path_or_state, str)
          else dict(path_or_state))
    core = _core(model)
    own = core.state_dict()
    load, unexpected = {}, []
    for k, v in sd.items():
        if k not in own:
            unexpected.append(k)
            continue
        if k.endswith("relative_position_bias_table") and v.shape != own[k].shape:
            src = int(round((np.sqrt(v.shape[0] - 3) + 1) / 2))
            dst = int(round((np.sqrt(own[k].shape[0] - 3) + 1) / 2))
            v = torch.from_numpy(interp_rel_pos_table(v.float().numpy(), src, dst))
        if v.shape != own[k].shape:
            raise ValueError(f"shape mismatch at {k}: checkpoint {tuple(v.shape)}, "
                             f"model {tuple(own[k].shape)}")
        load[k] = v
    core.load_state_dict(load, strict=False)
    names = {n for n, _ in core.named_parameters()}
    missing = sorted(n for n in names if n not in load)
    return missing, sorted(unexpected)


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
    file renamed into place). Returns the path."""
    params = {n: p.detach().cpu() for n, p in model.named_parameters()}
    state = {"params": params,
             "mu": {n: m.detach().cpu() for n, m in zip(optimizer.names, optimizer.mu)},
             "nu": {n: v.detach().cpu() for n, v in zip(optimizer.names, optimizer.nu)},
             "count": int(optimizer.count), "step": int(step),
             "data_state": data_state or {}}
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, TRAIN_STATE_FILE)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


@torch.no_grad()
def restore_train_state(ckpt_dir: str, model: nn.Module, optimizer
                        ) -> Tuple[Optional[int], Dict]:
    """Put the saved train state back into ``model`` and ``optimizer`` in
    place. Returns (step, data_state), or (None, {}) when ``ckpt_dir`` holds
    none."""
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
    for dst, key in ((optimizer.mu, "mu"), (optimizer.nu, "nu")):
        for n, buf in zip(optimizer.names, dst):
            buf.copy_(state[key][n])
    optimizer.count = int(state["count"])
    return int(state["step"]), dict(state.get("data_state") or {})
