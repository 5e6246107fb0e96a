"""Swin Transformer vision encoder (counterpart of x2vlm_tpu/models/swin.py).

A hierarchical ViT: a 4 x 4 conv patchify with a LayerNorm, stages of
window-attention blocks (every second block on windows shifted by half a
window, with the roll and the additive 0 / -100 region mask), a
``PatchMerging`` downsampling between stages and a final LayerNorm. Output
(B, 1 + (res/32)^2, vision_width): the fp32 mean of the final tokens in
front of them, as the reference's X2-VLM adaptation appends its avgpool
token. A stage whose grid is no larger than the window runs one unshifted
window over it. Stochastic depth runs one linspace over all blocks. With
``remat`` each block is rematerialised under ``remat_policy``
(``ops/remat.py``); the patch merging between stages is not.

The window attention runs the plain ``ops/attention.dot_product_attention``
with the per-head relative-position table bias plus the shift mask, as the
JAX package runs it outside Pallas: the windows stay (B, nW, H, N, D), so
the bias broadcasts over the batch instead of being built per window.

Parameter names are timm's: ``patch_embed.{proj,norm}``,
``layers.{s}.blocks.{b}.{norm1, attn.qkv, attn.proj,
attn.relative_position_bias_table, norm2, mlp.fc1, mlp.fc2}``,
``layers.{s}.downsample.{norm,reduction}``, ``norm``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from x2vlm_tpu_torch.device import resolve_device
from x2vlm_tpu_torch.ops.attention import dot_product_attention
from x2vlm_tpu_torch.ops.layers import (
    DropPath, FusedLayerNorm, Mlp, PatchEmbed, dense, gelu_exact, layer_norm, linear,
)
from x2vlm_tpu_torch.ops.remat import block_call, checkpoint_policy

__all__ = ["SwinConfig", "SwinTransformer", "rel_pos_index", "shift_attn_mask",
           "window_partition", "window_merge"]


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    image_res: int = 224
    patch_size: int = 4
    embed_dim: int = 128
    depths: Tuple[int, ...] = (2, 2, 18, 2)
    num_heads: Tuple[int, ...] = (4, 8, 16, 32)
    window_size: int = 7
    mlp_ratio: float = 4.0
    drop_path_rate: float = 0.1
    ln_eps: float = 1e-5
    remat: bool = False        # rematerialise each block in the backward (ops/remat.py)
    remat_policy: Optional[str] = None  # None / "full" | "dots" | "dots_saveable" | "nothing"

    def __post_init__(self):
        checkpoint_policy(self.remat_policy)

    @property
    def num_layers(self) -> int:
        return len(self.depths)

    @property
    def vision_width(self) -> int:
        return int(self.embed_dim * 2 ** (self.num_layers - 1))


def rel_pos_index(window: int) -> np.ndarray:
    """(w^2, w^2) index into a ((2w - 1)^2, heads) table."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1).astype(np.int64)


def shift_attn_mask(H: int, W: int, window: int, shift: int) -> np.ndarray:
    """(nW, w^2, w^2) additive mask of the shifted windows: 0 within one
    region of the rolled grid, -100 across regions."""
    img_mask = np.zeros((H, W), np.int32)
    cnt = 0
    for h_sl in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for w_sl in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img_mask[h_sl, w_sl] = cnt
            cnt += 1
    wins = img_mask.reshape(H // window, window, W // window, window)
    wins = wins.transpose(0, 2, 1, 3).reshape(-1, window * window)
    diff = wins[:, None, :] != wins[:, :, None]
    return np.where(diff, -100.0, 0.0).astype(np.float32)


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, nW, w^2, C), the windows in row-major order."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // window, window, W // window, window, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, -1, window * window, C)


def window_merge(wins: torch.Tensor, window: int, H: int, W: int) -> torch.Tensor:
    """The inverse of :func:`window_partition`: (B, nW, w^2, C) -> (B, H, W, C)."""
    B = wins.shape[0]
    x = wins.reshape(B, H // window, W // window, window, window, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, -1)


class _Static:
    """Index and mask tensors built once per (key, device), outside
    inference mode: a tensor first built under ``torch.inference_mode``
    (an eval, a request) could not be saved for a later training step's
    backward."""

    def __init__(self, make):
        self.make, self.cache = make, {}

    def get(self, key, device: torch.device) -> torch.Tensor:
        t = self.cache.get((key, device))
        if t is None:
            with torch.inference_mode(False):
                t = self.cache[(key, device)] = torch.from_numpy(self.make(*key)).to(device)
        return t


_REL_INDEX = _Static(rel_pos_index)
_SHIFT_MASK = _Static(shift_attn_mask)


class WindowAttention(nn.Module):
    """``qkv`` (with bias) -> attention within each window, with the
    per-head relative-position bias and the shift mask -> ``proj``."""

    def __init__(self, dim: int, num_heads: int, window: int, *, dtype: torch.dtype, device):
        super().__init__()
        self.num_heads, self.window, self.dtype = num_heads, window, dtype
        self.qkv = linear(dim, 3 * dim, device=device)
        self.proj = linear(dim, dim, device=device)
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((2 * window - 1) ** 2, num_heads, device=device))

    def init_extra(self, generator: torch.Generator, std: float) -> None:
        self.relative_position_bias_table.normal_(0.0, std, generator=generator)

    def forward(self, wins: torch.Tensor, attn_mask: Optional[torch.Tensor]) -> torch.Tensor:
        # wins (B, nW, N, C); attn_mask (nW, N, N) or None
        B, nW, N, C = wins.shape
        H = self.num_heads
        D = C // H
        qkv = dense(wins, self.qkv.weight, self.qkv.bias, self.dtype)
        q, k, v = qkv.reshape(B, nW, N, 3, H, D).permute(3, 0, 1, 4, 2, 5)  # (B, nW, H, N, D)
        idx = _REL_INDEX.get((self.window,), wins.device)
        bias = self.relative_position_bias_table[idx].permute(2, 0, 1)        # (H, N, N)
        if attn_mask is not None:
            bias = bias + attn_mask[:, None]                                  # (nW, H, N, N)
        # the plain core over (B, nW, H, N, D): the bias broadcasts over B
        out = dot_product_attention(q, k, v, bias=bias, scale=D ** -0.5)
        out = out.permute(0, 1, 3, 2, 4).reshape(B, nW, N, C)
        return dense(out, self.proj.weight, self.proj.bias, self.dtype)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, resolution: Tuple[int, int], window: int,
                 shift: int, config: SwinConfig, drop_path: float, *, dtype: torch.dtype,
                 device):
        super().__init__()
        if min(resolution) <= window:   # one window over the whole grid, no shift
            window, shift = min(resolution), 0
        self.resolution, self.window, self.shift, self.dtype = resolution, window, shift, dtype
        self.norm1 = FusedLayerNorm(dim, config.ln_eps, device=device)
        self.attn = WindowAttention(dim, num_heads, window, dtype=dtype, device=device)
        self.drop_path = DropPath(drop_path)
        self.norm2 = FusedLayerNorm(dim, config.ln_eps, device=device)
        self.mlp = Mlp(dim, int(dim * config.mlp_ratio), act=gelu_exact, dtype=dtype,
                       device=device)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        (H, W), window, shift = self.resolution, self.window, self.shift
        B, L, C = x.shape
        h = self.norm1(x).reshape(B, H, W, C)
        mask = None
        if shift:
            h = torch.roll(h, (-shift, -shift), dims=(1, 2))
            mask = _SHIFT_MASK.get((H, W, window, shift), x.device)
        h = window_merge(self.attn(window_partition(h, window), mask), window, H, W)
        if shift:
            h = torch.roll(h, (shift, shift), dims=(1, 2))
        x = x + self.drop_path(h.reshape(B, L, C), generator)
        return x + self.drop_path(self.mlp(self.norm2(x), generator), generator)


class PatchMerging(nn.Module):
    """2 x 2 neighbours concatenated (4C) -> LayerNorm -> ``reduction`` to 2C."""

    def __init__(self, dim: int, eps: float, *, dtype: torch.dtype, device):
        super().__init__()
        self.dtype = dtype
        self.norm = nn.LayerNorm(4 * dim, eps=eps, device=device)
        self.reduction = linear(4 * dim, 2 * dim, bias=False, device=device)

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        B, L, C = x.shape
        x = x.reshape(B, H, W, C)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], dim=-1).reshape(B, (H // 2) * (W // 2), 4 * C)
        x = layer_norm(x, self.norm.weight, self.norm.bias, self.norm.eps).to(self.dtype)
        return dense(x, self.reduction.weight, None, self.dtype)


class SwinPatchEmbed(PatchEmbed):
    """The conv patchify (``proj``) and its LayerNorm (``norm``)."""

    def __init__(self, embed_dim: int, patch_size: int, eps: float, *, dtype: torch.dtype,
                 device):
        super().__init__(embed_dim, patch_size, dtype=dtype, device=device)
        self.norm = FusedLayerNorm(embed_dim, eps, device=device)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        return self.norm(super().forward(pixels))


class SwinStage(nn.Module):
    def __init__(self, blocks, downsample: Optional[PatchMerging]):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample


class SwinTransformer(nn.Module):
    """NHWC pixels -> (B, 1 + (res/32)^2, vision_width): [mean || tokens]."""

    def __init__(self, config: SwinConfig, *, dtype: torch.dtype = torch.bfloat16,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        cfg = self.config = config
        self.dtype = dtype
        self.patch_embed = SwinPatchEmbed(cfg.embed_dim, cfg.patch_size, cfg.ln_eps,
                                          dtype=dtype, device=device)
        dpr = np.linspace(0.0, cfg.drop_path_rate, sum(cfg.depths))
        side = cfg.image_res // cfg.patch_size
        stages, blk = [], 0
        for si, depth in enumerate(cfg.depths):
            dim = int(cfg.embed_dim * 2 ** si)
            blocks = []
            for bi in range(depth):
                shift = 0 if bi % 2 == 0 else cfg.window_size // 2
                blocks.append(SwinBlock(dim, cfg.num_heads[si], (side, side), cfg.window_size,
                                        shift, cfg, float(dpr[blk]), dtype=dtype,
                                        device=device))
                blk += 1
            last = si == cfg.num_layers - 1
            stages.append(SwinStage(blocks, None if last else PatchMerging(
                dim, cfg.ln_eps, dtype=dtype, device=device)))
            side //= 1 if last else 2
        self.layers = nn.ModuleList(stages)
        self.norm = nn.LayerNorm(cfg.vision_width, eps=cfg.ln_eps, device=device)

    def forward(self, pixels: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        cfg = self.config
        x = self.patch_embed(pixels)
        side = cfg.image_res // cfg.patch_size
        if x.shape[1] != side * side:
            raise ValueError(f"input {tuple(pixels.shape)} gives {x.shape[1]} patches, "
                             f"config expects {side * side}")
        for stage in self.layers:
            for block in stage.blocks:
                x = block_call(block, x, remat=cfg.remat, policy=cfg.remat_policy,
                               generator=generator)
            if stage.downsample is not None:
                x = stage.downsample(x, side, side)
                side //= 2
        x = layer_norm(x, self.norm.weight, self.norm.bias, self.norm.eps)
        return torch.cat([x.mean(dim=1, keepdim=True), x], dim=1).to(self.dtype)
