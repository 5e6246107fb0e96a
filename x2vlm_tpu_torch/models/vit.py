"""Plain (DeiT-style) Vision Transformer (counterpart of
x2vlm_tpu/models/vit.py). No shipped config selects it; it completes the
family of vision towers for checkpoints of the older X-VLM.

A conv patchify, a CLS token and learned absolute position embeddings,
pre-LN blocks with stochastic depth, a final LayerNorm. Output
(B, num_patches + 1, C), token 0 the CLS token. With ``remat`` each block is
rematerialised under ``remat_policy`` (``ops/remat.py``).

Parameter names are timm's: ``patch_embed.proj``, ``cls_token``,
``pos_embed``, ``blocks.N.{norm1, attn.qkv, attn.proj, norm2, mlp.fc1,
mlp.fc2}``, ``norm``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from x2vlm_tpu_torch.device import resolve_device
from x2vlm_tpu_torch.ops.layers import (
    ACTIVATIONS, DropPath, FusedLayerNorm, Mlp, MultiHeadAttention, PatchEmbed, dropout,
)
from x2vlm_tpu_torch.ops.remat import block_call, checkpoint_policy

__all__ = ["ViTConfig", "ViT"]


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_res: int = 224
    patch_size: int = 16
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    drop_path_rate: float = 0.0
    dropout_rate: float = 0.0
    attn_dropout_rate: float = 0.0
    ln_eps: float = 1e-6
    act: str = "gelu"
    remat: bool = False        # rematerialise each block in the backward (ops/remat.py)
    remat_policy: Optional[str] = None  # None / "full" | "dots" | "dots_saveable" | "nothing"

    def __post_init__(self):
        checkpoint_policy(self.remat_policy)

    @property
    def num_patches(self) -> int:
        return (self.image_res // self.patch_size) ** 2


class ViTBlock(nn.Module):
    def __init__(self, config: ViTConfig, drop_path: float, *, dtype: torch.dtype, device):
        super().__init__()
        cfg = config
        self.norm1 = FusedLayerNorm(cfg.embed_dim, cfg.ln_eps, device=device)
        self.attn = MultiHeadAttention(
            cfg.embed_dim, cfg.num_heads, qkv_bias_mode="fused", out_proj=True,
            attn_dropout_rate=cfg.attn_dropout_rate, proj_dropout_rate=cfg.dropout_rate,
            dtype=dtype, device=device)
        self.drop_path = DropPath(drop_path)
        self.norm2 = FusedLayerNorm(cfg.embed_dim, cfg.ln_eps, device=device)
        self.mlp = Mlp(cfg.embed_dim, int(cfg.embed_dim * cfg.mlp_ratio),
                       act=ACTIVATIONS[cfg.act], dropout_rate=cfg.dropout_rate, dtype=dtype,
                       device=device)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        x = x + self.drop_path(self.attn(self.norm1(x), generator=generator), generator)
        return x + self.drop_path(self.mlp(self.norm2(x), generator), generator)


class ViT(nn.Module):
    """NHWC pixels -> (B, num_patches + 1, C): [CLS || patch tokens]."""

    def __init__(self, config: ViTConfig, *, dtype: torch.dtype = torch.bfloat16,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        cfg = self.config = config
        self.dtype = dtype
        self.patch_embed = PatchEmbed(cfg.embed_dim, cfg.patch_size, dtype=dtype,
                                      device=device)
        self.cls_token = nn.Parameter(torch.empty(1, 1, cfg.embed_dim, device=device))
        self.pos_embed = nn.Parameter(torch.empty(1, cfg.num_patches + 1, cfg.embed_dim,
                                                  device=device))
        dpr = np.linspace(0.0, cfg.drop_path_rate, cfg.depth)
        self.blocks = nn.ModuleList(ViTBlock(cfg, float(dpr[i]), dtype=dtype, device=device)
                                    for i in range(cfg.depth))
        self.norm = FusedLayerNorm(cfg.embed_dim, cfg.ln_eps, device=device)

    def init_extra(self, generator: torch.Generator, std: float) -> None:
        self.cls_token.normal_(0.0, std, generator=generator)
        self.pos_embed.normal_(0.0, std, generator=generator)

    def forward(self, pixels: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        cfg = self.config
        x = self.patch_embed(pixels)
        B, S, C = x.shape
        if S != cfg.num_patches:
            raise ValueError(f"input {tuple(pixels.shape)} gives {S} patches, "
                             f"config expects {cfg.num_patches}")
        x = torch.cat([self.cls_token.to(self.dtype).expand(B, 1, C), x], dim=1)
        x = dropout(x + self.pos_embed.to(self.dtype), cfg.dropout_rate, generator,
                    self.training)
        for blk in self.blocks:
            x = block_call(blk, x, remat=cfg.remat, policy=cfg.remat_policy,
                           generator=generator)
        return self.norm(x)
