"""CLIP ViT vision encoder (counterpart of x2vlm_tpu/models/clip_vit.py).

A pre-LN ViT: a bias-free conv patchify over NHWC pixels, a learned
``class_embedding``, learned absolute position embeddings, ``pre_layrnorm``,
pre-LN blocks with QuickGELU (or the exact GELU, the vision JSON's
``hidden_act``) and ``post_layernorm``, every LayerNorm at eps 1e-5.
Output (B, S+1, C) with token 0 the CLS token (BEiT-2's token 0 is a mean).
The self-attention goes through ``MultiHeadAttention`` without a bias, so
at 197 tokens it takes the flash kernel.

``local_attn_depth > 0`` turns on the region path inside the tower: the
last k layers run on [region rows || full rows], the region rows gathered
from their images before those layers, each row attending with its own key
mask (the region's patches for a region row, every key for a full row).
With ``remat`` each layer is rematerialised under ``remat_policy``
(``ops/remat.py``).

Parameter names are the reference's (HF CLIP's after its loader strips
``vision_model.`` and ``embeddings.``): ``patch_embed.weight``,
``class_embedding``, ``pos_embed.weight``, ``pre_layrnorm``,
``encoder.layers.N.{layer_norm1, self_attn.{q,k,v,out}_proj, layer_norm2,
mlp.fc1, mlp.fc2}``, ``post_layernorm``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from x2vlm_tpu_torch.device import resolve_device
from x2vlm_tpu_torch.ops.layers import (
    FusedLayerNorm, LayerNorm, Mlp, MultiHeadAttention, gelu_exact, patchify,
)
from x2vlm_tpu_torch.ops.remat import block_call, checkpoint_policy

__all__ = ["CLIPViTConfig", "CLIPViT", "quick_gelu", "CLIP_ACTIVATIONS"]


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


# the vision JSON's ``hidden_act`` values (HF CLIP ships quick_gelu)
CLIP_ACTIVATIONS = {"quick_gelu": quick_gelu, "gelu": gelu_exact}


@dataclasses.dataclass(frozen=True)
class CLIPViTConfig:
    image_res: int = 224
    patch_size: int = 16
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    attn_dropout_rate: float = 0.0   # the vision JSON's ``attention_dropout``
    act: str = "quick_gelu"          # the vision JSON's ``hidden_act``
    local_attn_depth: int = 0        # the region path's last k layers; <= 0: off
    ln_eps: float = 1e-5
    remat: bool = False        # rematerialise each block in the backward (ops/remat.py)
    remat_policy: Optional[str] = None  # None / "full" | "dots" | "dots_saveable" | "nothing"

    def __post_init__(self):
        checkpoint_policy(self.remat_policy)

    @property
    def num_patches(self) -> int:
        return (self.image_res // self.patch_size) ** 2


class CLIPEncoderLayer(nn.Module):
    def __init__(self, config: CLIPViTConfig, *, dtype: torch.dtype, device):
        super().__init__()
        cfg = config
        self.layer_norm1 = FusedLayerNorm(cfg.embed_dim, cfg.ln_eps, device=device)
        self.self_attn = MultiHeadAttention(
            cfg.embed_dim, cfg.num_heads, qkv_bias_mode="full", out_proj=True,
            attn_dropout_rate=cfg.attn_dropout_rate, dtype=dtype,
            names=("q_proj", "k_proj", "v_proj", "out_proj"), device=device)
        self.layer_norm2 = FusedLayerNorm(cfg.embed_dim, cfg.ln_eps, device=device)
        self.mlp = Mlp(cfg.embed_dim, cfg.intermediate_size, act=CLIP_ACTIVATIONS[cfg.act],
                       dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, key_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), key_mask=key_mask, generator=generator)
        return x + self.mlp(self.layer_norm2(x), generator)


class _Encoder(nn.Module):
    def __init__(self, config: CLIPViTConfig, *, dtype: torch.dtype, device):
        super().__init__()
        self.layers = nn.ModuleList(CLIPEncoderLayer(config, dtype=dtype, device=device)
                                    for _ in range(config.depth))


class CLIPViT(nn.Module):
    """Plain: NHWC pixels -> (B, S+1, C). Region mode (``local_attn_depth >
    0``): also ``idx_to_group_img`` (B_r,), the image of each region row, and
    ``image_atts`` (B_r, S+1), its key mask (slot 0, the CLS, set); returns
    (region rows (B_r, S+1, C), full rows (B, S+1, C)), both after
    ``post_layernorm``."""

    def __init__(self, config: CLIPViTConfig, *, dtype: torch.dtype = torch.bfloat16,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        cfg = self.config = config
        if cfg.local_attn_depth > cfg.depth:
            raise ValueError(f"local_attn_depth={cfg.local_attn_depth} exceeds "
                             f"depth={cfg.depth}")
        self.dtype = dtype
        self.patch_embed = torch.nn.utils.skip_init(
            nn.Conv2d, 3, cfg.embed_dim, cfg.patch_size, stride=cfg.patch_size, bias=False,
            device=device)
        self.class_embedding = nn.Parameter(torch.empty(cfg.embed_dim, device=device))
        self.pos_embed = torch.nn.utils.skip_init(nn.Embedding, cfg.num_patches + 1,
                                                  cfg.embed_dim, device=device)
        self.pre_layrnorm = FusedLayerNorm(cfg.embed_dim, cfg.ln_eps, device=device)
        self.encoder = _Encoder(cfg, dtype=dtype, device=device)
        self.post_layernorm = LayerNorm(cfg.embed_dim, cfg.ln_eps, dtype=dtype, device=device)

    def init_extra(self, generator: torch.Generator, std: float) -> None:
        self.class_embedding.normal_(0.0, 1.0, generator=generator)

    def forward(self, pixels: torch.Tensor, generator: Optional[torch.Generator] = None,
                idx_to_group_img: Optional[torch.Tensor] = None,
                image_atts: Optional[torch.Tensor] = None):
        cfg = self.config
        grouped = idx_to_group_img is not None
        if grouped and cfg.local_attn_depth <= 0:
            raise ValueError("region arguments require local_attn_depth > 0")
        x = patchify(pixels, self.patch_embed.weight, None, self.dtype)
        B, S, C = x.shape
        if S != cfg.num_patches:
            raise ValueError(f"input {tuple(pixels.shape)} gives {S} patches, "
                             f"config expects {cfg.num_patches}")
        cls = self.class_embedding.to(self.dtype).expand(B, 1, C)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.weight[None].to(self.dtype)
        x = self.pre_layrnorm(x)
        local_from = cfg.depth - cfg.local_attn_depth if grouped else cfg.depth
        key_mask = None
        for i, layer in enumerate(self.encoder.layers):
            if i == local_from:
                # the region rows of their images, then [region || full] with
                # per-row key masks through the last k layers
                x = torch.cat([x.index_select(0, idx_to_group_img), x])
                key_mask = torch.cat([image_atts.to(torch.int32),
                                      torch.ones(B, S + 1, dtype=torch.int32,
                                                 device=x.device)])
            x = block_call(layer, x, key_mask, remat=cfg.remat, policy=cfg.remat_policy,
                           generator=generator)
        x = self.post_layernorm(x)
        if grouped:
            n_region = idx_to_group_img.shape[0]
            return x[:n_region], x[n_region:]
        return x
