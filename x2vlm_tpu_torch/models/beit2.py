"""BEiT-2 vision encoder (counterpart of x2vlm_tpu/models/beit2.py).

Patch embedding over NHWC pixels, a learnable CLS token, no absolute
position embedding, pre-LN blocks with LayerScale and stochastic depth, and
a per-block relative-position bias table over the (Wh, Ww) window with 3
extra cls-interaction rows. All depth x H tables are gathered in one indexed
read per forward and handed to the attention in the compute dtype, shared
over the batch as (1, H, S, S); with ``remat`` each block is rematerialised
under ``remat_policy`` (``ops/remat.py``), the gathered biases its inputs.
Output: (B, num_patches + 1, C) = [mean-pooled patch tokens after fc_norm
|| patch tokens].
``grouped_image_embeds`` turns the per-image output into the region
stream's rows.

Parameter names are the reference's (``patch_embed.proj``, ``cls_token``,
``blocks.N.{norm1, attn.qkv, attn.q_bias, attn.v_bias, attn.proj,
attn.relative_position_bias_table, gamma_1, gamma_2, norm2, mlp.fc1,
mlp.fc2}``, ``fc_norm``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from x2vlm_tpu_torch.device import resolve_device
from x2vlm_tpu_torch.ops.layers import (
    ACTIVATIONS, DropPath, FusedLayerNorm, LayerNorm, Mlp, MultiHeadAttention,
    PatchEmbed,
)
from x2vlm_tpu_torch.ops.remat import block_call, checkpoint_policy

__all__ = ["BEiT2Config", "BEiT2", "BEiT2Block", "relative_position_index",
           "grouped_image_embeds"]


@dataclasses.dataclass(frozen=True)
class BEiT2Config:
    image_res: int = 224
    patch_size: int = 16
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    init_values: float = 0.1  # LayerScale init
    drop_path_rate: float = 0.1
    dropout_rate: float = 0.0
    attn_dropout_rate: float = 0.0
    ln_eps: float = 1e-6
    act: str = "gelu"          # "gelu" (erf) | "gelu_fast" (tanh)
    quant_int8: bool = False   # int8 W8A8 projections and FFN (serving only)
    remat: bool = False        # rematerialise each block in the backward (ops/remat.py)
    remat_policy: Optional[str] = None  # None / "full" | "dots" | "dots_saveable" | "nothing"

    def __post_init__(self):
        checkpoint_policy(self.remat_policy)

    @property
    def window(self) -> Tuple[int, int]:
        w = self.image_res // self.patch_size
        return (w, w)

    @property
    def num_patches(self) -> int:
        wh, ww = self.window
        return wh * ww

    @property
    def num_relative_distance(self) -> int:
        wh, ww = self.window
        return (2 * wh - 1) * (2 * ww - 1) + 3

    @classmethod
    def base(cls, image_res: int = 224, **kw) -> "BEiT2Config":
        return cls(image_res=image_res, embed_dim=768, depth=12, num_heads=12, **kw)


def relative_position_index(window: Tuple[int, int]) -> np.ndarray:
    """Static (Wh*Ww+1, Wh*Ww+1) index into the rel-pos table; the last 3
    table rows are cls->token, token->cls and cls->cls."""
    wh, ww = window
    num_rel = (2 * wh - 1) * (2 * ww - 1) + 3
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    n = wh * ww
    idx = np.zeros((n + 1, n + 1), np.int64)
    idx[1:, 1:] = rel.sum(-1)
    idx[0, 0:] = num_rel - 3
    idx[0:, 0] = num_rel - 2
    idx[0, 0] = num_rel - 1
    return idx


class BEiT2Attention(MultiHeadAttention):
    """BEiT-2 self-attention: fused ``qkv`` with q/v biases, ``proj``, and this
    block's ``relative_position_bias_table`` (gathered by :class:`BEiT2`)."""

    def __init__(self, config: BEiT2Config, *, dtype: torch.dtype, device):
        super().__init__(config.embed_dim, config.num_heads, qkv_bias_mode="qv",
                         out_proj=True, attn_dropout_rate=config.attn_dropout_rate,
                         proj_dropout_rate=config.dropout_rate, dtype=dtype,
                         quant=config.quant_int8, device=device)
        self.relative_position_bias_table = nn.Parameter(torch.empty(
            config.num_relative_distance, config.num_heads, device=device))

    def init_extra(self, generator: torch.Generator, std: float) -> None:
        self.relative_position_bias_table.normal_(0.0, std, generator=generator)


class BEiT2Block(nn.Module):
    def __init__(self, config: BEiT2Config, drop_path: float, *,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        device = resolve_device(device)
        cfg = config
        self.dtype = dtype
        self.init_values = cfg.init_values
        self.norm1 = FusedLayerNorm(cfg.embed_dim, cfg.ln_eps, device=device)
        self.attn = BEiT2Attention(cfg, dtype=dtype, device=device)
        self.gamma_1 = nn.Parameter(torch.empty(cfg.embed_dim, device=device))
        self.gamma_2 = nn.Parameter(torch.empty(cfg.embed_dim, device=device))
        self.norm2 = FusedLayerNorm(cfg.embed_dim, cfg.ln_eps, device=device)
        self.mlp = Mlp(cfg.embed_dim, int(cfg.embed_dim * cfg.mlp_ratio),
                       act=ACTIVATIONS[cfg.act], dropout_rate=cfg.dropout_rate,
                       dtype=dtype, quant=cfg.quant_int8, device=device)
        self.drop_path = DropPath(drop_path)

    def init_extra(self, generator: torch.Generator, std: float) -> None:
        self.gamma_1.fill_(self.init_values)
        self.gamma_2.fill_(self.init_values)

    def forward(self, x: torch.Tensor, rel_pos_bias: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = self.dtype
        h = self.attn(self.norm1(x.to(dt)), bias=rel_pos_bias, generator=generator)
        x = x + self.drop_path(h * self.gamma_1.to(dt), generator)
        h = self.mlp(self.norm2(x.to(dt)), generator)
        return x + self.drop_path(h * self.gamma_2.to(dt), generator)


class BEiT2(nn.Module):
    """Returns (B, num_patches + 1, C): [mean-pooled patches || patch tokens]."""

    def __init__(self, config: BEiT2Config, *, dtype: torch.dtype = torch.bfloat16,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        cfg = self.config = config
        self.dtype = dtype
        self.patch_embed = PatchEmbed(cfg.embed_dim, cfg.patch_size, dtype=dtype,
                                      device=device)
        self.cls_token = nn.Parameter(torch.empty(1, 1, cfg.embed_dim, device=device))
        dpr = np.linspace(0.0, cfg.drop_path_rate, cfg.depth)
        self.blocks = nn.ModuleList(
            BEiT2Block(cfg, float(dpr[i]), dtype=dtype, device=device)
            for i in range(cfg.depth))
        self.fc_norm = LayerNorm(cfg.embed_dim, cfg.ln_eps, dtype=torch.float32,
                                 device=device)
        self._rel_index: Dict[torch.device, torch.Tensor] = {}

    def init_extra(self, generator: torch.Generator, std: float) -> None:
        self.cls_token.normal_(0.0, std, generator=generator)

    def rel_pos_biases(self) -> torch.Tensor:
        """(depth, 1, H, S+1, S+1) rel-pos biases of every block in the
        compute dtype, from one gather over the concatenated tables."""
        cfg = self.config
        dev = self.cls_token.device
        index = self._rel_index.get(dev)
        if index is None:
            index = torch.from_numpy(relative_position_index(cfg.window)).to(dev)
            self._rel_index[dev] = index
        tables = torch.cat([blk.attn.relative_position_bias_table
                            for blk in self.blocks], dim=-1)   # (nrel, depth*H)
        gathered = tables[index]                               # (S1, S1, depth*H)
        S1 = gathered.shape[0]
        return gathered.permute(2, 0, 1).reshape(
            cfg.depth, 1, cfg.num_heads, S1, S1).to(self.dtype)

    def forward(self, pixels: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg = self.config
        x = self.patch_embed(pixels)
        B, S, C = x.shape
        if S != cfg.num_patches:
            raise ValueError(f"input {tuple(pixels.shape)} gives {S} patches, "
                             f"config expects {cfg.num_patches}")
        cls = self.cls_token.to(self.dtype).expand(B, 1, C)
        x = torch.cat([cls, x], dim=1)
        # unbind: the backward stacks the blocks' bias gradients once (a
        # select a block would zero-fill and add a depth-sized gradient each)
        for blk, bias in zip(self.blocks, self.rel_pos_biases().unbind(0)):
            x = block_call(blk, x, bias, remat=cfg.remat, policy=cfg.remat_policy,
                           generator=generator)
        # mean-pooling contract: fc_norm over the patches; token 0 is their mean
        patches = self.fc_norm(x[:, 1:].float())
        pooled = patches.mean(dim=1, keepdim=True)
        return torch.cat([pooled, patches], dim=1).to(self.dtype)


def grouped_image_embeds(vision_embeds: torch.Tensor, idx_to_group_img: torch.Tensor,
                         image_atts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The region stream's rows: ``vision_embeds`` (B_img, S+1, C) gathered
    to the region rows by ``idx_to_group_img`` (B_r,), the pooled slot
    replaced by the mean of the patches inside the region (``image_atts``
    (B_r, S+1), 1 on the region's patches; slot 0 is the CLS slot), summed
    in the patches' dtype with the ``max(sum, 1e-6)`` guard, as the JAX
    package does. Returns (region rows, the gathered full rows)."""
    full = vision_embeds.index_select(0, idx_to_group_img)
    patches = full[:, 1:, :]
    weights = image_atts[:, 1:, None].to(patches.dtype)
    pooled = (weights * patches).sum(dim=1, keepdim=True) / \
        weights.sum(dim=1, keepdim=True).clamp(min=1e-6)
    return torch.cat([pooled, patches], dim=1), full
