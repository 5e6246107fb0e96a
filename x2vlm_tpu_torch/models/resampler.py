"""Flamingo-style Perceiver resampler (the port's counterpart of
x2vlm_tpu/models/resampler.py; reference models/resampler.py:17-120): learned
latent queries cross-attend to the frames' tokens, so a video of F frames
of N tokens becomes ``num_latents`` tokens.

No shipped config selects it (``video_encoding: resampler``). Its attention
runs on the plain core (``ops/attention.py``), as the JAX module runs
``dot_product_attention(impl="xla")`` outside Pallas: no kernel is owed.

Names follow the JAX module's, in torch form: ``latents``,
``time_pos_emb``, ``attn_{i}.{norm_media,norm_latents,to_q,to_k,to_v,
to_out}``, ``ff_norm_{i}``, ``ff1_{i}``, ``ff2_{i}``, ``norm_out``. Dense
layers carry no bias; LayerNorms (eps 1e-5) compute in fp32; the
feed-forward GELU is the tanh form (flax ``nn.gelu``).
"""

from __future__ import annotations

import torch
from torch import nn

from x2vlm_tpu_torch.ops.attention import dot_product_attention
from x2vlm_tpu_torch.ops.layers import dense, gelu_fast, layer_norm, linear

__all__ = ["PerceiverAttention", "PerceiverResampler"]


class PerceiverAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int = 8, head_dim: int = 64, *,
                 dtype: torch.dtype, device):
        super().__init__()
        inner = num_heads * head_dim
        self.num_heads, self.head_dim, self.dtype = num_heads, head_dim, dtype
        self.norm_media = nn.LayerNorm(dim, eps=1e-5, device=device)
        self.norm_latents = nn.LayerNorm(dim, eps=1e-5, device=device)
        self.to_q = linear(dim, inner, bias=False, device=device)
        self.to_k = linear(dim, inner, bias=False, device=device)
        self.to_v = linear(dim, inner, bias=False, device=device)
        self.to_out = linear(inner, dim, bias=False, device=device)

    def forward(self, x: torch.Tensor, latents: torch.Tensor) -> torch.Tensor:
        """x (B, T, N, C) media, latents (B, T, L, C) -> (B, T, L, C); the
        keys are the media and the latents."""
        dt = self.dtype
        ln = lambda t, m: layer_norm(t, m.weight, m.bias, m.eps).to(dt)
        x, latents = ln(x, self.norm_media), ln(latents, self.norm_latents)
        q = dense(latents, self.to_q.weight, None, dt)
        kv = torch.cat([x, latents], dim=-2)
        k = dense(kv, self.to_k.weight, None, dt)
        v = dense(kv, self.to_v.weight, None, dt)
        B, T, L, _ = q.shape
        S = k.shape[-2]
        H, D = self.num_heads, self.head_dim

        def split(t, n):
            return t.reshape(B * T, n, H, D).transpose(1, 2)

        out = dot_product_attention(split(q, L), split(k, S), split(v, S))
        out = out.transpose(1, 2).reshape(B, T, L, H * D)
        return dense(out, self.to_out.weight, None, dt)


class PerceiverResampler(nn.Module):
    """x (B, T, N, C) frame features -> (B, num_latents, C): ``depth``
    rounds of latent cross-attention and feed-forward per frame, then the
    mean over the frames and a final LayerNorm. ``num_frames`` sizes
    ``time_pos_emb`` (1, T, 1, C), which the JAX module sizes from its
    input at init."""

    def __init__(self, dim: int, num_frames: int, *, depth: int = 2, num_latents: int = 64,
                 num_heads: int = 8, head_dim: int = 64, ff_mult: int = 4,
                 dtype: torch.dtype, device):
        super().__init__()
        self.depth, self.dtype = depth, dtype
        self.latents = nn.Parameter(torch.empty(num_latents, dim, device=device))
        self.time_pos_emb = nn.Parameter(torch.empty(1, num_frames, 1, dim, device=device))
        for i in range(depth):
            setattr(self, f"attn_{i}", PerceiverAttention(dim, num_heads, head_dim,
                                                          dtype=dtype, device=device))
            setattr(self, f"ff_norm_{i}", nn.LayerNorm(dim, eps=1e-5, device=device))
            setattr(self, f"ff1_{i}", linear(dim, dim * ff_mult, bias=False, device=device))
            setattr(self, f"ff2_{i}", linear(dim * ff_mult, dim, bias=False, device=device))
        self.norm_out = nn.LayerNorm(dim, eps=1e-5, device=device)

    def init_extra(self, generator: torch.Generator, std: float) -> None:
        self.latents.normal_(0.0, std, generator=generator)
        self.time_pos_emb.normal_(0.0, std, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        B, T = x.shape[:2]
        x = x.to(dt) + self.time_pos_emb.to(dt)
        lat = self.latents.to(dt)[None, None].expand(B, T, *self.latents.shape)
        for i in range(self.depth):
            lat = lat + getattr(self, f"attn_{i}")(x, lat)
            norm = getattr(self, f"ff_norm_{i}")
            h = layer_norm(lat, norm.weight, norm.bias, norm.eps).to(dt)
            h = gelu_fast(dense(h, getattr(self, f"ff1_{i}").weight, None, dt))
            lat = lat + dense(h, getattr(self, f"ff2_{i}").weight, None, dt)
        lat = lat.mean(dim=1)
        n = self.norm_out
        return layer_norm(lat, n.weight, n.bias, n.eps).to(dt)
