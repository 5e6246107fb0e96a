"""Shared building blocks of the encoder stacks (counterpart of
x2vlm_tpu/ops/layers.py).

Precision contract, as in the JAX package: parameters are fp32, matmuls run
in the module's compute ``dtype`` (bf16 by default), LayerNorm statistics
and softmax run in fp32.

Parameters are created uninitialised (no global RNG is touched); a model
fills them with :func:`init_weights` from an explicit ``torch.Generator`` or
loads them (``convert.py``). Parameter names are the reference X2-VLM
checkpoint names, so a released state dict loads with ``load_state_dict``.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from x2vlm_tpu_torch.device import resolve_device
from x2vlm_tpu_torch.ops.attention import dot_product_attention
from x2vlm_tpu_torch.ops.flash_attention import flash_attention, flash_supported
from x2vlm_tpu_torch.ops.quant import qdense, quantize_act
from x2vlm_tpu_torch.ops.tiny_attention import tiny_block_attention, tiny_supported

__all__ = ["LayerNorm", "FusedLayerNorm", "Mlp", "DropPath", "MultiHeadAttention",
           "PatchEmbed", "patchify", "gelu_exact", "gelu_fast", "ACTIVATIONS", "dense",
           "dropout", "drop_path_keep", "epilogue_act", "init_weights", "linear", "layer_norm",
           "serving_only", "static_caches", "IMAGE_MEAN", "IMAGE_STD"]

# CLIP image statistics (same values as x2vlm_tpu/data/transforms.py; the
# uint8 path must match host normalization bit for bit)
IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


def linear(in_features: int, out_features: int, bias: bool = True,
           device=None) -> nn.Linear:
    """An ``nn.Linear`` whose parameters are allocated but not initialised."""
    return torch.nn.utils.skip_init(nn.Linear, in_features, out_features,
                                    bias=bias, device=device)


def dense(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
          dtype: torch.dtype) -> torch.Tensor:
    """``x @ weight.T + bias`` with inputs and parameters cast to ``dtype``."""
    return F.linear(x.to(dtype), weight.to(dtype),
                    None if bias is None else bias.to(dtype))


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            training: bool) -> torch.Tensor:
    """Inverted dropout drawing from an explicit generator."""
    if not training or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class PatchEmbed(nn.Module):
    """Non-overlapping patchify as space-to-depth + one matmul over NHWC
    pixels; the weight keeps the reference's conv layout
    (``proj.weight`` (C, in, p, p), ``proj.bias``). uint8 pixels are
    CLIP-normalised in fp32 first. Returns (B, num_patches, C)."""

    def __init__(self, embed_dim: int, patch_size: int, in_chans: int = 3, *,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        device = resolve_device(device)
        self.patch_size = patch_size
        self.dtype = dtype
        self.proj = torch.nn.utils.skip_init(
            nn.Conv2d, in_chans, embed_dim, patch_size, stride=patch_size,
            device=device)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        return patchify(pixels, self.proj.weight, self.proj.bias, self.dtype)


def patchify(pixels: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
             dtype: torch.dtype) -> torch.Tensor:
    """NHWC pixels through a stride-p conv weight (C, in, p, p) as one
    matmul; uint8 pixels are CLIP-normalised in fp32 first. Returns
    (B, num_patches, C)."""
    p = weight.shape[-1]
    B, H, W, C = pixels.shape
    if pixels.dtype == torch.uint8:
        mean = torch.tensor(IMAGE_MEAN, dtype=torch.float32, device=pixels.device)
        std = torch.tensor(IMAGE_STD, dtype=torch.float32, device=pixels.device)
        pixels = (pixels.to(torch.float32) / 255.0 - mean) / std
    x = pixels.to(dtype)
    # (B, H, W, C) -> (B, N, p*p*C), flattened in (ph, pw, C) order
    x = x.reshape(B, H // p, p, W // p, p, C).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(B, (H // p) * (W // p), p * p * C)
    w = weight.permute(0, 2, 3, 1).reshape(-1, p * p * C)
    return dense(x, w, bias, dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """fp32 LayerNorm with the fast-variance formula E[x^2] - E[x]^2 (as
    flax's and the JAX FusedLayerNorm); returns fp32."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf * xf).mean(dim=-1, keepdim=True) - mean * mean
    return (xf - mean) * torch.rsqrt(var + eps) * weight + bias


class FusedLayerNorm(nn.LayerNorm):
    """LayerNorm with fp32 statistics that returns its input's dtype."""

    def __init__(self, dim: int, eps: float = 1e-6, *, device=None):
        super().__init__(dim, eps=eps, device=resolve_device(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps).to(x.dtype)


class LayerNorm(nn.LayerNorm):
    """fp32 LayerNorm returning ``dtype``."""

    def __init__(self, dim: int, eps: float = 1e-6, *,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__(dim, eps=eps, device=resolve_device(device))
        self.out_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps).to(self.out_dtype)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """erf GELU computed in fp32 (the JAX package's tanh-polynomial form of
    the same function is within 4.8e-7 of it)."""
    return F.gelu(x.float()).to(x.dtype)


def gelu_fast(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximated GELU."""
    return F.gelu(x, approximate="tanh")


ACTIVATIONS = {"gelu": gelu_exact, "gelu_exact": gelu_exact,
               "gelu_fast": gelu_fast}


def epilogue_act(act: Callable) -> str:
    """The int8 kernel's epilogue activation for ``act``: "gelu_fast" for
    the tanh GELU, else the erf "gelu" (the JAX ``Mlp``'s rule)."""
    return "gelu_fast" if act is gelu_fast else "gelu"


def serving_only(module: nn.Module) -> None:
    """Refuse training mode in an int8 (``quant_int8``) layer."""
    if module.training:
        raise ValueError(
            "quant_int8 is serving-only: round() has zero gradient, so training "
            "through the int8 layers learns nothing; disable quant_int8 for "
            "training, or call .eval() to serve")


class Mlp(nn.Module):
    """Transformer FFN: ``fc1`` -> act -> ``fc2`` (+ dropout).

    ``quant=True``: both matmuls in int8 W8A8 (``ops/quant.qdense``, the
    same parameters), the activation fused into fc1's epilogue; serving
    only."""

    def __init__(self, dim: int, hidden_dim: int, out_dim: Optional[int] = None, *,
                 act: Callable = gelu_exact, dropout_rate: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16, quant: bool = False, device=None):
        super().__init__()
        device = resolve_device(device)
        self.act = act
        self.dropout_rate = dropout_rate
        self.dtype = dtype
        self.quant = quant
        self.fc1 = linear(dim, hidden_dim, device=device)
        self.fc2 = linear(hidden_dim, out_dim or dim, device=device)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.quant:
            serving_only(self)
            x = qdense(x, self.fc1.weight, self.fc1.bias, act=epilogue_act(self.act),
                       dtype=self.dtype)
            return qdense(x, self.fc2.weight, self.fc2.bias, dtype=self.dtype)
        x = self.act(dense(x, self.fc1.weight, self.fc1.bias, self.dtype))
        x = dense(x, self.fc2.weight, self.fc2.bias, self.dtype)
        return dropout(x, self.dropout_rate, generator, self.training)


def drop_path_keep(shape, keep: float, generator: Optional[torch.Generator],
                   device) -> torch.Tensor:
    """The rows a drop path keeps, each with probability ``keep``, drawn
    from ``generator``. Checks that hold one step on two devices replace it
    to give both the same rows."""
    return torch.rand(shape, generator=generator, device=device) < keep


class DropPath(nn.Module):
    """Stochastic depth per sample: the identity in eval and with
    ``deterministic``; in training each row is dropped with probability
    ``rate`` (``drop_path_keep``, drawn from ``generator``) and the kept rows
    are scaled by 1/(1-rate)."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                deterministic: bool = False) -> torch.Tensor:
        if self.rate == 0.0 or not self.training or deterministic:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        mask = drop_path_keep(shape, keep, generator, x.device)
        return torch.where(mask, x / keep, torch.zeros_like(x))


class MultiHeadAttention(nn.Module):
    """Q/K/V projections around the attention core, with the kernel dispatch
    of the JAX package's ``MultiHeadAttention``:

    - short queries (Sq <= 64) with no bias that one of the tiny kernel's
      walks takes (``tiny_supported``: any Skv at D <= 128), go to the tiny
      kernel on the projection layout; q is scaled in the compute dtype
      after its projection;
    - Sq and Skv >= 128 (no attention dropout) go to the flash kernel on
      the (B, H, S, D) layout, with the softmax scale folded into the query
      weights and bias in fp32 before the cast;
    - anything else runs the plain ``dot_product_attention``, with the scale
      folded the same way.

    ``causal=True`` (the decoder's self-attention) never takes the tiny
    kernel, as the JAX rule gates it on ``not causal``: it goes to the flash
    kernel where that admits the shape, else to the plain core with its
    causal mask.

    ``mask`` (a full boolean (B, 1, Sq, Skv) mask: the UniLM attention
    matrix) and ``cache`` (the static decode cache) take neither kernel:
    the call runs the plain core, as the JAX package runs it outside Pallas.
    A cache is ``{"k", "v"}`` buffers of shape (B, H, Lmax, D) in the
    compute dtype plus ``index`` (an int): the new keys and values go in at
    ``index .. index + Sq - 1`` (on the device, no host sync), every query sees the keys at positions ``<= index + its
    offset``, and the call returns ``(out, new cache)`` with ``index`` as
    given: the caller moves it (the UniLM decode rewrites its trailing
    [MASK] slot each step).

    ``quant=True`` (serving only) projects through the int8 kernel
    (``ops/quant.qdense``) with each source (x, and ``kv`` when given)
    quantized once and shared by the projections it feeds; the output
    projection is int8 too. The query weight is quantized unscaled and the
    softmax scale goes to the attention core, as the JAX package's int8
    path does (at D = 64 the two agree bit for bit: 1/8 is a power of 2).

    Parameter names follow the reference checkpoints. ``qkv_bias_mode="qv"``
    is BEiT-2's fused ``qkv`` weight with ``q_bias`` / ``v_bias`` (no key
    bias); "fused" is one ``qkv`` projection with its bias (ViT); "full" (q,
    k, v biases) and "none" are separate ``query`` / ``key`` / ``value``
    projections (BERT; CLIP names them ``q_proj`` / ``k_proj`` / ``v_proj``
    through ``names``). ``out_proj=True`` adds the output projection
    ``proj`` (BEiT-2, ViT; CLIP's ``out_proj``); BERT keeps its output
    projection outside, in ``attention.output.dense``. Without it the module
    returns the merged heads, (B, Sq, H*D). ``deterministic`` turns the
    attention and output dropout off in training mode (the JAX module's
    argument).

    ``kv_gather_idx`` (B,) says which row of ``kv`` each query row attends
    to: ``kv`` then holds only the unique K/V sources (the fusion pass of
    hard-negative ITM has 4·bs rows over bs images), K/V are projected once
    per unique row and gathered to the query rows with ``index_select``
    (whose autograd is the scatter-add).
    """

    def __init__(self, dim: int, num_heads: int, *, kv_dim: Optional[int] = None,
                 qkv_bias_mode: str = "full", out_proj: bool = False,
                 attn_dropout_rate: float = 0.0, proj_dropout_rate: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16, quant: bool = False,
                 names: Tuple[str, str, str, str] = ("query", "key", "value", "proj"),
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self._names = names
        self.quant = quant
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        inner = self.head_dim * num_heads
        kv_dim = kv_dim or dim
        self.qkv_bias_mode = qkv_bias_mode
        self.attn_dropout_rate = attn_dropout_rate
        self.proj_dropout_rate = proj_dropout_rate
        self.dtype = dtype
        if qkv_bias_mode in ("qv", "fused"):
            if kv_dim != dim:
                raise ValueError("the fused qkv projection is self-attention only")
            fused_bias = qkv_bias_mode == "fused"
            self.qkv = linear(dim, 3 * inner, bias=fused_bias, device=device)
            if not fused_bias:
                self.q_bias = nn.Parameter(torch.empty(inner, device=device))
                self.v_bias = nn.Parameter(torch.empty(inner, device=device))
        elif qkv_bias_mode in ("full", "none"):
            with_bias = qkv_bias_mode == "full"
            for name, width in zip(names[:3], (dim, kv_dim, kv_dim)):
                setattr(self, name, linear(width, inner, with_bias, device=device))
        else:
            raise ValueError(f"qkv_bias_mode {qkv_bias_mode!r}: one of full, fused, qv, none")
        setattr(self, names[3], linear(inner, dim, device=device) if out_proj else None)

    @property
    def out(self) -> Optional[nn.Linear]:
        """The output projection (``proj`` / ``out_proj``), or None."""
        return getattr(self, self._names[3])

    def _qkv_fused(self, q_scale: float):
        """The fused ``qkv`` weight and bias with ``q_scale`` folded into the
        query rows."""
        inner = self.qkv.weight.shape[0] // 3
        w = self.qkv.weight
        if self.qkv_bias_mode == "qv":
            b = torch.cat([self.q_bias, torch.zeros_like(self.v_bias), self.v_bias])
        else:
            b = self.qkv.bias
        if q_scale != 1.0:
            w = torch.cat([w[:inner] * q_scale, w[inner:]])
            b = torch.cat([b[:inner] * q_scale, b[inner:]])
        return w, b

    def _project(self, x, kv_src, q_scale: float):
        """(q, k, v) in (B, S, H*D); ``q_scale`` is folded into the query
        weight and bias in fp32 before the cast to the compute dtype."""
        dt = self.dtype
        if self.quant:
            return self._project_int8(x, kv_src)
        if self.qkv_bias_mode in ("qv", "fused"):
            return dense(x, *self._qkv_fused(q_scale), dt).split(
                self.qkv.weight.shape[0] // 3, dim=-1)

        def fold(layer):
            b = layer.bias
            if q_scale == 1.0:
                return layer.weight, b
            return layer.weight * q_scale, None if b is None else b * q_scale

        query, key, value = (getattr(self, n) for n in self._names[:3])
        q = dense(x, *fold(query), dt)
        k = dense(kv_src, key.weight, key.bias, dt)
        v = dense(kv_src, value.weight, value.bias, dt)
        return q, k, v

    def _project_int8(self, x, kv_src):
        """(q, k, v) through the int8 kernel from the unscaled weights. The
        fused ``qkv`` is one launch (per-row weight scales make it equal to
        three); separate projections share one quantization per source."""
        dt = self.dtype
        if self.qkv_bias_mode in ("qv", "fused"):
            return qdense(x, *self._qkv_fused(1.0), dtype=dt).split(
                self.qkv.weight.shape[0] // 3, dim=-1)
        xq, sx = quantize_act(x)
        kvq, skv = (xq, sx) if kv_src is x else quantize_act(kv_src)
        query, key, value = (getattr(self, n) for n in self._names[:3])
        q = qdense(x, query.weight, query.bias, xq=xq, sx=sx, dtype=dt)
        k = qdense(kv_src, key.weight, key.bias, xq=kvq, sx=skv, dtype=dt)
        v = qdense(kv_src, value.weight, value.bias, xq=kvq, sx=skv, dtype=dt)
        return q, k, v

    @staticmethod
    def _gather(q, k, v, kv_gather_idx):
        if kv_gather_idx is None:
            return q, k, v
        return q, k.index_select(0, kv_gather_idx), v.index_select(0, kv_gather_idx)

    def forward(self, x: torch.Tensor, kv: Optional[torch.Tensor] = None, *,
                bias: Optional[torch.Tensor] = None,
                key_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                kv_gather_idx: Optional[torch.Tensor] = None, causal: bool = False,
                mask: Optional[torch.Tensor] = None, cache=None,
                deterministic: bool = False):
        if self.quant:
            serving_only(self)
        B, Sq, _ = x.shape
        kv_src = x if kv is None else kv
        Skv = kv_src.shape[1]
        H, D = self.num_heads, self.head_dim
        scale = D ** -0.5
        training = self.training and not deterministic
        drop = self.attn_dropout_rate if training else 0.0

        if bias is None and not causal and mask is None and cache is None \
                and tiny_supported(Sq, Skv, D):
            q, k, v = self._gather(*self._project(x, kv_src, 1.0), kv_gather_idx)
            out = tiny_block_attention(q, k, v, num_heads=H, key_mask=key_mask,
                                       dropout_rate=drop, generator=generator,
                                       training=training, scale=scale)
        else:
            # float: the scale is folded into the query weight; int8: it is
            # applied by the attention core
            q_scale, core_scale = (1.0, scale) if self.quant else (scale, 1.0)
            q, k, v = self._gather(*self._project(x, kv_src, q_scale), kv_gather_idx)
            q = q.reshape(B, Sq, H, D).transpose(1, 2).contiguous()
            k = k.reshape(B, Skv, H, D).transpose(1, 2).contiguous()
            v = v.reshape(B, Skv, H, D).transpose(1, 2).contiguous()
            if cache is not None:
                k, v, mask = _cache_write(cache, k, v)
                key_mask, causal = None, False
            if mask is None and drop == 0.0 and flash_supported(q, k):
                out = flash_attention(q, k, v, bias=bias, key_mask=key_mask,
                                      causal=causal, scale=core_scale)
            else:
                out = dot_product_attention(
                    q, k, v, bias=bias, mask=mask, key_mask=key_mask, causal=causal,
                    scale=core_scale, dropout_rate=drop, generator=generator,
                    training=training)
            out = out.transpose(1, 2).reshape(B, Sq, H * D)
        proj = self.out
        if proj is not None:
            if self.quant:
                out = qdense(out, proj.weight, proj.bias, dtype=self.dtype)
            else:
                out = dense(out, proj.weight, proj.bias, self.dtype)
            out = dropout(out, self.proj_dropout_rate, generator, training)
        if cache is not None:
            return out, {"k": k, "v": v, "index": cache["index"]}
        return out


def static_caches(num_layers: int, batch: int, num_heads: int, max_len: int,
                  head_dim: int, dtype: torch.dtype, device) -> list:
    """One zeroed static decode cache a layer: ``k`` / ``v`` (batch,
    num_heads, max_len, head_dim) in ``dtype``, ``index`` 0."""
    shape = (batch, num_heads, max_len, head_dim)
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device), "index": 0}
            for _ in range(num_layers)]


def _cache_write(cache, k: torch.Tensor, v: torch.Tensor):
    """The static cache with (B, H, Sq, D) ``k`` / ``v`` written at
    ``cache["index"] ..`` (out of place, on the device), and the
    (B, 1, Sq, Lmax) mask of the keys each query sees."""
    ck, cv = cache["k"], cache["v"]
    B, _, Lmax, _ = ck.shape
    Sq = k.shape[2]
    index = cache["index"]
    q_pos = torch.arange(index, index + Sq, device=ck.device)
    ck = ck.index_copy(2, q_pos, k.to(ck.dtype))
    cv = cv.index_copy(2, q_pos, v.to(cv.dtype))
    mask = torch.arange(Lmax, device=ck.device)[None, :] <= q_pos[:, None]
    return ck, cv, mask[None, None].expand(B, 1, Sq, Lmax)


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator,
                 std: float = 0.02) -> None:
    """Fill every parameter of ``module`` from ``generator``: linear, conv and
    embedding weights ~ N(0, std), biases 0, LayerNorm 1 / 0; a submodule
    with an ``init_extra(generator, std)`` method fills its own parameters
    after that."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.Embedding)):
            m.weight.normal_(0.0, std, generator=generator)
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, MultiHeadAttention) and m.qkv_bias_mode == "qv":
            m.q_bias.zero_()
            m.v_bias.zero_()
    for m in module.modules():
        if hasattr(m, "init_extra"):
            m.init_extra(generator, std)
