"""XVLM composition (counterpart of x2vlm_tpu/models/xvlm.py): the BEiT-2
vision tower, the BERT text / fusion stack, the contrastive projections, the
temperature and the ITM head.

Parameter names are the reference's (``vision_encoder.*``,
``text_encoder.bert.*``, ``vision_proj``, ``text_proj``, ``temp``,
``itm_head.{0,1,3}``). This slice carries what the retrieval serving path
runs; the MLM and bbox heads and the losses arrive with the training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from x2vlm_tpu_torch.device import resolve_device
from x2vlm_tpu_torch.models.beit2 import BEiT2, BEiT2Config
from x2vlm_tpu_torch.models.bert import BertConfig, TextEncoder
from x2vlm_tpu_torch.ops.layers import dense, init_weights, layer_norm, linear

__all__ = ["XVLMConfig", "XVLMBase", "MlpHead"]


@dataclasses.dataclass(frozen=True)
class XVLMConfig:
    vision: BEiT2Config = dataclasses.field(default_factory=BEiT2Config)
    text: BertConfig = dataclasses.field(default_factory=BertConfig)
    embed_dim: int = 256
    temp: float = 0.07

    @classmethod
    def base(cls, image_res: int = 224, **kw) -> "XVLMConfig":
        return cls(vision=BEiT2Config.base(image_res=image_res),
                   text=BertConfig.bert_base(), **kw)


class MlpHead(nn.Sequential):
    """``0`` dense(2x) -> ``1`` LayerNorm(eps 1e-5) -> ``2`` GELU -> ``3``
    dense(out), the reference's build_mlp. The first dense runs in the
    compute dtype; the LayerNorm, the erf GELU and the last dense in fp32."""

    def __init__(self, dim: int, out_dim: int, *, dtype: torch.dtype, device):
        super().__init__(linear(dim, 2 * dim, device=device),
                         nn.LayerNorm(2 * dim, eps=1e-5, device=device),
                         nn.GELU(),
                         linear(2 * dim, out_dim, device=device))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fc1, ln, _, fc2 = self
        x = dense(x, fc1.weight, fc1.bias, self.dtype)
        x = F.gelu(layer_norm(x, ln.weight, ln.bias, ln.eps))
        return F.linear(x, fc2.weight, fc2.bias)


class XVLMBase(nn.Module):
    """Composition core. ``seed`` fills every parameter from a
    ``torch.Generator`` on ``device``; ``seed=None`` leaves them for
    ``load_state_dict``. Modules start in eval mode."""

    def __init__(self, config: Optional[XVLMConfig] = None, *,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 seed: Optional[int] = 0):
        super().__init__()
        device = resolve_device(device)
        cfg = self.config = config or XVLMConfig.base()
        if not isinstance(cfg.vision, BEiT2Config):
            raise NotImplementedError(
                f"vision tower {type(cfg.vision).__name__}: this slice ports BEiT-2")
        self.dtype = dtype
        self.vision_encoder = BEiT2(cfg.vision, dtype=dtype, device=device)
        self.text_encoder = TextEncoder(cfg.text, dtype=dtype, device=device)
        vw, tw = cfg.vision.embed_dim, cfg.text.hidden_size
        self.vision_proj = linear(vw, cfg.embed_dim, device=device)
        self.text_proj = linear(tw, cfg.embed_dim, device=device)
        self.temp = nn.Parameter(torch.empty((), device=device))
        self.itm_head = MlpHead(tw, 2, dtype=dtype, device=device)
        if seed is not None:
            gen = torch.Generator(device=device)
            gen.manual_seed(seed)
            init_weights(self, gen)
        self.eval()

    def init_extra(self, generator: torch.Generator, std: float) -> None:
        self.temp.fill_(self.config.temp)

    def get_vision_embeds(self, image: torch.Tensor, generator=None):
        """NHWC image (float, or uint8 normalised on the device) ->
        (embeds (B, S+1, C), atts (B, S+1))."""
        embeds = self.vision_encoder(image, generator)
        atts = torch.ones(embeds.shape[:2], dtype=torch.int32, device=embeds.device)
        return embeds, atts

    def get_text_embeds(self, text_ids, text_atts, generator=None):
        return self.text_encoder(text_ids, attention_mask=text_atts, mode="text",
                                 generator=generator)

    def get_cross_embeds(self, image_embeds, image_atts, text_ids=None,
                         text_embeds=None, text_atts=None, generator=None):
        if text_atts is None:
            raise ValueError("get_cross_embeds requires text_atts")
        # pad the image stream to a multiple of 8 (197 -> 200) with masked
        # positions, as the JAX package does; the output is query-side only
        pad = (-image_embeds.shape[1]) % 8
        if pad:
            image_embeds = F.pad(image_embeds, (0, 0, 0, pad))
            image_atts = F.pad(image_atts, (0, pad))
        if text_embeds is not None:
            return self.text_encoder(encoder_embeds=text_embeds,
                                     attention_mask=text_atts,
                                     encoder_hidden_states=image_embeds,
                                     encoder_attention_mask=image_atts,
                                     mode="fusion", generator=generator)
        if text_ids is None:
            raise ValueError("get_cross_embeds requires text_ids or text_embeds")
        return self.text_encoder(text_ids, attention_mask=text_atts,
                                 encoder_hidden_states=image_embeds,
                                 encoder_attention_mask=image_atts,
                                 mode="multi_modal", generator=generator)

    def get_features(self, image_embeds=None, text_embeds=None):
        """L2-normalised CLS projection (fp32) of the one stream given."""
        embeds, proj = ((text_embeds, self.text_proj) if image_embeds is None
                        else (image_embeds, self.vision_proj))
        f = F.linear(embeds[:, 0, :].float(), proj.weight, proj.bias)
        return f / torch.linalg.norm(f, dim=-1, keepdim=True)
