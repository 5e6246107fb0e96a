"""NLVR2 (counterpart of ``XVLMForNLVR`` in x2vlm_tpu/models/classification.py;
reference models/model_classification.py:89-117): one text against two
images. One vision pass over both images, one text pass, one fusion pass
per image; the two CLS outputs, concatenated, go through ``cls_head``.

Like the reference's NLVR model it *is* the composition core plus
``cls_head`` (dense(2w -> 4w), LayerNorm, GELU, dense(2)): the JAX model
carries the vision tower, the text / fusion stack and ``temp`` (its
``setup`` makes the temperature, which nothing reads) and no projections
or ITM head, so the state dict is the reference names without a prefix."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from x2vlm_tpu_torch.models.xvlm import MlpHead, XVLMBase, XVLMConfig, cross_entropy

__all__ = ["XVLMForNLVR"]


class XVLMForNLVR(XVLMBase):
    def __init__(self, config: Optional[XVLMConfig] = None, *,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 seed: Optional[int] = 0, num_labels: int = 2):
        super().__init__(config, dtype=dtype, device=device, seed=None, projections=False,
                         itm_head=False)
        width = self.config.text.hidden_size
        self.cls_head = MlpHead(2 * width, num_labels, dtype=dtype,
                                device=self.device)
        self.fill(seed)

    def logits(self, image0: torch.Tensor, image1: torch.Tensor, text_ids: torch.Tensor,
               text_atts: torch.Tensor,
               dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, num_labels) fp32 logits of each text against its image pair."""
        embeds, atts = self.get_vision_embeds(torch.cat([image0, image1]), dropout_generator)
        e0, e1 = embeds.chunk(2)
        a0, a1 = atts.chunk(2)
        text_embeds = self.get_text_embeds(text_ids, text_atts, dropout_generator)
        cls = [self.get_cross_embeds(e, a, text_embeds=text_embeds, text_atts=text_atts,
                                     generator=dropout_generator)[:, 0, :]
               for e, a in ((e0, a0), (e1, a1))]
        return self.cls_head(torch.cat(cls, dim=-1))

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None,
                dropout_generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """batch: image0, image1, text_ids, text_atts, labels -> {loss_cls}.
        ``generator`` is unused (no draw but dropout's)."""
        logits = self.logits(batch["image0"], batch["image1"], batch["text_ids"],
                             batch["text_atts"], dropout_generator)
        return {"loss_cls": cross_entropy(logits, batch["labels"])}

    def predict(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.logits(batch["image0"], batch["image1"], batch["text_ids"],
                           batch["text_atts"])
