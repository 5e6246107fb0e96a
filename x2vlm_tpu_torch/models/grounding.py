"""Visual grounding (counterpart of x2vlm_tpu/models/grounding.py;
reference models/model_grounding.py:18-30): image + referring expression ->
the fusion stack's CLS -> bbox head -> sigmoid cxcywh; L1 + GIoU loss.

Like the reference's grounding model it *is* the composition core, with
the vision tower, the text / fusion stack and the bbox head only (the JAX
model turns the contrastive, matching and MLM heads off), so its state
dict carries the reference names without a prefix."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from x2vlm_tpu_torch.models.xvlm import XVLMBase, XVLMConfig

__all__ = ["XVLMForGrounding"]


class XVLMForGrounding(XVLMBase):
    def __init__(self, config: Optional[XVLMConfig] = None, *,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 seed: Optional[int] = 0):
        super().__init__(config, dtype=dtype, device=device, seed=seed, bbox_head=True,
                         projections=False, temp=False, itm_head=False)

    def predict(self, image: torch.Tensor, text_ids: torch.Tensor, text_atts: torch.Tensor,
                dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, 4) sigmoid cxcywh boxes, fp32, normalised to the image. The
        towers drop out in training mode; the fusion pass never does
        (``predict_bbox``)."""
        image_embeds, _ = self.get_vision_embeds(image, dropout_generator)
        text_embeds = self.get_text_embeds(text_ids, text_atts, dropout_generator)
        return self.predict_bbox(image_embeds, text_embeds, text_atts)

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None,
                dropout_generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """batch: image, text_ids, text_atts, target_bbox -> {loss_bbox,
        loss_giou}. ``generator`` is unused (no draw but dropout's)."""
        coord = self.predict(batch["image"], batch["text_ids"], batch["text_atts"],
                             dropout_generator)
        loss_bbox, loss_giou = self.get_bbox_loss(coord, batch["target_bbox"])
        return {"loss_bbox": loss_bbox, "loss_giou": loss_giou}
