"""Task heads over the XVLM composition core (counterpart of
x2vlm_tpu/models/heads.py). This slice carries the retrieval serving
programs; the training losses arrive with the training slice."""

from __future__ import annotations

import torch

from x2vlm_tpu_torch.models.xvlm import XVLMBase

__all__ = ["XVLMForRetrieval"]


class XVLMForRetrieval(XVLMBase):
    """Two-stage retrieval: ITC encoders for the shortlist, ITM for the rerank.

    Like the reference's retrieval model it *is* the composition core, so
    its state dict carries the reference names without a prefix."""

    def encode_images(self, image: torch.Tensor):
        """(B, H, W, 3) -> (embeds (B, S+1, C) compute dtype, feat (B, E) fp32)."""
        embeds, _ = self.get_vision_embeds(image)
        return embeds, self.get_features(image_embeds=embeds)

    def encode_texts(self, text_ids: torch.Tensor, text_atts: torch.Tensor):
        """(B, L) ids and attention mask -> (embeds (B, L, C), feat (B, E) fp32)."""
        embeds = self.get_text_embeds(text_ids, text_atts)
        return embeds, self.get_features(text_embeds=embeds)

    def itm_score(self, image_embeds: torch.Tensor, text_embeds: torch.Tensor,
                  text_atts: torch.Tensor) -> torch.Tensor:
        """ITM rerank score of each (image, text) pair: logit of 'match', fp32."""
        image_atts = torch.ones(image_embeds.shape[:2], dtype=torch.int32,
                                device=image_embeds.device)
        cross = self.get_cross_embeds(image_embeds, image_atts,
                                      text_embeds=text_embeds,
                                      text_atts=text_atts)[:, 0, :]
        return self.itm_head(cross)[:, 1].float()
