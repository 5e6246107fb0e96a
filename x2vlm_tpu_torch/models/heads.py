"""Task heads over the XVLM composition core (counterpart of
x2vlm_tpu/models/heads.py): the pretraining losses of the image-text,
region-text and text streams, and retrieval (fine-tuning losses and the
serving programs).

Randomness is explicit: ``generator`` draws the ITM hard negatives and
``dropout_generator`` every dropout / drop-path mask (both may be None, then
torch's default generator of the device is used)."""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from x2vlm_tpu_torch.models.xvlm import XVLMBase, XVLMConfig

__all__ = ["XVLMForPretrain", "XVLMForRetrieval"]


class XVLMForPretrain(nn.Module):
    """Pretraining losses over one stream batch. Like the JAX module it
    holds the composition core under ``base``, so its state dict keys are
    ``base.<reference name>``. Modules start in eval mode: call ``.train()``
    for dropout."""

    def __init__(self, config: Optional[XVLMConfig] = None, *,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 seed: Optional[int] = 0):
        super().__init__()
        self.base = XVLMBase(config, dtype=dtype, device=device, seed=seed,
                             mlm_head=True, bbox_head=True)
        self.config = self.base.config
        self.eval()

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None,
                dropout_generator: Optional[torch.Generator] = None,
                neg_idx=None, ret_match_loss: bool = True,
                ret_bbox_loss: bool = False) -> Dict[str, torch.Tensor]:
        if batch.get("image") is None:
            return self.forward_text(batch, dropout_generator)
        return self.forward_multimodal(batch, generator, dropout_generator, neg_idx,
                                       ret_match_loss, ret_bbox_loss)

    def forward_multimodal(self, batch, generator=None, dropout_generator=None,
                           neg_idx=None, ret_match_loss: bool = True,
                           ret_bbox_loss: bool = False):
        """ITC, then ITM + MLM through one fused fusion pass. ``neg_idx``:
        injected (image_neg_idx, text_neg_idx) for the ITM negatives.
        ``ret_match_loss=False`` (an image stream whose matching loss is off:
        noisy data beside an aux stream, or past ``stop_calc_itm``): no ITM
        (``loss_itm`` 0, no negatives drawn) and MLM through the whole stack
        from the masked ids with cross-attention to the image.

        ``ret_bbox_loss`` (the region stream: ``idx_to_group_img``,
        ``image_atts``, ``target_bbox``, ``is_image``): the losses run on the
        region rows, the region bitmaps as the image key mask, and
        ``loss_bbox`` / ``loss_giou`` come from the bbox head over the full
        rows."""
        base = self.base
        text_ids, text_atts = batch["text_ids"], batch["text_atts"]
        if ret_bbox_loss:
            image_embeds, image_atts, full_embeds = base.get_vision_embeds(
                batch["image"], dropout_generator, image_atts=batch["image_atts"],
                idx_to_group_img=batch["idx_to_group_img"])
        else:
            image_embeds, image_atts = base.get_vision_embeds(batch["image"],
                                                              dropout_generator)
        # one text-mode pass over the clean and the masked text
        both = base.get_text_embeds(torch.cat([text_ids, batch["text_ids_masked"]]),
                                    torch.cat([text_atts, text_atts]), dropout_generator)
        text_embeds, mlm_text_embeds = both.chunk(2)
        image_feat = base.get_features(image_embeds=image_embeds)
        text_feat = base.get_features(text_embeds=text_embeds)
        losses = {"loss_itc": base.get_contrastive_loss(image_feat, text_feat)}
        if ret_match_loss:
            losses["loss_itm"], losses["loss_mlm"] = base.get_matching_and_mlm_loss(
                image_embeds, image_atts, image_feat, text_embeds, text_atts, text_feat,
                mlm_text_embeds, batch["masked_pos"], batch["masked_ids"], generator,
                neg_idx=neg_idx, dropout_generator=dropout_generator)
        else:
            losses["loss_itm"] = torch.zeros((), dtype=torch.float32,
                                             device=image_feat.device)
            losses["loss_mlm"] = base.get_mlm_loss(
                batch["text_ids_masked"], text_atts, batch["masked_pos"],
                batch["masked_ids"], dropout_generator, image_embeds=image_embeds,
                image_atts=image_atts)
        if ret_bbox_loss:
            output_coord = base.predict_bbox(full_embeds, text_embeds, text_atts)
            losses["loss_bbox"], losses["loss_giou"] = base.get_bbox_loss(
                output_coord, batch["target_bbox"], batch.get("is_image"))
        return losses

    def forward_text(self, batch, dropout_generator=None):
        """The text-only stream: MLM through the whole stack."""
        return {"loss_mlm": self.base.get_mlm_loss(
            batch["text_ids_masked"], batch["text_atts"], batch["masked_pos"],
            batch["masked_ids"], dropout_generator)}


class XVLMForRetrieval(XVLMBase):
    """Two-stage retrieval: ITC encoders for the shortlist, ITM for the rerank;
    ``forward`` is the fine-tuning loss (ITC + ITM with duplicate-caption
    aware ``idx``).

    Like the reference's retrieval model it *is* the composition core, so
    its state dict carries the reference names without a prefix."""

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None,
                dropout_generator: Optional[torch.Generator] = None,
                neg_idx=None) -> Dict[str, torch.Tensor]:
        """batch: image, text_ids, text_atts, idx -> {loss_itc, loss_itm}."""
        text_atts, idx = batch["text_atts"], batch["idx"]
        image_embeds, image_atts = self.get_vision_embeds(batch["image"],
                                                          dropout_generator)
        text_embeds = self.get_text_embeds(batch["text_ids"], text_atts, dropout_generator)
        image_feat = self.get_features(image_embeds=image_embeds)
        text_feat = self.get_features(text_embeds=text_embeds)
        return {
            "loss_itc": self.get_contrastive_loss(image_feat, text_feat, idx=idx),
            "loss_itm": self.get_matching_loss(
                image_embeds, image_atts, image_feat, text_embeds, text_atts, text_feat,
                generator, idx=idx, neg_idx=neg_idx, dropout_generator=dropout_generator),
        }

    def encode_images(self, image: torch.Tensor):
        """(B, H, W, 3) images, or (B, F, H, W, 3) videos pooled over their
        frames -> (embeds (B, S+1, C) compute dtype, feat (B, E) fp32)."""
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
