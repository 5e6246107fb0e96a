"""XVLMPlus / CCLM (counterpart of x2vlm_tpu/models/xvlm_plus.py; reference
models/xvlm.py:960-1221 XVLMPlusBase, models/model_pretrain.py:91-196
XVLMPlus + CrossViewLM).

- The text tower is replaceable (XLM-R for CCLM) and runs all its layers
  uni-modally; the standalone cross encoder (no embeddings, cross-attention
  in every layer) fuses the text with the image, or with the *other
  language's* text embeddings for the parallel-text TTC / TTM / TLM
  objectives. The composition core (``XVLMBase`` on an ``XVLMPlusConfig``,
  models/xvlm.py) carries both, so every task model of the core runs on the
  Plus base, as the JAX ``make_base`` arranges.
- Checkpoint split: an XVLMBase state's fused text stack splits into
  text[0:T] / cross[T:N] (:func:`split_params_to_plus`, reference
  load_pretrained_xvlm:1073-1121).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Mapping, Optional

import torch

from x2vlm_tpu_torch.models.bert import BertConfig
from x2vlm_tpu_torch.models.heads import XVLMForPretrain
from x2vlm_tpu_torch.models.xvlm import XVLMConfig

__all__ = ["XVLMPlusConfig", "XVLMPlusForPretrain", "split_params_to_plus"]


@dataclasses.dataclass(frozen=True)
class XVLMPlusConfig(XVLMConfig):
    num_cross_layers: int = 6

    @property
    def is_plus(self) -> bool:
        return True

    @property
    def cross_config(self) -> BertConfig:
        """The cross encoder: the text config's widths, ``num_cross_layers``
        layers, cross-attention in each."""
        return dataclasses.replace(self.text, num_layers=self.num_cross_layers, fusion_layer=0,
                                   is_decoder=False)


class XVLMPlusForPretrain(XVLMForPretrain):
    """The XVLMPlus / CrossViewLM pretraining losses: the multimodal streams
    (image and region: ITC, ITM, MLM, the bbox losses) and the
    parallel-text stream (TTC / TTM / TLM). A batch without ``image``
    carrying ``text_ids_2`` is parallel text; without either, text-only
    MLM. State dict keys are ``base.<reference name>``."""

    def __init__(self, config: XVLMPlusConfig, *, dtype: torch.dtype = torch.bfloat16,
                 device=None, seed: Optional[int] = 0):
        if not config.is_plus:
            raise TypeError("XVLMPlusForPretrain needs an XVLMPlusConfig")
        super().__init__(config, dtype=dtype, device=device, seed=seed)

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None,
                dropout_generator: Optional[torch.Generator] = None,
                neg_idx=None, ret_match_loss: bool = True,
                ret_bbox_loss: bool = False) -> Dict[str, torch.Tensor]:
        if batch.get("image") is None and "text_ids_2" in batch:
            return self.forward_para_text(batch, generator, dropout_generator, neg_idx)
        return super().forward(batch, generator, dropout_generator, neg_idx,
                               ret_match_loss, ret_bbox_loss)

    def forward_multimodal(self, batch, generator=None, dropout_generator=None,
                           neg_idx=None, ret_match_loss: bool = True,
                           ret_bbox_loss: bool = False):
        """As the JAX ``XVLMPlusForPretrain.forward_multimodal``: ITC on the
        clean text, ITM through the cross encoder (3 x B rows), MLM from the
        masked ids through the text stack and the cross encoder, and with
        ``ret_bbox_loss`` the region stream's bbox losses."""
        base = self.base
        text_atts = batch["text_atts"]
        if ret_bbox_loss:
            image_embeds, image_atts, full_embeds = base.get_vision_embeds(
                batch["image"], dropout_generator, image_atts=batch["image_atts"],
                idx_to_group_img=batch["idx_to_group_img"])
        else:
            image_embeds, image_atts = base.get_vision_embeds(batch["image"],
                                                              dropout_generator)
        text_embeds = base.get_text_embeds(batch["text_ids"], text_atts, dropout_generator)
        image_feat = base.get_features(image_embeds=image_embeds)
        text_feat = base.get_features(text_embeds=text_embeds)
        losses = {"loss_itc": base.get_contrastive_loss(image_feat, text_feat)}
        if ret_match_loss:
            losses["loss_itm"] = base.get_matching_loss(
                image_embeds, image_atts, image_feat, text_embeds, text_atts, text_feat,
                generator, neg_idx=neg_idx, dropout_generator=dropout_generator)
        else:
            losses["loss_itm"] = torch.zeros((), dtype=torch.float32,
                                             device=image_feat.device)
        losses["loss_mlm"] = base.get_mlm_loss(
            batch["text_ids_masked"], text_atts, batch["masked_pos"], batch["masked_ids"],
            dropout_generator, image_embeds=image_embeds, image_atts=image_atts)
        if ret_bbox_loss:
            output_coord = base.predict_bbox(full_embeds, text_embeds, text_atts)
            losses["loss_bbox"], losses["loss_giou"] = base.get_bbox_loss(
                output_coord, batch["target_bbox"], batch.get("is_image"))
        return losses

    def forward_para_text(self, batch, generator=None, dropout_generator=None, neg_idx=None):
        """Cross-lingual TTC / TTM / TLM over parallel pairs (reference
        model_pretrain.py:161-181): language 2's embeddings take the image's
        place in the contrastive, matching and MLM losses. ``neg_idx``:
        injected (lang-1 negatives, lang-2 negatives) for the TTM rows."""
        base = self.base
        atts1, atts2 = batch["text_atts"], batch["text_atts_2"]
        e1 = base.get_text_embeds(batch["text_ids"], atts1, dropout_generator)
        e2 = base.get_text_embeds(batch["text_ids_2"], atts2, dropout_generator)
        f1 = base.get_features(text_embeds=e1)
        f2 = base.get_features(text_embeds=e2)
        return {
            "loss_ttc": base.get_contrastive_loss(f1, f2),
            "loss_ttm": base.get_matching_loss(e1, atts1, f1, e2, atts2, f2, generator,
                                               neg_idx=neg_idx,
                                               dropout_generator=dropout_generator),
            "loss_mlm": base.get_mlm_loss(batch["text_ids_masked"], atts1, batch["masked_pos"],
                                          batch["masked_ids"], dropout_generator,
                                          image_embeds=e2, image_atts=atts2),
        }


_TEXT_LAYER = re.compile(r"text_encoder\.bert\.encoder\.layer\.(\d+)\.(.*)")


def split_params_to_plus(state: Mapping[str, torch.Tensor], *, fusion_layer: int,
                         num_layers: int, replace_text_encoder: bool = False
                         ) -> Dict[str, torch.Tensor]:
    """An XVLMBase state dict (reference names) with its fused text stack
    split into the Plus text tower (layers [0, ``fusion_layer``) and the
    embeddings) and the cross encoder (layers [``fusion_layer``,
    ``num_layers``) as ``cross_encoder.encoder.layer.{j}``). With
    ``replace_text_encoder`` the text tower is dropped: a fresh XLM-R takes
    its place, and only the cross layers and the heads carry over."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in state.items():
        m = _TEXT_LAYER.match(k)
        if m and fusion_layer <= int(m.group(1)) < num_layers:
            out[f"cross_encoder.encoder.layer.{int(m.group(1)) - fusion_layer}.{m.group(2)}"] = v
        elif k.startswith("text_encoder.bert."):
            if not replace_text_encoder and not (m and int(m.group(1)) >= num_layers):
                out[k] = v
        else:
            out[k] = v
    return out
