"""Classification heads (the port's counterparts of x2vlm_tpu/models/
classification.py; reference models/model_classification.py).

- ``XVLMForClassification``: the CLS of a cross encoding (or of the text
  alone, without an image) -> ``cls_head``; the loss is hard-label CE,
  soft targets (``answer_weights``), KD from a teacher's ``answer_pred``
  (KL summed over classes, averaged over the batch) or, with one label,
  MSE. Video QA (MSRVTT / MSVD) is this over the answer list.
- ``XVLMForMultipleChoice``: K (question, option) rows per sample through
  ONE fusion pass over B * K rows, each row's image K / V gathered from its
  sample's single vision encoding (``encoder_gather_idx``), so the tower
  runs once per sample, not K times; ``mc_head`` scores each row and the K
  scores softmax against each other (NExT-QA MC).
- ``XVLMForNLVR``: one text against two images (reference :89-117). One
  vision pass over both images, one text pass, one fusion pass per image;
  the two CLS outputs, concatenated, go through ``cls_head``.

Like the reference's models each *is* the composition core plus its head
(``MlpHead``: dense(2w), LayerNorm, GELU, dense(out)): the JAX models carry
the vision tower, the text / fusion stack, ``temp`` and the frame positions
(their ``setup`` makes both, which nothing here reads but the positions) and
no projections or ITM head, so the state dict is the reference names
without a prefix."""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from x2vlm_tpu_torch.models.xvlm import MlpHead, XVLMBase, XVLMConfig, cross_entropy

__all__ = ["XVLMForClassification", "XVLMForMultipleChoice", "XVLMForNLVR"]


class XVLMForClassification(XVLMBase):
    def __init__(self, config: Optional[XVLMConfig] = None, *,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 seed: Optional[int] = 0, num_labels: int = 2):
        super().__init__(config, dtype=dtype, device=device, seed=None, projections=False,
                         itm_head=False)
        self.num_labels = num_labels
        self.cls_head = MlpHead(self.config.text.hidden_size, num_labels, dtype=dtype,
                                device=self.device)
        self.fill(seed)

    def logits(self, text_ids: torch.Tensor, text_atts: torch.Tensor,
               image: Optional[torch.Tensor] = None,
               dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, num_labels) fp32 logits: the cross encoding's CLS against
        ``image`` (a video when 5-D), or the whole stack over the text alone."""
        if image is None:
            embeds = self.text_encoder(text_ids, attention_mask=text_atts, mode="multi_modal",
                                       generator=dropout_generator)
        else:
            image_embeds, image_atts = self.get_vision_embeds(image, dropout_generator)
            embeds = self.get_cross_embeds(image_embeds, image_atts, text_ids=text_ids,
                                           text_atts=text_atts, generator=dropout_generator)
        return self.cls_head(embeds[:, 0, :])

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None,
                dropout_generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """batch: text_ids, text_atts, [image], and labels, or
        ``answer_weights`` (soft targets), or ``answer_pred`` (a teacher's
        logits) -> {loss_cls}. ``generator`` is unused."""
        logits = self.logits(batch["text_ids"], batch["text_atts"], batch.get("image"),
                             dropout_generator)
        if batch.get("answer_pred") is not None:
            teacher = batch["answer_pred"].float()
            kl = F.softmax(teacher, dim=-1) * (F.log_softmax(teacher, dim=-1) -
                                               F.log_softmax(logits, dim=-1))
            return {"loss_cls": kl.sum() / logits.shape[0]}
        labels = batch["labels"]
        if self.num_labels == 1:
            loss = ((logits[:, 0] - labels.float()) ** 2).mean()
        elif batch.get("answer_weights") is not None:
            loss = -(F.log_softmax(logits, dim=-1) * batch["answer_weights"]).sum(-1).mean()
        else:
            loss = cross_entropy(logits, labels)
        return {"loss_cls": loss}

    def predict(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.logits(batch["text_ids"], batch["text_atts"], batch.get("image"))


class XVLMForMultipleChoice(XVLMBase):
    def __init__(self, config: Optional[XVLMConfig] = None, *,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 seed: Optional[int] = 0):
        super().__init__(config, dtype=dtype, device=device, seed=None, projections=False,
                         itm_head=False)
        self.mc_head = MlpHead(self.config.text.hidden_size, 1, dtype=dtype,
                               device=self.device)
        self.fill(seed)

    def logits(self, image: torch.Tensor, option_ids: torch.Tensor,
               option_atts: torch.Tensor,
               dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, K) fp32 scores of each sample's K (question, option) rows
        against its image or video."""
        B, K, L = option_ids.shape
        image_embeds, image_atts = self.get_vision_embeds(image, dropout_generator)
        flat_ids, flat_atts = option_ids.reshape(B * K, L), option_atts.reshape(B * K, L)
        text_embeds = self.get_text_embeds(flat_ids, flat_atts, dropout_generator)
        gather_idx = torch.arange(B, device=image_embeds.device).repeat_interleave(K)
        cross = self.get_cross_embeds(
            image_embeds, image_atts.index_select(0, gather_idx), text_embeds=text_embeds,
            text_atts=flat_atts, generator=dropout_generator,
            encoder_gather_idx=gather_idx)[:, 0, :]
        return self.mc_head(cross).reshape(B, K)

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None,
                dropout_generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """batch: image, option_ids / option_atts (B, K, L), labels (B,) ->
        {loss_cls}. ``generator`` is unused."""
        logits = self.logits(batch["image"], batch["option_ids"], batch["option_atts"],
                             dropout_generator)
        return {"loss_cls": cross_entropy(logits, batch["labels"])}

    def predict(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.logits(batch["image"], batch["option_ids"], batch["option_atts"])


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
