"""XVLM composition (counterpart of x2vlm_tpu/models/xvlm.py): a vision
tower (BEiT-2, CLIP ViT or Swin, dispatched on its config's type by
``build_vision_tower``), the BERT text / fusion stack, the contrastive projections, the
temperature, the ITM head and the bbox head.

Parameter names are the reference's (``vision_encoder.*``,
``text_encoder.bert.*``, ``text_encoder.cls.predictions.*``, ``vision_proj``,
``text_proj``, ``temp``, ``itm_head.{0,1,3}``, ``bbox_head.{0,1,3}``, the
video frame positions ``absolute_frame_pos_embed``). On an
``XVLMPlusConfig`` (models/xvlm_plus.py; the JAX ``make_base`` picks the
Plus base the same way) the core is the Plus / CCLM base: the text tower
(XLM-R's ``text_encoder.roberta`` for CCLM) runs all its layers
uni-modally and a standalone cross encoder without embeddings
(``cross_encoder.encoder.layer.{j}``, cross-attention in every layer) fuses
the text with the image, or with another text's embeddings. Video (5-D input,
``get_frame_embeds``): the tower runs once over every frame of the batch,
then the frame positions are added and the frames mean-pooled, or
summarised by the Perceiver resampler (``resampler.*``). The
losses are here: ITC (``get_contrastive_loss``), ITM with hard negatives
(``get_hard_negatives``, ``get_matching_loss``) and MLM, the last two fused
into one fusion pass (``get_matching_and_mlm_loss``), and the region
stream's box losses (``predict_bbox``, ``get_bbox_loss``: L1 + GIoU). All
loss math is fp32. Single card: the JAX package's ITC all-gather and
sharding constraints have no counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from x2vlm_tpu_torch.core import mesh
from x2vlm_tpu_torch.device import resolve_device
from x2vlm_tpu_torch.models.beit2 import BEiT2, BEiT2Config, grouped_image_embeds
from x2vlm_tpu_torch.models.bert import BertConfig, BertEncoder, TextEncoder
from x2vlm_tpu_torch.models.clip_vit import CLIPViT, CLIPViTConfig
from x2vlm_tpu_torch.models.resampler import PerceiverResampler
from x2vlm_tpu_torch.models.swin import SwinConfig, SwinTransformer
from x2vlm_tpu_torch.models.vit import ViT, ViTConfig
from x2vlm_tpu_torch.ops import box as box_ops
from x2vlm_tpu_torch.ops.fused_ce import softmax_ce
from x2vlm_tpu_torch.ops.layers import dense, init_weights, layer_norm, linear

__all__ = ["XVLMConfig", "XVLMBase", "MlpHead", "cross_entropy", "build_vision_tower",
           "vision_width", "vision_seq_len"]


def vision_width(vision_cfg) -> int:
    """A vision tower's output width: Swin's is its stem width times
    2^(stages - 1) (1024 for Swin-B), the others' their ``embed_dim``."""
    w = getattr(vision_cfg, "vision_width", None)
    return w if isinstance(w, int) else vision_cfg.embed_dim


def vision_seq_len(vision_cfg) -> int:
    """A vision tower's output tokens, the pooled / CLS token included:
    1 + (res/patch)^2; Swin's final grid is (res / (patch * 2^(stages-1)))^2."""
    if isinstance(vision_cfg, SwinConfig):
        stride = vision_cfg.patch_size * 2 ** (vision_cfg.num_layers - 1)
        return 1 + (vision_cfg.image_res // stride) ** 2
    return 1 + vision_cfg.num_patches


def build_vision_tower(vision_cfg, *, dtype: torch.dtype, device) -> nn.Module:
    """The tower of ``vision_cfg``'s type. Every tower returns (B, S+1, C)
    with a summary token at position 0 (BEiT-2 and Swin: a mean; CLIP and
    ViT: a CLS token)."""
    for cfg_type, tower in ((BEiT2Config, BEiT2), (CLIPViTConfig, CLIPViT),
                            (SwinConfig, SwinTransformer), (ViTConfig, ViT)):
        if isinstance(vision_cfg, cfg_type):
            return tower(vision_cfg, dtype=dtype, device=device)
    raise TypeError(f"unknown vision config type {type(vision_cfg).__name__}")


@dataclasses.dataclass(frozen=True)
class XVLMConfig:
    # BEiT2Config | CLIPViTConfig | SwinConfig | ViTConfig
    vision: Any = dataclasses.field(default_factory=BEiT2Config)
    text: BertConfig = dataclasses.field(default_factory=BertConfig)
    embed_dim: int = 256
    temp: float = 0.07
    fix_temp: bool = False
    # ITM hard negatives: 0 = sample from the whole batch; > 0 = only within
    # blocks of this many rows along the batch
    itm_neg_block: int = 0
    # video (reference xvlm.py:482-501): "" (images only) | "avgpool" (the
    # mean over frames) | "resampler" (models/resampler.py); the frame
    # positions (1, frame_len, 1, width) with add_frame_pos
    video_encoding: str = ""
    frame_len: int = 1
    add_frame_pos: bool = False
    resampler_depth: int = 2
    resampler_latents: int = 64

    @classmethod
    def base(cls, image_res: int = 224, **kw) -> "XVLMConfig":
        return cls(vision=BEiT2Config.base(image_res=image_res),
                   text=BertConfig.bert_base(), **kw)

    @property
    def is_plus(self) -> bool:
        """A standalone cross encoder (``XVLMPlusConfig``)."""
        return False


cross_entropy = softmax_ce  # the JAX package's models.xvlm.cross_entropy


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
    ``load_state_dict``. Modules start in eval mode. The head flags build
    the parameters a task has, as the JAX package creates a head's
    parameters only where a task's ``setup`` makes them: ``projections``
    the contrastive ``vision_proj`` / ``text_proj``, ``temp`` the
    temperature (unless ``fix_temp``), ``itm_head``, ``mlm_head`` and
    ``bbox_head``."""

    def __init__(self, config: Optional[XVLMConfig] = None, *,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 seed: Optional[int] = 0, mlm_head: bool = False,
                 bbox_head: bool = False, projections: bool = True, temp: bool = True,
                 itm_head: bool = True):
        super().__init__()
        device = resolve_device(device)
        cfg = self.config = config or XVLMConfig.base()
        self.dtype = dtype
        self.vision_encoder = build_vision_tower(cfg.vision, dtype=dtype, device=device)
        self.text_encoder = TextEncoder(cfg.text, dtype=dtype, device=device,
                                        mlm_head=mlm_head)
        if cfg.is_plus:
            self.cross_encoder = BertEncoder(cfg.cross_config, add_embeddings=False,
                                             dtype=dtype, device=device)
        vw, tw = vision_width(cfg.vision), cfg.text.hidden_size
        if projections:
            self.vision_proj = linear(vw, cfg.embed_dim, device=device)
            self.text_proj = linear(tw, cfg.embed_dim, device=device)
        if temp and not cfg.fix_temp:
            self.temp = nn.Parameter(torch.empty((), device=device))
        if itm_head:
            self.itm_head = MlpHead(tw, 2, dtype=dtype, device=device)
        if bbox_head:
            self.bbox_head = MlpHead(tw, 4, dtype=dtype, device=device)
        if cfg.video_encoding and cfg.add_frame_pos:
            self.absolute_frame_pos_embed = nn.Parameter(
                torch.empty(1, cfg.frame_len, 1, vw, device=device))
        if cfg.video_encoding == "resampler":
            self.resampler = PerceiverResampler(vw, cfg.frame_len, depth=cfg.resampler_depth,
                                                num_latents=cfg.resampler_latents,
                                                dtype=dtype, device=device)
        self.fill(seed)

    def fill(self, seed: Optional[int]) -> None:
        """Every parameter from ``seed`` (None: left as allocated); eval mode.
        A task model that adds a head after the core calls it again."""
        if seed is not None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            init_weights(self, gen)
        self.eval()

    @property
    def device(self) -> torch.device:
        """The device of the parameters, whatever the vision tower."""
        return self._tied_table().device

    def init_extra(self, generator: torch.Generator, std: float) -> None:
        if "temp" in self._parameters:
            self.temp.fill_(self.config.temp)
        if "absolute_frame_pos_embed" in self._parameters:   # flax truncated_normal(0.02)
            nn.init.trunc_normal_(self.absolute_frame_pos_embed, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)

    def get_vision_embeds(self, image: torch.Tensor, generator=None, image_atts=None,
                          idx_to_group_img=None):
        """NHWC image (float, or uint8 normalised on the device) ->
        (embeds (B, S+1, C), atts (B, S+1)). With ``idx_to_group_img``
        (B_r,) and the region bitmaps ``image_atts`` (B_r, S+1), the region
        stream's rows of the images: (region rows with the region-masked
        pooled slot, ``image_atts``, the full rows for the bbox head). A CLIP
        tower with ``local_attn_depth > 0`` makes the region rows itself: its
        last layers attend inside each region. A 5-D ``image`` (B, F, H, W,
        3) is a video: :meth:`get_frame_embeds`."""
        if image.dim() == 5:
            if idx_to_group_img is not None:
                raise ValueError("a video batch has no region rows")
            return self.get_frame_embeds(image, generator)
        if idx_to_group_img is not None and image_atts is None:
            raise NotImplementedError(
                "idx_to_group_img without region bitmaps (grounding) comes with "
                "ROADMAP item A6")
        if idx_to_group_img is not None and \
                getattr(self.config.vision, "local_attn_depth", 0) > 0:
            region, full = self.vision_encoder(image, generator, idx_to_group_img, image_atts)
            return region, image_atts, full.index_select(0, idx_to_group_img)
        embeds = self.vision_encoder(image, generator)
        if idx_to_group_img is not None:
            region, full = grouped_image_embeds(embeds, idx_to_group_img, image_atts)
            return region, image_atts, full
        atts = torch.ones(embeds.shape[:2], dtype=torch.int32, device=embeds.device)
        return embeds, atts

    def get_frame_embeds(self, frames: torch.Tensor, generator=None):
        """(B, F, H, W, 3) frames -> (embeds, atts): one tower call over the
        B * F frames, video-major (a video's frames neighbours), the frame
        positions added in the compute dtype, then the mean over the frames
        (B, S+1, C), or the resampler's latents (B, num_latents, C)."""
        cfg = self.config
        B, n = frames.shape[:2]
        embeds = self.vision_encoder(frames.reshape((B * n,) + frames.shape[2:]), generator)
        embeds = embeds.reshape((B, n) + embeds.shape[1:])        # (B, F, S+1, C)
        if cfg.video_encoding and cfg.add_frame_pos:
            embeds = embeds + self.absolute_frame_pos_embed[:, :n].to(embeds.dtype)
        pooled = (self.resampler(embeds) if cfg.video_encoding == "resampler"
                  else embeds.mean(dim=1))
        atts = torch.ones(pooled.shape[:2], dtype=torch.int32, device=pooled.device)
        return pooled, atts

    def get_text_embeds(self, text_ids, text_atts, generator=None):
        """The text layers; on the Plus base the whole uni-modal stack."""
        return self.text_encoder(text_ids, attention_mask=text_atts,
                                 mode="multi_modal" if self.config.is_plus else "text",
                                 generator=generator)

    def get_cross_embeds(self, image_embeds, image_atts, text_ids=None,
                         text_embeds=None, text_atts=None, generator=None,
                         encoder_gather_idx=None, deterministic: bool = False):
        """The fusion stack over the text rows; ``encoder_gather_idx`` (B,)
        names the row of ``image_embeds`` (the unique images) each text row
        attends to, with ``image_atts`` already per text row.
        ``deterministic`` turns dropout and drop-path off in training mode."""
        if text_atts is None:
            raise ValueError("get_cross_embeds requires text_atts")
        # pad the image stream to a multiple of 8 (197 -> 200; Swin's 50 ->
        # 56) with masked positions, as the JAX package does; the output is
        # query-side only
        pad = 0 if image_embeds is None else (-image_embeds.shape[1]) % 8
        if pad:
            image_embeds = F.pad(image_embeds, (0, 0, 0, pad))
            image_atts = F.pad(image_atts, (0, pad))
        if self.config.is_plus:
            # the Plus base: the uni-modal text stack (unless given its
            # output), then the cross encoder; without an image stream its
            # cross-attentions are skipped (the text-only MLM)
            if text_embeds is None:
                if text_ids is None:
                    raise ValueError("get_cross_embeds requires text_ids or text_embeds")
                text_embeds = self.get_text_embeds(text_ids, text_atts, generator)
            return self.cross_encoder(encoder_embeds=text_embeds, attention_mask=text_atts,
                                      encoder_hidden_states=image_embeds,
                                      encoder_attention_mask=image_atts, mode="fusion",
                                      generator=generator,
                                      encoder_gather_idx=encoder_gather_idx,
                                      deterministic=deterministic)
        if text_embeds is not None:
            return self.text_encoder(encoder_embeds=text_embeds,
                                     attention_mask=text_atts,
                                     encoder_hidden_states=image_embeds,
                                     encoder_attention_mask=image_atts,
                                     mode="fusion", generator=generator,
                                     encoder_gather_idx=encoder_gather_idx,
                                     deterministic=deterministic)
        if text_ids is None:
            raise ValueError("get_cross_embeds requires text_ids or text_embeds")
        return self.text_encoder(text_ids, attention_mask=text_atts,
                                 encoder_hidden_states=image_embeds,
                                 encoder_attention_mask=image_atts,
                                 mode="multi_modal", generator=generator,
                                 encoder_gather_idx=encoder_gather_idx,
                                 deterministic=deterministic)

    def get_features(self, image_embeds=None, text_embeds=None):
        """L2-normalised CLS projection (fp32) of the one stream given."""
        embeds, proj = ((text_embeds, self.text_proj) if image_embeds is None
                        else (image_embeds, self.vision_proj))
        f = F.linear(embeds[:, 0, :].float(), proj.weight, proj.bias)
        return f / torch.linalg.norm(f, dim=-1, keepdim=True)

    # ---------- losses ----------

    def get_temp(self) -> torch.Tensor:
        if self.config.fix_temp:
            return torch.tensor(self.config.temp, dtype=torch.float32, device=self.device)
        # clamped in the graph; the optimizer also projects the parameter
        return self.temp.clamp(0.001, 0.5)

    def get_contrastive_loss(self, image_feat, text_feat, idx=None) -> torch.Tensor:
        """In-batch ITC, both directions; ``idx`` (B,) marks rows that share
        an image id as positives of each other (soft labels). In a step at
        world N (core/mesh.py) the batch is the global one: this rank's rows
        against every rank's features, gathered with their gradient, and
        ``idx`` gathered likewise (the JAX package's global-batch ITC); the
        loss is a mean over the rank's rows, which the ranks' mean makes the
        global one."""
        temp = self.get_temp()
        world = mesh.step_world()
        gather = mesh.gather_rows if world > 1 else (lambda x: x)
        rows = image_feat.shape[0]
        lo = mesh.process_index() * rows if world > 1 else 0
        logits = image_feat @ gather(text_feat).t() / temp
        logits_t = text_feat @ gather(image_feat).t() / temp
        if idx is None:
            labels = torch.arange(lo, lo + rows, device=logits.device)
            return (cross_entropy(logits, labels) + cross_entropy(logits_t, labels)) / 2
        idx = idx.reshape(-1)
        pos = (idx[:, None] == gather(idx)[None, :]).float()
        soft = pos / pos.sum(dim=1, keepdim=True)
        loss_i2t = -(torch.log_softmax(logits, dim=1) * soft).sum(1).mean()
        loss_t2i = -(torch.log_softmax(logits_t, dim=1) * soft).sum(1).mean()
        return (loss_i2t + loss_t2i) / 2

    @torch.no_grad()
    def get_hard_negatives(self, image_feat, text_feat,
                           generator: Optional[torch.Generator] = None, idx=None,
                           neg_idx: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        """One hard negative per row, drawn from softmax(similarity / temp)
        with the positives masked at -1e30 (Gumbel-max: one categorical draw
        per row from ``generator``). Returns (image_neg_idx, text_neg_idx);
        ``neg_idx`` passes given indices through (tests inject the JAX
        package's draws). In a step at world N the pool is the global batch
        (README deviation 3): this rank draws for its own rows from their
        similarity to every rank's features, and the indices are rows of
        the global batch, whose order is rank-contiguous."""
        if neg_idx is not None:
            return neg_idx
        masked_i2t, masked_t2i = self.masked_similarity(image_feat, text_feat, idx)
        dev = masked_i2t.device

        def draw(logits):
            u = torch.rand(logits.shape, generator=generator, device=dev)
            gumbel = -torch.log(-torch.log(u.clamp(1e-20, 1.0 - 1e-7)))
            return torch.argmax(logits + gumbel, dim=-1)

        text_neg_idx = draw(masked_i2t)
        image_neg_idx = draw(masked_t2i)
        return image_neg_idx, text_neg_idx

    @torch.no_grad()
    def masked_similarity(self, image_feat, text_feat, idx=None):
        """The logits the negatives are drawn from: (this rank's rows'
        image-to-text, text-to-image) similarity over the pool, / temp,
        -1e30 where row ``lo + i`` of the global batch may not take column
        j: a positive (the row itself, or a row of the same ``idx``) or,
        with ``itm_neg_block``, a column of another block."""
        world = mesh.step_world()
        rows = image_feat.shape[0]
        dev = image_feat.device
        temp = self.get_temp()
        if world > 1:
            lo = mesh.process_index() * rows
            sim_i2t = image_feat @ mesh.gather_rows(text_feat).t() / temp
            sim_t2i = text_feat @ mesh.gather_rows(image_feat).t() / temp
        else:
            lo = 0
            sim_i2t = (image_feat @ text_feat.t()) / temp
            sim_t2i = sim_i2t.t()
        g = torch.arange(lo, lo + rows, device=dev)
        c = torch.arange(rows * world, device=dev)
        if idx is None:
            pos = g[:, None] == c[None, :]
        else:
            idx = idx.reshape(-1)
            pos = idx[:, None] == (mesh.gather_rows(idx) if world > 1 else idx)[None, :]
        if self.config.itm_neg_block > 0:
            blk = self.config.itm_neg_block
            pos = pos | ((g // blk)[:, None] != (c // blk)[None, :])
        return sim_i2t.masked_fill(pos, -1e30), sim_t2i.masked_fill(pos, -1e30)

    def _negative_operands(self, image_embeds, image_atts, text_embeds, text_atts,
                           image_neg_idx, text_neg_idx):
        """(images, the image rows' key masks for ``[pos | (img, text_neg) |
        (img_neg, text)]``, their gather index into ``images``, text_neg,
        text_atts_neg). At world 1, or when ``itm_neg_block`` keeps every
        draw in this rank, ``images`` is the rank's own; else the negatives
        come from every rank's embeds, gathered with a gradient that flows
        back to the rank that owns the row."""
        rows = image_embeds.shape[0]
        ar = torch.arange(rows, device=image_embeds.device)
        world = mesh.step_world()
        blk = self.config.itm_neg_block
        if world > 1 and blk > 0 and rows % blk == 0:
            lo = mesh.process_index() * rows
            image_neg_idx, text_neg_idx = image_neg_idx - lo, text_neg_idx - lo
            world = 1
        if world == 1:
            gather_idx = torch.cat([ar, ar, image_neg_idx])
            return (image_embeds, image_atts.index_select(0, gather_idx), gather_idx,
                    text_embeds.index_select(0, text_neg_idx),
                    text_atts.index_select(0, text_neg_idx))
        text_neg = mesh.gather_rows(text_embeds).index_select(0, text_neg_idx)
        text_atts_neg = mesh.gather_rows(text_atts).index_select(0, text_neg_idx)
        images = torch.cat([image_embeds,
                            mesh.gather_rows(image_embeds).index_select(0, image_neg_idx)])
        atts = torch.cat([image_atts,
                          mesh.gather_rows(image_atts).index_select(0, image_neg_idx)])
        gather_idx = torch.cat([ar, ar, rows + ar])
        return images, atts.index_select(0, gather_idx), gather_idx, text_neg, text_atts_neg

    def get_matching_loss(self, image_embeds, image_atts, image_feat, text_embeds,
                          text_atts, text_feat, generator=None, idx=None,
                          neg_idx=None, dropout_generator=None) -> torch.Tensor:
        """ITM: one positive and two hard-negative rows per pair through one
        fusion pass (K/V projected once per unique image) -> 2-way head."""
        bs = image_embeds.shape[0]
        image_neg_idx, text_neg_idx = self.get_hard_negatives(
            image_feat, text_feat, generator, idx=idx, neg_idx=neg_idx)
        images, atts_rows, gather_idx, text_neg, text_atts_neg = self._negative_operands(
            image_embeds, image_atts, text_embeds, text_atts, image_neg_idx, text_neg_idx)
        cross = self.get_cross_embeds(
            images, atts_rows, text_embeds=torch.cat([text_embeds, text_neg, text_embeds]),
            text_atts=torch.cat([text_atts, text_atts_neg, text_atts]),
            generator=dropout_generator, encoder_gather_idx=gather_idx)[:, 0, :]
        dev = image_embeds.device
        labels = torch.cat([torch.ones(bs, dtype=torch.long, device=dev),
                            torch.zeros(2 * bs, dtype=torch.long, device=dev)])
        return cross_entropy(self.itm_head(cross), labels)

    def _tied_table(self) -> torch.Tensor:
        return self.text_encoder.stack.embeddings.word_embeddings.weight

    def get_matching_and_mlm_loss(self, image_embeds, image_atts, image_feat,
                                  text_embeds, text_atts, text_feat, mlm_text_embeds,
                                  masked_pos, masked_ids, generator=None, idx=None,
                                  neg_idx=None, dropout_generator=None):
        """ITM + MLM through ONE fusion pass over 4·bs rows
        [pos | (img, text_neg) | (img_neg, text) | (img, masked text)];
        ``mlm_text_embeds`` is the text-mode encoding of the masked ids.
        Returns (loss_itm, loss_mlm)."""
        bs = image_embeds.shape[0]
        image_neg_idx, text_neg_idx = self.get_hard_negatives(
            image_feat, text_feat, generator, idx=idx, neg_idx=neg_idx)
        images, atts_rows, gather_idx, text_neg, text_atts_neg = self._negative_operands(
            image_embeds, image_atts, text_embeds, text_atts, image_neg_idx, text_neg_idx)
        ar = torch.arange(bs, device=image_embeds.device)
        gather_idx = torch.cat([gather_idx, ar])
        text_all = torch.cat([text_embeds, text_neg, text_embeds, mlm_text_embeds])
        atts_all = torch.cat([text_atts, text_atts_neg, text_atts, text_atts])
        cross = self.get_cross_embeds(
            images, torch.cat([atts_rows, image_atts]), text_embeds=text_all,
            text_atts=atts_all, generator=dropout_generator,
            encoder_gather_idx=gather_idx)
        labels = torch.cat([torch.ones(bs, dtype=torch.long, device=ar.device),
                            torch.zeros(2 * bs, dtype=torch.long, device=ar.device)])
        loss_itm = cross_entropy(self.itm_head(cross[:3 * bs, 0, :]), labels)
        loss_mlm = self.text_encoder.mlm_head(cross[3 * bs:], masked_pos,
                                              self._tied_table(), masked_ids)
        return loss_itm, loss_mlm

    def get_mlm_loss(self, text_ids_masked, text_atts, masked_pos, masked_ids,
                     dropout_generator=None, image_embeds=None,
                     image_atts=None) -> torch.Tensor:
        """MLM through the whole stack from the masked ids: the fusion layers
        attend to ``image_embeds`` when given (the image stream without the
        matching loss, the JAX ``get_mlm_loss``), else they run without
        cross-attention (the text-only stream)."""
        if image_embeds is not None or self.config.is_plus:
            cross = self.get_cross_embeds(image_embeds, image_atts, text_ids=text_ids_masked,
                                          text_atts=text_atts, generator=dropout_generator)
        else:
            cross = self.text_encoder(text_ids_masked, attention_mask=text_atts,
                                      mode="multi_modal", generator=dropout_generator)
        return self.text_encoder.mlm_head(cross, masked_pos, self._tied_table(),
                                          masked_ids)

    # ---------- the region stream's box losses ----------

    def predict_bbox(self, image_embeds, text_embeds, text_atts) -> torch.Tensor:
        """The fusion stack's CLS over the full image rows (an all-ones image
        mask) -> bbox head -> sigmoid cxcywh, fp32 (reference
        xvlm.py:910-925). The fusion pass runs without dropout, in training
        too, as the JAX ``predict_bbox`` runs it deterministic."""
        image_atts = torch.ones(image_embeds.shape[:2], dtype=torch.int32,
                                device=image_embeds.device)
        cls = self.get_cross_embeds(image_embeds, image_atts, text_embeds=text_embeds,
                                    text_atts=text_atts, deterministic=True)[:, 0, :]
        return torch.sigmoid(self.bbox_head(cls).float())

    @staticmethod
    def get_bbox_loss(output_coord, target_bbox, is_image=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(L1, 1 - GIoU), each summed over the rows and divided by the rows
        kept: ``is_image`` rows (full-image captions) are left out, and in a
        step at world N the count is the global batch's
        (``mesh.batch_denominator``). A row
        whose predicted or target box is degenerate adds 0 to the GIoU loss
        (README deviation 4: the reference zeroes the whole batch's)."""
        output_coord = output_coord.float()
        target_bbox = target_bbox.float()
        loss_l1 = (output_coord - target_bbox).abs()
        b1 = box_ops.box_cxcywh_to_xyxy(output_coord)
        b2 = box_ops.box_cxcywh_to_xyxy(target_bbox)
        degenerate = (b1[:, 2:] < b1[:, :2]).any(dim=-1) | (b2[:, 2:] < b2[:, :2]).any(dim=-1)
        giou = box_ops.elementwise_generalized_box_iou(b1, b2)
        loss_giou = torch.where(degenerate, torch.zeros_like(giou), 1.0 - giou)
        if is_image is None:
            num = output_coord.shape[0]
        else:
            keep = 1.0 - is_image.float()
            num = mesh.batch_denominator(keep.sum())
            loss_l1 = loss_l1 * keep[:, None]
            loss_giou = loss_giou * keep
        return loss_l1.sum() / num, loss_giou.sum() / num
