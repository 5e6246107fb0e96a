"""X2-VLM in plain PyTorch: the benchmark's reference.

Written from the X2-VLM paper (arXiv:2211.12402) and its public code
(github.com/zengyan-97/X2-VLM: models/xvlm.py, xbert.py, beit2.py), with
the parameter names of its checkpoints. It imports nothing of the program
under test and holds no kernel, cache or batching trick: every matmul is a
plain ``x @ w.T`` in float32, with TF32 off (:func:`strict_fp32`).

It follows the benchmark's contract with the program on randomness: a
training step draws its dropout masks and ITM hard negatives from two
generators seeded from (seed, step, stream) (:func:`step_seeds`), each
draw a ``torch.rand`` of the shape the tensor has, in the order the layers
run. On the same device the same seeds give the same uniforms, so the
reference applies the masks the program applied, and computes everything
else itself.

``lowp=True`` runs every linear layer's matmuls, forward and backward, on
operands rounded to float8 e4m3 with a per-tensor scale (:class:`Fp8Linear`):
the control, one precision below the bfloat16 the configuration states.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

__all__ = ["Fp8Linear", "Reference", "param_spec", "step_seeds", "strict_fp32",
           "IMAGE_MEAN", "IMAGE_STD"]

# CLIP image statistics: X2-VLM normalises its inputs with them
IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)
NEG = -1e30   # a masked logit
FP8_MAX = 448.0


def strict_fp32() -> None:
    """Float32 matmuls in float32: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def step_seeds(seed: int, step: int, stream: int) -> Tuple[int, int]:
    """(negatives seed, dropout seed) of one stream at one step: the
    generators' seeds of the contract (stream 0 images, 1 regions)."""
    base = ((seed * 1_000_003 + step) * 8 + stream) * 2
    return base, base + 1


def _q8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale, back in fp32."""
    amax = t.detach().abs().amax().clamp(min=1e-30)
    s = amax / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class Fp8Linear(torch.autograd.Function):
    """``x @ w.T`` with both operands in float8 e4m3, and the backward's
    two products with theirs (the output gradient included) in float8."""

    @staticmethod
    def forward(ctx, x, w):
        xq, wq = _q8(x), _q8(w)
        ctx.save_for_backward(xq, wq)
        return xq @ wq.t()

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = _q8(g)
        gx = gq @ wq
        gw = gq.reshape(-1, gq.shape[-1]).t() @ xq.reshape(-1, xq.shape[-1])
        return gx, gw


def param_spec(model: Dict, heads: str) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, init) of every parameter: ``heads`` "pretrain" (ITM,
    MLM and bbox heads) or "retrieval" (ITM head). ``init`` is "normal"
    (N(0, 0.02)), "ln" (1 + N(0, 0.02)), "gamma" (LayerScale, 0.1) or
    "temp" (the ITC temperature). Names are the X2-VLM checkpoints'."""
    v, t = model["vision"], model["text"]
    C, p, H = v["width"], v["patch_size"], v["heads"]
    w = v["image_res"] // p
    nrel = (2 * w - 1) ** 2 + 3
    spec = []

    def lin(name, out_f, in_f, bias=True):
        spec.append((f"{name}.weight", (out_f, in_f), "normal"))
        if bias:
            spec.append((f"{name}.bias", (out_f,), "normal"))

    def ln(name, dim):
        spec.append((f"{name}.weight", (dim,), "ln"))
        spec.append((f"{name}.bias", (dim,), "normal"))

    ve = "vision_encoder"
    spec.append((f"{ve}.patch_embed.proj.weight", (C, 3, p, p), "normal"))
    spec.append((f"{ve}.patch_embed.proj.bias", (C,), "normal"))
    spec.append((f"{ve}.cls_token", (1, 1, C), "normal"))
    for i in range(v["depth"]):
        b = f"{ve}.blocks.{i}"
        ln(f"{b}.norm1", C)
        lin(f"{b}.attn.qkv", 3 * C, C, bias=False)
        spec.append((f"{b}.attn.q_bias", (C,), "normal"))
        spec.append((f"{b}.attn.v_bias", (C,), "normal"))
        lin(f"{b}.attn.proj", C, C)
        spec.append((f"{b}.attn.relative_position_bias_table", (nrel, H), "normal"))
        spec.append((f"{b}.gamma_1", (C,), "gamma"))
        spec.append((f"{b}.gamma_2", (C,), "gamma"))
        ln(f"{b}.norm2", C)
        lin(f"{b}.mlp.fc1", int(C * v["mlp_ratio"]), C)
        lin(f"{b}.mlp.fc2", C, int(C * v["mlp_ratio"]))
    ln(f"{ve}.fc_norm", C)

    D, I = t["hidden"], t["intermediate"]
    tb = "text_encoder.bert"
    spec.append((f"{tb}.embeddings.word_embeddings.weight", (t["vocab"], D), "normal"))
    spec.append((f"{tb}.embeddings.position_embeddings.weight", (t["max_positions"], D),
                 "normal"))
    spec.append((f"{tb}.embeddings.token_type_embeddings.weight", (t["type_vocab"], D),
                 "normal"))
    ln(f"{tb}.embeddings.LayerNorm", D)
    for i in range(t["layers"]):
        lay = f"{tb}.encoder.layer.{i}"
        attns = ["attention"] + (["crossattention"] if i >= t["fusion_layer"] else [])
        for a in attns:
            kv_in = C if a == "crossattention" else D
            lin(f"{lay}.{a}.self.query", D, D)
            lin(f"{lay}.{a}.self.key", D, kv_in)
            lin(f"{lay}.{a}.self.value", D, kv_in)
            lin(f"{lay}.{a}.output.dense", D, D)
            ln(f"{lay}.{a}.output.LayerNorm", D)
        lin(f"{lay}.intermediate.dense", I, D)
        lin(f"{lay}.output.dense", D, I)
        ln(f"{lay}.output.LayerNorm", D)
    if heads == "pretrain":
        pre = "text_encoder.cls.predictions"
        lin(f"{pre}.transform.dense", D, D)
        ln(f"{pre}.transform.LayerNorm", D)
        spec.append((f"{pre}.bias", (t["vocab"],), "normal"))
    E = model["embed_dim"]
    lin("vision_proj", E, C)
    lin("text_proj", E, D)
    spec.append(("temp", (), "temp"))
    for head, out in (("itm_head", 2),) + ((("bbox_head", 4),) if heads == "pretrain" else ()):
        lin(f"{head}.0", 2 * D, D)
        ln(f"{head}.1", 2 * D)
        lin(f"{head}.3", out, 2 * D)
    return spec


class Reference:
    """X2-VLM's forward passes and pretraining losses over the parameter
    dict ``P`` (reference names, float32). ``model`` is the configuration's
    ``model`` block with ``vision.image_res`` set. Randomness comes from
    the generators a call is given (None: no dropout, no draw)."""

    def __init__(self, P: Dict[str, torch.Tensor], model: Dict, lowp: bool = False):
        self.P, self.m, self.lowp = P, model, lowp
        v = model["vision"]
        self.window = v["image_res"] // v["patch_size"]
        self._rel_index = None

    # ---------- primitives ----------

    def lin(self, x, name, bias=True):
        w = self.P[f"{name}.weight"]
        y = Fp8Linear.apply(x, w) if self.lowp else x @ w.t()
        return y + self.P[f"{name}.bias"] if bias else y

    def ln(self, x, name, eps):
        return F.layer_norm(x, x.shape[-1:], self.P[f"{name}.weight"],
                            self.P[f"{name}.bias"], eps)

    @staticmethod
    def dropout(x, rate, gen):
        if gen is None or rate == 0.0:
            return x
        keep = torch.rand(x.shape, generator=gen, device=x.device) >= rate
        return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))

    @staticmethod
    def drop_path(x, rate, gen):
        if gen is None or rate == 0.0:
            return x
        keep = 1.0 - rate
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        mask = torch.rand(shape, generator=gen, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))

    @staticmethod
    def attend(q, k, v, heads, bias=None, key_mask=None, drop=0.0, gen=None, pad_to=None):
        """Softmax attention over (B, S, H*D) rows; ``key_mask`` (B, Skv)
        nonzero = attend; attention dropout draws a (B, Sq, H * Skv')
        multiplier, Skv' the keys padded to ``pad_to`` as the fusion
        layers lay them out."""
        B, Sq, HD = q.shape
        Skv = k.shape[1]
        D = HD // heads
        q4 = q.view(B, Sq, heads, D).transpose(1, 2) * D ** -0.5
        k4 = k.view(B, Skv, heads, D).transpose(1, 2)
        v4 = v.view(B, Skv, heads, D).transpose(1, 2)
        logits = q4 @ k4.transpose(-1, -2)
        if bias is not None:
            logits = logits + bias
        if key_mask is not None:
            logits = logits.masked_fill((key_mask == 0)[:, None, None, :], NEG)
        p = torch.softmax(logits, dim=-1)
        if gen is not None and drop > 0.0:
            skv = pad_to or Skv
            u = torch.rand((B, Sq, heads * skv), generator=gen, device=q.device)
            keep = (u >= drop).view(B, Sq, heads, skv).transpose(1, 2)[..., :Skv]
            p = p * keep.float() / (1.0 - drop)
        return (p @ v4).transpose(1, 2).reshape(B, Sq, HD)

    # ---------- vision: BEiT-2 ----------

    def rel_index(self, device):
        if self._rel_index is None:
            w = self.window
            coords = torch.stack(torch.meshgrid(torch.arange(w), torch.arange(w),
                                                indexing="ij")).reshape(2, -1)
            rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0)
            rel = (rel[..., 0] + w - 1) * (2 * w - 1) + (rel[..., 1] + w - 1)
            n, nrel = w * w, (2 * w - 1) ** 2 + 3
            idx = torch.zeros(n + 1, n + 1, dtype=torch.long)
            idx[1:, 1:] = rel
            idx[0, :] = nrel - 3
            idx[:, 0] = nrel - 2
            idx[0, 0] = nrel - 1
            self._rel_index = idx.to(device)
        return self._rel_index

    def vision(self, image: torch.Tensor, gen=None) -> torch.Tensor:
        """NHWC uint8 (or normalised float) images -> (B, 1 + N, C): the
        mean of the normed patch tokens, then the patch tokens."""
        v = self.m["vision"]
        P, ve = self.P, "vision_encoder"
        x = image.float()
        if image.dtype == torch.uint8:
            mean = torch.tensor(IMAGE_MEAN, device=x.device)
            std = torch.tensor(IMAGE_STD, device=x.device)
            x = (x / 255.0 - mean) / std
        x = x.permute(0, 3, 1, 2)
        w = P[f"{ve}.patch_embed.proj.weight"]
        p = w.shape[-1]
        B = x.shape[0]
        patches = x.reshape(B, 3, x.shape[2] // p, p, x.shape[3] // p, p)
        patches = patches.permute(0, 2, 4, 1, 3, 5).reshape(B, -1, 3 * p * p)
        x = self._lin_w(patches, w.reshape(w.shape[0], -1), P[f"{ve}.patch_embed.proj.bias"])
        C = x.shape[-1]
        x = torch.cat([P[f"{ve}.cls_token"].expand(B, 1, C), x], dim=1)
        idx = self.rel_index(x.device)
        depth, H = v["depth"], v["heads"]
        rates = torch.linspace(0.0, v["drop_path_rate"], depth).tolist()
        for i in range(depth):
            b = f"{ve}.blocks.{i}"
            h = self.ln(x, f"{b}.norm1", v["ln_eps"])
            wq = P[f"{b}.attn.qkv.weight"]
            qkv = self._lin_w(h, wq, torch.cat([P[f"{b}.attn.q_bias"],
                                                 torch.zeros_like(P[f"{b}.attn.v_bias"]),
                                                 P[f"{b}.attn.v_bias"]]))
            q, k, vv = qkv.split(C, dim=-1)
            bias = P[f"{b}.attn.relative_position_bias_table"][idx].permute(2, 0, 1)[None]
            h = self.lin(self.attend(q, k, vv, H, bias=bias), f"{b}.attn.proj")
            x = x + self.drop_path(h * P[f"{b}.gamma_1"], rates[i], gen)
            h = self.ln(x, f"{b}.norm2", v["ln_eps"])
            h = self.lin(F.gelu(self.lin(h, f"{b}.mlp.fc1")), f"{b}.mlp.fc2")
            x = x + self.drop_path(h * P[f"{b}.gamma_2"], rates[i], gen)
        patches = self.ln(x[:, 1:], f"{ve}.fc_norm", v["ln_eps"])
        return torch.cat([patches.mean(dim=1, keepdim=True), patches], dim=1)

    def _lin_w(self, x, w, b):
        y = Fp8Linear.apply(x, w) if self.lowp else x @ w.t()
        return y + b

    # ---------- text and fusion: BERT ----------

    def text_layers(self, x, atts, lo, hi, gen=None, image=None, image_atts=None,
                    gather=None, deterministic=False):
        """BERT layers [lo, hi) over (B, S, D) rows; layers from the fusion
        layer on cross-attend to ``image`` (unique rows, ``gather`` (B,)
        naming each text row's), padded to a multiple of 8 keys."""
        t = self.m["text"]
        H, eps = t["heads"], t["ln_eps"]
        hd = 0.0 if deterministic else t["hidden_dropout"]
        ad = 0.0 if deterministic else t["attn_dropout"]
        g = None if deterministic else gen
        if image is not None:
            pad = (-image.shape[1]) % 8
            if pad:
                image = F.pad(image, (0, 0, 0, pad))
                image_atts = F.pad(image_atts, (0, pad))
        for i in range(lo, hi):
            lay = f"text_encoder.bert.encoder.layer.{i}"
            a = f"{lay}.attention"
            q, k, v = (self.lin(x, f"{a}.self.{n}") for n in ("query", "key", "value"))
            h = self.attend(q, k, v, H, key_mask=atts, drop=ad, gen=g)
            h = self.dropout(self.lin(h, f"{a}.output.dense"), hd, g)
            x = self.ln(x + h, f"{a}.output.LayerNorm", eps)
            if i >= t["fusion_layer"] and image is not None:
                c = f"{lay}.crossattention"
                q = self.lin(x, f"{c}.self.query")
                k, v = self.lin(image, f"{c}.self.key"), self.lin(image, f"{c}.self.value")
                km = image_atts
                if gather is not None:
                    k, v = k.index_select(0, gather), v.index_select(0, gather)
                h = self.attend(q, k, v, H, key_mask=km, drop=ad, gen=g, pad_to=k.shape[1])
                h = self.dropout(self.lin(h, f"{c}.output.dense"), hd, g)
                x = self.ln(x + h, f"{c}.output.LayerNorm", eps)
            h = self.lin(F.gelu(self.lin(x, f"{lay}.intermediate.dense")), f"{lay}.output.dense")
            x = self.ln(x + self.dropout(h, hd, g), f"{lay}.output.LayerNorm", eps)
        return x

    def text(self, ids, atts, gen=None):
        """The uni-modal text layers over token ids."""
        t = self.m["text"]
        e = "text_encoder.bert.embeddings"
        S = ids.shape[1]
        x = (self.P[f"{e}.word_embeddings.weight"][ids.long()]
             + self.P[f"{e}.position_embeddings.weight"][:S][None]
             + self.P[f"{e}.token_type_embeddings.weight"][0])
        x = self.dropout(self.ln(x, f"{e}.LayerNorm", t["ln_eps"]), t["hidden_dropout"], gen)
        return self.text_layers(x, atts, 0, t["fusion_layer"], gen)

    def fusion(self, text_embeds, text_atts, image, image_atts, gen=None, gather=None,
               deterministic=False):
        t = self.m["text"]
        return self.text_layers(text_embeds, text_atts, t["fusion_layer"], t["layers"], gen,
                                image, image_atts, gather, deterministic)

    def features(self, embeds, proj):
        f = self.lin(embeds[:, 0, :], proj)
        return f / f.norm(dim=-1, keepdim=True)

    def head(self, x, name):
        h = self.ln(self.lin(x, f"{name}.0"), f"{name}.1", 1e-5)
        return self.lin(F.gelu(h), f"{name}.3")

    def temp(self):
        return self.P["temp"].clamp(0.001, 0.5)

    # ---------- pretraining losses ----------

    def hard_negatives(self, image_feat, text_feat, gen):
        """One negative a row, drawn from softmax(similarity / temp) with
        the positives masked (Gumbel-max on ``torch.rand`` uniforms): the
        texts of the images first, then the images of the texts."""
        with torch.no_grad():
            sim = image_feat @ text_feat.t() / self.temp()
            eye = torch.eye(sim.shape[0], dtype=torch.bool, device=sim.device)
            out = []
            for logits in (sim.masked_fill(eye, NEG), sim.t().masked_fill(eye, NEG)):
                u = torch.rand(logits.shape, generator=gen, device=logits.device)
                gumbel = -torch.log(-torch.log(u.clamp(1e-20, 1.0 - 1e-7)))
                out.append(torch.argmax(logits + gumbel, dim=-1))
        text_neg, image_neg = out
        return image_neg, text_neg

    def mlm_loss(self, hidden, masked_pos, masked_ids):
        t = self.m["text"]
        pre = "text_encoder.cls.predictions"
        h = torch.gather(hidden, 1, masked_pos.long()[:, :, None].expand(
            -1, -1, hidden.shape[-1]))
        h = self.ln(F.gelu(self.lin(h, f"{pre}.transform.dense")),
                    f"{pre}.transform.LayerNorm", t["ln_eps"])
        table = self.P["text_encoder.bert.embeddings.word_embeddings.weight"]
        logits = self._lin_w(h, table, self.P[f"{pre}.bias"])
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               masked_ids.reshape(-1).long(), ignore_index=-100)

    def pretrain_losses(self, batch: Dict[str, torch.Tensor], neg_gen=None, drop_gen=None,
                        region: bool = False) -> Dict[str, torch.Tensor]:
        """ITC, ITM with hard negatives and MLM (one fusion pass over
        [pos | (image, text_neg) | (image_neg, text) | (image, masked
        text)]) of an image or, with ``region``, a region-text batch, and
        the region batch's bbox L1 and GIoU losses. The ITC features, drawn
        before any hard negative, are kept in ``last_features``."""
        ids, atts = batch["text_ids"], batch["text_atts"]
        embeds = self.vision(batch["image"], drop_gen)
        if region:
            full = embeds.index_select(0, batch["idx_to_group_img"].long())
            w = batch["image_atts"][:, 1:, None].float()
            pooled = (w * full[:, 1:]).sum(1, keepdim=True) / w.sum(1, keepdim=True).clamp(
                min=1e-6)
            image_embeds = torch.cat([pooled, full[:, 1:]], dim=1)
            image_atts = batch["image_atts"]
        else:
            image_embeds = embeds
            image_atts = torch.ones(embeds.shape[:2], dtype=torch.int32, device=embeds.device)
        both = self.text(torch.cat([ids, batch["text_ids_masked"]]), torch.cat([atts, atts]),
                         drop_gen)
        text_embeds, mlm_embeds = both.chunk(2)
        image_feat = self.features(image_embeds, "vision_proj")
        text_feat = self.features(text_embeds, "text_proj")
        self.last_features = (image_feat.detach(), text_feat.detach())
        logits = image_feat @ text_feat.t() / self.temp()
        labels = torch.arange(logits.shape[0], device=logits.device)
        losses = {"loss_itc": (F.cross_entropy(logits, labels)
                               + F.cross_entropy(logits.t(), labels)) / 2}
        bs = ids.shape[0]
        image_neg, text_neg = self.hard_negatives(image_feat, text_feat, neg_gen)
        ar = torch.arange(bs, device=ids.device)
        gather = torch.cat([ar, ar, image_neg, ar])
        cross = self.fusion(
            torch.cat([text_embeds, text_embeds[text_neg], text_embeds, mlm_embeds]),
            torch.cat([atts, atts[text_neg], atts, atts]), image_embeds,
            image_atts.index_select(0, gather), drop_gen, gather)
        itm_labels = torch.cat([torch.ones(bs, dtype=torch.long, device=ids.device),
                                torch.zeros(2 * bs, dtype=torch.long, device=ids.device)])
        losses["loss_itm"] = F.cross_entropy(self.head(cross[:3 * bs, 0], "itm_head"),
                                             itm_labels)
        losses["loss_mlm"] = self.mlm_loss(cross[3 * bs:], batch["masked_pos"],
                                           batch["masked_ids"])
        if region:
            ones = torch.ones(full.shape[:2], dtype=torch.int32, device=full.device)
            cls = self.fusion(text_embeds, atts, full, ones, deterministic=True)[:, 0]
            coord = torch.sigmoid(self.head(cls, "bbox_head"))
            losses["loss_bbox"], losses["loss_giou"] = bbox_losses(
                coord, batch["target_bbox"].float(), batch["is_image"].float())
        return losses

    # ---------- retrieval ----------

    def encode_images(self, image):
        embeds = self.vision(image)
        return embeds, self.features(embeds, "vision_proj")

    def encode_texts(self, ids, atts):
        embeds = self.text(ids, atts)
        return embeds, self.features(embeds, "text_proj")

    def itm_score(self, image_embeds, text_embeds, text_atts, gather=None):
        """The ITM 'match' logit of each text row against its image row
        (``gather`` (B,) names the image row of each text row)."""
        atts = torch.ones((image_embeds.shape[0], image_embeds.shape[1]), dtype=torch.int32,
                          device=image_embeds.device)
        if gather is not None:
            atts = atts.index_select(0, gather)
        cross = self.fusion(text_embeds, text_atts, image_embeds, atts, gather=gather)
        return self.head(cross[:, 0], "itm_head")[:, 1]


def bbox_losses(coord, target, is_image):
    """(L1, 1 - GIoU) summed over the rows that are not whole-image
    captions, over their count; a degenerate box adds 0 to the GIoU loss."""
    def xyxy(b):
        cx, cy, w, h = b.unbind(-1)
        return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)

    b1, b2 = xyxy(coord), xyxy(target)
    area = lambda b: (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    wh = (torch.minimum(b1[:, 2:], b2[:, 2:]) - torch.maximum(b1[:, :2], b2[:, :2])).clamp(min=0)
    inter = wh[:, 0] * wh[:, 1]
    union = area(b1) + area(b2) - inter
    hull_wh = (torch.maximum(b1[:, 2:], b2[:, 2:]) - torch.minimum(b1[:, :2], b2[:, :2])
               ).clamp(min=0)
    hull = hull_wh[:, 0] * hull_wh[:, 1]
    giou = inter / union - (hull - union) / hull
    bad = (b1[:, 2:] < b1[:, :2]).any(-1) | (b2[:, 2:] < b2[:, :2]).any(-1)
    keep = 1.0 - is_image
    num = keep.sum()
    l1 = ((coord - target).abs() * keep[:, None]).sum() / num
    lg = (torch.where(bad, torch.zeros_like(giou), 1.0 - giou) * keep).sum() / num
    return l1, lg

