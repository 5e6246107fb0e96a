"""BERT text / fusion stack (counterpart of x2vlm_tpu/models/bert.py).

- ``mode='text'`` runs layers [0, fusion_layer)
- ``mode='fusion'`` runs layers [fusion_layer, N) on given embeddings, with
  cross-attention K/V projected from the vision width
- ``mode='multi_modal'`` runs all layers
- cross-attention exists only in layers >= fusion_layer
- decoder mode (``is_decoder``): every layer has a cross-attention and a
  causal self-attention (the VQA answer decoder, ``text_decoder``)

Post-LN layers. Parameter names are the reference's HF BERT names under
``text_encoder.bert`` (``embeddings.*``, ``encoder.layer.N.attention.self.
{query,key,value}``, ``attention.output.{dense,LayerNorm}``,
``crossattention.*``, ``intermediate.dense``, ``output.{dense,LayerNorm}``).
The MLM head is ``text_encoder.cls.predictions.{transform.dense,
transform.LayerNorm, bias}`` with its decoder tied to
``embeddings.word_embeddings.weight``; the answer decoder's stack and head
are the same modules under ``text_decoder``.

The RoBERTa / XLM-R form (the CCLM text tower, ``BertConfig.roberta_base``)
is the text tower with one token type: its stack is ``text_encoder.roberta``
and its head ``text_encoder.lm_head.{dense, layer_norm, bias}``, the
reference's xroberta names. Its position ids start at ``position_offset``
(2: padding_idx + 1), as in the JAX package, which does not skip padded
positions. ``embedding_dim`` narrows the MLM head's transform (the CCLM
bottleneck), and ``tie_word_embeddings=False`` gives the head its own
``decoder`` (an fp32 cross-entropy over its logits, plain, smoothed or
weighted, as the JAX head's untied path computes it).

UniLM captioning (models/captioning.py) passes ``attention_matrix`` (B, Sq,
Skv), which becomes the self-attention's full mask (and'ed with the key
mask), and ``position_ids``; its decode threads a list of per-layer static
caches through the stack (``cache=``; the stack then returns ``(x, new
caches)``). The cross-attention never takes a cache: it attends to the
image keys at every step, as the JAX package does.

With ``remat`` every layer of the text, fusion and decoder stacks (and the
Plus base's cross encoder, a stack too) is rematerialised under
``remat_policy`` (``ops/remat.py``); the static-cache decode never is, as
in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from x2vlm_tpu_torch.device import resolve_device
from x2vlm_tpu_torch.ops.fused_ce import fused_vocab_ce, fused_vocab_ce_weighted, softmax_ce
from x2vlm_tpu_torch.ops.layers import (
    ACTIVATIONS, DropPath, FusedLayerNorm, LayerNorm, MultiHeadAttention, dense,
    dropout, epilogue_act, gelu_exact, layer_norm, linear, serving_only,
)
from x2vlm_tpu_torch.ops.quant import qdense
from x2vlm_tpu_torch.ops.remat import block_call, checkpoint_policy

__all__ = ["BertConfig", "BertEncoder", "BertLayer", "BertMLMHead", "TextEncoder",
           "drop_path_schedule"]


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 18           # text layers + fusion layers
    fusion_layer: int = 12         # first fusion layer
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    encoder_width: int = 768       # width of the cross-attention K/V source
    ln_eps: float = 1e-12
    hidden_dropout: float = 0.1
    attn_dropout: float = 0.1
    position_offset: int = 0       # 2 for RoBERTa / XLM-R
    act: str = "gelu"              # "gelu" (erf) | "gelu_fast" (tanh)
    quant_int8: bool = False       # int8 W8A8 projections and FFN (serving only)
    remat: bool = False            # rematerialise each layer in the backward (ops/remat.py)
    remat_policy: Optional[str] = None  # None / "full" | "dots" | "dots_saveable" | "nothing"
    embedding_dim: Optional[int] = None  # the MLM head's bottleneck width (CCLM)
    tie_word_embeddings: bool = True     # the MLM decoder is the word-embedding table
    is_decoder: bool = False       # causal self-attention, cross-attention in every layer
    text_drop_path_rate: float = 0.0
    cross_drop_path_rate: float = 0.0

    def __post_init__(self):
        checkpoint_policy(self.remat_policy)
        if self.text_drop_path_rate > 0:
            # text drop-path requires cross drop-path and replaces hidden
            # dropout (reference xbert.py:637-641)
            if not self.cross_drop_path_rate > 0:
                raise ValueError("text_drop_path_rate > 0 requires "
                                 "cross_drop_path_rate > 0")
            object.__setattr__(self, "hidden_dropout", 0.0)

    @classmethod
    def bert_base(cls, num_layers=18, fusion_layer=12, encoder_width=768, **kw):
        return cls(num_layers=num_layers, fusion_layer=fusion_layer,
                   encoder_width=encoder_width, **kw)

    @classmethod
    def roberta_base(cls, vocab_size=250002, num_layers=12, fusion_layer=12,
                     encoder_width=768, **kw):
        """XLM-R base (the CCLM text tower): 514 positions from offset 2, one
        token type; ``ln_eps`` stays the JAX preset's 1e-12 (XLM-R's own is
        1e-5; README deviations)."""
        return cls(vocab_size=vocab_size, num_layers=num_layers, fusion_layer=fusion_layer,
                   encoder_width=encoder_width, max_position_embeddings=514,
                   type_vocab_size=1, position_offset=2, **kw)

    @property
    def roberta_form(self) -> bool:
        """The RoBERTa / XLM-R tower (one token type): the reference names
        ``roberta`` and ``lm_head`` instead of ``bert`` and
        ``cls.predictions``."""
        return self.type_vocab_size == 1


def drop_path_schedule(cfg: BertConfig) -> List[float]:
    """Per-layer stochastic-depth rates: linspace(0, text rate) over the text
    layers, then linspace(0, cross rate) over the fusion layers."""
    n_text = min(cfg.fusion_layer, cfg.num_layers)
    n_cross = cfg.num_layers - n_text
    return [float(r) for r in
            list(np.linspace(0.0, cfg.text_drop_path_rate, n_text))
            + list(np.linspace(0.0, cfg.cross_drop_path_rate, n_cross))]


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig, *, dtype: torch.dtype, device):
        super().__init__()
        self.config = cfg
        self.dtype = dtype
        emb = lambda n: torch.nn.utils.skip_init(nn.Embedding, n, cfg.hidden_size,
                                                 device=device)
        self.word_embeddings = emb(cfg.vocab_size)
        self.position_embeddings = emb(cfg.max_position_embeddings)
        self.token_type_embeddings = emb(cfg.type_vocab_size)
        self.LayerNorm = LayerNorm(cfg.hidden_size, cfg.ln_eps, dtype=dtype,
                                   device=device)

    def forward(self, input_ids: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                deterministic: bool = False,
                position_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``position_ids`` (S,) or (B, S), default ``position_offset`` ..
        ``position_offset`` + S - 1 (the UniLM encodings repeat a position
        for a [MASK] and its token)."""
        cfg, dt = self.config, self.dtype
        S = input_ids.shape[1]
        word = F.embedding(input_ids.long(), self.word_embeddings.weight).to(dt)
        if position_ids is None:
            off = cfg.position_offset
            pos = self.position_embeddings.weight[off:off + S].to(dt)[None]
        else:
            pos = F.embedding(position_ids.long(), self.position_embeddings.weight).to(dt)
            if pos.dim() == 2:
                pos = pos[None]
        tok = self.token_type_embeddings.weight[0].to(dt)
        x = self.LayerNorm(word + pos + tok)
        return dropout(x, cfg.hidden_dropout, generator, self.training and not deterministic)


class BertOutput(nn.Module):
    """``dense`` -> dropout -> drop-path -> ``LayerNorm(residual + h)``;
    ``dense`` in int8 with ``quant_int8`` (the attention's output projection,
    which the JAX package keeps inside ``MultiHeadAttention``, and fc2)."""

    def __init__(self, in_dim: int, cfg: BertConfig, *, dtype: torch.dtype, device):
        super().__init__()
        self.dtype = dtype
        self.quant = cfg.quant_int8
        self.dropout_rate = cfg.hidden_dropout
        self.dense = linear(in_dim, cfg.hidden_size, device=device)
        self.LayerNorm = FusedLayerNorm(cfg.hidden_size, cfg.ln_eps, device=device)

    def forward(self, h, residual, drop_path: DropPath,
                generator: Optional[torch.Generator] = None, deterministic: bool = False):
        if self.quant:
            serving_only(self)
            h = qdense(h, self.dense.weight, self.dense.bias, dtype=self.dtype)
        else:
            h = dense(h, self.dense.weight, self.dense.bias, self.dtype)
        h = drop_path(dropout(h, self.dropout_rate, generator,
                              self.training and not deterministic),
                      generator, deterministic)
        return self.LayerNorm((residual + h).to(self.dtype))


class BertAttention(nn.Module):
    """``self``: projections + attention core; ``output``: out projection +
    post-LN residual."""

    def __init__(self, cfg: BertConfig, kv_dim: Optional[int] = None, *,
                 dtype: torch.dtype, device):
        super().__init__()
        self.self = MultiHeadAttention(
            cfg.hidden_size, cfg.num_heads, kv_dim=kv_dim, qkv_bias_mode="full",
            attn_dropout_rate=cfg.attn_dropout, dtype=dtype,
            quant=cfg.quant_int8, device=device)
        self.output = BertOutput(cfg.hidden_size, cfg, dtype=dtype, device=device)

    def forward(self, x, kv=None, *, key_mask=None, drop_path: DropPath,
                generator=None, kv_gather_idx=None, causal: bool = False,
                mask=None, cache=None, deterministic: bool = False):
        """With ``cache``: returns (out, new cache)."""
        h = self.self(x, kv, key_mask=key_mask, generator=generator,
                      kv_gather_idx=kv_gather_idx, causal=causal, mask=mask,
                      cache=cache, deterministic=deterministic)
        if cache is not None:
            h, new_cache = h
            return self.output(h, x, drop_path, generator, deterministic), new_cache
        return self.output(h, x, drop_path, generator, deterministic)


class BertIntermediate(nn.Module):
    """``dense`` -> act; with ``quant_int8`` one int8 launch with the act in
    its epilogue."""

    def __init__(self, cfg: BertConfig, *, dtype: torch.dtype, device):
        super().__init__()
        self.dtype = dtype
        self.quant = cfg.quant_int8
        self.act = ACTIVATIONS[cfg.act]
        self.dense = linear(cfg.hidden_size, cfg.intermediate_size, device=device)

    def forward(self, x):
        if self.quant:
            serving_only(self)
            return qdense(x, self.dense.weight, self.dense.bias,
                          act=epilogue_act(self.act), dtype=self.dtype)
        return self.act(dense(x, self.dense.weight, self.dense.bias, self.dtype))


class BertLayer(nn.Module):
    """Post-LN transformer layer; cross-attention sublayer when ``has_cross``."""

    def __init__(self, cfg: BertConfig, has_cross: bool, drop_path: float = 0.0, *,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        self.attention = BertAttention(cfg, dtype=dtype, device=device)
        self.crossattention = (BertAttention(cfg, kv_dim=cfg.encoder_width,
                                             dtype=dtype, device=device)
                               if has_cross else None)
        self.intermediate = BertIntermediate(cfg, dtype=dtype, device=device)
        self.output = BertOutput(cfg.intermediate_size, cfg, dtype=dtype,
                                 device=device)
        self.drop_path = DropPath(drop_path)
        self.causal = cfg.is_decoder

    def forward(self, x, attention_mask=None, encoder_hidden_states=None,
                encoder_attention_mask=None,
                generator: Optional[torch.Generator] = None,
                encoder_gather_idx: Optional[torch.Tensor] = None,
                deterministic: bool = False, attention_matrix: Optional[torch.Tensor] = None,
                cache=None):
        """``encoder_gather_idx`` (B,): the row of ``encoder_hidden_states``
        each query row attends to (the stream holds only unique rows).
        ``deterministic`` turns dropout and drop-path off in training mode.
        ``attention_matrix`` (B, Sq, Skv), nonzero = attend: the
        self-attention's full mask, and'ed with ``attention_mask``. With
        ``cache`` (this layer's): returns (x, new cache)."""
        full_mask, new_cache = None, None
        if attention_matrix is not None and cache is None:
            full_mask = attention_matrix[:, None] != 0
            if attention_mask is not None:
                full_mask = full_mask & (attention_mask[:, None, None, :] != 0)
        x = self.attention(x, key_mask=attention_mask, drop_path=self.drop_path,
                           generator=generator, causal=self.causal, mask=full_mask,
                           cache=cache, deterministic=deterministic)
        if cache is not None:
            x, new_cache = x
        # cross-attention is skipped (not an error) without an image stream:
        # the text-only path runs the full stack uni-modally
        if self.crossattention is not None and encoder_hidden_states is not None:
            x = self.crossattention(x, encoder_hidden_states.to(self.dtype),
                                    key_mask=encoder_attention_mask,
                                    drop_path=self.drop_path, generator=generator,
                                    kv_gather_idx=encoder_gather_idx,
                                    deterministic=deterministic)
        x = self.output(self.intermediate(x), x, self.drop_path, generator, deterministic)
        return x if cache is None else (x, new_cache)


class _LayerStack(nn.Module):
    """Holds the layers under the reference's name ``encoder.layer``."""

    def __init__(self, layers):
        super().__init__()
        self.layer = nn.ModuleList(layers)


class BertEncoder(nn.Module):
    """The text / fusion / decoder stack. Call with
    mode='text'|'fusion'|'multi_modal'."""

    def __init__(self, config: BertConfig, add_embeddings: bool = True, *,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        device = resolve_device(device)
        cfg = self.config = config
        self.dtype = dtype
        self.embeddings = (BertEmbeddings(cfg, dtype=dtype, device=device)
                           if add_embeddings else None)
        dpr = drop_path_schedule(cfg)
        self.encoder = _LayerStack(
            BertLayer(cfg, has_cross=i >= cfg.fusion_layer or cfg.is_decoder,
                      drop_path=dpr[i], dtype=dtype, device=device)
            for i in range(cfg.num_layers))

    def forward(self, input_ids=None, attention_mask=None, encoder_embeds=None,
                encoder_hidden_states=None, encoder_attention_mask=None,
                mode: str = "multi_modal", generator: Optional[torch.Generator] = None,
                encoder_gather_idx: Optional[torch.Tensor] = None,
                deterministic: bool = False, attention_matrix: Optional[torch.Tensor] = None,
                position_ids: Optional[torch.Tensor] = None, cache=None):
        """``cache``: a list of per-layer static caches, one for each layer
        the mode runs; the stack then returns (x, the new caches)."""
        cfg = self.config
        if mode == "fusion":
            lo, hi = cfg.fusion_layer, cfg.num_layers
            if encoder_embeds is None:
                raise ValueError("mode='fusion' requires encoder_embeds")
            x = encoder_embeds.to(self.dtype)
        elif mode in ("text", "multi_modal"):
            lo, hi = 0, (cfg.fusion_layer if mode == "text" else cfg.num_layers)
            x = (encoder_embeds.to(self.dtype) if encoder_embeds is not None
                 else self.embeddings(input_ids, generator, deterministic, position_ids))
        else:
            raise ValueError(f"mode {mode!r}: one of text, fusion, multi_modal")
        if cache is not None:   # the static-cache decode: no backward, no remat
            new_caches = []
            for li, layer in enumerate(self.encoder.layer[lo:hi]):
                x, layer_cache = layer(x, attention_mask, encoder_hidden_states,
                                       encoder_attention_mask, generator, encoder_gather_idx,
                                       deterministic, attention_matrix, cache[li])
                new_caches.append(layer_cache)
            return x, new_caches
        for layer in self.encoder.layer[lo:hi]:
            x = block_call(layer, x, attention_mask, encoder_hidden_states,
                           encoder_attention_mask, remat=cfg.remat, policy=cfg.remat_policy,
                           generator=generator, encoder_gather_idx=encoder_gather_idx,
                           deterministic=deterministic, attention_matrix=attention_matrix)
        return x


class _MLMTransform(nn.Module):
    """``dense`` -> erf GELU -> ``LayerNorm`` (fp32 statistics)."""

    def __init__(self, cfg: BertConfig, *, device):
        super().__init__()
        dim = cfg.embedding_dim or cfg.hidden_size
        self.dense = linear(cfg.hidden_size, dim, device=device)
        self.LayerNorm = nn.LayerNorm(dim, eps=cfg.ln_eps, device=device)


class BertMLMHead(nn.Module):
    """The MLM head: the transform (dense -> GELU -> LayerNorm, to
    ``embedding_dim`` when set) at the masked positions only, then the tied
    decoder (the word-embedding table passed in, and ``bias``) fused with
    the cross-entropy (``ops/fused_ce.py``), so the (B*M, vocab) logits are
    never held at once; or, with ``tie_word_embeddings=False``, its own
    ``decoder`` and the cross-entropy on its logits, in the same three
    forms (plain, smoothed, weighted). Its names are the reference's:
    ``cls.predictions.{transform.dense, transform.LayerNorm, bias}``, or in
    the RoBERTa form ``lm_head.{dense, layer_norm, bias}``. Counterpart of
    the JAX ``BertMLMHead`` with labels."""

    def __init__(self, cfg: BertConfig, *, dtype: torch.dtype = torch.bfloat16,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        dim = cfg.embedding_dim or cfg.hidden_size
        self.roberta_form = cfg.roberta_form
        if self.roberta_form:
            self.dense = linear(cfg.hidden_size, dim, device=device)
            self.layer_norm = nn.LayerNorm(dim, eps=cfg.ln_eps, device=device)
        else:
            self.transform = _MLMTransform(cfg, device=device)
        self.tied = cfg.tie_word_embeddings
        if self.tied:
            self.bias = nn.Parameter(torch.empty(cfg.vocab_size, device=device))
        else:
            self.decoder = linear(dim, cfg.vocab_size, device=device)

    def init_extra(self, generator: torch.Generator, std: float) -> None:
        if self.tied:
            self.bias.zero_()

    def _transform(self, h: torch.Tensor) -> torch.Tensor:
        dense_, ln = ((self.dense, self.layer_norm) if self.roberta_form
                      else (self.transform.dense, self.transform.LayerNorm))
        h = gelu_exact(dense(h, dense_.weight, dense_.bias, self.dtype))
        return layer_norm(h, ln.weight, ln.bias, ln.eps).to(self.dtype)

    def _decode(self, h: torch.Tensor, embedding_table: Optional[torch.Tensor]) -> torch.Tensor:
        """The decoder in the compute dtype: the tied table or ``decoder``."""
        if self.tied:
            return dense(h, embedding_table, self.bias, self.dtype)
        return dense(h, self.decoder.weight, self.decoder.bias, self.dtype)

    def logits(self, hidden: torch.Tensor, embedding_table: torch.Tensor) -> torch.Tensor:
        """hidden (B, S, C) -> (B, S, vocab) fp32 logits at every position:
        the decoder in the compute dtype, then the cast (the JAX head
        without ``masked_pos`` and labels, as the answer decoder calls it)."""
        return self._decode(self._transform(hidden), embedding_table).float()

    def forward(self, hidden: torch.Tensor, masked_pos: torch.Tensor,
                embedding_table: torch.Tensor, labels: torch.Tensor,
                label_weights: Optional[torch.Tensor] = None,
                label_smoothing: float = 0.0) -> torch.Tensor:
        """hidden (B, S, C), masked_pos / labels (B, M) -> mean MLM loss (fp32)
        over the labels that are not -100; with ``label_smoothing`` the
        smoothed CE (reference model_generation.py:16-50), same mean; with
        ``label_weights`` (B, M) fp32 the weighted sum (rows to drop weigh
        0), the SCST form."""
        h = self._transform(torch.gather(hidden, 1, masked_pos.long()[:, :, None].expand(
            -1, -1, hidden.shape[-1])))
        if not self.tied:
            return self._untied_loss(self._decode(h, None).float(), labels, label_weights,
                                     label_smoothing)
        h = h.reshape(-1, h.shape[-1])
        flat = labels.reshape(-1)
        if label_weights is not None:
            return fused_vocab_ce_weighted(h, embedding_table, self.bias, flat,
                                           label_weights.reshape(-1).float(), label_smoothing)
        return fused_vocab_ce(h, embedding_table, self.bias, flat,
                              torch.ones_like(flat, dtype=torch.bool),
                              smoothing=label_smoothing)

    @staticmethod
    def _untied_loss(logits: torch.Tensor, labels: torch.Tensor,
                     label_weights: Optional[torch.Tensor], label_smoothing: float
                     ) -> torch.Tensor:
        """The untied decoder's (B, M, vocab) fp32 logits -> the loss of the
        JAX head's untied branch: with ``label_weights`` the weighted sum of
        (1 - s) * NLL + s * the mean over the vocab of -log p; with only
        ``label_smoothing`` the smoothed CE's mean; else the plain CE."""
        if label_weights is None:
            if label_smoothing:
                from x2vlm_tpu_torch.models.generation import label_smoothing_loss

                return label_smoothing_loss(logits, labels, smoothing=label_smoothing)
            return softmax_ce(logits, labels)
        logp = torch.log_softmax(logits, dim=-1)
        safe = labels.clamp(0, logits.shape[-1] - 1).long()
        row = (1.0 - label_smoothing) * -torch.gather(logp, -1, safe[..., None])[..., 0]
        if label_smoothing:
            row = row + label_smoothing * -logp.mean(-1)
        return (label_weights.float() * row).sum()


class _MLMPredictions(nn.Module):
    def __init__(self, head: BertMLMHead):
        super().__init__()
        self.predictions = head


class TextEncoder(nn.Module):
    """The text tower under the reference's names: ``text_encoder.bert`` and,
    with ``mlm_head``, ``text_encoder.cls.predictions``; in the RoBERTa
    form ``text_encoder.roberta`` and ``text_encoder.lm_head``
    (:class:`BertMLMHead`, reached as ``.mlm_head``, the stack as
    ``.stack``); the VQA answer decoder (``is_decoder``) is one too, under
    ``text_decoder``."""

    def __init__(self, config: BertConfig, *, dtype: torch.dtype = torch.bfloat16,
                 device=None, mlm_head: bool = False):
        super().__init__()
        stack = BertEncoder(config, dtype=dtype, device=device)
        head = BertMLMHead(config, dtype=dtype, device=device) if mlm_head else None
        if config.roberta_form:
            self.roberta, self.lm_head = stack, head
        else:
            self.bert = stack
            self.cls = None if head is None else _MLMPredictions(head)

    @property
    def stack(self) -> BertEncoder:
        return self.roberta if hasattr(self, "roberta") else self.bert

    @property
    def mlm_head(self) -> Optional[BertMLMHead]:
        if hasattr(self, "roberta"):
            return self.lm_head
        return None if self.cls is None else self.cls.predictions

    def forward(self, *args, **kwargs) -> torch.Tensor:
        return self.stack(*args, **kwargs)
