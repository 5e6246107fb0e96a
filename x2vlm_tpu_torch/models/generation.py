"""VQA as generation (counterpart of ``XVLMForVQA`` in
x2vlm_tpu/models/generation.py; reference models/model_generation.py):
the question runs through the multimodal encoder, and a causal answer
decoder, whose every layer cross-attends to the question states, scores
the answers. Inference ranks an answer list: first-token probabilities ->
top-k -> the chain-rule rerank of the k full answers (``rank_answer``,
vectorised as the JAX package's: one decoder pass a stage).

Like the reference's VQA model it *is* the composition core (the vision
tower and the text / fusion stack, or on the Plus / CCLM base the text
tower and the cross encoder: the JAX base turns the contrastive, matching,
MLM and bbox heads off) plus ``text_decoder``, a :class:`TextEncoder` in
decoder mode with its tied LM head, so the state dict carries the
reference names: ``text_decoder.bert.*`` and
``text_decoder.cls.predictions.*``, or in the RoBERTa / XLM-R form
``text_decoder.roberta.*`` and ``text_decoder.lm_head.*``.

The rank pass scores its Q x k answer rows in chunks of
:func:`rank_chunk_rows` rows, so that its fp32 logits and
log-probabilities stay within ``RANK_CHUNK_BYTES`` whatever the vocabulary
(XLM-R's 250,002 rows at Q = 32, k = 128 would take 78 GB at once); each
row's loss depends on its own row only.

The generation helpers (JAX ``generation.py:47, 177-257``):
``label_smoothing_loss``, ``top_k_top_p_filtering`` and ``sample_generate``,
the answer decoder's token-by-token decode with the static cache, its
draws from an explicit ``torch.Generator`` (or injected Gumbel noise).
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from x2vlm_tpu_torch.core import mesh
from x2vlm_tpu_torch.models.bert import TextEncoder
from x2vlm_tpu_torch.models.xvlm import XVLMBase, XVLMConfig
from x2vlm_tpu_torch.ops.layers import static_caches

__all__ = ["XVLMForVQA", "RANK_CHUNK_BYTES", "causal_lm_loss",
           "decoder_params_from_text_encoder", "gumbel_noise", "inference",
           "label_smoothing_loss", "rank_chunk_rows", "sample_generate", "top_k",
           "top_k_top_p_filtering"]

# the rank pass's fp32 logits and log-probabilities of one chunk of rows
RANK_CHUNK_BYTES = 10 * 2 ** 30


def rank_chunk_rows(answer_len: int, vocab_size: int) -> int:
    """Rows a chunk of the rank pass decodes: the largest power of two
    whose fp32 logits and log-probabilities (4 bytes each a row, position
    and vocabulary entry) fit in ``RANK_CHUNK_BYTES``; at least 1. 4,096 at
    BERT's 30,522 rows and 10 tokens (VQAv2's whole rank pass), 512 at
    XLM-R's 250,002."""
    rows = max(1, RANK_CHUNK_BYTES // (2 * 4 * answer_len * vocab_size))
    return 1 << (rows.bit_length() - 1)


def causal_lm_loss(logits: torch.Tensor, labels: torch.Tensor,
                   ignore_index: int = -100) -> torch.Tensor:
    """Next-token cross-entropy summed per row (fp32): logits (B, L, V),
    labels (B, L) aligned to the inputs, label[t] the target of position t
    (the shift is made here); labels equal to ``ignore_index`` add 0."""
    logits = logits[:, :-1, :].float()
    targets = labels[:, 1:]
    valid = targets != ignore_index
    safe = torch.where(valid, targets, torch.zeros_like(targets)).long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return torch.where(valid, nll, torch.zeros_like(nll)).sum(-1)


def label_smoothing_loss(logits: torch.Tensor, labels: torch.Tensor, smoothing: float = 0.1,
                         ignore_index: int = -100) -> torch.Tensor:
    """Smoothed CE averaged over the valid positions (fp32; reference
    model_generation.py:16-50): (1 - s) * NLL + s * the mean over the vocab
    of -log p; in a step at world N over the global count."""
    logits = logits.float()
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    loss = (1.0 - smoothing) * nll + smoothing * (-logp.mean(-1))
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    return loss.sum() / mesh.batch_denominator(valid.sum())


def top_k_top_p_filtering(logits: torch.Tensor, top_k: int = 0,
                          top_p: float = 1.0) -> torch.Tensor:
    """(B, V) fp32 logits with everything outside the ``top_k`` largest and
    the nucleus of mass ``top_p`` set to -1e30 (reference xbert.py:1521;
    the first token is always kept)."""
    neg = torch.full((), -1e30, dtype=logits.dtype, device=logits.device)
    if top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = torch.where(logits < kth, neg, logits)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cut = torch.cumsum(probs, dim=-1) - probs > top_p
        cutoff = torch.where(cut, torch.full_like(sorted_logits, float("inf")),
                             sorted_logits).min(-1, keepdim=True).values
        logits = torch.where(logits < cutoff, neg, logits)
    return logits


# noise(t, shape) -> fp32 Gumbel noise on the logits' device for draw t
Noise = Callable[[int, Tuple[int, ...]], torch.Tensor]


@contextlib.contextmanager
def inference(model: torch.nn.Module):
    """No autograd and eval mode (dropout off) for a decode, the mode
    restored after."""
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            yield
    finally:
        model.train(was_training)


def gumbel_noise(generator: Optional[torch.Generator], device) -> Noise:
    """Gumbel noise -log(-log(u)) from ``generator``: ``argmax(logits +
    noise)`` is a categorical draw, as ``jax.random.categorical`` draws."""
    tiny = torch.finfo(torch.float32).tiny

    def noise(t: int, shape: Tuple[int, ...]) -> torch.Tensor:
        u = torch.rand(shape, generator=generator, device=device).clamp_(min=tiny)
        return -torch.log(-torch.log(u))

    return noise


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the ``k`` largest along the last dim, equal
    values in index order, as ``jax.lax.top_k`` gives them (answers that
    share a first token tie in the first stage)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


class XVLMForVQA(XVLMBase):
    def __init__(self, config: Optional[XVLMConfig] = None, *, num_dec_layers: int = 6,
                 pad_token_id: int = 0, dtype: torch.dtype = torch.bfloat16, device=None,
                 seed: Optional[int] = 0):
        super().__init__(config, dtype=dtype, device=device, seed=None, projections=False,
                         temp=False, itm_head=False)
        text = self.config.text
        self.num_dec_layers = num_dec_layers
        self.pad_token_id = pad_token_id
        self.dec_config = dataclasses.replace(
            text, num_layers=num_dec_layers, fusion_layer=0, encoder_width=text.hidden_size,
            is_decoder=True)
        self.text_decoder = TextEncoder(self.dec_config, dtype=dtype,
                                        device=self.device,
                                        mlm_head=True)
        self.fill(seed)

    def encode_question(self, image: torch.Tensor, text_ids: torch.Tensor,
                        text_atts: torch.Tensor,
                        dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, L, C) question states: the fusion stack over the question and
        the image."""
        image_embeds, image_atts = self.get_vision_embeds(image, dropout_generator)
        return self.get_cross_embeds(image_embeds, image_atts, text_ids=text_ids,
                                     text_atts=text_atts, generator=dropout_generator)

    def decode_logits(self, answer_ids: torch.Tensor, answer_atts: torch.Tensor,
                      question_states: torch.Tensor, question_atts: torch.Tensor,
                      dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(A, La, vocab) fp32 logits of the causal decoder over the answer
        rows, each row attending to its question's states."""
        dec = self.text_decoder
        h = dec(answer_ids, attention_mask=answer_atts, encoder_hidden_states=question_states,
                encoder_attention_mask=question_atts, generator=dropout_generator)
        return dec.mlm_head.logits(h, dec.stack.embeddings.word_embeddings.weight)

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None,
                dropout_generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """batch: image, question_ids / question_atts (B rows), answer_ids /
        answer_atts / answer_weights / answer_index (the flattened answers,
        ``answer_index`` naming each one's question) -> {loss_vqa}: the
        answers' summed next-token losses weighted by ``answer_weights``,
        over the image count. ``generator`` is unused (no draw but
        dropout's)."""
        states = self.encode_question(batch["image"], batch["question_ids"],
                                      batch["question_atts"], dropout_generator)
        idx = batch["answer_index"].long()
        answer_ids = batch["answer_ids"]
        targets = torch.where(answer_ids == self.pad_token_id,
                              torch.full_like(answer_ids, -100), answer_ids)
        logits = self.decode_logits(answer_ids, batch["answer_atts"],
                                    states.index_select(0, idx),
                                    batch["question_atts"].index_select(0, idx),
                                    dropout_generator)
        per_answer = causal_lm_loss(logits, targets)
        loss = (batch["answer_weights"].float() * per_answer).sum() / batch["image"].shape[0]
        return {"loss_vqa": loss}

    def rank_answer(self, question_states: torch.Tensor, question_atts: torch.Tensor,
                    answer_ids: torch.Tensor, answer_atts: torch.Tensor, k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """question_states (Q, Lq, C); answer_ids / answer_atts (A, La), the
        tokenised answer list, row 0's first token the BOS. The first-token
        probabilities of every answer, the ``k`` best, each scored by its
        first-token log-probability less its sequence loss, reranked by
        the softmax of that; the Q x k full answers are decoded in chunks
        of :func:`rank_chunk_rows` rows. Returns (answer indices (Q, k),
        probabilities (Q, k)), the best first."""
        num_q = question_states.shape[0]
        bos = answer_ids[0, :1].expand(num_q, 1)
        logits0 = self.decode_logits(bos, torch.ones_like(bos), question_states,
                                     question_atts)[:, 0, :]
        probs0 = torch.softmax(logits0.float(), dim=-1)
        prob_first = probs0[:, answer_ids[:, 1].long()]                 # (Q, A)
        topk_probs, topk_ids = top_k(prob_first, k)

        flat = topk_ids.reshape(-1)
        input_ids = answer_ids.index_select(0, flat)
        input_atts = answer_atts.index_select(0, flat)
        targets = torch.where(input_ids == self.pad_token_id,
                              torch.full_like(input_ids, -100), input_ids)
        rows = rank_chunk_rows(input_ids.shape[1], self.dec_config.vocab_size)
        losses = []
        for lo in range(0, flat.shape[0], rows):
            q = torch.arange(lo, min(lo + rows, flat.shape[0]), device=flat.device) // k
            logits = self.decode_logits(input_ids[lo:lo + rows], input_atts[lo:lo + rows],
                                        question_states.index_select(0, q),
                                        question_atts.index_select(0, q))
            losses.append(causal_lm_loss(logits, targets[lo:lo + rows]))
            del logits
        answer_loss = torch.cat(losses).reshape(num_q, k)
        probs = torch.softmax(torch.log(topk_probs) - answer_loss, dim=-1)
        topk_probs2, rerank = top_k(probs, k)
        return torch.gather(topk_ids, 1, rerank), topk_probs2

    def predict(self, batch: Dict[str, torch.Tensor], k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """batch: image, question_ids / question_atts, answer_ids /
        answer_atts (the answer list) -> ``rank_answer``."""
        states = self.encode_question(batch["image"], batch["question_ids"],
                                      batch["question_atts"])
        return self.rank_answer(states, batch["question_atts"], batch["answer_ids"],
                                batch["answer_atts"], k)


def decoder_params_from_text_encoder(state: Mapping[str, torch.Tensor], *,
                                     num_text_layers: int, num_cross_layers: int,
                                     num_dec_layers: int) -> Dict[str, torch.Tensor]:
    """The decoder's parameters from a pretrained text encoder's state dict
    (reference load surgery, model_generation.py:454-512; the JAX
    function on the reference names): decoder layer j <- fusion layer j,
    or every other fusion layer (2 j + 1) when ``num_dec_layers`` is half
    ``num_cross_layers``; the embeddings and the MLM head as they are. The
    fusion layers are the text stack's from ``num_text_layers`` on
    (``text_encoder.bert.encoder.layer.{num_text_layers + i}``), or on the
    Plus / CCLM base the cross encoder's (``cross_encoder.encoder.layer.
    {i}``); in the RoBERTa / XLM-R form ``text_encoder.roberta.*`` and
    ``text_encoder.lm_head.*`` go to ``text_decoder.roberta.*`` and
    ``text_decoder.lm_head.*``."""
    if num_dec_layers == num_cross_layers:
        src = list(range(num_dec_layers))
    elif num_dec_layers == num_cross_layers // 2:
        src = [2 * j + 1 for j in range(num_dec_layers)]
    else:
        raise ValueError("initialization not implemented")
    layer_of = {s: j for j, s in enumerate(src)}
    plus = any(k.startswith("cross_encoder.encoder.layer.") for k in state)
    stack = "roberta" if any(k.startswith("text_encoder.roberta.") for k in state) else "bert"
    fusion = re.compile(r"cross_encoder\.encoder\.layer\.(\d+)\.(.*)" if plus else
                        rf"text_encoder\.{stack}\.encoder\.layer\.(\d+)\.(.*)")
    first = 0 if plus else num_text_layers
    out = {}
    for k, v in state.items():
        if k.startswith((f"text_encoder.{stack}.embeddings.", "text_encoder.cls.",
                         "text_encoder.lm_head.")):
            out["text_decoder." + k[len("text_encoder."):]] = v
        elif (m := fusion.fullmatch(k)) and int(m.group(1)) - first in layer_of:
            out[f"text_decoder.{stack}.encoder.layer.{layer_of[int(m.group(1)) - first]}."
                f"{m.group(2)}"] = v
    return out


def sample_generate(model: XVLMForVQA, batch: Dict[str, torch.Tensor], *, max_length: int,
                    bos_token_id: int, eos_token_id: int, pad_token_id: int = 0,
                    temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0,
                    greedy: bool = False, generator: Optional[torch.Generator] = None,
                    noise: Optional[Noise] = None) -> np.ndarray:
    """Token-by-token decode of the answer decoder with its static cache
    (reference xbert.py:1427 ``_generate_no_beam_search``; the JAX
    ``sample_generate``): from BOS, ``max_length`` tokens, each the argmax
    (``greedy``) or a draw ``argmax(filtered logits + noise(t, shape))``
    (Gumbel noise from ``generator`` unless ``noise`` is given). Returns
    (B, max_length) int64 on the host, PAD after a row's EOS; stops when
    every row has ended."""
    image = batch["image"]
    B, dev = image.shape[0], image.device
    tcfg = model.config.text
    noise = noise or gumbel_noise(generator, dev)
    dec = model.text_decoder
    table = dec.stack.embeddings.word_embeddings.weight
    out = np.full((B, max_length), pad_token_id, np.int64)
    done = np.zeros(B, bool)
    with inference(model):
        states = model.encode_question(image, batch["question_ids"], batch["question_atts"])
        cache = static_caches(model.num_dec_layers, B, tcfg.num_heads, max_length,
                              tcfg.hidden_size // tcfg.num_heads, model.dtype, dev)
        tok = torch.full((B, 1), bos_token_id, dtype=torch.long, device=dev)
        for t in range(max_length):
            h, cache = dec(tok, position_ids=torch.arange(t, t + 1, device=dev),
                           encoder_hidden_states=states,
                           encoder_attention_mask=batch["question_atts"],
                           cache=[dict(c, index=t) for c in cache], deterministic=True)
            logits = dec.mlm_head.logits(h[:, -1:, :], table)[:, 0].float()
            logits = logits / max(temperature, 1e-6)
            if greedy:
                nxt = torch.argmax(logits, dim=-1)
            else:
                logits = top_k_top_p_filtering(logits, top_k=top_k, top_p=top_p)
                nxt = torch.argmax(logits + noise(t, tuple(logits.shape)), dim=-1)
            nxt = np.where(done, pad_token_id, nxt.cpu().numpy())
            out[:, t] = nxt
            done |= nxt == eos_token_id
            if done.all():
                break
            tok = torch.from_numpy(nxt[:, None]).to(dev)
    return out
