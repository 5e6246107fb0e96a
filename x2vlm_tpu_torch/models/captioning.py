"""UniLM-style MLM captioning (counterpart of x2vlm_tpu/models/captioning.py;
reference models/model_generation.py:53-397 ``XVLMForMLMCaptioning``).

Training: the caption with masked slots, a triangular (B, L, L) attention
matrix (the self-attentions' full mask, so they run the plain attention
core), and the label-smoothed CE over the masked slots (``loss_caption``);
with ``sample_weights`` in the batch the SCST policy gradient
(``loss_scst``): each row's mean NLL over its masked slots, weighted by its
advantage, averaged over the batch.

Generation appends a [MASK] after the last token and predicts it. The
reference's growing ``history_states`` are per-layer static K / V caches
(``init_cache``; ``decode_step`` writes its tokens at ``index ..`` and
rewrites the trailing [MASK] slot the next step). The cross-attention
recomputes the image keys at every step, as the JAX package does.

- :func:`beam_search_generate_device`: the beam search as one Python loop
  of launches, the histories kept on the card; the top-K x K merge, EOS
  freezing, n-gram blocking and the ``-10000`` masks follow the JAX device
  search exactly, ties broken by index (``generation.top_k``, as
  ``lax.top_k``). Nothing is read back before the traceback.
- :func:`beam_search_generate`: the host-driven variant (numpy
  bookkeeping, the reference's algorithm op for op), kept for
  cross-checking as in the JAX package.
- :func:`sample_generate_captioning`: categorical rollouts for SCST, the
  draws from an explicit ``torch.Generator`` (or injected Gumbel noise).

The image stream is padded to a multiple of 8 keys (577 -> 584 at 384 px)
with masked positions, as ``get_cross_embeds`` pads it; the JAX model
attends to the 577 keys unpadded, which gives the same result.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from x2vlm_tpu_torch.models.generation import Noise, gumbel_noise, inference, top_k
from x2vlm_tpu_torch.models.xvlm import XVLMBase, XVLMConfig
from x2vlm_tpu_torch.ops.layers import static_caches

__all__ = ["XVLMForMLMCaptioning", "beam_search_generate", "beam_search_generate_device",
           "sample_generate_captioning"]

class XVLMForMLMCaptioning(XVLMBase):
    """The composition core with the MLM head only (no projections, temp,
    ITM or bbox head: the JAX base turns them off), under the reference
    names ``vision_encoder.*`` and ``text_encoder.{bert,cls.predictions}.*``."""

    def __init__(self, config: Optional[XVLMConfig] = None, *, label_smoothing: float = 0.1,
                 cls_token_id: int = 101, dtype: torch.dtype = torch.bfloat16, device=None,
                 seed: Optional[int] = 0):
        super().__init__(config, dtype=dtype, device=device, seed=seed, mlm_head=True,
                         projections=False, temp=False, itm_head=False)
        self.label_smoothing = label_smoothing
        self.cls_token_id = cls_token_id   # never a target (reference :74-76)

    def _image_stream(self, image: torch.Tensor, generator=None):
        embeds, atts = self.get_vision_embeds(image, generator)
        pad = (-embeds.shape[1]) % 8
        if pad:
            embeds = F.pad(embeds, (0, 0, 0, pad))
            atts = F.pad(atts, (0, pad))
        return embeds, atts

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None,
                dropout_generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """batch: image, text_ids_masked, text_atts_matrix, position_ids,
        masked_pos, masked_ids, masked_weight (and for SCST
        sample_weights) -> {loss_caption} or {loss_scst}. ``generator`` is
        unused (no draw but dropout's)."""
        image_embeds, image_atts = self._image_stream(batch["image"], dropout_generator)
        hidden = self.text_encoder(batch["text_ids_masked"],
                                   attention_matrix=batch["text_atts_matrix"],
                                   position_ids=batch.get("position_ids"),
                                   encoder_hidden_states=image_embeds,
                                   encoder_attention_mask=image_atts, mode="multi_modal",
                                   generator=dropout_generator)
        ignore = torch.full_like(batch["masked_ids"], -100)
        labels = torch.where(batch["masked_weight"] > 0, batch["masked_ids"], ignore)
        labels = torch.where(labels == self.cls_token_id, ignore, labels)
        head = self.text_encoder.mlm_head
        table = self.text_encoder.stack.embeddings.word_embeddings.weight
        if batch.get("sample_weights") is not None:
            # w[b, m] = valid / row count * advantage[b] / B: one weighted sum
            valid = (labels != -100).float()
            rows = valid.sum(-1, keepdim=True).clamp(min=1.0)
            w = valid / rows * (batch["sample_weights"].float()[:, None] / labels.shape[0])
            return {"loss_scst": head(hidden, batch["masked_pos"], table, labels,
                                      label_weights=w)}
        return {"loss_caption": head(hidden, batch["masked_pos"], table, labels,
                                     label_smoothing=self.label_smoothing)}

    # ---- decoding primitives ----

    def encode_image(self, image: torch.Tensor):
        """(image embeds padded to a multiple of 8 keys, their mask)."""
        return self._image_stream(image)

    def init_cache(self, batch_size: int, max_len: int) -> List[Dict]:
        """One zeroed static cache per text layer: ``k`` / ``v`` (B, H,
        max_len, D) in the compute dtype, ``index`` 0."""
        cfg = self.config.text
        return static_caches(cfg.num_layers, batch_size, cfg.num_heads, max_len,
                             cfg.hidden_size // cfg.num_heads, self.dtype,
                             self.device)

    def decode_step(self, x_ids: torch.Tensor, index: int, cache: List[Dict],
                    image_embeds: torch.Tensor, image_atts: torch.Tensor):
        """Run [tokens..., MASK] (B, T) at positions index .. index+T-1, their
        K / V written into the caches at those slots. Returns (fp32 logits of
        the last slot (B, vocab), the new caches)."""
        pos = torch.arange(index, index + x_ids.shape[1], device=x_ids.device)
        cache = [dict(c, index=index) for c in cache]
        hidden, new_cache = self.text_encoder(
            x_ids, position_ids=pos, encoder_hidden_states=image_embeds,
            encoder_attention_mask=image_atts, mode="multi_modal", cache=cache,
            deterministic=True)
        head = self.text_encoder.mlm_head
        logits = head.logits(hidden[:, -1:, :],
                             self.text_encoder.stack.embeddings.word_embeddings.weight)
        return logits[:, 0, :], new_cache


def _expand(x: torch.Tensor, k: int) -> torch.Tensor:
    return x.repeat_interleave(k, dim=0)


def _select_cache(cache: List[Dict], idx: torch.Tensor) -> List[Dict]:
    return [dict(c, k=c["k"].index_select(0, idx), v=c["v"].index_select(0, idx))
            for c in cache]


def _prompt_frame(prompt_ids: Sequence[int], mask_token_id: int, rows: int, device):
    return torch.tensor(list(prompt_ids) + [mask_token_id], dtype=torch.long,
                        device=device).expand(rows, -1)


def _ngram_forbid(seqs: torch.Tensor, t: int, ngram_size: int, vocab: int) -> torch.Tensor:
    """(N, vocab) 0 / 1: the tokens that would complete an n-gram already in
    ``seqs[:, :t]`` (the JAX device search's static window loop: window i
    counts only when its continuation ``i + n - 1`` is before ``t``)."""
    n1 = ngram_size - 1
    forbid = torch.zeros(seqs.shape[0], vocab, device=seqs.device)
    if t - n1 <= 0:
        return forbid
    tail = seqs[:, t - n1:t]
    wins = seqs[:, :t - 1].unfold(1, n1, 1)[:, :t - n1]            # (N, t-n1, n1)
    match = (wins == tail[:, None, :]).all(-1).float()               # (N, t-n1)
    return forbid.scatter_add_(1, seqs[:, n1:t], match).clamp_(max=1.0)


def _device_search(model, image, prompt_ids, *, mask_token_id, eos_token_id, num_beams,
                   min_length, max_length, forbid_duplicate_ngrams, ngram_size):
    """(ids, back pointers, scores) histories, each (steps, B, K), on the
    image's device."""
    B, K = image.shape[0], num_beams
    P = len(prompt_ids)
    steps = max_length
    dev = image.device
    img_embeds, img_atts = model.encode_image(image)
    cache = model.init_cache(B, P + max_length + 1)
    logits, cache = model.decode_step(_prompt_frame(prompt_ids, mask_token_id, B, dev), 0,
                                      cache, img_embeds, img_atts)
    logp = torch.log_softmax(logits.float(), dim=-1)
    V = logp.shape[-1]
    if min_length >= 1:
        logp[:, eos_token_id] = -10000.0
    k_scores, k_ids = top_k(logp, K)                                 # (B, K)
    cache = [dict(c, k=_expand(c["k"], K), v=_expand(c["v"], K)) for c in cache]
    img_embeds, img_atts = _expand(img_embeds, K), _expand(img_atts, K)

    ids_hist = torch.zeros((steps, B, K), dtype=torch.long, device=dev)
    ptr_hist = torch.zeros_like(ids_hist)
    score_hist = torch.zeros((steps, B, K), dtype=torch.float32, device=dev)
    eos_hist = torch.zeros((steps, B, K), dtype=torch.bool, device=dev)
    ids_hist[0], score_hist[0], eos_hist[0] = k_ids, k_scores, k_ids == eos_token_id
    seqs = torch.zeros((B * K, steps), dtype=torch.long, device=dev)
    seqs[:, 0] = k_ids.reshape(-1)
    masks = torch.full((B * K, 1), mask_token_id, dtype=torch.long, device=dev)
    rows = torch.arange(B, device=dev)[:, None] * K
    for t in range(1, steps):
        x = torch.cat([seqs[:, t - 1:t], masks], 1)
        logits, cache = model.decode_step(x, P + t - 1, cache, img_embeds, img_atts)
        logp = torch.log_softmax(logits.float(), dim=-1)
        if forbid_duplicate_ngrams and ngram_size >= 2:
            logp = logp - _ngram_forbid(seqs, t, ngram_size, V) * 10000.0
        if min_length and t + 1 <= min_length:
            logp[:, eos_token_id] = -10000.0
        kk_scores, kk_idx = top_k(logp, K)                           # (B*K, K)
        last_eos = eos_hist[t - 1].reshape(B * K, 1)
        last_scores = score_hist[t - 1].reshape(B * K, 1)
        kk_scores = (kk_scores + torch.where(last_eos, -10000.0, 0.0) + last_scores
                     ).reshape(B, K * K)
        k_scores, sel = top_k(kk_scores, K)                          # (B, K)
        back_ptrs = torch.div(sel, K, rounding_mode="floor")
        k_ids = torch.gather(kk_idx.reshape(B, K * K), 1, sel)
        flat = (rows + back_ptrs).reshape(-1)
        cache = _select_cache(cache, flat)
        seqs = seqs.index_select(0, flat)
        seqs[:, t] = k_ids.reshape(-1)
        ids_hist[t], ptr_hist[t], score_hist[t] = k_ids, back_ptrs, k_scores
        eos_hist[t] = k_ids == eos_token_id
    return ids_hist, ptr_hist, score_hist


def beam_search_generate_device(
    model: XVLMForMLMCaptioning, image: torch.Tensor, prompt_ids: Sequence[int], *,
    mask_token_id: int, eos_token_id: int, num_beams: int = 3, min_length: int = 5,
    max_length: int = 20, length_penalty: float = 0.0, forbid_duplicate_ngrams: bool = True,
    ngram_size: int = 3,
) -> List[List[int]]:
    """Beam search on the image's device: ``max_length`` frames (frame 0 the
    prompt with its [MASK], then one token and a [MASK] a frame), the
    (steps, B, K) histories read back once for the host traceback. Returns
    the best token list of each image (without the prompt or the EOS)."""
    with inference(model):
        hist = _device_search(model, image, prompt_ids, mask_token_id=mask_token_id,
                              eos_token_id=eos_token_id, num_beams=num_beams,
                              min_length=min_length, max_length=max_length,
                              forbid_duplicate_ngrams=forbid_duplicate_ngrams,
                              ngram_size=ngram_size)
    ids, ptrs, scores = (list(h.cpu().numpy()) for h in hist)
    return _trace_back(image.shape[0], ids, ptrs, scores, eos_token_id, length_penalty)


def _trace_back(B, step_ids, step_back_ptrs, total_scores, eos_token_id,
                length_penalty) -> List[List[int]]:
    """The host traceback of the best sequence per image (reference
    :330-375; the JAX ``_trace_back``)."""
    outputs = []
    for b in range(B):
        scores = [t[b] for t in total_scores]
        wids_list = [t[b] for t in step_ids]
        ptrs = [t[b] for t in step_back_ptrs]
        last_frame_id = len(scores) - 1
        for i, wids in enumerate(wids_list):
            if all(int(w) == eos_token_id for w in wids):
                last_frame_id = i
                break
        max_score, frame_id, pos_in_frame = -math.inf, -1, -1
        for fid in range(last_frame_id + 1):
            for i, wid in enumerate(wids_list[fid]):
                if int(wid) == eos_token_id or fid == last_frame_id:
                    s = float(scores[fid][i])
                    if length_penalty > 0:
                        s /= math.pow((5 + fid + 1) / 6.0, length_penalty)
                    if s > max_score:
                        max_score, frame_id, pos_in_frame = s, fid, i
        if frame_id == -1:
            outputs.append([0])
            continue
        seq = [int(wids_list[frame_id][pos_in_frame])]
        for fid in range(frame_id, 0, -1):
            pos_in_frame = int(ptrs[fid][pos_in_frame])
            seq.append(int(wids_list[fid - 1][pos_in_frame]))
        seq.reverse()
        if seq and seq[-1] == eos_token_id:
            seq = seq[:-1]
        outputs.append(seq)
    return outputs


def beam_search_generate(
    model: XVLMForMLMCaptioning, image: torch.Tensor, prompt_ids: Sequence[int], *,
    mask_token_id: int, eos_token_id: int, num_beams: int = 3, min_length: int = 5,
    max_length: int = 20, length_penalty: float = 0.0, forbid_duplicate_ngrams: bool = True,
    ngram_size: int = 3,
) -> List[List[int]]:
    """The host-driven beam search: each frame's log-probabilities read
    back and merged in numpy, as the JAX ``beam_search_generate`` (the
    reference's algorithm op for op; ``np.argsort`` breaks ties as there)."""
    B, K = image.shape[0], num_beams
    P = len(prompt_ids)
    dev = image.device
    with inference(model):
        img_embeds, img_atts = model.encode_image(image)
        cache = model.init_cache(B, P + max_length + 1)
        logits, cache = model.decode_step(_prompt_frame(prompt_ids, mask_token_id, B, dev),
                                          0, cache, img_embeds, img_atts)
        log_scores = torch.log_softmax(logits.float(), dim=-1).cpu().numpy().copy()
        total_scores, beam_masks, step_ids, step_back_ptrs = [], [], [], []
        if min_length >= 1:
            log_scores[:, eos_token_id] = -10000.0
        k_ids = np.argsort(-log_scores, axis=-1)[:, :K]
        k_scores = np.take_along_axis(log_scores, k_ids, axis=-1)
        step_ids.append(k_ids)
        step_back_ptrs.append(np.zeros((B, K), np.int64))
        beam_masks.append((k_ids == eos_token_id).astype(np.float32))
        total_scores.append(k_scores)
        partial_seqs = [[int(k_ids[b, k])] for b in range(B) for k in range(K)]
        cache = [dict(c, k=_expand(c["k"], K), v=_expand(c["v"], K)) for c in cache]
        img_embeds, img_atts = _expand(img_embeds, K), _expand(img_atts, K)

        next_pos = P + 1
        forbid_word_mask = None
        while next_pos < P + max_length:
            curr = np.asarray([s[-1] for s in partial_seqs], np.int64).reshape(B * K, 1)
            x = np.concatenate([curr, np.full((B * K, 1), mask_token_id, np.int64)], 1)
            logits, cache = model.decode_step(torch.from_numpy(x).to(dev), next_pos - 1,
                                              cache, img_embeds, img_atts)
            log_scores = torch.log_softmax(logits.float(), dim=-1).cpu().numpy().copy()
            if forbid_word_mask is not None:
                log_scores += forbid_word_mask * -10000.0
            if min_length and (next_pos - P + 1 <= min_length):
                log_scores[:, eos_token_id] = -10000.0
            kk_idx = np.argsort(-log_scores, axis=-1)[:, :K]
            kk_scores = np.take_along_axis(log_scores, kk_idx, axis=-1)
            last_eos = beam_masks[-1].reshape(B * K, 1)
            last_seq_scores = total_scores[-1].reshape(B * K, 1)
            kk_scores = kk_scores + last_eos * -10000.0 + last_seq_scores
            kk_scores = kk_scores.reshape(B, K * K)
            kk_ids_flat = kk_idx.reshape(B, K * K)
            sel = np.argsort(-kk_scores, axis=-1)[:, :K]
            k_scores = np.take_along_axis(kk_scores, sel, axis=-1)
            back_ptrs = sel // K
            k_ids = np.take_along_axis(kk_ids_flat, sel, axis=-1)
            step_back_ptrs.append(back_ptrs)
            step_ids.append(k_ids)
            beam_masks.append((k_ids == eos_token_id).astype(np.float32))
            total_scores.append(k_scores)
            flat = (np.arange(B)[:, None] * K + back_ptrs).reshape(-1)
            cache = _select_cache(cache, torch.from_numpy(flat).to(dev))
            partial_seqs = [partial_seqs[int(back_ptrs[b, k]) + b * K] + [int(k_ids[b, k])]
                            for b in range(B) for k in range(K)]
            if forbid_duplicate_ngrams and len(partial_seqs[0]) >= ngram_size:
                V = log_scores.shape[-1]
                buf = np.zeros((B * K, V), np.float32)
                any_dup = False
                for bk, seq in enumerate(partial_seqs):
                    tail = seq[-(ngram_size - 1):] if ngram_size > 1 else []
                    for i in range(len(seq) - (ngram_size - 1)):
                        if seq[i:i + ngram_size - 1] == tail:
                            buf[bk, seq[i + ngram_size - 1]] = 1.0
                            any_dup = True
                forbid_word_mask = buf if any_dup else None
            next_pos += 1
    return _trace_back(B, step_ids, step_back_ptrs, total_scores, eos_token_id,
                       length_penalty)


def sample_generate_captioning(
    model: XVLMForMLMCaptioning, image: torch.Tensor, prompt_ids: Sequence[int],
    generator: Optional[torch.Generator] = None, *, mask_token_id: int, eos_token_id: int,
    num_samples: int = 1, max_length: int = 20, temperature: float = 1.0,
    noise: Optional[Noise] = None,
) -> List[List[int]]:
    """Categorical rollouts for SCST: ``num_samples`` a image, the draws
    ``argmax(logits / temperature + noise(t, shape))`` with the noise from
    ``generator`` (or ``noise`` injected). After an EOS a rollout repeats
    it. Returns B * num_samples token lists, image-major, each cut at its
    first EOS."""
    B, K = image.shape[0], num_samples
    P = len(prompt_ids)
    dev = image.device
    noise = noise or gumbel_noise(generator, dev)
    N = B * K
    with inference(model):
        img_embeds, img_atts = model.encode_image(image)
        img_embeds, img_atts = _expand(img_embeds, K), _expand(img_atts, K)
        cache = model.init_cache(N, P + max_length + 1)
        logits, cache = model.decode_step(_prompt_frame(prompt_ids, mask_token_id, N, dev),
                                          0, cache, img_embeds, img_atts)
        logits = logits.float() / temperature
        tok = torch.argmax(logits + noise(0, tuple(logits.shape)), dim=-1)
        seqs = torch.zeros((N, max_length), dtype=torch.long, device=dev)
        seqs[:, 0] = tok
        done = tok == eos_token_id
        masks = torch.full((N, 1), mask_token_id, dtype=torch.long, device=dev)
        for t in range(1, max_length):
            x = torch.cat([seqs[:, t - 1:t], masks], 1)
            logits, cache = model.decode_step(x, P + t - 1, cache, img_embeds, img_atts)
            logits = logits.float() / temperature
            draw = torch.argmax(logits + noise(t, tuple(logits.shape)), dim=-1)
            tok = torch.where(done, torch.full_like(draw, eos_token_id), draw)
            seqs[:, t] = tok
            done = done | (tok == eos_token_id)
    out: List[List[int]] = []
    for row in seqs.cpu().tolist():
        toks = []
        for t in row:
            if t == eos_token_id:
                break
            toks.append(int(t))
        out.append(toks)
    return out
