"""Whole-word text masking for MLM (the port's copy of x2vlm_tpu/data/masking.py;
reference dataset/pretrain_dataset.py:36-130 TextMaskingGenerator).

Semantics preserved:
- candidate units are whole words (a word = token + its '##' continuation
  pieces) when ``mask_whole_word``, else single tokens
- skip-gram span masking: with prob ``skipgram_prb`` mask a span of up to
  ``skipgram_size`` words (geometric-ish via uniform choice)
- per masked token: 80% → [MASK], 10% → random vocab token, 10% → keep
- the first ``num_source_tokens`` positions (prompt) are protected
- number of masks = clamp(round(mask_prob * n_tokens), 1, max_masks); outputs
  are padded to ``max_masks`` with pos 0 / label -100 (ignored by the loss)
"""

from __future__ import annotations

import random
from typing import List, Optional, Sequence, Tuple

__all__ = ["TextMaskingGenerator", "IGNORE_INDEX", "pad_masks"]

IGNORE_INDEX = -100


class TextMaskingGenerator:
    def __init__(
        self,
        tokenizer,
        mask_prob: float,
        mask_max: int,
        skipgram_prb: float = 0.2,
        skipgram_size: int = 3,
        mask_whole_word: bool = True,
        rng: Optional[random.Random] = None,
    ):
        self.tokenizer = tokenizer
        self.mask_prob = mask_prob
        self.mask_max = mask_max
        self.skipgram_prb = skipgram_prb
        self.skipgram_size = skipgram_size
        self.mask_whole_word = mask_whole_word
        self.mask_token = tokenizer.mask_token
        # sorted by id: get_vocab() iteration order is hash-map order in the
        # fast (Rust) tokenizers and differs across instances — the 10%
        # random-replacement draw must be reproducible for a given seed
        self.vocab = [t for t, _ in sorted(tokenizer.get_vocab().items(),
                                           key=lambda kv: kv[1])]
        self.rng = rng or random.Random()

    @staticmethod
    def _is_continuation(token: str) -> bool:
        # WordPiece's continuation; no XLM-R piece has it, and like the JAX
        # launcher the port builds the CCLM masking without use_roberta
        return token.startswith("##")

    def word_starts(self, tokens: Sequence[str], lo: int) -> List[int]:
        return [i for i in range(lo, len(tokens))
                if not (self.mask_whole_word and self._is_continuation(tokens[i]))]

    def __call__(self, tokens: List[str], num_source_tokens: int = 0
                 ) -> Tuple[List[str], List[int]]:
        """Returns (masked_tokens, masked_positions). ``tokens[0]`` is CLS and
        never masked; positions < num_source_tokens (after CLS) protected."""
        tokens = list(tokens)
        lo = 1 + num_source_tokens
        n_maskable = max(len(tokens) - lo, 0)
        n_pred = min(self.mask_max, max(1, round(self.mask_prob * n_maskable)))

        starts = self.word_starts(tokens, lo)
        self.rng.shuffle(starts)

        masked_pos = set()
        for start in starts:
            if len(masked_pos) >= n_pred:
                break
            if start in masked_pos:
                continue
            span = 1
            if (self.mask_whole_word and self.skipgram_prb > 0
                    and self.skipgram_size > 1
                    and self.rng.random() < self.skipgram_prb):
                span = self.rng.randint(1, self.skipgram_size)
            # extend over whole words for `span` words
            end = start
            words_taken = 0
            while end < len(tokens) and words_taken < span:
                end += 1
                words_taken += 1
                while (end < len(tokens) and self.mask_whole_word
                       and self._is_continuation(tokens[end])):
                    end += 1
            for p in range(start, min(end, len(tokens))):
                if len(masked_pos) >= n_pred and p != start:
                    break
                masked_pos.add(p)

        masked_pos = sorted(masked_pos)
        if len(masked_pos) > n_pred:
            self.rng.shuffle(masked_pos)
            masked_pos = sorted(masked_pos[:n_pred])

        for pos in masked_pos:
            r = self.rng.random()
            if r < 0.8:
                tokens[pos] = self.mask_token
            elif r < 0.9:
                tokens[pos] = self.rng.choice(self.vocab)
            # else keep
        return tokens, masked_pos


def pad_masks(masked_pos: List[int], masked_ids: List[int], max_masks: int
              ) -> Tuple[List[int], List[int]]:
    """Pad to fixed length: pos→0, label→IGNORE_INDEX (reference pads labels
    with PAD_mask=-100, pretrain_dataset.py:271-273)."""
    n_pad = max_masks - len(masked_pos)
    return (masked_pos + [0] * n_pad,
            masked_ids + [IGNORE_INDEX] * n_pad)
