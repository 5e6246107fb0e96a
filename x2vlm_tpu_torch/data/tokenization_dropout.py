"""WordPiece-dropout tokenization (the port's copy of
x2vlm_tpu/data/tokenization_dropout.py; reference
dataset/tokenizers/bert_tokenizer_with_dropout.py:4-119): in training the
greedy longest-match WordPiece now and then takes a shorter match, which
gives other segmentations of a word, a subword regularisation for noisy
web text.

It wraps the port's :class:`~x2vlm_tpu_torch.data.tokenization.BertWordPiece`
(its ``get_vocab()``, ``unk_token`` and basic pre-tokenization
``basic_tokenize``), where the JAX copy wraps a ``transformers`` BERT
tokenizer (``basic_tokenizer.tokenize``); both split a text into the same
words, so equal ``random.Random`` states give equal pieces. No launcher
task builds it.
"""

from __future__ import annotations

import random
from typing import List, Optional

__all__ = ["WordpieceTokenizerWithDropout"]


class WordpieceTokenizerWithDropout:
    """``tokenizer``'s vocabulary with dropout in the longest match: at each
    step, with probability ``dropout`` the matcher passes over the longest
    matching piece for the next one, and again, down to the shortest (never
    an empty match). Every other attribute is ``tokenizer``'s."""

    def __init__(self, tokenizer, dropout: float = 0.1, rng: Optional[random.Random] = None,
                 max_input_chars_per_word: int = 100):
        self.vocab = tokenizer.get_vocab()
        self.unk_token = tokenizer.unk_token
        self.basic = tokenizer
        self.dropout = dropout
        self.rng = rng or random.Random()
        self.max_chars = max_input_chars_per_word

    def _wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_chars:
            return [self.unk_token]
        out: List[str] = []
        start = 0
        while start < len(word):
            matches = []          # every matching piece from here, the longest first
            for end in range(len(word), start, -1):
                sub = word[start:end] if start == 0 else "##" + word[start:end]
                if sub in self.vocab:
                    matches.append((end, sub))
            if not matches:
                return [self.unk_token]
            pick = 0
            while pick < len(matches) - 1 and self.dropout > 0 and \
                    self.rng.random() < self.dropout:
                pick += 1
            start, sub = matches[pick]
            out.append(sub)
        return out

    def tokenize(self, text: str) -> List[str]:
        words = (self.basic.basic_tokenize(text) if hasattr(self.basic, "basic_tokenize")
                 else text.lower().split())
        return [p for w in words for p in self._wordpiece(w)]

    def __getattr__(self, name):
        return getattr(self.basic, name)
