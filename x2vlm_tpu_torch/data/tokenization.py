"""The BERT WordPiece tokenizer and fixed-shape text preprocessing (the
port's counterpart of x2vlm_tpu/data/tokenization.py).

The JAX package builds its tokenizer with ``transformers``; the port has its
own :class:`BertWordPiece`, read from ``<text_encoder>/vocab.txt`` and held
to ``transformers.BertTokenizerFast`` in the CPU tests: basic tokenization
(control characters dropped, whitespace normalised, CJK characters split
off, lower-casing, accents stripped, punctuation split off), then greedy
longest-match-first WordPiece with ``##`` continuations, words over 100
characters and words with no match becoming ``[UNK]``; and ``decode``, the
ids back to text as ``BertTokenizerFast.decode`` gives it.
``TextPreprocessor`` and ``pre_caption`` are copies of the JAX ones.
RoBERTa and XLM-R tokenizers come with the multilingual models (ROADMAP
queue A8b).
"""

from __future__ import annotations

import os
import re
import unicodedata
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from x2vlm_tpu_torch.data.masking import TextMaskingGenerator, pad_masks

__all__ = ["BertWordPiece", "build_tokenizer", "TextPreprocessor", "pre_caption"]


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF or 0x20000 <= cp <= 0x2A6DF
            or 0x2A700 <= cp <= 0x2B73F or 0x2B740 <= cp <= 0x2B81F
            or 0x2B820 <= cp <= 0x2CEAF or 0xF900 <= cp <= 0xFAFF
            or 0x2F800 <= cp <= 0x2FA1F)


class BertWordPiece:
    """BERT's uncased WordPiece tokenizer over a ``vocab.txt`` (one token a
    line, the line number its id). The attributes and methods the data
    pipeline uses are those of a ``transformers`` tokenizer."""

    unk_token, sep_token, pad_token, cls_token, mask_token = (
        "[UNK]", "[SEP]", "[PAD]", "[CLS]", "[MASK]")
    max_input_chars_per_word = 100

    def __init__(self, vocab_file: str):
        self.vocab: Dict[str, int] = {}
        with open(vocab_file, "r", encoding="utf-8") as f:
            for i, line in enumerate(f):
                token = line.rstrip("\n")
                if token not in self.vocab:
                    self.vocab[token] = i
        for t in (self.unk_token, self.sep_token, self.pad_token, self.cls_token,
                  self.mask_token):
            if t not in self.vocab:
                raise ValueError(f"{vocab_file}: the special token {t} is not in the vocab")
        self.pad_token_id = self.vocab[self.pad_token]
        self.unk_token_id = self.vocab[self.unk_token]
        self.cls_token_id = self.vocab[self.cls_token]
        self.sep_token_id = self.vocab[self.sep_token]
        self.mask_token_id = self.vocab[self.mask_token]
        self.ids_to_tokens = {i: t for t, i in self.vocab.items()}
        self.all_special_ids = sorted({self.vocab[t] for t in (
            self.unk_token, self.sep_token, self.pad_token, self.cls_token, self.mask_token)})

    def get_vocab(self) -> Dict[str, int]:
        return dict(self.vocab)

    # ---- basic tokenization ----
    def _clean(self, text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            if _is_cjk(cp):
                out.append(f" {ch} ")
            else:
                out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    @staticmethod
    def _normalize_word(word: str) -> str:
        word = unicodedata.normalize("NFD", word)
        word = "".join(c for c in word if unicodedata.category(c) != "Mn")
        return word.lower()

    def basic_tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for word in self._clean(text).split():
            word = self._normalize_word(word)
            cur = ""
            for ch in word:
                if _is_punctuation(ch):
                    if cur:
                        out.append(cur)
                        cur = ""
                    out.append(ch)
                elif _is_whitespace(ch):
                    if cur:
                        out.append(cur)
                        cur = ""
                else:
                    cur += ch
            if cur:
                out.append(cur)
        return out

    # ---- WordPiece ----
    def wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_input_chars_per_word:
            return [self.unk_token]
        pieces, start = [], 0
        while start < len(word):
            end, piece = len(word), None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return [self.unk_token]
            pieces.append(piece)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        return [p for w in self.basic_tokenize(text) for p in self.wordpiece(w)]

    def convert_tokens_to_ids(self, tokens: Union[str, Sequence[str]]):
        if isinstance(tokens, str):
            return self.vocab.get(tokens, self.unk_token_id)
        return [self.vocab.get(t, self.unk_token_id) for t in tokens]


    def decode(self, ids: Sequence[int], skip_special_tokens: bool = False) -> str:
        """Token ids -> text, as ``BertTokenizerFast.decode`` gives it: the
        special tokens dropped with ``skip_special_tokens`` (before the
        merge, so a leading ``##`` piece keeps its prefix), each later
        ``##`` piece glued to the one before and every other token after a
        space, the cleanup applied to each token and then to the text
        (``clean_up_tokenization_spaces``)."""
        special = set(self.all_special_ids) if skip_special_tokens else set()
        out = []
        for i in (int(i) for i in ids):
            if i in special:
                continue
            tok = self.ids_to_tokens.get(i, self.unk_token)
            if out:
                tok = tok[2:] if tok.startswith("##") else " " + tok
            out.append(_cleanup(tok))
        return _cleanup("".join(out))


_CLEANUP = ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"), (" n't", "n't"),
            (" 'm", "'m"), (" 's", "'s"), (" 've", "'ve"), (" 're", "'re"))


def _cleanup(text: str) -> str:
    """``clean_up_tokenization`` of ``transformers`` (the WordPiece
    decoder's per-token cleanup also turns " do not" into " don't", which
    a single token never holds)."""
    for a, b in _CLEANUP:
        text = text.replace(a, b)
    return text


def build_tokenizer(path: str) -> BertWordPiece:
    """The tokenizer of the ``text_encoder`` directory ``path``: BERT's
    WordPiece over its ``vocab.txt``. RoBERTa / XLM-R paths (picked by path
    substring, as the JAX ``build_tokenizer`` picks them) raise."""
    lowered = str(path).lower()
    if "roberta" in lowered or "xlmr" in lowered:
        raise NotImplementedError(
            f"{path}: RoBERTa / XLM-R tokenizers come with the multilingual models "
            f"(ROADMAP queue A8b); the port tokenizes with BERT's WordPiece")
    vocab = os.path.join(path, "vocab.txt") if os.path.isdir(path) else path
    if not os.path.isfile(vocab):
        raise FileNotFoundError(f"no vocab.txt for the text encoder at {path}")
    return BertWordPiece(vocab)


def pre_caption(caption: str, max_words: int) -> str:
    """Caption normalization (reference dataset/utils.py pre_caption): strip
    punctuation runs, lowercase, collapse whitespace, cap word count."""
    caption = re.sub(r"([.!\"()*#:;~])", " ", caption.lower())
    caption = re.sub(r"\s{2,}", " ", caption)
    caption = caption.rstrip("\n").strip(" ")
    words = caption.split(" ")
    if len(words) > max_words:
        caption = " ".join(words[:max_words])
    return caption


class TextPreprocessor:
    """Caption -> fixed-shape (text_ids, text_atts[, masked variants])."""

    def __init__(
        self,
        tokenizer,
        max_tokens: int,
        max_words: Optional[int] = None,
        max_masks: int = 0,
        mask_prob: float = 0.5,
        mask_whole_word: bool = True,
        skipgram_prb: float = 0.2,
        skipgram_size: int = 3,
        rng=None,
    ):
        self.tokenizer = tokenizer
        self.max_tokens = max_tokens
        self.max_words = max_words or max_tokens
        self.max_masks = max_masks
        self.cls_token = tokenizer.cls_token
        self.eos_token = tokenizer.sep_token
        self.pad_id = tokenizer.pad_token_id
        if max_masks > 0:
            self.mask_generator = TextMaskingGenerator(
                tokenizer, mask_prob, max_masks, skipgram_prb, skipgram_size,
                mask_whole_word, rng=rng)

    def tokenize(self, text: str) -> List[str]:
        text = pre_caption(text, self.max_words)
        tokens = [self.cls_token] + self.tokenizer.tokenize(text)[: self.max_tokens - 1]
        return tokens[: self.max_tokens - 1] + [self.eos_token]

    def __call__(self, text: str, with_masking: bool = False):
        tokens = self.tokenize(text)
        n = len(tokens)
        ids = self.tokenizer.convert_tokens_to_ids(tokens)
        pad = self.max_tokens - n
        text_ids = np.asarray(ids + [self.pad_id] * pad, np.int32)
        text_atts = np.asarray([1] * n + [0] * pad, np.int32)
        if not with_masking:
            return text_ids, text_atts
        masked_tokens, masked_pos = self.mask_generator(list(tokens))
        masked_ids_list = [ids[p] for p in masked_pos]
        ids_masked = self.tokenizer.convert_tokens_to_ids(masked_tokens)
        text_ids_masked = np.asarray(ids_masked + [self.pad_id] * pad, np.int32)
        pos, labels = pad_masks(masked_pos, masked_ids_list, self.max_masks)
        return (text_ids, text_atts, text_ids_masked,
                np.asarray(pos, np.int32), np.asarray(labels, np.int32))
