"""The port's tokenizers and fixed-shape text preprocessing (the port's
counterpart of x2vlm_tpu/data/tokenization.py).

The JAX package builds its tokenizer with ``transformers``, picking the
family by a substring of the ``text_encoder`` path. The port reads the
files itself and imports neither ``transformers`` nor ``tokenizers`` nor
``sentencepiece``:

- :class:`BertWordPiece`, read from ``<text_encoder>/vocab.txt`` and held to
  ``transformers.BertTokenizerFast`` in the CPU tests: basic tokenization
  (control characters dropped, whitespace normalised, CJK characters split
  off, lower-casing, accents stripped, punctuation split off), then greedy
  longest-match-first WordPiece with ``##`` continuations, words over 100
  characters and words with no match becoming ``[UNK]``; and ``decode``,
  the ids back to text as ``BertTokenizerFast.decode`` gives it.
- :class:`XLMRUnigram`, read from ``<text_encoder>/tokenizer.json`` with
  ``json`` and held to ``transformers.XLMRobertaTokenizerFast`` in the CPU
  tests: the special tokens split off the raw text (with their ``lstrip`` /
  ``rstrip``), the file's normalizers (``Precompiled``: SentencePiece's
  compiled character map, a darts-clone double-array trie and its string
  pool; ``NFKC``, ``Replace``, ``Strip``, ``Lowercase``, ``Sequence``), the
  ``Metaspace`` pre-tokenizer, then the Viterbi of the ``Unigram`` model
  over its pieces (an unknown character scores the lowest piece's score
  less 10, adjacent unknowns fuse into one token).

A plain RoBERTa path (byte-level BPE) is reached by no shipped config and
comes with ROADMAP queue item A8d. ``TextPreprocessor`` and ``pre_caption``
are copies of the JAX ones; like the JAX launcher, the port builds the
CCLM preprocessor without ``use_roberta``, so whole-word masking looks for
``##`` continuations, which no XLM-R piece has (README deviations).
"""

from __future__ import annotations

import base64
import json
import os
import re
import struct
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from x2vlm_tpu_torch.data.masking import TextMaskingGenerator, pad_masks

__all__ = ["BertWordPiece", "XLMRUnigram", "build_tokenizer", "TextPreprocessor",
           "pre_caption"]


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


# ---- XLM-R: SentencePiece Unigram read from tokenizer.json ----

# Rust's char::is_whitespace: the Unicode White_Space property
_WHITE_SPACE = frozenset(map(chr, [*range(0x9, 0xE), 0x20, 0x85, 0xA0, 0x1680,
                                   *range(0x2000, 0x200B), 0x2028, 0x2029, 0x202F, 0x205F,
                                   0x3000]))
_ZWJ = "\u200d"


def _hangul(cp: int) -> str:
    """The Hangul syllable type of a code point: L, V, T, LV, LVT or ''."""
    if 0x1100 <= cp <= 0x115F or 0xA960 <= cp <= 0xA97C:
        return "L"
    if 0x1160 <= cp <= 0x11A7 or 0xD7B0 <= cp <= 0xD7C6:
        return "V"
    if 0x11A8 <= cp <= 0x11FF or 0xD7CB <= cp <= 0xD7FB:
        return "T"
    if 0xAC00 <= cp <= 0xD7A3:
        return "LV" if (cp - 0xAC00) % 28 == 0 else "LVT"
    return ""


def _extends(ch: str) -> bool:
    """Grapheme_Extend, ZWJ or SpacingMark: the characters that join the
    cluster before them (combining marks, emoji modifiers, ZWJ / ZWNJ)."""
    cp = ord(ch)
    return (unicodedata.category(ch) in ("Mn", "Me", "Mc") or cp in (0x200C, 0x200D)
            or 0x1F3FB <= cp <= 0x1F3FF or 0xE0020 <= cp <= 0xE007F)


def graphemes(text: str) -> List[str]:
    """Extended grapheme clusters (UAX #29) as the Precompiled normalizer
    walks them: CR LF, Hangul syllable sequences, regional-indicator pairs,
    a character and the extending marks after it, and ZWJ emoji sequences.
    Prepend characters and Indic conjunct joins are not modelled."""
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        j = i + 1
        c = text[i]
        if c == "\r" and j < n and text[j] == "\n":
            j += 1
        elif unicodedata.category(c) in ("Cc", "Zl", "Zp"):
            pass
        else:
            if 0x1F1E6 <= ord(c) <= 0x1F1FF and j < n and 0x1F1E6 <= ord(text[j]) <= 0x1F1FF:
                j += 1
            h = _hangul(ord(c))
            while h and j < n:
                nxt = _hangul(ord(text[j]))
                if ((h == "L" and nxt in ("L", "V", "LV", "LVT")) or
                        (h in ("LV", "V") and nxt in ("V", "T")) or
                        (h in ("LVT", "T") and nxt == "T")):
                    h, j = nxt, j + 1
                else:
                    break
            pict = unicodedata.category(c) == "So"
            while j < n:
                if _extends(text[j]):
                    # ExtPict Extend* ZWJ x ExtPict: an emoji joined by ZWJ
                    if (text[j] == _ZWJ and pict and j + 1 < n and
                            unicodedata.category(text[j + 1]) == "So"):
                        j += 2
                    else:
                        j += 1
                else:
                    break
        out.append(text[i:j])
        i = j
    return out


class _Charsmap:
    """SentencePiece's compiled character map (``precompiled_charsmap``): a
    little-endian u32 byte length, the darts-clone double-array units (u32
    each), then the NUL-terminated replacement strings. A key's leaf holds
    the offset of its replacement in the pool."""

    def __init__(self, blob: bytes):
        (size,) = struct.unpack_from("<I", blob, 0)
        self.units = struct.unpack_from(f"<{size // 4}I", blob, 4)
        self.pool = blob[4 + size:]

    def first_match(self, chunk: str) -> Optional[str]:
        """The replacement of the shortest key that is a prefix of
        ``chunk``'s UTF-8 bytes (darts-clone ``commonPrefixSearch``, first
        result), or None."""
        units = self.units
        unit = units[0]
        pos = (unit >> 10) << ((unit & (1 << 9)) >> 6)
        for c in chunk.encode("utf-8"):
            if c == 0:
                return None
            pos ^= c
            if pos >= len(units):
                return None
            unit = units[pos]
            if unit & ((1 << 31) | 0xFF) != c:
                return None
            pos ^= (unit >> 10) << ((unit & (1 << 9)) >> 6)
            if (unit >> 8) & 1:
                start = units[pos] & ((1 << 31) - 1)
                return self.pool[start:self.pool.index(b"\0", start)].decode("utf-8")
        return None

    def __call__(self, text: str) -> str:
        """As the ``tokenizers`` Precompiled normalizer: a grapheme of fewer
        than 6 bytes whose prefix is a key is replaced whole by that key's
        replacement; else each of its characters that is a key is
        replaced."""
        out = []
        for g in graphemes(text):
            if len(g.encode("utf-8")) < 6:
                norm = self.first_match(g)
                if norm is not None:
                    out.append(norm)
                    continue
            for ch in g:
                norm = self.first_match(ch)
                out.append(ch if norm is None else norm)
        return "".join(out)


def _normalizer(spec: Optional[dict]):
    """A ``tokenizer.json`` normalizer as a str -> str function."""
    if spec is None:
        return lambda s: s
    kind = spec["type"]
    if kind == "Sequence":
        steps = [_normalizer(n) for n in spec["normalizers"]]

        def run(s: str) -> str:
            for step in steps:
                s = step(s)
            return s
        return run
    if kind == "Precompiled":
        blob = spec.get("precompiled_charsmap")
        return _Charsmap(base64.b64decode(blob)) if blob else (lambda s: s)
    if kind == "NFKC":
        return lambda s: unicodedata.normalize("NFKC", s)
    if kind == "Lowercase":
        return str.lower
    if kind == "Strip":
        left, right = spec.get("strip_left", True), spec.get("strip_right", True)

        def strip(s: str) -> str:
            i, j = 0, len(s)
            while left and i < j and s[i] in _WHITE_SPACE:
                i += 1
            while right and j > i and s[j - 1] in _WHITE_SPACE:
                j -= 1
            return s[i:j]
        return strip
    if kind == "Replace":
        pat, content = spec["pattern"], spec["content"]
        if "String" in pat:
            return lambda s: s.replace(pat["String"], content)
        regex = re.compile(pat["Regex"])
        return lambda s: regex.sub(lambda _: content, s)
    raise NotImplementedError(f"tokenizer.json normalizer {kind!r} is not read by the port "
                              f"(it reads Precompiled, NFKC, Replace, Strip, Lowercase, "
                              f"Sequence)")


class XLMRUnigram:
    """XLM-R's SentencePiece Unigram tokenizer over a ``tokenizer.json``
    (the vocabulary: ``[piece, score]`` pairs whose list index is the id).
    The attributes and methods the data pipeline uses are those of
    ``transformers.XLMRobertaTokenizerFast``: ``<s>`` is the CLS and BOS
    token, ``</s>`` the SEP and EOS token."""

    unk_token, sep_token, pad_token, cls_token, mask_token = (
        "<unk>", "</s>", "<pad>", "<s>", "<mask>")
    bos_token, eos_token = "<s>", "</s>"
    unk_penalty = 10.0

    def __init__(self, path: str):
        with open(path, "r", encoding="utf-8") as f:
            spec = json.load(f)
        model = spec["model"]
        if model.get("type") != "Unigram":
            raise NotImplementedError(f"{path}: model {model.get('type')!r}; the port reads a "
                                      f"Unigram tokenizer.json here")
        if model.get("byte_fallback"):
            raise NotImplementedError(f"{path}: a byte-fallback Unigram is not read by the "
                                      f"port")
        pieces = [(str(p), float(s)) for p, s in model["vocab"]]
        self.scores = [s for _, s in pieces]
        self.unk_id = model.get("unk_id")
        if self.unk_id is None:
            raise ValueError(f"{path}: the Unigram has no unk_id")
        self.min_score = min(self.scores)
        self.pieces: Dict[str, int] = {}   # the Unigram's own: a repeated piece keeps its last id
        for i, (p, _) in enumerate(pieces):
            self.pieces[p] = i
        self.vocab = dict(self.pieces)
        self.max_piece_len = max(len(p) for p, _ in pieces)
        self.added: List[dict] = []
        for t in spec.get("added_tokens", []):
            if t.get("normalized") or t.get("single_word"):
                raise NotImplementedError(f"{path}: added token {t['content']!r} is normalized "
                                          f"or single-word, which the port does not read")
            self.added.append(t)
            self.vocab[t["content"]] = t["id"]
        # the longest added token first at each position (leftmost-longest)
        self._added_re = (re.compile("|".join(re.escape(t["content"]) for t in sorted(
            self.added, key=lambda t: -len(t["content"])))) if self.added else None)
        self._added = {t["content"]: t for t in self.added}
        self.normalize = _normalizer(spec.get("normalizer"))
        pre = spec.get("pre_tokenizer") or {}
        if pre.get("type") != "Metaspace":
            raise NotImplementedError(f"{path}: pre-tokenizer {pre.get('type')!r}; the port "
                                      f"reads Metaspace")
        self.replacement = pre.get("replacement", "\u2581")
        scheme = pre.get("prepend_scheme")
        if scheme is None:
            scheme = "always" if pre.get("add_prefix_space", True) else "never"
        self.prepend_scheme = scheme
        self.split = pre.get("split", True)
        for t in (self.unk_token, self.sep_token, self.pad_token, self.cls_token,
                  self.mask_token):
            if t not in self.vocab:
                raise ValueError(f"{path}: the special token {t} is not in the vocab")
        self.pad_token_id = self.vocab[self.pad_token]
        self.unk_token_id = self.vocab[self.unk_token]
        self.cls_token_id = self.vocab[self.cls_token]
        self.sep_token_id = self.vocab[self.sep_token]
        self.mask_token_id = self.vocab[self.mask_token]

    def get_vocab(self) -> Dict[str, int]:
        return dict(self.vocab)

    def __len__(self) -> int:
        return len(self.vocab)

    # ---- the added (special) tokens, split off the raw text ----
    def _split_added(self, text: str) -> List[Tuple[str, bool, int]]:
        """(segment, is an added token, its start in ``text``) in order,
        empty segments dropped."""
        out: List[Tuple[str, bool, int]] = []
        at = 0
        for m in (self._added_re.finditer(text) if self._added_re else ()):
            tok = self._added[m.group(0)]
            start, stop = m.start(), m.end()
            if tok.get("lstrip"):
                while start > at and text[start - 1] in _WHITE_SPACE:
                    start -= 1
            if tok.get("rstrip"):
                while stop < len(text) and text[stop] in _WHITE_SPACE:
                    stop += 1
            if start > at:
                out.append((text[at:start], False, at))
            # the token is the text it took, the stripped whitespace included
            # (so " <mask>" is no vocab entry, as transformers tokenizes it)
            out.append((text[start:stop], True, start))
            at = stop
        if at < len(text):
            out.append((text[at:], False, at))
        return out

    def _pre_tokenize(self, text: str, first: bool) -> List[str]:
        """Metaspace: spaces -> the replacement, the replacement prepended
        (scheme ``always``, or ``first`` on the text's first segment), then
        a split before each replacement run."""
        r = self.replacement
        text = text.replace(" ", r)
        if not text.startswith(r) and (self.prepend_scheme == "always" or
                                       (self.prepend_scheme == "first" and first)):
            text = r + text
        if not self.split:
            return [text]
        out, start = [], 0
        for i in range(1, len(text)):
            if text[i] == r and text[i - 1] != r:
                out.append(text[start:i])
                start = i
        out.append(text[start:])
        return out

    def _viterbi(self, text: str) -> List[str]:
        """The best segmentation of one pre-token: at each character, every
        piece that starts there, shortest first, improves its end's best
        path on a strictly higher score; a character no piece of its own
        length covers gets the unknown score; unknowns next to each other
        fuse (the ``tokenizers`` Unigram's ``encode_optimized``)."""
        n = len(text)
        score = [0.0] * (n + 1)
        start = [-1] * (n + 1)
        ids = [0] * (n + 1)
        unk_score = self.min_score - self.unk_penalty
        pieces, scores = self.pieces, self.scores
        for i in range(n):
            here = score[i]
            single = False
            for j in range(i + 1, min(n, i + self.max_piece_len) + 1):
                pid = pieces.get(text[i:j])
                if pid is None:
                    continue
                cand = scores[pid] + here
                if start[j] < 0 or cand > score[j]:
                    score[j], start[j], ids[j] = cand, i, pid
                if j == i + 1:
                    single = True
            if not single:
                cand = unk_score + here
                if start[i + 1] < 0 or cand > score[i + 1]:
                    score[i + 1], start[i + 1], ids[i + 1] = cand, i, self.unk_id
        out: List[str] = []
        unk: List[str] = []
        end = n
        while end > 0:
            s = start[end]
            if ids[end] == self.unk_id:
                unk.append(text[s:end])
            else:
                if unk:
                    out.append("".join(reversed(unk)))
                    unk = []
                out.append(text[s:end])
            end = s
        if unk:
            out.append("".join(reversed(unk)))
        return out[::-1]

    def tokenize(self, text: str) -> List[str]:
        """The pieces of ``text`` (an unknown run as its own characters, as
        ``XLMRobertaTokenizerFast.tokenize`` gives them), no ``<s>`` /
        ``</s>`` added."""
        out: List[str] = []
        for seg, added, at in self._split_added(text):
            if added:
                out.append(seg)
                continue
            seg = self.normalize(seg)
            if not seg:
                continue
            for word in self._pre_tokenize(seg, at == 0):
                out.extend(self._viterbi(word))
        return out

    def convert_tokens_to_ids(self, tokens: Union[str, Sequence[str]]):
        if isinstance(tokens, str):
            return self.vocab.get(tokens, self.unk_token_id)
        return [self.vocab.get(t, self.unk_token_id) for t in tokens]


def build_tokenizer(path: str):
    """The tokenizer of the ``text_encoder`` directory ``path``, its family
    picked by path substring as the JAX ``build_tokenizer`` picks it: XLM-R
    (``xlm-roberta`` / ``xlmr``) reads ``tokenizer.json``; BERT reads
    ``vocab.txt``. A plain RoBERTa path raises (ROADMAP A8d)."""
    lowered = str(path).lower()
    if "xlm-roberta" in lowered or "xlmr" in lowered:
        spec = os.path.join(path, "tokenizer.json") if os.path.isdir(path) else path
        if not os.path.isfile(spec):
            raise FileNotFoundError(f"no tokenizer.json for the text encoder at {path}")
        return XLMRUnigram(spec)
    if "roberta" in lowered:
        raise NotImplementedError(
            f"{path}: the RoBERTa byte-level BPE tokenizer comes with ROADMAP queue item "
            f"A8d; the port tokenizes with BERT's WordPiece and XLM-R's Unigram")
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
