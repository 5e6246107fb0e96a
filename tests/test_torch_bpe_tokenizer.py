"""The port's byte-level BPE tokenizer (``RobertaBPE``, read from
``vocab.json`` and ``merges.txt`` with ``json`` alone) against the JAX
package's ``build_tokenizer`` (``transformers.RobertaTokenizerFast``) on
files the test writes: a byte-level BPE trained here with ``tokenizers`` on
a corpus of English with contractions, accented Latin, CJK, Cyrillic,
digits and runs of spaces. Fixed sentences and a ``hypothesis`` fuzz of
mixed-script text, the vocabulary and the special tokens, and
``TextPreprocessor`` with masking against the JAX one."""

import random

import pytest
from tests.torch_threads import few_torch_threads  # noqa: E402,F401 (autouse)

transformers = pytest.importorskip("transformers")
tokenizers = pytest.importorskip("tokenizers")
hypothesis = pytest.importorskip("hypothesis")

from hypothesis import given, settings, strategies as st  # noqa: E402

from x2vlm_tpu.data.tokenization import (  # noqa: E402
    TextPreprocessor as JaxTextPreprocessor, build_tokenizer as jax_build_tokenizer,
)
from x2vlm_tpu_torch.data.tokenization import (  # noqa: E402
    _BYTE_CHARS, RobertaBPE, TextPreprocessor, build_tokenizer, byte_level_pieces,
)

CORPUS = [
    "the dog's running over the river bank, isn't it? we'll see what they've done",
    "I'm here and you're there; she'd say it's 2024 and 1,234.56 people came",
    "café résumé naïve Straße über Äpfel éléphant señor niño",
    "日本語のテキストと中文文本 한국어 문장 Москва и Санкт-Петербург",
    "tabs\tand  double   spaces\nnew lines  end  ",
    "x''s O'Neil's 'quoted' words!!! (brackets) [more] #hash @at 3rd 4th",
]
TEXTS = [
    "the dog's running",
    "  leading spaces and trailing   ",
    "it's   three  spaces'll 've 're 'm 'd 't",
    "café 日本語 123 and 4567",
    "mixed:日本123abcé—dash “quotes” ½ ⅔ Ⅻ",
    "a <mask> in the middle and <s> tokens </s>",
    "new\nline\ttab  nbsp　ideographic space",
    "CamelCase UPPER lower 42nd",
    "",
    "   ",
]
FUZZ_ALPHABET = list("abcxyzABC éüñ日本語한국МоскваÅ0123456789'\"!?.,;:-_ \t\n") + [
    " ", "　", " ", "́", "​", "😀", "½", "Ⅻ"]


@pytest.fixture(scope="module")
def roberta_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("bpe") / "roberta-test"
    d.mkdir()
    bpe = tokenizers.ByteLevelBPETokenizer()
    bpe.train_from_iterator(CORPUS * 4, vocab_size=600, min_frequency=2,
                            special_tokens=["<s>", "<pad>", "</s>", "<unk>", "<mask>"])
    bpe.save_model(str(d))
    return str(d)


@pytest.fixture(scope="module")
def both(roberta_dir):
    return build_tokenizer(roberta_dir), jax_build_tokenizer(roberta_dir)


def test_the_written_files_are_what_the_test_means(both):
    port, hf = both
    assert isinstance(port, RobertaBPE)
    assert isinstance(hf, transformers.RobertaTokenizerFast)
    assert len(port.ranks) > 100 and len(port.get_vocab()) > 256 + 100


@pytest.mark.parametrize("text", TEXTS + CORPUS)
def test_pieces_and_ids_equal_roberta_fast(both, text):
    port, hf = both
    assert port.tokenize(text) == hf.tokenize(text)
    assert port.convert_tokens_to_ids(port.tokenize(text)) == \
        hf.convert_tokens_to_ids(hf.tokenize(text))


@settings(max_examples=150, deadline=None, derandomize=True)
@given(st.text(alphabet=FUZZ_ALPHABET, max_size=40))
def test_fuzz_of_mixed_script_text_equals_roberta_fast(both, text):
    port, hf = both
    assert port.tokenize(text) == hf.tokenize(text)


@settings(max_examples=150, deadline=None, derandomize=True)
@given(st.text(alphabet=FUZZ_ALPHABET, max_size=40))
def test_pre_tokenization_equals_the_byte_level_pre_tokenizer(text):
    """The scanner against ``tokenizers``' ByteLevel pre-tokenizer (its
    regex), piece for piece, before the byte map."""
    pre = tokenizers.pre_tokenizers.ByteLevel(add_prefix_space=False)
    want = [p for p, _ in pre.pre_tokenize_str(text)]
    got = ["".join(_BYTE_CHARS[b] for b in p.encode("utf-8")) for p in byte_level_pieces(text)]
    assert got == want


def test_vocab_and_specials_equal_roberta_fast(both):
    port, hf = both
    assert port.get_vocab() == hf.get_vocab()
    for name in ("cls_token", "sep_token", "eos_token", "bos_token", "pad_token", "mask_token",
                 "unk_token"):
        assert getattr(port, name) == str(getattr(hf, name)), name
    for name in ("pad_token_id", "mask_token_id", "unk_token_id", "cls_token_id",
                 "sep_token_id"):
        assert getattr(port, name) == getattr(hf, name), name
    assert port.convert_tokens_to_ids("never-a-piece") == hf.convert_tokens_to_ids(
        "never-a-piece")


@pytest.mark.parametrize("seed", [0, 1])
def test_text_preprocessor_with_masking_equals_jax(both, seed):
    port, hf = both
    kw = dict(max_tokens=16, max_words=16, max_masks=4, mask_prob=0.5,
              skipgram_prb=0.2, skipgram_size=3)
    got_pre = TextPreprocessor(port, rng=random.Random(seed), **kw)
    want_pre = JaxTextPreprocessor(hf, rng=random.Random(seed), **kw)
    for text in TEXTS[:5] + CORPUS[:3]:
        got, want = got_pre(text, with_masking=True), want_pre(text, with_masking=True)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.tolist() == w.tolist(), text
