"""The port's BERT WordPiece tokenizer against ``transformers.BertTokenizerFast``
on a vocab the test writes, and its ``TextPreprocessor`` (masking included)
against the JAX package's from the same ``random.Random`` seed."""

import random

import numpy as np
import pytest
from tests.torch_threads import few_torch_threads  # noqa: E402,F401 (autouse)

transformers = pytest.importorskip("transformers")

from x2vlm_tpu.data.tokenization import (  # noqa: E402
    TextPreprocessor as JaxTextPreprocessor, build_tokenizer as jax_build_tokenizer,
)
from x2vlm_tpu_torch.data.tokenization import (  # noqa: E402
    BertWordPiece, TextPreprocessor, build_tokenizer, pre_caption,
)

VOCAB = ("[PAD] [UNK] [CLS] [SEP] [MASK] a b c d e dog cat runs the quick brown fox "
         "jump ##s ##ing ##ed over lazy river bank small big red blue green house tree "
         "cafe naive , . ! ? ' - ( ) 中 国 人 un ##believ ##able hello world ##o ##l "
         "x ##x ##xx 1 2 3 ##3").split()
TEXTS = [
    "The quick brown fox jumps over the lazy dog.",
    "Café naïve, DOG!! (runs) -- what?",
    "中国人 hello world",
    "unbelievable unbelievablex helloo",
    "x" * 100,                        # exactly 100 characters: WordPiece runs
    "x" * 101 + " dog",               # over 100 characters: [UNK]
    "",
    "   \t\n  ",
    "tab\tnew\nline\r\x00nul � control\x07 chars",
    "zzz qqq unknownword 123 3 33",
    "a-b's (c) d... e!?",
    "Ａ full-width Ｂ and accents: ÀÉÎÕÜ ñ ç",
]


@pytest.fixture(scope="module")
def vocab_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("vocab") / "bert-test-uncased"
    d.mkdir()
    (d / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
    return str(d)


@pytest.fixture(scope="module")
def both(vocab_dir):
    return build_tokenizer(vocab_dir), transformers.BertTokenizerFast(
        vocab_file=f"{vocab_dir}/vocab.txt", do_lower_case=True)


@pytest.mark.parametrize("text", TEXTS)
def test_token_ids_equal_bert_tokenizer_fast(both, text):
    port, hf = both
    assert port.tokenize(text) == hf.tokenize(text), text
    assert port.convert_tokens_to_ids(port.tokenize(text)) == \
        hf.convert_tokens_to_ids(hf.tokenize(text))


def test_special_tokens_and_vocab_equal_bert_tokenizer_fast(both):
    port, hf = both
    for name in ("cls_token", "sep_token", "pad_token", "mask_token", "unk_token"):
        assert getattr(port, name) == getattr(hf, name), name
    assert port.pad_token_id == hf.pad_token_id
    assert port.get_vocab() == hf.get_vocab()


def test_build_tokenizer_refuses_roberta_paths(tmp_path):
    """A plain RoBERTa path (byte-level BPE) without its vocab.json and
    merges.txt is refused (tests/test_torch_bpe_tokenizer.py reads them); an
    XLM-R path reads its tokenizer.json (tests/test_torch_xlmr_tokenizer.py)
    and needs one."""
    with pytest.raises(FileNotFoundError, match="vocab.json / merges.txt"):
        build_tokenizer(str(tmp_path / "roberta-base"))
    with pytest.raises(FileNotFoundError, match="tokenizer.json"):
        build_tokenizer(str(tmp_path / "xlm-roberta-base"))
    with pytest.raises(FileNotFoundError):
        build_tokenizer(str(tmp_path / "bert-missing"))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_text_preprocessor_with_masking_equals_jax(vocab_dir, seed):
    """Ids, attention, masked ids, masked positions and labels equal the JAX
    ``TextPreprocessor``'s from the same ``random.Random`` seed."""
    kw = dict(max_tokens=12, max_words=12, max_masks=4, mask_prob=0.5,
              skipgram_prb=0.2, skipgram_size=3)
    port = TextPreprocessor(BertWordPiece(f"{vocab_dir}/vocab.txt"),
                            rng=random.Random(seed), **kw)
    jax_pre = JaxTextPreprocessor(jax_build_tokenizer(vocab_dir), rng=random.Random(seed), **kw)
    for text in TEXTS[:4] + ["the dog runs over the river bank", "small red house tree"]:
        got, want = port(text, with_masking=True), jax_pre(text, with_masking=True)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w, err_msg=text)
        for g, w in zip(port(text), jax_pre(text)):
            np.testing.assert_array_equal(g, w, err_msg=text)


def test_pre_caption_is_the_jax_one():
    from x2vlm_tpu.data.tokenization import pre_caption as jax_pre_caption

    for text in TEXTS + ["A  B#C:D;E~F*G", "one two three four five six"]:
        assert pre_caption(text, 4) == jax_pre_caption(text, 4)
