"""The port's XLM-R tokenizer (``XLMRUnigram``, read from ``tokenizer.json``
with ``json`` alone) against the JAX package's ``build_tokenizer``
(``transformers.XLMRobertaTokenizerFast``) on a ``tokenizer.json`` the test
writes: a Unigram trained here with ``tokenizers`` on a six-language corpus,
a ``Precompiled`` normalizer whose darts-clone character map the test
builds (several keys, one mapped to a multi-character string, one a
combining sequence), ``Metaspace``, the ``<s> $A </s>`` template and
``<mask>`` last. Then ``TextPreprocessor`` with masking against the JAX one
from the same ``random.Random`` seed."""

import json
import random
import struct

import numpy as np
import pytest

transformers = pytest.importorskip("transformers")
tokenizers = pytest.importorskip("tokenizers")
hypothesis = pytest.importorskip("hypothesis")

from hypothesis import given, settings, strategies as st  # noqa: E402

from x2vlm_tpu.data.tokenization import (  # noqa: E402
    TextPreprocessor as JaxTextPreprocessor, build_tokenizer as jax_build_tokenizer,
)
from x2vlm_tpu_torch.data import tokenization as port_tok  # noqa: E402
from x2vlm_tpu_torch.data.tokenization import (  # noqa: E402
    TextPreprocessor, XLMRUnigram, build_tokenizer,
)

WORDS = {
    "en": "the a dog cat runs over river bank small red house tree man woman street "
          "playing holding standing picture of two people".split(),
    "de": "der die das hund katze läuft über fluss kleines rotes haus baum mann frau "
          "straße spielt".split(),
    "fr": "le la chien chat court sur rivière petite maison rouge arbre homme femme rue "
          "joue été".split(),
    "es": "el la perro gato corre sobre río pequeña casa roja árbol hombre mujer calle "
          "niño".split(),
    "ru": "собака кошка бежит через реку маленький красный дом дерево мужчина женщина "
          "улица".split(),
    "zh": list("一只狗在河边奔跑小红房子树男人女人街道上玩"),
}
# the character map: fullwidth letters, a ligature to two letters, a
# compatibility digit, e + combining acute composed, and a key whose
# shortest prefix is itself a key (ｋ and ｋ + combining acute)
CHARSMAP = {"ａ": "a", "ｂ": "b", "Ａ": "a", "ｋ": "k", "ｋ́": "K", "ﬁ": "fi",
            "①": "1", "é": "é", "…": "...", "　": " "}
TEXTS = [
    "a dog runs over the river bank",
    "Der kleine Hund läuft über die Straße",
    "une petite maison rouge près de la rivière",
    "El niño juega en la calle",
    "Маленькая собака бежит через реку",
    "一只狗在河边奔跑",
    "ｆｕｌｌ ｗｉｄｔｈ ａｂ Ａ and the ﬁne ① …",
    "café ｋ́ ｋ éé",
    "two  spaces   and　ideographic",
    "  leading and trailing  ",
    "unknown שלום 😀 ∑ symbols",
    "<s> a <mask> dog </s>",
    "",
    "x" * 40,
]
FUZZ_ALPHABET = ("".join(sorted({c for ws in WORDS.values() for w in ws for c in w}))
                 + "".join(CHARSMAP) + "́̈ .,!?'-0123456789ABCDEFXYZשל😀∑　"
                 + "ÀÉÎÕÜñç")


def _darts(values):
    """A darts-clone double array of byte keys -> values: each node's
    children at (its base) ^ label, a leaf (label 0) at the base itself,
    every base used once, the array padded to a block of 256 units."""
    root = {}
    for key, v in values.items():
        node = root
        for b in key.encode("utf-8"):
            node = node.setdefault(b, {})
        node[None] = v
    units, used, bases = {}, {0}, set()
    queue = [(root, 0, 0)]
    while queue:
        node, pos, label = queue.pop(0)
        labels = sorted(k for k in node if k is not None)
        need = ([0] if None in node else []) + labels
        base = 1
        while base in bases or any((base ^ c) in used for c in need):
            base += 1
        bases.add(base)
        unit = ((pos ^ base) << 10) | label
        if None in node:
            unit |= 1 << 8
            used.add(base)
            units[base] = node[None] | (1 << 31)
        units[pos] = unit
        for c in labels:
            used.add(base ^ c)
            queue.append((node[c], base ^ c, c))
    n = (max(units) | 255) + 1
    return [units.get(i, 0) for i in range(n)]


def charsmap_blob(mapping):
    pool, offsets = b"", {}
    for k, v in mapping.items():
        offsets[k] = len(pool)
        pool += v.encode("utf-8") + b"\0"
    units = _darts(offsets)
    trie = struct.pack(f"<{len(units)}I", *units)
    return struct.pack("<I", len(trie)) + trie + pool


def corpus(n=600, seed=0):
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        ws = WORDS[list(WORDS)[i % len(WORDS)]]
        k = int(rng.integers(3, 12))
        sep = "" if ws is WORDS["zh"] else " "
        lines.append(sep.join(ws[j] for j in rng.integers(0, len(ws), k)))
    return lines


def write_xlmr_dir(root, vocab_size=400):
    """``root/xlm-roberta-test/tokenizer.json``: a trained Unigram with the
    XLM-R specials (``<s> <pad> </s> <unk>`` first, ``<mask>`` last)."""
    from tokenizers import Tokenizer, decoders, models, normalizers, pre_tokenizers, processors
    from tokenizers import trainers

    tok = Tokenizer(models.Unigram())
    tok.normalizer = normalizers.Sequence([
        normalizers.Precompiled(charsmap_blob(CHARSMAP)),
        normalizers.Replace(tokenizers.Regex(" {2,}"), " ")])
    tok.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁", prepend_scheme="always")
    tok.decoder = decoders.Metaspace(replacement="▁", prepend_scheme="always")
    trainer = trainers.UnigramTrainer(vocab_size=vocab_size, unk_token="<unk>",
                                      special_tokens=["<s>", "<pad>", "</s>", "<unk>"],
                                      shrinking_factor=0.75, n_sub_iterations=2)
    tok.train_from_iterator(corpus(), trainer=trainer)
    spec = json.loads(tok.to_str())
    mask_id = len(spec["model"]["vocab"])
    spec["model"]["vocab"].append(["<mask>", 0.0])
    spec["added_tokens"].append({"id": mask_id, "content": "<mask>", "single_word": False,
                                 "lstrip": True, "rstrip": False, "normalized": False,
                                 "special": True})
    spec["post_processor"] = json.loads(processors.TemplateProcessing(
        single="<s> $A </s>", pair="<s> $A </s> </s> $B </s>",
        special_tokens=[("<s>", 0), ("</s>", 2)]).__getstate__())
    d = root / "xlm-roberta-test"
    d.mkdir()
    (d / "tokenizer.json").write_text(json.dumps(spec, ensure_ascii=False))
    return str(d)


@pytest.fixture(scope="module")
def xlmr_dir(tmp_path_factory):
    return write_xlmr_dir(tmp_path_factory.mktemp("xlmr"))


@pytest.fixture(scope="module")
def both(xlmr_dir):
    return build_tokenizer(xlmr_dir), jax_build_tokenizer(xlmr_dir)


def test_the_written_file_is_what_the_test_means(both, xlmr_dir):
    port, hf = both
    assert isinstance(port, XLMRUnigram)
    assert type(hf).__name__ == "XLMRobertaTokenizerFast"
    spec = json.load(open(f"{xlmr_dir}/tokenizer.json"))
    assert spec["normalizer"]["normalizers"][0]["type"] == "Precompiled"
    assert "".join(hf.tokenize("ａｂ ﬁ")).replace("▁", "") == "abfi"   # the map applies


@pytest.mark.parametrize("text", TEXTS)
def test_pieces_and_ids_equal_xlm_roberta_fast(both, text):
    port, hf = both
    assert port.tokenize(text) == hf.tokenize(text), text
    assert port.convert_tokens_to_ids(port.tokenize(text)) == \
        hf.convert_tokens_to_ids(hf.tokenize(text))


@settings(max_examples=150, deadline=None, derandomize=True)
@given(st.text(alphabet=FUZZ_ALPHABET, max_size=40))
def test_fuzz_of_mixed_script_text_equals_xlm_roberta_fast(both, text):
    port, hf = both
    assert port.tokenize(text) == hf.tokenize(text), ascii(text)


@settings(max_examples=150, deadline=None, derandomize=True)
@given(st.text(alphabet=FUZZ_ALPHABET, max_size=24))
def test_charsmap_equals_the_precompiled_normalizer(text):
    from tokenizers import normalizers

    want = normalizers.Precompiled(charsmap_blob(CHARSMAP)).normalize_str(text)
    assert port_tok._Charsmap(charsmap_blob(CHARSMAP))(text) == want, ascii(text)


def test_vocab_order_and_specials_equal_xlm_roberta_fast(both):
    port, hf = both
    assert port.get_vocab() == hf.get_vocab()
    by_id = lambda v: [t for t, _ in sorted(v.items(), key=lambda kv: kv[1])]
    assert by_id(port.get_vocab()) == by_id(hf.get_vocab())
    for name in ("cls_token", "sep_token", "eos_token", "bos_token", "pad_token", "mask_token",
                 "unk_token"):
        assert getattr(port, name) == str(getattr(hf, name)), name
    assert port.pad_token_id == hf.pad_token_id
    assert port.mask_token_id == hf.mask_token_id == len(port.get_vocab()) - 1
    assert port.convert_tokens_to_ids("never-a-piece") == hf.unk_token_id


def test_build_tokenizer_families(tmp_path, xlmr_dir):
    with pytest.raises(NotImplementedError, match="A8d"):
        build_tokenizer(str(tmp_path / "roberta-base"))
    with pytest.raises(FileNotFoundError):
        build_tokenizer(str(tmp_path / "xlm-roberta-missing"))
    assert isinstance(build_tokenizer(f"{xlmr_dir}/tokenizer.json"), XLMRUnigram)


def test_an_unread_normalizer_is_refused_by_name(tmp_path, xlmr_dir):
    spec = json.load(open(f"{xlmr_dir}/tokenizer.json"))
    spec["normalizer"] = {"type": "NFD"}
    p = tmp_path / "tokenizer.json"
    p.write_text(json.dumps(spec))
    with pytest.raises(NotImplementedError, match="NFD"):
        XLMRUnigram(str(p))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_text_preprocessor_with_masking_equals_jax(xlmr_dir, both, seed):
    """Ids, attention, masked ids, positions and labels equal the JAX
    ``TextPreprocessor``'s (built, as the JAX launcher builds the CCLM one,
    without ``use_roberta``) from the same ``random.Random`` seed."""
    kw = dict(max_tokens=16, max_words=16, max_masks=5, mask_prob=0.5,
              skipgram_prb=0.2, skipgram_size=3)
    port = TextPreprocessor(both[0], rng=random.Random(seed), **kw)
    jax_pre = JaxTextPreprocessor(both[1], rng=random.Random(seed), **kw)
    for text in TEXTS + corpus(12, seed=seed + 1):
        got, want = port(text, with_masking=True), jax_pre(text, with_masking=True)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w, err_msg=text)
        for g, w in zip(port(text), jax_pre(text)):
            np.testing.assert_array_equal(g, w, err_msg=text)
