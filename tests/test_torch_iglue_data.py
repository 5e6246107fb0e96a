"""The IGLUE host side against the JAX package: ``WITRetrievalDataset``
(base64 images, a line without a caption dropped), ``XFlickrCODataset``
(lines of one id sharing an image), ``XVNLIDataset`` (an unlabeled line
dropped) and ``MARVLDataset`` (both annotation forms, with and without an
image root) give the JAX package's samples, retrieval tables and labels bit
for bit on files written here; ``create_dataset`` builds the six IGLUE tasks
as the JAX factory does (``{lang: path}`` test files, MARVL's ``en``
branch, xGQA's ``[path, answer list]`` pairs); ``--fewshot`` fills the
config's path templates as the JAX ``setup`` does in its three variants;
``WordpieceTokenizerWithDropout`` over the port's WordPiece gives the JAX
one's pieces (over ``transformers``' ``BertTokenizer``) from the same
``random.Random`` state at dropout 0, 0.1 and 1. The captions are
multilingual, tokenised by the XLM-R tokenizer of
tests/test_torch_xlmr_tokenizer.py on both sides."""

import base64
import io
import json
import random

import numpy as np
import pytest
from PIL import Image

torch = pytest.importorskip("torch")
pytest.importorskip("transformers")
pytest.importorskip("tokenizers")

from tests.test_torch_xlmr_tokenizer import write_xlmr_dir  # noqa: E402
from x2vlm_tpu import run as jax_run  # noqa: E402
from x2vlm_tpu.data import transforms as JT  # noqa: E402
from x2vlm_tpu.data.factory import create_dataset as jax_create_dataset  # noqa: E402
from x2vlm_tpu.data.iglue import (  # noqa: E402
    MARVLDataset as JaxMARVLDataset, WITRetrievalDataset as JaxWITRetrievalDataset,
    XFlickrCODataset as JaxXFlickrCODataset, XVNLIDataset as JaxXVNLIDataset,
)
from x2vlm_tpu.data.tokenization import (  # noqa: E402
    TextPreprocessor as JaxTextPreprocessor, build_tokenizer as jax_build_tokenizer,
)
from x2vlm_tpu.data.tokenization_dropout import (  # noqa: E402
    WordpieceTokenizerWithDropout as JaxWordpieceTokenizerWithDropout,
)
from x2vlm_tpu_torch import run  # noqa: E402
from x2vlm_tpu_torch.data import transforms as T  # noqa: E402
from x2vlm_tpu_torch.data.factory import create_dataset  # noqa: E402
from x2vlm_tpu_torch.data.iglue import (  # noqa: E402
    MARVLDataset, WITRetrievalDataset, XFlickrCODataset, XVNLIDataset,
)
from x2vlm_tpu_torch.data.tokenization import (  # noqa: E402
    BertWordPiece, TextPreprocessor, build_tokenizer,
)
from x2vlm_tpu_torch.data.tokenization_dropout import (  # noqa: E402
    WordpieceTokenizerWithDropout,
)

RES = 32
WORDS = {"en": "a dog runs over the river bank small red house".split(),
         "de": "der hund läuft über den fluss kleines rotes haus".split(),
         "fr": "le chien court sur la rivière petite maison rouge".split(),
         "ru": "собака бежит через реку маленький красный дом".split(),
         "zh": list("一只狗在河边奔跑小红房子")}
LANGS = ("de", "fr", "ru", "zh")


def _cap(rng, lang, n=6):
    ws = WORDS[lang]
    return ("" if lang == "zh" else " ").join(ws[i] for i in rng.integers(0, len(ws), n))


def _image_bytes(rng, fmt="PNG"):
    w, h = int(rng.integers(30, 50)), int(rng.integers(30, 50))
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8)).save(buf, format=fmt)
    return buf.getvalue()


def _jsonl(path, rows):
    path.write_text("".join(json.dumps(r, ensure_ascii=False) + "\n" for r in rows))
    return str(path)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("iglue")
    xlmr = write_xlmr_dir(d)
    rng = np.random.default_rng(0)
    (d / "imgs").mkdir()
    for i in range(6):
        (d / "imgs" / f"im{i}.png").write_bytes(_image_bytes(rng))
        (d / "imgs" / f"{1000 + i}.jpg").write_bytes(_image_bytes(rng, "JPEG"))
    for lang in ("en",) + LANGS:
        wit = [{"image_content": base64.b64encode(_image_bytes(rng)).decode(),
                "image_url": f"http://example.org/{lang}{i}.png",
                "caption_reference_description": _cap(rng, lang)} for i in range(5)]
        wit[2]["caption_reference_description"] = ""          # dropped
        _jsonl(d / f"wit_{lang}.jsonl", wit)
        _jsonl(d / f"xflickrco_{lang}.jsonl", [
            {"id": i // 2, "img_path": f"im{i // 2}.png",
             "sentences": [_cap(rng, lang) for _ in range(1 + i % 2)]} for i in range(6)])
        labels = ["contradiction", "entailment", "neutral", "-", "entailment"]
        _jsonl(d / f"xvnli_{lang}.jsonl", [
            {"Flikr30kID": str(1000 + i), "sentence2": _cap(rng, lang), "gold_label": g}
            for i, g in enumerate(labels)])
        _jsonl(d / f"marvl_{lang}.jsonl", [
            {"left_img": f"im{i}.png", "right_img": f"im{i + 1}.png",
             "caption": _cap(rng, lang), "label": [True, "false", "True", False][i]}
            for i in range(4)])
        _jsonl(d / f"marvl_abs_{lang}.jsonl", [
            {"images": [str(d / "imgs" / f"im{i}.png"), str(d / "imgs" / f"im{5 - i}.png")],
             "sentence": _cap(rng, lang), "label": "True" if i % 2 else "False"}
            for i in range(3)])
        gqa = [{"image": f"im{i % 6}.png", "question": _cap(rng, lang), "question_id": i,
                "answer": _cap(rng, "en", 2)} for i in range(5)]
        (d / f"gqa_{lang}.json").write_text(json.dumps(gqa, ensure_ascii=False))
        (d / f"answers_{lang}.json").write_text(json.dumps(
            [_cap(rng, "en", 1 + i % 3) for i in range(9)], ensure_ascii=False))
    nlvr = [{"images": [f"im{i}.png", f"im{(i + 2) % 6}.png"], "sentence": _cap(rng, "en"),
             "label": "True" if i % 2 else "False"} for i in range(5)]
    (d / "nlvr.json").write_text(json.dumps(nlvr))
    (d / "bert").mkdir()
    (d / "bert" / "vocab.txt").write_text("\n".join(
        "[PAD] [UNK] [CLS] [SEP] [MASK] a b d o g r u n s un ##s ##n ##u ##g ##o ##ing ##r "
        "dog dogs run runs running the over river ##iver ##er ##ver bank ##ank ##nk small "
        "red house ##ouse ##use ##se ##e ##d ##ed , . !".split()))
    return d, xlmr


def _pres(corpus, max_tokens=12):
    _, xlmr = corpus
    return (JaxTextPreprocessor(jax_build_tokenizer(xlmr), max_tokens=max_tokens),
            TextPreprocessor(build_tokenizer(xlmr), max_tokens=max_tokens))


def _assert_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k


def _assert_same_dataset(got, want):
    if hasattr(want, "__len__"):      # a retrieval eval set has tables only
        assert len(got) == len(want)
        for i in range(len(want)):
            _assert_equal(got[i], want[i])
    if hasattr(want, "txt2img"):
        assert got.txt2img == want.txt2img and got.img2txt == want.img2txt
        assert got.n_images() == want.n_images() and got.n_texts() == want.n_texts()
        idx = list(range(want.n_images()))
        np.testing.assert_array_equal(got.image_batch(idx), want.image_batch(idx))
        for g, w in zip(got.text_batch(list(range(want.n_texts()))),
                        want.text_batch(list(range(want.n_texts())))):
            np.testing.assert_array_equal(g, w)


# ---- the datasets ----

@pytest.mark.parametrize("lang", ["en", "zh"])
def test_wit_dataset_equals_jax(corpus, lang):
    d, _ = corpus
    jp, pp = _pres(corpus)
    f = str(d / f"wit_{lang}.jsonl")
    want = JaxWITRetrievalDataset(f, JT.test_transform(RES), jp)
    got = WITRetrievalDataset(f, T.test_transform(RES), pp)
    assert len(got) == 4     # the line without a caption dropped
    _assert_same_dataset(got, want)


@pytest.mark.parametrize("lang", ["de", "ru"])
def test_xflickrco_dataset_equals_jax(corpus, lang):
    """The train rows (one a sentence) drawn through the train transform
    from equal seeds, and the eval tables."""
    d, _ = corpus
    jp, pp = _pres(corpus)
    f = str(d / f"xflickrco_{lang}.jsonl")
    want = JaxXFlickrCODataset(f, JT.train_transform(RES, rng=random.Random(3)),
                               str(d / "imgs"), jp)
    got = XFlickrCODataset(f, T.train_transform(RES, rng=random.Random(3)), str(d / "imgs"), pp)
    assert got.n_images() == 3 and got.n_texts() == 9 and got.img2txt[0] == [0, 1, 2]
    _assert_same_dataset(got, want)


def test_xvnli_dataset_equals_jax(corpus):
    d, _ = corpus
    jp, pp = _pres(corpus)
    f = str(d / "xvnli_fr.jsonl")
    want = JaxXVNLIDataset(f, JT.test_transform(RES), str(d / "imgs"), jp)
    got = XVNLIDataset(f, T.test_transform(RES), str(d / "imgs"), pp)
    assert [int(got[i]["labels"]) for i in range(len(got))] == [0, 1, 2, 1]
    _assert_same_dataset(got, want)


@pytest.mark.parametrize("form,root", [("marvl", "imgs"), ("marvl_abs", None)])
def test_marvl_dataset_equals_jax(corpus, form, root):
    """``left_img`` / ``right_img`` lines under an image root, and NLVR2-form
    lines with absolute paths under none; ``label`` true as a bool or as
    any case of the string."""
    d, _ = corpus
    jp, pp = _pres(corpus)
    f = str(d / f"{form}_ru.jsonl")
    image_root = str(d / root) if root else None
    want = JaxMARVLDataset(f, JT.test_transform(RES), image_root, jp)
    got = MARVLDataset(f, T.test_transform(RES), image_root, pp)
    labels = [int(got[i]["labels"]) for i in range(len(got))]
    assert labels == ([1, 0, 1, 0] if form == "marvl" else [0, 1, 0])
    _assert_same_dataset(got, want)


# ---- the factory ----

def _task_cfg(corpus, task):
    d, xlmr = corpus
    cfg = {"image_res": RES, "text_encoder": xlmr, "max_tokens": 12,
           "image_root": str(d / "imgs")}
    per_lang = lambda stem, ext="jsonl": {lang: str(d / f"{stem}_{lang}.{ext}")  # noqa: E731
                                          for lang in LANGS}
    if task == "wit":
        cfg.update(train_file=[str(d / "wit_en.jsonl")], test_file=per_lang("wit"),
                   image_root="")
    elif task == "xflickrco":
        cfg.update(train_file=[str(d / "xflickrco_en.jsonl")], test_file=per_lang("xflickrco"))
    elif task == "xvnli":
        cfg.update(train_file=[str(d / "xvnli_en.jsonl")], test_file=per_lang("xvnli"))
    elif task == "marvl":
        cfg.update(train_file=[str(d / "nlvr.json")],
                   test_file=dict(per_lang("marvl"), en=str(d / "nlvr.json")),
                   marvl_image_root=str(d / "imgs"))
    elif task == "xgqa":
        # a [path, answer list] pair a language; "de" takes the config's list
        cfg.update(train_file=[str(d / "gqa_en.json")], vqa_root=str(d / "imgs"),
                   answer_list=str(d / "answers_en.json"), answer_max_tokens=6,
                   test_file={lang: str(d / f"gqa_{lang}.json") if lang == "de" else
                              [str(d / f"gqa_{lang}.json"), str(d / f"answers_{lang}.json")]
                              for lang in LANGS})
    else:   # xretrieval
        ann = [{"image": f"im{i}.png", "caption": [_cap(np.random.default_rng(i), lang)
                                                   for lang in ("en", "de")]}
               for i in range(4)]
        (d / "xre.json").write_text(json.dumps(ann, ensure_ascii=False))
        cfg.update(train_file=[str(d / "xre.json")],
                   test_file={lang: str(d / "xre.json") for lang in ("de", "fr")})
    return cfg


@pytest.mark.parametrize("task", ["xretrieval", "wit", "xflickrco", "xvnli", "marvl", "xgqa"])
def test_create_dataset_equals_jax(corpus, task):
    """The train set (from ``rng = random.Random(7)``) and the ``{lang:
    dataset}`` eval sets of each IGLUE task; xGQA's answer lists per
    language; MARVL's ``en`` set an NLVR2 set on ``image_root``."""
    cfg = _task_cfg(corpus, task)
    want_tr, want_ev = jax_create_dataset(task, cfg, rng=random.Random(7))
    got_tr, got_ev = create_dataset(task, cfg, rng=random.Random(7))
    assert type(got_tr).__name__ == type(want_tr).__name__
    _assert_same_dataset(got_tr, want_tr)
    assert isinstance(got_ev, dict) and list(got_ev) == list(want_ev)
    for lang in want_ev:
        assert type(got_ev[lang]).__name__ == type(want_ev[lang]).__name__, lang
        _assert_same_dataset(got_ev[lang], want_ev[lang])
        if task == "xgqa":
            assert got_ev[lang].answer_list == want_ev[lang].answer_list
            np.testing.assert_array_equal(got_ev[lang].answer_ids, want_ev[lang].answer_ids)
            np.testing.assert_array_equal(got_ev[lang].answer_atts, want_ev[lang].answer_atts)
            assert got_ev[lang].gt_answers() == want_ev[lang].gt_answers()
    if task == "marvl":
        assert type(got_ev["en"]).__name__ == "NLVRDataset"
    if task == "xgqa":
        assert got_ev["de"].answer_list != got_ev["fr"].answer_list
        assert (got_ev["fr"].answer_ids[:, -1] == 1).any()     # XLM-R's <pad>
    none, ev = create_dataset(task, cfg, evaluate=True)
    assert none is None and list(ev) == list(want_ev)


def test_create_dataset_refuses_an_unknown_task(corpus):
    with pytest.raises(ValueError, match="unknown dataset task"):
        create_dataset("gqa", _task_cfg(corpus, "xvnli"))


# ---- --fewshot ----

@pytest.mark.parametrize("paths,fewshot", [
    ({"train_file": ["data/{}/train_{}.jsonl", "data/plain.jsonl"],
      "test_file": "data/test_{}_{}.jsonl"}, "ar,25"),               # two slots each
    ({"train_file": "data/xvnli/{}_{}.jsonl",
      "test_file": ["data/xvnli/test_{}.jsonl"]}, "fr,10"),          # XVNLI's
    ({"train_file": ["data/marvl/{}.jsonl"], "test_file": "data/marvl/{}.json"}, "zh,48"),
])
def test_fewshot_fills_the_templates_as_jax(corpus, tmp_path, paths, fewshot):
    """Through both packages' ``setup``: two or more slots take the parts in
    order; one slot takes the language alone in ``test_file`` and
    ``<lang>,<shots>`` in ``train_file``; a path without a slot stays."""
    cfg = dict(_task_cfg(corpus, "xvnli"), **paths)
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(cfg))
    argv = ["--task", "xvnli", "--config", str(cfg_path), "--fewshot", fewshot]
    want, _ = jax_run.setup(jax_run.parse_args(argv + ["--output_dir", str(tmp_path / "j")]))
    got = run.setup(run.parse_args(argv + ["--output_dir", str(tmp_path / "p"),
                                           "--device", "cpu"]))
    for key in paths:
        assert got[key] == want[key], key
    assert "{}" not in json.dumps({k: got[k] for k in paths})


def test_fewshot_fills_the_validation_keys_as_the_jax_rule():
    """``valid_file`` takes the joined string in one slot, ``val_file`` the
    language alone (the JAX ``setup``'s rule; neither key is in the
    registry, so no config reaches ``setup`` with them)."""
    cfg = {"valid_file": "v/{}.jsonl", "val_file": ["d/{}.jsonl", "d/{}_{}.jsonl"]}
    run.fill_fewshot(cfg, "ja,5")
    assert cfg == {"valid_file": "v/ja,5.jsonl", "val_file": ["d/ja.jsonl", "d/ja_5.jsonl"]}


# ---- WordPiece dropout ----

TEXTS = ("The dogs running over the river-bank, small red houses!",
         "A dog runs; Über den Fluss. unknownword dogs, ruSSing",
         "riverbank dogsun runs rundogs")


@pytest.mark.parametrize("dropout", [0.0, 0.1, 1.0])
def test_wordpiece_dropout_equals_jax(corpus, dropout):
    """The same pieces as the JAX wrapper over ``transformers``'
    ``BertTokenizer`` (its ``basic_tokenizer``) from equal seeds; at
    dropout 0 they are the plain WordPiece's; at 1 each step takes the
    shortest match."""
    from transformers import BertTokenizer

    d, _ = corpus
    vocab = str(d / "bert" / "vocab.txt")
    port_tok = BertWordPiece(vocab)
    for seed in (0, 1, 2):
        want_tok = JaxWordpieceTokenizerWithDropout(BertTokenizer(vocab), dropout=dropout,
                                                    rng=random.Random(seed))
        got_tok = WordpieceTokenizerWithDropout(port_tok, dropout=dropout,
                                                rng=random.Random(seed))
        for _ in range(3):
            for text in TEXTS:
                assert got_tok.tokenize(text) == want_tok.tokenize(text), (seed, text)
    plain = WordpieceTokenizerWithDropout(port_tok, dropout=0.0)
    assert [plain.tokenize(t) for t in TEXTS] == [port_tok.tokenize(t) for t in TEXTS]
    shortest = WordpieceTokenizerWithDropout(port_tok, dropout=1.0)
    assert shortest.tokenize("dogs") == ["d", "##o", "##g", "##s"]
    assert shortest.pad_token_id == port_tok.pad_token_id     # the wrapped tokenizer's
