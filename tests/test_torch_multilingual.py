"""The multilingual and parallel-text streams and the CCLM launcher against
the JAX package: ``ImageMultiTextStream``, ``RegionMultiTextStream`` (with
and without ``code_switch``) and ``ParaTextStream`` give the JAX package's
samples bit for bit (XLM-R tokenizer of tests/test_torch_xlmr_tokenizer.py
on both sides); ``pretrain_loop`` draws the parallel-text stream's
generators from stream 4 and prefixes its metrics ``mtext_``; the launcher
runs the shipped ``configs/pretrain/cclm_x2vlm_base.yaml`` (its data paths
pointed at a corpus written here, a tiny model, an X2-VLM ``.th`` split
into the Plus base by ``is_xvlm_ckpt``) with an exact ``--resume``, the
parallel-text cursor included, and ``--task retrieval`` on ``model_type:
cclm``; ``native_aug: auto`` runs the native data plane where it builds,
``false`` PIL."""

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
from x2vlm_tpu.data import transforms as JT  # noqa: E402
from x2vlm_tpu.data.multilingual import (  # noqa: E402
    ImageMultiTextStream as JaxImageMultiTextStream, ParaTextStream as JaxParaTextStream,
    RegionMultiTextStream as JaxRegionMultiTextStream, choose_language as jax_choose_language,
)
from x2vlm_tpu.data.streaming import DistLineReader as JaxDistLineReader  # noqa: E402
from x2vlm_tpu.data.tokenization import (  # noqa: E402
    TextPreprocessor as JaxTextPreprocessor, build_tokenizer as jax_build_tokenizer,
)
from x2vlm_tpu_torch import run  # noqa: E402
from x2vlm_tpu_torch.core.config import load_config  # noqa: E402
from x2vlm_tpu_torch.data import transforms as T  # noqa: E402
from x2vlm_tpu_torch.data.multilingual import (  # noqa: E402
    ImageMultiTextStream, ParaTextStream, RegionMultiTextStream, choose_language,
)
from x2vlm_tpu_torch.data.streaming import DistLineReader  # noqa: E402
from x2vlm_tpu_torch.data.tokenization import TextPreprocessor, build_tokenizer  # noqa: E402
from x2vlm_tpu_torch.models import (  # noqa: E402
    BEiT2Config, BertConfig, XVLMConfig, XVLMForPretrain,
)
from x2vlm_tpu_torch.tasks import pretrain as port_pretrain  # noqa: E402
from x2vlm_tpu_torch.train.checkpoint import TRAIN_STATE_FILE  # noqa: E402

LANGS = ["en", "de", "fr", "cs", "ja", "zh", "ru", "es"]
WORDS = {"en": "a dog runs over the river bank small red house".split(),
         "de": "der hund läuft über den fluss kleines rotes haus".split(),
         "fr": "le chien court sur la rivière petite maison rouge".split(),
         "es": "el perro corre sobre el río pequeña casa roja".split(),
         "ru": "собака бежит через реку маленький красный дом".split(),
         "zh": list("一只狗在河边奔跑小红房子")}
IMAGE_RES, PATCH = 32, 16


def _png(rng, w=40, h=40):
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8)).save(buf, format="PNG")
    return buf.getvalue()


def _cap(rng, lang, n=6):
    ws = WORDS[lang]
    return ("" if lang == "zh" else " ").join(ws[i] for i in rng.integers(0, len(ws), n))


def _captions(rng):
    """Some of the config's languages (cs and ja never: no caption), one
    of them empty now and then."""
    langs = [lang for lang in WORDS if rng.random() < 0.6] or ["en"]
    caps = {lang: _cap(rng, lang) for lang in langs}
    if len(langs) > 1 and rng.random() < 0.3:
        caps[langs[0]] = ""
    return caps


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("cclm")
    xlmr = write_xlmr_dir(d)
    rng = np.random.default_rng(0)
    with open(d / "img.jsonl", "w") as f:
        for i in range(12):
            line = {"binary": base64.b64encode(_png(rng)).decode(), "caption": _captions(rng)}
            if i == 7:
                line["caption"] = {"it": "x"}            # no caption of the languages: broken
            f.write(json.dumps(line, ensure_ascii=False) + "\n")
    for name, multi in (("regions_multi.jsonl", True), ("regions.jsonl", False)):
        with open(d / name, "w") as f:
            for _ in range(8):
                w, h = int(rng.integers(40, 60)), int(rng.integers(40, 60))
                elems = []
                for _ in range(int(rng.integers(1, 4))):
                    bw, bh = int(rng.integers(4, w // 2)), int(rng.integers(4, h // 2))
                    x, y = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
                    cap = ({lang: _cap(rng, lang, 3) for lang in ("en", "de", "fr")
                            if rng.random() < 0.8} or {"en": "a dog"}) if multi \
                        else _cap(rng, "en", 3)
                    elems.append({"bb": [x, y, bw, bh], "caption": cap})
                line = {"binary": base64.b64encode(_png(rng, w, h)).decode(), "elems": elems}
                if rng.random() < 0.5:
                    line["caption"] = ({"en": _cap(rng, "en"), "de": _cap(rng, "de")}
                                       if multi else _cap(rng, "en"))
                f.write(json.dumps(line, ensure_ascii=False) + "\n")
    with open(d / "para.jsonl", "w") as f:
        for i in range(12):
            a, b = rng.choice(list(WORDS), 2, replace=False)
            line = {"text1" if i % 3 else "text": _cap(rng, a), "text2": _cap(rng, b)}
            f.write(json.dumps(line, ensure_ascii=False) + "\n")
    return d, xlmr


def _pre(xlmr, seed, port=True, max_tokens=12):
    kw = dict(max_tokens=max_tokens, max_words=max_tokens, max_masks=4,
              rng=random.Random(seed))
    if port:
        return TextPreprocessor(build_tokenizer(xlmr), **kw)
    return JaxTextPreprocessor(jax_build_tokenizer(xlmr), **kw)


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            if k == "rows":
                _assert_same(g[k], w[k])
            else:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_choose_language_equals_jax():
    caps = {"en": "a", "de": "", "fr": "c", "zh": "d"}
    for seed in range(5):
        assert choose_language(caps, LANGS, random.Random(seed)) == \
            jax_choose_language(caps, LANGS, random.Random(seed))
    with pytest.raises(ValueError):
        choose_language({"cs": ""}, LANGS, random.Random(0))


@pytest.mark.parametrize("seed", [0, 1])
def test_image_multi_text_stream_equals_jax(corpus, seed):
    d, xlmr = corpus
    path = [str(d / "img.jsonl")]
    streams = []
    for port in (True, False):
        kw = dict(languages=LANGS, caption_key="caption", rng=random.Random(seed))
        if port:
            streams.append(ImageMultiTextStream(
                DistLineReader(path, seed=1), _pre(xlmr, seed + 1),
                T.pretrain_transform(IMAGE_RES, rng=random.Random(seed + 2), as_float=False),
                **kw))
        else:
            streams.append(JaxImageMultiTextStream(
                JaxDistLineReader(path, seed=1), _pre(xlmr, seed + 1, port=False),
                JT.pretrain_transform(IMAGE_RES, rng=random.Random(seed + 2), as_float=False),
                **kw))
    got, want = ([s for s, _ in zip(st, range(20))] for st in streams)
    _assert_same(got, want)
    assert streams[0].broken == streams[1].broken == 2     # line 7, in both epochs read


@pytest.mark.parametrize("code_switch,multi", [(True, True), (False, True), (True, False)])
def test_region_multi_text_stream_equals_jax(corpus, code_switch, multi):
    d, xlmr = corpus
    path = [str(d / ("regions_multi.jsonl" if multi else "regions.jsonl"))]
    kw = dict(image_res=IMAGE_RES, patch_size=PATCH, max_regions=3, min_perc_in_image=0.5,
              careful_hflip=True, languages=["en", "de", "fr"], code_switch=code_switch)
    port = RegionMultiTextStream(DistLineReader(path, seed=1), _pre(xlmr, 3),
                                 T.box_transform(random.Random(4)), rng=random.Random(5), **kw)
    ref = JaxRegionMultiTextStream(JaxDistLineReader(path, seed=1),
                                   _pre(xlmr, 3, port=False), JT.box_transform(random.Random(4)),
                                   rng=random.Random(5), **kw)
    got, want = ([s for s, _ in zip(st, range(12))] for st in (port, ref))
    _assert_same(got, want)
    assert port.broken == ref.broken


@pytest.mark.parametrize("seed", [0, 1])
def test_para_text_stream_equals_jax(corpus, seed):
    d, xlmr = corpus
    path = [str(d / "para.jsonl")]
    port = ParaTextStream(DistLineReader(path, seed=1), _pre(xlmr, seed),
                          rng=random.Random(seed + 7))
    ref = JaxParaTextStream(JaxDistLineReader(path, seed=1), _pre(xlmr, seed, port=False),
                            rng=random.Random(seed + 7))
    got, want = ([s for s, _ in zip(st, range(16))] for st in (port, ref))
    _assert_same(got, want)
    assert set(got[0]) == {"text_ids", "text_atts", "text_ids_masked", "masked_pos",
                           "masked_ids", "text_ids_2", "text_atts_2"}
    assert port.broken == ref.broken == 0


# ---- the launcher on the shipped CCLM config ----

def _th(d):
    """A tiny X2-VLM (Base) ``.th``: 4 text layers, fusion at 2."""
    path = d / "x2vlm_tiny.th"
    if not path.exists():
        cfg = XVLMConfig(vision=BEiT2Config(image_res=IMAGE_RES, patch_size=PATCH, embed_dim=32,
                                            depth=2, num_heads=2),
                         text=BertConfig(vocab_size=40, hidden_size=32, num_layers=4,
                                         fusion_layer=2, num_heads=2, intermediate_size=64,
                                         encoder_width=32, max_position_embeddings=16),
                         embed_dim=256)   # the shipped config's
        base = XVLMForPretrain(cfg, dtype=torch.float32, device="cpu", seed=3).base
        torch.save({"model": base.state_dict()}, path)
    return path


def _shipped(corpus, **extra):
    """configs/pretrain/cclm_x2vlm_base.yaml with its data paths pointed at
    the corpus and a tiny model (the region and parallel-text blocks cut)."""
    d, xlmr = corpus
    cfg = load_config("configs/pretrain/cclm_x2vlm_base.yaml").to_dict()
    assert cfg["model_type"] == "cclm" and cfg["is_xvlm_ckpt"] and cfg["replace_text_encoder"]
    del cfg["vision_config"]
    vocab = len(build_tokenizer(xlmr).get_vocab())
    cfg.update(
        train_file=[str(d / "img.jsonl")], train_file_regions=[str(d / "regions.jsonl")],
        train_file_mtext=[str(d / "para.jsonl")],
        images=dict(cfg["images"], batch_size=4, num_workers=2),
        regions=dict(cfg["regions"], batch_size=6, max_images=3, num_workers=2),
        mtexts=dict(cfg["mtexts"], batch_size=4, max_tokens=10, num_workers=2),
        train_dataset_size=4, image_res=IMAGE_RES, text_encoder=xlmr,
        vision_config_inline={"vision_width": 32, "patch_size": PATCH,
                              "num_hidden_layers": 2, "num_attention_heads": 2},
        text_num_hidden_layers=2, text_fusion_start_at=2, num_cross_layers=2,
        xvlm_ckpt_text_num_hidden_layers=2,
        text_config_inline={"vocab_size": vocab, "hidden_size": 32, "num_heads": 2,
                            "intermediate_size": 64, "max_position_embeddings": 16},
        max_tokens=12, max_words=12, max_masks=3)
    cfg.update(extra)
    return cfg


def _main(corpus, name, cfg, task, *extra):
    d = corpus[0]
    path = d / f"cfg_{name}.json"
    path.write_text(json.dumps(cfg))
    return run.main(["--task", task, "--config", str(path), "--output_dir",
                     str(d / f"out_{name}"), "--seed", "0", "--device", "cpu", *extra])


def _state(corpus, name):
    return torch.load(corpus[0] / f"out_{name}" / "ckpt" / TRAIN_STATE_FILE, weights_only=False)


def test_launcher_runs_the_shipped_cclm_config_and_resumes_exactly(corpus, capsys):
    """2 steps in one run equal 1 step, --resume, 1 more, each from the
    split ``.th``: parameters, AdamW state and the cursors of the image,
    region and parallel-text streams bit for bit (dropout on)."""
    th = str(_th(corpus[0]))
    cfg = _shipped(corpus)
    rec = _main(corpus, "whole", cfg, "pretrain", "--epoch", "2", "--checkpoint", th)
    report = [line for line in capsys.readouterr().out.splitlines()
              if line.startswith("### imported") or line.startswith("###   ")]
    # XLM-R and the MLM decoder bias fresh (38 leaves); the cross encoder and
    # the MLM head's transform from the .th
    assert "0 unexpected keys, 38 missing" in report[0] and "fully-fresh" not in report[0]
    assert [line.split(":")[0] for line in report[1:]] == ["###   text_encoder"]
    assert rec["pretrain_steps"] == [0, 2]
    for k in ("image_loss_itc", "image_loss_itm", "image_loss_mlm", "region_loss_bbox",
              "region_loss_giou", "mtext_loss_ttc", "mtext_loss_ttm", "mtext_loss_mlm",
              "grad_norm"):
        assert np.isfinite(rec[k]) and rec[k] > 0, k
    _main(corpus, "split", cfg, "pretrain", "--epoch", "1", "--checkpoint", th)
    rec2 = _main(corpus, "split", cfg, "pretrain", "--epoch", "2", "--resume",
                 "--checkpoint", th)
    assert rec2["pretrain_steps"] == [1, 2]
    whole, split = _state(corpus, "whole"), _state(corpus, "split")
    assert set(whole["data_state"]) == {"image", "region", "mtext"}
    assert whole["data_state"] == split["data_state"]
    assert whole["data_state"]["mtext"]["line_idx"] == 8
    assert any(k.startswith("base.cross_encoder.") for k in whole["params"])
    for part in ("params", "mu", "nu"):
        assert whole[part].keys() == split[part].keys()
        for k in whole[part]:
            assert torch.equal(whole[part][k], split[part][k]), (part, k)


def test_multilingual_region_block_and_code_switch_reach_the_launcher(corpus, monkeypatch):
    """A ``languages`` region block builds the multilingual region stream
    with the block's ``code_switch``; the parallel text's keys come from
    ``source_key`` / ``target_key``."""
    seen = {}
    real_loop = port_pretrain.pretrain_loop

    def loop(model, optimizer, streams, **kw):
        seen["region"] = next(streams.region)
        seen["mtext"] = next(streams.mtext)
        return real_loop(model, optimizer, streams, **dict(kw, num_steps=0))

    monkeypatch.setattr(port_pretrain, "pretrain_loop", loop)
    d = corpus[0]
    made = []
    real_init = RegionMultiTextStream.__init__

    def spy(self, *a, **kw):
        made.append(kw["code_switch"])
        real_init(self, *a, **kw)

    monkeypatch.setattr(RegionMultiTextStream, "__init__", spy)
    with open(d / "para_swapped.jsonl", "w") as f:
        for line in open(d / "para.jsonl"):
            ann = json.loads(line)
            f.write(json.dumps({"src": ann.get("text1", ann.get("text")),
                                "tgt": ann["text2"]}, ensure_ascii=False) + "\n")
    cfg = _shipped(corpus, train_file_regions=[str(d / "regions_multi.jsonl")],
                   train_file_mtext=[str(d / "para_swapped.jsonl")])
    cfg["regions"] = dict(cfg["regions"], languages=["en", "de"], code_switch=False)
    cfg["mtexts"] = dict(cfg["mtexts"], source_key="src", target_key="tgt")
    _main(corpus, "options", cfg, "pretrain")
    assert made == [False]
    assert seen["region"]["text_ids"].shape == (6, 12)
    assert seen["mtext"]["text_ids_2"].shape == (4, 10)


def test_the_parallel_text_stream_draws_from_stream_four(monkeypatch):
    """Each step's parallel-text batch goes through the Plus model with no
    image, its generators seeded by stream 4, its losses as ``mtext_*``."""
    calls = []
    real = port_pretrain.step_generators

    def spy(device, seed, step, stream):
        calls.append((step, stream))
        return real(device, seed, step, stream)

    monkeypatch.setattr(port_pretrain, "step_generators", spy)
    got = []

    class Model(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.ones(()))

        def forward(self, batch, generator=None, dropout_generator=None, **kw):
            got.append((batch["image"], "text_ids_2" in batch))
            return {"loss_ttc": self.w * 1.0}

    from x2vlm_tpu_torch.train import create_optimizer, lr_schedule

    model = Model()
    opt = create_optimizer(model, lr_schedule(1e-3, 10))
    batches = iter([{"image": np.zeros((1, 2, 2, 3), np.float32)}] * 2)
    mbatches = iter([{"text_ids_2": np.zeros((1, 3), np.int32)}] * 2)
    streams = port_pretrain.PretrainStreams(image=batches, mtext=mbatches, mtext_weight=1.0)
    logger = port_pretrain.pretrain_loop(model, opt, streams, num_steps=2, seed=0,
                                         to_device=lambda b: {k: torch.as_tensor(v)
                                                              for k, v in b.items()})
    assert calls == [(0, 0), (0, 4), (1, 0), (1, 4)]
    assert [g[1] for g in got] == [False, True, False, True] and got[1][0] is None
    assert "mtext_loss_ttc" in logger.to_dict()


def test_retrieval_runs_on_model_type_cclm(corpus):
    d, xlmr = corpus
    ann = []
    rng = np.random.default_rng(1)
    (d / "imgs").mkdir(exist_ok=True)
    for i in range(8):
        (d / "imgs" / f"im{i}.png").write_bytes(_png(rng))
        ann.append({"image": f"im{i}.png", "image_id": i,
                    "caption": [_cap(rng, "de"), _cap(rng, "en")]})
    (d / "ret.json").write_text(json.dumps(ann, ensure_ascii=False))
    cfg = _shipped(corpus)
    for k in ("train_file_regions", "train_file_mtext", "regions", "mtexts", "images"):
        cfg.pop(k)
    cfg.update(train_file=[str(d / "ret.json")], test_file=[str(d / "ret.json")],
               image_root=str(d / "imgs"), k_test=4, batch_size=4, batch_size_test=4,
               schedular={"epochs": 1, "num_warmup_steps": 1})
    rec = _main(corpus, "ret", cfg, "retrieval", "--checkpoint", str(_th(d)))
    assert np.isfinite(rec["loss_itc"]) and np.isfinite(rec["loss_itm"])
    assert np.isfinite(rec["eval_r_mean"])
    state = _state(corpus, "ret")
    assert any(k.startswith("cross_encoder.") for k in state["params"])
    assert any(k.startswith("text_encoder.roberta.") for k in state["params"])


@pytest.mark.parametrize("native_aug", ["auto", False])
def test_native_aug_auto_runs_native_and_false_runs_pil(corpus, native_aug, monkeypatch):
    """``native_aug: auto`` (the default) decodes the image and region
    streams with the native data plane where it builds (uint8 images from
    the C++ transforms), ``false`` with PIL, as the JAX launcher; the run
    reads one batch of each stream and takes no step."""
    from x2vlm_tpu_torch.data.native import native_available

    seen, real_loop = {}, port_pretrain.pretrain_loop

    def loop(model, optimizer, streams, **kw):
        seen["image"], seen["region"] = next(streams.image), next(streams.region)
        return real_loop(model, optimizer, streams, **dict(kw, num_steps=0))

    monkeypatch.setattr(port_pretrain, "pretrain_loop", loop)
    cfg = _shipped(corpus, native_aug=native_aug)
    cfg["train_file_mtext"] = []
    rec = _main(corpus, f"aug_{native_aug}", cfg, "pretrain", "--epoch", "1")
    want = "native" if native_aug == "auto" and native_available() else "pil"
    assert rec["data_plane"] == {"image": want, "region": want}
    assert seen["image"]["image"].dtype == np.uint8     # both paths: on-device normalise
    assert seen["region"]["image"].dtype == (np.uint8 if want == "native" else np.float32)
