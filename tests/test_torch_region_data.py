"""The region stream's host side and its launcher against the JAX package:
``RegionTextStream`` (the box-aware crop, careful hflip, bitmaps, cxcywh
targets and the full-image row) and ``region_collate`` (its sampling and
its padding branch) give the JAX package's arrays bit for bit; the
``BOX_AUGS`` transform equals JAX's; the launcher runs the shipped
``configs/pretrain/x2vlm_base_4m.yaml`` (its data paths pointed at a
corpus written here, a tiny model) with the image, region and text
streams, and its ``--resume`` is exact, the region cursor included; a
reference ``.th`` with a bbox head imports it, and ``predict_bbox`` equals
the JAX package's on the imported weights."""

import base64
import io
import json
import random

import numpy as np
import pytest
from PIL import Image

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests.golden_torch import GoldenXVLM  # noqa: E402
from x2vlm_tpu.data import transforms as JT  # noqa: E402
from x2vlm_tpu.data.pretrain import (  # noqa: E402
    RegionTextStream as JaxRegionTextStream, region_collate as jax_region_collate,
)
from x2vlm_tpu.data.streaming import DistLineReader as JaxDistLineReader  # noqa: E402
from x2vlm_tpu.data.tokenization import (  # noqa: E402
    TextPreprocessor as JaxTextPreprocessor, build_tokenizer as jax_build_tokenizer,
)
from x2vlm_tpu.models import (  # noqa: E402
    BEiT2Config as JaxBEiT2Config, BertConfig as JaxBertConfig,
    XVLMConfig as JaxXVLMConfig, XVLMForPretrain as JaxXVLMForPretrain,
)
from x2vlm_tpu.models.heads import pretrain_init_inputs  # noqa: E402
from x2vlm_tpu.train.checkpoint import convert_xvlm_state_dict, merge_imported  # noqa: E402
from x2vlm_tpu_torch import run  # noqa: E402
from x2vlm_tpu_torch.core.config import load_config  # noqa: E402
from x2vlm_tpu_torch.data import transforms as T  # noqa: E402
from x2vlm_tpu_torch.data.pretrain import RegionTextStream, region_collate  # noqa: E402
from x2vlm_tpu_torch.data.streaming import DistLineReader  # noqa: E402
from x2vlm_tpu_torch.data.tokenization import BertWordPiece, TextPreprocessor  # noqa: E402
from x2vlm_tpu_torch.models import (  # noqa: E402
    BEiT2Config, BertConfig, XVLMConfig, XVLMForPretrain, XVLMForRetrieval,
)
from x2vlm_tpu_torch.tasks.pretrain import pretrain_loop  # noqa: E402
from x2vlm_tpu_torch.train.checkpoint import (  # noqa: E402
    TRAIN_STATE_FILE, load_reference_checkpoint,
)

VOCAB = ("[PAD] [UNK] [CLS] [SEP] [MASK] a b c d e dog cat runs the quick brown fox "
         "jump ##s ##ing over lazy river bank small big red blue green house tree left "
         "right man on").split()
WORDS = VOCAB[5:]
IMAGE_RES, PATCH = 48, 16


def _png(rng, w, h):
    low = rng.integers(0, 256, (h // 16 + 1, w // 16 + 1, 3)).astype(np.float32)
    img = np.kron(low, np.ones((16, 16, 1), np.float32))[:h, :w]
    img = np.clip(img + rng.normal(0, 12, img.shape), 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def _caption(rng, n=5):
    return " ".join(rng.choice(WORDS, n))


def _region_line(rng, i):
    """A region line: 1-4 boxes inside a W x H image, captions (a list for
    some), attributes for some, a caption naming left or right every third
    line, a full-image caption every other line; line 5 has a box outside
    its image (a broken sample)."""
    w, h = int(rng.integers(60, 100)), int(rng.integers(60, 100))
    elems = []
    for _ in range(int(rng.integers(1, 5))):
        bw, bh = int(rng.integers(4, w // 2)), int(rng.integers(4, h // 2))
        x, y = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
        cap = [_caption(rng, 3), _caption(rng, 4)] if rng.random() < 0.3 else _caption(rng, 3)
        elem = {"bb": [x, y, bw, bh], "caption": cap}
        if rng.random() < 0.4:
            elem["attributes"] = ["red", "small big"]
        elems.append(elem)
    if i % 3 == 0:
        elems[0]["caption"] = "the man on the left"
    if i == 5:
        elems = [{"bb": [w - 2, 0, 10, 10], "caption": "a dog"}]
    line = {"binary": base64.b64encode(_png(rng, w, h)).decode(), "elems": elems}
    if i % 2:
        line["caption"] = _caption(rng, 6)
    return line


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("regions")
    (d / "bert").mkdir()
    (d / "bert" / "vocab.txt").write_text("\n".join(VOCAB))
    rng = np.random.default_rng(0)
    with open(d / "regions.jsonl", "w") as f:
        for i in range(14):
            f.write(json.dumps(_region_line(rng, i)) + "\n")
    with open(d / "img.jsonl", "w") as f:
        for _ in range(8):
            f.write(json.dumps({"binary": base64.b64encode(_png(rng, 40, 40)).decode(),
                                "desc": _caption(rng, 8)}) + "\n")
    with open(d / "txt.jsonl", "w") as f:
        for _ in range(8):
            f.write(json.dumps({"text": _caption(rng, 9)}) + "\n")
    return d


def _streams(corpus, seed):
    kw = dict(image_res=IMAGE_RES, patch_size=PATCH, max_regions=3, min_perc_in_image=0.5,
              careful_hflip=True, rng=random.Random(seed))
    path = [str(corpus / "regions.jsonl")]
    port = RegionTextStream(
        DistLineReader(path, seed=1),
        TextPreprocessor(BertWordPiece(str(corpus / "bert" / "vocab.txt")), max_tokens=10,
                         max_words=10, max_masks=3, rng=random.Random(seed + 1)),
        T.box_transform(random.Random(seed + 2)), **kw)
    kw["rng"] = random.Random(seed)
    ref = JaxRegionTextStream(
        JaxDistLineReader(path, seed=1),
        JaxTextPreprocessor(jax_build_tokenizer(str(corpus / "bert")), max_tokens=10,
                            max_words=10, max_masks=3, rng=random.Random(seed + 1)),
        JT.box_transform(random.Random(seed + 2)), **kw)
    return port, ref


def _assert_samples_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["image"], w["image"])
        assert g["image"].dtype == w["image"].dtype == np.float32
        assert len(g["rows"]) == len(w["rows"])
        for gr, wr in zip(g["rows"], w["rows"]):
            assert gr.keys() == wr.keys()
            for k in gr:
                np.testing.assert_array_equal(gr[k], wr[k], err_msg=k)
                assert np.asarray(gr[k]).dtype == np.asarray(wr[k]).dtype, k


@pytest.mark.parametrize("seed", [0, 1])
def test_region_stream_equals_jax(corpus, seed):
    port, ref = _streams(corpus, seed)
    got = [s for s, _ in zip(port, range(20))]
    want = [s for s, _ in zip(ref, range(20))]
    _assert_samples_equal(got, want)
    assert port.broken == ref.broken == 2   # line 5 (its box outside its image), twice
    rows = [r for s in got for r in s["rows"]]
    assert any(r["is_image"] == 1 for r in rows) and any(r["is_image"] == 0 for r in rows)
    bitmaps = np.stack([r["image_atts"] for r in rows if r["is_image"] == 0])
    assert (bitmaps[:, 0] == 1).all() and (bitmaps[:, 1:].sum(1) < (IMAGE_RES // PATCH) ** 2).any()


@pytest.mark.parametrize("batch_size,max_images", [(5, 4), (24, 6)])
def test_region_collate_equals_jax(corpus, batch_size, max_images):
    """(5, 4): more rows than the batch, rows sampled; (24, 6): fewer, padded
    by draws with replacement, and the images padded with zero images."""
    port, _ = _streams(corpus, 3)
    samples = [s for s, _ in zip(port, range(max_images - 1))]
    got = region_collate(samples, batch_size, max_images, random.Random(9))
    want = jax_region_collate(samples, batch_size, max_images, random.Random(9))
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype, k
    assert got["image"].shape[0] == max_images and not got["image"][-1].any()
    assert got["text_ids"].shape[0] == batch_size


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_box_transform_equals_jax(seed):
    assert T.BOX_AUGS == JT.BOX_AUGS
    rng = np.random.default_rng(seed)
    img = Image.open(io.BytesIO(_png(rng, 50, 40))).convert("RGB")
    port, ref = T.box_transform(random.Random(seed)), JT.box_transform(random.Random(seed))
    for _ in range(4):
        np.testing.assert_array_equal(port(img), ref(img))


# ---- the launcher on the shipped config ----

def _shipped(corpus, **extra):
    """configs/pretrain/x2vlm_base_4m.yaml with its data paths pointed at the
    corpus and a tiny model; the region block at its own sizes."""
    cfg = load_config("configs/pretrain/x2vlm_base_4m.yaml").to_dict()
    del cfg["vision_config"]
    cfg.update(
        train_file=[str(corpus / "img.jsonl")], train_file_regions=[str(corpus / "regions.jsonl")],
        train_file_text=[str(corpus / "txt.jsonl")],
        texts={"caption_key": "text", "batch_size": 4, "iter_perc": 0.5, "num_workers": 2},
        images=dict(cfg["images"], batch_size=4, num_workers=2), train_dataset_size=4,
        image_res=IMAGE_RES, text_encoder=str(corpus / "bert"),
        vision_config_inline={"vision_width": 32, "patch_size": PATCH,
                              "num_hidden_layers": 2, "num_attention_heads": 2},
        text_num_hidden_layers=4, text_fusion_start_at=2,
        text_config_inline={"vocab_size": len(VOCAB), "hidden_size": 32, "num_heads": 2,
                            "intermediate_size": 64},
        max_tokens=10, max_words=10, max_masks=3)
    cfg.update(extra)
    return cfg


def _main(corpus, name, cfg, *extra):
    path = corpus / f"cfg_{name}.json"
    path.write_text(json.dumps(cfg))
    return run.main(["--task", "pretrain", "--config", str(path), "--output_dir",
                     str(corpus / f"out_{name}"), "--seed", "0", "--device", "cpu", *extra])


def _state(corpus, name):
    return torch.load(corpus / f"out_{name}" / "ckpt" / TRAIN_STATE_FILE, weights_only=False)


def test_launcher_runs_the_shipped_config_and_resumes_exactly(corpus):
    """2 steps in one run equal 1 step, --resume, 1 more: parameters (the
    bbox head's among them), AdamW state and the data cursors of the three
    streams, bit for bit (dropout on)."""
    cfg = _shipped(corpus)
    assert cfg["regions"]["batch_size"] == 128 and cfg["regions"]["max_images"] == 50
    rec = _main(corpus, "whole", cfg, "--epoch", "2")
    assert rec["pretrain_steps"] == [0, 2] and rec["broken"] > 0   # region line 5
    for k in ("image_loss_itc", "region_loss_itc", "region_loss_itm", "region_loss_mlm",
              "region_loss_bbox", "region_loss_giou", "text_loss_mlm", "grad_norm"):
        assert np.isfinite(rec[k]) and rec[k] > 0, k
    _main(corpus, "split", cfg, "--epoch", "1")
    rec2 = _main(corpus, "split", cfg, "--epoch", "2", "--resume")
    assert rec2["pretrain_steps"] == [1, 2]
    whole, split = _state(corpus, "whole"), _state(corpus, "split")
    assert set(whole["data_state"]) == {"image", "region", "text"}
    assert whole["data_state"] == split["data_state"]
    assert whole["data_state"]["region"]["line_idx"] > 0 or \
        whole["data_state"]["region"]["epoch"] > 0
    assert any(k.startswith("base.bbox_head.") for k in whole["params"])
    for part in ("params", "mu", "nu"):
        assert whole[part].keys() == split[part].keys()
        for k in whole[part]:
            assert torch.equal(whole[part][k], split[part][k]), (part, k)


@pytest.mark.parametrize("extra", [{"regions_use_bbox_only": True},
                                   {"calc_image_bbox_loss": True}])
def test_launcher_region_options(corpus, extra, monkeypatch):
    """Each option reaches ``pretrain_loop`` (what the loop then does with
    it is held against the JAX loop in test_torch_region.py)."""
    seen = {}

    def loop(model, optimizer, streams, **kw):
        seen.update(kw, regions_use_bbox_only=streams.regions_use_bbox_only)
        return pretrain_loop(model, optimizer, streams, **kw)

    monkeypatch.setattr("x2vlm_tpu_torch.tasks.pretrain.pretrain_loop", loop)
    rec = _main(corpus, "opt", _shipped(corpus, **extra), "--epoch", "1")
    for k in ("regions_use_bbox_only", "calc_image_bbox_loss"):
        assert seen[k] is (k in extra), k
    assert np.isfinite(rec["region_loss_bbox"]) and np.isfinite(rec["region_loss_giou"])
    if "regions_use_bbox_only" in extra:   # ITC / ITM / MLM weigh 0 in the total
        assert rec["region_loss_total"] == pytest.approx(
            rec["region_loss_bbox"] + rec["region_loss_giou"], rel=1e-5)


# ---- a reference .th with a bbox head ----

TEXT = dict(vocab_size=100, hidden_size=32, num_layers=4, fusion_layer=2, num_heads=2,
            intermediate_size=64, encoder_width=32, hidden_dropout=0.0, attn_dropout=0.0,
            max_position_embeddings=64)
VISION = dict(image_res=32, patch_size=16, embed_dim=32, depth=2, num_heads=2,
              drop_path_rate=0.0, dropout_rate=0.0)


def test_th_bbox_head_imports_and_predict_bbox_equals_jax(tmp_path):
    torch.manual_seed(0)
    golden = GoldenXVLM().eval()
    sd = golden.state_dict()
    path = tmp_path / "golden.th"
    torch.save({"model": {f"module.{k}": v for k, v in sd.items()}}, path)
    port = XVLMForPretrain(XVLMConfig(vision=BEiT2Config(**VISION), text=BertConfig(**TEXT),
                                      embed_dim=16), dtype=torch.float32, device="cpu", seed=1)
    missing, unexpected = load_reference_checkpoint(port, str(path))
    assert missing == [] and not any(k.startswith("bbox_head.") for k in unexpected)
    torch.testing.assert_close(port.base.bbox_head[3].weight, sd["bbox_head.3.weight"],
                               rtol=0, atol=0)
    # a retrieval model has no bbox head, as the JAX one has none
    retrieval = XVLMForRetrieval(XVLMConfig(vision=BEiT2Config(**VISION),
                                            text=BertConfig(**TEXT), embed_dim=16),
                                 dtype=torch.float32, device="cpu", seed=1)
    _, unexpected = load_reference_checkpoint(retrieval, str(path))
    assert {k for k in unexpected if k.startswith("bbox_head.")} == \
        {k for k in sd if k.startswith("bbox_head.")}

    cfg = JaxXVLMConfig(vision=JaxBEiT2Config(**VISION), text=JaxBertConfig(**TEXT),
                        embed_dim=16)
    model = JaxXVLMForPretrain(cfg, dtype=jnp.float32)
    init = model.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                      pretrain_init_inputs(cfg), rng=jax.random.PRNGKey(2), ret_bbox_loss=True)
    tree, _ = convert_xvlm_state_dict({k: v.numpy() for k, v in sd.items()}, vision_depth=2,
                                      dst_window=2)
    params, jax_missing = merge_imported(init, tree)
    assert not any("bbox_head" in p for p in jax_missing)
    rng = np.random.default_rng(4)
    full = rng.standard_normal((3, 5, 32)).astype(np.float32)
    text = rng.standard_normal((3, 7, 32)).astype(np.float32)
    atts = np.ones((3, 7), np.int32)
    atts[1, 3:] = 0
    want = model.apply(params, *(jnp.asarray(x) for x in (full, text, atts)),
                       method=lambda m, f, t, a: m.base.predict_bbox(f, t, a))
    with torch.no_grad():
        got = port.base.predict_bbox(*(torch.from_numpy(x) for x in (full, text, atts)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
