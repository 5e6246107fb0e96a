"""Every shipped pretraining YAML through both launchers, on the CPU.

- Each of the eight ``configs/pretrain/*.yaml`` with its data paths pointed
  at a corpus written here and a tiny inline model (``vision_config_inline``
  / ``text_config_inline``; the stacks' depths cut, the split of the text
  stack kept in proportion): the port's ``run.main --task pretrain`` builds
  the JAX launcher's streams (image, the clean-data ``aux``, region, video,
  ``video_aux``, parallel text), their loss weights, the aux replacement
  probabilities, ``stop_calc_itm`` and ``calc_image_bbox_loss``; each
  stream's first batch has the JAX one's keys and shapes (and dtypes but
  the pixels', which the port keeps uint8 to the card), and the
  image and aux streams' caption tokens equal the JAX ones bit for bit (the
  augmentation draws differ by design: the port seeds each batch's draws
  from its cursor, for an exact ``--resume``). The port's run then takes
  two steps with finite losses; the JAX launcher runs none and makes no
  parameters.
- The aux block reads ``aux_caption_key``: aux lines that carry their
  captions under that key alone give the JAX launcher's caption tokens bit
  for bit, and every aux sample would be broken were the key ignored.
"""

import base64
import io
import json
import random

import numpy as np
import pytest
from tests.torch_threads import few_torch_threads  # noqa: E402,F401 (autouse)
from PIL import Image

torch = pytest.importorskip("torch")
pytest.importorskip("tokenizers")

from tests.test_torch_xlmr_tokenizer import write_xlmr_dir  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from x2vlm_tpu import run as jax_run  # noqa: E402
from x2vlm_tpu.models.heads import XVLMForPretrain as JaxXVLMForPretrain  # noqa: E402
from x2vlm_tpu.models.xvlm_plus import XVLMPlusForPretrain as JaxXVLMPlusForPretrain  # noqa: E402
from x2vlm_tpu.tasks import pretrain as jax_pretrain  # noqa: E402
from x2vlm_tpu_torch import run  # noqa: E402
from x2vlm_tpu_torch.core.config import load_config  # noqa: E402
from x2vlm_tpu_torch.tasks import pretrain as port_pretrain  # noqa: E402
from x2vlm_tpu_torch.train.metrics import MetricLogger  # noqa: E402

VOCAB = ("[PAD] [UNK] [CLS] [SEP] [MASK] a b c d e dog cat runs the quick brown fox "
         "jump ##s ##ing over lazy river bank small big red blue green house tree left "
         "right man on").split()
WORDS = [w for w in VOCAB[5:] if not w.startswith("##")]
LANGS = ["en", "de", "fr", "cs", "ja", "zh", "ru", "es"]
RES, N = 32, 8            # image side; batch rows (the JAX launcher's 8 CPU devices)
YAMLS = ("x2vlm_base_4m", "x2vlm_base_1b", "x2vlm_base_1b_stage2_video", "x2vlm_large_4m",
         "x2vlm_large_1b", "x2vlm_large_1b_stage2", "cclm_x2vlm_base",
         "multilingual_cclm_x2vlm_large")
# the PretrainStreams attributes both launchers set from the config
STREAM_FIELDS = ("image_weight", "region_weight", "video_weight", "text_weight",
                 "mtext_weight", "aux_perc", "video_aux_perc", "regions_use_bbox_only")
STREAMS = ("image", "aux", "region", "video", "video_aux", "text", "mtext")


def _png(rng, side=40):
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (side, side + 6, 3), np.uint8)).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _cap(rng, n=6):
    return " ".join(rng.choice(WORDS, n))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("pretrain_configs")
    (d / "bert").mkdir()
    (d / "bert" / "vocab.txt").write_text("\n".join(VOCAB))
    xlmr = write_xlmr_dir(d)
    rng = np.random.default_rng(0)

    def lines(name, make, n=2 * N):
        with open(d / name, "w") as f:
            for i in range(n):
                f.write(json.dumps(make(i), ensure_ascii=False) + "\n")

    # captions under the BERT configs' key and, keyed by language, the CCLM ones'
    lines("img.jsonl", lambda i: {"binary": _png(rng), "desc": _cap(rng),
                                  "caption": {lang: _cap(rng) for lang in ("en", "de", "fr")}})
    lines("aux.jsonl", lambda i: {"binary": _png(rng), "desc": _cap(rng, 4)})
    # the aux lines of the aux_caption_key test: captions under that key alone
    lines("aux_clean.jsonl", lambda i: {"binary": _png(rng), "clean": _cap(rng, 5)})

    def region(i, multi):
        elems = []
        for _ in range(int(rng.integers(1, 4))):
            cap = ({lang: _cap(rng, 3) for lang in ("en", "de", "fr")} if multi
                   else _cap(rng, 3))
            elems.append({"bb": [int(rng.integers(0, 20)), int(rng.integers(0, 20)), 16, 14],
                          "caption": cap})
        return {"binary": _png(rng, 48), "elems": elems,
                "caption": {"en": _cap(rng), "de": _cap(rng)} if multi else _cap(rng)}

    lines("regions.jsonl", lambda i: region(i, False))
    lines("regions_multi.jsonl", lambda i: region(i, True))

    def video(i):
        frames = [_png(rng, 20) for _ in range(8 + i % 3)]
        cap = _cap(rng)
        return {"frames": frames, "video_frames": frames, "caption": cap, "text": cap}

    lines("videos.jsonl", video)
    lines("videos_aux.jsonl", video)
    lines("para.jsonl", lambda i: {"text1": _cap(rng), "text2": _cap(rng, 5),
                                   "source_text": _cap(rng), "target_text": _cap(rng, 5)})
    return d, xlmr


def _tiny(cfg: dict, corpus) -> dict:
    """The shipped config with a tiny inline model (the text stack's split
    kept: 4 layers fusing from 3 where 24 fuse from 18, else from 2), 8 rows
    a stream, its data paths pointed at the corpus."""
    d, xlmr = corpus
    del cfg["vision_config"]
    plus = cfg.get("model_type") == "cclm"
    n_text = cfg["text_num_hidden_layers"]
    tiny_text = 2 if plus else 4
    fusion = (tiny_text if cfg["text_fusion_start_at"] >= n_text else
              tiny_text * cfg["text_fusion_start_at"] // n_text)
    vocab = len(json.load(open(f"{xlmr}/tokenizer.json"))["model"]["vocab"]) if plus \
        else len(VOCAB)
    out = dict(cfg, image_res=RES, text_encoder=xlmr if plus else str(d / "bert"),
               vision_config_inline={"vision_width": 32, "patch_size": 16,
                                     "num_hidden_layers": 2, "num_attention_heads": 2},
               text_num_hidden_layers=tiny_text, text_fusion_start_at=fusion,
               text_config_inline={"vocab_size": vocab, "hidden_size": 32, "num_heads": 2,
                                   "intermediate_size": 64, "max_position_embeddings": 80},
               embed_dim=16, train_dataset_size=N,
               train_file=[str(d / "img.jsonl")],
               images=dict(cfg["images"], batch_size=N, num_workers=1))
    if plus:
        out.update(num_cross_layers=2)
    if cfg.get("train_file_aux"):
        out["train_file_aux"] = [str(d / "aux.jsonl")]
    if cfg.get("regions"):
        out.update(train_file_regions=[str(d / ("regions_multi.jsonl"
                                                if cfg["regions"].get("languages")
                                                else "regions.jsonl"))],
                   regions=dict(cfg["regions"], batch_size=N, max_images=N, num_workers=1))
    if cfg.get("videos"):
        out.update(train_file_videos=[str(d / "videos.jsonl")],
                   videos=dict(cfg["videos"], batch_size=N, num_workers=1))
        if cfg.get("train_file_videos_aux"):
            out["train_file_videos_aux"] = [str(d / "videos_aux.jsonl")]
    if cfg.get("mtexts"):
        out.update(train_file_mtext=[str(d / "para.jsonl")],
                   mtexts=dict(cfg["mtexts"], batch_size=N, num_workers=1))
    return out


def _capture(monkeypatch, module, seen: dict, run_loop: bool = False):
    """``module.pretrain_loop`` replaced by one that keeps its streams, their
    first batches and its keyword arguments, and runs no step, or with
    ``run_loop`` then runs the loop on the batches after them."""
    real = module.pretrain_loop

    def loop(model, *a, **kw):
        streams = a[-1]
        seen["streams"] = streams
        seen["kw"] = kw
        seen["batches"] = {name: dict(next(getattr(streams, name))) for name in STREAMS
                           if getattr(streams, name) is not None}
        if run_loop:
            return real(model, *a, **kw)
        return a[0] if module is jax_pretrain else MetricLogger()
    monkeypatch.setattr(module, "pretrain_loop", loop)


def _launch(corpus, name, cfg, *extra, jax_side=False):
    d = corpus[0]
    path = d / f"cfg_{name}.json"
    path.write_text(json.dumps(cfg))
    argv = ["--task", "pretrain", "--config", str(path), "--seed", "1", "--epoch", "1",
            *extra]
    if jax_side:
        return jax_run.main(argv + ["--output_dir", str(d / f"jax_{name}")])
    return run.main(argv + ["--output_dir", str(d / f"out_{name}"), "--device", "cpu"])


def _both(corpus, monkeypatch, name, cfg, *port_args, run_port=False):
    """The streams each launcher builds from ``cfg`` and the port's record:
    the JAX launcher runs no step and makes no parameters (a placeholder
    tree); with ``run_port`` the port runs its steps after its first
    batches."""
    got, want = {}, {}
    _capture(monkeypatch, port_pretrain, got, run_loop=run_port)
    _capture(monkeypatch, jax_pretrain, want)
    for cls in (JaxXVLMForPretrain, JaxXVLMPlusForPretrain):
        monkeypatch.setattr(cls, "init", lambda self, *a, **kw: {
            "params": {"base": {"temp": jnp.ones((), jnp.float32)}}})
    got["record"] = _launch(corpus, name, cfg, *port_args)
    _launch(corpus, name, cfg, jax_side=True)
    monkeypatch.undo()
    return got, want


@pytest.mark.parametrize("name", YAMLS)
def test_shipped_pretraining_yaml_builds_the_jax_launchers_streams(corpus, monkeypatch, name):
    shipped = load_config(f"configs/pretrain/{name}.yaml").to_dict()
    cfg = _tiny(shipped, corpus)
    got, want = _both(corpus, monkeypatch, name, cfg, "--epoch", "2", run_port=True)
    present = {s for s in STREAMS if getattr(got["streams"], s) is not None}
    assert present == {s for s in STREAMS if getattr(want["streams"], s) is not None}
    assert ("aux" in present) == bool(shipped.get("train_file_aux"))
    assert ("video_aux" in present) == bool(shipped.get("train_file_videos_aux"))
    for field in STREAM_FIELDS:
        assert getattr(got["streams"], field) == getattr(want["streams"], field), field
    for key in ("stop_calc_itm_after", "calc_image_bbox_loss"):
        assert got["kw"][key] == want["kw"][key], key
    assert got["kw"]["stop_calc_itm_after"] == shipped.get("stop_calc_itm")
    for stream, batch in got["batches"].items():
        ref = want["batches"][stream]
        assert set(batch) == set(ref), stream
        for k, v in batch.items():
            assert np.shape(v) == np.shape(ref[k]), (stream, k)
            if k != "image":   # the port keeps the pixels uint8 to the card
                assert np.asarray(v).dtype.kind == np.asarray(ref[k]).dtype.kind, (stream, k)
        if stream in ("image", "aux") and not shipped["images"].get("languages"):
            for k in ("text_ids", "text_atts"):
                np.testing.assert_array_equal(batch[k], ref[k], err_msg=f"{stream} {k}")

    # the port's run goes on: two steps on the batches after those (at
    # --seed 1 the first image batch is an aux batch, the second a noisy
    # one), every loss finite
    rec = got["record"]
    assert rec["pretrain_steps"] == [0, 2]
    losses = {k: v for k, v in rec.items() if "_loss_" in k}
    assert losses and all(np.isfinite(v) for v in losses.values()), losses
    assert rec["image_loss_itm"] > 0 or "aux" not in present


def test_aux_block_reads_aux_caption_key(corpus, monkeypatch):
    """``images.aux_caption_key`` names the aux lines' caption: lines with
    their captions under that key alone give the JAX launcher's caption
    tokens bit for bit; read with the image key, each would be broken."""
    d = corpus[0]
    shipped = load_config("configs/pretrain/x2vlm_base_1b.yaml").to_dict()
    assert shipped["images"]["aux_caption_key"] == "desc"
    cfg = _tiny(shipped, corpus)
    cfg.update(train_file_aux=[str(d / "aux_clean.jsonl")],
               images=dict(cfg["images"], aux_caption_key="clean"))
    got, want = _both(corpus, monkeypatch, "aux_key", cfg)
    aux, ref = got["batches"]["aux"], want["batches"]["aux"]
    for k in ("text_ids", "text_atts"):
        np.testing.assert_array_equal(aux[k], ref[k], err_msg=k)
    first = json.loads(open(d / "aux_clean.jsonl").readline())["clean"].split()
    assert aux["text_atts"][0].sum() == len(first) + 2     # [CLS] caption [SEP]
    cfg["images"] = dict(cfg["images"], aux_caption_key="desc")
    with pytest.raises(Exception, match="broken"):
        _both(corpus, monkeypatch, "aux_key_wrong", cfg)
