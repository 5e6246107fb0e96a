"""``--task retrieval`` on the two shipped configs of the other vision
towers, ``configs/finetune/retrieval_flickr_{clip,swin}_base.yaml``, on the
CPU with a tiny inline model (the YAML's keys kept, its data paths, sizes
and batch cut): train, ``--evaluate`` from the saved state, ``--resume``
restoring the train state bit for bit; and a start from raw published
weights (tiny fake HF CLIP / timm Swin files named by the vision JSON's
``ckpt``, an HF BERT ``pytorch_model.bin`` in the text encoder's
directory), its fresh parameters in the ``lr_mult`` group."""

import json

import numpy as np
import pytest
from tests.torch_threads import few_torch_threads  # noqa: E402,F401 (autouse)

torch = pytest.importorskip("torch")

from tests.test_torch_launcher import VOCAB, _png  # noqa: E402
from tests.test_torch_tower_import import bert_file, clip_file, swin_file  # noqa: E402
from x2vlm_tpu_torch import run  # noqa: E402
from x2vlm_tpu_torch.core.config import load_config  # noqa: E402
from x2vlm_tpu_torch.models import CLIPViTConfig, SwinConfig  # noqa: E402
from x2vlm_tpu_torch.train import checkpoint as ckpt_lib  # noqa: E402

TOWERS = {
    "clip": {"vision_width": 32, "patch_size": 16, "num_hidden_layers": 2,
             "num_attention_heads": 2, "intermediate_size": 64, "hidden_act": "quick_gelu"},
    # an 8 x 8 grid of 2 x 2 windows, then 4 x 4; final stride 4 x 2 = 8
    "swin": {"vision_width": 32, "embed_dim": 16, "depths": [2, 2], "num_heads": [2, 4],
             "window_size": 2, "patch_size": 4},
}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("towers")
    (d / "bert").mkdir()
    (d / "bert" / "vocab.txt").write_text("\n".join(VOCAB))
    (d / "imgs").mkdir()
    rng = np.random.default_rng(0)
    words = VOCAB[5:]
    ann = []
    for i in range(8):
        (d / "imgs" / f"im{i}.png").write_bytes(_png(rng))
        ann.append({"image": f"im{i}.png", "image_id": i,
                    "caption": [" ".join(rng.choice(words, 5)) for _ in range(2)]})
    (d / "ret.json").write_text(json.dumps(ann))
    return d


def _shipped(corpus, tower, vision_json=None, text_dir=None):
    cfg = load_config(f"configs/finetune/retrieval_flickr_{tower}_base.yaml").to_dict()
    assert cfg["use_clip_vit" if tower == "clip" else "use_swin"]
    del cfg["vision_config"]
    cfg.update(image_res=32, patch_size=16 if tower == "clip" else 8,
               vision_config_inline=TOWERS[tower], text_num_hidden_layers=4,
               text_fusion_start_at=2,
               text_config_inline={"vocab_size": len(VOCAB), "hidden_size": 32, "num_heads": 2,
                                   "intermediate_size": 64, "max_position_embeddings": 16},
               embed_dim=16, max_tokens=10, batch_size=4, batch_size_test=3, k_test=4,
               text_encoder=str(text_dir or corpus / "bert"),
               train_file=[str(corpus / "ret.json")], test_file=[str(corpus / "ret.json")],
               image_root=str(corpus / "imgs"), schedular=dict(cfg["schedular"], epochs=1))
    if vision_json is not None:
        cfg["vision_config"] = str(vision_json)
    return cfg


def _main(corpus, name, cfg, *extra):
    path = corpus / f"cfg_{name}.json"
    path.write_text(json.dumps(cfg))
    return run.main(["--task", "retrieval", "--config", str(path), "--output_dir",
                     str(corpus / f"out_{name}"), "--seed", "0", "--device", "cpu", *extra])


def _state(corpus, name):
    return torch.load(corpus / f"out_{name}" / "ckpt" / ckpt_lib.TRAIN_STATE_FILE,
                      weights_only=False)


@pytest.mark.parametrize("tower", sorted(TOWERS))
def test_retrieval_on_the_shipped_tower_configs(corpus, tower, monkeypatch):
    cfg = _shipped(corpus, tower)
    model, mcfg = run.build_model(cfg, "retrieval", device="cpu")
    assert isinstance(mcfg.vision, CLIPViTConfig if tower == "clip" else SwinConfig)
    assert mcfg.text.encoder_width == 32 and model.vision_proj.in_features == 32
    rec = _main(corpus, tower, cfg)
    keys = ("txt_r1", "txt_r5", "txt_r10", "img_r1", "img_r5", "img_r10", "r_mean")
    assert all(np.isfinite(rec[f"eval_{k}"]) for k in keys)
    assert np.isfinite(rec["loss_itc"]) and np.isfinite(rec["loss_itm"])
    saved = _state(corpus, tower)
    assert saved["step"] == saved["count"] == 2     # 8 annotations at batch 4
    metrics = _main(corpus, tower, cfg, "--evaluate", "--checkpoint",
                    str(corpus / f"out_{tower}" / "ckpt"))
    assert {k: metrics[k] for k in keys} == {k: rec[f"eval_{k}"] for k in keys}

    seen = {}
    restore = ckpt_lib.restore_train_state

    def spy(ckpt_dir, model, optimizer):
        out = restore(ckpt_dir, model, optimizer)
        seen["params"] = {n: p.detach().clone() for n, p in model.named_parameters()}
        seen["mu"] = dict(zip(optimizer.names, (m.clone() for m in optimizer.mu)))
        seen["nu"] = dict(zip(optimizer.names, (v.clone() for v in optimizer.nu)))
        seen["count"] = optimizer.count
        return out

    monkeypatch.setattr(ckpt_lib, "restore_train_state", spy)
    _main(corpus, tower, cfg, "--resume", "--epoch", "2")
    assert seen["count"] == saved["count"]
    for part in ("params", "mu", "nu"):
        assert seen[part].keys() == saved[part].keys()
        for k in saved[part]:
            assert torch.equal(seen[part][k], saved[part][k]), (part, k)
    assert _state(corpus, tower)["count"] == 4


@pytest.mark.parametrize("tower", sorted(TOWERS))
def test_a_start_from_raw_published_weights(corpus, tower, tmp_path):
    """The vision JSON's ``ckpt`` (HF CLIP names, or a timm Swin file at
    window 4 for the model's window 2) and ``bert/pytorch_model.bin`` (2
    layers, expanded to 4: layers 2-3 copy 0-1) fill the towers; the
    cross-attention, projections, ITM head and ``temp`` stay fresh."""
    rng = np.random.default_rng(1)
    if tower == "clip":
        vision = clip_file(rng, layers=2, width=32, tokens=5)
    else:
        vision = swin_file(rng, depths=(2, 2), dims=(16, 32), heads=(2, 4), window=4)
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in vision.items()},
               tmp_path / "vision.bin")
    vjson = tmp_path / "vision.json"
    vjson.write_text(json.dumps(dict(TOWERS[tower], ckpt=str(tmp_path / "vision.bin"))))
    text_dir = tmp_path / "bert"
    text_dir.mkdir()
    (text_dir / "vocab.txt").write_text("\n".join(VOCAB))
    text = bert_file(rng, layers=2, width=32, vocab=len(VOCAB))
    text["bert.embeddings.position_embeddings.weight"] = text[
        "bert.embeddings.position_embeddings.weight"][:16]
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in text.items()},
               text_dir / "pytorch_model.bin")
    cfg = _shipped(corpus, tower, vision_json=vjson, text_dir=text_dir)
    del cfg["vision_config_inline"]
    model, mcfg = run.build_model(cfg, "retrieval", device="cpu")
    args = run.parse_args(["--task", "retrieval", "--config", "x", "--output_dir", "y",
                           "--device", "cpu"])
    fresh = run.load_initial_params(args, cfg, model)
    assert not [n for n in fresh if n.startswith("vision_encoder.")]
    assert {n.split(".")[0] for n in fresh} == {"text_encoder", "vision_proj", "text_proj",
                                                "temp", "itm_head"}
    assert all("crossattention" in n for n in fresh if n.startswith("text_encoder."))
    sd = model.state_dict()
    for i, src in ((0, 0), (2, 0), (3, 1)):
        key = f"encoder.layer.{src}.intermediate.dense.weight"
        np.testing.assert_array_equal(
            sd[f"text_encoder.bert.encoder.layer.{i}.intermediate.dense.weight"].numpy(),
            text["bert." + key])
    if tower == "clip":
        np.testing.assert_array_equal(sd["vision_encoder.pos_embed.weight"].numpy(),
                                      vision["vision_model.embeddings.position_embedding.weight"])
    else:
        table = "layers.1.blocks.1.attn.relative_position_bias_table"
        assert sd[f"vision_encoder.{table}"].shape == (9, 4) and vision[table].shape == (49, 4)
        np.testing.assert_allclose(sd[f"vision_encoder.{table}"].numpy(),
                                   ckpt_lib.resize_swin_rel_pos_table(vision[table], 2))
    opt = run.make_optimizer(cfg, model, 4, mcfg.text.fusion_layer, fresh_names=fresh)
    assert (True, 2.0) in dict(opt.groups)    # lr_mult of the shipped config
