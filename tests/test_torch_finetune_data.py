"""The grounding and NLVR2 host side and launcher against the JAX package:
``NLVRDataset``, ``GroundingTrainDataset`` (the box-keeping crop, the flip
with and without ``careful_hflip``, the cxcywh target) and
``GroundingEvalDataset`` give the JAX package's arrays bit for bit from the
same ``random.Random`` seeds, as does ``create_dataset`` for both tasks;
the launcher runs ``--task grounding`` and ``--task nlvr`` on the shipped
``configs/finetune/refcoco_grounding_base.yaml`` and ``nlvr_base.yaml``
(data paths pointed at files written here, a tiny inline model, the CPU):
fine-tune with its eval, ``--evaluate`` from the saved state, ``--resume``
(the restored state equal to the saved one bit for bit, the run going on
from its step), and a reference ``.th`` import (grounding keeps its bbox
head, NLVR's ``cls_head`` stays fresh in the lr_mult group)."""

import json
import random

import numpy as np
import pytest
from PIL import Image

torch = pytest.importorskip("torch")

from tests.golden_torch import GoldenXVLM  # noqa: E402
from x2vlm_tpu.data import (  # noqa: E402
    GroundingEvalDataset as JaxGroundingEvalDataset,
    GroundingTrainDataset as JaxGroundingTrainDataset, NLVRDataset as JaxNLVRDataset,
    TextPreprocessor as JaxTextPreprocessor,
)
from x2vlm_tpu.data import transforms as JT  # noqa: E402
from x2vlm_tpu.data.factory import create_dataset as jax_create_dataset  # noqa: E402
from x2vlm_tpu_torch import run  # noqa: E402
from x2vlm_tpu_torch.core.config import load_config  # noqa: E402
from x2vlm_tpu_torch.data import transforms as T  # noqa: E402
from x2vlm_tpu_torch.data.factory import create_dataset  # noqa: E402
from x2vlm_tpu_torch.data.finetune import (  # noqa: E402
    GroundingEvalDataset, GroundingTrainDataset, NLVRDataset,
)
from x2vlm_tpu_torch.data.tokenization import BertWordPiece, TextPreprocessor  # noqa: E402
from x2vlm_tpu_torch.train import checkpoint as ckpt_lib  # noqa: E402
from x2vlm_tpu_torch.train import param_labels  # noqa: E402

VOCAB = ("[PAD] [UNK] [CLS] [SEP] [MASK] a b c d e dog cat runs the quick brown fox "
         "jump ##s ##ing over lazy river bank small big red blue green house tree left "
         "right man on").split()
WORDS = VOCAB[5:]
RES = 32
# (caption, bbox xywh) of the grounding lines: captions naming left / right
# (careful_hflip keeps them unflipped), boxes at the image's edges and inside
GROUNDING = (("the dog on the left", [0, 0, 10.5, 12]), ("a big red house", [7.3, 5.9, 20, 18]),
             ("man on the right bank", [30, 20, 26, 20]), ("small blue tree", [12, 3, 1.5, 2.5]),
             ("the quick brown fox", [44.2, 30.1, 11.8, 9.9]), ("green river", [5, 5, 40, 30]))


def _caption(rng, n):
    return " ".join(rng.choice(WORDS, n))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("finetune")
    (d / "bert").mkdir()
    (d / "bert" / "vocab.txt").write_text("\n".join(VOCAB))
    (d / "imgs").mkdir()
    rng = np.random.default_rng(0)
    for i in range(6):
        Image.fromarray(rng.integers(0, 255, (40 + 4 * i, 56, 3), np.uint8)).save(
            d / "imgs" / f"im{i}.png")
    ground = [{"image": f"im{i % 6}.png", "text": t, "bbox": b, "ref_id": 100 + i}
              for i, (t, b) in enumerate(GROUNDING)]
    for i, (t, b) in enumerate(GROUNDING[:4]):
        ground.append({"image": f"im{(i + 3) % 6}.png", "text": t + " again", "bbox": b,
                       "ref_id": 200 + i})
    (d / "ground.json").write_text(json.dumps(ground))
    refs = {str(a["ref_id"]): {"split": ("val", "testA", "testB")[k % 3], "bbox": a["bbox"],
                               "width": 56, "height": 40 + 4 * (int(a["image"][2]))}
            for k, a in enumerate(ground)}
    (d / "refs.json").write_text(json.dumps(refs))
    nlvr = [{"images": [f"im{i % 6}.png", f"im{(i + 2) % 6}.png"],
             "sentence": _caption(rng, 7), "label": "True" if i % 3 else "False"}
            for i in range(8)]
    (d / "nlvr.json").write_text(json.dumps(nlvr))
    (d / "nlvr_dev.json").write_text(json.dumps(nlvr[:5]))
    return d


def _pre(corpus, port=True):
    if port:
        return TextPreprocessor(BertWordPiece(str(corpus / "bert" / "vocab.txt")), max_tokens=10)
    from x2vlm_tpu.data.tokenization import build_tokenizer

    return JaxTextPreprocessor(build_tokenizer(str(corpus / "bert")), max_tokens=10)


def _assert_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k


# ---- the datasets ----

def test_nlvr_dataset_equals_jax(corpus):
    """The train transform (random crop, flip, RandomAugment) from equal
    seeds: every sample's arrays bit for bit."""
    r1, r2 = random.Random(3), random.Random(3)
    want = JaxNLVRDataset(str(corpus / "nlvr.json"), JT.train_transform(RES, rng=r1),
                          str(corpus / "imgs"), _pre(corpus, port=False))
    got = NLVRDataset(str(corpus / "nlvr.json"), T.train_transform(RES, rng=r2),
                      str(corpus / "imgs"), _pre(corpus))
    assert len(got) == len(want) == 8
    for i in range(len(want)):
        _assert_equal(got[i], want[i])
    assert {int(got[i]["labels"]) for i in range(8)} == {0, 1}


@pytest.mark.parametrize("careful_hflip", [True, False])
def test_grounding_train_dataset_equals_jax(corpus, careful_hflip):
    """Three passes over the lines (the crop and the flip drawn anew each):
    images, ids and targets bit for bit, the targets inside the image."""
    r1, r2 = random.Random(5), random.Random(5)
    want = JaxGroundingTrainDataset(str(corpus / "ground.json"), JT.box_transform(rng=r1),
                                    str(corpus / "imgs"), _pre(corpus, port=False),
                                    image_res=RES, careful_hflip=careful_hflip, rng=r1)
    got = GroundingTrainDataset(str(corpus / "ground.json"), T.box_transform(rng=r2),
                                str(corpus / "imgs"), _pre(corpus), image_res=RES,
                                careful_hflip=careful_hflip, rng=r2)
    for _ in range(3):
        for i in range(len(want)):
            _assert_equal(got[i], want[i])
    target = np.stack([got[i]["target_bbox"] for i in range(len(got))])
    assert np.all(target[:, 2:] > 0) and np.all(target[:, :2] > 0) and np.all(target < 1.01)


def test_grounding_train_dataset_flips_the_box(corpus, tmp_path):
    """A flip mirrors the box: the target's cx goes to 1 - cx."""
    line = {"image": "im0.png", "text": "a dog", "bbox": [4, 6, 10, 8], "ref_id": 0}
    (tmp_path / "one.json").write_text(json.dumps([line] * 40))
    ds = GroundingTrainDataset(str(tmp_path / "one.json"), T.box_transform(rng=random.Random(0)),
                               str(corpus / "imgs"), _pre(corpus), image_res=RES,
                               rng=random.Random(1))
    flipped = 0
    for i in range(40):
        r = random.Random()
        r.setstate(ds.rng.getstate())   # the draws the next sample makes
        crop = [r.randint(0, 4), r.randint(0, 6), r.randint(14, 56), r.randint(14, 40)]
        flip = r.random() < 0.5
        cx = ((4 - crop[0]) + 5) / (crop[2] - crop[0])
        t = ds[i]["target_bbox"]
        np.testing.assert_allclose(t[0], 1 - cx if flip else cx, rtol=1e-5)
        flipped += flip
    assert 0 < flipped < 40


def test_grounding_eval_dataset_equals_jax(corpus):
    want = JaxGroundingEvalDataset(str(corpus / "ground.json"), JT.test_transform(RES),
                                   str(corpus / "imgs"), _pre(corpus, port=False))
    got = GroundingEvalDataset(str(corpus / "ground.json"), T.test_transform(RES),
                               str(corpus / "imgs"), _pre(corpus))
    for i in range(len(want)):
        _assert_equal(got[i], want[i])
    assert got[0]["ref_id"] == 100


@pytest.mark.parametrize("task", ["grounding", "nlvr"])
def test_create_dataset_equals_jax(corpus, task):
    """The factory's train and eval sets (the eval a {split: dataset} dict
    for NLVR) from ``rng = random.Random(7)``."""
    cfg = {"image_res": RES, "text_encoder": str(corpus / "bert"), "max_tokens": 10,
           "image_root": str(corpus / "imgs"), "careful_hflip": True}
    if task == "grounding":
        cfg.update(train_file=[str(corpus / "ground.json")],
                   test_file=[str(corpus / "ground.json")])
    else:
        cfg.update(train_file=[str(corpus / "nlvr.json")],
                   test_file={"dev": str(corpus / "nlvr_dev.json"),
                              "test": str(corpus / "nlvr.json")})
    want_tr, want_ev = jax_create_dataset(task, cfg, rng=random.Random(7))
    got_tr, got_ev = create_dataset(task, cfg, rng=random.Random(7))
    for i in range(len(want_tr)):
        _assert_equal(got_tr[i], want_tr[i])
    if task == "nlvr":
        assert set(got_ev) == set(want_ev) == {"dev", "test"}
        pairs = [(got_ev[k], want_ev[k]) for k in want_ev]
    else:
        pairs = [(got_ev, want_ev)]
    for g, w in pairs:
        for i in range(len(w)):
            _assert_equal(g[i], w[i])
    assert create_dataset(task, cfg, evaluate=True)[0] is None


# ---- the launcher on the shipped configs ----

TINY = dict(
    image_res=RES,
    vision_config_inline={"vision_width": 32, "patch_size": 16, "num_hidden_layers": 2,
                          "num_attention_heads": 2},
    text_num_hidden_layers=4, text_fusion_start_at=2,
    text_config_inline={"vocab_size": 100, "hidden_size": 32, "num_heads": 2,
                        "intermediate_size": 64, "max_position_embeddings": 64},
    embed_dim=16, max_tokens=10)


def _shipped(corpus, task, **extra):
    """The shipped config of ``task``, its data paths pointed at the corpus,
    a tiny model, batch 4 (eval 3)."""
    name = {"grounding": "refcoco_grounding_base", "nlvr": "nlvr_base"}[task]
    cfg = load_config(f"configs/finetune/{name}.yaml").to_dict()
    del cfg["vision_config"]
    cfg.update(TINY, text_encoder=str(corpus / "bert"), image_root=str(corpus / "imgs"),
               batch_size=4, batch_size_test=3,
               schedular=dict(cfg["schedular"], epochs=1))
    if task == "grounding":
        cfg.update(train_file=[str(corpus / "ground.json")],
                   test_file=[str(corpus / "ground.json")], refs_file=str(corpus / "refs.json"))
    else:
        cfg.update(train_file=[str(corpus / "nlvr.json")],
                   test_file={"dev": str(corpus / "nlvr_dev.json"),
                              "test": str(corpus / "nlvr.json")})
    cfg.update(extra)
    return cfg


def _main(corpus, task, name, cfg, *extra):
    path = corpus / f"cfg_{name}.json"
    path.write_text(json.dumps(cfg))
    return run.main(["--task", task, "--config", str(path), "--output_dir",
                     str(corpus / f"out_{name}"), "--seed", "0", "--device", "cpu", *extra])


def _state(corpus, name, ckpt="ckpt"):
    return torch.load(corpus / f"out_{name}" / ckpt / ckpt_lib.TRAIN_STATE_FILE,
                      weights_only=False)


def _resume_restores_exactly(corpus, task, name, cfg, monkeypatch):
    """``--resume`` with one more epoch: the model and AdamW state right
    after the restore equal the saved ones bit for bit, and the run goes on
    from the saved step."""
    saved = _state(corpus, name)
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
    _main(corpus, task, name, cfg, "--resume", "--epoch", "2")
    assert seen["count"] == saved["count"]
    for part in ("params", "mu", "nu"):
        assert seen[part].keys() == saved[part].keys()
        for k in saved[part]:
            assert torch.equal(seen[part][k], saved[part][k]), (part, k)
    after = _state(corpus, name)
    assert after["step"] == after["count"] == 2 * saved["step"]


def test_grounding_launcher_train_evaluate_resume(corpus, monkeypatch):
    cfg = _shipped(corpus, "grounding")
    assert cfg["batch_size"] == 4 and cfg["careful_hflip"] is True
    rec = _main(corpus, "grounding", "ground", cfg)
    for k in ("loss_bbox", "loss_giou", "eval_val_acc", "eval_testA_acc", "eval_testB_acc"):
        assert np.isfinite(rec[k]), k
    state = _state(corpus, "ground")       # 10 lines at batch 4: 2 steps
    assert state["step"] == state["count"] == 2
    assert {k.split(".")[0] for k in state["params"]} == \
        {"vision_encoder", "text_encoder", "bbox_head"}
    assert (corpus / "out_ground" / "ckpt_best" / ckpt_lib.TRAIN_STATE_FILE).is_file()
    metrics = _main(corpus, "grounding", "ground", cfg, "--evaluate", "--checkpoint",
                    str(corpus / "out_ground" / "ckpt"))
    assert {k: metrics[k] for k in ("val_acc", "testA_acc", "testB_acc")} == \
        {k: rec[f"eval_{k}"] for k in ("val_acc", "testA_acc", "testB_acc")}
    _resume_restores_exactly(corpus, "grounding", "ground", cfg, monkeypatch)


def test_grounding_launcher_vlue_and_no_refs(corpus, tmp_path):
    """``vlue_test``: the test json's own boxes give ``score``; without
    ``refs_file`` the eval counts the predictions."""
    vlue = [dict(a, width=56, height=40 + 4 * int(a["image"][2]))
            for a in json.loads((corpus / "ground.json").read_text())]
    (tmp_path / "vlue.json").write_text(json.dumps(vlue))
    cfg = _shipped(corpus, "grounding", test_file=[str(tmp_path / "vlue.json")],
                   vlue_test=True)
    metrics = _main(corpus, "grounding", "vlue", cfg, "--evaluate")
    assert set(metrics) == {"score"} and 0 <= metrics["score"] <= 1
    cfg = _shipped(corpus, "grounding")
    del cfg["refs_file"]
    assert _main(corpus, "grounding", "norefs", cfg, "--evaluate") == {"n": 10}


def test_nlvr_launcher_train_evaluate_resume(corpus, monkeypatch):
    """A {split: file} ``test_file``: each split's accuracy and their mean,
    which picks the best epoch."""
    cfg = _shipped(corpus, "nlvr")
    rec = _main(corpus, "nlvr", "nlvr", cfg)
    for k in ("loss_cls", "eval_dev_accuracy", "eval_test_accuracy", "eval_accuracy"):
        assert np.isfinite(rec[k]), k
    assert rec["eval_dev_n"] == 5 and rec["eval_test_n"] == 8
    assert rec["eval_accuracy"] == pytest.approx(
        (rec["eval_dev_accuracy"] + rec["eval_test_accuracy"]) / 2)
    state = _state(corpus, "nlvr")
    assert state["step"] == 2
    assert {k.split(".")[0] for k in state["params"]} == \
        {"temp", "vision_encoder", "text_encoder", "cls_head"}
    metrics = _main(corpus, "nlvr", "nlvr", cfg, "--evaluate", "--checkpoint",
                    str(corpus / "out_nlvr" / "ckpt"))
    assert metrics == {k[len("eval_"):]: v for k, v in rec.items() if k.startswith("eval_")}
    _resume_restores_exactly(corpus, "nlvr", "nlvr", cfg, monkeypatch)


@pytest.mark.parametrize("task", ["grounding", "nlvr"])
def test_a_reference_th_imports(corpus, tmp_path, task):
    """A pretraining ``.th`` (reference names): grounding loads everything
    it has, its bbox head among it, and leaves the projections, the ITM and
    MLM heads and ``temp`` over; NLVR leaves ``cls_head`` fresh, which the
    optimizer puts in the lr_mult group."""
    torch.manual_seed(0)
    sd = GoldenXVLM().state_dict()
    th = tmp_path / "x.th"
    torch.save({"model": sd}, th)
    cfg = _shipped(corpus, task)
    args = run.parse_args(["--task", task, "--config", "x", "--output_dir", str(tmp_path),
                           "--checkpoint", str(th), "--device", "cpu"])
    model, mcfg = run.build_model(cfg, task, device="cpu")
    missing, unexpected = ckpt_lib.load_reference_checkpoint(model, str(th))
    assert run.load_initial_params(args, cfg, model) == missing
    tops = {k.split(".")[0] for k in unexpected}
    if task == "grounding":
        assert missing == []
        assert tops == {"vision_proj", "text_proj", "itm_head", "temp", "text_encoder",
                        "vision_encoder"}
        assert all(k.startswith("text_encoder.cls.") for k in unexpected
                   if k.startswith("text_encoder."))
        torch.testing.assert_close(model.bbox_head[3].weight, sd["bbox_head.3.weight"],
                                   rtol=0, atol=0)
    else:
        assert missing == sorted(n for n, _ in model.named_parameters()
                                 if n.startswith("cls_head."))
        assert "bbox_head" in tops and "temp" not in tops
        torch.testing.assert_close(model.temp, sd["temp"], rtol=0, atol=0)
        labels = param_labels(model.named_parameters(), mcfg.text.fusion_layer,
                              fresh_names=missing)
        assert {n for n, lab in labels.items() if lab == "fresh"} == set(missing)
        opt = run.make_optimizer(cfg, model, 10, mcfg.text.fusion_layer, fresh_names=missing)
        assert (True, 2.0) in dict(opt.groups)    # lr_mult of the shipped config
