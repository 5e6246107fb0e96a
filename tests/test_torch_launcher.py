"""The port's launcher, ``python -m x2vlm_tpu_torch.run``, end to end on the
CPU (``--device cpu``) at a tiny config (the ``_model_cfg`` of
test_cli_tasks.py): pretraining with an image-text and a text stream, its
exact resume (4 steps in one run equal 2 + resume + 2, bit for bit), the
retrieval fine-tune with its eval, ``--evaluate`` and ``--resume``; and
every IGLUE task reaching its runner."""

import base64
import io
import json
import re

import numpy as np
import pytest
import yaml
from PIL import Image

torch = pytest.importorskip("torch")

from x2vlm_tpu_torch import run  # noqa: E402
from x2vlm_tpu_torch.train.checkpoint import TRAIN_STATE_FILE  # noqa: E402

VOCAB = ("[PAD] [UNK] [CLS] [SEP] [MASK] a b c d e dog cat runs the quick brown fox "
         "jump ##s ##ing over lazy river bank small big red blue green house tree").split()


def _png(rng, w=40, h=40):
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8)).save(buf, format="PNG")
    return buf.getvalue()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("launcher")
    (d / "bert-tiny").mkdir()
    (d / "bert-tiny" / "vocab.txt").write_text("\n".join(VOCAB))
    (d / "imgs").mkdir()
    rng = np.random.default_rng(0)
    words = VOCAB[5:]
    with open(d / "img.jsonl", "w") as f:
        for _ in range(12):
            f.write(json.dumps({"binary": base64.b64encode(_png(rng)).decode(),
                                "desc": " ".join(rng.choice(words, 8))}) + "\n")
    with open(d / "txt.jsonl", "w") as f:
        for _ in range(12):
            f.write(json.dumps({"text": " ".join(rng.choice(words, 9))}) + "\n")
    ann = []
    for i in range(8):
        (d / "imgs" / f"im{i}.png").write_bytes(_png(rng))
        ann.append({"image": f"im{i}.png", "image_id": i,
                    "caption": [" ".join(rng.choice(words, 5)) for _ in range(2)]})
    (d / "ret.json").write_text(json.dumps(ann))
    return d


def _model_cfg(d, **extra):
    cfg = {"image_res": 32,
           "vision_config_inline": {"vision_width": 32, "patch_size": 16,
                                    "num_hidden_layers": 2, "num_attention_heads": 2},
           "text_encoder": str(d / "bert-tiny"), "text_num_hidden_layers": 4,
           "text_fusion_start_at": 2,
           "text_config_inline": {"vocab_size": len(VOCAB), "hidden_size": 32, "num_heads": 2,
                                  "intermediate_size": 64, "hidden_dropout": 0.1,
                                  "attn_dropout": 0.1},
           "embed_dim": 16, "max_tokens": 10, "max_words": 10, "max_masks": 3,
           "batch_size": 4, "batch_size_test": 4,
           "optimizer": {"lr": 1e-3, "weight_decay": 0.01, "lr_mult": 2},
           "schedular": {"epochs": 1, "num_warmup_steps": 100}}
    cfg.update(extra)
    return cfg


def _pretrain_cfg(d, **extra):
    cfg = _model_cfg(d, train_file=[str(d / "img.jsonl")],
                     images={"batch_size": 4, "num_workers": 2}, train_dataset_size=8,
                     train_file_text=[str(d / "txt.jsonl")],
                     texts={"batch_size": 4, "iter_perc": 0.5})
    cfg.update(extra)
    return cfg


def _main(d, name, cfg, task, *extra, suffix=".json"):
    path = d / f"cfg_{name}{suffix}"
    path.write_text(json.dumps(cfg) if suffix == ".json" else yaml.safe_dump(cfg))
    return run.main(["--task", task, "--config", str(path), "--output_dir",
                     str(d / f"out_{name}"), "--seed", "0", "--device", "cpu", *extra])


def _state(d, name):
    return torch.load(d / f"out_{name}" / "ckpt" / TRAIN_STATE_FILE, weights_only=False)


def test_pretrain_runs_and_saves(corpus):
    rec = _main(corpus, "pre", _pretrain_cfg(corpus, ckpt_frequent_step=1), "pretrain",
                suffix=".yaml")
    assert rec["pretrain_steps"] == [0, 2] and rec["broken"] == 0.0
    for k in ("image_loss_itc", "image_loss_itm", "image_loss_mlm", "text_loss_mlm",
              "grad_norm"):
        assert np.isfinite(rec[k]) and rec[k] > 0, k
    state = _state(corpus, "pre")
    assert state["step"] == 2 and state["count"] == 2
    assert state["data_state"]["image"] == {"epoch": 0, "file_idx": 0, "line_idx": 8}
    assert set(state["data_state"]) == {"image", "text"}


def test_pretrain_resume_is_exact(corpus):
    """4 steps in one run equal 2 steps, --resume, 2 more: parameters, AdamW
    state and data cursors bit for bit (dropout on: each step's generators
    are seeded by the step, each batch's draws by its cursor)."""
    cfg = _pretrain_cfg(corpus)
    _main(corpus, "whole", cfg, "pretrain", "--epoch", "2")
    _main(corpus, "split", cfg, "pretrain", "--epoch", "1")
    rec = _main(corpus, "split", cfg, "pretrain", "--epoch", "2", "--resume")
    assert rec["pretrain_steps"] == [2, 4]
    whole, split = _state(corpus, "whole"), _state(corpus, "split")
    assert whole["step"] == split["step"] == 4 and whole["count"] == split["count"]
    assert whole["data_state"] == split["data_state"]
    for part in ("params", "mu", "nu"):
        assert whole[part].keys() == split[part].keys()
        for k in whole[part]:
            assert torch.equal(whole[part][k], split[part][k]), (part, k)


def test_retrieval_train_evaluate_resume(corpus):
    cfg = _model_cfg(corpus, train_file=[str(corpus / "ret.json")],
                     test_file=[str(corpus / "ret.json")], image_root=str(corpus / "imgs"),
                     k_test=4)
    rec = _main(corpus, "ret", cfg, "retrieval")
    keys = ("txt_r1", "txt_r5", "txt_r10", "txt_r_mean", "img_r1", "img_r5", "img_r10",
            "img_r_mean", "r1_mean", "r_mean")
    assert all(np.isfinite(rec[f"eval_{k}"]) for k in keys)
    assert np.isfinite(rec["loss_itc"]) and np.isfinite(rec["loss_itm"])
    state = _state(corpus, "ret")   # 8 annotations at batch 4: 2 steps
    assert state["step"] == 2 and state["count"] == 2
    assert (corpus / "out_ret" / "ckpt_best" / TRAIN_STATE_FILE).is_file()
    # --evaluate from the saved parameters: the recalls of the run's last eval
    metrics = _main(corpus, "ret", cfg, "retrieval", "--evaluate", "--checkpoint",
                    str(corpus / "out_ret" / "ckpt"))
    assert {k: metrics[k] for k in keys} == {k: rec[f"eval_{k}"] for k in keys}
    # --resume past the last epoch trains nothing more
    _main(corpus, "ret", cfg, "retrieval", "--resume")
    assert _state(corpus, "ret")["count"] == 2


def test_a_reference_th_loads_through_checkpoint(corpus, tmp_path):
    """The .th the port exports (reference names) imports with nothing
    missing; the lr_mult group is empty."""
    state = _state(corpus, "pre")
    th = tmp_path / "x.th"
    torch.save({"model": {k[len("base."):]: v for k, v in state["params"].items()}}, th)
    cfg = _model_cfg(corpus, train_file=[str(corpus / "ret.json")],
                     test_file=[str(corpus / "ret.json")], image_root=str(corpus / "imgs"))
    args = run.parse_args(["--task", "retrieval", "--config", "x", "--output_dir", "y",
                           "--checkpoint", str(th), "--device", "cpu"])
    model, _ = run.build_model(cfg, "retrieval", device="cpu")
    assert run.load_initial_params(args, cfg, model) == []


@pytest.mark.parametrize("task", ["xgqa", "classification", "marvl", "xretrieval", "xvnli",
                                  "wit", "xflickrco"])
def test_iglue_tasks_are_no_longer_refused(corpus, task):
    """The IGLUE tasks and ``classification`` of an IGLUE ``dataset_type``
    (the default, XVNLI) reach their runners; the config here has no data
    for them, so the run stops at its first file key."""
    with pytest.raises(KeyError):
        _main(corpus, f"task_{task}", _model_cfg(corpus), task)


@pytest.mark.parametrize("task", ["video_qa", "next_qa_mc", "video_retrieval"])
def test_video_tasks_are_no_longer_refused(corpus, task):
    """The video tasks pass the task gate; the config here has no data for
    them, so the run stops at its first file key."""
    with pytest.raises(KeyError):
        _main(corpus, f"task_{task}", _model_cfg(corpus), task)


@pytest.mark.parametrize("task", ["grounding", "nlvr"])
def test_grounding_and_nlvr_are_no_longer_refused(corpus, task):
    """They pass the task gate and build their model; the config here has
    no data for them, so the run stops at the dataset."""
    with pytest.raises(KeyError, match="test_file"):
        _main(corpus, f"task_{task}", _model_cfg(corpus), task)


def test_captioning_is_no_longer_refused(corpus):
    """Captioning passes the task gate and builds its model; the config here
    has no data for it, so the run stops at the dataset."""
    with pytest.raises(KeyError, match="test_file"):
        _main(corpus, "task_captioning", _model_cfg(corpus), "captioning")


def test_vqa_is_no_longer_refused(corpus):
    """VQA passes the task gate and builds its model; the config here has
    no data for it, so the run stops at the dataset."""
    with pytest.raises(KeyError, match="test_file"):
        _main(corpus, "task_vqa", _model_cfg(corpus), "vqa")


@pytest.mark.parametrize("extra,err,match", [
    # the multilingual streams and the Plus base run (tests/test_torch_plus.py);
    # what stays refused around them:
    # native_aug: true runs the native data plane (raises where it cannot build)
    ({"native_aug": True}, None, "native"),
    ({"train_file_mtext": ["m.jsonl"], "mtexts": {"batch_size": 4}}, ValueError,
     "model_type: cclm"),
    ({"mixed_in_batch": False}, ValueError, "mixed_in_batch"),
    ({"images": {"batch_size": 4, "tokenized": True}}, ValueError, "tokenized"),
    ({"use_swin": True, "patch_size": 16}, ValueError, "use_swin requires patch_size"),
    ({"is_xvlm_ckpt": True}, ValueError, "is_xvlm_ckpt"),
    ({"remat": True, "remat_policy": "dot"}, ValueError, "remat_policy"),
    ({"flat_optimizer": True}, NotImplementedError, "flat_optimizer"),
])
def test_unported_streams_and_options_raise(corpus, extra, err, match):
    if err is None:   # no longer refused: the run takes the native data plane
        from x2vlm_tpu_torch.data.native import native_available, unavailable_reason

        if not native_available():
            with pytest.raises(RuntimeError, match=re.escape(unavailable_reason())):
                _main(corpus, "refused", _pretrain_cfg(corpus, **extra), "pretrain")
            return
        rec = _main(corpus, "refused", _pretrain_cfg(corpus, **extra), "pretrain")
        assert set(rec["data_plane"].values()) == {match}
        return
    with pytest.raises(err, match=match):
        _main(corpus, "refused", _pretrain_cfg(corpus, **extra), "pretrain")


def test_remat_pretraining_equals_the_plain_run_bit_for_bit(corpus):
    """``remat: true`` under ``dots`` (the image and text streams, dropout
    on): the saved state equals the plain run's bit for bit."""
    _main(corpus, "plain", _pretrain_cfg(corpus), "pretrain")
    _main(corpus, "remat", _pretrain_cfg(corpus, remat=True, remat_policy="dots"), "pretrain")
    plain, remat = _state(corpus, "plain"), _state(corpus, "remat")
    assert remat["step"] == plain["step"] == 2
    for part in ("params", "mu", "nu"):
        assert remat[part].keys() == plain[part].keys()
        for k, v in plain[part].items():
            assert torch.equal(remat[part][k], v), (part, k)


def test_unknown_config_keys_are_refused(corpus):
    with pytest.raises(ValueError, match="no_such_knob"):
        _main(corpus, "unknown", _pretrain_cfg(corpus, no_such_knob=1), "pretrain")


def test_the_launcher_runs_on_the_card_by_default(corpus, monkeypatch):
    assert run.parse_args(["--task", "pretrain", "--config", "c", "--output_dir", "o"]
                          ).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = corpus / "default.json"
    path.write_text(json.dumps(_pretrain_cfg(corpus)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run.main(["--task", "pretrain", "--config", str(path), "--output_dir",
                  str(corpus / "out_default")])
