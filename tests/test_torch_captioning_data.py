"""The captioning host side, evaluation, SCST, launcher and server against
the JAX package: ``CaptioningTrainDataset`` (standard and FG-free, through
``create_dataset``), ``CaptioningSCSTDataset`` and ``CaptioningEvalDataset``
give the JAX arrays bit for bit from the same seeds; ``build_scst_batch``
and ``scst_rewards`` equal the JAX ones; the
caption metrics equal ``x2vlm_tpu/evalkit/caption.py`` on the same
strings; ``BertWordPiece.decode`` equals ``BertTokenizerFast.decode``;
``generate_captions`` and ``CaptioningServer.from_npz`` (a JAX-exported
bundle) give the JAX captions; a reference ``.th`` fills the model with
``text_encoder.cls.predictions.*`` as the MLM head; and the launcher's
``--task captioning`` on the shipped
``configs/finetune/coco_captioning_base.yaml`` (a tiny inline model, the
CPU) trains, evaluates, resumes exactly and takes SCST steps."""

import json
import random

import numpy as np
import pytest
from PIL import Image

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tests.golden_torch import GoldenXVLM  # noqa: E402
from tests.test_torch_captioning import PROMPT, SEARCH, cap  # noqa: E402,F401
from tests.test_torch_grounding import RES  # noqa: E402
from tests.test_torch_grounding import VOCAB as MODEL_VOCAB  # noqa: E402
from x2vlm_tpu.data import transforms as JT  # noqa: E402
from x2vlm_tpu.data.factory import create_dataset as jax_create_dataset  # noqa: E402
from x2vlm_tpu.data.finetune import (  # noqa: E402
    CaptioningEvalDataset as JaxCaptioningEvalDataset,
    CaptioningSCSTDataset as JaxCaptioningSCSTDataset,
)
from x2vlm_tpu.data.tokenization import build_tokenizer as jax_build_tokenizer  # noqa: E402
from x2vlm_tpu.evalkit import caption as jax_caption  # noqa: E402
from x2vlm_tpu.serving import export_captioning_bundle, load_captioning_bundle  # noqa: E402
from x2vlm_tpu.tasks import scst as jax_scst  # noqa: E402
from x2vlm_tpu.tasks.captioning import generate_captions as jax_generate_captions  # noqa: E402
from x2vlm_tpu.train import scst as jax_train_scst  # noqa: E402
from x2vlm_tpu_torch import run  # noqa: E402
from x2vlm_tpu_torch.core.config import load_config  # noqa: E402
from x2vlm_tpu_torch.data import transforms as T  # noqa: E402
from x2vlm_tpu_torch.data.factory import create_dataset  # noqa: E402
from x2vlm_tpu_torch.data.finetune import (  # noqa: E402
    CaptioningEvalDataset, CaptioningSCSTDataset,
)
from x2vlm_tpu_torch.data.tokenization import BertWordPiece  # noqa: E402
from x2vlm_tpu_torch.evalkit import caption as port_caption  # noqa: E402
from x2vlm_tpu_torch.serving import CaptioningServer  # noqa: E402
from x2vlm_tpu_torch.tasks import scst as port_scst  # noqa: E402
from x2vlm_tpu_torch.tasks.captioning import generate_captions  # noqa: E402
from x2vlm_tpu_torch.train import checkpoint as ckpt_lib  # noqa: E402
from x2vlm_tpu_torch.train import scst as port_train_scst  # noqa: E402

VOCAB = ("[PAD] [UNK] [CLS] [SEP] [MASK] a b c d e dog cat runs the quick brown fox "
         "jump ##s ##ing over lazy river bank small big red blue green house tree left "
         "right man on picture of with two sitting near . , ' ##ed ##ly").split()
CAPTIONS = ["A dog runs over the river bank.", "two small cats sitting near a tree",
            "the quick brown fox jumps over the lazy dog", "a man on the left, jumping",
            "a big red house with a green tree", "the lazy cat's bank is blue",
            "a quick dog runs, sitting near the brown house",
            "a brownish dog jumped quickly over the small red fox near the big lazy river"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("cap")
    (d / "bert").mkdir()
    (d / "bert" / "vocab.txt").write_text("\n".join(VOCAB))
    (d / "imgs").mkdir()
    rng = np.random.default_rng(0)
    for i in range(6):
        Image.fromarray(rng.integers(0, 255, (36 + 4 * i, 48, 3), np.uint8)).save(
            d / "imgs" / f"im{i}.png")
    train = [{"image": f"im{i % 6}.png", "caption": c, "image_id": f"coco_{100 + i % 6}"}
             for i, c in enumerate(CAPTIONS)]
    train[3]["caption"] = [CAPTIONS[3], CAPTIONS[4]]           # a list: one drawn
    test = [{"image": f"im{i}.png", "caption": CAPTIONS[i:i + 5],
             "image_id": f"COCO_val2014_{200 + i:012d}.jpg"} for i in range(5)]
    (d / "train.json").write_text(json.dumps(train))
    (d / "test.json").write_text(json.dumps(test))
    (d / "gt.json").write_text(json.dumps({str(200 + i): CAPTIONS[i:i + 5] for i in range(5)}))
    return d


def _assert_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k


def _cfg(corpus, **extra):
    cfg = load_config("configs/finetune/coco_captioning_base.yaml").to_dict()
    del cfg["vision_config"]
    cfg.update(image_res=RES, text_encoder=str(corpus / "bert"),
               image_root=str(corpus / "imgs"), train_file=[str(corpus / "train.json")],
               test_file=[str(corpus / "test.json")], caption_gt_file=str(corpus / "gt.json"))
    cfg.update(extra)
    return cfg


# ---- the datasets ----

@pytest.mark.parametrize("fg_free", [False, True])
def test_create_dataset_captioning_equals_jax(corpus, fg_free):
    """Both factories from one seed: every train sample (the transform
    without the flip, the whole-word masks after the prompt, both
    encodings; a line with a caption list) and every eval sample (the
    ``image_id`` parsed from a COCO file name) bit for bit."""
    cfg = _cfg(corpus, fg_free=fg_free, mask_prob=0.6)
    jtok = jax_build_tokenizer(cfg["text_encoder"])
    want_tr, want_ev = jax_create_dataset("captioning", cfg, tokenizer=jtok,
                                          rng=random.Random(5))
    got_tr, got_ev = create_dataset("captioning", cfg, rng=random.Random(5))
    assert len(got_tr) == len(want_tr) == len(CAPTIONS) and got_tr.seq_len == want_tr.seq_len
    for _ in range(2):              # the rng runs on across an epoch
        for i in range(len(want_tr)):
            _assert_equal(got_tr[i], want_tr[i])
    assert any(0 < w.sum() for w in (got_tr[i]["masked_weight"] for i in range(3)))
    for i in range(len(want_ev)):
        _assert_equal(got_ev[i], want_ev[i])
    assert [int(got_ev[i]["image_id"]) for i in range(5)] == list(range(200, 205))
    assert create_dataset("captioning", cfg, evaluate=True)[0] is None


def test_scst_and_eval_datasets_equal_jax(corpus):
    """One row an image with every caption of it, sorted by path."""
    tf, jtf = T.test_transform(RES), JT.test_transform(RES)
    files = [str(corpus / "train.json")]
    got = CaptioningSCSTDataset(files, tf, str(corpus / "imgs"))
    want = JaxCaptioningSCSTDataset(files, jtf, str(corpus / "imgs"))
    assert len(got) == len(want) == 6
    for i in range(len(want)):
        g, w = got[i], want[i]
        assert g["captions"] == w["captions"]
        np.testing.assert_array_equal(g["image"], w["image"])
    ev = CaptioningEvalDataset([str(corpus / "train.json")], tf, str(corpus / "imgs"))
    jev = JaxCaptioningEvalDataset([str(corpus / "train.json")], jtf, str(corpus / "imgs"))
    for i in range(len(jev)):
        _assert_equal(ev[i], jev[i])


def test_build_scst_batch_equals_jax():
    """The FG-free rows of sampled captions (one empty, one with more
    tokens than ``max_length + 1`` targets: the rest cut), the images
    repeated, the advantages as ``sample_weights``."""
    images = np.random.default_rng(1).standard_normal((2, 4, 4, 3)).astype(np.float32)
    sampled = [[10, 11], [], [5, 6, 7, 8, 9, 10, 11, 12], [13]]
    adv = np.array([0.5, -0.5, 1.5, -1.5], np.float32)
    kw = dict(mask_token_id=4, sep_token_id=3, pad_token_id=0, max_length=5)
    want = jax_scst.build_scst_batch(jnp.asarray(images), sampled, adv, PROMPT, **kw)
    got = port_scst.build_scst_batch(torch.from_numpy(images), sampled, adv, PROMPT, **kw)
    assert got.keys() == want.keys()
    for k in want:
        g, w = got[k].numpy(), np.asarray(want[k])
        np.testing.assert_array_equal(g, w, err_msg=k)
        assert g.dtype == (np.int64 if w.dtype == np.int32 else w.dtype), k
    assert got["masked_weight"][2].sum() == 6 and got["masked_weight"][1].sum() == 1


# ---- metrics and rewards ----

PREDS = ["a dog runs over the bank", "two cats sitting", "the fox jumped over a lazy dog",
         "", "houses and trees trees", "a man is running quickly on the left"]
REFS = [[CAPTIONS[0].lower(), "a dog running on a river bank"], [CAPTIONS[1], "cats near trees"],
        [CAPTIONS[2]], ["an empty caption"], ["a big red house with a green tree"],
        ["a man runs on the left side", "the running man", "man running fast"]]


def test_caption_metrics_equal_jax():
    for name in ("bleu", "cider_d", "rouge_l", "meteor"):
        assert getattr(port_caption, name)(PREDS, REFS) == \
            getattr(jax_caption, name)(PREDS, REFS), name
    words = "running runs jumped quickly happiness relational conditional agreed caresses"
    assert [port_caption.porter_stem(w) for w in words.split()] == \
        [jax_caption.porter_stem(w) for w in words.split()]
    preds = [{"image_id": i, "caption": p} for i, p in enumerate(PREDS)]
    anns = {i: r for i, r in enumerate(REFS)}
    assert port_caption.caption_eval(preds, anns) == jax_caption.caption_eval(preds, anns)


@pytest.mark.parametrize("baseline", [False, True])
def test_scst_rewards_equal_jax(baseline):
    sampled = PREDS + PREDS[::-1]
    refs = REFS[:4]
    kw = dict(num_samples_per_image=3, baseline=PREDS[:4] if baseline else None)
    np.testing.assert_array_equal(port_train_scst.scst_rewards(sampled, refs, **kw),
                                  jax_train_scst.scst_rewards(sampled, refs, **kw))


def test_decode_equals_bert_tokenizer_fast(corpus):
    """Random id lists over the whole vocab (special tokens, ``##`` pieces,
    punctuation), with and without the special tokens."""
    jtok = jax_build_tokenizer(str(corpus / "bert"))
    tok = BertWordPiece(str(corpus / "bert" / "vocab.txt"))
    rng = np.random.default_rng(3)
    for n in list(range(0, 12)) * 15:
        ids = rng.integers(0, len(VOCAB), n).tolist()
        for skip in (True, False):
            assert tok.decode(ids, skip_special_tokens=skip) == \
                jtok.decode(ids, skip_special_tokens=skip), (ids, skip)
    ids = jtok.convert_tokens_to_ids(jtok.tokenize(CAPTIONS[-1]))
    assert tok.decode(ids) == jtok.decode(ids)
    assert (tok.mask_token_id, tok.sep_token_id, tok.cls_token_id) == \
        (jtok.mask_token_id, jtok.sep_token_id, jtok.cls_token_id)


# ---- generation over a set, and the server ----

@pytest.fixture(scope="module")
def model_corpus(tmp_path_factory):
    """The model fixture's vocab (36 tokens) as a bert vocab, and 3 images."""
    d = tmp_path_factory.mktemp("capgen")
    (d / "bert").mkdir()
    (d / "bert" / "vocab.txt").write_text("\n".join(MODEL_VOCAB))
    rng = np.random.default_rng(2)
    (d / "imgs").mkdir()
    for i in range(3):
        Image.fromarray(rng.integers(0, 255, (40, 40, 3), np.uint8)).save(
            d / "imgs" / f"im{i}.png")
    (d / "test.json").write_text(json.dumps([{"image": f"im{i}.png", "image_id": 7 + i}
                                             for i in range(3)]))
    return d


def test_generate_captions_equals_jax(cap, model_corpus):  # noqa: F811
    """3 images at batch 2 (the last batch padded), the prompt "a the", the
    captions decoded: the JAX task's results."""
    d = model_corpus
    files = [str(d / "test.json")]
    jtok = jax_build_tokenizer(str(d / "bert"))
    tok = BertWordPiece(str(d / "bert" / "vocab.txt"))
    kw = dict(prompt="a the", num_beams=2, min_length=2, max_length=5, batch_size=2)
    want = jax_generate_captions(cap["model"], cap["variables"], JaxCaptioningEvalDataset(
        files, JT.test_transform(RES), str(d / "imgs")), jtok, **kw)
    ds = CaptioningEvalDataset(files, T.test_transform(RES), str(d / "imgs"))
    got = generate_captions(cap["port"], ds, tok, device="cpu", **kw)
    assert got == want and [r["image_id"] for r in got] == [7, 8, 9]


def test_captioning_server_serves_a_jax_bundle(cap, tmp_path):  # noqa: F811
    """A bundle the JAX ``export_captioning_bundle`` wrote: the server's
    token lists equal the JAX ``CaptioningBundle.generate``, with and
    without a length penalty."""
    from tests.test_torch_grounding import port_config

    images = cap["images"]
    export_captioning_bundle(cap["model"], cap["variables"], str(tmp_path), batch=B_BUNDLE,
                             prompt_ids=PROMPT, mask_token_id=SEARCH["mask_token_id"],
                             eos_token_id=SEARCH["eos_token_id"], num_beams=3, min_length=2,
                             max_length=6, platforms=["cpu"])
    bundle = load_captioning_bundle(str(tmp_path))
    server = CaptioningServer.from_npz(tmp_path, port_config(), dtype=torch.float32,
                                       device="cpu")
    assert server.manifest["max_length"] == 6 and not server.model.training
    for lp in (0.0, 1.0):
        assert server.generate(images[:B_BUNDLE], length_penalty=lp) == \
            bundle.generate(images[:B_BUNDLE], length_penalty=lp)


B_BUNDLE = 2


def test_a_reference_th_fills_the_captioning_model(corpus, tmp_path):
    """A pretraining ``.th`` (reference names) fills every parameter, the MLM
    head from ``text_encoder.cls.predictions.*``; the projections, ``temp``,
    the ITM and bbox heads and the tied decoder weight are left over."""
    torch.manual_seed(0)
    sd = GoldenXVLM().state_dict()
    torch.save({"model": sd}, tmp_path / "x.th")
    cfg = _cfg(corpus, **TINY)
    model, _ = run.build_model(cfg, "captioning", device="cpu")
    args = run.parse_args(["--task", "captioning", "--config", "x", "--output_dir",
                           str(tmp_path), "--checkpoint", str(tmp_path / "x.th"),
                           "--device", "cpu"])
    assert run.load_initial_params(args, cfg, model) == []
    missing, unexpected = ckpt_lib.load_reference_checkpoint(model, str(tmp_path / "x.th"))
    assert missing == []
    assert {k.split(".")[0] for k in unexpected} == {"vision_proj", "text_proj", "itm_head",
                                                     "bbox_head", "temp", "vision_encoder",
                                                     "text_encoder"}
    assert [k for k in unexpected if k.startswith("text_encoder.")] == \
        ["text_encoder.cls.predictions.decoder.weight"]
    head = model.text_encoder.mlm_head
    assert torch.equal(head.bias, sd["text_encoder.cls.predictions.bias"])
    assert torch.equal(head.transform.dense.weight,
                       sd["text_encoder.cls.predictions.transform.dense.weight"])


# ---- the launcher on the shipped config ----

TINY = dict(
    vision_config_inline={"vision_width": 32, "patch_size": 16, "num_hidden_layers": 2,
                          "num_attention_heads": 2},
    text_num_hidden_layers=4, text_fusion_start_at=2,
    text_config_inline={"vocab_size": 100, "hidden_size": 32, "num_heads": 2,
                        "intermediate_size": 64, "max_position_embeddings": 64},
    embed_dim=16)


def _shipped(corpus, epochs=2, **extra):
    """coco_captioning_base.yaml, its data paths pointed at the corpus, a
    tiny model, batch 4 (eval 3), 2 epochs of 2 steps; the decode settings
    (prompt, beams 3, min 5, max 20) as shipped."""
    cfg = _cfg(corpus, **TINY)
    cfg.update(batch_size=4, batch_size_test=3,
               schedular=dict(cfg["schedular"], epochs=epochs), **extra)
    return cfg


def _main(corpus, name, cfg, *extra):
    path = corpus / f"cfg_{name}.json"
    path.write_text(json.dumps(cfg))
    return run.main(["--task", "captioning", "--config", str(path), "--output_dir",
                     str(corpus / f"out_{name}"), "--seed", "0", "--device", "cpu", *extra])


def _state(corpus, name):
    return torch.load(corpus / f"out_{name}" / "ckpt" / ckpt_lib.TRAIN_STATE_FILE,
                      weights_only=False)


def test_captioning_launcher_train_evaluate_resume(corpus, monkeypatch):
    """8 captions at batch 4 over 2 epochs: the smoothed loss and the eval
    (BLEU-1..4, CIDEr-D, ROUGE-L, METEOR over 5 images) finite;
    ``--evaluate`` from the saved state gives the same metrics; a
    ``--resume`` from the state saved at step 2 reads the same batches at
    steps 3 and 4 and ends in the whole run's state bit for bit."""
    cfg = _shipped(corpus)
    assert (cfg["prompt"], cfg["max_tokens"], cfg["max_masks"], cfg["label_smoothing"]) == \
        ("a picture of ", 25, 12, 0.1)
    batches = {}
    to_device = run.to_device
    save = ckpt_lib.save_train_state

    def spy_batches(name):
        def spy(batch, device):
            batches.setdefault(name, []).append({k: np.array(v) for k, v in batch.items()})
            return to_device(batch, device)
        return spy

    def save_step2(ckpt_dir, model, optimizer, step, data_state=None):
        path = save(ckpt_dir, model, optimizer, step, data_state)
        if step == 2 and ckpt_dir.endswith("out_cap/ckpt"):
            save(str(corpus / "out_resumed" / "ckpt"), model, optimizer, step, data_state)
        return path

    monkeypatch.setattr(run, "to_device", spy_batches("whole"))
    monkeypatch.setattr(ckpt_lib, "save_train_state", save_step2)
    rec = _main(corpus, "cap", cfg)
    for k in ("loss_caption", "eval_cider", "eval_bleu4", "eval_rouge_l", "eval_meteor"):
        assert np.isfinite(rec[k]), k
    assert rec["epoch"] == 1 and rec["eval_n"] == 5
    whole = _state(corpus, "cap")
    assert whole["step"] == whole["count"] == 4
    assert len(batches["whole"]) == 4
    assert all(b["text_ids_masked"].shape == (4, 25) for b in batches["whole"])
    assert batches["whole"][0]["text_atts_matrix"].shape == (4, 25, 25)

    metrics = _main(corpus, "cap", cfg, "--evaluate", "--checkpoint",
                    str(corpus / "out_cap" / "ckpt"))
    assert metrics == {k[len("eval_"):]: v for k, v in rec.items() if k.startswith("eval_")}

    monkeypatch.setattr(run, "to_device", spy_batches("resumed"))
    _main(corpus, "resumed", cfg, "--resume")
    assert len(batches["resumed"]) == 2
    for got, want in zip(batches["resumed"], batches["whole"][2:]):
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    resumed = _state(corpus, "resumed")
    assert resumed["step"] == resumed["count"] == 4
    for part in ("params", "mu", "nu"):
        for k, v in whole[part].items():
            assert torch.equal(resumed[part][k], v), (part, k)


def test_captioning_launcher_scst(corpus, monkeypatch):
    """``scst: true``: 6 images at 2 a step, 2 rollouts an image: 3
    policy-gradient steps of 4 rows of 4 + 2 * 21 tokens, the loss finite,
    the eval logged, the state saved; without ``caption_gt_file`` the plain
    eval counts the captions."""
    from x2vlm_tpu_torch.tasks import scst as tasks_scst

    seen = []
    build = tasks_scst.build_scst_batch

    def spy(images, sampled, advantages, *a, **k):
        batch = build(images, sampled, advantages, *a, **k)
        seen.append({k: tuple(v.shape) for k, v in batch.items()})
        return batch

    monkeypatch.setattr(tasks_scst, "build_scst_batch", spy)
    cfg = _shipped(corpus, epochs=1, scst=True, batch_size_scst=2, scst_num_samples=2)
    rec = _main(corpus, "scst", cfg)
    assert rec["epoch"] == 0 and np.isfinite(rec["loss_scst"])
    assert np.isfinite(rec["eval"]["cider"]) and rec["eval"]["n"] == 5
    assert len(seen) == 3
    assert seen[0]["text_ids_masked"] == (4, 4 + 2 * 21) and seen[0]["image"][0] == 4
    assert _state(corpus, "scst")["step"] == 3
    del cfg["caption_gt_file"]
    assert _main(corpus, "count", cfg, "--evaluate") == {"n": 5}


def test_captioning_launcher_scst_resume(corpus, monkeypatch):
    """``scst: true`` over 2 epochs of 3 steps, then ``--resume`` from the
    state saved after epoch 0: the resumed run takes only epoch 1's steps,
    on the whole run's SCST batches (rollouts and advantages included), and
    ends in its state bit for bit."""
    from x2vlm_tpu_torch.tasks import scst as tasks_scst

    batches = {}
    build = tasks_scst.build_scst_batch
    save = ckpt_lib.save_train_state

    def spy_batches(name):
        def spy(*a, **k):
            batch = build(*a, **k)
            batches.setdefault(name, []).append({key: v.cpu().numpy()
                                                 for key, v in batch.items()})
            return batch
        return spy

    def save_epoch0(ckpt_dir, model, optimizer, step, data_state=None):
        path = save(ckpt_dir, model, optimizer, step, data_state)
        if step == 3 and ckpt_dir.endswith("out_scst2/ckpt"):
            save(str(corpus / "out_scst2_resumed" / "ckpt"), model, optimizer, step,
                 data_state)
        return path

    cfg = _shipped(corpus, epochs=2, scst=True, batch_size_scst=2, scst_num_samples=2)
    del cfg["caption_gt_file"]
    monkeypatch.setattr(tasks_scst, "build_scst_batch", spy_batches("whole"))
    monkeypatch.setattr(ckpt_lib, "save_train_state", save_epoch0)
    rec = _main(corpus, "scst2", cfg)
    assert rec["epoch"] == 1 and np.isfinite(rec["loss_scst"])
    whole = _state(corpus, "scst2")
    assert whole["step"] == whole["count"] == 6 and whole["data_state"] == {"epochs_done": 2}
    assert len(batches["whole"]) == 6

    monkeypatch.setattr(tasks_scst, "build_scst_batch", spy_batches("resumed"))
    _main(corpus, "scst2_resumed", cfg, "--resume")
    assert len(batches["resumed"]) == 3
    for got, want in zip(batches["resumed"], batches["whole"][3:]):
        _assert_equal(got, want)
    resumed = _state(corpus, "scst2_resumed")
    assert resumed["step"] == resumed["count"] == 6
    for part in ("params", "mu", "nu"):
        for k, v in whole[part].items():
            assert torch.equal(resumed[part][k], v), (part, k)


def test_captioning_launcher_scst_takes_whole_batches_only(corpus):
    """A set of 6 images at 8 a step: no SCST step (as the JAX loop, which
    takes whole batches only), the loss logged nan, step 0 saved."""
    cfg = _shipped(corpus, epochs=1, scst=True, batch_size_scst=8, scst_num_samples=2)
    del cfg["caption_gt_file"]
    rec = _main(corpus, "scst_short", cfg)
    assert rec["epoch"] == 0 and np.isnan(rec["loss_scst"])
    state = _state(corpus, "scst_short")
    assert state["step"] == state["count"] == 0
