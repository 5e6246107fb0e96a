"""The VQA host side, evaluation, launcher and server against the JAX
package: ``tokenize_answers``, ``VQATrainDataset`` (count / len weights,
the ``weight`` field, Visual Genome lines under ``vg_root``),
``vqa_collate`` (the seeded cut and the zero-weight padding) and
``VQAEvalDataset`` give the JAX package's arrays bit for bit from the same
seeds, as does ``create_dataset("vqa")``; ``evalkit/vqa.py`` equals the JAX
one on fixed strings; ``interp_rel_pos_table`` at 14 -> 48 (224 px weights
at the VQA config's 768 px) equals the JAX ``_interp_rel_pos_table``;
``evaluate_vqa`` and ``VQAServer.from_npz`` (a JAX ``params.npz``) rank as
the JAX functions do; a ``.th`` with ``text_decoder.*`` fills the decoder,
a pretraining ``.th`` leaves it fresh at ``lr_mult``; and the launcher's
``--task vqa`` on the shipped ``configs/finetune/vqa2_base.yaml`` (a tiny
inline model, the CPU) trains, evaluates and resumes exactly."""

import json
import random

import numpy as np
import pytest
from tests.torch_threads import few_torch_threads  # noqa: E402,F401 (autouse)
from PIL import Image

torch = pytest.importorskip("torch")

from tests.golden_torch import GoldenXVLM  # noqa: E402
from tests.test_torch_grounding import BOXES, RES, port_config  # noqa: E402
from tests.test_torch_vqa import ANSWERS, answer_atts, jb, vqa  # noqa: E402,F401
from x2vlm_tpu.data import TextPreprocessor as JaxTextPreprocessor  # noqa: E402
from x2vlm_tpu.data import transforms as JT  # noqa: E402
from x2vlm_tpu.data.factory import create_dataset as jax_create_dataset  # noqa: E402
from x2vlm_tpu.data.finetune import (  # noqa: E402
    VQAEvalDataset as JaxVQAEvalDataset, VQATrainDataset as JaxVQATrainDataset,
    tokenize_answers as jax_tokenize_answers, vqa_collate as jax_vqa_collate,
)
from x2vlm_tpu.data.tokenization import build_tokenizer as jax_build_tokenizer  # noqa: E402
from x2vlm_tpu.evalkit import vqa as jax_vqa_eval  # noqa: E402
from x2vlm_tpu.models.generation import XVLMForVQA as JaxXVLMForVQA  # noqa: E402
from x2vlm_tpu.serving import save_params_npz  # noqa: E402
from x2vlm_tpu.tasks.vqa import evaluate_vqa as jax_evaluate_vqa  # noqa: E402
from x2vlm_tpu.train.checkpoint import _interp_rel_pos_table  # noqa: E402
from x2vlm_tpu_torch import run  # noqa: E402
from x2vlm_tpu_torch.core.config import load_config  # noqa: E402
from x2vlm_tpu_torch.data import transforms as T  # noqa: E402
from x2vlm_tpu_torch.data.factory import create_dataset  # noqa: E402
from x2vlm_tpu_torch.data.finetune import (  # noqa: E402
    VQAEvalDataset, VQATrainDataset, tokenize_answers, vqa_collate,
)
from x2vlm_tpu_torch.data.tokenization import BertWordPiece, TextPreprocessor  # noqa: E402
from x2vlm_tpu_torch.evalkit import vqa as port_vqa_eval  # noqa: E402
from x2vlm_tpu_torch.serving import VQAServer  # noqa: E402
from x2vlm_tpu_torch.tasks.vqa import evaluate_vqa  # noqa: E402
from x2vlm_tpu_torch.train import checkpoint as ckpt_lib  # noqa: E402
from x2vlm_tpu_torch.train import param_labels  # noqa: E402

VOCAB = ("[PAD] [UNK] [CLS] [SEP] [MASK] a b c d e dog cat runs the quick brown fox "
         "jump ##s ##ing over lazy river bank small big red blue green house tree left "
         "right man on yes no two three what is color how many").split()
ANSWER_LIST = ["yes", "no", "two", "three", "red", "blue house", "the big red house",
               "dog", "a lazy dog runs over the river bank", "green tree"]
HUMAN = ["yes", "yes", "no", "yes", "yes", "no", "yes", "yes", "two", "yes"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("vqa")
    (d / "bert").mkdir()
    (d / "bert" / "vocab.txt").write_text("\n".join(VOCAB))
    rng = np.random.default_rng(0)
    for sub in ("imgs", "vg"):
        (d / sub).mkdir()
        for i in range(4):
            Image.fromarray(rng.integers(0, 255, (36 + 4 * i, 48, 3), np.uint8)).save(
                d / sub / f"im{i}.png")
    questions = ["what color is the house", "how many dogs", "is the man on the left",
                 "what is on the river bank", "how many big red trees", "is it blue",
                 "what runs", "is the fox quick"]
    train = []
    for i, q in enumerate(questions):
        line = {"image": f"im{i % 4}.png", "question": q, "question_id": 10 + i}
        if i % 4 == 1:     # precomputed weights
            line.update(answer=["two", "three"], weight=[0.7, 0.3])
        elif i % 4 == 2:   # a Visual Genome line, one answer
            line.update(answer="a dog", dataset="vg")
        else:              # 10 human answers, duplicates merged
            line["answer"] = [HUMAN[(i + j) % 10] for j in range(10)]
        train.append(line)
    (d / "train.json").write_text(json.dumps(train))
    test = [{"image": f"im{i % 4}.png", "question": q, "question_id": 100 + i,
             "answer": [HUMAN[(i + j) % 10] for j in range(10)]}
            for i, q in enumerate(questions[:5])]
    (d / "test.json").write_text(json.dumps(test))
    (d / "test_std.json").write_text(json.dumps(
        [{k: v for k, v in a.items() if k != "answer"} for a in test]))
    (d / "answers.json").write_text(json.dumps(ANSWER_LIST))
    return d


def _tokenizers(corpus):
    return jax_build_tokenizer(str(corpus / "bert")), BertWordPiece(str(corpus / "bert" /
                                                                        "vocab.txt"))


def _pres(corpus):
    jt, pt = _tokenizers(corpus)
    return JaxTextPreprocessor(jt, max_tokens=10), TextPreprocessor(pt, max_tokens=10)


def _assert_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k


# ---- the datasets ----

@pytest.mark.parametrize("max_tokens", [4, 10])
def test_tokenize_answers_equals_jax(corpus, max_tokens):
    """CLS, the pieces, SEP, padded; answers longer than ``max_tokens`` cut."""
    jt, pt = _tokenizers(corpus)
    want = jax_tokenize_answers(ANSWER_LIST, jt, max_tokens)
    got = tokenize_answers(ANSWER_LIST, pt, max_tokens)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype == np.int32
    assert got[0].shape == (len(ANSWER_LIST), max_tokens)


def test_vqa_train_dataset_equals_jax(corpus):
    """The train transform from equal seeds, two passes: images, question
    ids, answers and weights bit for bit; count / len weights, the
    ``weight`` field and a Visual Genome line's root."""
    roots = {"vqa": str(corpus / "imgs"), "vg": str(corpus / "vg")}
    jpre, ppre = _pres(corpus)
    jt, pt = _tokenizers(corpus)
    r1, r2 = random.Random(3), random.Random(3)
    want = JaxVQATrainDataset(str(corpus / "train.json"), JT.train_transform(RES, rng=r1),
                              roots, jpre, jt, answer_max_tokens=6, rng=r1)
    got = VQATrainDataset(str(corpus / "train.json"), T.train_transform(RES, rng=r2),
                          roots, ppre, pt, answer_max_tokens=6, rng=r2)
    assert len(got) == len(want) == 8
    for _ in range(2):
        for i in range(len(want)):
            _assert_equal(got[i], want[i])
    np.testing.assert_allclose(got[0]["weights"].sum(), 1.0, rtol=1e-6)
    np.testing.assert_array_equal(got[1]["weights"], np.float32([0.7, 0.3]))


@pytest.mark.parametrize("answers_per_batch", [3, 8, 20])
def test_vqa_collate_equals_jax(corpus, answers_per_batch):
    """Cut to a sorted sample (3, 8 of the 13 answer rows) or padded with
    weight-0 rows (20) from the same ``random.Random``, twice in a row."""
    jpre, ppre = _pres(corpus)
    jt, pt = _tokenizers(corpus)
    want_ds = JaxVQATrainDataset(str(corpus / "train.json"), JT.test_transform(RES),
                                 str(corpus / "imgs"), jpre, jt)
    got_ds = VQATrainDataset(str(corpus / "train.json"), T.test_transform(RES),
                             str(corpus / "imgs"), ppre, pt)
    idx = [0, 1, 3, 4, 5]
    r1, r2 = random.Random(9), random.Random(9)
    for _ in range(2):
        want = jax_vqa_collate([want_ds[i] for i in idx], answers_per_batch, rng=r1)
        got = vqa_collate([got_ds[i] for i in idx], answers_per_batch, rng=r2)
        _assert_equal(got, want)
    assert got["answer_ids"].shape[0] == answers_per_batch
    n_rows = sum(len(got_ds[i]["weights"]) for i in idx)
    assert n_rows == 13
    if answers_per_batch == 20:
        pad = got["answer_weights"] == 0
        assert pad.sum() == 20 - n_rows and (got["answer_atts"][pad].sum(1) == 1).all()


def test_vqa_eval_dataset_equals_jax(corpus):
    jpre, ppre = _pres(corpus)
    jt, pt = _tokenizers(corpus)
    want = JaxVQAEvalDataset(str(corpus / "test.json"), JT.test_transform(RES),
                             str(corpus / "imgs"), jpre, jt,
                             answer_list_file=str(corpus / "answers.json"))
    got = VQAEvalDataset(str(corpus / "test.json"), T.test_transform(RES),
                         str(corpus / "imgs"), ppre, pt,
                         answer_list_file=str(corpus / "answers.json"))
    for i in range(len(want)):
        _assert_equal(got[i], want[i])
    assert got.answer_list == want.answer_list == ANSWER_LIST
    np.testing.assert_array_equal(got.answer_ids, want.answer_ids)
    np.testing.assert_array_equal(got.answer_atts, want.answer_atts)
    assert got.gt_answers() == want.gt_answers() and len(got.gt_answers()) == 5
    std = VQAEvalDataset(str(corpus / "test_std.json"), T.test_transform(RES),
                         str(corpus / "imgs"), ppre, pt)
    assert std.gt_answers() == {} and std.answer_list is None


def _vqa_cfg(corpus, **extra):
    cfg = {"image_res": RES, "text_encoder": str(corpus / "bert"), "max_tokens": 10,
           "vqa_root": str(corpus / "imgs"), "vg_root": str(corpus / "vg"),
           "train_file": [str(corpus / "train.json")],
           "test_file": [str(corpus / "test.json")],
           "answer_list": str(corpus / "answers.json"), "answer_max_tokens": 6}
    cfg.update(extra)
    return cfg


@pytest.mark.parametrize("test_file", ["list", "dict"])
def test_create_dataset_equals_jax(corpus, test_file):
    """The factory's VQA train and eval sets from ``random.Random(7)``, the
    Visual Genome root by ``vg_root``, a {split: file} test set."""
    cfg = _vqa_cfg(corpus)
    if test_file == "dict":
        cfg["test_file"] = {"dev": str(corpus / "test.json"),
                            "std": str(corpus / "test_std.json")}
    want_tr, want_ev = jax_create_dataset("vqa", cfg, rng=random.Random(7))
    got_tr, got_ev = create_dataset("vqa", cfg, rng=random.Random(7))
    for i in range(len(want_tr)):
        _assert_equal(got_tr[i], want_tr[i])
    pairs = ([(got_ev[k], want_ev[k]) for k in want_ev] if test_file == "dict"
             else [(got_ev, want_ev)])
    for g, w in pairs:
        assert g.answer_list == w.answer_list
        for i in range(len(w)):
            _assert_equal(g[i], w[i])
    assert create_dataset("vqa", cfg, evaluate=True)[0] is None


# ---- evaluation ----

STRINGS = ["Yes.", "two dogs", "Two", "the  Man's hat!", "isnt it", "a red, blue house",
           "3,000", "ten", "none of them", "it's 7.5", "yes/no", "what's (this)?",
           "dont", "an apple\tpie\n", "1.5.", "Y'all'd've"]


def test_normalize_and_accuracy_equal_jax():
    for s in STRINGS:
        assert port_vqa_eval.normalize_answer(s) == jax_vqa_eval.normalize_answer(s), s
    gts = [HUMAN, ["two"] * 3 + ["2"] * 4 + ["three"] * 3, ["Yes."] * 2 + ["no"] * 8]
    for pred in ("yes", "2", "two", "no", "Yes", "three"):
        for g in gts:
            assert port_vqa_eval.vqa_accuracy(pred, g) == jax_vqa_eval.vqa_accuracy(pred, g)
    results = [{"question_id": i, "answer": a} for i, a in enumerate(("yes", "2", "no", "x"))]
    ann = {0: HUMAN, 1: gts[1], 2: gts[2], 7: ["x"]}
    assert port_vqa_eval.vqa_eval(results, ann) == jax_vqa_eval.vqa_eval(results, ann)
    single = {0: "yes", 1: ["3", "2"], 3: "y"}
    assert port_vqa_eval.exact_match_accuracy(results, single) == \
        jax_vqa_eval.exact_match_accuracy(results, single) == pytest.approx(200 / 3)


def test_evaluate_vqa_equals_jax(vqa, corpus):
    """5 questions at batch 2 (the last batch padded in both packages) and
    one batch of all, over the tiny model's answer list."""
    jpre, _ = _pres(corpus)
    jt, _ = _tokenizers(corpus)
    rows = [{"image": f"im{i % 4}.png", "question": q, "question_id": 50 + i}
            for i, q in enumerate(["the dog runs", "a big red house", "the quick fox",
                                   "a b c", "man on the left"])]
    path = corpus / "eval_tiny.json"
    path.write_text(json.dumps(rows))
    ds = VQAEvalDataset(str(path), T.test_transform(RES), str(corpus / "imgs"),
                        _pres(corpus)[1], _tokenizers(corpus)[1])
    jds = JaxVQAEvalDataset(str(path), JT.test_transform(RES), str(corpus / "imgs"), jpre, jt)
    names = [f"answer {i}" for i in range(len(ANSWERS))]
    for bs, k in ((2, 4), (5, len(ANSWERS))):
        want = jax_evaluate_vqa(vqa["model"], vqa["variables"], jds, names, ANSWERS,
                                answer_atts(ANSWERS), k_test=k, batch_size=bs)
        got = evaluate_vqa(vqa["port"], ds, names, ANSWERS, answer_atts(ANSWERS),
                           device="cpu", k_test=k, batch_size=bs)
        assert got == want and len(got) == 5


def test_vqa_server_from_npz_ranks_as_jax_predict(vqa, tmp_path):
    """A JAX ``params.npz`` served by ``VQAServer.from_npz`` (the decoder's
    depth read from it): the top-k ids equal JAX ``predict``'s, the scores
    to 1e-5."""
    save_params_npz(str(tmp_path / "params.npz"), vqa["variables"])
    server = VQAServer.from_npz(tmp_path / "params.npz", port_config(), dtype=torch.float32,
                                device="cpu")
    assert server.model.num_dec_layers == 2
    b = vqa["batch"]
    pred = {"image": b["image"], "question_ids": b["question_ids"],
            "question_atts": b["question_atts"], "answer_ids": ANSWERS,
            "answer_atts": answer_atts(ANSWERS)}
    want_ids, want_probs = vqa["model"].apply(vqa["variables"], jb(pred), 4,
                                              method=JaxXVLMForVQA.predict)
    ids, probs = server.rank(b["image"], b["question_ids"], b["question_atts"], ANSWERS,
                             answer_atts(ANSWERS), k_test=4)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(probs.numpy(), np.asarray(want_probs), **BOXES)
    all_ids, _ = server.rank(b["image"], b["question_ids"], b["question_atts"], ANSWERS,
                             answer_atts(ANSWERS))
    assert all_ids.shape == (3, len(ANSWERS))     # k_test 128 capped at the list


# ---- checkpoints ----

@pytest.mark.parametrize("src,dst,heads", [(14, 48, 12), (14, 48, 2)])
def test_interp_rel_pos_table_at_768px_equals_jax(src, dst, heads):
    """224 px weights (window 14) at the VQA config's 768 px (window 48)."""
    table = np.random.default_rng(src + heads).standard_normal(
        ((2 * src - 1) ** 2 + 3, heads)).astype(np.float32)
    got = ckpt_lib.interp_rel_pos_table(table, src, dst)
    assert got.shape == ((2 * dst - 1) ** 2 + 3, heads)
    np.testing.assert_array_equal(got, _interp_rel_pos_table(table, src, dst))
    np.testing.assert_array_equal(got[-3:], table[-3:])


TINY = dict(
    image_res=RES,
    vision_config_inline={"vision_width": 32, "patch_size": 16, "num_hidden_layers": 2,
                          "num_attention_heads": 2},
    text_num_hidden_layers=4, text_fusion_start_at=2,
    text_config_inline={"vocab_size": 100, "hidden_size": 32, "num_heads": 2,
                        "intermediate_size": 64, "max_position_embeddings": 64},
    embed_dim=16, max_tokens=10, num_dec_layers=2)


def _shipped(corpus, **extra):
    """configs/finetune/vqa2_base.yaml, its data paths pointed at the corpus,
    a tiny model, batch 4 (eval 3), 2 epochs, the eval after the last."""
    cfg = load_config("configs/finetune/vqa2_base.yaml").to_dict()
    del cfg["vision_config"]
    cfg.update(TINY, text_encoder=str(corpus / "bert"), vqa_root=str(corpus / "imgs"),
               vg_root=str(corpus / "vg"), train_file=[str(corpus / "train.json")],
               test_file=[str(corpus / "test.json")], answer_list=str(corpus / "answers.json"),
               batch_size=4, batch_size_test=3, k_test=4, start_eval=1,
               schedular=dict(cfg["schedular"], epochs=2))
    cfg.update(extra)
    return cfg


@pytest.mark.parametrize("large_lr_for_dec", [False, True])
def test_a_pretraining_th_leaves_the_decoder_fresh_at_lr_mult(corpus, tmp_path,
                                                              large_lr_for_dec):
    """A pretraining ``.th`` fills the vision and text towers and leaves
    every decoder parameter fresh, in the lr_mult group (2 in the shipped
    config); the projections, ``temp`` and the ITM, MLM and bbox heads are
    left over. ``large_lr_for_dec`` changes nothing here (the decoder is
    fresh either way)."""
    torch.manual_seed(0)
    sd = GoldenXVLM().state_dict()
    torch.save({"model": sd}, tmp_path / "x.th")
    cfg = _shipped(corpus, large_lr_for_dec=large_lr_for_dec)
    model, mcfg = run.build_model(cfg, "vqa", device="cpu")
    missing, unexpected = ckpt_lib.load_reference_checkpoint(model, str(tmp_path / "x.th"))
    decoder = sorted(n for n, _ in model.named_parameters() if n.startswith("text_decoder."))
    assert missing == decoder and len(decoder) > 0
    assert {k.split(".")[0] for k in unexpected} >= {"vision_proj", "text_proj", "itm_head",
                                                     "bbox_head", "temp"}
    assert not any(k.startswith("vision_encoder.") and "relative_position_index" not in k
                   for k in unexpected)
    labels = param_labels(model.named_parameters(), mcfg.text.fusion_layer,
                          fresh_names=missing)
    assert {n for n, lab in labels.items() if lab == "fresh"} == set(decoder)
    opt = run.make_optimizer(cfg, model, 10, mcfg.text.fusion_layer, fresh_names=missing)
    assert (True, 2.0) in dict(opt.groups)


@pytest.mark.parametrize("large_lr_for_dec", [False, True])
def test_a_vqa_th_fills_the_decoder(corpus, tmp_path, large_lr_for_dec):
    """A fine-tuned VQA ``.th`` (reference names, the tied decoder weight
    among them) loads the whole model: nothing missing, the tied weight left
    over; with ``large_lr_for_dec`` the whole decoder still trains at
    lr_mult."""
    cfg = _shipped(corpus, large_lr_for_dec=large_lr_for_dec)
    src, mcfg = run.build_model(cfg, "vqa", device="cpu", seed=3)
    sd = dict(src.state_dict())
    sd["text_decoder.cls.predictions.decoder.weight"] = \
        sd["text_decoder.bert.embeddings.word_embeddings.weight"]
    torch.save({"model": sd}, tmp_path / "vqa.th")
    model, _ = run.build_model(cfg, "vqa", device="cpu", seed=4)
    args = run.parse_args(["--task", "vqa", "--config", "x", "--output_dir", str(tmp_path),
                           "--checkpoint", str(tmp_path / "vqa.th"), "--device", "cpu"])
    assert run.load_initial_params(args, cfg, model) == []
    missing, unexpected = ckpt_lib.load_reference_checkpoint(model, str(tmp_path / "vqa.th"))
    assert missing == [] and unexpected == ["text_decoder.cls.predictions.decoder.weight"]
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    opt = run.make_optimizer(cfg, model, 10, mcfg.text.fusion_layer)
    at_lr_mult = {opt.names[i] for (_, scale), idx in opt.groups if scale == 2.0 for i in idx}
    decoder = {n for n in opt.names if n.startswith("text_decoder.")}
    assert at_lr_mult == (decoder if large_lr_for_dec else set())


# ---- the launcher on the shipped config ----

def _main(corpus, name, cfg, *extra):
    path = corpus / f"cfg_{name}.json"
    path.write_text(json.dumps(cfg))
    return run.main(["--task", "vqa", "--config", str(path), "--output_dir",
                     str(corpus / f"out_{name}"), "--seed", "0", "--device", "cpu", *extra])


def _state(corpus, name, ckpt="ckpt"):
    return torch.load(corpus / f"out_{name}" / ckpt / ckpt_lib.TRAIN_STATE_FILE,
                      weights_only=False)


def test_vqa_launcher_train_evaluate_resume(corpus, monkeypatch):
    """8 questions at batch 4 over 2 epochs (4 steps, 8 answer rows a
    batch): the losses and the eval (``overall`` of 10 human answers, the
    exact match ``acc``, ``vqa_result.json``) finite; ``--evaluate`` from
    the saved state gives the same metrics; a ``--resume`` from the state
    saved at step 2 reads the same batches at steps 3 and 4 (the data
    cursor and the answer-cut rng) and ends in the whole run's state bit
    for bit."""
    cfg = _shipped(corpus)
    assert cfg["image_res"] == RES and cfg["optimizer"]["lr_mult"] == 2
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
        if step == 2 and ckpt_dir.endswith("out_vqa/ckpt"):
            save(str(corpus / "out_resumed" / "ckpt"), model, optimizer, step, data_state)
        return path

    monkeypatch.setattr(run, "to_device", spy_batches("whole"))
    monkeypatch.setattr(ckpt_lib, "save_train_state", save_step2)
    rec = _main(corpus, "vqa", cfg)
    for k in ("loss_vqa", "eval_overall", "eval_acc"):
        assert np.isfinite(rec[k]), k
    assert rec["epoch"] == 1 and rec["eval_n"] == 5
    whole = _state(corpus, "vqa")
    assert whole["step"] == whole["count"] == 4
    assert len(batches["whole"]) == 4
    assert all(b["answer_ids"].shape == (8, 10) for b in batches["whole"])
    results = json.loads((corpus / "out_vqa" / "vqa_result.json").read_text())
    assert sorted(r["question_id"] for r in results) == list(range(100, 105))
    assert all(r["answer"] in ANSWER_LIST for r in results)

    metrics = _main(corpus, "vqa", cfg, "--evaluate", "--checkpoint",
                    str(corpus / "out_vqa" / "ckpt"))
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


def test_vqa_launcher_metric_by_answer_count(corpus):
    """Test lines with one answer each are scored by the exact match
    (``acc`` picks the best epoch); a split with none writes its results
    and counts them."""
    one = [dict(a, answer=a["answer"][0])
           for a in json.loads((corpus / "test.json").read_text())]
    (corpus / "test_one.json").write_text(json.dumps(one))
    cfg = _shipped(corpus, test_file={"one": str(corpus / "test_one.json"),
                                      "std": str(corpus / "test_std.json")})
    metrics = _main(corpus, "split", cfg, "--evaluate")
    assert set(metrics) == {"one_n", "one_overall", "one_acc", "std_n", "acc"}
    assert metrics["acc"] == metrics["one_acc"] and metrics["std_n"] == 5
    for split in ("one", "std"):
        assert (corpus / "out_split" / f"vqa_result_{split}.json").is_file()
