"""The video path's host side and its launcher against the JAX package:
``sample_frame_ids`` / ``sample_clip_ids`` and ``VideoTextStream`` (plain
frame lists, clip-of-clips lines, ``combine_continuous_clips``, skipped
captions, the ``broken`` count) give the JAX package's draws and arrays bit
for bit, as do ``load_frames``, the three video datasets and
``create_dataset``; ``evaluate_classification`` (video QA and multiple
choice) and ``evaluate_retrieval`` on videos equal the JAX functions; the
launcher (tiny inline models, the CPU) runs ``--task video_qa`` on the
shipped ``configs/finetune/vqa_msrvtt_base.yaml`` (train, ``--evaluate``,
an exact ``--resume``), ``--task next_qa_mc`` and ``--task
video_retrieval`` on written configs, and ``--task pretrain`` on the
shipped ``configs/pretrain/x2vlm_base_1b_stage2_video.yaml`` with an exact
resume of the video cursor; a ``.th`` whose frame positions have another
frame count imports into the video QA model."""

import base64
import io
import json
import random

import numpy as np
import pytest
from tests.torch_threads import few_torch_threads  # noqa: E402,F401 (autouse)
from PIL import Image

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests.test_torch_grounding import RES, port_config  # noqa: E402
from tests.test_torch_pretrain import _noisy  # noqa: E402
from tests.test_torch_region_data import _region_line  # noqa: E402
from tests.test_torch_video import F, configs, pair  # noqa: E402
from x2vlm_tpu.data import factory as jax_factory  # noqa: E402
from x2vlm_tpu.data import pretrain as jax_pretrain  # noqa: E402
from x2vlm_tpu.data import transforms as JT  # noqa: E402
from x2vlm_tpu.data import video as jax_video  # noqa: E402
from x2vlm_tpu.data.streaming import DistLineReader as JaxDistLineReader  # noqa: E402
from x2vlm_tpu.data.tokenization import (  # noqa: E402
    TextPreprocessor as JaxTextPreprocessor, build_tokenizer as jax_build_tokenizer,
)
from x2vlm_tpu.models import XVLMForRetrieval as JaxRetrieval  # noqa: E402
from x2vlm_tpu.serving import _flatten  # noqa: E402
from x2vlm_tpu.tasks import evaluate_classification as jax_evaluate_classification  # noqa: E402
from x2vlm_tpu.tasks.retrieval import evaluate_retrieval as jax_evaluate_retrieval  # noqa: E402
from x2vlm_tpu_torch import run  # noqa: E402
from x2vlm_tpu_torch.convert import convert_jax_params  # noqa: E402
from x2vlm_tpu_torch.core.config import load_config  # noqa: E402
from x2vlm_tpu_torch.data import factory, pretrain, video  # noqa: E402
from x2vlm_tpu_torch.data import transforms as T  # noqa: E402
from x2vlm_tpu_torch.data.streaming import DistLineReader  # noqa: E402
from x2vlm_tpu_torch.data.tokenization import BertWordPiece, TextPreprocessor  # noqa: E402
from x2vlm_tpu_torch.models import XVLMForRetrieval  # noqa: E402
from x2vlm_tpu_torch.tasks.classification import evaluate_classification  # noqa: E402
from x2vlm_tpu_torch.tasks.retrieval import evaluate_retrieval  # noqa: E402
from x2vlm_tpu_torch.train import checkpoint as ckpt_lib  # noqa: E402

VOCAB = ("[PAD] [UNK] [CLS] [SEP] [MASK] a b c d e dog cat runs the quick brown fox "
         "jump ##s ##ing over lazy river bank small big red blue green house tree left "
         "right man on").split()
WORDS = VOCAB[5:]
ANSWERS = ["dog", "cat", "river", "house", "tree", "man"]
N_VIDEOS = 6


def _png(rng, side=20):
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (side, side + 4, 3), np.uint8)).save(buf, format="PNG")
    return buf.getvalue()


def _caption(rng, n=5):
    return " ".join(rng.choice(WORDS, n))


def _stream_line(rng, i):
    """A pretraining video line: a plain frame list (2-9 frames), or every
    third line a clip-of-clips (clips of 1-3 frames, a caption each, some
    "[Music]", half ``is_continuous``); line 4 has every clip caption
    skipped (broken), line 7 an empty caption (passed over), line 10 a frame
    that does not decode (broken), line 13 one caption for all its clips."""
    frame = lambda: base64.b64encode(_png(rng)).decode()
    if i % 3 == 0 or i in (4, 13):
        clips = [[frame() for _ in range(int(rng.integers(1, 4)))]
                 for _ in range(int(rng.integers(2, 5)))]
        caps = [_caption(rng, 3) if rng.random() < 0.7 else "[Music]" for _ in clips]
        if i == 4:
            caps = ["[Music]"] * len(clips)
        line = {"frames": clips, "caption": _caption(rng) if i == 13 else caps,
                "is_continuous": bool(i % 2)}
    else:
        frames = [frame() for _ in range(int(rng.integers(2, 10)))]
        line = {"frames": frames,
                "caption": [_caption(rng), _caption(rng, 3)] if i % 2 else _caption(rng)}
    if i == 7:
        line["caption"] = ""
    if i == 10:
        line["frames"][0] = base64.b64encode(b"not an image").decode()
    return line


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("video")
    (d / "bert").mkdir()
    (d / "bert" / "vocab.txt").write_text("\n".join(VOCAB))
    rng = np.random.default_rng(0)
    with open(d / "videos.jsonl", "w") as f:
        for i in range(16):
            f.write(json.dumps(_stream_line(rng, i)) + "\n")
    # frame directories (2 to 7 frames) under video_root; video 5 as a path list
    root = d / "frames"
    for v in range(N_VIDEOS):
        (root / f"v{v}").mkdir(parents=True)
        for j in range(2 + v):
            (root / f"v{v}" / f"{j:03d}.png").write_bytes(_png(rng, 40))
    vid = lambda v: [f"v5/{j:03d}.png" for j in range(7)] if v == 5 else f"v{v}"
    qa = [{"video": vid(i % N_VIDEOS), "question": _caption(rng, 4),
           "answer": ANSWERS[i % 5] if i != 3 else "not on the list"} for i in range(16)]
    mc = [{"video": vid(i % N_VIDEOS), "question": _caption(rng, 4),
           "options": [_caption(rng, 2) for _ in range(5)], "answer": i % 5}
          for i in range(8)]
    ret = [{"video": vid(v), "caption": [_caption(rng), _caption(rng, 4)] if v % 2
            else _caption(rng), "video_id": f"id{v % 5}"} for v in range(N_VIDEOS)]
    for name, data in (("qa.json", qa), ("mc.json", mc), ("ret.json", ret),
                       ("answers.json", ANSWERS)):
        (d / name).write_text(json.dumps(data))
    with open(d / "img.jsonl", "w") as f:
        for _ in range(8):
            f.write(json.dumps({"binary": base64.b64encode(_png(rng, 40)).decode(),
                                "desc": _caption(rng, 8)}) + "\n")
    with open(d / "regions.jsonl", "w") as f:
        for i in range(8):
            f.write(json.dumps(_region_line(rng, i + 6)) + "\n")
    return d


def _assert_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype, k


# ---- sampling ----

def test_sample_frame_ids_equal_jax():
    for seed in range(40):
        n, frame_len = seed % 13 + 1, seed % 6 + 1
        for training in (True, False):
            a, b = random.Random(seed), random.Random(seed)
            assert pretrain.sample_frame_ids(n, frame_len, training, a) == \
                jax_pretrain.sample_frame_ids(n, frame_len, training, b)
            assert a.random() == b.random()


def test_sample_clip_ids_equal_jax():
    rng = np.random.default_rng(1)
    for seed in range(60):
        clips = [[0] * int(rng.integers(1, 5)) for _ in range(int(rng.integers(1, 8)))]
        caps = [" [Music] " if rng.random() < 0.3 else "x" for _ in clips] \
            if seed % 2 else None
        need = int(rng.integers(1, 14))
        a, b = random.Random(seed), random.Random(seed)
        assert pretrain.sample_clip_ids(clips, need, caps, {"[Music]"}, a) == \
            jax_pretrain.sample_clip_ids(clips, need, caps, {"[Music]"}, b)
        assert a.random() == b.random()


# ---- the pretraining stream ----

def _streams(corpus, seed, **kw):
    path = [str(corpus / "videos.jsonl")]
    out = []
    for Reader, Pre, tok, tf, Stream in (
            (DistLineReader, TextPreprocessor, BertWordPiece(str(corpus / "bert" / "vocab.txt")),
             T.pretrain_transform, pretrain.VideoTextStream),
            (JaxDistLineReader, JaxTextPreprocessor, jax_build_tokenizer(str(corpus / "bert")),
             JT.pretrain_transform, jax_pretrain.VideoTextStream)):
        rng = random.Random(seed)
        out.append(Stream(Reader(path, seed=1),
                          Pre(tok, max_tokens=10, max_words=10, max_masks=3, rng=rng),
                          tf(RES, rng=rng, as_float=False), frame_len=3, rng=rng, **kw))
    return out


@pytest.mark.parametrize("combine", [False, True])
def test_video_text_stream_equals_jax(corpus, combine):
    """Two passes over the 16 lines: the samples (uint8 frames) and the
    ``broken`` count equal; the empty caption passes over uncounted."""
    kw = dict(combine_continuous_clips=True, minimum_frames_before_sampling=4) \
        if combine else {}
    port, ref = _streams(corpus, 3, **kw)
    got = [s for s, _ in zip(port, range(26))]
    want = [s for s, _ in zip(ref, range(26))]
    _assert_equal(got, want)
    assert got[0]["image"].shape == (3, RES, RES, 3) and got[0]["image"].dtype == np.uint8
    assert port.broken == ref.broken == 4          # lines 4 and 10, in each pass


# ---- datasets ----

def _cfg(corpus, **extra):
    cfg = {"text_encoder": str(corpus / "bert"), "image_res": RES, "max_tokens": 10,
           "video_root": str(corpus / "frames"), "frame_len": F,
           "answer_list": str(corpus / "answers.json"), "num_options": 5}
    cfg.update(extra)
    return cfg


@pytest.mark.parametrize("task,ann", [("video_qa", "qa.json"), ("next_qa_mc", "mc.json"),
                                      ("video_retrieval", "ret.json")])
def test_create_dataset_equals_jax(corpus, task, ann):
    """Train and eval sets of each video task: every sample bit for bit
    (``load_frames`` float32 (F, H, W, 3); the train sets' random frames,
    crops and caption draws; the QA label -100 off the answer list), and
    the retrieval set's ``image_batch`` / ``text_batch`` and tables."""
    cfg = _cfg(corpus, train_file=[str(corpus / ann)], test_file=str(corpus / ann))
    sets = []
    for create in (factory.create_dataset, jax_factory.create_dataset):
        random.seed(5)
        train, test = create(task, cfg, rng=random.Random(7))
        sets.append(([train[i] for i in range(len(train))], [test[i] for i in range(len(test))],
                     test))
    (gt, ge, gds), (wt, we, wds) = sets
    _assert_equal(gt, wt)
    _assert_equal(ge, we)
    assert gt[0]["image"].shape == (F, RES, RES, 3) and gt[0]["image"].dtype == np.float32
    if task == "video_qa":
        assert gt[3]["labels"] == -100
    if task == "video_retrieval":
        np.testing.assert_array_equal(gds.image_batch([0, 5]), wds.image_batch([0, 5]))
        for a, b in zip(gds.text_batch(range(gds.n_texts())), wds.text_batch(range(9))):
            np.testing.assert_array_equal(a, b)
        assert (gds.txt2img, gds.img2txt) == (wds.txt2img, wds.img2txt)
        assert [s["idx"] for s in gt] == [0, 1, 2, 3, 4, 0]


def test_load_frames_equals_jax(corpus):
    for v, n in (("v1", 2), (["v5/000.png", "v5/003.png"], 4), ("v4", 3)):
        for training in (True, False):
            a, b = random.Random(2), random.Random(2)
            got = video.load_frames(v, T.test_transform(RES), n, training, a,
                                    str(corpus / "frames"))
            want = jax_video.load_frames(v, JT.test_transform(RES), n, training, b,
                                         str(corpus / "frames"))
            assert got.dtype == np.float32 and got.shape == (n, RES, RES, 3)
            np.testing.assert_array_equal(got, want)


# ---- evaluation ----

@pytest.mark.parametrize("task,ann", [("cls", "qa.json"), ("mc", "mc.json")])
def test_evaluate_classification_equals_jax(corpus, task, ann):
    jm, variables, pm = pair(task)
    name = "video_qa" if task == "cls" else "next_qa_mc"
    cfg = _cfg(corpus, test_file=str(corpus / ann), num_options=4 if task == "mc" else 5)
    _, gds = factory.create_dataset(name, cfg, evaluate=True)
    _, wds = jax_factory.create_dataset(name, cfg, evaluate=True)
    if task == "cls":   # the model's 5 labels: the first 5 answers
        gds.answer_to_id = wds.answer_to_id = {a: i for i, a in enumerate(ANSWERS[:5])}
    got = evaluate_classification(pm, gds, device="cpu", batch_size=3)
    want = jax_evaluate_classification(jm, variables, wds, batch_size=3)
    assert got == want and got["n"] == len(gds)


def test_evaluate_retrieval_on_videos_equals_jax(corpus):
    jcfg, pcfg = configs("frame_pos")
    rng = np.random.default_rng(4)
    jm = JaxRetrieval(jcfg, dtype=jnp.float32)
    ids = np.ones((2, 10), np.int32)
    example = {"image": jnp.zeros((2, F, RES, RES, 3)), "text_ids": jnp.asarray(ids),
               "text_atts": jnp.asarray(ids), "idx": jnp.zeros((2,), jnp.int32)}
    variables = _noisy(jm.init({"params": jax.random.PRNGKey(0),
                                "dropout": jax.random.PRNGKey(1)}, example,
                               rng=jax.random.PRNGKey(0)), rng)
    state, unused = convert_jax_params(_flatten(variables), device="cpu")
    pm = XVLMForRetrieval(pcfg, dtype=torch.float32, device="cpu", seed=None)
    assert unused == [] and set(state) == set(pm.state_dict())
    pm.load_state_dict(state)
    cfg = _cfg(corpus, test_file=str(corpus / "ret.json"))
    _, gds = factory.create_dataset("video_retrieval", cfg, evaluate=True)
    _, wds = jax_factory.create_dataset("video_retrieval", cfg, evaluate=True)
    kw = dict(k_test=4, batch_images=4, batch_texts=4)
    got = evaluate_retrieval(pm, gds, device="cpu", **kw)
    want = jax_evaluate_retrieval(jm, variables, wds, **kw)
    got.pop("eval_seconds"), want.pop("eval_seconds")
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-9), k


# ---- the launcher ----

TINY = dict(
    image_res=RES,
    vision_config_inline={"vision_width": 32, "patch_size": 16, "num_hidden_layers": 2,
                          "num_attention_heads": 2},
    text_num_hidden_layers=4, text_fusion_start_at=2,
    text_config_inline={"vocab_size": len(VOCAB), "hidden_size": 32, "num_heads": 2,
                        "intermediate_size": 64, "max_position_embeddings": 64},
    embed_dim=16, max_tokens=10)


def _shipped(corpus, rel, **extra):
    cfg = load_config(rel).to_dict()
    del cfg["vision_config"]
    cfg.update(TINY, text_encoder=str(corpus / "bert"))
    cfg.update(extra)
    return cfg


def _main(corpus, task, name, cfg, *extra):
    path = corpus / f"cfg_{name}.json"
    path.write_text(json.dumps(cfg))
    return run.main(["--task", task, "--config", str(path), "--output_dir",
                     str(corpus / f"out_{name}"), "--seed", "0", "--device", "cpu", *extra])


def _state(corpus, name):
    return torch.load(corpus / f"out_{name}" / "ckpt" / ckpt_lib.TRAIN_STATE_FILE,
                      weights_only=False)


def _assert_states_equal(a, b):
    assert a["step"] == b["step"] and a["count"] == b["count"]
    for part in ("params", "mu", "nu"):
        assert a[part].keys() == b[part].keys()
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (part, k)


def _qa_cfg(corpus):
    return _shipped(corpus, "configs/finetune/vqa_msrvtt_base.yaml",
                    video_root=str(corpus / "frames"), train_file=[str(corpus / "qa.json")],
                    test_file=[str(corpus / "qa.json")],
                    answer_list=str(corpus / "answers.json"),
                    schedular={"sched": "linear", "lr": 2e-5, "epochs": 2,
                               "num_warmup_steps": 0.1})


@pytest.fixture(scope="module")
def qa_run(corpus):
    """The shipped MSRVTT QA config at its own batch (8 videos x 5 frames)
    with a tiny model: 16 questions, 2 epochs (4 steps), the batches each
    step read, and a copy of the state saved after epoch 0."""
    cfg = _qa_cfg(corpus)
    batches = []
    to_device = run.to_device
    save = ckpt_lib.save_train_state

    def spy(batch, device):
        batches.append({k: np.array(v) for k, v in batch.items()})
        return to_device(batch, device)

    def save_epoch0(ckpt_dir, model, optimizer, step, data_state=None):
        path = save(ckpt_dir, model, optimizer, step, data_state)
        if step == 2 and ckpt_dir.endswith("out_qa/ckpt"):
            save(str(corpus / "out_qa_resumed" / "ckpt"), model, optimizer, step, data_state)
        return path

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(run, "to_device", spy)
        mp.setattr(ckpt_lib, "save_train_state", save_epoch0)
        rec = _main(corpus, "video_qa", "qa", cfg)
    return {"cfg": cfg, "rec": rec, "batches": batches, "state": _state(corpus, "qa")}


def test_video_qa_launcher_train_evaluate_resume(corpus, qa_run, monkeypatch):
    """The run's loss and eval accuracy; ``--evaluate`` from the saved state
    gives the same metrics; a ``--resume`` from the state saved after epoch
    0 reads the whole run's batches and ends in its state bit for bit. The
    head's width is the answer list's."""
    cfg, rec, whole = qa_run["cfg"], qa_run["rec"], qa_run["state"]
    assert (cfg["batch_size"], cfg["batch_size_test"], cfg["frame_len"]) == (8, 16, 5)
    assert np.isfinite(rec["loss_cls"]) and rec["eval_n"] == 16
    assert 0 <= rec["eval_accuracy"] <= 100
    assert whole["step"] == whole["count"] == 4
    assert whole["params"]["cls_head.3.weight"].shape == (len(ANSWERS), 64)
    assert whole["params"]["absolute_frame_pos_embed"].shape == (1, 5, 1, 32)
    assert [b["image"].shape for b in qa_run["batches"]] == [(8, 5, RES, RES, 3)] * 4

    metrics = _main(corpus, "video_qa", "qa", cfg, "--evaluate", "--checkpoint",
                    str(corpus / "out_qa" / "ckpt"))
    assert metrics == {k[len("eval_"):]: v for k, v in rec.items() if k.startswith("eval_")}

    resumed = []
    to_device = run.to_device
    monkeypatch.setattr(run, "to_device", lambda b, d: resumed.append(
        {k: np.array(v) for k, v in b.items()}) or to_device(b, d))
    _main(corpus, "video_qa", "qa_resumed", cfg, "--resume")
    assert len(resumed) == 2
    for got, want in zip(resumed, qa_run["batches"][2:]):
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    _assert_states_equal(_state(corpus, "qa_resumed"), whole)


def test_classification_task_runs_its_video_dataset_type_and_refuses_iglue(corpus, qa_run):
    """``--task classification`` runs the config's video ``dataset_type``
    (an eval of the QA run's state); an IGLUE one (XVNLI) is no longer
    refused: with no test lines it builds its 3-label model and evaluates
    nothing; an unknown one raises."""
    cfg = dict(qa_run["cfg"], train_file=[])
    th = corpus / "out_qa" / "ckpt"
    metrics = _main(corpus, "classification", "cls_eval", cfg, "--evaluate",
                    "--checkpoint", str(th))
    assert metrics["n"] == 16
    xvnli = _main(corpus, "classification", "cls_xvnli",
                  dict(cfg, dataset_type="xvnli", test_file=[], image_root=""), "--evaluate")
    assert xvnli == {"accuracy": 0.0, "n": 0}
    with pytest.raises(ValueError, match="dataset_type"):
        _main(corpus, "classification", "cls_other", dict(cfg, dataset_type="gqa"))


def test_a_th_of_another_frame_count_imports(corpus, qa_run):
    """A ``.th`` with 3 frame positions into the 5-frame QA model: the
    first three loaded, nothing missing but the fresh head."""
    state = qa_run["state"]["params"]
    sd = {k: v for k, v in state.items() if not k.startswith("cls_head.")}
    sd["absolute_frame_pos_embed"] = torch.randn(1, 3, 1, 32)
    th = corpus / "three_frames.th"
    torch.save({"model": sd}, th)
    cfg = _shipped(corpus, "configs/finetune/vqa_msrvtt_base.yaml")
    cfg["num_labels"] = len(ANSWERS)
    model, _ = run.build_model(cfg, "classification", device="cpu")
    args = run.parse_args(["--task", "video_qa", "--config", "x", "--output_dir", "y",
                           "--checkpoint", str(th), "--device", "cpu"])
    missing = run.load_initial_params(args, cfg, model)
    assert missing == sorted(f"cls_head.{i}.{w}" for i in (0, 1, 3) for w in ("weight", "bias"))
    assert torch.equal(model.absolute_frame_pos_embed.detach()[:, :3],
                       sd["absolute_frame_pos_embed"])


@pytest.mark.parametrize("task", ["next_qa_mc", "video_retrieval", "next_qa_mc-resampler"])
def test_next_qa_and_video_retrieval_launchers(corpus, task):
    """Written configs (3 frames, batch 2): 2 steps and the eval; the
    metrics finite; the retrieval one tracks ``img_r_mean``
    (``pick_best_t2v``); NExT-QA again through the Perceiver resampler
    (``video_encoding: resampler``, the JAX factory's depth 2 and 64
    latents), its 2 x 64 resampler attention calls a forward on the plain
    core."""
    from x2vlm_tpu_torch.ops.attention import dot_product_attention

    task, _, encoding = task.partition("-")
    name = f"{task}_{encoding}" if encoding else task
    ann = "mc.json" if task == "next_qa_mc" else "ret.json"
    cfg = _shipped(corpus, "configs/finetune/vqa_msrvtt_base.yaml",
                   video_root=str(corpus / "frames"), train_file=[str(corpus / ann)],
                   test_file=str(corpus / ann), frame_len=F, batch_size=2,
                   batch_size_test=4, k_test=4, pick_best_t2v=True,
                   schedular={"sched": "linear", "lr": 1e-4, "epochs": 1})
    del cfg["answer_list"], cfg["dataset_type"]
    if encoding:
        cfg["video_encoding"] = encoding
    plain = dot_product_attention.calls_by_shape.copy()
    rec = _main(corpus, task, name, cfg)
    plain = dot_product_attention.calls_by_shape - plain
    key = "eval_accuracy" if task == "next_qa_mc" else "eval_img_r_mean"
    losses = [v for k, v in rec.items() if k.startswith("loss")]
    assert np.isfinite(rec[key]) and losses and np.isfinite(losses).all()
    state = _state(corpus, name)
    assert state["params"]["absolute_frame_pos_embed"].shape == (1, F, 1, 32)
    if task == "next_qa_mc":
        assert state["params"]["mc_head.3.weight"].shape == (1, 64)
    resampled = {k: n for k, n in plain.items() if k[1:] == (64, 64 + (RES // 16) ** 2 + 1)}
    if encoding:
        assert state["params"]["resampler.latents"].shape == (64, 32)
        assert state["params"]["resampler.attn_1.to_q.weight"].shape == (512, 32)
        # per video-frame row: 2 layers a forward; the steps' and the eval's rows
        assert resampled and all(n % 2 == 0 for n in resampled.values())
    else:
        assert not resampled and not any(k.startswith("resampler.") for k in state["params"])


def test_stage2_video_pretraining_resumes_the_video_cursor_exactly(corpus):
    """The shipped stage-2 config with the image, region and video streams
    (cut: 4 images, 8 region rows over 4 images, 4 videos of 3 frames):
    2 steps in one run equal 1 step, ``--resume``, 1 more, bit for bit,
    the video cursor among the saved ones; the video losses finite."""
    base = _shipped(corpus, "configs/pretrain/x2vlm_base_1b_stage2_video.yaml")
    assert (base["videos"]["batch_size"], base["frame_len"]) == (40, 3)
    cfg = dict(base, train_file=[str(corpus / "img.jsonl")],
               train_file_regions=[str(corpus / "regions.jsonl")],
               train_file_videos=[str(corpus / "videos.jsonl")],
               images=dict(base["images"], batch_size=4, num_workers=2),
               regions=dict(base["regions"], batch_size=8, max_images=4, num_workers=2),
               videos=dict(base["videos"], batch_size=4, num_workers=2),
               train_dataset_size=4, max_words=10, max_masks=3)
    rec = _main(corpus, "pretrain", "s2_whole", cfg, "--epoch", "2")
    assert rec["pretrain_steps"] == [0, 2] and rec["broken"] > 0
    for k in ("video_loss_itc", "video_loss_itm", "video_loss_mlm", "region_loss_bbox"):
        assert np.isfinite(rec[k]) and rec[k] > 0, k
    _main(corpus, "pretrain", "s2_split", cfg, "--epoch", "1")
    assert _state(corpus, "s2_split")["data_state"]["video"]["line_idx"] > 0
    _main(corpus, "pretrain", "s2_split", cfg, "--epoch", "2", "--resume")
    whole, split = _state(corpus, "s2_whole"), _state(corpus, "s2_split")
    assert set(whole["data_state"]) == {"image", "region", "video"}
    assert whole["data_state"] == split["data_state"]
    assert whole["params"]["base.absolute_frame_pos_embed"].shape == (1, 3, 1, 32)
    _assert_states_equal(whole, split)


def test_pretrain_loop_video_streams_draw_as_jax(monkeypatch):
    """The loop's stream draws against the JAX ``pretrain_loop`` with the
    grad functions stubbed: over 12 steps with an aux and a video-aux
    stream (``aux_iter_perc`` 0.5, ``video_aux_iter_perc`` 0.5), each call's
    loss weight, matching-loss flag and batch are the JAX loop's: the video
    batch takes the image batch's flag (no matching loss beside a noisy
    image batch) and the video-aux draw follows the image draw on one rng."""
    from x2vlm_tpu.tasks import pretrain as jax_loop_mod
    from x2vlm_tpu_torch.tasks import pretrain as loop_mod

    def streams(mod):
        def it(name):
            return iter({"tag": f"{name}{i}"} for i in range(100))
        return mod.PretrainStreams(image=it("image"), aux=it("aux"), video=it("video"),
                                   video_aux=it("video_aux"), image_weight=1.0,
                                   video_weight=0.5, aux_perc=0.5, video_aux_perc=0.5,
                                   rng=random.Random(3))

    calls = {"jax": [], "port": []}

    def stub(name):
        def make_grad_fn(model, loss_scale=1.0, loss_weights=None, apply_kwargs=None):
            itm = (apply_kwargs or {}).get("ret_match_loss")

            def grad(*a):
                batch = a[1] if name == "jax" else a[0]
                calls[name].append((loss_scale, itm, batch["tag"]))
                return ({}, {}) if name == "jax" else {}
            return grad
        return make_grad_fn

    monkeypatch.setattr(jax_loop_mod, "make_grad_fn", stub("jax"))
    monkeypatch.setattr(jax_loop_mod, "make_apply_grads", lambda tx: lambda state, g: state)
    monkeypatch.setattr(loop_mod, "make_grad_fn", stub("port"))
    monkeypatch.setattr(loop_mod, "make_apply_grads", lambda opt: lambda: 0.0)
    state = type("State", (), {"params": None})()
    jax_loop_mod.pretrain_loop(None, state, None, streams(jax_loop_mod), num_steps=12,
                               rng_key=jax.random.PRNGKey(0), log_every=100)
    loop_mod.pretrain_loop(torch.nn.Linear(1, 1), type("Opt", (), {"params": []})(),
                           streams(loop_mod), num_steps=12, seed=0, to_device=lambda b: b,
                           log_every=100)
    assert calls["port"] == calls["jax"] and len(calls["port"]) == 24
    flags = [(itm, tag) for _, itm, tag in calls["port"]]
    assert any(t.startswith("video_aux") for _, t in flags) and \
        any(t.startswith("video") and not t.startswith("video_aux") for _, t in flags)
    assert {itm for itm, t in flags if t.startswith("image")} == {False}
