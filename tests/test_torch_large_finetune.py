"""The two large fine-tunes against the JAX package on the CPU:
``configs/finetune/refcoco_grounding_large.yaml`` (text and cross drop
path 0.1, ``careful_hflip``, ``lr_mult``) and
``configs/finetune/coco_captioning_large.yaml`` (FG-free captions at 40 +
18 = 58 tokens, label smoothing, a beam-3 decode of 5 to 50 frames,
``vision_lr`` / ``text_lr``).

- Both YAMLs through the port's launcher with a tiny inline model (32 px,
  batch 4, the rest as shipped): one epoch of 2 steps with finite losses,
  and the eval.
- One grounding step with every drop path at 0.1 (the vision tower's,
  the text and cross stacks' linspace schedules) and the keep masks
  injected on both sides (the port's ``ops.layers.drop_path_keep``, the
  JAX ``jax.random.bernoulli``; the attention dropout at 0), against
  ``jax.vjp`` of the JAX model: both losses and every gradient to
  rtol = atol = 1e-4.
- One FG-free captioning step on a 58-token batch of the port's
  ``CaptioningTrainDataset`` against ``jax.value_and_grad``, the same way.
- The optimizer's scale of every parameter under each YAML's
  ``optimizer`` block against the JAX optimizer's labels and the JAX
  launcher's scales (captioning: the vision tower at 2, the rest at 1;
  grounding: its bbox head, fresh, at ``lr_mult`` 2, the rest at 1).
"""

import json
import os
import random

import numpy as np
import pytest
from PIL import Image

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests.test_torch_grounding import (  # noqa: E402
    RES, TEXT, TOL, VISION, VOCAB, assert_grads_equal, to_port,
)
from tests.test_torch_pretrain import _noisy  # noqa: E402
from x2vlm_tpu.models import (  # noqa: E402
    BEiT2Config as JaxBEiT2Config, BertConfig as JaxBertConfig,
    XVLMConfig as JaxXVLMConfig, XVLMForGrounding as JaxXVLMForGrounding,
)
from x2vlm_tpu.models import captioning as jcap  # noqa: E402
from x2vlm_tpu.serving import _flatten  # noqa: E402
from x2vlm_tpu.train import optim as jax_optim  # noqa: E402
from x2vlm_tpu_torch import run  # noqa: E402
from x2vlm_tpu_torch.convert import convert_jax_params  # noqa: E402
from x2vlm_tpu_torch.core.config import load_config  # noqa: E402
from x2vlm_tpu_torch.data.finetune import CaptioningTrainDataset  # noqa: E402
from x2vlm_tpu_torch.data.tokenization import BertWordPiece  # noqa: E402
from x2vlm_tpu_torch.models import (  # noqa: E402
    BEiT2Config, BertConfig, XVLMConfig, XVLMForGrounding, XVLMForMLMCaptioning,
)
from x2vlm_tpu_torch.ops import layers as port_layers  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUNDING_YAML = "configs/finetune/refcoco_grounding_large.yaml"
CAPTION_YAML = "configs/finetune/coco_captioning_large.yaml"
WORDS = VOCAB[5:]
B = 3
DROP = dict(text_drop_path_rate=0.1, cross_drop_path_rate=0.1)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Tiny models: a few CPU threads each (the suite runs on several
    workers at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def _shipped(rel):
    return load_config(os.path.join(ROOT, rel)).to_dict()


# ---- both YAMLs through the launcher ----

TINY = dict(
    image_res=32,
    vision_config_inline={"vision_width": 32, "patch_size": 16, "num_hidden_layers": 2,
                          "num_attention_heads": 2},
    text_num_hidden_layers=4, text_fusion_start_at=2,
    text_config_inline={"vocab_size": len(VOCAB), "hidden_size": 32, "num_heads": 2,
                        "intermediate_size": 64, "max_position_embeddings": 64},
    batch_size=4, batch_size_test=4)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("large_ft")
    (d / "bert").mkdir()
    (d / "bert" / "vocab.txt").write_text("\n".join(VOCAB))
    (d / "imgs").mkdir()
    rng = np.random.default_rng(0)
    for i in range(6):
        Image.fromarray(rng.integers(0, 255, (48, 56, 3), np.uint8)).save(
            d / "imgs" / f"im{i}.png")
    cap = lambda n: " ".join(rng.choice(WORDS, n))
    ground = [{"image": f"im{i % 6}.png", "text": cap(4) + (" on the left" if i % 3 else ""),
               "bbox": [float(rng.integers(0, 20)), float(rng.integers(0, 16)), 24.0, 20.0],
               "ref_id": 100 + i} for i in range(12)]
    (d / "ground.json").write_text(json.dumps(ground[:8]))
    (d / "ground_test.json").write_text(json.dumps(ground[8:]))
    refs = {str(a["ref_id"]): {"split": ("val", "testA", "testB")[k % 3], "bbox": a["bbox"],
                               "width": 56, "height": 48} for k, a in enumerate(ground[8:])}
    (d / "refs.json").write_text(json.dumps(refs))
    train = [{"image": f"im{i % 6}.png", "caption": [cap(8), cap(12)], "image_id": i}
             for i in range(8)]
    test = [{"image": f"im{i % 6}.png", "caption": [cap(6), cap(7)], "image_id": 50 + i}
            for i in range(4)]
    (d / "cap.json").write_text(json.dumps(train))
    (d / "cap_test.json").write_text(json.dumps(test))
    (d / "cap_gt.json").write_text(json.dumps({str(a["image_id"]): a["caption"]
                                               for a in test}))
    return d


@pytest.mark.parametrize("task", ["grounding", "captioning"])
def test_the_large_yaml_runs_through_the_launcher(corpus, task):
    rel = GROUNDING_YAML if task == "grounding" else CAPTION_YAML
    cfg = _shipped(rel)
    del cfg["vision_config"]
    cfg.update(TINY, text_encoder=str(corpus / "bert"), image_root=str(corpus / "imgs"),
               schedular=dict(cfg["schedular"], epochs=1), start_eval=0)
    if task == "grounding":
        assert (cfg["text_drop_path_rate"], cfg["cross_drop_path_rate"],
                cfg["careful_hflip"]) == (0.1, 0.1, True)
        cfg.update(train_file=[str(corpus / "ground.json")],
                   test_file=[str(corpus / "ground_test.json")],
                   refs_file=str(corpus / "refs.json"))
        keys = ("loss_bbox", "loss_giou", "eval_val_acc", "eval_testA_acc", "eval_testB_acc")
    else:
        assert (cfg["fg_free"], cfg["max_tokens"], cfg["max_masks"], cfg["max_length"],
                cfg["num_beams"]) == (True, 40, 18, 50, 3)
        cfg.update(train_file=[str(corpus / "cap.json")],
                   test_file=[str(corpus / "cap_test.json")],
                   caption_gt_file=str(corpus / "cap_gt.json"))
        keys = ("loss_caption", "eval_bleu4", "eval_cider")
    path = corpus / f"cfg_{task}.json"
    path.write_text(json.dumps(cfg))
    steps = []
    make_step = run.make_train_step

    def spy(model, optimizer, **kw):
        step = make_step(model, optimizer, **kw)

        def counted(batch, *a, **k):
            steps.append({k: tuple(v.shape) for k, v in batch.items()})
            return step(batch, *a, **k)

        return counted

    run.make_train_step = spy
    try:
        rec = run.main(["--task", task, "--config", str(path), "--output_dir",
                        str(corpus / f"out_{task}"), "--seed", "0", "--device", "cpu"])
    finally:
        run.make_train_step = make_step
    assert len(steps) == 2
    for k in keys:
        assert np.isfinite(rec[k]), k
    if task == "captioning":
        assert steps[0]["text_ids_masked"] == (4, 58)
        assert rec["eval_n"] == 4


# ---- one step against the JAX model, drop path on with injected masks ----

def _keep_mask(i, shape):
    """The i-th injected keep mask: one row dropped every other call."""
    m = np.ones(shape, bool)
    if i % 2 == 0:
        m[(i // 2) % shape[0]] = False
    return m


@pytest.fixture
def injected(monkeypatch):
    """Both packages' drop paths keep ``_keep_mask``'s rows, in call order."""
    calls = {"port": [], "jax": []}

    def port_keep(shape, keep, generator, device):
        calls["port"].append((tuple(shape), round(keep, 6)))
        return torch.from_numpy(_keep_mask(len(calls["port"]) - 1, tuple(shape)))

    def jax_bernoulli(key, p, shape=None):
        calls["jax"].append((tuple(shape), round(float(p), 6)))
        return jnp.asarray(_keep_mask(len(calls["jax"]) - 1, tuple(shape)))

    monkeypatch.setattr(port_layers, "drop_path_keep", port_keep)
    monkeypatch.setattr(jax.random, "bernoulli", jax_bernoulli)
    return calls


def test_grounding_step_with_drop_path_equals_jax(injected):
    vision = dict(VISION, drop_path_rate=0.1)
    jcfg = JaxXVLMConfig(vision=JaxBEiT2Config(**vision),
                         text=JaxBertConfig(**dict(TEXT, **DROP)), embed_dim=16)
    pcfg = XVLMConfig(vision=BEiT2Config(**vision), text=BertConfig(**dict(TEXT, **DROP)),
                      embed_dim=16)
    assert pcfg.text.hidden_dropout == 0.0     # the text drop path replaces it
    rng = np.random.default_rng(22)
    ids = rng.integers(5, len(VOCAB), (B, 8)).astype(np.int32)
    atts = np.ones((B, 8), np.int32)
    atts[1, 5:] = 0
    ids[:, 0] = 2
    batch = {"image": rng.standard_normal((B, RES, RES, 3)).astype(np.float32),
             "text_ids": ids * atts, "text_atts": atts,
             "target_bbox": (rng.random((B, 4)) * 0.5 + 0.25).astype(np.float32)}
    model = JaxXVLMForGrounding(jcfg, dtype=jnp.float32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = _noisy(model.init({"params": jax.random.PRNGKey(0),
                                   "dropout": jax.random.PRNGKey(1)}, jb), rng)
    injected["jax"].clear()

    def losses(params):
        out = model.apply({"params": params}, jb, deterministic=False,
                          rngs={"dropout": jax.random.PRNGKey(2)})
        return jnp.stack([out["loss_bbox"], out["loss_giou"]])

    want, vjp = jax.vjp(losses, variables["params"])
    (want_grads,) = vjp(jnp.ones(2, jnp.float32))
    port = to_port(variables, XVLMForGrounding(pcfg, dtype=torch.float32, device="cpu",
                                               seed=None))
    port.train()
    got = port({k: torch.from_numpy(v) for k, v in batch.items()})
    (got["loss_bbox"] + got["loss_giou"]).backward()
    # every drop path drew, in the same order at the same rates on both sides
    assert injected["port"] == injected["jax"] and len(injected["port"]) >= 4
    assert {k for _, k in injected["port"]} >= {0.9}
    np.testing.assert_allclose([got["loss_bbox"].item(), got["loss_giou"].item()],
                               np.asarray(want), **TOL)
    assert_grads_equal(port, want_grads)


def test_fg_free_caption_step_at_58_tokens_equals_jax(tmp_path):
    tok = BertWordPiece(str(_vocab(tmp_path)))
    ds = CaptioningTrainDataset([], None, "", tok, prompt="a", max_tokens=40, max_masks=18,
                                mask_prob=0.6, fg_free=True, rng=random.Random(5))
    rng = np.random.default_rng(23)
    rows = [ds.preprocess(" ".join(rng.choice(WORDS, n))) for n in (36, 20, 9)]
    batch = {k: np.stack([r[k] for r in rows]) for k in rows[0]}
    assert batch["text_ids_masked"].shape == (B, 58) and batch["masked_weight"].sum() > 18
    batch["image"] = rng.standard_normal((B, RES, RES, 3)).astype(np.float32)
    jcfg = JaxXVLMConfig(vision=JaxBEiT2Config(**VISION), text=JaxBertConfig(**TEXT),
                         embed_dim=16)
    model = jcap.XVLMForMLMCaptioning(jcfg, label_smoothing=0.1, cls_token_id=2,
                                      dtype=jnp.float32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = _noisy(model.init({"params": jax.random.PRNGKey(0),
                                   "dropout": jax.random.PRNGKey(1)}, jb), rng)

    def loss(params):
        return model.apply({"params": params}, jb, deterministic=True)["loss_caption"]

    want, want_grads = jax.value_and_grad(loss)(variables["params"])
    port = to_port(variables, XVLMForMLMCaptioning(
        XVLMConfig(vision=BEiT2Config(**VISION), text=BertConfig(**TEXT), embed_dim=16),
        label_smoothing=0.1, cls_token_id=2, dtype=torch.float32, device="cpu", seed=None))
    port.train()
    got = port({k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
                for k, v in batch.items()})
    got["loss_caption"].backward()
    np.testing.assert_allclose(got["loss_caption"].item(), float(want), **TOL)
    assert_grads_equal(port, want_grads)


def _vocab(tmp_path):
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(VOCAB))
    return path


# ---- the learning rates of each YAML's groups ----

CODES = {"vision": 1.0, "text": 2.0, "cross": 3.0, "other": 4.0, "fresh": 5.0}


@pytest.mark.parametrize("rel,fresh,want", [
    (GROUNDING_YAML, "bbox_head",
     {"vision": 1.0, "text": 1.0, "cross": 1.0, "fresh": 2.0}),
    (CAPTION_YAML, "",
     {"vision": 2.0, "text": 1.0, "cross": 1.0, "other": 1.0}),
], ids=["grounding", "captioning"])
def test_learning_rate_groups_equal_jax(rel, fresh, want):
    """Each parameter's label equals the JAX ``param_labels``' (converted to
    the port's names), and its scale in the port's optimizer is the JAX
    launcher's scale of that label under the YAML's ``optimizer`` block."""
    cfg = _shipped(rel)
    o = cfg["optimizer"]
    base = float(o["lr"])
    jax_scale = {"vision": float(o.get("vision_lr", base)) / base,
                 "text": float(o.get("text_lr", base)) / base,
                 "cross": float(o.get("cross_lr", base)) / base, "other": 1.0,
                 "fresh": float(o.get("lr_mult", 1.0))}
    task = "grounding" if rel == GROUNDING_YAML else "captioning"
    jcfg = JaxXVLMConfig(vision=JaxBEiT2Config(**VISION), text=JaxBertConfig(**TEXT),
                         embed_dim=16)
    rng = np.random.default_rng(4)
    image = jnp.asarray(rng.standard_normal((2, RES, RES, 3)).astype(np.float32))
    ids = jnp.ones((2, 8), jnp.int32)
    if task == "grounding":
        jmodel = JaxXVLMForGrounding(jcfg, dtype=jnp.float32)
        inputs = {"image": image, "text_ids": ids, "text_atts": ids,
                  "target_bbox": jnp.full((2, 4), 0.5)}
        port = XVLMForGrounding(_port_cfg(), dtype=torch.float32, device="cpu", seed=0)
    else:
        jmodel = jcap.XVLMForMLMCaptioning(jcfg, cls_token_id=2, dtype=jnp.float32)
        inputs = {"image": image, "text_ids_masked": ids,
                  "text_atts_matrix": jnp.ones((2, 8, 8), jnp.int32),
                  "position_ids": jnp.tile(jnp.arange(8), (2, 1)),
                  "masked_pos": jnp.zeros((2, 2), jnp.int32),
                  "masked_ids": jnp.ones((2, 2), jnp.int32),
                  "masked_weight": jnp.ones((2, 2))}
        port = XVLMForMLMCaptioning(_port_cfg(), dtype=torch.float32, device="cpu", seed=0)
    params = jmodel.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                         inputs)["params"]
    labels = jax_optim.param_labels(params, fusion_layer=TEXT["fusion_layer"],
                                    fresh_prefixes=(fresh,) if fresh else ())
    coded = jax.tree_util.tree_map(lambda lab, leaf: np.full(leaf.shape, CODES[lab], np.float32),
                                   labels, params)
    by_name, _ = convert_jax_params(_flatten({"params": coded}), device="cpu")
    decode = {v: k for k, v in CODES.items()}
    jax_labels = {n: decode[float(t.reshape(-1)[0])] for n, t in by_name.items()}
    fresh_names = [n for n, _ in port.named_parameters() if fresh and n.startswith(fresh + ".")]
    opt = run.make_optimizer(cfg, port, 10, TEXT["fusion_layer"], fresh_names=fresh_names)
    scale = {opt.names[i]: s for (_, s), idx in opt.groups for i in idx}
    assert set(scale) == set(jax_labels)
    for name, s in scale.items():
        assert s == jax_scale[jax_labels[name]], (name, jax_labels[name], s)
    assert {jax_labels[n]: s for n, s in scale.items()} == want


def _port_cfg():
    return XVLMConfig(vision=BEiT2Config(**VISION), text=BertConfig(**TEXT), embed_dim=16)
