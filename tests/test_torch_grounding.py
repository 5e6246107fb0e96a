"""The grounding task against the JAX package in fp32 on the CPU:
``XVLMForGrounding`` (its parameter names equal the converted JAX tree;
``predict`` boxes; the L1 and GIoU losses and every parameter's gradient
against ``jax.vjp``; the fusion pass without dropout in training mode; one
train step against the JAX ``make_train_step``), ``predict_grounding``,
the two bbox evaluations and ``GroundingServer.from_npz`` on a
``params.npz`` the JAX ``save_params_npz`` wrote.

Config: a 32 px image (4 patches and CLS, padded to 8 keys in the fusion),
vision width 32, 2 blocks; a 4-layer text stack of width 32 with 2
fusion layers (the config of test_finetune_tasks.py); every dropout at 0
unless a test turns it on. Tolerances: boxes to 1e-5; losses, gradients
and a step's parameters to rtol = atol = 1e-4, as test_torch_region.py."""

import json

import numpy as np
import pytest
from tests.torch_threads import few_torch_threads  # noqa: E402,F401 (autouse)
from PIL import Image

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests.test_torch_pretrain import _noisy  # noqa: E402
from x2vlm_tpu.data import (  # noqa: E402
    GroundingEvalDataset as JaxGroundingEvalDataset, TextPreprocessor as JaxTextPreprocessor,
)
from x2vlm_tpu.data import transforms as JT  # noqa: E402
from x2vlm_tpu.evalkit import grounding as jax_eval  # noqa: E402
from x2vlm_tpu.models import (  # noqa: E402
    BEiT2Config as JaxBEiT2Config, BertConfig as JaxBertConfig,
    XVLMConfig as JaxXVLMConfig, XVLMForGrounding as JaxXVLMForGrounding,
)
from x2vlm_tpu.serving import _flatten, save_params_npz  # noqa: E402
from x2vlm_tpu.tasks import predict_grounding as jax_predict_grounding  # noqa: E402
from x2vlm_tpu.train import optim as jax_optim  # noqa: E402
from x2vlm_tpu.train.trainer import (  # noqa: E402
    create_train_state, make_train_step as jax_make_train_step,
)
from x2vlm_tpu_torch.convert import convert_jax_params  # noqa: E402
from x2vlm_tpu_torch.data import transforms as T  # noqa: E402
from x2vlm_tpu_torch.data.finetune import GroundingEvalDataset  # noqa: E402
from x2vlm_tpu_torch.data.tokenization import BertWordPiece, TextPreprocessor  # noqa: E402
from x2vlm_tpu_torch.evalkit import grounding as port_eval  # noqa: E402
from x2vlm_tpu_torch.models import (  # noqa: E402
    BEiT2Config, BertConfig, XVLMConfig, XVLMForGrounding,
)
from x2vlm_tpu_torch.serving import GroundingServer  # noqa: E402
from x2vlm_tpu_torch.tasks.grounding import predict_grounding  # noqa: E402
from x2vlm_tpu_torch.train import (  # noqa: E402
    create_optimizer, lr_schedule, make_train_step, param_labels,
)

TOL = dict(rtol=1e-4, atol=1e-4)
BOXES = dict(rtol=1e-5, atol=1e-5)
RES = 32
VOCAB = ("[PAD] [UNK] [CLS] [SEP] [MASK] a b c d e dog cat runs the quick brown fox "
         "jump ##s ##ing over lazy river bank small big red blue green house tree left "
         "right man on").split()
VISION = dict(image_res=RES, patch_size=16, embed_dim=32, depth=2, num_heads=2,
              drop_path_rate=0.0, dropout_rate=0.0)
TEXT = dict(vocab_size=len(VOCAB), hidden_size=32, num_layers=4, fusion_layer=2,
            num_heads=2, intermediate_size=64, encoder_width=32, hidden_dropout=0.0,
            attn_dropout=0.0, max_position_embeddings=64)
B, L = 4, 8
# the step's optimizer: group scales as the shipped configs' lr_mult; eps
# 1e-6 so that Adam's first update, ~sign(g), does not blow a gradient's
# fp32 rounding near eps up to the learning rate
GROUPS = dict(lr_mult=2.0, vision_lr_scale=0.5, text_lr_scale=1.0, cross_lr_scale=1.5,
              eps=1e-6)


def jax_config(**text):
    return JaxXVLMConfig(vision=JaxBEiT2Config(**VISION),
                         text=JaxBertConfig(**dict(TEXT, **text)), embed_dim=16)


def port_config(**text):
    return XVLMConfig(vision=BEiT2Config(**VISION), text=BertConfig(**dict(TEXT, **text)),
                      embed_dim=16)


def text_batch(rng, n=B):
    ids = rng.integers(5, len(VOCAB), (n, L)).astype(np.int32)
    atts = np.ones((n, L), np.int32)
    atts[1, 5:] = 0
    atts[n - 1, 3:] = 0
    ids[:, 0] = 2
    return ids * atts, atts


def to_port(variables, model):
    """The JAX variables converted into the port model ``model`` (strict:
    its state dict keys must be the converted tree's)."""
    state, unused = convert_jax_params(_flatten(variables), device="cpu")
    assert unused == []
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)
    return model


def port_grads(model):
    return {n: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
            for n, p in model.named_parameters()}


def assert_grads_equal(model, jax_grads):
    want, _ = convert_jax_params(_flatten({"params": jax_grads}), device="cpu")
    got = port_grads(model)
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g, want[name].numpy(), err_msg=name, **TOL)


def assert_params_equal(model, jax_params):
    want, _ = convert_jax_params(_flatten({"params": jax_params}), device="cpu")
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), err_msg=name,
                                   **TOL)


def one_step_each(jax_model, variables, port, batch, fresh_prefix):
    """One AdamW step of each package's ``make_train_step`` from the same
    parameters on ``batch`` (no warmup, clipping, decay, ``GROUPS`` with
    ``fresh_prefix`` in the lr_mult group). Returns the JAX parameters."""
    fusion = TEXT["fusion_layer"]
    tx = jax_optim.create_optimizer(
        variables["params"], jax_optim.lr_schedule(1e-2, 10),
        labels=jax_optim.param_labels(variables["params"], fusion,
                                      fresh_prefixes=(fresh_prefix,)), **GROUPS)
    state = create_train_state(variables, tx)
    state, _ = jax_make_train_step(jax_model, tx, donate=False)(
        state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    opt = create_optimizer(port, lr_schedule(1e-2, 10),
                           labels=param_labels(port.named_parameters(), fusion,
                                               fresh_prefixes=(fresh_prefix,)), **GROUPS)
    metrics = make_train_step(port, opt)({k: torch.from_numpy(v) for k, v in batch.items()})
    assert all(np.isfinite(v.item()) for v in metrics.values())
    return state.params


def write_images(root, rng, n, size=(56, 40)):
    root.mkdir(exist_ok=True)
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (size[1], size[0], 3), np.uint8)).save(
            root / f"im{i}.png")


def tokenizers(tmp_path):
    """The JAX package's BertTokenizerFast and the port's WordPiece over one
    vocab file."""
    from transformers import BertTokenizerFast

    (tmp_path / "vocab.txt").write_text("\n".join(VOCAB))
    return (BertTokenizerFast(vocab_file=str(tmp_path / "vocab.txt"), do_lower_case=True),
            BertWordPiece(str(tmp_path / "vocab.txt")))


# ---- the model ----

@pytest.fixture(scope="module")
def grounding():
    rng = np.random.default_rng(0)
    model = JaxXVLMForGrounding(jax_config(), dtype=jnp.float32)
    ids, atts = text_batch(rng)
    batch = {"image": rng.standard_normal((B, RES, RES, 3)).astype(np.float32),
             "text_ids": ids, "text_atts": atts,
             "target_bbox": (rng.random((B, 4)) * 0.5 + 0.25).astype(np.float32)}
    init = model.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                      {k: jnp.asarray(v) for k, v in batch.items()})
    variables = _noisy(init, rng)
    port = to_port(variables, XVLMForGrounding(port_config(), dtype=torch.float32,
                                               device="cpu", seed=None))
    return dict(model=model, variables=variables, batch=batch, port=port)


def test_parameter_names_are_the_converted_jax_tree(grounding):
    """base/{vision_encoder, text_encoder, bbox_head}: no projections, no
    temperature, no ITM or MLM head (fixture: the converted tree loads
    strictly and names every parameter)."""
    tops = {k.split(".")[0] for k in grounding["port"].state_dict()}
    assert tops == {"vision_encoder", "text_encoder", "bbox_head"}
    assert set(grounding["variables"]["params"]) == {"base"}


def test_predict_boxes_equal_jax(grounding):
    b = grounding["batch"]
    args = [b[k] for k in ("image", "text_ids", "text_atts")]
    want = grounding["model"].apply(grounding["variables"], *(jnp.asarray(x) for x in args),
                                    method=JaxXVLMForGrounding.predict)
    with torch.no_grad():
        got = grounding["port"].predict(*(torch.from_numpy(x) for x in args))
    assert got.dtype == torch.float32 and got.shape == (B, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BOXES)


def test_losses_and_gradients_equal_jax(grounding):
    model, variables, batch = grounding["model"], grounding["variables"], grounding["batch"]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def losses(params):
        out = model.apply({"params": params}, jb, deterministic=True)
        return jnp.stack([out["loss_bbox"], out["loss_giou"]])

    want, vjp = jax.vjp(losses, variables["params"])
    (want_grads,) = vjp(jnp.ones(2, jnp.float32))
    port = grounding["port"]
    port.zero_grad(set_to_none=True)
    port.train()
    try:
        got = port({k: torch.from_numpy(v) for k, v in batch.items()})
        (got["loss_bbox"] + got["loss_giou"]).backward()
    finally:
        port.eval()
    assert tuple(got) == ("loss_bbox", "loss_giou")
    np.testing.assert_allclose([got["loss_bbox"].item(), got["loss_giou"].item()],
                               np.asarray(want), **TOL)
    assert_grads_equal(port, want_grads)
    assert port.bbox_head[3].weight.grad.abs().sum() > 0
    port.zero_grad(set_to_none=True)


def test_the_fusion_pass_has_no_dropout_in_training():
    """With every dropout on, in training mode: the bbox pass over given
    embeddings equals eval mode's whatever the generator, while the
    towers before it do drop out (the JAX ``predict_bbox``)."""
    rng = np.random.default_rng(1)
    port = XVLMForGrounding(port_config(hidden_dropout=0.3, attn_dropout=0.3),
                            dtype=torch.float32, device="cpu", seed=3)
    ids, atts = (torch.from_numpy(x) for x in text_batch(rng))
    image = torch.from_numpy(rng.standard_normal((B, RES, RES, 3)).astype(np.float32))
    image_embeds = torch.from_numpy(rng.standard_normal((B, 5, 32)).astype(np.float32))
    text_embeds = torch.from_numpy(rng.standard_normal((B, L, 32)).astype(np.float32))
    with torch.no_grad():
        eval_boxes = port.predict_bbox(image_embeds, text_embeds, atts)
        eval_predict = port.predict(image, ids, atts)
        port.train()
        gens = [torch.Generator().manual_seed(s) for s in (0, 1)]
        train_boxes = [port.predict_bbox(image_embeds, text_embeds, atts) for _ in gens]
        train_predict = [port.predict(image, ids, atts, g) for g in gens]
    port.eval()
    for boxes in train_boxes:
        torch.testing.assert_close(boxes, eval_boxes, rtol=0, atol=0)
    assert not torch.equal(train_predict[0], train_predict[1])
    assert not torch.equal(train_predict[0], eval_predict)


def test_one_train_step_equals_jax(grounding):
    """Every parameter after one step of each package's train step, the
    fresh ``bbox_head`` group at lr_mult."""
    port = to_port(grounding["variables"], XVLMForGrounding(
        port_config(), dtype=torch.float32, device="cpu", seed=None))
    want = one_step_each(grounding["model"], grounding["variables"], port,
                         grounding["batch"], "bbox_head")
    assert_params_equal(port, want)
    moved = port.bbox_head[0].weight.detach().numpy() - np.asarray(
        grounding["variables"]["params"]["base"]["bbox_head"]["fc1"]["kernel"]).T
    assert np.abs(moved).max() > 1e-3


# ---- evaluation ----

@pytest.fixture(scope="module")
def eval_sets(tmp_path_factory, grounding):
    d = tmp_path_factory.mktemp("grounding_eval")
    rng = np.random.default_rng(2)
    write_images(d / "imgs", rng, 3)
    ann = [{"image": f"im{i % 3}.png", "text": t, "ref_id": 10 + i, "bbox": [3, 4, 20, 15]}
           for i, t in enumerate(["the dog on the left", "a big red house", "man on the river",
                                  "small blue tree right", "the quick brown fox"])]
    (d / "test.json").write_text(json.dumps(ann))
    jax_tok, tok = tokenizers(d)
    jax_ds = JaxGroundingEvalDataset(str(d / "test.json"), JT.test_transform(RES),
                                     str(d / "imgs"), JaxTextPreprocessor(jax_tok, max_tokens=L))
    ds = GroundingEvalDataset(str(d / "test.json"), T.test_transform(RES), str(d / "imgs"),
                              TextPreprocessor(tok, max_tokens=L))
    return dict(dir=d, ann=ann, jax=jax_ds, port=ds)


def test_predict_grounding_equals_jax(grounding, eval_sets):
    """5 samples at batch 3: the last batch padded with copies of its last
    sample in both packages, the copies dropped."""
    want = jax_predict_grounding(grounding["model"], grounding["variables"], eval_sets["jax"],
                                 batch_size=3)
    got = predict_grounding(grounding["port"], eval_sets["port"], device="cpu", batch_size=3)
    assert [r["ref_id"] for r in got] == [r["ref_id"] for r in want] == list(range(10, 15))
    np.testing.assert_allclose([r["pred"] for r in got], [r["pred"] for r in want], **BOXES)


def _results_and_refs(rng, n=40):
    results, refs, vlue = [], {}, []
    splits = ("val", "testA", "testB")
    for i in range(n):
        w, h = int(rng.integers(50, 400)), int(rng.integers(50, 400))
        box = [float(rng.uniform(0, w / 2)), float(rng.uniform(0, h / 2)),
               float(rng.uniform(5, w / 2)), float(rng.uniform(5, h / 2))]
        cx, cy = (box[0] + box[2] / 2) / w, (box[1] + box[3] / 2) / h
        jitter = rng.normal(0, 0.15 if i % 2 else 0.02, 4)
        pred = [cx + jitter[0], cy + jitter[1], box[2] / w * (1 + jitter[2]),
                box[3] / h * (1 + jitter[3])]
        results.append({"ref_id": i, "pred": pred})
        refs[i] = {"split": splits[i % 3], "bbox": box, "width": w, "height": h}
        vlue.append({"ref_id": i, "bbox": box, "width": w, "height": h})
    results.append({"ref_id": 999, "pred": [0.5, 0.5, 0.1, 0.1]})   # no ref: skipped
    return results, refs, vlue


def test_grounding_eval_bbox_equals_jax():
    results, refs, _ = _results_and_refs(np.random.default_rng(3))
    want = jax_eval.grounding_eval_bbox(results, refs)
    got = port_eval.grounding_eval_bbox(results, refs)
    assert got == want and set(got) == {"val_acc", "testA_acc", "testB_acc"}
    assert 0 < got["val_acc"] < 100


@pytest.mark.parametrize("as_path", [False, True])
def test_grounding_eval_bbox_vlue_equals_jax(tmp_path, as_path):
    results, _, vlue = _results_and_refs(np.random.default_rng(4))
    results = results[:-1]
    test_json = vlue
    if as_path:
        (tmp_path / "vlue.json").write_text(json.dumps(vlue))
        test_json = str(tmp_path / "vlue.json")
    got = port_eval.grounding_eval_bbox_vlue(results, test_json)
    assert got == jax_eval.grounding_eval_bbox_vlue(results, test_json)
    assert 0 < got["score"] < 1


def test_iou_and_box_conversion_equal_jax():
    rng = np.random.default_rng(5)
    for _ in range(20):
        a, b = rng.uniform(0, 50, 4).tolist(), rng.uniform(0, 50, 4).tolist()
        a[2:] = [a[0] + abs(a[2]), a[1] + abs(a[3])]
        assert port_eval.iou_xyxy(a, b) == jax_eval.iou_xyxy(a, b)
        c = rng.random(4).tolist()
        assert port_eval.cxcywh_norm_to_xyxy_pixels(c, 640, 427) == \
            jax_eval.cxcywh_norm_to_xyxy_pixels(c, 640, 427)


# ---- serving ----

def test_grounding_server_serves_a_jax_params_npz(grounding, tmp_path):
    path = tmp_path / "params.npz"
    save_params_npz(str(path), grounding["variables"])
    server = GroundingServer.from_npz(path, port_config(), dtype=torch.float32, device="cpu")
    b = grounding["batch"]
    args = [b[k] for k in ("image", "text_ids", "text_atts")]
    got = server.predict(*args)
    want = grounding["model"].apply(grounding["variables"], *(jnp.asarray(x) for x in args),
                                    method=JaxXVLMForGrounding.predict)
    assert got.shape == (B, 4) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BOXES)
    assert not server.model.training

