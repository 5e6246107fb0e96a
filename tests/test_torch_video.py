"""The video models against the JAX package in fp32 on the CPU:
``get_frame_embeds`` (the frames video-major through one tower call; with and
without the frame positions, and through the Perceiver resampler),
``XVLMForClassification``'s four losses and ``XVLMForMultipleChoice``'s
(every gradient against ``jax.value_and_grad``), the video stream's
pretraining batch with the JAX hard-negative draws injected, one
``make_train_step`` against the JAX one, the decay mask and optimizer groups
of a video model, the round trip through ``convert.py`` and the frame-count
merge of a ``.th`` file.

Config: test_torch_grounding.py's (a 32 px image, vision width 32, 2 blocks;
a 4-layer text stack with 2 fusion layers), 3 frames, a resampler of depth 2
with 4 latents. Tolerances: outputs and losses to 1e-5, gradients and a
step's parameters to rtol = atol = 1e-4."""

import dataclasses

import numpy as np
import pytest
from tests.torch_threads import few_torch_threads  # noqa: E402,F401 (autouse)

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests.test_torch_grounding import (  # noqa: E402
    B, RES, TOL, assert_params_equal, jax_config, one_step_each, port_config, text_batch,
    to_port,
)
from tests.test_torch_pretrain import _noisy  # noqa: E402
from x2vlm_tpu.models import XVLMForPretrain as JaxPretrain  # noqa: E402
from x2vlm_tpu.models.classification import (  # noqa: E402
    XVLMForClassification as JaxClassification, XVLMForMultipleChoice as JaxMultipleChoice,
)
from x2vlm_tpu.models.heads import pretrain_init_inputs  # noqa: E402
from x2vlm_tpu.serving import _flatten  # noqa: E402
from x2vlm_tpu.train import checkpoint as jax_ckpt  # noqa: E402
from x2vlm_tpu.train.optim import _is_no_decay, param_labels as jax_param_labels  # noqa: E402
from x2vlm_tpu_torch.convert import convert_jax_params, to_jax_params  # noqa: E402
from x2vlm_tpu_torch.models import (  # noqa: E402
    XVLMForClassification, XVLMForMultipleChoice, XVLMForPretrain,
)
from x2vlm_tpu_torch.train import checkpoint as ckpt_lib  # noqa: E402
from x2vlm_tpu_torch.train.optim import is_no_decay, param_labels  # noqa: E402

OUT = dict(rtol=1e-5, atol=1e-5)
F, K, NUM_LABELS = 3, 4, 5
VIDEO = {"avgpool": dict(video_encoding="avgpool", frame_len=F, add_frame_pos=False),
         "frame_pos": dict(video_encoding="avgpool", frame_len=F, add_frame_pos=True),
         "resampler": dict(video_encoding="resampler", frame_len=F, add_frame_pos=True,
                           resampler_depth=2, resampler_latents=4)}


def configs(kind):
    return (dataclasses.replace(jax_config(), **VIDEO[kind]),
            dataclasses.replace(port_config(), **VIDEO[kind]))


def video(rng, n=B, dtype=np.float32):
    shape = (n, F, RES, RES, 3)
    if dtype == np.uint8:
        return rng.integers(0, 256, shape).astype(np.uint8)
    return rng.standard_normal(shape).astype(np.float32)


def cls_batch(rng, branch="hard"):
    ids, atts = text_batch(rng)
    batch = {"image": video(rng), "text_ids": ids, "text_atts": atts,
             "labels": np.array([1, 4, 0, 2], np.int32)}
    if branch == "mse":
        batch["labels"] = rng.standard_normal(B).astype(np.float32)
    if branch == "soft":
        w = rng.random((B, NUM_LABELS)).astype(np.float32)
        batch["answer_weights"] = w / w.sum(-1, keepdims=True)
    if branch == "kd":
        batch["answer_pred"] = rng.standard_normal((B, NUM_LABELS)).astype(np.float32)
    return batch


def mc_batch(rng):
    ids, atts = zip(*(text_batch(rng) for _ in range(K)))
    return {"image": video(rng), "option_ids": np.stack(ids, 1),
            "option_atts": np.stack(atts, 1), "labels": np.array([0, 3, 1, 2], np.int32)}


_MODELS = {}


def pair(task, kind="frame_pos", num_labels=NUM_LABELS):
    """(JAX model, noisy variables, port model with those weights), built
    once per (task, kind, num_labels)."""
    key = (task, kind, num_labels)
    if key not in _MODELS:
        rng = np.random.default_rng(len(_MODELS))
        jcfg, pcfg = configs(kind)
        if task == "mc":
            jm, pm, batch = JaxMultipleChoice(jcfg, dtype=jnp.float32), \
                XVLMForMultipleChoice(pcfg, dtype=torch.float32, device="cpu", seed=None), \
                mc_batch(rng)
        else:
            jm = JaxClassification(jcfg, num_labels=num_labels, dtype=jnp.float32)
            pm = XVLMForClassification(pcfg, dtype=torch.float32, device="cpu", seed=None,
                                       num_labels=num_labels)
            batch = cls_batch(rng)
        init = jm.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                       {k: jnp.asarray(v) for k, v in batch.items()})
        variables = _noisy(init, rng)
        _MODELS[key] = (jm, variables, to_port(variables, pm))
    return _MODELS[key]


def jax_loss_and_grads(jm, variables, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.value_and_grad(
        lambda p: jm.apply({"params": p}, jb, deterministic=True)["loss_cls"])(
            variables["params"])
    return float(loss), grads


def port_loss_and_grads(pm, batch):
    pm.zero_grad(set_to_none=True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    if "option_ids" in tb or tb["labels"].dtype == torch.int32:
        tb["labels"] = tb["labels"].long()
    loss = pm(tb)["loss_cls"]
    loss.backward()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
             for n, p in pm.named_parameters()}
    pm.zero_grad(set_to_none=True)
    return loss.item(), grads


def assert_grads(got, jax_grads):
    want, _ = convert_jax_params(_flatten({"params": jax_grads}), device="cpu")
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g, want[name].numpy(), err_msg=name, **TOL)


# ---- names ----

@pytest.mark.parametrize("task,kind", [("cls", "avgpool"), ("cls", "frame_pos"),
                                       ("cls", "resampler"), ("mc", "frame_pos")])
def test_state_dict_keys_are_the_converted_jax_tree(task, kind):
    """base/{temp, vision_encoder, text_encoder[, frame_pos_embed][,
    resampler]} and the head at the top (``cls_head`` / ``mc_head``); the
    port names them ``absolute_frame_pos_embed`` and ``resampler.*``
    (``to_port`` loads strictly), and ``to_jax_params`` goes back to the
    JAX tree leaf for leaf."""
    jm, variables, pm = pair(task, kind)
    params = variables["params"]
    head = "mc_head" if task == "mc" else "cls_head"
    assert set(params) == {"base", head}
    base = {"temp", "vision_encoder", "text_encoder"}
    base |= {"frame_pos_embed"} if VIDEO[kind]["add_frame_pos"] else set()
    base |= {"resampler"} if kind == "resampler" else set()
    assert set(params["base"]) == base
    tops = {k.split(".")[0] for k in pm.state_dict()}
    want = {"temp", "vision_encoder", "text_encoder", head}
    want |= {"absolute_frame_pos_embed"} if VIDEO[kind]["add_frame_pos"] else set()
    want |= {"resampler"} if kind == "resampler" else set()
    assert tops == want
    if VIDEO[kind]["add_frame_pos"]:
        assert pm.absolute_frame_pos_embed.shape == (1, F, 1, 32)
    back = to_jax_params(pm.state_dict())
    flat = _flatten(variables)
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)


def test_a_seeded_video_model_draws_its_frame_positions():
    """Truncated normal at 0.02 (the JAX init), inside +-2 std; the
    resampler's latents and time positions normal at 0.02."""
    _, pcfg = configs("resampler")
    m = XVLMForClassification(pcfg, dtype=torch.float32, device="cpu", seed=3, num_labels=2)
    fp = m.absolute_frame_pos_embed
    assert fp.abs().max() <= 0.04 and 0.01 < fp.std() < 0.03
    assert 0.01 < m.resampler.latents.std() < 0.03


# ---- the frame embeddings ----

@pytest.mark.parametrize("kind", sorted(VIDEO))
def test_frame_embeds_equal_jax(kind):
    jm, variables, pm = pair("cls", kind)
    frames = video(np.random.default_rng(5))
    want_e, want_a = jm.apply(variables, jnp.asarray(frames),
                              method=lambda m, f: m.base.get_vision_embeds(f))
    with torch.no_grad():
        got_e, got_a = pm.get_vision_embeds(torch.from_numpy(frames))
    n = 4 if kind == "resampler" else 1 + (RES // 16) ** 2
    assert got_e.shape == (B, n, 32) and got_a.dtype == torch.int32
    np.testing.assert_allclose(got_e.numpy(), np.asarray(want_e), **OUT)
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))


def test_frames_are_flattened_video_major():
    """One tower call over B * F frames; video b's frames are rows b * F ..
    b * F + F - 1 (each video's own frames are averaged)."""
    _, _, pm = pair("cls", "avgpool")
    frames = torch.from_numpy(video(np.random.default_rng(6)))
    seen = []
    orig = pm.vision_encoder.forward
    pm.vision_encoder.forward = lambda x, *a: seen.append(x.clone()) or orig(x, *a)
    try:
        with torch.no_grad():
            pooled, _ = pm.get_frame_embeds(frames)
    finally:
        del pm.vision_encoder.forward
    assert len(seen) == 1 and seen[0].shape == (B * F, RES, RES, 3)
    assert torch.equal(seen[0][F + 2], frames[1, 2])
    with torch.no_grad():
        one = pm.vision_encoder(frames[2]).mean(0)
    torch.testing.assert_close(pooled[2], one, rtol=1e-5, atol=1e-5)


# ---- the classification losses ----

@pytest.mark.parametrize("branch", ["hard", "soft", "kd", "mse"])
def test_classification_losses_and_gradients_equal_jax(branch):
    """Hard-label CE (an answer off the list at -100 among the labels), soft
    targets, KD from a teacher's logits, MSE with one label."""
    jm, variables, pm = pair("cls", "frame_pos", 1 if branch == "mse" else NUM_LABELS)
    batch = cls_batch(np.random.default_rng(7), branch)
    if branch == "hard":
        batch["labels"][2] = -100
    want, want_grads = jax_loss_and_grads(jm, variables, batch)
    got, grads = port_loss_and_grads(pm, batch)
    np.testing.assert_allclose(got, want, **OUT)
    assert_grads(grads, want_grads)
    assert np.abs(grads["absolute_frame_pos_embed"]).sum() > 0


def test_classification_logits_equal_jax():
    jm, variables, pm = pair("cls", "resampler")
    batch = cls_batch(np.random.default_rng(8))
    want = jm.apply(variables, {k: jnp.asarray(v) for k, v in batch.items()},
                    method=JaxClassification.predict)
    with torch.no_grad():
        got = pm.predict({k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.shape == (B, NUM_LABELS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT)


def test_classification_without_an_image_runs_the_whole_stack_on_text():
    jm, variables, pm = pair("cls", "frame_pos")
    batch = cls_batch(np.random.default_rng(9))
    del batch["image"]
    want, want_grads = jax_loss_and_grads(jm, variables, batch)
    got, grads = port_loss_and_grads(pm, batch)
    np.testing.assert_allclose(got, want, **OUT)
    assert_grads(grads, want_grads)


def test_multiple_choice_loss_gradients_and_scores_equal_jax():
    """B * K option rows through one fusion pass, each row's image K / V
    gathered from its sample's single encoding: the vision tower runs once
    over the B videos' frames."""
    jm, variables, pm = pair("mc")
    batch = mc_batch(np.random.default_rng(10))
    want, want_grads = jax_loss_and_grads(jm, variables, batch)
    calls = []
    orig = pm.vision_encoder.forward
    pm.vision_encoder.forward = lambda x, *a: calls.append(x.shape[0]) or orig(x, *a)
    try:
        got, grads = port_loss_and_grads(pm, batch)
    finally:
        del pm.vision_encoder.forward
    assert calls == [B * F]
    np.testing.assert_allclose(got, want, **OUT)
    assert_grads(grads, want_grads)
    want_s = jm.apply(variables, {k: jnp.asarray(v) for k, v in batch.items()},
                      method=JaxMultipleChoice.predict)
    with torch.no_grad():
        got_s = pm.predict({k: torch.from_numpy(v) for k, v in batch.items()})
    assert got_s.shape == (B, K)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **OUT)


# ---- the video stream's pretraining batch ----

@pytest.fixture(scope="module")
def video_pretrain():
    rng = np.random.default_rng(11)
    jcfg, pcfg = configs("frame_pos")
    model = JaxPretrain(jcfg, dtype=jnp.float32)
    init = model.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                      pretrain_init_inputs(jcfg), rng=jax.random.PRNGKey(2),
                      ret_bbox_loss=True)
    variables = _noisy(init, rng)
    ids, atts = text_batch(rng)
    masked_ids = rng.integers(5, 30, (B, 3)).astype(np.int32)
    masked_ids[1, 2] = -100
    batch = {"image": video(rng, dtype=np.uint8), "text_ids": ids, "text_atts": atts,
             "text_ids_masked": np.where(rng.random(ids.shape) < 0.3, 4, ids) * atts,
             "masked_pos": rng.integers(1, 4, (B, 3)).astype(np.int32),
             "masked_ids": masked_ids}
    state, unused = convert_jax_params(_flatten(variables), device="cpu")
    port = XVLMForPretrain(pcfg, dtype=torch.float32, device="cpu", seed=None)
    assert unused == [] and set(state) == set(port.base.state_dict())
    port.base.load_state_dict(state)
    return dict(model=model, variables=variables, batch=batch, port=port)


@pytest.mark.parametrize("itm", [True, False])
def test_video_stream_losses_and_gradients_equal_jax(video_pretrain, itm):
    """The 5-D uint8 batch through ITC, ITM (the JAX draws injected) and
    MLM, and with the matching loss off (the noisy-image carry)."""
    model, variables, batch = (video_pretrain[k] for k in ("model", "variables", "batch"))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(7)

    def negs(m, b, key):
        base = m.base
        ie, _ = base.get_vision_embeds(b["image"])
        te = base.get_text_embeds(b["text_ids"], b["text_atts"])
        return base.get_hard_negatives(*base.get_features(ie, te), key)

    neg = [np.array(x) for x in model.apply(variables, jb, key, method=negs)]

    def loss_fn(params):
        out = model.apply({"params": params}, jb, rng=key, ret_match_loss=itm,
                          deterministic=True)
        return sum(out.values()), out

    (_, want), grads = jax.value_and_grad(loss_fn, has_aux=True)(variables["params"])
    port = video_pretrain["port"]
    port.zero_grad(set_to_none=True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = port(tb, neg_idx=tuple(torch.from_numpy(x).long() for x in neg) if itm else None,
               ret_match_loss=itm)
    sum(got.values()).backward()
    for k in ("loss_itc", "loss_itm", "loss_mlm"):
        np.testing.assert_allclose(got[k].item(), float(want[k]), err_msg=k, **OUT)
    want_g, _ = convert_jax_params(_flatten({"params": grads}), device="cpu")
    for name, p in port.base.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(g.numpy(), want_g[name].numpy(), err_msg=name, **TOL)
    assert port.base.absolute_frame_pos_embed.grad.abs().sum() > 0
    port.zero_grad(set_to_none=True)


# ---- training ----

def test_one_train_step_equals_jax():
    """Every parameter after one AdamW step of the video QA model (the frame
    positions undecayed, the fresh ``cls_head`` at lr_mult)."""
    jm, variables, _ = pair("cls", "frame_pos")
    _, pcfg = configs("frame_pos")
    port = to_port(variables, XVLMForClassification(pcfg, dtype=torch.float32, device="cpu",
                                                    seed=None, num_labels=NUM_LABELS))
    batch = cls_batch(np.random.default_rng(12))
    want = one_step_each(jm, variables, port, batch, "cls_head")
    assert_params_equal(port, want)


def tree_leaf(tree, path):
    for part in path.split("/"):
        tree = tree[part]
    return tree


@pytest.mark.parametrize("task", ["cls", "mc"])
def test_decay_mask_and_labels_match_jax(task):
    """Every port parameter of a video model (frame positions, resampler,
    head) marked with its index and carried to the JAX names: each JAX
    leaf has the port parameter's decay flag and optimizer group;
    ``absolute_frame_pos_embed`` is not decayed, as ``frame_pos_embed``."""
    _, pcfg = configs("resampler")
    port = (XVLMForMultipleChoice(pcfg, dtype=torch.float32, device="cpu", seed=0)
            if task == "mc" else
            XVLMForClassification(pcfg, dtype=torch.float32, device="cpu", seed=0,
                                  num_labels=3))
    named = list(port.named_parameters())
    marked = to_jax_params({n: torch.full_like(p, float(i)) for i, (n, p) in enumerate(named)})
    leaves = {k[len("params/"):]: int(v.flat[0]) for k, v in marked.items()}
    head = "mc_head" if task == "mc" else "cls_head"
    labels = param_labels(named, 2, fresh_names=[f"{head}.0.weight"])
    tree = {}
    for k in leaves:
        node = tree
        *parents, last = k.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = np.zeros(np.shape(marked["params/" + k]), np.float32)
    jax_labels = _flatten(jax_param_labels({"params": tree}, 2,
                                           fresh_paths=[f"{head}/fc1/kernel"]))
    seen = set()
    for k, i in leaves.items():
        name, p = named[i]
        seen.add(name)
        assert is_no_decay(name, p) == bool(_is_no_decay(k, tree_leaf(tree, k))), (name, k)
        assert labels[name] == str(jax_labels["params/" + k]), (name, k)
    assert seen == {n for n, _ in named}
    assert is_no_decay("absolute_frame_pos_embed", port.absolute_frame_pos_embed)
    assert not is_no_decay("resampler.time_pos_emb", port.resampler.time_pos_emb)


# ---- the frame-count merge ----

@pytest.mark.parametrize("n_file", [2, 5])
def test_frame_count_merge_equals_jax(tmp_path, n_file):
    """A ``.th`` whose ``absolute_frame_pos_embed`` has 2 or 5 frames into a
    3-frame model: the first min(frames) load, the rest keep their fresh
    values, as the JAX ``merge_imported`` does; the parameter is not
    missing. Another shape mismatch raises, in both packages."""
    jm, variables, pm = pair("cls", "frame_pos")
    rng = np.random.default_rng(13)
    sd = {k: v.clone() for k, v in pm.state_dict().items()}
    sd["absolute_frame_pos_embed"] = torch.from_numpy(
        rng.standard_normal((1, n_file, 1, 32)).astype(np.float32))
    sd["cls_head.3.bias"] = torch.from_numpy(rng.standard_normal(NUM_LABELS).astype(np.float32))
    path = tmp_path / "video.th"
    torch.save({"model": sd}, path)
    _, pcfg = configs("frame_pos")
    port = XVLMForClassification(pcfg, dtype=torch.float32, device="cpu", seed=1,
                                 num_labels=NUM_LABELS)
    fresh = port.absolute_frame_pos_embed.detach().clone()
    missing, unexpected = ckpt_lib.load_reference_checkpoint(port, str(path))
    assert missing == [] and unexpected == []
    got = port.absolute_frame_pos_embed.detach()
    n = min(n_file, F)
    torch.testing.assert_close(got[:, :n], sd["absolute_frame_pos_embed"][:, :n],
                               rtol=0, atol=0)
    torch.testing.assert_close(got[:, n:], fresh[:, n:], rtol=0, atol=0)
    assert torch.equal(port.cls_head[3].bias.detach(), sd["cls_head.3.bias"])
    # the JAX merge of the same file into the same fresh values
    imported, _ = jax_ckpt.convert_xvlm_state_dict(
        {k: v.numpy() for k, v in sd.items()}, vision_depth=2)
    fresh_tree = jax.tree_util.tree_map(np.asarray, dict(variables["params"]))
    fresh_tree["base"] = dict(fresh_tree["base"], frame_pos_embed=fresh.numpy())
    merged, jax_missing = jax_ckpt.merge_imported({"params": fresh_tree}, imported)
    np.testing.assert_array_equal(np.asarray(merged["params"]["base"]["frame_pos_embed"]),
                                  got.numpy())
    assert not any("frame_pos" in m for m in jax_missing)
    bad = dict(sd, absolute_frame_pos_embed=torch.zeros(1, F, 1, 16))
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt_lib.load_reference_checkpoint(port, bad)
