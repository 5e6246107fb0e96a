"""The port's Plus / CCLM base against the JAX package's, in fp32 on the CPU:
``XVLMPlusForPretrain`` on its three routes (the multimodal streams with
and without the region stream's bbox losses, the parallel-text TTC / TTM /
TLM, the text-only MLM) against ``jax.vjp`` with the JAX hard negatives
injected, ``XVLMForRetrieval`` on a Plus config, the Base -> Plus splits
and the ``.th`` import of a CCLM file bit for bit, the optimizer's groups
through index-marked parameters, the converters' round trip; the factory's
Plus rules and the registry audit.

Config: a tiny XLM-R-form text tower (one token type, positions from 2, a
vocabulary of 60) of 2 layers, 2 cross layers, a BEiT-2 tower of width 32
at 32 px, every dropout at 0. The JAX parameters (seeded noise on every
leaf) go across with ``convert.py``. Tolerances: the losses to 1e-5 and
every parameter's gradient to 1e-4 (fp32 through a few layers and a
backward pass, sums in another order)."""

import dataclasses
import os
import re

import numpy as np
import pytest
from tests.torch_threads import few_torch_threads  # noqa: E402,F401 (autouse)

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from x2vlm_tpu.models import (  # noqa: E402
    BEiT2Config as JaxBEiT2Config, BertConfig as JaxBertConfig,
    XVLMForRetrieval as JaxXVLMForRetrieval,
)
from x2vlm_tpu.models.heads import pretrain_init_inputs  # noqa: E402
from x2vlm_tpu.models.xvlm_plus import (  # noqa: E402
    XVLMPlusConfig as JaxXVLMPlusConfig, XVLMPlusForPretrain as JaxXVLMPlusForPretrain,
    split_params_to_plus as jax_split_params_to_plus,
)
from x2vlm_tpu.serving import _flatten  # noqa: E402
from x2vlm_tpu.train import checkpoint as jax_ckpt  # noqa: E402
from x2vlm_tpu.train.optim import _is_no_decay, param_labels as jax_param_labels  # noqa: E402
from x2vlm_tpu_torch import factory  # noqa: E402
from x2vlm_tpu_torch.convert import convert_jax_params, to_jax_params  # noqa: E402
from x2vlm_tpu_torch.models import (  # noqa: E402
    BEiT2Config, BertConfig, XVLMConfig, XVLMForPretrain, XVLMForRetrieval, XVLMPlusConfig,
    XVLMPlusForPretrain, split_params_to_plus,
)
from x2vlm_tpu_torch.train import checkpoint as ckpt  # noqa: E402
from x2vlm_tpu_torch.train.optim import is_no_decay, param_labels  # noqa: E402

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)
VISION = dict(image_res=32, patch_size=16, embed_dim=32, depth=2, num_heads=2,
              drop_path_rate=0.0, dropout_rate=0.0)
TEXT = dict(vocab_size=60, hidden_size=32, num_layers=2, fusion_layer=2, num_heads=2,
            intermediate_size=64, encoder_width=32, hidden_dropout=0.0, attn_dropout=0.0)
B, L, L2, M = 3, 8, 6, 3
LOSSES = {"image": ("loss_itc", "loss_itm", "loss_mlm"),
          "region": ("loss_itc", "loss_itm", "loss_mlm", "loss_bbox", "loss_giou"),
          "para": ("loss_ttc", "loss_ttm", "loss_mlm"), "text": ("loss_mlm",)}


def _text(cls):
    return dataclasses.replace(cls.roberta_base(**TEXT), max_position_embeddings=16)


def _jax_config(**kw):
    return JaxXVLMPlusConfig(vision=JaxBEiT2Config(**VISION), text=_text(JaxBertConfig),
                             embed_dim=16, num_cross_layers=2, **kw)


def _port_config(**kw):
    return XVLMPlusConfig(vision=BEiT2Config(**VISION), text=_text(BertConfig), embed_dim=16,
                          num_cross_layers=2, **kw)


def _noisy(variables, rng):
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(np.asarray(x) + 0.05 * rng.standard_normal(x.shape),
                              jnp.float32), variables)


def _text_rows(rng, n, length, prefix=""):
    ids = rng.integers(4, 60, (n, length)).astype(np.int32)
    atts = np.ones((n, length), np.int32)
    atts[1, length - 3:] = 0
    return {f"text_ids{prefix}": ids * atts, f"text_atts{prefix}": atts}


def _mlm(rng, rows, n):
    masked_ids = rng.integers(4, 60, (n, M)).astype(np.int32)
    masked_ids[n - 1, 2] = -100
    return {"text_ids_masked": np.where(rng.random(rows["text_ids"].shape) < 0.3, 59,
                                        rows["text_ids"]) * rows["text_atts"],
            "masked_pos": rng.integers(0, 5, (n, M)).astype(np.int32),
            "masked_ids": masked_ids}


def _batch(route, rng):
    if route == "region":
        rows = _text_rows(rng, 5, L)
        atts = (rng.random((5, 5)) < 0.6).astype(np.float32)
        atts[:, 0] = 1
        atts[2] = 1
        target = (rng.random((5, 4)) * 0.5 + 0.25).astype(np.float32)
        return dict(rows, **_mlm(rng, rows, 5),
                    image=rng.standard_normal((2, 32, 32, 3)).astype(np.float32),
                    idx_to_group_img=np.array([0, 1, 0, 1, 1], np.int32), image_atts=atts,
                    target_bbox=target, is_image=np.array([0, 0, 1, 0, 0], np.float32))
    rows = _text_rows(rng, B, L)
    out = dict(rows, **_mlm(rng, rows, B))
    if route == "image":
        out["image"] = rng.standard_normal((B, 32, 32, 3)).astype(np.float32)
    if route == "para":
        out.update(_text_rows(rng, B, L2, "_2"))
    return out


@pytest.fixture(scope="module")
def plus():
    rng = np.random.default_rng(0)
    model = JaxXVLMPlusForPretrain(_jax_config(), dtype=jnp.float32)
    init = model.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                      pretrain_init_inputs(_jax_config()), rng=jax.random.PRNGKey(2),
                      ret_bbox_loss=True)
    variables = _noisy(init, rng)
    state, unused = convert_jax_params(_flatten(variables), device="cpu")
    port = XVLMPlusForPretrain(_port_config(), dtype=torch.float32, device="cpu", seed=None)
    port.base.load_state_dict(state)
    return dict(model=model, variables=variables, port=port, unused=unused, rng=rng)


def _jax_negatives(m, b, key, route):
    base = m.base
    if route == "para":
        f1 = base.get_features(text_embeds=base.get_text_embeds(b["text_ids"], b["text_atts"]))
        f2 = base.get_features(text_embeds=base.get_text_embeds(b["text_ids_2"],
                                                                b["text_atts_2"]))
        return base.get_hard_negatives(f1, f2, key)
    if route == "region":
        ie, _, _ = base.get_vision_embeds(b["image"], image_atts=b["image_atts"],
                                          idx_to_group_img=b["idx_to_group_img"])
    else:
        ie, _ = base.get_vision_embeds(b["image"])
    te = base.get_text_embeds(b["text_ids"], b["text_atts"])
    return base.get_hard_negatives(*base.get_features(ie, te), key)


@pytest.mark.parametrize("route", ["image", "region", "para", "text"])
def test_plus_pretrain_losses_and_gradients_match_jax(plus, route):
    """Each route's losses to 1e-5 and every parameter's gradient to 1e-4
    (a parameter the route does not reach: no .grad, JAX's zeros)."""
    batch = _batch(route, np.random.default_rng({"image": 1, "region": 2, "para": 3,
                                                 "text": 4}[route]))
    model, variables = plus["model"], plus["variables"]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(7)
    names = LOSSES[route]

    def losses(params):
        out = model.apply({"params": params}, jb, rng=key, ret_bbox_loss=route == "region",
                          deterministic=True)
        assert tuple(sorted(out)) == tuple(sorted(names))
        return jnp.stack([jnp.asarray(out[k], jnp.float32) for k in names])

    want, vjp = jax.vjp(losses, variables["params"])
    (want_grads,) = vjp(jnp.ones(len(names), jnp.float32))
    neg = None
    if route != "text":
        neg = tuple(torch.from_numpy(np.array(x)).long() for x in model.apply(
            variables, jb, key, route, method=_jax_negatives))
    port = plus["port"]
    port.zero_grad(set_to_none=True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    if route == "region":
        tb["idx_to_group_img"] = tb["idx_to_group_img"].long()
    got = port(tb, neg_idx=neg, ret_bbox_loss=route == "region")
    assert set(got) == set(names)
    sum(got[k] for k in names).backward()
    for k, w in zip(names, np.asarray(want)):
        np.testing.assert_allclose(got[k].item(), w, err_msg=k, **FWD)
    grads, _ = convert_jax_params(_flatten(want_grads), device="cpu")
    params = dict(port.base.named_parameters())
    assert set(params) == set(grads)
    for name, p in params.items():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(g.numpy(), grads[name].numpy(), err_msg=name, **GRAD)
    reached = {n for n, p in params.items() if p.grad is not None and p.grad.abs().sum() > 0}
    assert any(n.startswith("text_encoder.roberta.layer") or
               n.startswith("text_encoder.roberta.encoder.layer.") for n in reached)
    if route != "text":
        assert any(n.startswith("cross_encoder.encoder.layer.1.crossattention") for n in reached)


def test_convert_jax_params_places_every_plus_leaf(plus):
    """Every JAX leaf has a place: the XLM-R tower under ``text_encoder.
    roberta``, the MLM head under ``text_encoder.lm_head``, the cross
    encoder's layers; and back again exactly."""
    assert plus["unused"] == []
    state = plus["port"].base.state_dict()
    assert "text_encoder.lm_head.layer_norm.weight" in state
    assert "cross_encoder.encoder.layer.1.crossattention.self.key.weight" in state
    assert not any(k.startswith(("text_encoder.bert.", "text_encoder.cls.")) for k in state)
    back = to_jax_params(plus["port"].state_dict())
    want = _flatten(plus["variables"]["params"])
    assert set(back) == {"params/" + k for k in want}
    for k, v in want.items():
        np.testing.assert_array_equal(back["params/" + k], np.asarray(v), err_msg=k)


def test_plus_position_ids_start_at_two(plus):
    """The XLM-R form's positions are offset by padding_idx + 1, as the
    JAX ``BertEmbeddings`` computes them."""
    emb = plus["port"].base.text_encoder.roberta.embeddings
    ids = torch.tensor([[5, 6, 7]])
    table = emb.position_embeddings.weight
    x = emb(ids, deterministic=True)
    manual = (emb.word_embeddings.weight[ids] + table[2:5][None] +
              emb.token_type_embeddings.weight[0])
    manual = torch.nn.functional.layer_norm(manual, (32,), emb.LayerNorm.weight,
                                            emb.LayerNorm.bias, 1e-12)
    torch.testing.assert_close(x, manual, rtol=1e-6, atol=1e-6)


def test_retrieval_on_a_plus_config_matches_jax():
    """``XVLMForRetrieval`` on the Plus base (the JAX ``make_base`` picks it):
    ITC with duplicate-aware ``idx`` + ITM through the cross encoder, losses
    and every gradient; ``itm_score`` and the encoders too."""
    rng = np.random.default_rng(5)
    model = JaxXVLMForRetrieval(_jax_config(), dtype=jnp.float32)
    batch = _batch("image", rng)
    batch = {k: batch[k] for k in ("image", "text_ids", "text_atts")}
    batch["idx"] = np.array([4, 8, 4], np.int32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(3)
    variables = _noisy(model.init({"params": jax.random.PRNGKey(0), "dropout": key}, jb,
                                  rng=key), rng)

    def negs(m, b, key):
        ie, _ = m.base.get_vision_embeds(b["image"])
        te = m.base.get_text_embeds(b["text_ids"], b["text_atts"])
        return m.base.get_hard_negatives(*m.base.get_features(ie, te), key, idx=b["idx"])

    def losses(params):
        out = model.apply({"params": params}, jb, rng=key, deterministic=True)
        return jnp.stack([out["loss_itc"], out["loss_itm"]])

    want, vjp = jax.vjp(losses, variables["params"])
    (want_grads,) = vjp(jnp.ones(2, jnp.float32))
    neg = tuple(torch.from_numpy(np.array(x)).long()
                for x in model.apply(variables, jb, key, method=negs))
    state, unused = convert_jax_params(_flatten(variables), device="cpu")
    assert unused == []
    port = XVLMForRetrieval(_port_config(), dtype=torch.float32, device="cpu", seed=None)
    port.load_state_dict(state)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = port(tb, neg_idx=neg)
    (got["loss_itc"] + got["loss_itm"]).backward()
    np.testing.assert_allclose([got["loss_itc"].item(), got["loss_itm"].item()],
                               np.asarray(want), **FWD)
    grads, _ = convert_jax_params(_flatten(want_grads), device="cpu")
    for name, p in port.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(g.numpy(), grads[name].numpy(), err_msg=name, **GRAD)
    with torch.no_grad():
        ie, _ = port.encode_images(tb["image"])
        te, _ = port.encode_texts(tb["text_ids"], tb["text_atts"])
        score = port.itm_score(ie, te, tb["text_atts"])
    want_score = model.apply(variables, jb["image"], jb["text_ids"], jb["text_atts"],
                             method=lambda m, i, t, a: m.itm_score(
                                 m.encode_images(i)[0], m.encode_texts(t, a)[0], a))
    np.testing.assert_allclose(score.numpy(), np.asarray(want_score), **FWD)


def _base_state():
    """An X2-VLM (Base) model's reference-named state with noise, 4 text
    layers (fusion at 2), as a ``.th`` holds it (the tied decoder too)."""
    cfg = XVLMConfig(vision=BEiT2Config(**VISION),
                     text=BertConfig(**dict(TEXT, vocab_size=50, num_layers=4,
                                            max_position_embeddings=16)),
                     embed_dim=16)
    base = XVLMForPretrain(cfg, dtype=torch.float32, device="cpu", seed=3).base
    g = torch.Generator().manual_seed(9)
    sd = {k: v + 0.05 * torch.randn(v.shape, generator=g) for k, v in base.state_dict().items()}
    sd["text_encoder.cls.predictions.decoder.weight"] = \
        sd["text_encoder.bert.embeddings.word_embeddings.weight"].clone()
    return sd


@pytest.mark.parametrize("replace", [False, True])
def test_split_params_to_plus_equals_jax(replace):
    sd = _base_state()
    tree, _ = jax_ckpt.convert_xvlm_state_dict({k: v.numpy() for k, v in sd.items()},
                                               vision_depth=2)
    want = jax_split_params_to_plus(tree, fusion_layer=2, num_layers=4,
                                    replace_text_encoder=replace)
    want["mlm_head"] = {k: v for k, v in want["mlm_head"].items() if k != "decoder"}
    state = {k: v for k, v in sd.items() if "decoder.weight" not in k}
    got = split_params_to_plus(state, fusion_layer=2, num_layers=4,
                               replace_text_encoder=replace)
    assert any(k.startswith("cross_encoder.encoder.layer.1.") for k in got)
    assert replace != any(k.startswith("text_encoder.bert.") for k in got)
    _assert_same(got, want)


def _assert_same(port_state, jax_tree):
    got = {re.sub(r"^params/(base/)?", "", k): v for k, v in to_jax_params(port_state).items()}
    want = {k: np.asarray(v, np.float32) for k, v in _flatten(jax_tree).items()}
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:6]
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)


@pytest.mark.parametrize("text_layers,replace", [(2, True), (2, False), (3, False)])
def test_split_imported_to_plus_equals_jax(text_layers, replace):
    """The ``.th`` import then the Base -> Plus surgery: with
    ``replace_text_encoder`` no text tower and an MLM head of its transform
    only; the carried keys bit for bit the JAX tree's."""
    sd = _base_state()
    tree, _ = jax_ckpt.convert_xvlm_state_dict({k: v.numpy() for k, v in sd.items()},
                                               vision_depth=2)
    want = jax_ckpt.split_imported_to_plus(tree, xvlm_text_layers=text_layers,
                                           replace_text_encoder=replace)
    state, unused, kind = ckpt.convert_checkpoint_auto(sd)
    assert kind == "xvlm" and unused == []
    got = ckpt.split_imported_to_plus(state, xvlm_text_layers=text_layers,
                                      replace_text_encoder=replace)
    n_cross = 4 - text_layers
    assert {int(k.split(".")[3]) for k in got if k.startswith("cross_encoder.")} == \
        set(range(n_cross))
    if replace:
        assert not any(k.startswith("text_encoder.bert.") for k in got)
        assert not any("predictions.bias" in k or "decoder" in k for k in got)
    else:
        got.pop("text_encoder.cls.predictions.decoder.weight")
        want["mlm_head"].pop("decoder")
    _assert_same(got, want)


def test_a_cclm_file_imports_as_the_jax_converter_reads_it():
    """A Plus / CCLM ``.th``: ``text_encoder.roberta.*``, the xroberta
    ``lm_head`` with its tied decoder, the cross encoder under
    ``cross_encoder.bert.encoder.layer`` -> the model's parameters bit for
    bit the JAX converter's tree."""
    port = XVLMPlusForPretrain(_port_config(), dtype=torch.float32, device="cpu", seed=4)
    sd = {}
    for k, v in port.base.state_dict().items():
        sd[k.replace("cross_encoder.encoder.", "cross_encoder.bert.encoder.")] = v + 0.01
    sd["text_encoder.lm_head.decoder.weight"] = \
        sd["text_encoder.roberta.embeddings.word_embeddings.weight"]
    tree, jax_unused = jax_ckpt.convert_xvlm_state_dict(
        {k: v.numpy() for k, v in sd.items()}, vision_depth=2)
    fresh = XVLMPlusForPretrain(_port_config(), dtype=torch.float32, device="cpu", seed=0)
    missing, unexpected = ckpt.load_reference_checkpoint(fresh, sd)
    assert missing == [] and unexpected == ["text_encoder.lm_head.decoder.weight"]
    tree["mlm_head"].pop("decoder")
    _assert_same(fresh.base.state_dict(), tree)


def test_decay_mask_and_labels_match_jax():
    """Every Plus parameter marked with its index and carried to the JAX
    names: each JAX leaf has the port parameter's decay flag and group
    (XLM-R's tower ``text``, the cross encoder ``other`` as the JAX rule
    gives it, the fresh names ``fresh``)."""
    port = XVLMPlusForPretrain(_port_config(), dtype=torch.float32, device="cpu", seed=0)
    named = list(port.named_parameters())
    marked = {n: torch.full_like(p, float(i)) for i, (n, p) in enumerate(named)}
    flat = to_jax_params(marked)
    leaves = {k[len("params/"):]: int(v.flat[0]) for k, v in flat.items()}
    fresh = ["cross_encoder.encoder.layer.0.crossattention.self.query.weight",
             "text_encoder.lm_head.bias"]
    labels = param_labels(named, 2, fresh_names=fresh)
    tree = {}
    for k in leaves:
        node = tree
        *parents, last = k.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = np.zeros(np.shape(flat["params/" + k]), np.float32)
    jax_labels = _flatten(jax_param_labels(
        {"params": tree}, 2, fresh_paths=["cross_encoder/layer_0/cross_attn/query/kernel",
                                          "mlm_head/decoder_bias"]))
    seen = set()
    for k, i in leaves.items():
        name, p = named[i]
        seen.add(name)
        node = tree
        for part in k.split("/"):
            node = node[part]
        assert is_no_decay(name, p) == bool(_is_no_decay(k, node)), (name, k)
        assert labels[name] == str(jax_labels["params/" + k]), (name, k)
    assert seen == {n for n, _ in named}
    assert labels["base.cross_encoder.encoder.layer.1.output.dense.weight"] == "other"
    assert labels["base.text_encoder.roberta.encoder.layer.1.output.dense.weight"] == "text"


# ---- the factory ----

def _yaml(**kw):
    return dict(dict(image_res=32, patch_size=16, text_encoder="data/xlm-roberta-base",
                     text_num_hidden_layers=2, text_fusion_start_at=2,
                     vision_config_inline={"vision_width": 32, "num_hidden_layers": 2,
                                           "num_attention_heads": 2},
                     text_config_inline={"vocab_size": 60, "hidden_size": 32, "num_heads": 2,
                                         "intermediate_size": 64, "encoder_width": 32,
                                         "max_position_embeddings": 16},
                     model_type="cclm", num_cross_layers=2, embed_dim=16), **kw)


def test_factory_builds_the_cclm_model_as_the_jax_factory():
    from x2vlm_tpu.factory import xvlm_config_from_yaml as jax_config_from_yaml

    cfg = _yaml(text_config_inline=dict(_yaml()["text_config_inline"], embedding_dim=16,
                                        tie_word_embeddings=False))
    got, want = factory.xvlm_config_from_yaml(cfg), jax_config_from_yaml(cfg)
    assert isinstance(got, XVLMPlusConfig) and got.num_cross_layers == want.num_cross_layers
    for f in dataclasses.fields(BertConfig):
        assert getattr(got.text, f.name) == getattr(want.text, f.name), f.name
    assert got.text.position_offset == 2 and got.text.type_vocab_size == 1
    assert got.cross_config.num_layers == 2 and got.cross_config.fusion_layer == 0
    model, _ = factory.build_model(cfg, "pretrain", device="cpu", dtype=torch.float32)
    assert isinstance(model, XVLMPlusForPretrain)
    head = model.base.text_encoder.mlm_head
    assert head.dense.weight.shape == (16, 32) and head.decoder.weight.shape == (60, 16)
    # the untied bottleneck head's loss: a plain CE over its own decoder
    h = torch.randn(2, 5, 32)
    pos = torch.tensor([[1, 2], [0, 3]])
    labels = torch.tensor([[4, -100], [7, 9]])
    with torch.no_grad():
        got_loss = head(h, pos, None, labels)
        logits = head.logits(torch.gather(h, 1, pos[:, :, None].expand(-1, -1, 32)), None)
    want_loss = torch.nn.functional.cross_entropy(logits.reshape(-1, 60), labels.reshape(-1))
    torch.testing.assert_close(got_loss, want_loss, rtol=1e-6, atol=1e-6)
    assert isinstance(factory.build_model(cfg, "retrieval", device="cpu")[0],
                      XVLMForRetrieval)


@pytest.mark.parametrize("extra,err,match", [
    ({"cross_drop_path_rate": 0.1, "text_drop_path_rate": 0.1}, ValueError, "drop-path"),
    ({"text_config_inline": {"remat": True, "remat_policy": "dot"}}, ValueError,
     "remat_policy"),
])
def test_factory_refuses_what_the_plus_base_does_not_build(extra, err, match):
    with pytest.raises(err, match=match):
        factory.xvlm_config_from_yaml(_yaml(**extra))


def test_text_config_inline_remats_the_text_tower_alone():
    """``text_config_inline`` remat keys reach the text tower, the cross
    encoder and the decoder (the text config carries them) and not the
    vision tower, as in the JAX factory."""
    from x2vlm_tpu.factory import xvlm_config_from_yaml as jax_config_from_yaml

    cfg = _yaml(text_config_inline=dict(_yaml()["text_config_inline"], remat=True,
                                        remat_policy="dots_saveable"))
    got, want = factory.xvlm_config_from_yaml(cfg), jax_config_from_yaml(cfg)
    for stack in (got.text, got.cross_config):
        assert (stack.remat, stack.remat_policy) == (True, "dots_saveable")
    assert (want.text.remat, want.text.remat_policy) == (True, "dots_saveable")
    assert not got.vision.remat and not want.vision.remat
    model, _ = factory.build_model(cfg, "vqa", device="cpu")
    assert model.text_decoder.stack.config.remat


@pytest.mark.parametrize("task,extra", [("nlvr", {}), ("vqa", {"pad_token_id": 1}),
                                        ("classification", {"num_labels": 3})])
def test_the_plus_base_is_no_longer_refused_under_another_task(task, extra):
    """The IGLUE tasks' models build on the Plus core: its cross encoder,
    no fused text stack; the VQA decoder in the RoBERTa form."""
    model, mcfg = factory.build_model(_yaml(**extra), task, device="cpu")
    assert mcfg.is_plus and hasattr(model, "cross_encoder")
    assert hasattr(model.text_encoder, "roberta")
    if task == "vqa":
        assert hasattr(model.text_decoder, "roberta") and model.pad_token_id == 1


# ---- the registry audit (the JAX tests/test_config_zoo.py meta-audit) ----

# use_random_sampling is read-and-unused by the reference too
AUDIT_EXEMPT = {"use_random_sampling"}


def test_registry_keys_are_actually_read_by_the_port():
    """Every key of the port's registry appears as a string literal in some
    port source file other than the registry itself, apart from
    ``AUDIT_EXEMPT``."""
    from x2vlm_tpu_torch.core import config_schema as cs

    root = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "x2vlm_tpu_torch")
    src = ""
    for d, _, files in os.walk(root):
        for fn in files:
            if fn.endswith(".py") and fn != "config_schema.py":
                with open(os.path.join(d, fn)) as f:
                    src += f.read()
    registries = [cs.TOP_LEVEL, cs.VISION_JSON] + list({id(r): r for r in
                                                       cs.BLOCKS.values()}.values())
    missing = sorted({k for reg in registries for k in reg
                      if k not in AUDIT_EXEMPT and
                      not re.search(r"['\"]" + re.escape(k) + r"['\"]", src)})
    assert missing == []
    for k in ("code_switch", "source_key", "target_key", "num_cross_layers", "is_xvlm_ckpt",
              "xvlm_ckpt_text_num_hidden_layers", "native_aug", "marvl_image_root", "remat",
              "remat_policy"):
        assert k not in AUDIT_EXEMPT and re.search(r"['\"]" + k + r"['\"]", src), k
