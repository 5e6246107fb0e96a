"""The port's optimizer, schedule and train step against the JAX package's
``create_optimizer`` optax chain, on the CPU.

The same parameters (a tiny ``XVLMForPretrain`` with seeded noise, carried
across with ``convert.py``) and the same fixed numpy gradients go through 3
updates of each, with warmup (the first update has lr 0), gradient clipping,
masked weight decay, group scales and the temperature projection; the
parameters must agree to 1e-6 (fp32 elementwise math in another order). The
group labels and the decay mask are compared leaf for leaf through the name
map, which is found by carrying leaf-numbered arrays through ``convert.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from x2vlm_tpu.models import (  # noqa: E402
    BEiT2Config as JaxBEiT2Config, BertConfig as JaxBertConfig,
    XVLMConfig as JaxXVLMConfig, XVLMForPretrain as JaxXVLMForPretrain,
)
from x2vlm_tpu.models.heads import pretrain_init_inputs  # noqa: E402
from x2vlm_tpu.serving import _flatten  # noqa: E402
from x2vlm_tpu.train import optim as jax_optim  # noqa: E402
from x2vlm_tpu_torch.convert import convert_jax_params  # noqa: E402
from x2vlm_tpu_torch.models import (  # noqa: E402
    BEiT2Config, BertConfig, XVLMConfig, XVLMForPretrain,
)
from x2vlm_tpu_torch.train import (  # noqa: E402
    create_optimizer, is_no_decay, lr_schedule, make_train_step, param_labels,
)

VISION = dict(image_res=32, patch_size=16, embed_dim=32, depth=2, num_heads=2,
              drop_path_rate=0.0, dropout_rate=0.0)
TEXT = dict(vocab_size=100, hidden_size=32, num_layers=4, fusion_layer=2,
            num_heads=2, intermediate_size=64, encoder_width=32,
            hidden_dropout=0.0, attn_dropout=0.0, max_position_embeddings=64)
PORT_CONFIG = XVLMConfig(vision=BEiT2Config(**VISION), text=BertConfig(**TEXT),
                         embed_dim=16)
GROUPS = dict(lr_mult=3.0, vision_lr_scale=0.5, text_lr_scale=1.0, cross_lr_scale=2.0)


@pytest.fixture(scope="module")
def jax_params():
    cfg = JaxXVLMConfig(vision=JaxBEiT2Config(**VISION), text=JaxBertConfig(**TEXT),
                        embed_dim=16)
    init = JaxXVLMForPretrain(cfg, dtype=jnp.float32).init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        pretrain_init_inputs(cfg), rng=jax.random.PRNGKey(2), ret_bbox_loss=True)
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda x: jnp.asarray(np.asarray(x) + 0.05 * rng.standard_normal(x.shape),
                              jnp.float32), init["params"])
    # the temperature just above its lower bound: the projection must act
    params["base"]["temp"] = jnp.float32(0.0012)
    return params


def _port_model(jax_params):
    state, unused = convert_jax_params(_flatten({"params": jax_params}), device="cpu")
    assert unused == []
    model = XVLMForPretrain(PORT_CONFIG, dtype=torch.float32, device="cpu", seed=None)
    model.base.load_state_dict(state)
    return model


def _leaf_map(jax_params):
    """port parameter name -> JAX leaf paths it is made of."""
    paths = sorted(_flatten(jax_params))
    numbered = {p: np.full(np.shape(_flatten(jax_params)[p]), i, np.float32)
                for i, p in enumerate(paths)}
    state, _ = convert_jax_params(numbered, device="cpu")
    return {f"base.{name}": [paths[int(i)] for i in np.unique(t.numpy())]
            for name, t in state.items()}


def _jax_leaf_values(tree, fn):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax_optim._path_str(p): fn(jax_optim._path_str(p), x) for p, x in flat}


def test_labels_and_decay_mask_match_jax_leaf_for_leaf(jax_params):
    model = _port_model(jax_params)
    fusion = TEXT["fusion_layer"]
    fresh = ("itm_head",)
    jlabels = _flatten(jax_optim.param_labels({"params": jax_params}, fusion,
                                              fresh_prefixes=fresh))
    jlabels = {k.split("/", 1)[-1]: str(v) for k, v in jlabels.items()}  # drop params/
    jmask = _jax_leaf_values(jax_params,
                             lambda p, x: not jax_optim._is_no_decay(p, x))
    labels = param_labels(model.named_parameters(), fusion, fresh_prefixes=fresh)
    leaf_map = _leaf_map(jax_params)
    assert sorted(sum(leaf_map.values(), [])) == sorted(jmask)   # a bijection of leaves
    for name, p in model.named_parameters():
        for leaf in leaf_map[name]:
            assert labels[name] == jlabels[leaf], (name, leaf)
            assert (not is_no_decay(name, p)) == jmask[leaf], (name, leaf)
    assert set(labels.values()) == {"vision", "text", "cross", "other", "fresh"}
    assert labels["base.text_encoder.cls.predictions.bias"] == "other"
    assert not is_no_decay("base.text_encoder.bert.embeddings.position_embeddings.weight",
                           model.base.text_encoder.bert.embeddings.position_embeddings.weight)


def test_optimizer_matches_the_optax_chain_over_3_updates(jax_params):
    fusion = TEXT["fusion_layer"]
    schedule = dict(base_lr=1e-3, total_steps=10, warmup_steps=0.2)
    tx = jax_optim.create_optimizer(
        jax_params, jax_optim.lr_schedule(**schedule),
        labels=jax_optim.param_labels(jax_params, fusion, fresh_prefixes=("itm_head",)),
        **GROUPS)
    model = _port_model(jax_params)
    opt = create_optimizer(model, lr_schedule(**schedule),
                           labels=param_labels(model.named_parameters(), fusion,
                                               fresh_prefixes=("itm_head",)), **GROUPS)
    state = tx.init(jax_params)
    params = jax_params
    rng = np.random.default_rng(1)
    for it in range(3):
        grads = jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.standard_normal(x.shape) * 0.01, jnp.float32), params)
        grads["base"]["temp"] = jnp.float32(50.0)      # pushes temp below 0.001
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        gstate, _ = convert_jax_params(_flatten({"params": grads}), device="cpu")
        for name, p in model.base.named_parameters():
            p.grad = gstate[name].clone()
        g_norm = opt.step()
        np.testing.assert_allclose(float(g_norm), float(optax.global_norm(grads)),
                                   rtol=1e-6)
        want, _ = convert_jax_params(_flatten({"params": params}), device="cpu")
        for name, p in model.base.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                       rtol=1e-6, atol=1e-6, err_msg=f"{name} update {it}")
    assert model.base.temp.item() == pytest.approx(0.001)


def test_lr_schedule_matches_jax():
    """The JAX schedule computes in fp32, the port's in Python floats: they
    agree to fp32 rounding of the base rate."""
    for args in ((1e-4, 1000, 100), (2e-4, 50, 0.1), (1e-3, 20, 0, 0.1)):
        want = jax_optim.lr_schedule(*args)
        got = lr_schedule(*args)
        assert args[2] == 0 or got(0) == float(want(0)) == 0.0   # warmup starts at 0
        for step in (0, 1, 5, 99, 100, 101, 500, 999, 1000, 1500):
            assert got(step) == pytest.approx(float(want(step)), rel=1e-6,
                                              abs=1e-6 * args[0])


def _batch(rng, n):
    ids = rng.integers(1, 100, (n, 8)).astype(np.int64)
    atts = np.ones((n, 8), np.int64)
    atts[1::2, 5:] = 0
    return {"image": torch.from_numpy(rng.standard_normal((n, 32, 32, 3)).astype(np.float32)),
            "text_ids": torch.from_numpy(ids * atts),
            "text_atts": torch.from_numpy(atts),
            "text_ids_masked": torch.from_numpy(np.where(rng.random((n, 8)) < 0.3, 3, ids)
                                                * atts),
            "masked_pos": torch.from_numpy(rng.integers(0, 4, (n, 3))),
            "masked_ids": torch.from_numpy(rng.integers(1, 100, (n, 3)))}


def test_train_step_accumulation_is_the_mean_of_microbatch_gradients(jax_params):
    """accum_steps=2 over 4 rows: the averaged gradients equal the mean of
    the two 2-row microbatches' gradients computed one by one (with the same
    generator draws), and the metrics are finite."""
    batch = _batch(np.random.default_rng(2), 4)
    model = _port_model(jax_params)
    opt = create_optimizer(model, lr_schedule(1e-4, 1000, 100))
    step = make_train_step(model, opt, accum_steps=2)
    accum, opt_step = {}, opt.step

    def read_grads_then_step():   # the step clears .grad after the update
        # the image stream does not reach the bbox head: it has no .grad
        accum.update({n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None})
        return opt_step()

    opt.step = read_grads_then_step
    metrics = step(batch, torch.Generator().manual_seed(3), torch.Generator().manual_seed(4))
    assert set(metrics) == {"loss_itc", "loss_itm", "loss_mlm", "loss_total", "grad_norm"}
    assert all(torch.isfinite(v) for v in metrics.values())
    assert all(p.grad is None for p in model.parameters())

    ref = _port_model(jax_params).train()
    gen, dgen = torch.Generator().manual_seed(3), torch.Generator().manual_seed(4)
    grads, totals = [], []
    for half in (slice(0, 2), slice(2, 4)):
        ref.zero_grad(set_to_none=True)
        losses = ref({k: v[half] for k, v in batch.items()}, gen, dgen)
        total = sum(losses.values())
        total.backward()
        totals.append(total.item())
        grads.append({n: p.grad.clone() for n, p in ref.named_parameters()
                      if p.grad is not None})
    assert accum.keys() == grads[0].keys() == grads[1].keys()
    assert {n for n, _ in model.named_parameters()} - accum.keys() == {
        n for n, _ in model.named_parameters() if n.startswith("base.bbox_head.")}
    for name, g in accum.items():
        torch.testing.assert_close(g, (grads[0][name] + grads[1][name]) / 2,
                                   rtol=1e-6, atol=1e-7, msg=name)
    assert float(metrics["loss_total"]) == pytest.approx(sum(totals) / 2, rel=1e-6)
    # the first update of a warmup schedule has lr 0: only the clock moved
    for (name, p), q in zip(model.named_parameters(), ref.parameters()):
        assert torch.equal(p, q), name
    assert opt.count == 1


def test_train_step_with_dropout_is_reproducible_and_moves_the_weights(jax_params):
    cfg = XVLMConfig(vision=BEiT2Config(**dict(VISION, drop_path_rate=0.1)),
                     text=BertConfig(**dict(TEXT, hidden_dropout=0.1, attn_dropout=0.1)),
                     embed_dim=16)
    batch = _batch(np.random.default_rng(5), 4)
    results = []
    for _ in range(2):
        model = XVLMForPretrain(cfg, dtype=torch.float32, device="cpu", seed=0)
        before = [p.detach().clone() for p in model.parameters()]
        step = make_train_step(model, create_optimizer(model, lr_schedule(1e-3, 10)),
                               loss_weights={"loss_mlm": 0.5})
        gen, dgen = torch.Generator().manual_seed(1), torch.Generator().manual_seed(2)
        metrics = [step(batch, gen, dgen) for _ in range(2)]
        assert all(torch.isfinite(v).all() for m in metrics for v in m.values())
        m = metrics[0]
        assert float(m["loss_total"]) == pytest.approx(
            float(m["loss_itc"] + m["loss_itm"] + 0.5 * m["loss_mlm"]), rel=1e-6)
        assert any(not torch.equal(a, b) for a, b in zip(before, model.parameters()))
        results.append([float(v) for v in metrics[1].values()])
    assert results[0] == results[1]
