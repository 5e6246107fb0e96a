"""The port's pretraining and retrieval fine-tuning losses and gradients
against ``jax.value_and_grad`` of the JAX package's ``XVLMForPretrain`` /
``XVLMForRetrieval``, in fp32 on the CPU.

Config: the tiny config of test_torch_xvlm.py, but with a 192 px image so
the vision stream (145 tokens) takes the flash route (vision width 64, one
head: D = 64), and every dropout and drop-path at 0. The JAX parameters
(seeded noise on every leaf) go across with ``convert.py``; the hard
negatives the JAX model draws are injected into the port. Tolerance:
rtol = atol = 1e-4 for the losses and every parameter's gradient (fp32
through several layers and a backward pass, sums in another order)."""

import numpy as np
import pytest
from tests.torch_threads import few_torch_threads  # noqa: E402,F401 (autouse)

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from x2vlm_tpu.models import (  # noqa: E402
    BEiT2Config as JaxBEiT2Config, BertConfig as JaxBertConfig,
    XVLMConfig as JaxXVLMConfig, XVLMForPretrain as JaxXVLMForPretrain,
    XVLMForRetrieval as JaxXVLMForRetrieval,
)
from x2vlm_tpu.models.heads import pretrain_init_inputs  # noqa: E402
from x2vlm_tpu.ops.fused_ce import (  # noqa: E402
    fused_vocab_ce as jax_fused_ce, fused_vocab_ce_weighted as jax_fused_ce_weighted,
)
from x2vlm_tpu.serving import _flatten  # noqa: E402
from x2vlm_tpu_torch.convert import convert_jax_params  # noqa: E402
from x2vlm_tpu_torch.models import (  # noqa: E402
    BEiT2Config, BertConfig, XVLMConfig, XVLMForPretrain, XVLMForRetrieval,
)
from x2vlm_tpu_torch.ops import flash_attention as port_flash  # noqa: E402
from x2vlm_tpu_torch.ops import tiny_attention as port_tiny  # noqa: E402
from x2vlm_tpu_torch.ops.fused_ce import (  # noqa: E402
    CHUNK, fused_vocab_ce, fused_vocab_ce_weighted,
)

TOL = dict(rtol=1e-4, atol=1e-4)
VISION = dict(image_res=192, patch_size=16, embed_dim=64, depth=2, num_heads=1,
              drop_path_rate=0.0, dropout_rate=0.0)
TEXT = dict(vocab_size=100, hidden_size=32, num_layers=4, fusion_layer=2,
            num_heads=2, intermediate_size=64, encoder_width=64,
            hidden_dropout=0.0, attn_dropout=0.0, max_position_embeddings=64)
PORT_CONFIG = XVLMConfig(vision=BEiT2Config(**VISION), text=BertConfig(**TEXT),
                         embed_dim=16)
B, L, M = 3, 8, 3


def _jax_config():
    return JaxXVLMConfig(vision=JaxBEiT2Config(**VISION), text=JaxBertConfig(**TEXT),
                         embed_dim=16)


def _noisy(variables, rng):
    """Seeded noise on every leaf, so zero / one inits carry information."""
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(np.asarray(x) + 0.05 * rng.standard_normal(x.shape),
                              jnp.float32), variables)


def _batch(rng):
    ids = rng.integers(1, 100, (B, L)).astype(np.int32)
    atts = np.ones((B, L), np.int32)
    atts[1, 5:] = 0
    atts[2, 3:] = 0
    masked_ids = rng.integers(1, 100, (B, M)).astype(np.int32)
    masked_ids[2, 2] = -100          # an ignored label
    return {
        "image": rng.standard_normal((B, 192, 192, 3)).astype(np.float32),
        "text_ids": ids * atts,
        "text_atts": atts,
        "text_ids_masked": np.where(rng.random((B, L)) < 0.3, 3, ids) * atts,
        "masked_pos": rng.integers(0, 3, (B, M)).astype(np.int32),
        "masked_ids": masked_ids,
    }


def _port_grads_by_jax_tree(grads_tree):
    """A JAX gradient tree in the port's names (same mapping as the params)."""
    state, _ = convert_jax_params(_flatten(grads_tree), device="cpu")
    return state


def _features(m, batch):
    base = m.base
    ie, _ = base.get_vision_embeds(batch["image"], deterministic=True)
    te = base.get_text_embeds(batch["text_ids"], batch["text_atts"], deterministic=True)
    return base.get_features(ie, te)


@pytest.fixture(scope="module")
def pretrain():
    rng = np.random.default_rng(0)
    model = JaxXVLMForPretrain(_jax_config(), dtype=jnp.float32)
    init = model.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                      pretrain_init_inputs(_jax_config()), rng=jax.random.PRNGKey(2),
                      ret_bbox_loss=True)
    variables = _noisy(init, rng)
    batch = _batch(rng)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(7)

    def negs(m, b, key):
        i_f, t_f = _features(m, b)
        return m.base.get_hard_negatives(i_f, t_f, key)

    neg_idx = [np.array(x) for x in model.apply(variables, jbatch, key, method=negs)]

    def loss_fn(params):
        losses = model.apply({"params": params}, jbatch, rng=key, deterministic=True)
        return sum(losses.values()), losses

    (_, losses), grads = jax.value_and_grad(loss_fn, has_aux=True)(variables["params"])
    state, unused = convert_jax_params(_flatten(variables), device="cpu")
    port = XVLMForPretrain(PORT_CONFIG, dtype=torch.float32, device="cpu", seed=None)
    port.base.load_state_dict(state)
    return dict(losses={k: float(v) for k, v in losses.items()}, grads=grads,
                params=variables["params"], neg_idx=neg_idx, batch=batch, port=port,
                unused=unused)


def _port_losses(port, batch, neg_idx):
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    port.zero_grad(set_to_none=True)
    losses = port(tb, neg_idx=tuple(torch.from_numpy(x).long() for x in neg_idx))
    sum(losses.values()).backward()
    return {k: v.item() for k, v in losses.items()}


def test_pretrain_losses_and_gradients_match_jax(pretrain, monkeypatch):
    calls = {"flash": 0, "tiny": 0}

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(port_flash, "flash_attention_bwd_reference",
                        spy("flash", port_flash.flash_attention_bwd_reference))
    monkeypatch.setattr(port_tiny, "tiny_attention_bwd_reference",
                        spy("tiny", port_tiny.tiny_attention_bwd_reference))
    port = pretrain["port"]
    got = _port_losses(port, pretrain["batch"], pretrain["neg_idx"])
    # the backward ran through both attention wrappers: 2 vision blocks;
    # 2 text layers + 2 fusion layers x (self + cross)
    assert calls == {"flash": 2, "tiny": 6}
    assert set(got) == {"loss_itc", "loss_itm", "loss_mlm"}
    for k, v in pretrain["losses"].items():
        np.testing.assert_allclose(got[k], v, err_msg=k, **TOL)
    want = _port_grads_by_jax_tree(pretrain["grads"])
    params = dict(port.base.named_parameters())
    assert set(params) == set(want)
    for name, p in params.items():
        # the image stream does not reach the bbox head: no .grad, JAX's zeros
        assert p.grad is not None or name.startswith("bbox_head."), name
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), err_msg=name, **TOL)


def test_pretrain_text_stream_matches_jax(pretrain):
    """The text-only stream: MLM through the whole stack, no cross-attention."""
    batch = {k: v for k, v in _batch(np.random.default_rng(1)).items() if k != "image"}
    model = JaxXVLMForPretrain(_jax_config(), dtype=jnp.float32)
    want = model.apply({"params": pretrain["params"]},
                       {k: jnp.asarray(v) for k, v in batch.items()}, deterministic=True)
    with torch.no_grad():
        got = pretrain["port"]({k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(got) == {"loss_mlm"}
    np.testing.assert_allclose(float(got["loss_mlm"]), float(want["loss_mlm"]), **TOL)


def test_convert_jax_params_leaves_nothing(pretrain):
    """The bbox head goes across too: every JAX parameter has a place."""
    assert pretrain["unused"] == []
    assert "bbox_head.3.weight" in dict(pretrain["port"].base.named_parameters())


def test_retrieval_finetune_losses_match_jax():
    """XVLMForRetrieval.forward: ITC with duplicate-caption-aware idx + ITM."""
    rng = np.random.default_rng(3)
    cfg = _jax_config()
    model = JaxXVLMForRetrieval(cfg, dtype=jnp.float32)
    batch = _batch(rng)
    batch = {k: batch[k] for k in ("image", "text_ids", "text_atts")}
    batch["idx"] = np.array([5, 9, 5], np.int32)   # rows 0 and 2: one image id
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(4)
    init = model.init({"params": jax.random.PRNGKey(0), "dropout": key}, jbatch, rng=key)
    variables = _noisy(init, rng)

    def negs(m, b, key):
        ie, _ = m.base.get_vision_embeds(b["image"], deterministic=True)
        te = m.base.get_text_embeds(b["text_ids"], b["text_atts"], deterministic=True)
        i_f, t_f = m.base.get_features(ie, te)
        return m.base.get_hard_negatives(i_f, t_f, key, idx=b["idx"])

    neg_idx = model.apply(variables, jbatch, key, method=negs)

    def loss_fn(params):
        losses = model.apply({"params": params}, jbatch, rng=key, deterministic=True)
        return sum(losses.values()), losses

    (_, want), grads = jax.value_and_grad(loss_fn, has_aux=True)(variables["params"])
    state, _ = convert_jax_params(_flatten(variables), device="cpu")
    port = XVLMForRetrieval(PORT_CONFIG, dtype=torch.float32, device="cpu", seed=None)
    port.load_state_dict(state)
    got = port({k: torch.from_numpy(v) for k, v in batch.items()},
               neg_idx=tuple(torch.from_numpy(np.array(x)).long() for x in neg_idx))
    for k in ("loss_itc", "loss_itm"):
        np.testing.assert_allclose(got[k].item(), float(want[k]), err_msg=k, **TOL)
    sum(got.values()).backward()
    want_g = _port_grads_by_jax_tree(grads)
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[name].numpy(), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_fused_vocab_ce_weighted_matches_jax(smoothing):
    """Two vocab chunks (V > 7680), some zero weights, loss and gradients."""
    rng = np.random.default_rng(int(smoothing * 10))
    N, D, V = 6, 16, CHUNK + 321
    h = rng.standard_normal((N, D)).astype(np.float32)
    table = rng.standard_normal((V, D)).astype(np.float32) * 0.3
    bias = rng.standard_normal(V).astype(np.float32) * 0.1
    labels = rng.integers(0, V, N).astype(np.int32)
    labels[0] = V - 1                                 # in the last chunk
    weights = rng.random(N).astype(np.float32)
    weights[3] = 0.0
    want, vjp = jax.vjp(lambda h, t, b: jax_fused_ce_weighted(
        h, t, b, jnp.asarray(labels), jnp.asarray(weights), smoothing),
        jnp.asarray(h), jnp.asarray(table), jnp.asarray(bias))
    want_g = vjp(jnp.float32(1.0))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (h, table, bias)]
    got = fused_vocab_ce_weighted(*leaves, torch.from_numpy(labels),
                                  torch.from_numpy(weights), smoothing)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-5)
    for label, leaf, w in zip(("dh", "dtable", "dbias"), leaves, want_g):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), err_msg=label,
                                   rtol=1e-5, atol=1e-6)


def test_fused_vocab_ce_mean_matches_jax():
    rng = np.random.default_rng(5)
    N, D, V = 5, 8, 50
    h = rng.standard_normal((N, D)).astype(np.float32)
    table = rng.standard_normal((V, D)).astype(np.float32)
    bias = np.zeros(V, np.float32)
    labels = rng.integers(0, V, N).astype(np.int32)
    labels[1] = -100
    valid = np.array([True, True, False, True, True])
    want = jax_fused_ce(jnp.asarray(h), jnp.asarray(table), jnp.asarray(bias),
                        jnp.asarray(labels), jnp.asarray(valid))
    got = fused_vocab_ce(*(torch.from_numpy(x) for x in (h, table, bias, labels, valid)))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["eye", "idx", "block"])
def test_hard_negative_sampler_never_draws_a_positive(case):
    cfg = PORT_CONFIG if case != "block" else XVLMConfig(
        vision=PORT_CONFIG.vision, text=PORT_CONFIG.text, embed_dim=16, itm_neg_block=4)
    model = XVLMForRetrieval(cfg, dtype=torch.float32, device="cpu", seed=0)
    n = 8
    gen = torch.Generator().manual_seed(0)
    feats = torch.nn.functional.normalize(torch.randn(2, n, 16, generator=gen), dim=-1)
    idx = torch.tensor([0, 0, 1, 2, 2, 2, 3, 4]) if case == "idx" else None
    seen = set()
    for seed in range(20):
        img_neg, txt_neg = model.get_hard_negatives(
            feats[0], feats[1], torch.Generator().manual_seed(seed), idx=idx)
        rows = torch.arange(n)
        for neg in (img_neg, txt_neg):
            if idx is None:
                assert (neg != rows).all()
            else:
                assert (idx[neg] != idx).all()
            if case == "block":
                assert (neg // 4 == rows // 4).all()
            seen.update(neg.tolist())
    assert len(seen) > 2   # it samples, it does not pick one index


def test_fix_temp_builds_the_jax_param_tree():
    """fix_temp: no temperature parameter in either package; the ITC
    temperature is the config's."""
    vision = dict(VISION, image_res=32, embed_dim=32, num_heads=2)
    text = dict(TEXT, encoder_width=32)
    jcfg = JaxXVLMConfig(vision=JaxBEiT2Config(**vision), text=JaxBertConfig(**text),
                         embed_dim=16, fix_temp=True)
    init = JaxXVLMForPretrain(jcfg, dtype=jnp.float32).init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        pretrain_init_inputs(jcfg), rng=jax.random.PRNGKey(2), ret_bbox_loss=True)
    state, unused = convert_jax_params(_flatten(init), device="cpu")
    assert unused == [] and "temp" not in state
    cfg = XVLMConfig(vision=BEiT2Config(**vision), text=BertConfig(**text), embed_dim=16,
                     fix_temp=True)
    port = XVLMForPretrain(cfg, dtype=torch.float32, device="cpu", seed=None)
    port.base.load_state_dict(state)    # strict: the same parameters
    assert port.base.get_temp().item() == pytest.approx(0.07)


@pytest.fixture(scope="module")
def small_pretrain():
    vision = dict(VISION, image_res=32, embed_dim=32, num_heads=2)
    text = dict(TEXT, encoder_width=32)
    jcfg = JaxXVLMConfig(vision=JaxBEiT2Config(**vision), text=JaxBertConfig(**text),
                         embed_dim=16)
    model = JaxXVLMForPretrain(jcfg, dtype=jnp.float32)
    init = model.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                      pretrain_init_inputs(jcfg), rng=jax.random.PRNGKey(2), ret_bbox_loss=True)
    cfg = XVLMConfig(vision=BEiT2Config(**vision), text=BertConfig(**text), embed_dim=16)
    return model, init["params"], XVLMForPretrain(cfg, dtype=torch.float32, device="cpu",
                                                  seed=0)


@pytest.mark.parametrize("with_idx", [False, True])
@pytest.mark.parametrize("temp", [0.0005, 0.07, 0.9])
def test_contrastive_loss_and_temp_gradient_match_jax(small_pretrain, temp, with_idx):
    """ITC with the temperature inside and outside the [0.001, 0.5] clamp:
    the loss and the temperature's gradient (0 where clamped)."""
    model, params, port = small_pretrain
    rng = np.random.default_rng(11)
    feats = rng.standard_normal((2, 4, 16)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    idx = np.array([3, 1, 3, 0], np.int32) if with_idx else None

    def itc(t):
        p = dict(params, base=dict(params["base"], temp=t))
        return model.apply({"params": p}, jnp.asarray(feats[0]), jnp.asarray(feats[1]),
                           None if idx is None else jnp.asarray(idx),
                           method=lambda m, i, t, x: m.base.get_contrastive_loss(i, t, idx=x))

    want, want_g = jax.value_and_grad(itc)(jnp.float32(temp))
    with torch.no_grad():
        port.base.temp.fill_(temp)
    port.zero_grad(set_to_none=True)
    got = port.base.get_contrastive_loss(
        torch.from_numpy(feats[0]), torch.from_numpy(feats[1]),
        None if idx is None else torch.from_numpy(idx))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(port.base.temp.grad.item(), float(want_g), rtol=1e-5,
                               atol=1e-5)
