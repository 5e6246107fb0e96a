"""The VQA model against the JAX package in fp32 on the CPU:
``XVLMForVQA`` (its parameter names equal the converted JAX tree, the
answer decoder under ``text_decoder``), ``encode_question``,
``decode_logits``, ``loss_vqa`` and every parameter's gradient against
``jax.value_and_grad``, ``rank_answer`` (answers that tie on their first
token among them), ``causal_lm_loss`` (to fp32 rounding, 1e-6: the
log-softmaxes sum in another order) and both branches of
``decoder_params_from_text_encoder``; and the attention route of a causal
call: never the tiny kernel, while the decoder's cross-attention takes it.

Config: test_torch_grounding.py's (32 px, 2 vision blocks, a 2 + 2 layer
text stack of width 32) with a 2-layer decoder, dropout off. Tolerances:
states and logits to 1e-5, the loss and the rank scores to 1e-5, gradients
to rtol = atol = 1e-4."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests.test_torch_grounding import (  # noqa: E402
    BOXES, RES, VOCAB, assert_grads_equal, jax_config, port_config, text_batch, to_port,
)
from tests.test_torch_pretrain import _noisy  # noqa: E402
from x2vlm_tpu.models.generation import (  # noqa: E402
    XVLMForVQA as JaxXVLMForVQA, causal_lm_loss as jax_causal_lm_loss,
    decoder_params_from_text_encoder as jax_decoder_params,
)
from x2vlm_tpu.serving import _flatten  # noqa: E402
from x2vlm_tpu_torch.convert import convert_jax_params  # noqa: E402
from x2vlm_tpu_torch.models import XVLMForVQA  # noqa: E402
from x2vlm_tpu_torch.models.generation import (  # noqa: E402
    causal_lm_loss, decoder_params_from_text_encoder, top_k,
)
from x2vlm_tpu_torch.ops import layers as port_layers  # noqa: E402
from x2vlm_tpu_torch.ops.attention import NEG_INF, dot_product_attention  # noqa: E402

B, L, LA, N_ANS, N_DEC = 3, 8, 5, 6, 2
# the answer list: rows 1 / 2 and 3 / 4 share their first token, so their
# first-token probabilities tie and the top-k order decides between them
ANSWERS = np.array([[2, 10, 3, 0, 0], [2, 11, 12, 3, 0], [2, 11, 3, 0, 0],
                    [2, 13, 14, 15, 3], [2, 13, 3, 0, 0], [2, 16, 3, 0, 0]], np.int32)


def answer_atts(ids):
    return (ids != 0).astype(np.int32)


@pytest.fixture(scope="module")
def vqa():
    rng = np.random.default_rng(12)
    model = JaxXVLMForVQA(jax_config(), num_dec_layers=N_DEC, dtype=jnp.float32)
    q_ids, q_atts = text_batch(rng, B)
    a_ids = ANSWERS[[0, 1, 3, 2, 5]]
    batch = {"image": rng.standard_normal((B, RES, RES, 3)).astype(np.float32),
             "question_ids": q_ids, "question_atts": q_atts,
             "answer_ids": a_ids, "answer_atts": answer_atts(a_ids),
             "answer_weights": np.array([0.5, 0.3, 1.0, 0.0, 0.7], np.float32),
             "answer_index": np.array([0, 0, 1, 2, 2], np.int32)}
    init = model.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                      {k: jnp.asarray(v) for k, v in batch.items()})
    variables = _noisy(init, rng)
    port = to_port(variables, XVLMForVQA(port_config(), num_dec_layers=N_DEC,
                                         dtype=torch.float32, device="cpu", seed=None))
    return dict(model=model, variables=variables, batch=batch, port=port)


def jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def tb(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 and not k.endswith("atts")
            else torch.from_numpy(v) for k, v in batch.items()}


def test_parameter_names_are_the_converted_jax_tree(vqa):
    """base/{vision_encoder, text_encoder} (no projections, temp or heads),
    the decoder's stack (a cross-attention in every layer) and its tied head."""
    params = vqa["variables"]["params"]
    assert set(params) == {"base", "text_decoder", "dec_head"}
    assert set(params["base"]) == {"vision_encoder", "text_encoder"}
    assert set(params["dec_head"]) == {"transform_dense", "transform_ln", "decoder_bias"}
    state = vqa["port"].state_dict()
    assert {k.split(".")[0] for k in state} == {"vision_encoder", "text_encoder",
                                                "text_decoder"}
    for j in range(N_DEC):
        assert f"text_decoder.bert.encoder.layer.{j}.crossattention.self.key.weight" in state
    assert "text_decoder.cls.predictions.bias" in state
    assert not any(k.startswith("text_decoder.cls.predictions.decoder") for k in state)
    # a seeded model carries the same tree
    fresh = XVLMForVQA(port_config(), num_dec_layers=N_DEC, dtype=torch.float32,
                       device="cpu", seed=0)
    assert set(fresh.state_dict()) == set(state)


def test_encode_question_and_decode_logits_equal_jax(vqa):
    model, variables, batch = vqa["model"], vqa["variables"], vqa["batch"]
    want_states = model.apply(variables, jnp.asarray(batch["image"]),
                              jnp.asarray(batch["question_ids"]),
                              jnp.asarray(batch["question_atts"]),
                              method=JaxXVLMForVQA.encode_question)
    idx = batch["answer_index"]
    want_logits = model.apply(variables, jnp.asarray(batch["answer_ids"]),
                              jnp.asarray(batch["answer_atts"]), want_states[idx],
                              jnp.asarray(batch["question_atts"][idx]),
                              method=JaxXVLMForVQA.decode_logits)
    t = tb(batch)
    port = vqa["port"]
    with torch.no_grad():
        states = port.encode_question(t["image"], t["question_ids"], t["question_atts"])
        logits = port.decode_logits(t["answer_ids"], t["answer_atts"], states[idx],
                                    t["question_atts"][idx])
    assert states.shape == (B, L, 32) and logits.shape == (5, LA, len(VOCAB))
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(states.numpy(), np.asarray(want_states), **BOXES)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), **BOXES)


def test_loss_and_gradients_equal_jax(vqa):
    """``loss_vqa`` (a zero-weight row, two answers of one question) and
    every parameter's gradient."""
    model, variables, batch = vqa["model"], vqa["variables"], vqa["batch"]

    def loss(params):
        return model.apply({"params": params}, jb(batch), deterministic=True)["loss_vqa"]

    want, want_grads = jax.value_and_grad(loss)(variables["params"])
    port = vqa["port"]
    port.zero_grad(set_to_none=True)
    port.train()
    try:
        got = port(tb(batch))
        got["loss_vqa"].backward()
    finally:
        port.eval()
    assert tuple(got) == ("loss_vqa",)
    np.testing.assert_allclose(got["loss_vqa"].item(), float(want), **BOXES)
    assert_grads_equal(port, want_grads)
    dec = port.text_decoder.bert.encoder.layer[N_DEC - 1].crossattention.self.key.weight
    assert dec.grad.abs().sum() > 0
    port.zero_grad(set_to_none=True)


def test_the_train_step_takes_every_answer_row(vqa):
    """One ``make_train_step`` step over the 3 questions and 5 answer rows:
    its ``loss_vqa`` is the model's on the whole batch (no row cut to the
    question count); under accumulation the batch splits by question (3
    microbatches of one question, each with the 5 answer rows) and the
    step's ``loss_vqa`` is the unsplit one up to summation order."""
    from x2vlm_tpu_torch.train import create_optimizer, lr_schedule, make_train_step

    port = to_port(vqa["variables"], XVLMForVQA(port_config(), num_dec_layers=N_DEC,
                                                dtype=torch.float32, device="cpu",
                                                seed=None))
    batch = tb(vqa["batch"])
    with torch.no_grad():
        want = port(batch)["loss_vqa"].item()
    opt = create_optimizer(port, lr_schedule(1e-3, 10))
    fresh = {k: v.clone() for k, v in port.state_dict().items()}
    got = make_train_step(port, opt)(batch)["loss_vqa"].item()
    assert got == want
    port.load_state_dict(fresh)
    opt = create_optimizer(port, lr_schedule(1e-3, 10))
    split = make_train_step(port, opt, accum_steps=3)(batch)["loss_vqa"].item()
    np.testing.assert_allclose(split, want, **BOXES)


@pytest.mark.parametrize("k", [4, N_ANS])
def test_rank_answer_equals_jax(vqa, k):
    """The top-k answer ids equal, the scores to 1e-5, with answers tied on
    their first token (k = 4 cuts between a tied pair's members in one
    order only) and k = every answer."""
    model, variables, batch = vqa["model"], vqa["variables"], vqa["batch"]
    pred = {"image": batch["image"], "question_ids": batch["question_ids"],
            "question_atts": batch["question_atts"], "answer_ids": ANSWERS,
            "answer_atts": answer_atts(ANSWERS)}
    want_ids, want_probs = model.apply(variables, jb(pred), k, method=JaxXVLMForVQA.predict)
    with torch.no_grad():
        ids, probs = vqa["port"].predict(tb(pred), k)
    assert ids.shape == (B, k) and probs.shape == (B, k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(probs.numpy(), np.asarray(want_probs), **BOXES)


def test_top_k_orders_ties_as_jax():
    x = np.array([[0.2, 0.5, 0.5, 0.1, 0.5], [1.0, 1.0, 1.0, 1.0, 0.0]], np.float32)
    for k in (1, 2, 4, 5):
        want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
        v, i = top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(v.numpy(), np.asarray(want_v))


def test_causal_lm_loss_equals_jax():
    rng = np.random.default_rng(13)
    logits = rng.standard_normal((4, 6, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (4, 6)).astype(np.int64)
    labels[1, 3:] = -100
    labels[2, 1:] = -100          # a row with no target: 0
    want = jax_causal_lm_loss(jnp.asarray(logits), jnp.asarray(labels))
    got = causal_lm_loss(torch.from_numpy(logits), torch.from_numpy(labels))
    # the two log-softmaxes sum in another order: equal to fp32 rounding
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)
    assert got[2].item() == 0.0


@pytest.mark.parametrize("num_dec", [2, 1])
def test_decoder_params_from_text_encoder_equals_jax(vqa, num_dec):
    """The decoder from the fusion layers: layer j <- 2 + j (2 decoder
    layers over 2 fusion layers), or <- 2 + 2 j + 1 (1 over 2); the
    embeddings and the MLM head as they are."""
    base = vqa["variables"]["params"]["base"]
    rng = np.random.default_rng(14)
    head = {"transform_dense": {"kernel": rng.standard_normal((32, 32)).astype(np.float32),
                                "bias": rng.standard_normal(32).astype(np.float32)},
            "transform_ln": {"scale": rng.standard_normal(32).astype(np.float32),
                             "bias": rng.standard_normal(32).astype(np.float32)},
            "decoder_bias": rng.standard_normal(len(VOCAB)).astype(np.float32)}
    for with_head in (True, False):
        params = dict(base, **({"mlm_head": head} if with_head else {}))
        want_tree = jax_decoder_params(params, num_text_layers=2, num_cross_layers=2,
                                       num_dec_layers=num_dec)
        want, _ = convert_jax_params(_flatten(dict(want_tree, vision_encoder=base[
            "vision_encoder"], text_encoder=base["text_encoder"])), device="cpu")
        want = {k: v for k, v in want.items() if k.startswith("text_decoder.")}
        state, _ = convert_jax_params(_flatten(params), device="cpu")
        got = decoder_params_from_text_encoder(state, num_text_layers=2, num_cross_layers=2,
                                               num_dec_layers=num_dec)
        assert set(got) == set(want)
        assert any(k.startswith("text_decoder.cls.") for k in got) == with_head
        for k, v in got.items():
            assert torch.equal(v, want[k]), k
    with pytest.raises(ValueError, match="not implemented"):
        decoder_params_from_text_encoder(state, num_text_layers=2, num_cross_layers=2,
                                         num_dec_layers=3)


class _Routes:
    """Counts the attention calls of ``MultiHeadAttention`` by route (the
    tiny kernel's wrapper, the flash kernel's, the plain core), each still
    running what it wraps."""

    def __init__(self, monkeypatch):
        self.calls = {"tiny": 0, "flash": 0, "plain": 0}
        for route, name in (("tiny", "tiny_block_attention"), ("flash", "flash_attention"),
                            ("plain", "dot_product_attention")):
            fn = getattr(port_layers, name)

            def counted(*a, _fn=fn, _route=route, **kw):
                self.calls[_route] += 1
                return _fn(*a, **kw)

            monkeypatch.setattr(port_layers, name, counted)


@pytest.mark.parametrize("sq", [1, 10, 40, 64])
@torch.no_grad()
def test_causal_attention_never_takes_the_tiny_kernel(monkeypatch, sq):
    """A causal self-attention at a length the tiny kernel takes runs the
    plain core with the causal mask (its output that of an explicit
    lower-triangular softmax; position t blind to later tokens); the same
    call without ``causal`` takes the tiny kernel."""
    gen = torch.Generator().manual_seed(sq)
    mha = port_layers.MultiHeadAttention(32, 2, dtype=torch.float32, device="cpu")
    port_layers.init_weights(mha, gen)
    x = torch.randn(2, sq, 32, generator=gen)
    key_mask = torch.ones(2, sq, dtype=torch.int32)
    key_mask[1, sq - sq // 3:] = 0
    routes = _Routes(monkeypatch)
    out = mha(x, key_mask=key_mask, causal=True)
    assert routes.calls == {"tiny": 0, "flash": 0, "plain": 1}
    mha(x, key_mask=key_mask)
    assert routes.calls == {"tiny": 1, "flash": 0, "plain": 1}

    q, k, v = (t.reshape(2, sq, 2, 16).transpose(1, 2) for t in mha._project(x, x, 1.0))
    logits = q @ k.transpose(-1, -2) * 16 ** -0.5
    visible = torch.ones(sq, sq, dtype=torch.bool).tril()[None, None] & \
        (key_mask != 0)[:, None, None, :]
    want = torch.softmax(logits.masked_fill(~visible, NEG_INF), -1) @ v
    np.testing.assert_allclose(out.numpy(), want.transpose(1, 2).reshape(2, sq, 32).numpy(),
                               rtol=1e-5, atol=1e-6)
    if sq > 1:
        x2 = x.clone()
        x2[:, -1] += 1.0
        out2 = mha(x2, key_mask=key_mask, causal=True)
        np.testing.assert_array_equal(out2[:, :-1].numpy(), out[:, :-1].numpy())


def test_the_decoder_routes_self_attention_plain_and_cross_attention_tiny(vqa, monkeypatch):
    """One decoder pass: each layer's causal self-attention on the plain
    core, its cross-attention to the question states on the tiny kernel."""
    batch = tb(vqa["batch"])
    port = vqa["port"]
    with torch.no_grad():
        states = port.encode_question(batch["image"], batch["question_ids"],
                                      batch["question_atts"])
        routes = _Routes(monkeypatch)
        port.decode_logits(batch["answer_ids"][:B], batch["answer_atts"][:B], states,
                           batch["question_atts"])
    assert routes.calls == {"tiny": N_DEC, "flash": 0, "plain": N_DEC}


@torch.no_grad()
def test_a_causal_call_past_the_tiny_lengths_takes_the_flash_kernel(monkeypatch):
    """Sq = Skv = 128 at D = 64: the flash kernel with its causal mask (on
    the CPU its plain version), equal to the plain core's causal output."""
    gen = torch.Generator().manual_seed(3)
    mha = port_layers.MultiHeadAttention(128, 2, dtype=torch.float32, device="cpu")
    port_layers.init_weights(mha, gen)
    x = torch.randn(2, 128, 128, generator=gen)
    routes = _Routes(monkeypatch)
    out = mha(x, causal=True)
    assert routes.calls == {"tiny": 0, "flash": 1, "plain": 0}
    q, k, v = (t.reshape(2, 128, 2, 64).transpose(1, 2) for t in mha._project(x, x, 1.0))
    want = dot_product_attention(q, k, v, causal=True)
    np.testing.assert_allclose(out.numpy(), want.transpose(1, 2).reshape(2, 128, 128).numpy(),
                               rtol=1e-5, atol=1e-5)
