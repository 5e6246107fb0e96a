"""The untied / bottleneck MLM head (``tie_word_embeddings=False``,
``embedding_dim``) with ``label_smoothing`` and ``label_weights`` against the
JAX ``BertMLMHead``'s untied branch on the same seeded numpy weights and
inputs, in fp32: the loss and the gradients of every head weight and of
the hidden states to 1e-5, for the plain, the smoothed and the weighted
forms (the weighted one with and without smoothing)."""

import numpy as np
import pytest
from tests.torch_threads import few_torch_threads  # noqa: E402,F401 (autouse)

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from x2vlm_tpu.models.bert import (  # noqa: E402
    BertConfig as JaxBertConfig, BertMLMHead as JaxBertMLMHead,
)
from x2vlm_tpu_torch.models.bert import BertConfig, BertMLMHead  # noqa: E402

CFG = dict(vocab_size=50, hidden_size=16, embedding_dim=8, tie_word_embeddings=False,
           num_layers=1, num_heads=2, intermediate_size=32)
B, S, M = 3, 7, 4


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    hidden = rng.standard_normal((B, S, 16)).astype(np.float32)
    pos = rng.integers(0, S, (B, M)).astype(np.int32)
    labels = rng.integers(0, 50, (B, M)).astype(np.int32)
    labels[0, 1] = labels[2, 3] = -100
    weights = rng.random((B, M)).astype(np.float32)
    weights[labels == -100] = 0.0
    head = JaxBertMLMHead(JaxBertConfig(**CFG), dtype=jnp.float32)
    params = head.init(jax.random.PRNGKey(0), jnp.asarray(hidden), jnp.asarray(pos),
                       labels=jnp.asarray(labels))["params"]
    params = jax.tree_util.tree_map(
        lambda x: jnp.asarray(np.asarray(x) + 0.1 * rng.standard_normal(x.shape), jnp.float32),
        params)
    return head, params, hidden, pos, labels, weights


def port_head(params):
    head = BertMLMHead(BertConfig(**CFG), dtype=torch.float32, device="cpu")
    t = lambda x: torch.tensor(np.asarray(x))
    with torch.no_grad():
        for port, jax_name in ((head.transform.dense, "transform_dense"),
                               (head.decoder, "decoder")):
            port.weight.copy_(t(params[jax_name]["kernel"]).T)
            port.bias.copy_(t(params[jax_name]["bias"]))
        head.transform.LayerNorm.weight.copy_(t(params["transform_ln"]["scale"]))
        head.transform.LayerNorm.bias.copy_(t(params["transform_ln"]["bias"]))
    return head


@pytest.mark.parametrize("smoothing,weighted", [(0.0, False), (0.1, False), (0.0, True),
                                                (0.2, True)])
def test_untied_loss_and_gradients_equal_jax(case, smoothing, weighted):
    jax_head, params, hidden, pos, labels, weights = case
    lw = jnp.asarray(weights) if weighted else None

    def jax_loss(p, h):
        return jax_head.apply({"params": p}, h, jnp.asarray(pos), labels=jnp.asarray(labels),
                              label_weights=lw, label_smoothing=smoothing)

    want, (g_params, g_hidden) = jax.value_and_grad(jax_loss, argnums=(0, 1))(
        params, jnp.asarray(hidden))
    head = port_head(params)
    h = torch.tensor(hidden, requires_grad=True)
    got = head(h, torch.tensor(pos), None, torch.tensor(labels).long(),
               label_weights=torch.tensor(weights) if weighted else None,
               label_smoothing=smoothing)
    got.backward()
    assert abs(got.item() - float(want)) <= 1e-5 * max(1.0, abs(float(want)))
    pairs = [(h.grad, g_hidden),
             (head.transform.dense.weight.grad.T, g_params["transform_dense"]["kernel"]),
             (head.transform.dense.bias.grad, g_params["transform_dense"]["bias"]),
             (head.transform.LayerNorm.weight.grad, g_params["transform_ln"]["scale"]),
             (head.transform.LayerNorm.bias.grad, g_params["transform_ln"]["bias"]),
             (head.decoder.weight.grad.T, g_params["decoder"]["kernel"]),
             (head.decoder.bias.grad, g_params["decoder"]["bias"])]
    for i, (g, w) in enumerate(pairs):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5,
                                   err_msg=str(i))
