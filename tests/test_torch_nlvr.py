"""The NLVR2 task against the JAX package in fp32 on the CPU: ``XVLMForNLVR``
(its parameter names equal the converted JAX tree, ``temp`` and the
top-level ``cls_head`` among them; the logits; ``loss_cls`` and every
parameter's gradient against ``jax.vjp``; one train step against the JAX
``make_train_step``, ``temp`` and the fresh ``cls_head`` group included)
and ``evaluate_classification`` on an ``NLVRDataset``.

Config and tolerances: test_torch_grounding.py's (logits to 1e-5, the
rest to rtol = atol = 1e-4)."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests.test_torch_grounding import (  # noqa: E402
    BOXES, RES, TOL, assert_grads_equal, assert_params_equal, jax_config, one_step_each,
    port_config, text_batch, to_port, tokenizers, write_images,
)
from tests.test_torch_pretrain import _noisy  # noqa: E402
from x2vlm_tpu.data import (  # noqa: E402
    NLVRDataset as JaxNLVRDataset, TextPreprocessor as JaxTextPreprocessor,
)
from x2vlm_tpu.data import transforms as JT  # noqa: E402
from x2vlm_tpu.models import XVLMForNLVR as JaxXVLMForNLVR  # noqa: E402
from x2vlm_tpu.tasks import evaluate_classification as jax_evaluate  # noqa: E402
from x2vlm_tpu_torch.data import transforms as T  # noqa: E402
from x2vlm_tpu_torch.data.finetune import NLVRDataset  # noqa: E402
from x2vlm_tpu_torch.data.tokenization import TextPreprocessor  # noqa: E402
from x2vlm_tpu_torch.models import XVLMForNLVR  # noqa: E402
from x2vlm_tpu_torch.tasks.classification import evaluate_classification  # noqa: E402

B, L = 4, 8


@pytest.fixture(scope="module")
def nlvr():
    rng = np.random.default_rng(10)
    model = JaxXVLMForNLVR(jax_config(), dtype=jnp.float32)
    ids, atts = text_batch(rng)
    batch = {"image0": rng.standard_normal((B, RES, RES, 3)).astype(np.float32),
             "image1": rng.standard_normal((B, RES, RES, 3)).astype(np.float32),
             "text_ids": ids, "text_atts": atts,
             "labels": np.array([0, 1, 1, 0], np.int32)}
    init = model.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                      {k: jnp.asarray(v) for k, v in batch.items()})
    variables = _noisy(init, rng)
    port = to_port(variables, XVLMForNLVR(port_config(), dtype=torch.float32, device="cpu",
                                          seed=None))
    return dict(model=model, variables=variables, batch=batch, port=port)


def test_parameter_names_are_the_converted_jax_tree(nlvr):
    """base/{temp, vision_encoder, text_encoder} and a top-level cls_head
    over the two CLS outputs: fc1 (2w -> 4w)."""
    params = nlvr["variables"]["params"]
    assert set(params) == {"base", "cls_head"}
    assert set(params["base"]) == {"temp", "vision_encoder", "text_encoder"}
    port = nlvr["port"]
    assert {k.split(".")[0] for k in port.state_dict()} == \
        {"temp", "vision_encoder", "text_encoder", "cls_head"}
    assert port.cls_head[0].weight.shape == (128, 64)
    # a seeded model starts temp where the JAX init does
    fresh = XVLMForNLVR(port_config(), dtype=torch.float32, device="cpu", seed=0)
    assert fresh.temp.item() == pytest.approx(0.07)


def test_logits_equal_jax(nlvr):
    want = nlvr["model"].apply(nlvr["variables"], {k: jnp.asarray(v)
                                                   for k, v in nlvr["batch"].items()},
                               method=JaxXVLMForNLVR.predict)
    with torch.no_grad():
        got = nlvr["port"].predict({k: torch.from_numpy(v) for k, v in nlvr["batch"].items()})
    assert got.dtype == torch.float32 and got.shape == (B, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BOXES)


def test_loss_and_gradients_equal_jax(nlvr):
    """Every gradient, ``temp``'s (zero: nothing reads it) included."""
    model, variables, batch = nlvr["model"], nlvr["variables"], nlvr["batch"]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss(params):
        return model.apply({"params": params}, jb, deterministic=True)["loss_cls"]

    want, vjp = jax.vjp(loss, variables["params"])
    (want_grads,) = vjp(jnp.float32(1.0))
    port = nlvr["port"]
    port.zero_grad(set_to_none=True)
    port.train()
    try:
        got = port({k: torch.from_numpy(v) for k, v in batch.items()})
        got["loss_cls"].backward()
    finally:
        port.eval()
    assert tuple(got) == ("loss_cls",)
    np.testing.assert_allclose(got["loss_cls"].item(), float(want), **TOL)
    assert_grads_equal(port, want_grads)
    assert port.temp.grad is None and float(want_grads["base"]["temp"]) == 0.0
    assert port.cls_head[3].weight.grad.abs().sum() > 0
    port.zero_grad(set_to_none=True)


def test_one_train_step_equals_jax(nlvr):
    """Every parameter after one step, the fresh ``cls_head`` at lr_mult and
    ``temp`` (no gradient, no decay: it stays) included."""
    port = to_port(nlvr["variables"], XVLMForNLVR(port_config(), dtype=torch.float32,
                                                  device="cpu", seed=None))
    want = one_step_each(nlvr["model"], nlvr["variables"], port, nlvr["batch"], "cls_head")
    assert_params_equal(port, want)
    assert port.temp.item() == float(nlvr["variables"]["params"]["base"]["temp"])


def test_evaluate_classification_equals_jax(nlvr, tmp_path):
    """5 pairs at batch 2 (the last batch padded in both packages), and a
    batch of every sample at once."""
    rng = np.random.default_rng(11)
    write_images(tmp_path / "imgs", rng, 4)
    ann = [{"images": [f"im{i % 4}.png", f"im{(i + 1) % 4}.png"], "sentence": s,
            "label": "True" if i % 2 else "False"}
           for i, s in enumerate(["the dog runs over the river", "two big red houses",
                                  "a small tree on the left", "the quick brown fox",
                                  "a man on the bank"])]
    (tmp_path / "nlvr.json").write_text(json.dumps(ann))
    jax_tok, tok = tokenizers(tmp_path)
    jax_ds = JaxNLVRDataset(str(tmp_path / "nlvr.json"), JT.test_transform(RES),
                            str(tmp_path / "imgs"), JaxTextPreprocessor(jax_tok, max_tokens=L))
    ds = NLVRDataset(str(tmp_path / "nlvr.json"), T.test_transform(RES), str(tmp_path / "imgs"),
                     TextPreprocessor(tok, max_tokens=L))
    for bs in (2, 5):
        want = jax_evaluate(nlvr["model"], nlvr["variables"], jax_ds, batch_size=bs)
        got = evaluate_classification(nlvr["port"], ds, device="cpu", batch_size=bs)
        assert got == want and got["n"] == 5
