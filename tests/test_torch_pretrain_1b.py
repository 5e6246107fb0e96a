"""The paths the 1B pretraining configs add, against the JAX package on the CPU.

- The clean-data aux replacement and ``stop_calc_itm`` through both
  packages' ``pretrain_loop``: with the grad functions stubbed, each call's
  batch, loss weight and matching-loss flag over 10 steps (the aux draw on
  the loop's host ``random.Random``; noisy image batches never match; from
  the threshold on neither the aux nor the region stream does); with the
  real models (fp32, every dropout at 0, ``stop_calc_itm`` 0, so no hard
  negative is drawn) two steps of an aux, a noisy and a region batch: each
  step's losses and summed gradients, rtol = atol = 1e-4 (the tolerance of
  test_torch_pretrain.py).
- The 24-layer text stack that fuses from layer 18 (``x2vlm_large_1b.yaml``'s
  split) at tiny widths: one pretraining step's losses and every gradient
  against ``jax.value_and_grad`` with the JAX negatives injected, and the
  reference names of layers 18-23 (self- and cross-attention) both ways
  through ``convert.py``.
"""

import copy
import itertools
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests.test_torch_pretrain import TOL, VISION, TEXT, _batch, _features, _noisy  # noqa: E402
from tests.test_torch_region import _image_batch, region  # noqa: E402,F401
from x2vlm_tpu.models import (  # noqa: E402
    BEiT2Config as JaxBEiT2Config, BertConfig as JaxBertConfig,
    XVLMConfig as JaxXVLMConfig, XVLMForPretrain as JaxXVLMForPretrain,
)
from x2vlm_tpu.models.heads import pretrain_init_inputs  # noqa: E402
from x2vlm_tpu.serving import _flatten  # noqa: E402
from x2vlm_tpu.tasks import pretrain as jax_loop_mod  # noqa: E402
from x2vlm_tpu.train import create_optimizer as jax_create_optimizer  # noqa: E402
from x2vlm_tpu.train import create_train_state, lr_schedule as jax_lr_schedule  # noqa: E402
from x2vlm_tpu.train.metrics import MetricLogger as JaxMetricLogger  # noqa: E402
from x2vlm_tpu_torch.convert import convert_jax_params, to_jax_params  # noqa: E402
from x2vlm_tpu_torch.models import (  # noqa: E402
    BEiT2Config, BertConfig, XVLMConfig, XVLMForPretrain,
)
from x2vlm_tpu_torch.models.xvlm import XVLMBase  # noqa: E402
from x2vlm_tpu_torch.run import to_device  # noqa: E402
from x2vlm_tpu_torch.tasks import pretrain as loop_mod  # noqa: E402
from x2vlm_tpu_torch.train import create_optimizer, lr_schedule  # noqa: E402
from x2vlm_tpu_torch.train.metrics import MetricLogger  # noqa: E402



@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Tiny models: a few CPU threads each (the suite runs on several
    workers at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)

# ---- the aux replacement and stop_calc_itm ----

def _stub_streams(mod):
    def it(name):
        return iter({"tag": f"{name}{i}"} for i in range(100))
    return mod.PretrainStreams(image=it("image"), aux=it("aux"), region=it("region"),
                               image_weight=1.0, region_weight=0.5, aux_perc=0.4,
                               rng=random.Random(2))


def test_aux_draws_and_stop_calc_itm_equal_jax(monkeypatch):
    """Over 10 steps with ``aux_iter_perc`` 0.4 and ``stop_calc_itm`` 4:
    each grad call's loss weight, matching flag and batch equal the JAX
    loop's; noisy image batches never match, aux and region batches match
    before step 4 and not from it on; both kinds fall on each side."""
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
    jax_loop_mod.pretrain_loop(None, state, None, _stub_streams(jax_loop_mod), num_steps=10,
                               rng_key=jax.random.PRNGKey(0), stop_calc_itm_after=4,
                               log_every=100)
    loop_mod.pretrain_loop(torch.nn.Linear(1, 1), type("Opt", (), {"params": []})(),
                           _stub_streams(loop_mod), num_steps=10, seed=0,
                           to_device=lambda b: b, stop_calc_itm_after=4, log_every=100)
    assert calls["port"] == calls["jax"] and len(calls["port"]) == 20
    image = calls["port"][0::2]
    region_calls = calls["port"][1::2]
    assert [itm for _, itm, _ in region_calls] == [step < 4 for step in range(10)]
    kinds = []
    for step, (_, itm, tag) in enumerate(image):
        aux = tag.startswith("aux")
        assert itm == (aux and step < 4), (step, tag, itm)
        kinds.append((aux, step < 4))
    assert set(kinds) == {(True, True), (False, True), (True, False), (False, False)}


def _aux_batch(b):
    """Another image-stream batch: the image batch's texts rolled by a row."""
    out = dict(b)
    for k in ("text_ids", "text_atts", "text_ids_masked", "masked_pos", "masked_ids"):
        out[k] = np.roll(b[k], 1, axis=0)
    return out


class _Rows:
    """A logger that also keeps each step's metrics."""

    def __init__(self, base):
        self.rows = []
        self.base = base

    def update(self, **kw):
        self.rows.append({k: float(v) for k, v in kw.items()})
        self.base.update(**kw)

    def __getattr__(self, name):
        return getattr(self.base, name)


def _jax_loop_steps(region, monkeypatch):
    grads = []
    monkeypatch.setattr(jax_loop_mod, "make_apply_grads",
                        lambda tx: lambda state, g: (grads.append(g), state)[1])
    b = region["batch"]
    tx = jax_create_optimizer(region["variables"]["params"], jax_lr_schedule(1e-3, 10))
    streams = jax_loop_mod.PretrainStreams(
        image=itertools.repeat(_image_batch(b)), aux=itertools.repeat(_aux_batch(_image_batch(b))),
        region=itertools.repeat(b), region_weight=0.5, aux_perc=0.5, rng=random.Random(1))
    logger = _Rows(JaxMetricLogger())
    jax_loop_mod.pretrain_loop(
        region["model"], create_train_state(region["variables"], tx), tx, streams, num_steps=2,
        rng_key=jax.random.PRNGKey(5), stop_calc_itm_after=0,
        shard_fn=lambda x: jax.tree_util.tree_map(jnp.asarray, x), log_every=10, logger=logger)
    return logger.rows, [convert_jax_params(_flatten(g), device="cpu")[0] for g in grads]


def _port_loop_steps(region, monkeypatch):
    port = copy.deepcopy(region["port"])
    grads = []

    def make_apply_grads(opt):
        def apply():
            grads.append({n: (p.grad.clone() if p.grad is not None else torch.zeros_like(p))
                          for n, p in port.base.named_parameters()})
            for p in port.parameters():
                p.grad = None
            return torch.zeros(())
        return apply

    monkeypatch.setattr(loop_mod, "make_apply_grads", make_apply_grads)
    b = region["batch"]
    streams = loop_mod.PretrainStreams(
        image=itertools.repeat(_image_batch(b)), aux=itertools.repeat(_aux_batch(_image_batch(b))),
        region=itertools.repeat(b), region_weight=0.5, aux_perc=0.5, rng=random.Random(1))
    logger = _Rows(MetricLogger())
    loop_mod.pretrain_loop(port, create_optimizer(port, lr_schedule(1e-3, 10)), streams,
                           num_steps=2, seed=0, stop_calc_itm_after=0, log_every=10,
                           to_device=lambda x: to_device(x, torch.device("cpu")), logger=logger)
    return logger.rows, grads


def test_aux_noisy_and_region_steps_without_matching_equal_jax(region, monkeypatch):  # noqa: F811
    """Two steps (the loop's draw at ``random.Random(1)``, ``aux_iter_perc``
    0.5: an aux batch, then a noisy one) past ``stop_calc_itm`` 0: each
    step's losses and summed gradients equal the JAX loop's; the two image
    batches differ, so the draw shows in the losses."""
    want_rows, want_grads = _jax_loop_steps(region, monkeypatch)
    got_rows, got_grads = _port_loop_steps(region, monkeypatch)
    draws = random.Random(1)
    assert [draws.random() < 0.5 for _ in range(2)] == [True, False]
    assert len(got_rows) == len(want_rows) == 2
    for got, want in zip(got_rows, want_rows):
        assert got["image_loss_itm"] == got["region_loss_itm"] == 0.0
        for k, v in want.items():
            if k != "grad_norm":
                np.testing.assert_allclose(got[k], v, err_msg=k, **TOL)
    assert abs(got_rows[0]["image_loss_mlm"] - got_rows[1]["image_loss_mlm"]) > 1e-3
    for got, want in zip(got_grads, want_grads):
        assert set(got) == set(want)
        for name, g in got.items():
            np.testing.assert_allclose(g.numpy(), want[name].numpy(), err_msg=name, **TOL)


# ---- the 24-layer text stack that fuses from 18 ----

TEXT_24 = dict(TEXT, num_layers=24, fusion_layer=18)


@pytest.fixture(scope="module")
def stack24():
    rng = np.random.default_rng(24)
    jcfg = JaxXVLMConfig(vision=JaxBEiT2Config(**VISION), text=JaxBertConfig(**TEXT_24),
                         embed_dim=16)
    model = JaxXVLMForPretrain(jcfg, dtype=jnp.float32)
    init = model.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                      pretrain_init_inputs(jcfg), rng=jax.random.PRNGKey(2), ret_bbox_loss=True)
    variables = _noisy(init, rng)
    return model, variables, rng


def test_24_layer_stack_fusing_from_18_matches_jax(stack24):
    model, variables, rng = stack24
    batch = _batch(rng)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(9)

    def negs(m, b, key):
        i_f, t_f = _features(m, b)
        return m.base.get_hard_negatives(i_f, t_f, key)

    neg_idx = [np.array(x) for x in model.apply(variables, jbatch, key, method=negs)]

    def loss_fn(params):
        losses = model.apply({"params": params}, jbatch, rng=key, deterministic=True)
        return sum(losses.values()), losses

    (_, want), grads = jax.value_and_grad(loss_fn, has_aux=True)(variables["params"])
    state, unused = convert_jax_params(_flatten(variables), device="cpu")
    assert unused == []
    port = XVLMForPretrain(XVLMConfig(vision=BEiT2Config(**VISION), text=BertConfig(**TEXT_24),
                                      embed_dim=16), dtype=torch.float32, device="cpu", seed=None)
    port.base.load_state_dict(state)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = port(tb, neg_idx=tuple(torch.from_numpy(x).long() for x in neg_idx))
    sum(got.values()).backward()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].item(), float(v), err_msg=k, **TOL)
    want_grads, _ = convert_jax_params(_flatten(grads), device="cpu")
    params = dict(port.base.named_parameters())
    assert set(params) == set(want_grads)
    for name, p in params.items():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        assert p.grad is not None or name.startswith("bbox_head."), name
        np.testing.assert_allclose(g.numpy(), want_grads[name].numpy(), err_msg=name, **TOL)


def test_24_layer_stack_names_round_trip(stack24):
    """Layers 0-17 have no cross-attention, 18-23 have it, under the
    reference names; ``to_jax_params`` gives the JAX tree back bit for bit."""
    _, variables, _ = stack24
    flat = _flatten(variables)
    state, _ = convert_jax_params(flat, device="cpu")
    p = "text_encoder.bert.encoder.layer."
    cross = {int(k[len(p):].split(".")[0]) for k in state
             if k.startswith(p) and ".crossattention." in k}
    layers = {int(k[len(p):].split(".")[0]) for k in state if k.startswith(p)}
    assert layers == set(range(24)) and cross == set(range(18, 24))
    back = to_jax_params({f"base.{k}": v for k, v in XVLMBase_state(state).items()})
    want = {k: np.asarray(v, np.float32) for k, v in flat.items() if k.startswith("params/")}
    assert set(back) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def XVLMBase_state(state):
    """``state`` through a port model and out again: the names the port saves."""
    base = XVLMForPretrain(XVLMConfig(vision=BEiT2Config(**VISION), text=BertConfig(**TEXT_24),
                                      embed_dim=16), dtype=torch.float32, device="cpu",
                           seed=None).base
    base.load_state_dict(state)
    assert isinstance(base, XVLMBase)
    return base.state_dict()
