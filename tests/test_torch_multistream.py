"""The multi-stream pretraining step and ``ret_match_loss=False`` against
the JAX package: the image stream (with and without the matching loss) and
the text stream, each weighted by its ``iter_perc`` (0.7 / 0.3), their
gradients summed as ``make_grad_fn`` + ``tree_add`` sum them. Losses and
every parameter's gradient in fp32, rtol = atol = 1e-4 (the setup and
tolerance of test_torch_pretrain.py)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests.test_torch_pretrain import (  # noqa: E402
    PORT_CONFIG, TOL, _batch, _features, _jax_config, _noisy, _port_grads_by_jax_tree,
)
from x2vlm_tpu.models import XVLMForPretrain as JaxXVLMForPretrain  # noqa: E402
from x2vlm_tpu.models.heads import pretrain_init_inputs  # noqa: E402
from x2vlm_tpu.serving import _flatten  # noqa: E402
from x2vlm_tpu.train.trainer import make_grad_fn as jax_make_grad_fn, tree_add  # noqa: E402
from x2vlm_tpu_torch.convert import convert_jax_params  # noqa: E402
from x2vlm_tpu_torch.models import XVLMForPretrain  # noqa: E402
from x2vlm_tpu_torch.train import (  # noqa: E402
    create_optimizer, lr_schedule, make_apply_grads, make_grad_fn,
)

W_IMAGE, W_TEXT = 0.7, 0.3


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(11)
    cfg = _jax_config()
    model = JaxXVLMForPretrain(cfg, dtype=jnp.float32)
    init = model.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                      pretrain_init_inputs(cfg), rng=jax.random.PRNGKey(2), ret_bbox_loss=True)
    variables = _noisy(init, rng)
    image_batch = _batch(rng)
    text_batch = {k: v for k, v in _batch(rng).items() if k != "image"}
    state, _ = convert_jax_params(_flatten(variables), device="cpu")
    port = XVLMForPretrain(PORT_CONFIG, dtype=torch.float32, device="cpu", seed=None)
    port.base.load_state_dict(state)
    return dict(model=model, params=variables["params"], variables=variables, port=port,
                image=image_batch, text=text_batch)


def _jax_step(s, itm, key):
    """The JAX package's per-stream gradients, summed, and the losses."""
    image = {k: jnp.asarray(v) for k, v in s["image"].items()}
    text = dict({k: jnp.asarray(v) for k, v in s["text"].items()}, image=None)
    g1, l1 = jax_make_grad_fn(s["model"], loss_scale=W_IMAGE,
                              apply_kwargs={"ret_match_loss": itm, "deterministic": True})(
        s["params"], image, jax.random.fold_in(key, 0))
    g2, l2 = jax_make_grad_fn(s["model"], loss_scale=W_TEXT,
                              apply_kwargs={"deterministic": True})(
        s["params"], text, jax.random.fold_in(key, 3))
    return tree_add(g1, g2), {**{f"image_{k}": float(v) for k, v in l1.items()},
                              **{f"text_{k}": float(v) for k, v in l2.items()}}


def _jax_negatives(s, key):
    rng_itm, _ = jax.random.split(jax.random.fold_in(key, 0))
    image = {k: jnp.asarray(v) for k, v in s["image"].items()}

    def negs(m, b, k):
        i_f, t_f = _features(m, b)
        return m.base.get_hard_negatives(i_f, t_f, k)

    return tuple(torch.from_numpy(np.array(x)).long()
                 for x in s["model"].apply(s["variables"], image, rng_itm, method=negs))


@pytest.mark.parametrize("itm", [False, True])
def test_multi_stream_step_matches_jax(setup, itm):
    s = setup
    key = jax.random.PRNGKey(5)
    want_grads, want = _jax_step(s, itm, key)
    port = s["port"]
    port.zero_grad(set_to_none=True)
    kwargs = {"ret_match_loss": itm}
    if itm:
        kwargs["neg_idx"] = _jax_negatives(s, key)
    image = {k: torch.from_numpy(v) for k, v in s["image"].items()}
    text = dict({k: torch.from_numpy(v) for k, v in s["text"].items()}, image=None)
    got = {f"image_{k}": v.item() for k, v in make_grad_fn(
        port, loss_scale=W_IMAGE, apply_kwargs=kwargs)(image).items()}
    got.update({f"text_{k}": v.item() for k, v in make_grad_fn(
        port, loss_scale=W_TEXT)(text).items()})
    port.eval()
    assert set(got) == set(want)
    if not itm:
        assert got["image_loss_itm"] == 0.0
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, err_msg=k, **TOL)
    grads = _port_grads_by_jax_tree(want_grads)
    for name, p in port.base.named_parameters():
        # a parameter no stream reached (the bbox head, which only the region
        # stream trains; the ITM head without the matching loss) has no
        # .grad, which AdamW reads as zeros, as JAX's zeros
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        assert p.grad is not None or name.startswith("bbox_head.") or (
            not itm and name.startswith("itm_head.")), name
        np.testing.assert_allclose(g.numpy(), grads[name].numpy(), err_msg=name, **TOL)


def test_apply_grads_steps_once_and_clears(setup):
    port = XVLMForPretrain(PORT_CONFIG, dtype=torch.float32, device="cpu", seed=3)
    opt = create_optimizer(port, lr_schedule(1e-3, 10, 0))
    before = {n: p.detach().clone() for n, p in port.named_parameters()}
    text = dict({k: torch.from_numpy(v) for k, v in setup["text"].items()}, image=None)
    make_grad_fn(port, loss_scale=0.5)(text)
    norm = make_apply_grads(opt)()
    assert opt.count == 1 and torch.isfinite(norm)
    assert all(p.grad is None for p in opt.params)
    assert any(not torch.equal(p, before[n]) for n, p in port.named_parameters())
