"""``flat_optimizer: true`` on the CPU. The launcher's optimizer with the
key is the port's own ``AdamW``, bit for bit the one without it over 3
updates (warmup, so the first has lr 0; the clip acting on some steps and
not others; masked weight decay; the vision / text / cross / other / fresh
group scales; the temperature's projection), and within 1e-6 relative of
the JAX ``create_optimizer(flatten=True)`` on the same leaves and
gradients. It is refused under ``--fsdp`` > 1, and its saved train state
restores a run bit for bit. The JAX leaves are a flat dict under the
port's names, with the port's labels, so no JAX model is built."""

import numpy as np
import pytest
from tests.torch_threads import few_torch_threads  # noqa: E402,F401 (autouse)

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from torch import nn  # noqa: E402

from x2vlm_tpu.train import optim as jax_optim  # noqa: E402
from x2vlm_tpu_torch import run  # noqa: E402
from x2vlm_tpu_torch.train import checkpoint as ckpt_lib  # noqa: E402
from x2vlm_tpu_torch.train.optim import (  # noqa: E402
    AdamW, create_optimizer, lr_schedule, param_labels,
)

SHAPES = {
    "temp": (),
    "vision_encoder.blocks.0.attn.qkv.weight": (12, 6),
    "vision_encoder.blocks.0.attn.qkv.bias": (12,),
    "vision_encoder.blocks.0.norm1.weight": (6,),
    "text_encoder.bert.embeddings.word_embeddings.weight": (20, 6),
    "text_encoder.bert.encoder.layer.0.attention.self.query.weight": (6, 6),
    "text_encoder.bert.encoder.layer.3.crossattention.self.key.weight": (6, 6),
    "text_encoder.bert.encoder.layer.3.crossattention.self.key.bias": (6,),
    "itm_head.weight": (2, 6),
    "cls_head.0.weight": (4, 6),
    "cls_head.0.bias": (4,),
}
FRESH = ("cls_head.0.weight", "cls_head.0.bias")
GROUPS = dict(lr_mult=5.0, vision_lr_scale=2.0, text_lr_scale=0.5, cross_lr_scale=3.0)
KW = dict(weight_decay=0.05, clip_grad_norm=1.0, **GROUPS)
LR, TOTAL, WARMUP = 1e-2, 20, 2
# the launcher's config of the same optimizer
CFG = {"optimizer": {"opt": "adamW", "lr": LR, "weight_decay": 0.05, "lr_mult": 5.0,
                     "vision_lr": 2.0 * LR, "text_lr": 0.5 * LR, "cross_lr": 3.0 * LR},
       "schedular": {"sched": "linear", "num_warmup_steps": WARMUP},
       "accelerator": {"CLIP_GRAD_NORM": 1.0}}
STEPS = 3
# a gradient scale a step: the clip acts on steps 0 and 2, not on step 1
GRAD_SCALES = (3.0, 0.01, 2.0)


class Tiny(nn.Module):
    """Parameters under ``SHAPES``' dotted names, drawn from a seed."""

    def __init__(self, seed=0):
        super().__init__()
        rng = np.random.default_rng(seed)
        for name, shape in SHAPES.items():
            *path, leaf = name.split(".")
            m = self
            for part in path:
                if not hasattr(m, part):
                    m.add_module(part, nn.Module())
                m = getattr(m, part)
            value = np.asarray(rng.standard_normal(shape) * 0.5, np.float32)
            if name == "temp":   # just above its lower bound: the projection must act
                value = np.asarray(0.0012, np.float32)
            m.register_parameter(leaf, nn.Parameter(torch.tensor(value)))


def grads(step):
    rng = np.random.default_rng(100 + step)
    return {n: np.asarray((rng.standard_normal(s) + (5.0 if n == "temp" else 0.0))
                          * GRAD_SCALES[step], np.float32) for n, s in SHAPES.items()}


def labels_of(model):
    return param_labels(model.named_parameters(), fusion_layer=2, fresh_names=FRESH)


def launcher_optimizer(model, flat=True):
    return run.make_optimizer(dict(CFG, flat_optimizer=flat), model, TOTAL, fusion_layer=2,
                              fresh_names=FRESH)


def port_run(flat, steps=STEPS, model=None, opt=None, first=0):
    """``steps`` updates from ``first``: the launcher's optimizer (``flat``:
    with ``flat_optimizer: true``), or ``create_optimizer`` directly."""
    model = model or Tiny()
    if opt is None and flat is None:
        opt = create_optimizer(model, lr_schedule(LR, TOTAL, warmup_steps=WARMUP),
                               labels=labels_of(model), **KW)
    opt = opt or launcher_optimizer(model, flat)
    for step in range(first, first + steps):
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(grads(step)[n])
        opt.step()
    return model, opt


@pytest.mark.parametrize("flat", [True, False])
def test_the_flat_update_equals_adamw_bit_for_bit(flat):
    """The launcher's optimizer, with the key and without, against
    ``create_optimizer``'s AdamW."""
    tree_model, tree_opt = port_run(None)
    model, opt = port_run(flat)
    assert type(opt) is AdamW and len(opt.groups) >= 6   # every group its own
    assert {s for (_, s), _ in opt.groups} == {1.0, 2.0, 0.5, 3.0, 5.0}
    for (n, a), (_, b) in zip(tree_model.named_parameters(), model.named_parameters()):
        assert torch.equal(a, b), n
    for m_tree, m in zip(tree_opt.full_moments(), opt.full_moments()):
        for a, b in zip(m_tree, m):
            assert torch.equal(a, b)
    assert abs(model.temp.item() - 0.001) < 1e-7   # projected onto its lower bound


def test_the_flat_update_equals_the_jax_flat_adamw():
    model, _ = port_run(True)
    init = Tiny()
    params = {n: jnp.asarray(p.detach().numpy()) for n, p in init.named_parameters()}
    labels = labels_of(init)
    tx = jax_optim.create_optimizer(
        params, jax_optim.lr_schedule(LR, TOTAL, warmup_steps=WARMUP), flatten=True,
        labels={n: labels[n] for n in params}, **KW)
    state = tx.init(params)
    for step in range(STEPS):
        g = {n: jnp.asarray(v) for n, v in grads(step).items()}
        u, state = tx.update(g, state, params)
        params = optax.apply_updates(params, u)
    for n, p in model.named_parameters():
        want = np.asarray(params[n], np.float64)
        err = np.linalg.norm(p.detach().double().numpy() - want)
        assert err <= 1e-6 * max(np.linalg.norm(want), 1e-30), (n, err)


def test_flat_optimizer_is_refused_with_fsdp(monkeypatch):
    monkeypatch.setattr(run.mesh, "fsdp_size", lambda: 2)
    with pytest.raises(ValueError, match="--fsdp 1"):
        launcher_optimizer(Tiny())


def test_a_saved_flat_state_resumes_bit_for_bit(tmp_path):
    """1 update, save, a fresh model and optimizer restored from the file,
    2 more: the parameters and moments of the 3-update run bit for bit."""
    whole_model, whole_opt = port_run(True)
    model, opt = port_run(True, steps=1)
    ckpt_lib.save_train_state(str(tmp_path), model, opt, step=1)
    saved = torch.load(tmp_path / ckpt_lib.TRAIN_STATE_FILE, weights_only=False)
    for part in ("mu", "nu"):
        for n, t in saved[part].items():
            assert t.shape == SHAPES[n], (part, n)
    fresh = Tiny(seed=7)
    fresh_opt = launcher_optimizer(fresh)
    step, _ = ckpt_lib.restore_train_state(str(tmp_path), fresh, fresh_opt)
    assert step == 1 and fresh_opt.count == 1
    port_run(True, steps=STEPS - 1, model=fresh, opt=fresh_opt, first=1)
    for (n, a), (_, b) in zip(whole_model.named_parameters(), fresh.named_parameters()):
        assert torch.equal(a, b), n
    for m_whole, m_res in zip(whole_opt.full_moments(), fresh_opt.full_moments()):
        for a, b in zip(m_whole, m_res):
            assert torch.equal(a, b)
