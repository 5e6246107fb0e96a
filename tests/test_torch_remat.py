"""Rematerialisation (``x2vlm_tpu_torch/ops/remat.py``) and the VQA
accumulation split, in fp32 on the CPU at tiny sizes.

- Under each policy (``None`` / full, ``dots``, ``dots_saveable``,
  ``nothing``) the port's remat step equals the JAX package's remat step
  (``nn.remat`` under ``checkpoint_policy``): BEiT-2 with the BERT text,
  fusion and decoder stacks (an ``XVLMForVQA``), the Plus base's cross
  encoder with its RoBERTa-form text tower and decoder (an ``XVLMForVQA``
  on an ``XVLMPlusConfig``), and the CLIP ViT, Swin and ViT towers; the
  loss to 1e-5 and every gradient to 1e-4, the JAX parameters carried
  across by ``convert.py``. Each block of each stack is checked to have
  gone through the checkpoint.
- With dropout and drop-path on, the port's remat step equals its plain
  step bit for bit (loss, every gradient) and leaves the dropout generator
  where the plain step leaves it, in one step and with ``accum_steps=2``.
- ``dots`` saves the weight matmuls (the backward recomputes none of them),
  ``dots_saveable`` also the batched products, full and ``nothing`` none.
- A VQA batch under ``accum_steps`` 2 and 4 (split by question) equals the
  JAX package's unsplit step, every microbatch of one shape.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from tests.test_torch_grounding import TEXT, VISION, assert_grads_equal  # noqa: E402
from tests.test_torch_iglue import ANSWERS as PLUS_ANSWERS  # noqa: E402
from tests.test_torch_iglue import _rows, _text  # noqa: E402
from tests.test_torch_pretrain import _noisy  # noqa: E402
from tests.test_torch_towers import (  # noqa: E402
    TOWERS, _grads_as_jax, _noisy as _noisy_tower, _port_tower,
)
from tests.test_torch_vqa import ANSWERS, answer_atts, jb, tb  # noqa: E402
from x2vlm_tpu.models import BEiT2Config as JaxBEiT2Config  # noqa: E402
from x2vlm_tpu.models import BertConfig as JaxBertConfig  # noqa: E402
from x2vlm_tpu.models import XVLMConfig as JaxXVLMConfig  # noqa: E402
from x2vlm_tpu.models.generation import XVLMForVQA as JaxXVLMForVQA  # noqa: E402
from x2vlm_tpu.models.xvlm_plus import XVLMPlusConfig as JaxXVLMPlusConfig  # noqa: E402
from x2vlm_tpu.ops.layers import checkpoint_policy as jax_checkpoint_policy  # noqa: E402
from x2vlm_tpu.serving import _flatten  # noqa: E402
from x2vlm_tpu_torch import factory  # noqa: E402
from x2vlm_tpu_torch.convert import convert_jax_params  # noqa: E402
from x2vlm_tpu_torch.models import (  # noqa: E402
    BEiT2Config, BertConfig, XVLMConfig, XVLMForVQA, XVLMPlusConfig,
)
from x2vlm_tpu_torch.ops import remat  # noqa: E402
from x2vlm_tpu_torch.train import create_optimizer, lr_schedule, make_train_step  # noqa: E402
from x2vlm_tpu_torch.train.trainer import split_batch  # noqa: E402

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)
POLICIES = (None, "dots", "dots_saveable", "nothing")
N_DEC = 2


def _remat(cfg, policy):
    return dataclasses.replace(cfg, remat=True, remat_policy=policy)


def _vqa_batch(rng, plus: bool, q: int = 4):
    """``q`` questions over 32 px images and 6 answer rows, unevenly over
    the questions (the last question's two rows straddle no split)."""
    if plus:
        ids, atts = _rows(rng, q, 8)
        a_ids = PLUS_ANSWERS[[0, 1, 3, 2, 5, 4]]
        a_atts = (a_ids != 1).astype(np.int32)
    else:
        ids = rng.integers(5, 30, (q, 8)).astype(np.int32)
        ids[:, 0] = 2
        atts = np.ones((q, 8), np.int32)
        atts[1, 5:] = 0
        ids = ids * atts
        a_ids = ANSWERS[[0, 1, 3, 2, 5, 4]]
        a_atts = answer_atts(a_ids)
    return {"image": rng.standard_normal((q, 32, 32, 3)).astype(np.float32),
            "question_ids": ids, "question_atts": atts,
            "answer_ids": a_ids, "answer_atts": a_atts,
            "answer_weights": np.array([0.5, 0.3, 1.0, 0.2, 0.7, 0.4], np.float32),
            "answer_index": np.array([0, 0, 1, q - 1, q - 1, 1], np.int32)}


def _vqa_configs(plus: bool, policy, remat_on: bool = True):
    """(JAX config, port config) of the tiny VQA model: BEiT-2 with the
    BERT text / fusion stack or the Plus base, remat under ``policy``."""
    if plus:
        jv, pv = JaxBEiT2Config(**VISION), BEiT2Config(**VISION)
        jt, pt = _text(JaxBertConfig), _text(BertConfig)
        jcfg = JaxXVLMPlusConfig(vision=jv, text=jt, embed_dim=16, num_cross_layers=2)
        pcfg = XVLMPlusConfig(vision=pv, text=pt, embed_dim=16, num_cross_layers=2)
    else:
        jcfg = JaxXVLMConfig(vision=JaxBEiT2Config(**VISION), text=JaxBertConfig(**TEXT),
                             embed_dim=16)
        pcfg = XVLMConfig(vision=BEiT2Config(**VISION), text=BertConfig(**TEXT), embed_dim=16)
    if remat_on:
        jcfg = dataclasses.replace(jcfg, vision=_remat(jcfg.vision, policy),
                                   text=_remat(jcfg.text, policy))
        pcfg = dataclasses.replace(pcfg, vision=_remat(pcfg.vision, policy),
                                   text=_remat(pcfg.text, policy))
    return jcfg, pcfg


@pytest.fixture(scope="module", params=["bert", "plus"])
def vqa_pair(request):
    """The tiny VQA model (JAX, plain) with seeded noise on every leaf, its
    batch, and the JAX variables."""
    plus = request.param == "plus"
    rng = np.random.default_rng(18 + plus)
    jcfg, _ = _vqa_configs(plus, None, remat_on=False)
    model = JaxXVLMForVQA(jcfg, num_dec_layers=N_DEC, pad_token_id=int(plus),
                          dtype=jnp.float32)
    batch = _vqa_batch(rng, plus)
    init = model.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                      jb(batch))
    return dict(plus=plus, variables=_noisy(init, rng), batch=batch)


def _port_vqa(pcfg, variables, plus):
    port = XVLMForVQA(pcfg, num_dec_layers=N_DEC, pad_token_id=int(plus),
                      dtype=torch.float32, device="cpu", seed=None)
    state, unused = convert_jax_params(_flatten(variables), device="cpu")
    assert unused == [] and set(state) == set(port.state_dict())
    port.load_state_dict(state)
    return port


def _jax_vqa_loss_and_grads(vqa_pair, policy):
    """The JAX remat step's loss and gradients on the pair's batch, once a
    (model, policy)."""
    key = ("jax", policy)
    if key in vqa_pair:
        return vqa_pair[key]
    plus, variables, batch = vqa_pair["plus"], vqa_pair["variables"], vqa_pair["batch"]
    jcfg, _ = _vqa_configs(plus, policy)
    model = JaxXVLMForVQA(jcfg, num_dec_layers=N_DEC, pad_token_id=int(plus),
                          dtype=jnp.float32)

    def loss(params):
        return model.apply({"params": params}, jb(batch), deterministic=True)["loss_vqa"]

    vqa_pair[key] = jax.value_and_grad(loss)(variables["params"])
    return vqa_pair[key]


def _vqa_blocks(pcfg):
    """The blocks a VQA step rematerialises: the vision tower's, the text
    and fusion stack's (or the Plus text tower's and cross encoder's) and
    the decoder's."""
    text = pcfg.text.num_layers + (pcfg.num_cross_layers if pcfg.is_plus else 0)
    return {"BEiT2Block": pcfg.vision.depth, "BertLayer": text + N_DEC}


# ---- the remat step against the JAX package's remat step ----

@pytest.mark.parametrize("policy", POLICIES, ids=str)
def test_vqa_remat_step_equals_jax_remat_step(vqa_pair, policy):
    """BEiT-2, the text, fusion and decoder stacks (``bert``) or the Plus
    text tower, cross encoder and decoder (``plus``) under ``policy``."""
    plus, variables, batch = vqa_pair["plus"], vqa_pair["variables"], vqa_pair["batch"]
    _, pcfg = _vqa_configs(plus, policy)
    want, want_grads = _jax_vqa_loss_and_grads(vqa_pair, policy)
    port = _port_vqa(pcfg, variables, plus)
    port.train()
    remat.rematerialised.calls.clear()
    got = port(tb(batch))
    got["loss_vqa"].backward()
    assert dict(remat.rematerialised.calls) == _vqa_blocks(pcfg)
    np.testing.assert_allclose(got["loss_vqa"].item(), float(want), **FWD)
    assert_grads_equal(port, want_grads)


@pytest.fixture(scope="module", params=["clip_gelu", "swin", "vit"])
def tower_pair(request):
    jax_cls, jax_cfg_cls, cls, cfg_cls, kw = TOWERS[request.param]
    rng = np.random.default_rng(sorted(TOWERS).index(request.param) + 18)
    pixels = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    jax_model = jax_cls(jax_cfg_cls(**kw), dtype=jnp.float32)
    variables = _noisy_tower(jax_model.init(jax.random.PRNGKey(0), jnp.asarray(pixels)), rng)
    cot = rng.standard_normal(jax.eval_shape(jax_model.apply, variables, pixels).shape)
    return dict(name=request.param, classes=(jax_cls, jax_cfg_cls, cls, cfg_cls), kw=kw,
                variables=variables, pixels=pixels, cot=cot.astype(np.float32))


@pytest.mark.parametrize("policy", POLICIES, ids=str)
def test_tower_remat_step_equals_jax_remat_step(tower_pair, policy):
    """CLIP ViT, Swin and ViT under ``policy``: the output and every
    gradient against ``jax.vjp`` of the JAX remat tower."""
    jax_cls, jax_cfg_cls, cls, cfg_cls = tower_pair["classes"]
    kw = dict(tower_pair["kw"], remat=True, remat_policy=policy)
    variables, pixels, cot = tower_pair["variables"], tower_pair["pixels"], tower_pair["cot"]
    jax_model = jax_cls(jax_cfg_cls(**kw), dtype=jnp.float32)

    @jax.jit
    def forward_and_vjp(v):
        out, vjp = jax.vjp(lambda w: jax_model.apply(w, jnp.asarray(pixels)), v)
        return out, vjp(jnp.asarray(cot))[0]

    out, grads = forward_and_vjp(variables)
    want = _flatten(grads["params"])
    port = _port_tower(cls, cfg_cls(**kw), variables)
    port.train()
    remat.rematerialised.calls.clear()
    got = port(torch.from_numpy(pixels))
    (got * torch.from_numpy(cot)).sum().backward()
    n_blocks = sum(port.config.depths) if hasattr(port.config, "depths") else port.config.depth
    assert sum(remat.rematerialised.calls.values()) == n_blocks
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), **FWD)
    grads = _grads_as_jax(((n, p.grad) for n, p in port.named_parameters()),
                          "vision_encoder.")
    assert set(grads) == {f"vision_encoder/{k}" for k in want}
    for k, w in want.items():
        np.testing.assert_allclose(grads[f"vision_encoder/{k}"], np.asarray(w), err_msg=k,
                                   **GRAD)


# ---- the remat step against the port's plain step, dropout on ----

def _dropout_vqa(plus: bool, policy, remat_on: bool):
    """The tiny VQA model with every dropout and drop-path on."""
    _, pcfg = _vqa_configs(plus, policy, remat_on)
    text = dict(hidden_dropout=0.1, attn_dropout=0.1)
    if not plus:
        text.update(text_drop_path_rate=0.1, cross_drop_path_rate=0.2)
    pcfg = dataclasses.replace(
        pcfg, vision=dataclasses.replace(pcfg.vision, drop_path_rate=0.2, dropout_rate=0.1,
                                         attn_dropout_rate=0.1),
        text=dataclasses.replace(pcfg.text, **text))
    return XVLMForVQA(pcfg, num_dec_layers=N_DEC, pad_token_id=int(plus),
                      dtype=torch.float32, device="cpu", seed=3)


def _step(model, batch, accum):
    """One ``make_train_step`` step from generators seeded 1 and 2: its
    loss, the summed gradient it applied and the dropout generator's state
    after it."""
    opt = create_optimizer(model, lr_schedule(1e-3, 10))
    applied = {}
    apply = opt.step

    def step_and_keep():
        applied.update({n: p.grad.clone() for n, p in model.named_parameters()
                        if p.grad is not None})
        return apply()

    opt.step = step_and_keep
    gens = [torch.Generator().manual_seed(s) for s in (1, 2)]
    metrics = make_train_step(model, opt, accum_steps=accum)(tb(batch), *gens)
    return metrics["loss_vqa"].item(), applied, gens[1].get_state()


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("policy", POLICIES, ids=str)
def test_remat_step_equals_the_plain_step_bit_for_bit(policy, accum):
    """BEiT-2 with the text, fusion and decoder stacks, dropout and
    drop-path on: the loss, every gradient and the dropout generator's
    state after the step equal the plain step's bit for bit."""
    batch = _vqa_batch(np.random.default_rng(5), plus=False)
    want = _step(_dropout_vqa(False, policy, False), batch, accum)
    remat.rematerialised.calls.clear()
    got = _step(_dropout_vqa(False, policy, True), batch, accum)
    assert sum(remat.rematerialised.calls.values()) == accum * (2 + 4 + N_DEC)
    assert got[0] == want[0]
    assert got[1].keys() == want[1].keys()
    for k, g in want[1].items():
        assert torch.equal(got[1][k], g), k
    assert torch.equal(got[2], want[2])


def _tower_grads(tower, pixels, cot, accum):
    """Gradients of ``accum`` forward / backward passes over halves of
    ``pixels`` (each backward before the next forward), dropout drawn from a
    generator seeded 2, and its state after."""
    gen = torch.Generator().manual_seed(2)
    tower.train()
    tower.zero_grad(set_to_none=True)
    n = pixels.shape[0] // accum
    for i in range(accum):
        out = tower(pixels[i * n:(i + 1) * n], gen)
        (out * cot[i * n:(i + 1) * n]).sum().backward()
    return {k: p.grad.clone() for k, p in tower.named_parameters()}, gen.get_state()


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("family", ["plus", "clip_gelu", "swin", "vit"])
def test_remat_equals_plain_with_drops_on_every_stack(family, accum):
    """The Plus cross encoder (its VQA step, hidden and attention dropout
    on) and the CLIP, Swin and ViT towers (attention dropout, drop-path,
    dropout) under ``dots``: bit for bit, the generator left as the plain
    pass leaves it."""
    if family == "plus":
        batch = _vqa_batch(np.random.default_rng(6), plus=True)
        want = _step(_dropout_vqa(True, "dots", False), batch, accum)
        got = _step(_dropout_vqa(True, "dots", True), batch, accum)
        assert got[0] == want[0]
        pairs = [(got[1], want[1]), ({"gen": got[2]}, {"gen": want[2]})]
    else:
        _, _, cls, cfg_cls = TOWERS[family][:4]
        kw = dict(TOWERS[family][4])
        drops = {"clip_gelu": dict(attn_dropout_rate=0.1),
                 "swin": dict(drop_path_rate=0.3),
                 "vit": dict(drop_path_rate=0.3, dropout_rate=0.1, attn_dropout_rate=0.1)}
        kw.update(drops[family])
        rng = np.random.default_rng(7)
        pixels = torch.from_numpy(rng.standard_normal((4, 32, 32, 3)).astype(np.float32))
        runs = []
        for on in (False, True):
            tower = cls(cfg_cls(**kw, remat=on, remat_policy="dots"), dtype=torch.float32,
                        device="cpu")
            from x2vlm_tpu_torch.ops.layers import init_weights
            init_weights(tower, torch.Generator().manual_seed(4))
            if not runs:
                cot = torch.randn(tower(pixels).shape, generator=torch.Generator().manual_seed(5))
            runs.append(_tower_grads(tower, pixels, cot, accum))
        (want_g, want_s), (got_g, got_s) = runs
        pairs = [(got_g, want_g), ({"gen": got_s}, {"gen": want_s})]
    for got, want in pairs:
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert torch.equal(got[k], v), k


# ---- the policies: what the backward recomputes ----

class _CountMatmuls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = {"mm": 0, "bmm": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in ("mm", "addmm"):
            self.n["mm"] += 1
        elif name in ("bmm", "baddbmm"):
            self.n["bmm"] += 1
        return func(*args, **(kwargs or {}))


def _backward_matmuls(policy, remat_on=True):
    """The matmuls a BERT stack's backward runs (its recompute among them),
    the attention on the plain core (a causal stack of 80 tokens)."""
    cfg = BertConfig(**dict(TEXT, num_layers=2, fusion_layer=2, max_position_embeddings=96,
                            is_decoder=True), remat=remat_on, remat_policy=policy)
    from x2vlm_tpu_torch.models.bert import BertEncoder
    stack = BertEncoder(cfg, dtype=torch.float32, device="cpu")
    from x2vlm_tpu_torch.ops.layers import init_weights
    init_weights(stack, torch.Generator().manual_seed(0))
    stack.train()
    ids = torch.randint(5, 30, (2, 80), generator=torch.Generator().manual_seed(1))
    enc = torch.randn(2, 6, 32, generator=torch.Generator().manual_seed(2))
    out = stack(ids, torch.ones(2, 80, dtype=torch.int32), encoder_hidden_states=enc,
                encoder_attention_mask=torch.ones(2, 6, dtype=torch.int32))
    counter = _CountMatmuls()
    with counter:
        out.sum().backward()
    return counter.n


def test_policies_save_what_they_name():
    """Full and ``nothing`` recompute every forward matmul; ``dots``
    recomputes the batched products only; ``dots_saveable`` none."""
    plain = _backward_matmuls(None, remat_on=False)
    full, nothing = _backward_matmuls(None), _backward_matmuls("nothing")
    dots, saveable = _backward_matmuls("dots"), _backward_matmuls("dots_saveable")
    assert full == nothing
    assert full["mm"] > dots["mm"] == saveable["mm"] == plain["mm"]
    assert full["bmm"] == dots["bmm"] > saveable["bmm"] == plain["bmm"]


@pytest.mark.parametrize("name", [None, "full", "dots", "dots_saveable", "nothing", "typo"],
                         ids=str)
def test_policy_names_are_the_jax_packages(name):
    """The names ``checkpoint_policy`` takes, and an unknown one refused by
    both packages, by the configs and by the factory."""
    if name == "typo":
        for fn in (remat.checkpoint_policy, jax_checkpoint_policy,
                   lambda n: BEiT2Config(remat_policy=n), lambda n: BertConfig(remat_policy=n),
                   lambda n: factory.xvlm_config_from_yaml(
                       {"image_res": 224, "remat": True, "remat_policy": n})):
            with pytest.raises(ValueError, match="remat_policy"):
                fn(name)
        return
    assert (remat.checkpoint_policy(name) is None) == (jax_checkpoint_policy(name) is None
                                                       or name == "nothing")


# ---- VQA accumulation: split by question ----

@pytest.mark.parametrize("accum", [2, 4])
def test_vqa_split_step_equals_the_jax_unsplit_step(vqa_pair, accum):
    """``make_train_step`` with ``accum_steps`` over 4 questions and 6
    answer rows (uneven over the questions): the loss and the gradient it
    applies equal the JAX package's unsplit step; every microbatch holds
    the batch's 6 answer rows, its own at their weights."""
    plus, variables, batch = vqa_pair["plus"], vqa_pair["variables"], vqa_pair["batch"]
    _, pcfg = _vqa_configs(plus, "dots")
    want, want_grads = _jax_vqa_loss_and_grads(vqa_pair, "dots")
    parts = split_batch(tb(batch), accum)
    shapes = {tuple((k, tuple(v.shape)) for k, v in p.items()) for p in parts}
    assert len(shapes) == 1 and dict(next(iter(shapes)))["answer_ids"] == (6, 5)
    assert sum(float(p["answer_weights"].sum()) for p in parts) == pytest.approx(
        float(batch["answer_weights"].sum()))
    port = _port_vqa(pcfg, variables, plus)
    opt = create_optimizer(port, lr_schedule(1e-3, 10))
    apply = opt.step

    def check_then_apply():
        assert_grads_equal(port, want_grads)
        return apply()

    opt.step = check_then_apply
    got = make_train_step(port, opt, accum_steps=accum)(tb(batch))
    np.testing.assert_allclose(got["loss_vqa"].item(), float(want), **FWD)


def test_other_batches_with_ragged_rows_still_raise():
    batch = {"image": torch.zeros(4, 2), "text_ids": torch.zeros(3, 2)}
    with pytest.raises(ValueError, match="rows"):
        split_batch(batch, 2)
    with pytest.raises(ValueError, match="does not split"):
        split_batch({"image": torch.zeros(3, 2), "answer_index": torch.zeros(5)}, 2)
