"""The port's data-parallel step at world 2 (gloo on the CPU, spawned ranks)
against its world-1 step, and the parts that differ by world size against
the JAX functions on the global inputs.

One spawn (``tests/torch_dist.py``) runs every world-2 check:

(a) the pretraining step (``make_grad_fn`` + the gradient all-reduce) on 3
    rows a rank equals the world-1 step on the 6 rows in rank order: every
    loss (the mean over the ranks) and every all-reduced gradient within
    rtol = atol = 1e-5, with the global negative pool, with
    ``itm_neg_block = 4`` (blocks that straddle the ranks) and on a region
    batch; the ranks mask different numbers of MLM tokens and keep
    different numbers of bbox rows. The negatives are injected (global
    rows), dropout is off. The config is test_torch_pretrain.py's (whose
    world-1 step that file holds against JAX at 1e-4), with the port's
    seeded weights plus seeded noise;
(b) two AdamW steps at world 2 end in the world-1 run's parameters within
    1e-5; the ZeRO split (``AdamW.shard``, as ``--fsdp 2``) ends in the
    unsplit run's parameters, and its saved state restores at world 1 into
    the unsplit run's parameters and moments, and at world 2 into a split
    optimizer's slices;
(c) ITC with ``idx`` and its temperature gradient, the negative pool's
    masked similarity (``idx`` and the global pool; ``itm_neg_block = 4``)
    and the MLM CE over the global count, computed at world 2 and compared
    here with the JAX functions on the global inputs (the JAX loss methods
    through ``apply`` with the temperature as the only parameter, so no
    JAX model is initialised or compiled whole).
"""

import copy
import dataclasses
import functools
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.torch_dist import init_group, spawn  # noqa: E402
from x2vlm_tpu_torch.core import mesh  # noqa: E402
from x2vlm_tpu_torch.models import BEiT2Config, BertConfig, XVLMConfig, XVLMForPretrain  # noqa: E402,E501
from x2vlm_tpu_torch.train import checkpoint as ckpt_lib  # noqa: E402
from x2vlm_tpu_torch.train.optim import AdamW, lr_schedule, shard_dim  # noqa: E402
from x2vlm_tpu_torch.train.trainer import make_apply_grads, make_grad_fn  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
VISION = dict(image_res=192, patch_size=16, embed_dim=64, depth=2, num_heads=1,
              drop_path_rate=0.0, dropout_rate=0.0)
TEXT = dict(vocab_size=100, hidden_size=32, num_layers=4, fusion_layer=2,
            num_heads=2, intermediate_size=64, encoder_width=64,
            hidden_dropout=0.0, attn_dropout=0.0, max_position_embeddings=64)
CONFIG = XVLMConfig(vision=BEiT2Config(**VISION), text=BertConfig(**TEXT), embed_dim=16)
B, L, M, WORLD = 3, 8, 3, 2
N_PATCH = (192 // 16) ** 2
# injected negatives, rows of the global batch of 6: the global pool (every
# row's negatives on the other rank) and itm_neg_block = 4 (blocks {0..3},
# {4, 5}: rows 2 and 3 take negatives across the ranks)
NEGS = {0: ([5, 3, 4, 2, 1, 0], [4, 5, 3, 1, 0, 2]),
        4: ([2, 0, 3, 1, 5, 4], [1, 3, 0, 2, 5, 4])}
FSDP_MIN_SIZE = 1024   # small enough to split this model's larger leaves


@functools.lru_cache(maxsize=1)
def _built():
    model = XVLMForPretrain(CONFIG, dtype=torch.float32, device="cpu", seed=0)
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for p in model.parameters():   # seeded noise: zero / one inits carry information
            p.add_(torch.from_numpy(np.asarray(0.05 * rng.standard_normal(tuple(p.shape)))).float())
    return model


def _model():
    """A fresh copy of the one model a process builds (a build takes ~2 s)."""
    return copy.deepcopy(_built())


def _batch(rank, region=False):
    """test_torch_pretrain.py's ``_batch`` recipe, B = 3, from a seed per
    rank; rank 1 ignores one more MLM label. ``region``: 2 images and 3
    region rows, rank 0 keeping 2 bbox rows and rank 1 one."""
    rng = np.random.default_rng(10 + rank + 100 * region)
    ids = rng.integers(1, 100, (B, L)).astype(np.int32)
    atts = np.ones((B, L), np.int32)
    atts[1, 5:] = 0
    atts[2, 3:] = 0
    masked_ids = rng.integers(1, 100, (B, M)).astype(np.int32)
    masked_ids[2, 2] = -100
    if rank == 1:
        masked_ids[0, 1] = -100
    batch = {"image": rng.standard_normal((2 if region else B, 192, 192, 3)).astype(np.float32),
             "text_ids": ids * atts, "text_atts": atts,
             "text_ids_masked": np.where(rng.random((B, L)) < 0.3, 3, ids) * atts,
             "masked_pos": rng.integers(0, 3, (B, M)).astype(np.int32),
             "masked_ids": masked_ids}
    if region:
        bitmaps = np.zeros((B, 1 + N_PATCH), np.float32)
        bitmaps[:, 0] = 1
        for r in range(B):
            bitmaps[r, 1 + rng.choice(N_PATCH, 10 + 20 * r, replace=False)] = 1
        batch.update(idx_to_group_img=np.array([0, 1, 1], np.int32), image_atts=bitmaps,
                     target_bbox=(rng.random((B, 4)) * 0.5 + 0.25).astype(np.float32),
                     is_image=np.array([[0, 1, 0], [1, 1, 0]][rank], np.float32))
    return batch


def _global(batches):
    out = {k: np.concatenate([b[k] for b in batches]) for k in batches[0]}
    if "idx_to_group_img" in out:   # rank 1's rows group its own images
        n = batches[0]["image"].shape[0]
        out["idx_to_group_img"] = np.concatenate(
            [b["idx_to_group_img"] + r * n for r, b in enumerate(batches)])
    return out


def _tensors(batch):
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    for k in ("text_ids", "text_ids_masked", "masked_pos", "masked_ids", "idx_to_group_img"):
        if k in t:
            t[k] = t[k].long()
    return t


def _negs(block, rows):
    return tuple(torch.tensor(x)[rows] for x in NEGS[block])


CASES = [("pool", 0, False), ("block4", 4, False), ("region", 0, True)]


def _grad_step(model, batch, negs, region):
    model.zero_grad(set_to_none=True)
    kw = {"neg_idx": negs, "ret_bbox_loss": region}
    losses = make_grad_fn(model, apply_kwargs=kw)(_tensors(batch))
    mesh.all_reduce_grads(list(model.parameters()))
    return ({k: v.item() for k, v in losses.items()},
            {n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
             for n, p in model.named_parameters()})


def _adamw(model):
    """AdamW at the pretraining configs' lr (1e-4, no warmup). Adam's update
    is about lr an element whatever the gradient's size, so a gradient that
    differs in its last bits (another summation order) moves a parameter by
    up to about lr times its relative change where the gradient is near
    eps: the lr sets how close two runs' parameters can be held."""
    return AdamW(model.named_parameters(), lr_schedule(1e-4, 10, 0))


def _two_steps(model, opt, batches, negs):
    grad_fn, apply_grads = make_grad_fn(model, apply_kwargs={"neg_idx": negs}), \
        make_apply_grads(opt)
    for p in opt.params:
        p.grad = None
    for b in batches:
        grad_fn(_tensors(b))
        apply_grads()


def _world2_worker(rank, world, tmp):
    tmp = Path(tmp)
    rows = slice(rank * B, (rank + 1) * B)
    batches = {region: [_batch(r, region) for r in range(world)] for region in (False, True)}
    # world 1 first, before this process joins the group
    want = {}
    for name, block, region in CASES:
        model = _model()
        model.base.config = dataclasses.replace(CONFIG, itm_neg_block=block)
        want[name] = _grad_step(model, _global(batches[region]), _negs(block, slice(None)),
                                region)
    two = [[_batch(r + 4 * s) for r in range(world)] for s in range(2)]
    ref = _model()
    _two_steps(ref, _adamw(ref), [_global(b) for b in two], _negs(0, slice(None)))

    init_group(rank, world, str(tmp), fsdp=world)
    # (a) the step at world 2
    for name, block, region in CASES:
        model = _model()
        model.base.config = dataclasses.replace(CONFIG, itm_neg_block=block)
        losses, grads = _grad_step(model, batches[region][rank], _negs(block, rows), region)
        w_losses, w_grads = want[name]
        assert losses.keys() == w_losses.keys()
        for k in losses:
            np.testing.assert_allclose(losses[k], w_losses[k], **TOL, err_msg=f"{name} {k}")
        for n, g in grads.items():
            np.testing.assert_allclose(g.numpy(), w_grads[n].numpy(), **TOL,
                                       err_msg=f"{name} {n}")
    # (b) two AdamW steps, whole and ZeRO-split
    whole, split = _model(), _model()
    opt_whole, opt_split = _adamw(whole), _adamw(split)
    opt_split.shard(mesh.fsdp_group(), mesh.fsdp_rank(), mesh.fsdp_size(),
                    min_size=FSDP_MIN_SIZE)
    assert sum(s is not None for s in opt_split.slices) >= 10
    for model, opt in ((whole, opt_whole), (split, opt_split)):
        _two_steps(model, opt, [b[rank] for b in two], _negs(0, rows))
    for (n, p), q, r in zip(whole.named_parameters(), split.parameters(), ref.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), r.detach().numpy(), **TOL, err_msg=n)
        assert torch.equal(p, q), n
    ckpt_lib.save_train_state(str(tmp / "split_ckpt"), split, opt_split, 2)
    # the whole state loads into a split optimizer too, each rank its slices
    again = _model()
    opt_again = _adamw(again)
    opt_again.shard(mesh.fsdp_group(), mesh.fsdp_rank(), mesh.fsdp_size(),
                    min_size=FSDP_MIN_SIZE)
    ckpt_lib.restore_train_state(str(tmp / "split_ckpt"), again, opt_again)
    for got, want in zip(opt_again.full_moments(), (opt_whole.mu, opt_whole.nu)):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    if rank == 0:
        torch.save({"params": {n: p.detach() for n, p in whole.named_parameters()},
                    "mu": opt_whole.mu, "nu": opt_whole.nu}, tmp / "whole.pt")
    # (c) the parts held against JAX in the parent
    base = _model().base
    feats, idx = _itc_inputs()
    with torch.no_grad():
        base.temp.fill_(0.07)
    i_f, t_f = (torch.from_numpy(f[rows].copy()).requires_grad_() for f in feats)
    with mesh.data_parallel():
        itc = base.get_contrastive_loss(i_f, t_f, torch.from_numpy(idx[rows]))
        itc.backward()
        sims = {}
        for block, with_idx in ((0, True), (4, False)):
            base.config = dataclasses.replace(CONFIG, itm_neg_block=block)
            sims[block] = base.masked_similarity(
                i_f.detach(), t_f.detach(), torch.from_numpy(idx[rows]) if with_idx else None)
        ce = _mlm_ce(rank)
    np.savez(tmp / f"parts{rank}.npz", itc=itc.item(), i_grad=i_f.grad.numpy(),
             t_grad=t_f.grad.numpy(), temp_grad=base.temp.grad.item(),
             **{f"sim{b}_{d}": s[d].numpy() for b, s in sims.items() for d in (0, 1)}, **ce)


def _itc_inputs():
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((2, B * WORLD, 16)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    return feats, np.array([3, 1, 3, 0, 1, 2])   # rows 1 and 4 share an id across ranks


def _mlm_inputs():
    rng = np.random.default_rng(6)
    h = rng.standard_normal((2 * 5, 16)).astype(np.float32)
    table = rng.standard_normal((30, 16)).astype(np.float32)
    bias = rng.standard_normal(30).astype(np.float32)
    labels = rng.integers(0, 30, 2 * 5).astype(np.int32)
    labels[[1, 6, 7, 9]] = -100   # rank 0 keeps 4 labels, rank 1 two
    return h, table, bias, labels


def _mlm_ce(rank):
    from x2vlm_tpu_torch.ops.fused_ce import fused_vocab_ce

    h, table, bias, labels = _mlm_inputs()
    rows = slice(rank * 5, (rank + 1) * 5)
    h_r = torch.from_numpy(h[rows].copy()).requires_grad_()
    lab = torch.from_numpy(labels[rows]).long()
    loss = fused_vocab_ce(h_r, torch.from_numpy(table), torch.from_numpy(bias), lab,
                          torch.ones_like(lab, dtype=torch.bool))
    loss.backward()
    return {"ce": loss.item(), "ce_grad": h_r.grad.numpy()}


def _jax_parts():
    """The JAX functions on the global inputs of (c): ITC with ``idx`` and
    its gradients, the masked similarity the draws read (``jax.random.
    categorical``'s logits, captured) with ``idx`` and with
    ``itm_neg_block = 4``, the MLM CE over the global count and its
    gradient."""
    import jax
    import jax.numpy as jnp

    from x2vlm_tpu.models import (
        BEiT2Config as JBEiT2, BertConfig as JBert, XVLMConfig as JXVLMConfig,
        XVLMForPretrain as JXVLMForPretrain,
    )
    from x2vlm_tpu.ops.fused_ce import fused_vocab_ce as jax_fused_ce

    def jax_model(block):
        return JXVLMForPretrain(JXVLMConfig(vision=JBEiT2(**VISION), text=JBert(**TEXT),
                                            embed_dim=16, itm_neg_block=block),
                                dtype=jnp.float32)

    feats, idx = _itc_inputs()
    idx = jnp.asarray(idx)
    m0 = jax_model(0)

    def itc(i_f, t_f, t):
        return m0.apply({"params": {"base": {"temp": t}}}, i_f, t_f, idx,
                        method=lambda m, a, b, x: m.base.get_contrastive_loss(a, b, idx=x))

    out = {}
    out["itc"], (out["i_grad"], out["t_grad"], out["temp_grad"]) = jax.value_and_grad(
        itc, argnums=(0, 1, 2))(jnp.asarray(feats[0]), jnp.asarray(feats[1]),
                                jnp.float32(0.07))
    captured = []

    def categorical(key, logits, axis=-1):
        captured.append(np.asarray(logits))
        return jnp.argmax(logits, axis)

    orig = jax.random.categorical
    jax.random.categorical = categorical
    try:
        for block, x in ((0, idx), (4, None)):
            captured.clear()
            jax_model(block).apply(
                {"params": {"base": {"temp": jnp.float32(0.07)}}}, jnp.asarray(feats[0]),
                jnp.asarray(feats[1]), jax.random.PRNGKey(0), x,
                method=lambda m, a, b, k, i: m.base.get_hard_negatives(a, b, k, idx=i))
            out.update({f"sim{block}_{d}": captured[d] for d in (0, 1)})
    finally:
        jax.random.categorical = orig
    h, table, bias, labels = _mlm_inputs()

    def ce(h):
        return jax_fused_ce(h, jnp.asarray(table), jnp.asarray(bias), jnp.asarray(labels),
                            jnp.ones(labels.shape, bool))

    out["ce"], out["ce_grad"] = jax.value_and_grad(ce)(jnp.asarray(h))
    return {k: np.asarray(v) for k, v in out.items()}


def test_world2_step_equals_world1_and_the_jax_global_functions(tmp_path):
    want = spawn(_world2_worker, tmp_path, meanwhile=_jax_parts)
    # (b) the ZeRO-split state restores at world 1 into the whole run's state
    model = _model()
    opt = _adamw(model)
    step, _ = ckpt_lib.restore_train_state(str(tmp_path / "split_ckpt"), model, opt)
    whole = torch.load(tmp_path / "whole.pt", weights_only=False)
    assert step == 2 and opt.count == 2
    for (n, p), mu, nu, w_mu, w_nu in zip(model.named_parameters(), opt.mu, opt.nu,
                                          whole["mu"], whole["nu"]):
        assert torch.equal(p, whole["params"][n]), n
        assert torch.equal(mu, w_mu) and torch.equal(nu, w_nu), n
    # (c) the ranks' parts against JAX on the global inputs: a loss is the
    # ranks' mean, a row's gradient the global loss's times the world size
    parts = [np.load(tmp_path / f"parts{r}.npz") for r in range(WORLD)]
    for k in want:
        got = np.concatenate([p[k] for p in parts]) if parts[0][k].ndim else \
            np.mean([float(p[k]) for p in parts])
        if k.startswith("sim"):
            np.testing.assert_array_equal(got <= -1e29, want[k] <= -1e29, err_msg=k)
            np.testing.assert_allclose(got, want[k], rtol=1e-5, atol=1e-4, err_msg=k)
        else:
            scale = WORLD if k.endswith("grad") and parts[0][k].ndim else 1
            np.testing.assert_allclose(got / scale, want[k], **TOL, err_msg=k)


@pytest.mark.parametrize("shape,size,want", [
    ((768, 3072), 2, 1), ((3072, 768), 4, 0), ((30522, 768), 2, 0), ((30522, 768), 4, 1),
    ((768,), 2, None), ((250, 257), 2, None), ((2 ** 16,), 2, 0), ((7, 2 ** 14), 4, 1),
    ((64, 64, 16), 8, 0), ((5, 5, 4096), 2, 2), ((16, 4096), 1, None), ((), 2, None),
])
def test_shard_dim_is_the_jax_leaf_spec(shape, size, want):
    """``--fsdp``'s split rule against the JAX ``_leaf_spec`` (min_size 2^16)."""
    from x2vlm_tpu.parallel.partition import _leaf_spec

    got = shard_dim(shape, size)
    assert got == want
    spec = tuple(_leaf_spec(np.zeros(shape, np.int8), size, 2 ** 16))
    assert (None if not any(spec) else spec.index("fsdp")) == got
