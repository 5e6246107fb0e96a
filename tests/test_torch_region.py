"""The region stream's model path against the JAX package in fp32 on the CPU:
the box functions, ``grouped_image_embeds``, ``get_bbox_loss`` (is_image rows
and degenerate boxes), ``predict_bbox`` and ``XVLMForPretrain`` on a region
batch (the five losses and every parameter's gradient, against
``jax.vjp`` of the JAX model with its hard-negative draws injected), with
the matching loss on and off and with the ``regions_use_bbox_only`` loss
weights; the bbox pass without dropout in training mode; and
``calc_image_bbox_loss`` through both packages' ``pretrain_loop``.

Config: a 112 px image (49 patches, so region bitmaps cover 1 to 40 of
them), vision width 32, 2 blocks; the text stack of test_torch_pretrain.py
at width 32; every dropout and drop-path at 0. Tolerances: 1e-6 for the box
functions, the grouped embeddings and the bbox loss (a few fp32 operations);
rtol = atol = 1e-4 for the model's losses and gradients, as in
test_torch_pretrain.py."""

import copy
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests.test_torch_pretrain import TEXT, TOL, _noisy  # noqa: E402
from x2vlm_tpu.models import (  # noqa: E402
    BEiT2Config as JaxBEiT2Config, BertConfig as JaxBertConfig,
    XVLMConfig as JaxXVLMConfig, XVLMForPretrain as JaxXVLMForPretrain,
)
from x2vlm_tpu.models.beit2 import grouped_image_embeds as jax_grouped  # noqa: E402
from x2vlm_tpu.models.heads import pretrain_init_inputs  # noqa: E402
from x2vlm_tpu.models.xvlm import XVLMBase as JaxXVLMBase  # noqa: E402
from x2vlm_tpu.ops import box as jax_box  # noqa: E402
from x2vlm_tpu.serving import _flatten  # noqa: E402
from x2vlm_tpu_torch.convert import convert_jax_params  # noqa: E402
from x2vlm_tpu_torch.models import (  # noqa: E402
    BEiT2Config, BertConfig, XVLMBase, XVLMConfig, XVLMForPretrain,
)
from x2vlm_tpu_torch.models.beit2 import grouped_image_embeds  # noqa: E402
from x2vlm_tpu_torch.ops import box  # noqa: E402
from x2vlm_tpu_torch.run import to_device  # noqa: E402
from x2vlm_tpu_torch.tasks.pretrain import PretrainStreams, pretrain_loop  # noqa: E402
from x2vlm_tpu_torch.train import create_optimizer, lr_schedule  # noqa: E402

EXACT = dict(rtol=1e-6, atol=1e-6)
RES = 112
N_PATCH = (RES // 16) ** 2
VISION = dict(image_res=RES, patch_size=16, embed_dim=32, depth=2, num_heads=2,
              drop_path_rate=0.0, dropout_rate=0.0)
PORT_TEXT = dict(TEXT, encoder_width=32)
N_IMG, R, L, M = 2, 6, 8, 3
LOSSES = ("loss_itc", "loss_itm", "loss_mlm", "loss_bbox", "loss_giou")


def _jax_config():
    return JaxXVLMConfig(vision=JaxBEiT2Config(**VISION), text=JaxBertConfig(**PORT_TEXT),
                         embed_dim=16)


def _port_config():
    return XVLMConfig(vision=BEiT2Config(**VISION), text=BertConfig(**PORT_TEXT), embed_dim=16)


# ---- box functions ----

def _xyxy(rng, n, degenerate=False):
    lo = rng.random((n, 2)).astype(np.float32)
    wh = rng.random((n, 2)).astype(np.float32) * 0.6
    if degenerate:
        wh[::2, 0] = 0.0                       # zero width
        wh[1::3, 1] *= -1                      # negative height
    return np.concatenate([lo, lo + wh], axis=1)


PAIRWISE = ("box_iou", "generalized_box_iou")
ELEMENTWISE = ("elementwise_box_iou", "elementwise_generalized_box_iou")
UNARY = ("box_cxcywh_to_xyxy", "box_xyxy_to_cxcywh", "box_area")


@pytest.mark.parametrize("degenerate", [False, True])
@pytest.mark.parametrize("name", UNARY + PAIRWISE + ELEMENTWISE)
def test_box_functions_equal_jax(name, degenerate):
    rng = np.random.default_rng(len(name))
    a, b = _xyxy(rng, 7, degenerate), _xyxy(rng, 5 if name in PAIRWISE else 7)
    if degenerate and name in PAIRWISE + ELEMENTWISE:
        b[0] = a[0]                            # one pair identical, degenerate or not
    args = (a,) if name in UNARY else (a, b)
    want = getattr(jax_box, name)(*(jnp.asarray(x) for x in args))
    got = getattr(box, name)(*(torch.from_numpy(x) for x in args))
    if name == "box_iou":
        want, got = want[0], got[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), equal_nan=True, **EXACT)


# ---- region rows and the bbox loss ----

def _bitmaps(rng, rows):
    """Region bitmaps over 1 to 40 patches (random patches), the CLS slot on;
    row 2 covers the whole image (a full-image caption row)."""
    atts = np.zeros((rows, 1 + N_PATCH), np.float32)
    atts[:, 0] = 1
    for r, n in enumerate(np.linspace(1, 40, rows).astype(int)):
        atts[r, 1 + rng.choice(N_PATCH, n, replace=False)] = 1
    atts[2] = 1
    return atts


def test_grouped_image_embeds_equal_jax():
    rng = np.random.default_rng(0)
    embeds = rng.standard_normal((3, 1 + N_PATCH, 16)).astype(np.float32)
    idx = np.array([2, 0, 0, 1, 2, 2, 1], np.int32)
    atts = _bitmaps(rng, 7)
    atts[5, 1:] = 0                            # no patch at all: the 1e-6 guard
    want = jax_grouped(*(jnp.asarray(x) for x in (embeds, idx, atts)))
    got = grouped_image_embeds(torch.from_numpy(embeds), torch.from_numpy(idx).long(),
                               torch.from_numpy(atts))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **EXACT)


def _coords(rng, n):
    pred = rng.random((n, 4)).astype(np.float32) * 0.5 + 0.2
    target = rng.random((n, 4)).astype(np.float32) * 0.5 + 0.2
    target[3, 2] = -0.1                        # a degenerate target (negative width)
    return pred, target


@pytest.mark.parametrize("with_is_image", [False, True])
def test_bbox_loss_equals_jax(with_is_image):
    rng = np.random.default_rng(1)
    pred, target = _coords(rng, 6)
    is_image = np.array([0, 1, 0, 0, 1, 0], np.float32) if with_is_image else None
    want = JaxXVLMBase.get_bbox_loss(None, jnp.asarray(pred), jnp.asarray(target),
                                     None if is_image is None else jnp.asarray(is_image))
    got = XVLMBase.get_bbox_loss(torch.from_numpy(pred), torch.from_numpy(target),
                                 None if is_image is None else torch.from_numpy(is_image))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.item(), float(w), **EXACT)


def test_bbox_loss_gradient_equals_jax():
    """The degenerate row's GIoU term is cut from the gradient as well."""
    rng = np.random.default_rng(2)
    pred, target = _coords(rng, 5)
    is_image = np.array([0, 0, 1, 0, 0], np.float32)

    def total(p):
        return sum(JaxXVLMBase.get_bbox_loss(None, p, jnp.asarray(target),
                                             jnp.asarray(is_image)))

    want = jax.grad(total)(jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_()
    sum(XVLMBase.get_bbox_loss(p, torch.from_numpy(target), torch.from_numpy(is_image))
        ).backward()
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want), **EXACT)


# ---- the model on a region batch ----

def _region_batch(rng):
    ids = rng.integers(1, 100, (R, L)).astype(np.int32)
    atts = np.ones((R, L), np.int32)
    atts[1, 5:] = 0
    atts[4, 3:] = 0
    masked_ids = rng.integers(1, 100, (R, M)).astype(np.int32)
    masked_ids[3, 1] = -100
    target = rng.random((R, 4)).astype(np.float32) * 0.5 + 0.25
    target[5, 3] = -0.05                       # a degenerate target
    return {
        "image": rng.standard_normal((N_IMG, RES, RES, 3)).astype(np.float32),
        "text_ids": ids * atts, "text_atts": atts,
        "text_ids_masked": np.where(rng.random((R, L)) < 0.3, 3, ids) * atts,
        "masked_pos": rng.integers(0, 3, (R, M)).astype(np.int32),
        "masked_ids": masked_ids,
        "idx_to_group_img": np.array([0, 1, 0, 1, 1, 0], np.int32),
        "image_atts": _bitmaps(rng, R),
        "target_bbox": target,
        "is_image": np.array([0, 0, 1, 0, 0, 0], np.float32),
    }


@pytest.fixture(scope="module")
def region():
    rng = np.random.default_rng(3)
    model = JaxXVLMForPretrain(_jax_config(), dtype=jnp.float32)
    init = model.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                      pretrain_init_inputs(_jax_config()), rng=jax.random.PRNGKey(2),
                      ret_bbox_loss=True)
    variables = _noisy(init, rng)
    batch = _region_batch(rng)
    state, unused = convert_jax_params(_flatten(variables), device="cpu")
    port = XVLMForPretrain(_port_config(), dtype=torch.float32, device="cpu", seed=None)
    port.base.load_state_dict(state)
    return dict(model=model, variables=variables, batch=batch, port=port, unused=unused,
                jax={})


def _jax_region(s, itm, key):
    """The JAX losses and a vjp over the loss vector, and the negatives
    (computed once for each ``itm``)."""
    if itm not in s["jax"]:
        s["jax"][itm] = _jax_region_uncached(s, itm, key)
    return s["jax"][itm]


def _jax_region_uncached(s, itm, key):
    model, variables = s["model"], s["variables"]
    jb = {k: jnp.asarray(v) for k, v in s["batch"].items()}

    def negs(m, b, key):
        base = m.base
        ie, _, _ = base.get_vision_embeds(b["image"], image_atts=b["image_atts"],
                                          idx_to_group_img=b["idx_to_group_img"])
        te = base.get_text_embeds(b["text_ids"], b["text_atts"])
        i_f, t_f = base.get_features(ie, te)
        return base.get_hard_negatives(i_f, t_f, key)

    def losses(params):
        out = model.apply({"params": params}, jb, rng=key, ret_bbox_loss=True,
                          ret_match_loss=itm, deterministic=True)
        return jnp.stack([jnp.asarray(out[k], jnp.float32) for k in LOSSES])

    vec, vjp = jax.vjp(losses, variables["params"])
    neg = [np.array(x) for x in model.apply(variables, jb, key, method=negs)]
    return np.asarray(vec), vjp, neg


@pytest.mark.parametrize("case", ["itm", "no_itm", "bbox_only"])
def test_region_losses_and_gradients_match_jax(region, case):
    itm = case != "no_itm"
    weights = np.array([0, 0, 0, 1, 1] if case == "bbox_only" else [1] * 5, np.float32)
    key = jax.random.PRNGKey(7)
    want, vjp, neg = _jax_region(region, itm, key)
    (want_grads,) = vjp(jnp.asarray(weights))
    port = region["port"]
    port.zero_grad(set_to_none=True)
    tb = {k: torch.from_numpy(v) for k, v in region["batch"].items()}
    tb["idx_to_group_img"] = tb["idx_to_group_img"].long()
    got = port(tb, neg_idx=tuple(torch.from_numpy(x).long() for x in neg) if itm else None,
               ret_match_loss=itm, ret_bbox_loss=True)
    assert tuple(got) == LOSSES
    sum(float(w) * got[k] for w, k in zip(weights, LOSSES)).backward()
    for k, v in zip(LOSSES, want):
        np.testing.assert_allclose(got[k].item(), v, err_msg=k, **TOL)
    assert got["loss_giou"].item() > 0 and got["loss_bbox"].item() > 0
    grads, _ = convert_jax_params(_flatten(want_grads), device="cpu")
    params = dict(port.base.named_parameters())
    assert set(params) == set(grads)
    for name, p in params.items():
        # a parameter the weighted losses do not reach has no .grad (zeros)
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(g.numpy(), grads[name].numpy(), err_msg=name, **TOL)
    assert params["bbox_head.3.weight"].grad.abs().sum() > 0


def test_region_vision_embeds_equal_jax(region):
    """``get_vision_embeds`` with ``idx_to_group_img`` and the bitmaps: the
    region rows, the bitmaps and the full rows."""
    b = region["batch"]
    want = region["model"].apply(
        region["variables"], *(jnp.asarray(b[k]) for k in
                               ("image", "image_atts", "idx_to_group_img")),
        method=lambda m, i, a, x: m.base.get_vision_embeds(i, image_atts=a,
                                                           idx_to_group_img=x))
    with torch.no_grad():
        got = region["port"].base.get_vision_embeds(
            torch.from_numpy(b["image"]), image_atts=torch.from_numpy(b["image_atts"]),
            idx_to_group_img=torch.from_numpy(b["idx_to_group_img"]).long())
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32), **TOL)


def test_region_vision_embeds_without_bitmaps_raise(region):
    """Region rows without their bitmaps serve only grounding (ROADMAP A6)."""
    b = region["batch"]
    with pytest.raises(NotImplementedError, match="A6"):
        region["port"].base.get_vision_embeds(
            torch.from_numpy(b["image"]),
            idx_to_group_img=torch.from_numpy(b["idx_to_group_img"]).long())


def test_predict_bbox_through_convert_equals_jax(region):
    assert region["unused"] == []
    rng = np.random.default_rng(5)
    full = rng.standard_normal((4, 1 + N_PATCH, 32)).astype(np.float32)
    text = rng.standard_normal((4, L, 32)).astype(np.float32)
    atts = np.ones((4, L), np.int32)
    atts[2, 4:] = 0
    want = region["model"].apply(
        region["variables"], *(jnp.asarray(x) for x in (full, text, atts)),
        method=lambda m, f, t, a: m.base.predict_bbox(f, t, a))
    port = region["port"]
    port.train()             # the bbox pass runs without dropout, and leaves the mode be
    try:
        with torch.no_grad():
            got = port.base.predict_bbox(*(torch.from_numpy(x) for x in (full, text, atts)))
        assert all(m.training for m in port.modules())
    finally:
        port.eval()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_predict_bbox_runs_the_fusion_pass_without_dropout():
    """In training mode with every text dropout and drop-path on, the bbox
    pass equals the eval-mode pass, while the same fusion pass without
    ``deterministic`` does not."""
    text = dict(PORT_TEXT, hidden_dropout=0.3, attn_dropout=0.3, text_drop_path_rate=0.2,
                cross_drop_path_rate=0.2)
    base = XVLMBase(XVLMConfig(vision=BEiT2Config(**VISION), text=BertConfig(**text),
                               embed_dim=16), dtype=torch.float32, device="cpu", seed=2,
                    bbox_head=True)
    rng = np.random.default_rng(6)
    full = torch.from_numpy(rng.standard_normal((4, 1 + N_PATCH, 32)).astype(np.float32))
    te = torch.from_numpy(rng.standard_normal((4, L, 32)).astype(np.float32))
    atts = torch.ones((4, L), dtype=torch.int32)
    with torch.no_grad():
        want = base.predict_bbox(full, te, atts)
        base.train()
        got = base.predict_bbox(full, te, atts)
        dropped = base.get_cross_embeds(full, torch.ones(full.shape[:2], dtype=torch.int32),
                                        text_embeds=te, text_atts=atts)[:, 0, :]
        assert all(m.training for m in base.modules())
        base.eval()
        kept = base.get_cross_embeds(full, torch.ones(full.shape[:2], dtype=torch.int32),
                                     text_embeds=te, text_atts=atts)[:, 0, :]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert not torch.allclose(dropped, kept)


# ---- calc_image_bbox_loss through both packages' pretrain loops ----

def _image_batch(b):
    """The region batch's first row of each image, as an image-stream batch."""
    keys = ("text_ids", "text_atts", "text_ids_masked", "masked_pos", "masked_ids")
    assert list(b["idx_to_group_img"][:N_IMG]) == list(range(N_IMG))
    return dict({k: b[k][:N_IMG] for k in keys}, image=b["image"])


def _jax_loop_bbox(region, calc):
    from x2vlm_tpu.tasks.pretrain import PretrainStreams as JaxStreams, pretrain_loop
    from x2vlm_tpu.train import create_optimizer, create_train_state, lr_schedule
    from x2vlm_tpu.train.metrics import MetricLogger

    tx = create_optimizer(region["variables"]["params"], lr_schedule(1e-3, 10))
    streams = JaxStreams(image=itertools.repeat(_image_batch(region["batch"])),
                         region=itertools.repeat(region["batch"]))
    logger = MetricLogger()
    pretrain_loop(region["model"], create_train_state(region["variables"], tx), tx, streams,
                  num_steps=1, rng_key=jax.random.PRNGKey(5),
                  shard_fn=lambda b: jax.tree_util.tree_map(jnp.asarray, b),
                  calc_image_bbox_loss=calc, log_every=10, logger=logger)
    return [logger.meters[f"region_{k}"].global_avg for k in ("loss_bbox", "loss_giou")]


def _port_loop_bbox(region, calc):
    port = copy.deepcopy(region["port"])
    streams = PretrainStreams(image=itertools.repeat(_image_batch(region["batch"])),
                              region=itertools.repeat(region["batch"]))
    logger = pretrain_loop(port, create_optimizer(port, lr_schedule(1e-3, 10)), streams,
                           num_steps=1, seed=0,
                           to_device=lambda b: to_device(b, torch.device("cpu")),
                           calc_image_bbox_loss=calc, log_every=10)
    return [logger.meters[f"region_{k}"].global_avg for k in ("loss_bbox", "loss_giou")]


def _direct_bbox(region, is_image):
    """``get_bbox_loss`` on the batch's own prediction with ``is_image``."""
    base = region["port"].base
    tb = to_device(region["batch"], torch.device("cpu"))
    with torch.no_grad():
        _, _, full = base.get_vision_embeds(tb["image"], image_atts=tb["image_atts"],
                                            idx_to_group_img=tb["idx_to_group_img"])
        te = base.get_text_embeds(tb["text_ids"], tb["text_atts"])
        coord = base.predict_bbox(full, te, tb["text_atts"])
        return [x.item() for x in base.get_bbox_loss(
            coord, tb["target_bbox"], tb["is_image"] if is_image else None)]


@pytest.mark.parametrize("calc", [False, True])
def test_pretrain_loop_calc_image_bbox_loss_matches_jax(region, calc):
    """One step of each package's ``pretrain_loop`` on the region batch
    (row 2 a full-image row): the region stream's bbox losses equal JAX's,
    and equal ``get_bbox_loss`` with ``is_image`` None when the flag is on
    (the batch's ``is_image`` when off), which differ from each other."""
    assert region["batch"]["is_image"].sum() == 1
    got = _port_loop_bbox(region, calc)
    np.testing.assert_allclose(got, _jax_loop_bbox(region, calc), **TOL)
    np.testing.assert_allclose(got, _direct_bbox(region, is_image=not calc), **TOL)
    other = _direct_bbox(region, is_image=calc)
    assert all(abs(g - o) > 1e-3 for g, o in zip(got, other)), (got, other)
