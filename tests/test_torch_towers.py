"""The port's CLIP ViT, Swin and ViT vision towers against the JAX
package's, in fp32 on the CPU at tiny sizes: the JAX parameters (seeded
noise on every leaf) carried across with ``x2vlm_tpu_torch.convert``, the
same pixels in. Forward within 1e-5, every parameter's and the pixels'
gradient within 1e-4 of ``jax.vjp`` under the same cotangent. Also CLIP's
region path (``local_attn_depth``), the retrieval losses (ITC + ITM) of a
CLIP and a Swin ``XVLMForRetrieval`` with their gradients, and each
tower's decay mask and optimizer groups against the JAX ones."""

import numpy as np
import pytest
from tests.torch_threads import few_torch_threads  # noqa: E402,F401 (autouse)

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from x2vlm_tpu.models import BertConfig as JaxBertConfig  # noqa: E402
from x2vlm_tpu.models import XVLMConfig as JaxXVLMConfig  # noqa: E402
from x2vlm_tpu.models.beit2 import BEiT2Config as JaxBEiT2Config  # noqa: E402
from x2vlm_tpu.models.clip_vit import CLIPViT as JaxCLIPViT  # noqa: E402
from x2vlm_tpu.models.clip_vit import CLIPViTConfig as JaxCLIPViTConfig  # noqa: E402
from x2vlm_tpu.models.heads import XVLMForRetrieval as JaxXVLMForRetrieval  # noqa: E402
from x2vlm_tpu.models.swin import SwinConfig as JaxSwinConfig  # noqa: E402
from x2vlm_tpu.models.swin import SwinTransformer as JaxSwin  # noqa: E402
from x2vlm_tpu.models.vit import ViT as JaxViT  # noqa: E402
from x2vlm_tpu.models.vit import ViTConfig as JaxViTConfig  # noqa: E402
from x2vlm_tpu.serving import _flatten  # noqa: E402
from x2vlm_tpu.train.optim import _is_no_decay  # noqa: E402
from x2vlm_tpu.train.optim import param_labels as jax_param_labels  # noqa: E402
from x2vlm_tpu_torch.convert import convert_jax_params, to_jax_params  # noqa: E402
from x2vlm_tpu_torch.models import (  # noqa: E402
    BEiT2Config, BertConfig, CLIPViT, CLIPViTConfig, SwinConfig, SwinTransformer, ViT,
    ViTConfig, XVLMConfig, XVLMForRetrieval, vision_seq_len, vision_width,
)
from x2vlm_tpu_torch.train.optim import is_no_decay, param_labels  # noqa: E402

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)

CLIP = dict(image_res=32, patch_size=8, embed_dim=32, depth=3, num_heads=2,
            intermediate_size=64)
# stage 0: a 16 x 16 grid of 4 x 4 windows, its second block shifted; stage
# 1: 8 x 8, shifted likewise; stage 2: a 4 x 4 grid, one window, no shift
SWIN = dict(image_res=32, patch_size=2, embed_dim=16, depths=(2, 2, 2), num_heads=(2, 2, 4),
            window_size=4, drop_path_rate=0.0)
VIT = dict(image_res=32, patch_size=8, embed_dim=32, depth=2, num_heads=2)
TOWERS = {
    "clip_quick_gelu": (JaxCLIPViT, JaxCLIPViTConfig, CLIPViT, CLIPViTConfig, CLIP),
    "clip_gelu": (JaxCLIPViT, JaxCLIPViTConfig, CLIPViT, CLIPViTConfig,
                  dict(CLIP, act="gelu")),
    "swin": (JaxSwin, JaxSwinConfig, SwinTransformer, SwinConfig, SWIN),
    "vit": (JaxViT, JaxViTConfig, ViT, ViTConfig, VIT),
}


def _noisy(variables, rng, scale=0.05):
    """Seeded noise on every leaf, so zero-initialised ones carry signal."""
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(np.asarray(x) + scale * rng.standard_normal(x.shape),
                              jnp.float32), variables)


def _port_tower(cls, cfg, variables):
    """The port's tower with the JAX tower's parameters."""
    flat = {f"vision_encoder/{k}": v for k, v in _flatten(variables["params"]).items()}
    state, unused = convert_jax_params(flat, device="cpu")
    assert unused == []
    tower = cls(cfg, dtype=torch.float32, device="cpu")
    tower.load_state_dict({k[len("vision_encoder."):]: v for k, v in state.items()})
    return tower


def _grads_as_jax(named_grads, prefix):
    """Port gradients by parameter name -> the JAX flat names (stripped of
    ``params/base/``), through the same converter the parameters took."""
    flat = to_jax_params({prefix + n: g for n, g in named_grads})
    return {k[len("params/base/"):]: v for k, v in flat.items()}


@pytest.fixture(scope="module", params=sorted(TOWERS))
def tower_pair(request):
    jax_cls, jax_cfg_cls, cls, cfg_cls, kw = TOWERS[request.param]
    rng = np.random.default_rng(sorted(TOWERS).index(request.param))
    jax_model = jax_cls(jax_cfg_cls(**kw), dtype=jnp.float32)
    pixels = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    variables = _noisy(jax_model.init(jax.random.PRNGKey(0), jnp.asarray(pixels)), rng)
    port = _port_tower(cls, cfg_cls(**kw), variables)
    return request.param, jax_model, variables, port, pixels, rng


def test_tower_forward_matches_jax(tower_pair):
    name, jax_model, variables, port, pixels, _ = tower_pair
    want = np.asarray(jax_model.apply(variables, jnp.asarray(pixels)))
    with torch.no_grad():
        got = port(torch.from_numpy(pixels)).numpy()
    cfg = port.config
    assert got.shape == want.shape == (2, vision_seq_len(cfg), vision_width(cfg))
    np.testing.assert_allclose(got, want, **FWD)


def test_tower_gradients_match_jax_vjp(tower_pair):
    name, jax_model, variables, port, pixels, rng = tower_pair
    out, vjp = jax.vjp(lambda v, x: jax_model.apply(v, x), variables, jnp.asarray(pixels))
    cot = rng.standard_normal(out.shape).astype(np.float32)
    g_vars, g_pix = vjp(jnp.asarray(cot))
    want = _flatten(g_vars["params"])

    x = torch.from_numpy(pixels).requires_grad_(True)
    port.zero_grad()
    (port(x) * torch.from_numpy(cot)).sum().backward()
    got = _grads_as_jax(((n, p.grad) for n, p in port.named_parameters()), "vision_encoder.")
    assert set(got) == {f"vision_encoder/{k}" for k in want}
    for k, w in want.items():
        np.testing.assert_allclose(got[f"vision_encoder/{k}"], np.asarray(w), err_msg=k,
                                   **GRAD)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_pix), **GRAD)


def test_swin_shapes_cover_the_shifted_and_single_window_stages():
    cfg = SwinConfig(**SWIN)
    tower = SwinTransformer(cfg, dtype=torch.float32, device="cpu")
    got = [(b.resolution, b.window, b.shift) for s in tower.layers for b in s.blocks]
    assert got == [((16, 16), 4, 0), ((16, 16), 4, 2), ((8, 8), 4, 0), ((8, 8), 4, 2),
                   ((4, 4), 4, 0), ((4, 4), 4, 0)]
    assert vision_width(cfg) == 64 and vision_seq_len(cfg) == 17
    full = SwinConfig()
    assert vision_width(full) == 1024 and vision_seq_len(full) == 50


def test_swin_trains_after_an_inference_mode_forward():
    """The window index and shift mask a Swin forward caches are built
    outside inference mode, so a training step after a served request (or
    an eval) in the same process can save them for its backward."""
    from x2vlm_tpu_torch.models import swin as swin_mod

    cfg = SwinConfig(**SWIN)
    tower = SwinTransformer(cfg, dtype=torch.float32, device="cpu")
    x = torch.randn(1, cfg.image_res, cfg.image_res, 3)
    swin_mod._REL_INDEX.cache.clear()
    swin_mod._SHIFT_MASK.cache.clear()
    with torch.inference_mode():
        tower(x)
    assert not any(t.is_inference() for t in swin_mod._REL_INDEX.cache.values())
    tower(x).sum().backward()
    assert tower.layers[0].blocks[0].attn.relative_position_bias_table.grad is not None


# ---- CLIP's region path ----

REGION = dict(CLIP, depth=3, local_attn_depth=2)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_clip_region_path_matches_jax(k):
    rng = np.random.default_rng(7 + k)
    kw = dict(REGION, local_attn_depth=k)
    jax_model = JaxCLIPViT(JaxCLIPViTConfig(**kw), dtype=jnp.float32)
    pixels = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    variables = _noisy(jax_model.init(jax.random.PRNGKey(0), jnp.asarray(pixels)), rng)
    port = _port_tower(CLIPViT, CLIPViTConfig(**kw), variables)
    idx = np.array([1, 0, 1], np.int32)
    atts = (rng.random((3, 17)) > 0.4).astype(np.int32)
    atts[:, 0] = 1
    region, full = jax_model.apply(variables, jnp.asarray(pixels),
                                   idx_to_group_img=jnp.asarray(idx),
                                   image_atts=jnp.asarray(atts))
    with torch.no_grad():
        p_region, p_full = port(torch.from_numpy(pixels), None,
                                torch.from_numpy(idx).long(), torch.from_numpy(atts))
    np.testing.assert_allclose(p_region.numpy(), np.asarray(region), **FWD)
    np.testing.assert_allclose(p_full.numpy(), np.asarray(full), **FWD)


def test_clip_region_path_through_get_vision_embeds():
    """``get_vision_embeds`` with region bitmaps on a CLIP core with
    ``local_attn_depth``: the tower's region rows, and the full rows
    gathered to the region rows, as the JAX composition."""
    rng = np.random.default_rng(3)
    text = dict(vocab_size=50, hidden_size=32, num_layers=2, fusion_layer=1, num_heads=2,
                intermediate_size=64, encoder_width=32, max_position_embeddings=16)
    jcfg = JaxXVLMConfig(vision=JaxCLIPViTConfig(**REGION), text=JaxBertConfig(**text),
                         embed_dim=8)
    jax_model = JaxXVLMForRetrieval(jcfg, dtype=jnp.float32)
    pixels = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    idx = np.array([0, 1, 1], np.int32)
    atts = (rng.random((3, 17)) > 0.5).astype(np.int32)
    atts[:, 0] = 1

    def embeds(m, img, idx, atts):
        return m.base.get_vision_embeds(img, image_atts=atts, idx_to_group_img=idx)

    init = jax_model.init(jax.random.PRNGKey(0), jnp.asarray(pixels), jnp.asarray(idx),
                          jnp.asarray(atts), method=embeds)
    variables = _noisy(init, rng)
    want = jax_model.apply(variables, jnp.asarray(pixels), jnp.asarray(idx),
                           jnp.asarray(atts), method=embeds)
    state, _ = convert_jax_params(_flatten(variables), device="cpu")
    port = XVLMForRetrieval(XVLMConfig(vision=CLIPViTConfig(**REGION), text=BertConfig(**text),
                                       embed_dim=8),
                            dtype=torch.float32, device="cpu", seed=0)
    # the JAX call creates the vision tower's parameters (and temp) only
    missing, _ = port.load_state_dict(state, strict=False)
    assert not [k for k in missing if k.startswith("vision_encoder.")]
    with torch.no_grad():
        got = port.get_vision_embeds(torch.from_numpy(pixels), None,
                                     torch.from_numpy(atts), torch.from_numpy(idx).long())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **FWD)


# ---- the retrieval losses of a CLIP and a Swin X2-VLM ----

TEXT = dict(vocab_size=60, hidden_size=32, num_layers=4, fusion_layer=2, num_heads=2,
            intermediate_size=64, hidden_dropout=0.0, attn_dropout=0.0,
            max_position_embeddings=16)
CORES = {"clip": (JaxCLIPViTConfig, CLIPViTConfig, CLIP),
         "swin": (JaxSwinConfig, SwinConfig, SWIN)}


def _retrieval_pair(kind, rng):
    jax_vcfg_cls, vcfg_cls, kw = CORES[kind]
    vcfg = vcfg_cls(**kw)
    text = dict(TEXT, encoder_width=vision_width(vcfg))
    jcfg = JaxXVLMConfig(vision=jax_vcfg_cls(**kw), text=JaxBertConfig(**text), embed_dim=16)
    jax_model = JaxXVLMForRetrieval(jcfg, dtype=jnp.float32)
    batch = {"image": rng.standard_normal((3, 32, 32, 3)).astype(np.float32),
             "text_ids": rng.integers(1, 60, (3, 7)).astype(np.int32),
             "text_atts": np.ones((3, 7), np.int32),
             "idx": np.array([0, 1, 2], np.int32)}
    batch["text_atts"][1, 4:] = 0
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    init = jax_model.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                          jb, rng=jax.random.PRNGKey(2))
    variables = _noisy(init, rng, 0.02)
    state, unused = convert_jax_params(_flatten(variables), device="cpu")
    assert unused == []
    port = XVLMForRetrieval(XVLMConfig(vision=vcfg, text=BertConfig(**text), embed_dim=16),
                            dtype=torch.float32, device="cpu", seed=None)
    port.load_state_dict(state)
    return jax_model, variables, port, batch


@pytest.mark.parametrize("kind", sorted(CORES))
def test_retrieval_losses_and_gradients_match_jax(kind):
    """ITC + ITM (the JAX hard-negative draws injected, dropout off) and
    every parameter's gradient against ``jax.value_and_grad``."""
    rng = np.random.default_rng(11)
    jax_model, variables, port, batch = _retrieval_pair(kind, rng)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(4)

    def negs(m, b, key):
        ie, _ = m.base.get_vision_embeds(b["image"], deterministic=True)
        te = m.base.get_text_embeds(b["text_ids"], b["text_atts"], deterministic=True)
        i_f, t_f = m.base.get_features(ie, te)
        return m.base.get_hard_negatives(i_f, t_f, key, idx=b["idx"])

    neg_idx = jax_model.apply(variables, jbatch, key, method=negs)

    def loss_fn(params):
        losses = jax_model.apply({"params": params}, jbatch, rng=key, deterministic=True)
        return sum(losses.values()), losses

    (_, want), grads = jax.value_and_grad(loss_fn, has_aux=True)(variables["params"])
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = port(tb, neg_idx=tuple(torch.from_numpy(np.array(x)).long() for x in neg_idx))
    for k in ("loss_itc", "loss_itm"):
        np.testing.assert_allclose(got[k].item(), float(want[k]), err_msg=k, **FWD)
    sum(got.values()).backward()
    got_g = to_jax_params({n: p.grad for n, p in port.named_parameters()})
    want_g = _flatten({"params": grads})
    assert set(got_g) == set(want_g)
    for k, w in want_g.items():
        np.testing.assert_allclose(got_g[k], np.asarray(w), err_msg=k, **GRAD)


# ---- decay mask and optimizer groups ----

def tree_leaf(tree, path):
    for part in path.split("/"):
        tree = tree[part]
    return tree


MASK_CORES = {"beit2": (JaxBEiT2Config, BEiT2Config,
                        dict(image_res=32, patch_size=16, embed_dim=32, depth=2,
                             num_heads=2)),
              "clip": CORES["clip"], "swin": CORES["swin"],
              "vit": (JaxViTConfig, ViTConfig, VIT)}


@pytest.mark.parametrize("kind", sorted(MASK_CORES))
def test_decay_mask_and_labels_match_jax(kind):
    """Every port parameter is marked with its index, carried to the JAX
    names by ``to_jax_params``: each JAX leaf it lands on has the port
    parameter's decay flag and optimizer group."""
    jax_vcfg_cls, vcfg_cls, kw = MASK_CORES[kind]
    vcfg = vcfg_cls(**kw)
    text = dict(TEXT, encoder_width=vision_width(vcfg))
    port = XVLMForRetrieval(XVLMConfig(vision=vcfg, text=BertConfig(**text), embed_dim=16),
                            dtype=torch.float32, device="cpu", seed=0)
    named = list(port.named_parameters())
    marked = {n: torch.full_like(p, float(i)) for i, (n, p) in enumerate(named)}
    leaves = {k[len("params/"):]: int(v.flat[0]) for k, v in to_jax_params(marked).items()}
    fresh = ["itm_head.0.weight", "vision_proj.bias"]
    labels = param_labels(named, 2, fresh_names=fresh)
    tree = {}
    for k in leaves:
        node = tree
        *parents, last = k.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = np.zeros(np.shape(to_jax_params(marked)["params/" + k]), np.float32)
    jax_labels = _flatten(jax_param_labels({"params": tree}, 2,
                                           fresh_paths=["itm_head/fc1/kernel",
                                                        "vision_proj/bias"]))
    seen = set()
    for k, i in leaves.items():
        name, p = named[i]
        seen.add(name)
        assert is_no_decay(name, p) == bool(_is_no_decay(k, tree_leaf(tree, k))), (name, k)
        assert labels[name] == str(jax_labels["params/" + k]), (name, k)
    assert seen == {n for n, _ in named}


def test_clip_position_table_is_not_decayed():
    p = torch.zeros(5, 4)
    assert is_no_decay("vision_encoder.pos_embed.weight", p)
    assert is_no_decay("vision_encoder.pos_embed", torch.zeros(1, 5, 4))
    assert not is_no_decay("text_encoder.bert.embeddings.position_embeddings.weight", p)
    assert not is_no_decay("vision_encoder.patch_embed.weight", torch.zeros(4, 3, 2, 2))


@pytest.mark.parametrize("kind", sorted(CORES))
def test_every_task_model_and_server_finds_its_device(kind):
    """CLIP has no ``cls_token`` and Swin no class token at all: the task
    models and servers find the device from the core, whatever the tower."""
    from x2vlm_tpu_torch.models import (
        XVLMForGrounding, XVLMForMLMCaptioning, XVLMForNLVR, XVLMForVQA,
    )
    from x2vlm_tpu_torch.serving import (
        CaptioningServer, GroundingServer, RetrievalServer, VQAServer,
    )

    _, vcfg_cls, kw = CORES[kind]
    vcfg = vcfg_cls(**kw)
    cfg = XVLMConfig(vision=vcfg, text=BertConfig(**TEXT, encoder_width=vision_width(vcfg)),
                     embed_dim=16)
    models = {cls: cls(cfg, dtype=torch.float32, device="cpu", seed=0) for cls in (
        XVLMForRetrieval, XVLMForGrounding, XVLMForNLVR, XVLMForVQA, XVLMForMLMCaptioning)}
    for cls, server in ((XVLMForRetrieval, RetrievalServer), (XVLMForGrounding, GroundingServer),
                        (XVLMForVQA, VQAServer), (XVLMForMLMCaptioning, CaptioningServer)):
        assert server(models[cls]).device == torch.device("cpu")
    assert models[XVLMForNLVR].cls_head[0].weight.device == torch.device("cpu")
    assert models[XVLMForMLMCaptioning].init_cache(2, 5)[0]["k"].device == torch.device("cpu")
    image = torch.randn(2, 32, 32, 3)
    embeds, atts = models[XVLMForRetrieval].get_vision_embeds(image)
    assert embeds.shape == (2, vision_seq_len(vcfg), vision_width(vcfg))
