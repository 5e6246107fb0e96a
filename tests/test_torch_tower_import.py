"""The port's checkpoint converters against the JAX package's, on the same
fake state dicts (HF CLIP, timm Swin, raw BEiT-2, HF BERT): the port's
reference-named state dict, carried to the JAX names by
``convert.to_jax_params``, equals the JAX converter's flax tree bit for
bit (the Swin window resize within 1e-6 of the table's scale of
``jax.image.resize``, which computes in fp32).
``convert_jax_params`` and ``to_jax_params`` round-trip exactly for every
tower, head and the VQA decoder. ``load_reference_checkpoint`` resizes a
Swin file's window tables with the Swin resize and a BEiT-2 file's with
the 3-extra-row interpolation."""

import types

import numpy as np
import pytest
from tests.torch_threads import few_torch_threads  # noqa: E402,F401 (autouse)

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from x2vlm_tpu.serving import _flatten  # noqa: E402
from x2vlm_tpu.train import checkpoint as jax_ckpt  # noqa: E402
from x2vlm_tpu_torch.convert import convert_jax_params, to_jax_params  # noqa: E402
from x2vlm_tpu_torch.models import (  # noqa: E402
    BEiT2Config, BertConfig, CLIPViTConfig, SwinConfig, ViTConfig, XVLMConfig,
    XVLMForGrounding, XVLMForNLVR, XVLMForPretrain, XVLMForRetrieval, XVLMForVQA,
    vision_width,
)
from x2vlm_tpu_torch.train import checkpoint as ckpt  # noqa: E402


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def clip_file(rng, layers=2, width=32, tokens=5, raw=True):
    pre = "vision_model." if raw else ""
    emb = "vision_model.embeddings." if raw else ""
    sd = {f"{emb}patch_embedding.weight": _f32(rng, width, 3, 16, 16),
          f"{emb}class_embedding": _f32(rng, width),
          f"{emb}position_embedding.weight": _f32(rng, tokens, width),
          f"{emb}position_ids": np.arange(tokens),
          f"{pre}pre_layrnorm.weight": _f32(rng, width), f"{pre}pre_layrnorm.bias": _f32(rng, width),
          f"{pre}post_layernorm.weight": _f32(rng, width),
          f"{pre}post_layernorm.bias": _f32(rng, width)}
    for i in range(layers):
        p = f"{pre}encoder.layers.{i}"
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[f"{p}.self_attn.{proj}.weight"] = _f32(rng, width, width)
            sd[f"{p}.self_attn.{proj}.bias"] = _f32(rng, width)
        for ln in ("layer_norm1", "layer_norm2"):
            sd[f"{p}.{ln}.weight"] = _f32(rng, width)
            sd[f"{p}.{ln}.bias"] = _f32(rng, width)
        sd[f"{p}.mlp.fc1.weight"] = _f32(rng, 2 * width, width)
        sd[f"{p}.mlp.fc1.bias"] = _f32(rng, 2 * width)
        sd[f"{p}.mlp.fc2.weight"] = _f32(rng, width, 2 * width)
        sd[f"{p}.mlp.fc2.bias"] = _f32(rng, width)
    return sd


def swin_file(rng, depths=(2, 1), dims=(16, 32), heads=(2, 4), window=4):
    sd = {"patch_embed.proj.weight": _f32(rng, dims[0], 3, 4, 4),
          "patch_embed.proj.bias": _f32(rng, dims[0]),
          "patch_embed.norm.weight": _f32(rng, dims[0]),
          "patch_embed.norm.bias": _f32(rng, dims[0]),
          "norm.weight": _f32(rng, dims[-1]), "norm.bias": _f32(rng, dims[-1]),
          "head.weight": _f32(rng, 10, dims[-1])}
    for s, (depth, dim, h) in enumerate(zip(depths, dims, heads)):
        for b in range(depth):
            p = f"layers.{s}.blocks.{b}"
            for ln in ("norm1", "norm2"):
                sd[f"{p}.{ln}.weight"] = _f32(rng, dim)
                sd[f"{p}.{ln}.bias"] = _f32(rng, dim)
            sd[f"{p}.attn.qkv.weight"] = _f32(rng, 3 * dim, dim)
            sd[f"{p}.attn.qkv.bias"] = _f32(rng, 3 * dim)
            sd[f"{p}.attn.proj.weight"] = _f32(rng, dim, dim)
            sd[f"{p}.attn.proj.bias"] = _f32(rng, dim)
            sd[f"{p}.attn.relative_position_bias_table"] = _f32(rng, (2 * window - 1) ** 2, h)
            sd[f"{p}.attn.relative_position_index"] = np.zeros((window ** 2,) * 2, np.int64)
            sd[f"{p}.attn_mask"] = np.zeros((4, window ** 2, window ** 2), np.float32)
            sd[f"{p}.mlp.fc1.weight"] = _f32(rng, 4 * dim, dim)
            sd[f"{p}.mlp.fc1.bias"] = _f32(rng, 4 * dim)
            sd[f"{p}.mlp.fc2.weight"] = _f32(rng, dim, 4 * dim)
            sd[f"{p}.mlp.fc2.bias"] = _f32(rng, dim)
        if s < len(depths) - 1:
            sd[f"layers.{s}.downsample.reduction.weight"] = _f32(rng, 2 * dim, 4 * dim)
            sd[f"layers.{s}.downsample.norm.weight"] = _f32(rng, 4 * dim)
            sd[f"layers.{s}.downsample.norm.bias"] = _f32(rng, 4 * dim)
    return sd


def beit_file(rng, depth=2, width=32, heads=2, window=2, shared=True):
    n_rel = (2 * window - 1) ** 2 + 3
    sd = {"cls_token": _f32(rng, 1, 1, width), "patch_embed.proj.weight": _f32(rng, width, 3, 16, 16),
          "patch_embed.proj.bias": _f32(rng, width), "fc_norm.weight": _f32(rng, width),
          "fc_norm.bias": _f32(rng, width), "head.weight": _f32(rng, 10, width),
          "head.bias": _f32(rng, 10)}
    if shared:
        sd["rel_pos_bias.relative_position_bias_table"] = _f32(rng, n_rel, heads)
    for i in range(depth):
        p = f"blocks.{i}"
        for n in ("norm1", "norm2"):
            sd[f"{p}.{n}.weight"] = _f32(rng, width)
            sd[f"{p}.{n}.bias"] = _f32(rng, width)
        sd[f"{p}.attn.qkv.weight"] = _f32(rng, 3 * width, width)
        sd[f"{p}.attn.q_bias"] = _f32(rng, width)
        sd[f"{p}.attn.v_bias"] = _f32(rng, width)
        sd[f"{p}.attn.proj.weight"] = _f32(rng, width, width)
        sd[f"{p}.attn.proj.bias"] = _f32(rng, width)
        sd[f"{p}.gamma_1"] = _f32(rng, width)
        sd[f"{p}.gamma_2"] = _f32(rng, width)
        sd[f"{p}.mlp.fc1.weight"] = _f32(rng, 4 * width, width)
        sd[f"{p}.mlp.fc1.bias"] = _f32(rng, 4 * width)
        sd[f"{p}.mlp.fc2.weight"] = _f32(rng, width, 4 * width)
        sd[f"{p}.mlp.fc2.bias"] = _f32(rng, width)
        if not shared:
            sd[f"{p}.attn.relative_position_bias_table"] = _f32(rng, n_rel, heads)
    return sd


def bert_file(rng, layers=4, width=32, vocab=50, bert_prefix=True):
    b = "bert." if bert_prefix else ""
    sd = {f"{b}embeddings.word_embeddings.weight": _f32(rng, vocab, width),
          f"{b}embeddings.position_embeddings.weight": _f32(rng, 16, width),
          f"{b}embeddings.token_type_embeddings.weight": _f32(rng, 2, width),
          f"{b}embeddings.LayerNorm.weight": _f32(rng, width),
          f"{b}embeddings.LayerNorm.bias": _f32(rng, width),
          f"{b}pooler.dense.weight": _f32(rng, width, width),
          f"{b}pooler.dense.bias": _f32(rng, width)}
    for i in range(layers):
        p = f"{b}encoder.layer.{i}"
        for proj in ("query", "key", "value"):
            sd[f"{p}.attention.self.{proj}.weight"] = _f32(rng, width, width)
            sd[f"{p}.attention.self.{proj}.bias"] = _f32(rng, width)
        sd[f"{p}.attention.output.dense.weight"] = _f32(rng, width, width)
        sd[f"{p}.attention.output.dense.bias"] = _f32(rng, width)
        for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[f"{p}.{ln}.weight"] = _f32(rng, width)
            sd[f"{p}.{ln}.bias"] = _f32(rng, width)
        sd[f"{p}.intermediate.dense.weight"] = _f32(rng, 2 * width, width)
        sd[f"{p}.intermediate.dense.bias"] = _f32(rng, 2 * width)
        sd[f"{p}.output.dense.weight"] = _f32(rng, width, 2 * width)
        sd[f"{p}.output.dense.bias"] = _f32(rng, width)
    if bert_prefix:
        sd.update({"cls.predictions.transform.dense.weight": _f32(rng, width, width),
                   "cls.predictions.transform.dense.bias": _f32(rng, width),
                   "cls.predictions.transform.LayerNorm.weight": _f32(rng, width),
                   "cls.predictions.transform.LayerNorm.bias": _f32(rng, width),
                   "cls.predictions.decoder.weight": _f32(rng, vocab, width),
                   "cls.predictions.bias": _f32(rng, vocab),
                   "cls.seq_relationship.weight": _f32(rng, 2, width)})
    return sd


def _as_jax(state):
    """The port's state under the JAX names, ``params/base/`` dropped."""
    return {k.split("/", 2)[2] if k.startswith("params/base/") else k[len("params/"):]: v
            for k, v in to_jax_params(state).items()}


def _assert_same(port_state, jax_tree, prefix="", resized=False):
    """Equal bit for bit; a resized Swin table within 1e-6 of its scale."""
    want = {prefix + k: np.asarray(v) for k, v in _flatten(jax_tree).items()}
    got = _as_jax(port_state)
    assert set(got) == set(want)
    for k, w in want.items():
        if resized and k.endswith("rel_pos_table"):
            np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-6 * np.abs(w).max(),
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], w.astype(np.float32), err_msg=k)


@pytest.mark.parametrize("raw,src_layers", [(True, 2), (False, 2), (True, 4)],
                         ids=["hf_names", "stripped", "2N_to_N"])
def test_clip_converter_matches_jax(raw, src_layers):
    rng = np.random.default_rng(src_layers)
    sd = clip_file(rng, layers=src_layers, raw=raw)
    tree, unused = jax_ckpt.convert_clip_vit_checkpoint(sd, depth=2)
    state, p_unused = ckpt.convert_clip_vit_checkpoint(sd, depth=2)
    _assert_same(state, tree, "vision_encoder/")
    if src_layers == 4:   # layers 1 and 3 taken; 0 and 2 left over
        assert {k.split(".")[2] for k in p_unused} == {"0", "2"}
        np.testing.assert_array_equal(
            state["vision_encoder.encoder.layers.0.mlp.fc1.weight"].numpy(),
            sd[("vision_model." if raw else "") + "encoder.layers.1.mlp.fc1.weight"])
    assert p_unused == sorted(unused)


@pytest.mark.parametrize("dst_window", [None, 6, 3])
def test_swin_converter_matches_jax(dst_window):
    rng = np.random.default_rng(1)
    sd = swin_file(rng)
    tree, unused = jax_ckpt.convert_swin_checkpoint(sd, depths=(2, 1), dst_window=dst_window)
    state, p_unused = ckpt.convert_swin_checkpoint(sd, depths=(2, 1), dst_window=dst_window)
    _assert_same(state, tree, "vision_encoder/", resized=dst_window is not None)
    assert unused == p_unused == []


@pytest.mark.parametrize("src,dst", [(7, 12), (12, 7)])
def test_swin_window_resize_matches_jax_image_resize(src, dst):
    rng = np.random.default_rng(src)
    table = _f32(rng, (2 * src - 1) ** 2, 4)
    want = jax_ckpt._interp_swin_rel_pos_table(table, dst)
    got = ckpt.resize_swin_rel_pos_table(table, dst)
    assert got.shape == want.shape == ((2 * dst - 1) ** 2, 4) and got.dtype == np.float32
    # the JAX resize computes in fp32, the port's in float64: within 1e-6
    # of the table's scale
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(table).max())
    # not torch's bicubic (a = -0.75, no antialiasing): that one differs
    body = torch.from_numpy(table.reshape(2 * src - 1, 2 * src - 1, 4)).permute(2, 0, 1)
    torch_cubic = torch.nn.functional.interpolate(body[None], size=(2 * dst - 1,) * 2,
                                                  mode="bicubic", align_corners=False)
    assert np.abs(torch_cubic[0].permute(1, 2, 0).reshape(-1, 4).numpy() - want).max() > 1e-3


@pytest.mark.parametrize("shared,dst_window", [(True, None), (False, 3), (True, 3)])
def test_beit2_converter_matches_jax(shared, dst_window):
    rng = np.random.default_rng(2)
    sd = beit_file(rng, shared=shared)
    tree, unused = jax_ckpt.convert_beit2_checkpoint(sd, depth=2, dst_window=dst_window)
    state, p_unused = ckpt.convert_beit2_checkpoint(sd, depth=2, dst_window=dst_window)
    _assert_same(state, tree, "vision_encoder/")
    assert unused == p_unused == []


@pytest.mark.parametrize("bert_prefix,to_layers", [(True, 6), (False, 6), (True, 4)])
def test_hf_bert_converter_matches_jax(bert_prefix, to_layers):
    """The text layers expanded 4 -> 6 (layers 2, 3 copied into 4, 5), the
    MLM head kept; the tied decoder weight, pooler and NSP head are not the
    port's parameters (a model reports them unexpected)."""
    rng = np.random.default_rng(3)
    sd = bert_file(rng, bert_prefix=bert_prefix)
    tree, _ = jax_ckpt.convert_hf_bert_checkpoint(sd, to_layers=to_layers, fusion_layer=4)
    state, unused = ckpt.convert_hf_bert_checkpoint(sd, to_layers=to_layers, fusion_layer=4)
    assert unused == ([] if bert_prefix else ["pooler.dense.bias", "pooler.dense.weight"])
    cfg = XVLMConfig(vision=BEiT2Config(image_res=32, patch_size=16, embed_dim=32, depth=1,
                                        num_heads=2),
                     text=BertConfig(vocab_size=50, hidden_size=32, num_layers=to_layers,
                                     fusion_layer=4, num_heads=2, intermediate_size=64,
                                     encoder_width=32, max_position_embeddings=16),
                     embed_dim=8)
    own = XVLMForPretrain(cfg, dtype=torch.float32, device="cpu", seed=0).base.state_dict()
    carried = {k: v for k, v in state.items() if k in own}
    assert sorted(set(state) - set(carried)) == sorted(
        k for k in state if "pooler" in k or "seq_relationship" in k or "decoder.weight" in k)
    mlm = tree.pop("mlm_head", {})
    mlm.pop("decoder", None)
    _assert_same(carried, dict(tree, **({"mlm_head": mlm} if mlm else {})))


def xlmr_file(rng, layers=2, width=32, vocab=50):
    """An HF XLM-R file: ``roberta.*`` (one token type, 514-style offset
    positions) and the ``lm_head`` with its tied decoder and bias."""
    sd = {k.replace("bert.", "roberta."): v for k, v in
          bert_file(rng, layers=layers, width=width, vocab=vocab).items()
          if k.startswith("bert.")}
    sd["roberta.embeddings.token_type_embeddings.weight"] = _f32(rng, 1, width)
    sd.update({"lm_head.dense.weight": _f32(rng, width, width),
               "lm_head.dense.bias": _f32(rng, width),
               "lm_head.layer_norm.weight": _f32(rng, width),
               "lm_head.layer_norm.bias": _f32(rng, width),
               "lm_head.decoder.weight": _f32(rng, vocab, width),
               "lm_head.decoder.bias": _f32(rng, vocab), "lm_head.bias": _f32(rng, vocab)})
    return sd


def test_an_xlmr_file_converts_as_the_jax_one():
    """A raw XLM-R file (formerly refused with A8b) lands under the
    xroberta names of a Plus model's text tower: bit for bit the JAX
    converter's tree after ``to_jax_params``; the pooler and the tied
    decoder weight are not the model's."""
    import dataclasses

    from x2vlm_tpu_torch.models import XVLMPlusConfig, XVLMPlusForPretrain

    rng = np.random.default_rng(5)
    sd = xlmr_file(rng)
    tree, _ = jax_ckpt.convert_hf_bert_checkpoint(sd, to_layers=2, fusion_layer=2)
    state, unused, kind = ckpt.convert_checkpoint_auto(sd, text_layers=2, text_fusion_layer=2)
    assert kind == "bert" and unused == []
    text = dataclasses.replace(BertConfig.roberta_base(
        vocab_size=50, hidden_size=32, num_layers=2, fusion_layer=2, num_heads=2,
        intermediate_size=64, encoder_width=32), max_position_embeddings=16)
    cfg = XVLMPlusConfig(vision=BEiT2Config(image_res=32, patch_size=16, embed_dim=32,
                                            depth=1, num_heads=2),
                         text=text, embed_dim=8, num_cross_layers=1)
    own = XVLMPlusForPretrain(cfg, dtype=torch.float32, device="cpu", seed=0).base.state_dict()
    carried = {k: v for k, v in state.items() if k in own}
    assert sorted(set(state) - set(carried)) == sorted(
        k for k in state if "pooler" in k or ".decoder." in k)
    mlm = tree.pop("mlm_head")
    mlm.pop("decoder")
    _assert_same(carried, dict(tree, mlm_head=mlm))


@pytest.mark.parametrize("flavour", ["clip", "swin", "beit2", "bert", "xvlm"])
def test_convert_checkpoint_auto_picks_the_flavour(flavour):
    rng = np.random.default_rng(4)
    sd = {"clip": clip_file(rng), "swin": swin_file(rng), "beit2": beit_file(rng),
          "bert": bert_file(rng),
          "xvlm": {"vision_encoder.cls_token": _f32(rng, 1, 1, 32)}}[flavour]
    vcfg = {"clip": CLIPViTConfig(image_res=32, patch_size=16, embed_dim=32, depth=2,
                                  num_heads=2, intermediate_size=64),
            "swin": SwinConfig(image_res=32, patch_size=4, embed_dim=16, depths=(2, 1),
                               num_heads=(2, 4), window_size=4)}.get(flavour)
    state, _, kind = ckpt.convert_checkpoint_auto(sd, vision_cfg=vcfg, text_layers=6,
                                                  text_fusion_layer=4)
    jax_vcfg = types.SimpleNamespace(depth=2, depths=(2, 1), window_size=4)
    _, _, jax_kind = jax_ckpt.convert_checkpoint_auto(sd, vision_cfg=jax_vcfg, text_layers=6,
                                                      text_fusion_layer=4)
    assert kind == jax_kind == flavour
    assert all(k.startswith(("vision_encoder.", "text_encoder.")) for k in state)


# ---- load_reference_checkpoint: the window tables by tower ----

def _swin_model(window):
    vcfg = SwinConfig(image_res=32, patch_size=4, embed_dim=16, depths=(2, 1),
                      num_heads=(2, 4), window_size=window, drop_path_rate=0.0)
    text = BertConfig(vocab_size=50, hidden_size=32, num_layers=2, fusion_layer=1, num_heads=2,
                      intermediate_size=64, encoder_width=vision_width(vcfg),
                      max_position_embeddings=16)
    return XVLMForRetrieval(XVLMConfig(vision=vcfg, text=text, embed_dim=8),
                            dtype=torch.float32, device="cpu", seed=0)


def test_a_swin_file_at_another_window_loads_through_the_swin_resize():
    """A window-4 X2-VLM Swin file into a window-2 model (the 8 x 8 grid,
    then 4 x 4): every table resized on its square lattice, without the 3
    cls rows BEiT-2's interpolation assumes."""
    rng = np.random.default_rng(5)
    src = {f"vision_encoder.{k}": torch.from_numpy(np.asarray(v))
           for k, v in swin_file(rng).items()}
    model = _swin_model(2)
    missing, unexpected = ckpt.load_reference_checkpoint(model, src)
    assert not [k for k in missing if k.startswith("vision_encoder.")]
    assert not [k for k in unexpected if "relative_position_bias_table" in k]
    for s, b in ((0, 0), (0, 1), (1, 0)):
        name = f"vision_encoder.layers.{s}.blocks.{b}.attn.relative_position_bias_table"
        want = jax_ckpt._interp_swin_rel_pos_table(src[name].numpy(), 2)
        np.testing.assert_allclose(model.state_dict()[name].numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())


def test_a_beit2_file_at_another_resolution_keeps_the_cls_rows():
    rng = np.random.default_rng(6)
    src = {f"vision_encoder.{k}": torch.from_numpy(np.asarray(v))
           for k, v in beit_file(rng, window=2, shared=False).items()}
    vcfg = BEiT2Config(image_res=48, patch_size=16, embed_dim=32, depth=2, num_heads=2)
    text = BertConfig(vocab_size=50, hidden_size=32, num_layers=2, fusion_layer=1, num_heads=2,
                      intermediate_size=64, encoder_width=32, max_position_embeddings=16)
    model = XVLMForRetrieval(XVLMConfig(vision=vcfg, text=text, embed_dim=8),
                             dtype=torch.float32, device="cpu", seed=0)
    ckpt.load_reference_checkpoint(model, src)
    name = "vision_encoder.blocks.1.attn.relative_position_bias_table"
    want = jax_ckpt._interp_rel_pos_table(src[name].numpy(), 2, 3)
    got = model.state_dict()[name].numpy()
    np.testing.assert_array_equal(got, ckpt.interp_rel_pos_table(src[name].numpy(), 2, 3))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[-3:], src[name].numpy()[-3:])


# ---- convert_jax_params <-> to_jax_params ----

TEXT = dict(vocab_size=50, hidden_size=32, num_layers=3, fusion_layer=2, num_heads=2,
            intermediate_size=64, max_position_embeddings=16)
VISION = {"beit2": BEiT2Config(image_res=32, patch_size=16, embed_dim=32, depth=2, num_heads=2),
          "clip": CLIPViTConfig(image_res=32, patch_size=16, embed_dim=32, depth=2,
                                num_heads=2, intermediate_size=64),
          "swin": SwinConfig(image_res=32, patch_size=4, embed_dim=16, depths=(2, 1),
                             num_heads=(2, 4), window_size=4),
          "vit": ViTConfig(image_res=32, patch_size=16, embed_dim=32, depth=2, num_heads=2)}
MODELS = {"pretrain": lambda c: XVLMForPretrain(c, dtype=torch.float32, device="cpu", seed=1),
          "grounding": lambda c: XVLMForGrounding(c, dtype=torch.float32, device="cpu", seed=1),
          "nlvr": lambda c: XVLMForNLVR(c, dtype=torch.float32, device="cpu", seed=1),
          "vqa": lambda c: XVLMForVQA(c, num_dec_layers=2, dtype=torch.float32, device="cpu",
                                      seed=1)}


@pytest.mark.parametrize("tower", sorted(VISION))
@pytest.mark.parametrize("task", sorted(MODELS))
def test_the_two_converters_round_trip_exactly(tower, task):
    vcfg = VISION[tower]
    cfg = XVLMConfig(vision=vcfg, text=BertConfig(**TEXT, encoder_width=vision_width(vcfg)),
                     embed_dim=8)
    state = MODELS[task](cfg).state_dict()
    flat = to_jax_params(state)
    back, unused = convert_jax_params(flat, device="cpu")
    strip = {k[len("base."):] if k.startswith("base.") else k: v for k, v in state.items()}
    assert unused == [] and set(back) == set(strip)
    for k, v in strip.items():
        assert torch.equal(back[k], v), k
    again = to_jax_params(back)
    assert set(again) == set(flat) and all(np.array_equal(again[k], flat[k]) for k in flat)


def test_to_jax_params_names_equal_the_jax_models_tree():
    """A CLIP and a Swin retrieval model: the JAX ``init`` tree's names are
    exactly the exported ones."""
    from x2vlm_tpu.models import BertConfig as JaxBertConfig
    from x2vlm_tpu.models import XVLMConfig as JaxXVLMConfig
    from x2vlm_tpu.models.clip_vit import CLIPViTConfig as JaxCLIPViTConfig
    from x2vlm_tpu.models.heads import XVLMForRetrieval as JaxXVLMForRetrieval
    from x2vlm_tpu.models.swin import SwinConfig as JaxSwinConfig

    rng = np.random.default_rng(0)
    batch = {"image": jnp.asarray(_f32(rng, 2, 32, 32, 3)),
             "text_ids": jnp.asarray(rng.integers(1, 50, (2, 6)), jnp.int32),
             "text_atts": jnp.ones((2, 6), jnp.int32), "idx": jnp.arange(2)}
    for jv, pv in ((JaxCLIPViTConfig(image_res=32, patch_size=16, embed_dim=32, depth=2,
                                     num_heads=2, intermediate_size=64), VISION["clip"]),
                   (JaxSwinConfig(image_res=32, patch_size=4, embed_dim=16, depths=(2, 1),
                                  num_heads=(2, 4), window_size=4), VISION["swin"])):
        w = vision_width(pv)
        jmodel = JaxXVLMForRetrieval(JaxXVLMConfig(
            vision=jv, text=JaxBertConfig(**TEXT, encoder_width=w), embed_dim=8),
            dtype=jnp.float32)
        init = jmodel.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                           batch, rng=jax.random.PRNGKey(2))
        port = XVLMForRetrieval(XVLMConfig(vision=pv, text=BertConfig(**TEXT, encoder_width=w),
                                           embed_dim=8), dtype=torch.float32, device="cpu")
        flat = to_jax_params(port.state_dict())
        want = _flatten(init)
        assert set(flat) == set(want)
        assert all(flat[k].shape == np.shape(want[k]) for k in want)
