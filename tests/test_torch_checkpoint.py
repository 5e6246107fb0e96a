"""The reference ``.th`` import and the train state's save / resume.

Import: a ``GoldenXVLM`` state dict (reference names) saved as a ``.th``
goes into the port through ``load_reference_checkpoint`` and into the JAX
package through ``convert_xvlm_state_dict`` + ``merge_imported``; the
vision, text, cross, feature and head outputs agree in fp32 (rtol = atol =
1e-4), at the checkpoint's resolution and with the rel-pos tables
interpolated to another (32 -> 48 px, window 2 -> 3), and the port's table
interpolation equals the JAX ``_interp_rel_pos_table``.

Save / resume: parameters, AdamW ``mu`` / ``nu`` / ``count``, step and data
cursors round-trip bit for bit."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests.golden_torch import GoldenXVLM  # noqa: E402
from x2vlm_tpu.models import (  # noqa: E402
    BEiT2Config as JaxBEiT2Config, BertConfig as JaxBertConfig,
    XVLMConfig as JaxXVLMConfig, XVLMForPretrain as JaxXVLMForPretrain,
)
from x2vlm_tpu.models.heads import pretrain_init_inputs  # noqa: E402
from x2vlm_tpu.train.checkpoint import (  # noqa: E402
    _interp_rel_pos_table, convert_xvlm_state_dict, merge_imported,
)
from x2vlm_tpu_torch.models import (  # noqa: E402
    BEiT2Config, BertConfig, XVLMConfig, XVLMForPretrain, XVLMForRetrieval,
)
from x2vlm_tpu_torch.train import create_optimizer, lr_schedule  # noqa: E402
from x2vlm_tpu_torch.train.checkpoint import (  # noqa: E402
    import_report, interp_rel_pos_table, load_reference_checkpoint, load_torch_checkpoint, restore_train_state, save_train_state,
)

TOL = dict(rtol=1e-4, atol=1e-4)
TEXT = dict(vocab_size=100, hidden_size=32, num_layers=4, fusion_layer=2, num_heads=2,
            intermediate_size=64, encoder_width=32, hidden_dropout=0.0, attn_dropout=0.0,
            max_position_embeddings=64)


def _vision(res):
    return dict(image_res=res, patch_size=16, embed_dim=32, depth=2, num_heads=2,
                drop_path_rate=0.0, dropout_rate=0.0)


@pytest.fixture(scope="module")
def golden_th(tmp_path_factory):
    torch.manual_seed(0)
    golden = GoldenXVLM().eval()
    path = tmp_path_factory.mktemp("th") / "golden.th"
    torch.save({"model": {f"module.{k}": v for k, v in golden.state_dict().items()}}, path)
    return str(path), {k: v.detach().numpy() for k, v in golden.state_dict().items()}


def _batch(res):
    rng = np.random.default_rng(res)
    ids = rng.integers(0, 100, (2, 8)).astype(np.int32)
    atts = np.ones((2, 8), np.int32)
    atts[1, 6:] = 0
    return {"image": rng.standard_normal((2, res, res, 3)).astype(np.float32),
            "text_ids": ids, "text_atts": atts,
            "masked_pos": np.array([[1, 3], [2, 4]], np.int32),
            "masked_ids": np.array([[5, 7], [9, -100]], np.int32)}


def _jax_outputs(sd, res):
    cfg = JaxXVLMConfig(vision=JaxBEiT2Config(**_vision(res)), text=JaxBertConfig(**TEXT),
                        embed_dim=16)
    model = JaxXVLMForPretrain(cfg, dtype=jnp.float32)
    init = model.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                      pretrain_init_inputs(cfg), rng=jax.random.PRNGKey(2), ret_bbox_loss=True)
    tree, _ = convert_xvlm_state_dict(sd, vision_depth=2, dst_window=res // 16)
    params, _ = merge_imported(init, tree)
    b = {k: jnp.asarray(v) for k, v in _batch(res).items()}

    def outs(m):
        base = m.base
        ie, ia = base.get_vision_embeds(b["image"], deterministic=True)
        te = base.get_text_embeds(b["text_ids"], b["text_atts"], deterministic=True)
        fi, ft = base.get_features(ie, te)
        cross = base.get_cross_embeds(ie, ia, text_ids=b["text_ids"], text_atts=b["text_atts"],
                                      deterministic=True)
        mlm = base.mlm_head(cross, masked_pos=b["masked_pos"],
                            embedding_table=base._tied_table(), labels=b["masked_ids"])
        return dict(vision=ie, text=te, image_feat=fi, text_feat=ft, cross=cross,
                    itm=base.itm_head(cross[:, 0]), mlm=mlm)

    return {k: np.asarray(v) for k, v in model.apply(params, method=outs).items()}


def _port_outputs(model, res):
    base = model.base
    b = {k: torch.from_numpy(v) for k, v in _batch(res).items()}
    with torch.no_grad():
        ie, ia = base.get_vision_embeds(b["image"])
        te = base.get_text_embeds(b["text_ids"], b["text_atts"])
        cross = base.get_cross_embeds(ie, ia, text_ids=b["text_ids"], text_atts=b["text_atts"])
        mlm = base.text_encoder.mlm_head(cross, b["masked_pos"].long(), base._tied_table(),
                                         b["masked_ids"].long())
        return {k: v.float().numpy() for k, v in dict(
            vision=ie, text=te, image_feat=base.get_features(image_embeds=ie),
            text_feat=base.get_features(text_embeds=te), cross=cross,
            itm=base.itm_head(cross[:, 0]), mlm=mlm).items()}


@pytest.mark.parametrize("res", [32, 48])
def test_th_import_outputs_equal_jax(golden_th, res):
    path, sd = golden_th
    model = XVLMForPretrain(XVLMConfig(vision=BEiT2Config(**_vision(res)),
                                       text=BertConfig(**TEXT), embed_dim=16),
                            dtype=torch.float32, device="cpu", seed=1)
    missing, unexpected = load_reference_checkpoint(model, path)
    assert missing == []
    # the bbox head loads into the pretraining model; left over are the tied
    # decoder and the static index tables
    assert sorted({k.split(".")[0] for k in unexpected}) == ["text_encoder",
                                                             "vision_encoder"]
    assert all(k.endswith("relative_position_index")
               or k == "text_encoder.cls.predictions.decoder.weight" for k in unexpected)
    got, want = _port_outputs(model, res), _jax_outputs(sd, res)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


@pytest.mark.parametrize("src,dst,heads", [(2, 3, 2), (14, 24, 3), (7, 7, 2), (24, 14, 1)])
def test_interp_rel_pos_table_equals_jax(src, dst, heads):
    rng = np.random.default_rng(src * dst)
    table = rng.standard_normal(((2 * src - 1) ** 2 + 3, heads)).astype(np.float32)
    got = interp_rel_pos_table(table, src, dst)
    np.testing.assert_array_equal(got, _interp_rel_pos_table(table, src, dst))
    assert got.shape == ((2 * dst - 1) ** 2 + 3, heads)


def test_retrieval_model_import_reports_the_mlm_head_unexpected(golden_th, tmp_path):
    path, _ = golden_th
    model = XVLMForRetrieval(XVLMConfig(vision=BEiT2Config(**_vision(32)),
                                        text=BertConfig(**TEXT), embed_dim=16),
                             dtype=torch.float32, device="cpu", seed=1)
    missing, unexpected = load_reference_checkpoint(model, load_torch_checkpoint(path))
    assert missing == []
    assert {k for k in unexpected if k.startswith("text_encoder.cls.predictions.")} == {
        "text_encoder.cls.predictions.bias", "text_encoder.cls.predictions.decoder.weight",
        "text_encoder.cls.predictions.transform.LayerNorm.bias",
        "text_encoder.cls.predictions.transform.LayerNorm.weight",
        "text_encoder.cls.predictions.transform.dense.bias",
        "text_encoder.cls.predictions.transform.dense.weight"}
    # a partial file: the subtree it lacks is reported wholly fresh
    sd = {k: v for k, v in load_torch_checkpoint(path).items() if not k.startswith("itm_head")}
    missing, unexpected = load_reference_checkpoint(model, sd)
    assert missing == [f"itm_head.{i}.{p}" for i in (0, 1, 3) for p in ("bias", "weight")]
    assert "fully-fresh subtrees: ['itm_head']" in import_report(model, missing, unexpected, "x")
    out = tmp_path / "export.th"   # the port's state dict is a reference .th
    torch.save({"model": model.state_dict()}, out)
    again = XVLMForRetrieval(model.config, dtype=torch.float32, device="cpu", seed=2)
    assert load_reference_checkpoint(again, str(out)) == ([], [])
    for (n, p), (_, q) in zip(model.named_parameters(), again.named_parameters()):
        assert torch.equal(p, q), n


def test_a_shape_mismatch_raises(golden_th):
    path, _ = golden_th
    text = dict(TEXT, hidden_size=48, encoder_width=32)
    model = XVLMForRetrieval(XVLMConfig(vision=BEiT2Config(**_vision(32)),
                                        text=BertConfig(**text), embed_dim=16),
                             dtype=torch.float32, device="cpu", seed=1)
    with pytest.raises(ValueError, match="shape mismatch"):
        load_reference_checkpoint(model, path)


def test_train_state_round_trip_is_exact(tmp_path):
    cfg = XVLMConfig(vision=BEiT2Config(**_vision(32)), text=BertConfig(**TEXT), embed_dim=16)
    model = XVLMForRetrieval(cfg, dtype=torch.float32, device="cpu", seed=1)
    opt = create_optimizer(model, lr_schedule(1e-3, 10, 0))
    for p in opt.params:
        p.grad = torch.randn_like(p)
    opt.step()
    cursors = {"image": {"epoch": 1, "file_idx": 2, "line_idx": 3}}
    save_train_state(str(tmp_path), model, opt, 7, data_state=cursors)
    fresh = XVLMForRetrieval(cfg, dtype=torch.float32, device="cpu", seed=5)
    opt2 = create_optimizer(fresh, lr_schedule(1e-3, 10, 0))
    step, data_state = restore_train_state(str(tmp_path), fresh, opt2)
    assert step == 7 and data_state == cursors and opt2.count == opt.count == 1
    for (n, p), (_, q) in zip(model.named_parameters(), fresh.named_parameters()):
        assert torch.equal(p, q), n
    for a, b in zip(opt.mu + opt.nu, opt2.mu + opt2.nu):
        assert torch.equal(a, b)
    assert restore_train_state(str(tmp_path / "none"), fresh, opt2) == (None, {})
    assert not list(tmp_path.glob("*.tmp"))
