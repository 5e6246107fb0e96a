"""X2VLM-large and the shipped configs, on the CPU.

- Every shipped YAML (``configs/**/*.yaml``) through the port's
  ``factory.xvlm_config_from_yaml`` gives the JAX factory's vision and text
  configs field for field (``remat`` / ``remat_policy`` among them) and
  its composition config; this pins the large presets (BEiT-2-large 24 x
  1024 with 16 heads, BERT-large 18 x 1024) and the JAX package's mapping
  of ``xlm-roberta-large`` to the ``roberta_base`` preset, which the port
  keeps.
- A 224 px ``.th`` of a 16-head tower imports at 768 px: every block's
  table interpolated 14 -> 48 as the JAX function interpolates it.
- ``configs/finetune/vqa2_large.yaml`` through the launcher with a tiny
  inline model: ``accumulate_steps`` 2 reaches the step (each step two
  microbatches of the question batch), ``remat`` under ``dots``
  rematerialises every block of the train step's forward, and
  ``large_lr_for_dec`` puts the whole decoder at ``lr_mult``.
"""

import dataclasses
import glob
import json
import os

import numpy as np
import pytest
from tests.torch_threads import few_torch_threads  # noqa: E402,F401 (autouse)

torch = pytest.importorskip("torch")

from tests.test_torch_vqa_data import TINY, corpus  # noqa: E402,F401
from x2vlm_tpu.factory import xvlm_config_from_yaml as jax_xvlm_config  # noqa: E402
from x2vlm_tpu.train.checkpoint import _interp_rel_pos_table  # noqa: E402
from x2vlm_tpu_torch import factory, run  # noqa: E402
from x2vlm_tpu_torch.core.config import load_config  # noqa: E402
from x2vlm_tpu_torch.models import BEiT2Config, XVLMConfig  # noqa: E402
from x2vlm_tpu_torch.models.xvlm import XVLMBase  # noqa: E402
from x2vlm_tpu_torch.ops import remat  # noqa: E402
from x2vlm_tpu_torch.train import checkpoint as ckpt_lib  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = sorted(os.path.relpath(p, ROOT)
               for p in glob.glob(os.path.join(ROOT, "configs", "**", "*.yaml"), recursive=True))
# fields of a JAX config the port's does not carry (Swin's CLS switch: the
# port always prepends the pooled token, the JAX default)
JAX_ONLY = {"SwinConfig": {"add_cls"}}


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def test_every_shipped_yaml_is_held():
    assert len(YAMLS) == 24


@pytest.mark.parametrize("path", YAMLS)
def test_shipped_yaml_builds_the_jax_factorys_configs(path):
    cfg = load_config(os.path.join(ROOT, path)).to_dict()
    got, want = factory.xvlm_config_from_yaml(cfg), jax_xvlm_config(cfg)
    assert type(got).__name__ == type(want).__name__
    for part in ("vision", "text"):
        g, w = getattr(got, part), getattr(want, part)
        assert type(g).__name__ == type(w).__name__
        assert set(_fields(w)) - set(_fields(g)) == JAX_ONLY.get(type(w).__name__, set())
        for name, value in _fields(g).items():
            assert value == getattr(w, name), (part, name)
    for name, value in _fields(got).items():
        if name not in ("vision", "text"):
            assert value == getattr(want, name), name
    assert got.vision.remat == got.text.remat == bool(cfg.get("remat", False))
    if got.is_plus:
        assert _fields(got.cross_config) == {
            k: v for k, v in _fields(want.cross_config).items() if k in _fields(got.text)}


def test_the_large_presets():
    """X2VLM-large: BEiT-2-large (24 blocks of width 1024, 16 heads) and the
    18-layer BERT-large text stack; ``vqa2_large.yaml`` remats both towers
    under ``dots``, the decoder and fusion stacks with the text config."""
    pre = factory.xvlm_config_from_yaml(
        load_config(os.path.join(ROOT, "configs/pretrain/x2vlm_large_4m.yaml")).to_dict())
    vqa = factory.xvlm_config_from_yaml(
        load_config(os.path.join(ROOT, "configs/finetune/vqa2_large.yaml")).to_dict())
    for cfg in (pre, vqa):
        v, t = cfg.vision, cfg.text
        assert (v.embed_dim, v.depth, v.num_heads) == (1024, 24, 16)
        assert (t.hidden_size, t.num_layers, t.fusion_layer, t.num_heads,
                t.intermediate_size, t.encoder_width) == (1024, 18, 12, 16, 4096, 1024)
    assert pre.vision.image_res == 224 and vqa.vision.image_res == 768
    assert not pre.vision.remat and not pre.text.remat
    assert (vqa.vision.remat, vqa.vision.remat_policy) == (True, "dots")
    assert (vqa.text.remat, vqa.text.remat_policy) == (True, "dots")


def test_xlm_roberta_large_keeps_the_base_preset():
    """The JAX factory maps ``xlm-roberta-large`` to ``roberta_base``: the
    multilingual large config builds a 24-layer XLM-R of width 768 over
    BEiT-2-large, in both packages."""
    cfg = load_config(os.path.join(
        ROOT, "configs/pretrain/multilingual_cclm_x2vlm_large.yaml")).to_dict()
    assert "xlm-roberta-large" in cfg["text_encoder"]
    got = factory.xvlm_config_from_yaml(cfg)
    assert got.is_plus and got.vision.embed_dim == 1024
    assert (got.text.hidden_size, got.text.num_heads, got.text.num_layers) == (768, 12, 24)
    assert got.text.hidden_size == jax_xvlm_config(cfg).text.hidden_size


@pytest.mark.parametrize("dst", [24, 48])
def test_a_16_head_th_imports_at_a_larger_window(tmp_path, dst):
    """A 224 px ``.th`` of a 2-block, 16-head tower into the same tower at
    384 / 768 px: each block's table interpolated 14 -> ``dst`` as the JAX
    ``_interp_rel_pos_table``, the rest loaded as it is."""
    vision = dict(patch_size=16, embed_dim=64, depth=2, num_heads=16, drop_path_rate=0.0)
    text = dict(vocab_size=40, hidden_size=32, num_layers=2, fusion_layer=1, num_heads=2,
                intermediate_size=64, encoder_width=64, max_position_embeddings=16)
    from x2vlm_tpu_torch.models import BertConfig
    src = XVLMBase(XVLMConfig(vision=BEiT2Config(image_res=224, **vision),
                              text=BertConfig(**text), embed_dim=16),
                   dtype=torch.float32, device="cpu", seed=1)
    state = src.state_dict()
    torch.save({"model": state}, tmp_path / "x.th")
    model = XVLMBase(XVLMConfig(vision=BEiT2Config(image_res=16 * dst, **vision),
                                text=BertConfig(**text), embed_dim=16),
                     dtype=torch.float32, device="cpu", seed=2)
    missing, _ = ckpt_lib.load_reference_checkpoint(model, str(tmp_path / "x.th"))
    assert missing == []
    got = model.state_dict()
    for i in range(2):
        k = f"vision_encoder.blocks.{i}.attn.relative_position_bias_table"
        want = _interp_rel_pos_table(state[k].numpy(), 14, dst)
        assert got[k].shape == ((2 * dst - 1) ** 2 + 3, 16)
        np.testing.assert_array_equal(got[k].numpy(), want)
    k = "vision_encoder.blocks.1.attn.qkv.weight"
    assert torch.equal(got[k], state[k])


def test_vqa2_large_through_the_launcher(corpus, monkeypatch):  # noqa: F811
    """``vqa2_large.yaml`` with a tiny inline model, 2 steps of 4 questions:
    the step made with ``accum_steps`` 2, two microbatches of 2 questions
    and the batch's 8 answer rows each, every block of the towers and the
    stacks rematerialised in each microbatch's forward, the decoder at
    ``lr_mult``, the loss finite."""
    cfg = load_config(os.path.join(ROOT, "configs/finetune/vqa2_large.yaml")).to_dict()
    assert (cfg["accumulate_steps"], cfg["remat"], cfg["remat_policy"],
            cfg["large_lr_for_dec"]) == (2, True, "dots", True)
    del cfg["vision_config"]
    cfg.update(TINY, text_encoder=str(corpus / "bert"), vqa_root=str(corpus / "imgs"),
               vg_root=str(corpus / "vg"), train_file=[str(corpus / "train.json")],
               test_file=[str(corpus / "test.json")], answer_list=str(corpus / "answers.json"),
               batch_size=4, batch_size_test=3, k_test=4, start_eval=0,
               schedular=dict(cfg["schedular"], epochs=1))
    seen = {"accum": [], "parts": [], "groups": None}
    make_step = run.make_train_step
    make_optimizer = run.make_optimizer

    def spy_step(model, optimizer, **kw):
        seen["accum"].append(kw.get("accum_steps"))
        at_mult = {optimizer.names[i] for (_, scale), idx in optimizer.groups if scale == 2.0
                   for i in idx}
        seen["groups"] = (at_mult, {n for n in optimizer.names if n.startswith("text_decoder.")})
        forward = model.forward

        def spied(batch, *a, **k):
            remat.rematerialised.calls.clear()
            out = forward(batch, *a, **k)
            seen["parts"].append((tuple(batch["question_ids"].shape),
                                  tuple(batch["answer_ids"].shape),
                                  dict(remat.rematerialised.calls)))
            return out

        model.forward = spied
        return make_step(model, optimizer, **kw)

    monkeypatch.setattr(run, "make_train_step", spy_step)
    monkeypatch.setattr(run, "make_optimizer", make_optimizer)
    path = corpus / "cfg_large.json"
    path.write_text(json.dumps(cfg))
    rec = run.main(["--task", "vqa", "--config", str(path), "--output_dir",
                    str(corpus / "out_large"), "--seed", "0", "--device", "cpu"])
    assert np.isfinite(rec["loss_vqa"]) and np.isfinite(rec["eval_overall"])
    assert seen["accum"] == [2]
    at_mult, decoder = seen["groups"]
    assert decoder and decoder <= at_mult
    blocks = {"BEiT2Block": 2, "BertLayer": 4 + TINY["num_dec_layers"]}
    assert seen["parts"] == [((2, 10), (8, 10), blocks)] * 4
