"""The CCLM-large config against the JAX package on the CPU.

``multilingual_cclm_x2vlm_large.yaml`` (``is_xvlm_ckpt``,
``replace_text_encoder``) with an X2VLM-large ``.th`` at the shipped
widths (BEiT-2-large 1024 x 16 heads, BERT-large 1024 x 16 heads; the
depths cut to 1-2 layers): the JAX factory builds its XLM-R, and so its
standalone cross encoder, at width 768, the ``.th``'s fusion layers are
1024 wide, and both launchers refuse the import on a shape mismatch (1024
in the file, 768 in the model). At those widths the parallel-text loss
raises in both packages too (the cross encoder's cross-attention takes
1024-wide keys; language 2's states are 768 wide), while an image batch
runs.
"""

import json

import numpy as np
import pytest
from tests.torch_threads import few_torch_threads  # noqa: E402,F401 (autouse)

torch = pytest.importorskip("torch")
pytest.importorskip("tokenizers")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests.test_torch_pretrain_configs import corpus  # noqa: E402,F401
from x2vlm_tpu import run as jax_run  # noqa: E402
from x2vlm_tpu.models.heads import pretrain_init_inputs  # noqa: E402
from x2vlm_tpu_torch import run  # noqa: E402
from x2vlm_tpu_torch.core.config import load_config  # noqa: E402
from x2vlm_tpu_torch.models import (  # noqa: E402
    BEiT2Config, BertConfig, XVLMConfig, XVLMForPretrain,
)


def _large_th(path):
    """An X2VLM-large ``.th`` at the shipped widths, the depths cut: a
    BEiT-2-large block (at 32 px), two BERT-large layers fusing from 1."""
    cfg = XVLMConfig(vision=BEiT2Config(image_res=32, patch_size=16, embed_dim=1024, depth=1,
                                        num_heads=16),
                     text=BertConfig(vocab_size=100, hidden_size=1024, num_layers=2,
                                     fusion_layer=1, num_heads=16, intermediate_size=4096,
                                     encoder_width=1024),
                     embed_dim=256)
    sd = XVLMForPretrain(cfg, dtype=torch.float32, device="cpu", seed=3).base.state_dict()
    # the reference's file also holds the MLM decoder, tied to the embeddings
    sd.setdefault("text_encoder.cls.predictions.decoder.weight",
                  sd["text_encoder.bert.embeddings.word_embeddings.weight"])
    torch.save({"model": sd}, path)


def _cclm_large_cut(corpus):  # noqa: F811
    """``multilingual_cclm_x2vlm_large.yaml`` at its widths (BEiT-2-large;
    XLM-R at the JAX factory's width, 768) with every stack one layer deep
    and a small vocabulary, at 32 px, its data paths on the corpus."""
    d, xlmr = corpus
    cfg = load_config("configs/pretrain/multilingual_cclm_x2vlm_large.yaml").to_dict()
    assert (cfg["is_xvlm_ckpt"], cfg["replace_text_encoder"]) == (True, True)
    del cfg["vision_config"]
    vocab = len(json.load(open(f"{xlmr}/tokenizer.json"))["model"]["vocab"])
    cfg.update(image_res=32, vision_config_inline={"vision_width": 1024, "patch_size": 16,
                                     "num_hidden_layers": 1, "num_attention_heads": 16},
               text_encoder=xlmr, text_num_hidden_layers=1, text_fusion_start_at=1,
               num_cross_layers=1, xvlm_ckpt_text_num_hidden_layers=1,
               text_config_inline={"vocab_size": vocab},
               train_file=[str(d / "img.jsonl")],
               train_file_regions=[str(d / "regions_multi.jsonl")],
               train_file_mtext=[str(d / "para.jsonl")], train_dataset_size=8,
               images=dict(cfg["images"], batch_size=8, num_workers=1),
               regions=dict(cfg["regions"], batch_size=8, max_images=8, num_workers=1),
               mtexts=dict(cfg["mtexts"], batch_size=8, num_workers=1))
    return cfg


def test_cclm_large_import_is_refused_as_the_jax_launcher_refuses_it(corpus):  # noqa: F811
    d = corpus[0]
    th = d / "x2vlm_large_cut.th"
    _large_th(th)
    cfg = _cclm_large_cut(corpus)
    path = d / "cfg_cclm_large_import.json"
    path.write_text(json.dumps(cfg))
    argv = ["--task", "pretrain", "--config", str(path), "--checkpoint", str(th),
            "--seed", "0", "--epoch", "1"]
    with pytest.raises(ValueError) as want:
        jax_run.main(argv + ["--output_dir", str(d / "jax_cclm_large")])
    with pytest.raises(ValueError) as got:
        run.main(argv + ["--output_dir", str(d / "out_cclm_large"), "--device", "cpu"])
    # a parameter 1024 wide in the file and 768 in the model (each package
    # names the first it meets: JAX the text projection, the port the cross
    # encoder's first query)
    for err in (want.value, got.value):
        assert "shape mismatch" in str(err) and "1024" in str(err) and "768" in str(err), err


def test_cclm_large_parallel_text_raises_in_both_packages(corpus):  # noqa: F811
    """At the widths both factories build for ``multilingual_cclm_x2vlm_large``
    (text 768, vision 1024), the cross encoder's cross-attention takes
    1024-wide keys, and a parallel pair's language-2 states are 768 wide:
    the parallel-text loss raises in the JAX model and in the port alike,
    while an image batch runs in both."""
    from x2vlm_tpu.factory import build_model as jax_build_model
    from x2vlm_tpu_torch.factory import build_model

    cfg = _cclm_large_cut(corpus)
    rng = np.random.default_rng(5)
    ids = rng.integers(5, 300, (2, 12)).astype(np.int32)
    atts = np.ones((2, 12), np.int32)
    pair = {"text_ids": ids, "text_atts": atts, "text_ids_masked": ids,
            "masked_pos": np.array([[1, 2], [3, 4]], np.int32),
            "masked_ids": ids[:, 1:3].copy(), "text_ids_2": ids[:, ::-1].copy(),
            "text_atts_2": atts}
    image = dict({k: v for k, v in pair.items() if not k.endswith("_2")},
                 image=rng.standard_normal((2, 32, 32, 3)).astype(np.float32))
    model, mcfg = jax_build_model(cfg, "pretrain", dtype=jnp.float32)
    assert (mcfg.text.hidden_size, mcfg.vision.embed_dim) == (768, 1024)
    variables = model.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                           pretrain_init_inputs(mcfg), rng=jax.random.PRNGKey(2),
                           ret_bbox_loss=True)
    jnp_batch = lambda b: {k: jnp.asarray(v) for k, v in b.items()}
    out = model.apply(variables, jnp_batch(image), rng=jax.random.PRNGKey(3), deterministic=True)
    assert np.isfinite(float(out["loss_itm"]))
    with pytest.raises(Exception, match="cross_attn/key"):
        model.apply(variables, jnp_batch(pair), rng=jax.random.PRNGKey(3), deterministic=True)
    port, pcfg = build_model(cfg, "pretrain", device="cpu", dtype=torch.float32, seed=0)
    assert (pcfg.text.hidden_size, pcfg.vision.embed_dim) == (768, 1024)
    tb = lambda b: {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}
    with torch.no_grad():
        assert torch.isfinite(port(tb(image))["loss_itm"])
        with pytest.raises(RuntimeError, match="shapes cannot be multiplied"):
            port(tb(pair))
