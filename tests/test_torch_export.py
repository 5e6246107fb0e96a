"""The serving-bundle export (``python -m x2vlm_tpu_torch.export_serving``)
against the JAX package, in fp32 on the CPU at tiny sizes: for each bundle
kind (retrieval on the BEiT-2, CLIP and Swin towers, grounding, VQA,
captioning) the port exports its model, and the JAX package's
``load_params_npz`` plus its own model's ``apply`` (built from the same
YAML keys by the JAX factory) gives what the port's server gives, within
1e-5; the server builds its tower from the manifest's config echo. A
JAX-exported ``params.npz`` of a CLIP and a Swin model still serves in
the port; ``--selftest`` passes; the CLI exports from a ``.th``."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from x2vlm_tpu.factory import build_model as jax_build_model  # noqa: E402
from x2vlm_tpu.models.captioning import (  # noqa: E402
    beam_search_generate_device as jax_beam_search,
)
from x2vlm_tpu.serving import load_params_npz as jax_load_params_npz  # noqa: E402
from x2vlm_tpu.serving import save_params_npz as jax_save_params_npz  # noqa: E402
from x2vlm_tpu_torch import export_serving  # noqa: E402
from x2vlm_tpu_torch.factory import build_model, xvlm_config_from_yaml  # noqa: E402
from x2vlm_tpu_torch.serving import (  # noqa: E402
    CaptioningServer, GroundingServer, RetrievalServer, VQAServer,
)

TOL = dict(rtol=1e-5, atol=1e-5)
BASE = {"image_res": 32, "patch_size": 16, "max_tokens": 8, "embed_dim": 16,
        "text_num_hidden_layers": 2, "text_fusion_start_at": 1,
        "vision_config_inline": {"vision_width": 32, "patch_size": 16, "num_hidden_layers": 1,
                                 "num_attention_heads": 2},
        "text_config_inline": {"vocab_size": 40, "hidden_size": 32, "num_heads": 2,
                               "intermediate_size": 64, "max_position_embeddings": 32,
                               "hidden_dropout": 0.0, "attn_dropout": 0.0}}
CLIP = dict(BASE, use_clip_vit=True, vision_config_inline={
    "vision_width": 32, "patch_size": 16, "num_hidden_layers": 2, "num_attention_heads": 2,
    "intermediate_size": 64})
# Swin: an 8 x 8 grid of 2 x 2 windows, then 4 x 4, each stage's second
# block shifted; the final stride 4 x 2 = 8 is the YAML's patch_size
SWIN = dict(BASE, use_swin=True, patch_size=8, vision_config_inline={
    "embed_dim": 16, "depths": [2, 2], "num_heads": [2, 2], "window_size": 2, "patch_size": 4})
KINDS = {"retrieval_beit2": ("retrieval", BASE), "retrieval_clip": ("retrieval", CLIP),
         "retrieval_swin": ("retrieval", SWIN), "grounding": ("grounding", BASE),
         "vqa": ("vqa", dict(BASE, num_dec_layers=1)),
         "captioning": ("captioning", dict(BASE, prompt="a b"))}


class Tok:
    """The tokenizer ids a captioning manifest records."""
    cls_token, mask_token_id, sep_token_id = "[CLS]", 3, 2

    @staticmethod
    def tokenize(text):
        return text.split()

    @staticmethod
    def convert_tokens_to_ids(tokens):
        return [{"[CLS]": 1, "a": 7, "b": 9}[t] for t in tokens]


def _port_model(cfg, task, seed=3):
    model, _ = build_model(cfg, task, device="cpu", dtype=torch.float32, seed=seed)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():   # noise on every parameter: zero biases carry signal too
        for p in model.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=gen))
    return model.eval()


def _inputs(seed=0, n=2):
    rng = np.random.default_rng(seed)
    image = rng.standard_normal((n, 32, 32, 3)).astype(np.float32)
    ids = rng.integers(4, 40, (n, 8)).astype(np.int32)
    atts = np.ones((n, 8), np.int32)
    atts[1, 5:] = 0
    return image, ids, atts


@pytest.fixture(scope="module", params=sorted(KINDS))
def exported(request, tmp_path_factory):
    task, cfg = KINDS[request.param]
    out = tmp_path_factory.mktemp(request.param)
    model = _port_model(cfg, task)
    manifest = export_serving.export_bundle(model, cfg, task, str(out), batch_images=2,
                                            tokenizer=Tok)
    jmodel, _ = jax_build_model(cfg, task, dtype=jnp.float32)
    return request.param, task, cfg, out, model, manifest, jmodel


def test_jax_serves_the_port_bundle_as_the_port_does(exported):
    name, task, cfg, out, model, manifest, jmodel = exported
    v = jax_load_params_npz(str(out / "params.npz"))
    image, ids, atts = _inputs()
    ji, jids, jatts = jnp.asarray(image), jnp.asarray(ids), jnp.asarray(atts)
    if task == "retrieval":
        server = RetrievalServer.from_npz(out / "params.npz", dtype=torch.float32, device="cpu")
        ie, i_feat = server.encode_images(image)
        te, t_feat = server.encode_texts(ids, atts)
        score = server.itm_score(ie, te, atts)
        jie, ji_feat = jmodel.apply(v, ji, method=jmodel.encode_images)
        jte, jt_feat = jmodel.apply(v, jids, jatts, method=jmodel.encode_texts)
        jscore = jmodel.apply(v, jie, jte, jatts, method=jmodel.itm_score)
        pairs = ((ie, jie), (i_feat, ji_feat), (te, jte), (t_feat, jt_feat), (score, jscore))
    elif task == "grounding":
        server = GroundingServer.from_npz(out / "params.npz", dtype=torch.float32, device="cpu")
        pairs = ((server.predict(image, ids, atts),
                  jmodel.apply(v, ji, jids, jatts, method=jmodel.predict)),)
    elif task == "vqa":
        server = VQAServer.from_npz(out / "params.npz", dtype=torch.float32, device="cpu")
        rng = np.random.default_rng(5)
        a_ids = rng.integers(4, 40, (6, 4)).astype(np.int32)
        a_ids[:, 0] = 1
        a_atts = np.ones_like(a_ids)
        a_atts[2, 2:] = 0
        idx, scores = server.rank(image, ids, atts, a_ids, a_atts, k_test=3)
        batch = {"image": ji, "question_ids": jids, "question_atts": jatts,
                 "answer_ids": jnp.asarray(a_ids), "answer_atts": jnp.asarray(a_atts)}
        jidx, jscores = jmodel.apply(v, batch, 3, method=jmodel.predict)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        pairs = ((scores, jscores),)
    else:
        server = CaptioningServer.from_npz(out, dtype=torch.float32, device="cpu")
        assert server.manifest["prompt_ids"] == [1, 7, 9]
        kw = dict(mask_token_id=3, eos_token_id=2, num_beams=3, min_length=5, max_length=20)
        assert server.generate(image) == jax_beam_search(jmodel, v, ji, [1, 7, 9], **kw)
        pairs = ((server.model.get_vision_embeds(torch.from_numpy(image))[0],
                  jmodel.apply(v, ji, method=lambda m, x: m.base.get_vision_embeds(x)[0])),)
    for got, want in pairs:
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_the_bundle_builds_its_tower_from_the_manifest(exported):
    name, task, cfg, out, model, manifest, _ = exported
    assert manifest["artifacts"] == [] and manifest["image_res"] == 32
    assert not list(out.glob("*.jexp"))
    with open(out / "manifest.json") as f:
        echo = json.load(f)["config"]
    assert xvlm_config_from_yaml(echo) == model.config
    assert all(k.startswith("params/") for k in np.load(out / "params.npz").files)


@pytest.mark.parametrize("kind", ["retrieval_clip", "retrieval_swin"])
def test_a_jax_params_npz_serves_in_the_port(kind, tmp_path):
    import jax

    task, cfg = KINDS[kind]
    jmodel, _ = jax_build_model(cfg, task, dtype=jnp.float32)
    image, ids, atts = _inputs(1)
    ji, jids, jatts = jnp.asarray(image), jnp.asarray(ids), jnp.asarray(atts)

    def programs(m, img, ids, atts):
        ie, _ = m.encode_images(img)
        te, _ = m.encode_texts(ids, atts)
        return m.itm_score(ie, te, atts)

    v = jmodel.init(jax.random.PRNGKey(0), ji, jids, jatts, method=programs)
    jax_save_params_npz(str(tmp_path / "params.npz"), v)
    server = RetrievalServer.from_npz(tmp_path / "params.npz", xvlm_config_from_yaml(cfg),
                                      dtype=torch.float32, device="cpu")
    ie, i_feat = server.encode_images(image)
    te, _ = server.encode_texts(ids, atts)
    jie, ji_feat = jmodel.apply(v, ji, method=jmodel.encode_images)
    jte, _ = jmodel.apply(v, jids, jatts, method=jmodel.encode_texts)
    np.testing.assert_allclose(i_feat.numpy(), np.asarray(ji_feat), **TOL)
    np.testing.assert_allclose(server.itm_score(ie, te, atts).numpy(),
                               np.asarray(jmodel.apply(v, jie, jte, jatts,
                                                       method=jmodel.itm_score)), **TOL)


def test_selftest_passes():
    assert export_serving.main(["--selftest"]) == 0


def test_the_cli_exports_a_th_and_refuses_a_mesh(tmp_path):
    model = _port_model(SWIN, "retrieval", seed=8)
    torch.save({"model": model.state_dict()}, tmp_path / "x.th")
    (tmp_path / "cfg.json").write_text(json.dumps(SWIN))
    argv = ["--task", "retrieval", "--config", str(tmp_path / "cfg.json"), "--checkpoint",
            str(tmp_path / "x.th"), "--out", str(tmp_path / "b"), "--device", "cpu"]
    assert export_serving.main(argv)["embed_dim"] == 16
    served = RetrievalServer.from_npz(tmp_path / "b" / "params.npz", dtype=torch.float32,
                                      device="cpu").model.state_dict()
    for k, t in model.state_dict().items():
        assert torch.equal(served[k], t), k
    # a mesh is refused where it does not divide the global batch sizes
    with pytest.raises(ValueError, match="must divide"):
        export_serving.main(argv + ["--mesh", "3"])
