"""The port's retrieval serving path against the JAX ``XVLMForRetrieval`` on
the tiny config of test_checkpoint_import.py (32 px, depth 2, width 32,
4 text layers, fusion at 2), in fp32 on the CPU: the JAX parameters are
carried across with ``x2vlm_tpu_torch.convert``. Tolerance rtol = atol =
1e-4 (fp32 through several layers, different summation orders)."""

import numpy as np
import pytest
from tests.torch_threads import few_torch_threads  # noqa: E402,F401 (autouse)

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from x2vlm_tpu.models import (  # noqa: E402
    BEiT2Config as JaxBEiT2Config, BertConfig as JaxBertConfig,
    XVLMConfig as JaxXVLMConfig, XVLMForRetrieval as JaxXVLMForRetrieval,
)
from x2vlm_tpu.serving import _flatten, save_params_npz  # noqa: E402
from x2vlm_tpu.train.checkpoint import convert_xvlm_state_dict  # noqa: E402
from x2vlm_tpu_torch.convert import convert_jax_params  # noqa: E402
from x2vlm_tpu_torch.models import (  # noqa: E402
    BEiT2Config, BertConfig, XVLMConfig, XVLMForRetrieval,
)
from x2vlm_tpu_torch.serving import RetrievalServer  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
VISION = dict(image_res=32, patch_size=16, embed_dim=32, depth=2, num_heads=2,
              drop_path_rate=0.0, dropout_rate=0.0)
TEXT = dict(vocab_size=100, hidden_size=32, num_layers=4, fusion_layer=2,
            num_heads=2, intermediate_size=64, encoder_width=32,
            hidden_dropout=0.0, attn_dropout=0.0, max_position_embeddings=64)
PORT_CONFIG = XVLMConfig(vision=BEiT2Config(**VISION), text=BertConfig(**TEXT),
                         embed_dim=16)


@pytest.fixture(scope="module")
def setup():
    cfg = JaxXVLMConfig(vision=JaxBEiT2Config(**VISION),
                        text=JaxBertConfig(**TEXT), embed_dim=16)
    model = JaxXVLMForRetrieval(cfg, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    image = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
    ids = rng.integers(0, 100, (3, 8)).astype(np.int32)
    atts = np.ones((3, 8), np.int32)
    atts[1, 5:] = 0  # padded rows
    atts[2, 2:] = 0

    def serving_programs(m, img, ids, atts):
        ie, _ = m.encode_images(img)
        te, _ = m.encode_texts(ids, atts)
        return m.itm_score(ie, te, atts)

    init = model.init(jax.random.PRNGKey(0), jnp.asarray(image), jnp.asarray(ids),
                      jnp.asarray(atts), method=serving_programs)
    # seeded noise on every param, so the zero-initialised ones (biases,
    # rel-pos tables) carry information through the comparison
    variables = jax.tree_util.tree_map(
        lambda x: jnp.asarray(np.asarray(x) + 0.05 * rng.standard_normal(x.shape),
                              jnp.float32), init)
    state, unused = convert_jax_params(_flatten(variables), device="cpu")
    port = XVLMForRetrieval(PORT_CONFIG, dtype=torch.float32, device="cpu", seed=None)
    port.load_state_dict(state)
    return model, variables, port, unused, (image, ids, atts)


def _jax_outputs(model, variables, image, ids, atts):
    ie, i_feat = model.apply(variables, jnp.asarray(image), method=model.encode_images)
    te, t_feat = model.apply(variables, jnp.asarray(ids), jnp.asarray(atts),
                             method=model.encode_texts)
    score = model.apply(variables, ie, te, jnp.asarray(atts), method=model.itm_score)
    return {k: np.asarray(v) for k, v in dict(
        image_embeds=ie, image_feat=i_feat, text_embeds=te, text_feat=t_feat,
        itm=score).items()}


def _port_outputs(encode_images, encode_texts, itm_score, image, ids, atts):
    with torch.no_grad():
        ie, i_feat = encode_images(torch.from_numpy(image))
        te, t_feat = encode_texts(torch.from_numpy(ids), torch.from_numpy(atts))
        score = itm_score(ie, te, torch.from_numpy(atts))
    return {k: v.numpy() for k, v in dict(
        image_embeds=ie, image_feat=i_feat, text_embeds=te, text_feat=t_feat,
        itm=score).items()}


@pytest.mark.parametrize("output", ["image_embeds", "image_feat", "text_embeds",
                                    "text_feat", "itm"])
def test_retrieval_outputs_match_jax(setup, output):
    model, variables, port, _, (image, ids, atts) = setup
    want = _jax_outputs(model, variables, image, ids, atts)[output]
    got = _port_outputs(port.encode_images, port.encode_texts, port.itm_score,
                        image, ids, atts)[output]
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)


def test_multi_modal_cross_embeds_match_jax(setup):
    """get_cross_embeds from token ids: all text + fusion layers in one pass
    (the 'multi_modal' mode), with the image stream padded 5 -> 8."""
    model, variables, port, _, (image, ids, atts) = setup

    def cross(m, img, ids, atts):
        ie, ia = m.base.get_vision_embeds(img)
        return m.base.get_cross_embeds(ie, ia, text_ids=ids, text_atts=atts)

    want = model.apply(variables, jnp.asarray(image), jnp.asarray(ids),
                       jnp.asarray(atts), method=cross)
    with torch.no_grad():
        ie, ia = port.get_vision_embeds(torch.from_numpy(image))
        got = port.get_cross_embeds(ie, ia, text_ids=torch.from_numpy(ids),
                                    text_atts=torch.from_numpy(atts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_convert_carries_every_serving_param(setup):
    _, _, port, unused, _ = setup
    # the JAX retrieval programs create exactly what this slice carries
    assert unused == []
    assert set(port.state_dict()) == set(
        convert_jax_params(_flatten(setup[1]), device="cpu")[0])


def test_port_names_are_the_reference_names(setup):
    """The port's state dict goes through the JAX package's importer of
    reference checkpoints: every array lands on the JAX param it came from,
    bit for bit, and no key of the port is left unused."""
    _, variables, port, _, _ = setup
    sd = {k: v.detach().numpy() for k, v in port.state_dict().items()}
    tree, unused = convert_xvlm_state_dict(sd, vision_depth=2, load_mlm_head=False)
    assert unused == [], unused
    want = _flatten(variables["params"]["base"])
    got = _flatten(tree)
    assert set(got) == set(want)
    for key, value in got.items():
        np.testing.assert_array_equal(value, want[key], err_msg=key)


def test_retrieval_server_loads_a_jax_params_npz(setup, tmp_path):
    model, variables, _, _, (image, ids, atts) = setup
    path = tmp_path / "params.npz"
    save_params_npz(str(path), variables)
    server = RetrievalServer.from_npz(path, PORT_CONFIG, dtype=torch.float32,
                                      device="cpu")
    want = _jax_outputs(model, variables, image, ids, atts)
    got = _port_outputs(server.encode_images, server.encode_texts, server.itm_score,
                        image, ids, atts)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **TOL)


def test_seeded_init_is_reproducible_and_complete():
    a = XVLMForRetrieval(PORT_CONFIG, dtype=torch.float32, device="cpu", seed=3)
    b = XVLMForRetrieval(PORT_CONFIG, dtype=torch.float32, device="cpu", seed=3)
    for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), name
        assert torch.isfinite(x).all(), name
    assert a.temp.item() == pytest.approx(0.07)
    assert not a.training
    image = np.random.default_rng(0).integers(0, 256, (2, 32, 32, 3)).astype(np.uint8)
    with torch.no_grad():
        embeds, feat = a.encode_images(torch.from_numpy(image))
    assert embeds.shape == (2, 5, 32) and feat.shape == (2, 16)
    assert torch.isfinite(embeds).all()
