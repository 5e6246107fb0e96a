"""The port's int8 W8A8 serving path (``ops/quant.py``,
``ops/int8_matmul.py``, ``quant_int8=True`` in BEiT-2 and BERT) against the
JAX package's ``quantize_act`` / ``quantize_weight`` / ``int8_matmul_xla`` /
``QDense`` / ``XVLMForRetrieval(quant_int8=True)``, in fp32 on the CPU,
where the kernel wrappers run their plain versions.

Tolerances: int8 values and scales exactly; the matmul and ``qdense``
rtol = atol = 1e-6 (the erf GELU against the JAX tanh-polynomial form,
<= 4.8e-7); the whole retrieval slice rtol = atol = 5e-3: a 1e-7 difference
upstream (LayerNorm, softmax sums) can flip one activation's rounding at a
.5 boundary, which moves one term of a dot product by 1/127 of its scale.
"""

from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.linen as fnn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from x2vlm_tpu.models import (  # noqa: E402
    BEiT2Config as JaxBEiT2Config, BertConfig as JaxBertConfig,
    XVLMConfig as JaxXVLMConfig, XVLMForRetrieval as JaxXVLMForRetrieval,
)
from x2vlm_tpu.ops import int8_matmul as jim  # noqa: E402
from x2vlm_tpu.ops import quant as jq  # noqa: E402
from x2vlm_tpu.serving import _flatten  # noqa: E402
from x2vlm_tpu_torch.convert import convert_jax_params  # noqa: E402
from x2vlm_tpu_torch.models import (  # noqa: E402
    BEiT2Config, BertConfig, XVLMConfig, XVLMForRetrieval,
)
from x2vlm_tpu_torch.ops import int8_matmul as tim  # noqa: E402
from x2vlm_tpu_torch.ops import layers as tl  # noqa: E402
from x2vlm_tpu_torch.ops import quant as tq  # noqa: E402
from x2vlm_tpu_torch.serving import RetrievalServer  # noqa: E402

FINE = dict(rtol=1e-6, atol=1e-6)
SLICE = dict(rtol=5e-3, atol=5e-3)
VISION = dict(image_res=32, patch_size=16, embed_dim=32, depth=2, num_heads=2,
              drop_path_rate=0.0, dropout_rate=0.0, act="gelu_fast")
TEXT = dict(vocab_size=100, hidden_size=32, num_layers=4, fusion_layer=2,
            num_heads=2, intermediate_size=64, encoder_width=32,
            hidden_dropout=0.0, attn_dropout=0.0, max_position_embeddings=64,
            act="gelu_fast")


def _port_config(quant: bool) -> XVLMConfig:
    return XVLMConfig(vision=BEiT2Config(**VISION, quant_int8=quant),
                      text=BertConfig(**TEXT, quant_int8=quant), embed_dim=16)


def _np(x):
    return np.asarray(x)


# ---------------------------------------------------------------- quantization

def _act_cases():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((5, 48)) * 2.0).astype(np.float32)
    x[1] = 0.0                          # a zero row: sx = 1e-6 / 127, xq = 0
    x[2] = 1e-9 * x[2]                  # below the 1e-6 floor
    x[3, :] = [0.5, 1.5, 2.5, -2.5, -3.5, 126.5, -126.5, 127.0] * 6   # sx = 1: .5 ties
    x[4, 7] = 300.0                     # one large outlier
    return x


def test_quantize_act_matches_jax():
    x = _act_cases()
    want_q, want_s = jq.quantize_act(jnp.asarray(x))
    got_q, got_s = tq.quantize_act(torch.from_numpy(x))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    assert got_s.shape == (5, 1)
    np.testing.assert_array_equal(got_q.numpy(), _np(want_q))
    np.testing.assert_array_equal(got_s.numpy(), _np(want_s))
    # round half to even at the .5 ties, zero for the zero row
    assert got_q[3, :8].tolist() == [0, 2, 2, -2, -4, 126, -126, 127]
    assert got_q[1].abs().max().item() == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_act_3d_and_bf16(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 64)).astype(np.float32)
    xj = jnp.asarray(x, getattr(jnp, dtype))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    want_q, want_s = jq.quantize_act(xj)
    got_q, got_s = tq.quantize_act(xt)
    assert got_q.shape == (2, 7, 64) and got_s.shape == (2, 7, 1)
    np.testing.assert_array_equal(got_q.numpy(), _np(want_q))
    np.testing.assert_array_equal(got_s.numpy(), _np(want_s))


def test_quantize_weight_matches_jax():
    rng = np.random.default_rng(2)
    w = (rng.standard_normal((48, 24)) * 0.02).astype(np.float32)   # JAX (K, N)
    w[:, 3] = 0.0                                                    # a zero column
    w[5, 4] = 1.0                                                    # an outlier
    want_q, want_s = jim.quantize_weight(jnp.asarray(w))
    got_q, got_s = tq.quantize_weight(torch.from_numpy(w.T.copy()))  # torch (N, K)
    assert got_q.shape == (24, 48) and got_s.shape == (24,)
    np.testing.assert_array_equal(got_q.numpy().T, _np(want_q))
    np.testing.assert_array_equal(got_s.numpy(), _np(want_s).reshape(-1))


# ------------------------------------------------------------------ the matmul

@pytest.mark.parametrize("M,K,N,act,with_bias", [
    (200, 768, 768, None, True),          # projection shape (M off every tile)
    (256, 768, 3072, "gelu_fast", True),  # fc1 + fused tanh GELU
    (64, 3072, 768, None, False),         # fc2
    (128, 768, 768, "gelu", True),        # erf epilogue
    ((4, 50), 768, 768, None, True),      # 3-D input
])
def test_int8_matmul_reference_matches_jax(M, K, N, act, with_bias):
    rng = np.random.default_rng(3)
    lead = M if isinstance(M, tuple) else (M,)
    x = (rng.standard_normal((*lead, K)) * 0.5).astype(np.float32)
    w = (rng.standard_normal((K, N)) * 0.02).astype(np.float32)
    b = (rng.standard_normal((N,)) * 0.1).astype(np.float32) if with_bias else None
    wq, sw = jim.quantize_weight(jnp.asarray(w))
    want = jim.int8_matmul_xla(jnp.asarray(x), wq, sw, None if b is None else jnp.asarray(b),
                               act=act, out_dtype=jnp.float32)
    t = lambda a: None if a is None else torch.from_numpy(np.array(a))
    got = tim.int8_matmul(t(x), t(wq).T.contiguous(), t(sw).reshape(-1), t(b), act=act,
                          out_dtype=torch.float32)
    assert got.shape == (*lead, N) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np(want), **FINE)
    if act is None:   # no activation: the same operations in the same order
        np.testing.assert_array_equal(got.numpy(), _np(want))


def test_int8_matmul_exact_sums_and_bf16_out():
    """The float64 sums of the plain version are the int32 sums (K = 3072 of
    +-127 products passes 2^24, where float32 sums would round)."""
    xq = torch.full((3, 3072), 127, dtype=torch.int8)
    xq[1] = -127
    wq = torch.full((2, 3072), 127, dtype=torch.int8)
    wq[1, ::2] = -127
    one = torch.ones(3, 1)
    out = tim.int8_matmul_reference(xq.float(), wq, torch.ones(2), xq=xq, sx=one,
                                    out_dtype=torch.float32)
    assert out[:, 0].tolist() == [127 * 127 * 3072, -127 * 127 * 3072, 127 * 127 * 3072]
    assert out[:, 1].tolist() == [0.0, 0.0, 0.0]
    x = torch.randn(4, 32)
    wq2, sw2 = tq.quantize_weight(torch.randn(8, 32))
    bf = tim.int8_matmul(x, wq2, sw2, act="gelu")
    assert bf.dtype == torch.bfloat16 and bf.shape == (4, 8)
    torch.testing.assert_close(bf, tim.int8_matmul(x, wq2, sw2, act="gelu",
                                                   out_dtype=torch.float32).bfloat16())
    with pytest.raises(ValueError, match="act"):
        tim.int8_matmul(x, wq2, sw2, act="relu")


# ---------------------------------------------------------------------- qdense

@pytest.mark.parametrize("shared", [False, True], ids=["own", "shared_xq"])
@pytest.mark.parametrize("act", [None, "gelu_fast", "gelu"])
def test_qdense_matches_jax_qdense(shared, act):
    """Same parameters as a flax ``nn.Dense`` tree (QDense's is identical),
    carried to the ``nn.Linear`` layout; with and without a shared
    ``(xq, sx)`` from ``quantize_act``."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 9, 40)).astype(np.float32)
    dense = fnn.Dense(24, dtype=jnp.float32, param_dtype=jnp.float32)
    params = dense.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) + 0.1 * rng.standard_normal(a.shape),
                              jnp.float32), params)
    qd = jq.QDense(24, dtype=jnp.float32)
    assert (jax.tree_util.tree_structure(qd.init(jax.random.PRNGKey(0), jnp.asarray(x)))
            == jax.tree_util.tree_structure(params))
    xq, sx = jq.quantize_act(jnp.asarray(x)) if shared else (None, None)
    want = qd.apply(params, jnp.asarray(x), xq, sx, act=act)
    weight = torch.from_numpy(np.array(params["params"]["kernel"]).T.copy())
    bias = torch.from_numpy(np.array(params["params"]["bias"]))
    xt = torch.from_numpy(x)
    pq, ps = tq.quantize_act(xt) if shared else (None, None)
    got = tq.qdense(xt, weight, bias, xq=pq, sx=ps, act=act, dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), _np(want), **FINE)


def test_int8_model_loads_the_float_state_dict_unchanged():
    """quant_int8 adds no parameter and renames none: the float model's
    state dict (the names ``convert.py`` writes) loads strictly."""
    fp = XVLMForRetrieval(_port_config(False), dtype=torch.float32, device="cpu", seed=5)
    q = XVLMForRetrieval(_port_config(True), dtype=torch.float32, device="cpu", seed=None)
    assert list(q.state_dict()) == list(fp.state_dict())
    q.load_state_dict(fp.state_dict())
    for (name, a), b in zip(q.state_dict().items(), fp.state_dict().values()):
        assert torch.equal(a, b), name


# ------------------------------------------------------------------- the slice

@pytest.fixture(scope="module")
def slice_setup():
    cfg = JaxXVLMConfig(vision=JaxBEiT2Config(**VISION, quant_int8=True),
                        text=JaxBertConfig(**TEXT, quant_int8=True), embed_dim=16)
    model = JaxXVLMForRetrieval(cfg, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    image = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
    ids = rng.integers(0, 100, (3, 8)).astype(np.int32)
    atts = np.ones((3, 8), np.int32)
    atts[1, 5:] = 0
    atts[2, 2:] = 0

    def serving_programs(m, img, ids, atts):
        ie, _ = m.encode_images(img)
        te, _ = m.encode_texts(ids, atts)
        return m.itm_score(ie, te, atts)

    init = model.init(jax.random.PRNGKey(0), jnp.asarray(image), jnp.asarray(ids),
                      jnp.asarray(atts), method=serving_programs)
    variables = jax.tree_util.tree_map(
        lambda x: jnp.asarray(np.asarray(x) + 0.05 * rng.standard_normal(x.shape),
                              jnp.float32), init)
    state, unused = convert_jax_params(_flatten(variables), device="cpu")
    assert unused == []
    port = XVLMForRetrieval(_port_config(True), dtype=torch.float32, device="cpu",
                            seed=None)
    port.load_state_dict(state)
    ie, i_feat = model.apply(variables, jnp.asarray(image), method=model.encode_images)
    te, t_feat = model.apply(variables, jnp.asarray(ids), jnp.asarray(atts),
                             method=model.encode_texts)
    score = model.apply(variables, ie, te, jnp.asarray(atts), method=model.itm_score)
    want = {k: _np(v) for k, v in dict(image_embeds=ie, image_feat=i_feat, text_embeds=te,
                                       text_feat=t_feat, itm=score).items()}
    return port, state, want, (image, ids, atts)


def _port_outputs(serve, image, ids, atts):
    with torch.no_grad():
        ie, i_feat = serve.encode_images(torch.from_numpy(image))
        te, t_feat = serve.encode_texts(torch.from_numpy(ids), torch.from_numpy(atts))
        score = serve.itm_score(ie, te, torch.from_numpy(atts))
    return {k: v.numpy() for k, v in dict(
        image_embeds=ie, image_feat=i_feat, text_embeds=te, text_feat=t_feat,
        itm=score).items()}


@pytest.mark.parametrize("output", ["image_embeds", "image_feat", "text_embeds",
                                    "text_feat", "itm"])
def test_int8_retrieval_matches_jax(slice_setup, output):
    port, _, want, inputs = slice_setup
    got = _port_outputs(port, *inputs)[output]
    err = float(np.abs(got - want[output]).max())
    print(f"int8 slice {output}: max abs error to JAX {err:.3e}")
    assert got.shape == want[output].shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want[output], **SLICE)


def test_int8_retrieval_server_serves_the_quant_config(slice_setup):
    """``RetrievalServer`` serves a quant_int8 model as it is, built in the
    port or loaded from the bf16-named state dict."""
    port, state, want, inputs = slice_setup
    fp = XVLMForRetrieval(_port_config(False), dtype=torch.float32, device="cpu", seed=None)
    fp.load_state_dict(state)
    q = XVLMForRetrieval(_port_config(True), dtype=torch.float32, device="cpu", seed=None)
    q.load_state_dict(fp.state_dict())
    got = _port_outputs(RetrievalServer(q), *inputs)
    direct = _port_outputs(port, *inputs)
    for key in want:
        np.testing.assert_array_equal(got[key], direct[key], err_msg=key)


def test_int8_model_close_to_float_model(slice_setup):
    """The port's int8 model against its float model, same weights: relative
    error < 0.05, the JAX package's bound (tests/test_encoders.py)."""
    port, state, _, inputs = slice_setup
    fp = XVLMForRetrieval(_port_config(False), dtype=torch.float32, device="cpu", seed=None)
    fp.load_state_dict(state)
    got, ref = _port_outputs(port, *inputs), _port_outputs(fp, *inputs)
    for key in ("image_embeds", "text_embeds", "itm"):
        rel = np.linalg.norm(got[key] - ref[key]) / np.linalg.norm(ref[key])
        assert rel < 0.05, (key, rel)


def test_int8_launches_per_request(slice_setup):
    """The launches a request makes on the card, counted on the CPU path:
    one GEMM per projection / FFN matmul (the fused BEiT-2 qkv is one); one
    quantization per GEMM without a shared (xq, sx), plus one per attention
    source. Per layer: vision 4 GEMM + 4 quantize, text 6 + 4, fusion 10 + 7
    (the counts chip_smoke.py checks at X2VLM-base: 48/48, 72/48, 60/42)."""
    port, _, _, (image, ids, atts) = slice_setup
    calls = {"gemm": 0, "quantize": 0}
    real_mm, real_q = tq.int8_matmul, tl.quantize_act

    def gemm(x, *a, xq=None, **kw):
        calls["gemm"] += 1
        calls["quantize"] += xq is None
        return real_mm(x, *a, xq=xq, **kw)

    def quantize(x):
        calls["quantize"] += 1
        return real_q(x)

    counts = {}
    with mock.patch.object(tq, "int8_matmul", gemm), \
            mock.patch.object(tl, "quantize_act", quantize), torch.no_grad():
        for name, fn in (("encode_images", lambda: port.encode_images(torch.from_numpy(image))),
                         ("encode_texts", lambda: port.encode_texts(torch.from_numpy(ids),
                                                                    torch.from_numpy(atts)))):
            calls.update(gemm=0, quantize=0)
            out = fn()
            counts[name] = dict(calls)
            if name == "encode_images":
                ie = out[0]
            else:
                te = out[0]
        calls.update(gemm=0, quantize=0)
        port.itm_score(ie, te, torch.from_numpy(atts))
        counts["itm_score"] = dict(calls)
    depth, n_text = VISION["depth"], TEXT["fusion_layer"]
    n_fusion = TEXT["num_layers"] - TEXT["fusion_layer"]
    assert counts == {"encode_images": {"gemm": 4 * depth, "quantize": 4 * depth},
                      "encode_texts": {"gemm": 6 * n_text, "quantize": 4 * n_text},
                      "itm_score": {"gemm": 10 * n_fusion, "quantize": 7 * n_fusion}}


# ------------------------------------------------------------- serving only

@pytest.mark.parametrize("layer", ["Mlp", "MultiHeadAttention", "BertIntermediate",
                                   "BertOutput"])
def test_int8_layers_raise_in_training_mode(layer):
    from x2vlm_tpu_torch.models import bert as tb
    x = torch.randn(2, 5, 16)
    cfg = BertConfig(hidden_size=16, num_heads=2, intermediate_size=32, quant_int8=True)
    make = {
        "Mlp": lambda: tl.Mlp(16, 32, quant=True, dtype=torch.float32, device="cpu"),
        "MultiHeadAttention": lambda: tl.MultiHeadAttention(
            16, 2, quant=True, dtype=torch.float32, device="cpu"),
        "BertIntermediate": lambda: tb.BertIntermediate(cfg, dtype=torch.float32,
                                                        device="cpu"),
        "BertOutput": lambda: tb.BertOutput(16, cfg, dtype=torch.float32, device="cpu"),
    }
    mod = make[layer]()
    tl.init_weights(mod, torch.Generator().manual_seed(0))
    call = (lambda: mod(x, x, tl.DropPath(0.0))) if layer == "BertOutput" else (lambda: mod(x))
    assert mod.training
    with pytest.raises(ValueError, match="serving-only"):
        call()
    mod.eval()
    with torch.no_grad():
        out = call()
    assert out.shape[:2] == (2, 5) and torch.isfinite(out).all()


def test_int8_epilogue_act_follows_the_config():
    """fc1's fused activation: the tanh GELU for act="gelu_fast", else the
    erf GELU (the JAX ``Mlp``'s rule); no other epilogue exists."""
    assert tl.epilogue_act(tl.ACTIVATIONS["gelu_fast"]) == "gelu_fast"
    assert tl.epilogue_act(tl.ACTIVATIONS["gelu"]) == "gelu"
    assert tl.epilogue_act(tl.ACTIVATIONS["gelu_exact"]) == "gelu"
    assert set(tim.ACTS) == {None, "gelu", "gelu_fast"}
