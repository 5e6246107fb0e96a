"""The port's shared layers against the flax modules, with the same weights,
in fp32 on the CPU. Tolerance 1e-5 (GELU: 1e-6 against the JAX package's
tanh-polynomial erf)."""

import zlib
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from x2vlm_tpu.ops import layers as jl  # noqa: E402
from x2vlm_tpu_torch.ops import layers as tl  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


def _perturbed(params, seed):
    """Flax params with seeded noise added, so zero/one inits (biases, LN,
    rel-pos tables) carry information."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(np.asarray(x) + 0.1 * rng.standard_normal(x.shape),
                              jnp.float32), params)


def _load_linear(layer, p):
    with torch.no_grad():
        layer.weight.copy_(_t(p["kernel"]).T)
        if "bias" in p:
            layer.bias.copy_(_t(p["bias"]))


@pytest.mark.parametrize("uint8", [False, True], ids=["float", "uint8"])
def test_patch_embed(uint8):
    rng = np.random.default_rng(1)
    if uint8:
        x = rng.integers(0, 256, (2, 32, 32, 3)).astype(np.uint8)
    else:
        x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    mod = jl.PatchEmbed(24, 16, dtype=jnp.float32)
    params = _perturbed(mod.init(jax.random.PRNGKey(0), jnp.asarray(x)), 2)
    want = mod.apply(params, jnp.asarray(x))
    port = tl.PatchEmbed(24, 16, dtype=torch.float32, device="cpu")
    p = params["params"]
    with torch.no_grad():
        port.proj.weight.copy_(_t(p["kernel"]).permute(3, 2, 0, 1))
        port.proj.bias.copy_(_t(p["bias"]))
        got = port(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("eps", [1e-6, 1e-12])
def test_fused_layer_norm(eps):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 7, 48)) * 3 + 1).astype(np.float32)
    mod = jl.FusedLayerNorm(epsilon=eps)
    params = _perturbed(mod.init(jax.random.PRNGKey(0), jnp.asarray(x)), 4)
    want = mod.apply(params, jnp.asarray(x))
    port = tl.FusedLayerNorm(48, eps, device="cpu")
    with torch.no_grad():
        port.weight.copy_(_t(params["params"]["scale"]))
        port.bias.copy_(_t(params["params"]["bias"]))
        got = port(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", ["gelu_exact", "gelu_fast"])
def test_gelu(name):
    x = np.linspace(-12, 12, 20001, dtype=np.float32)
    want = getattr(jl, name)(jnp.asarray(x))
    got = getattr(tl, name)(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_mlp():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    mod = jl.Mlp(hidden_dim=40, dtype=jnp.float32)
    params = _perturbed(mod.init(jax.random.PRNGKey(0), jnp.asarray(x)), 6)
    want = mod.apply(params, jnp.asarray(x))
    port = tl.Mlp(16, 40, dtype=torch.float32, device="cpu").eval()
    _load_linear(port.fc1, params["params"]["fc1"])
    _load_linear(port.fc2, params["params"]["fc2"])
    with torch.no_grad():
        got = port(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_drop_path():
    x = torch.ones(64, 3, 4)
    dp = tl.DropPath(0.25)
    assert dp.eval()(x) is x
    dp.train()
    a = dp(x, torch.Generator().manual_seed(0))
    b = dp(x, torch.Generator().manual_seed(0))
    assert torch.equal(a, b)
    rows = a.reshape(64, -1)
    kept = (rows == 1 / 0.75).all(1)
    dropped = (rows == 0).all(1)
    assert bool((kept | dropped).all()) and 0 < int(dropped.sum()) < 64


MHA_CASES = {
    # name: (mode, B, Sq, Skv or None (self), C, kv width, H, bias, key mask, route)
    "tiny_self_full_mask": ("full", 2, 12, None, 256, 256, 4, False, True, "tiny"),
    "tiny_cross_full_mask": ("full", 2, 12, 20, 256, 48, 4, False, True, "tiny"),
    "flash_qv_bias": ("qv", 2, 130, None, 128, 128, 2, True, False, "flash"),
    "flash_full_key_mask": ("full", 2, 130, None, 128, 128, 2, False, True, "flash"),
    "plain_qv_bias_short": ("qv", 2, 20, None, 64, 64, 2, True, False, "plain"),
    "none_bias_mode_tiny": ("none", 2, 9, None, 256, 256, 4, False, False, "tiny"),
}


@pytest.mark.parametrize("name", sorted(MHA_CASES))
def test_multi_head_attention_routes(name):
    mode, B, Sq, Skv, C, kv_w, H, with_bias, with_mask, route = MHA_CASES[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    x = rng.standard_normal((B, Sq, C)).astype(np.float32)
    kv = None if Skv is None else rng.standard_normal((B, Skv, kv_w)).astype(np.float32)
    S_kv = Sq if Skv is None else Skv
    bias = rng.standard_normal((1, H, Sq, S_kv)).astype(np.float32) if with_bias else None
    km = None
    if with_mask:
        km = np.ones((B, S_kv), np.int32)
        km[1, S_kv - 3:] = 0
    jx = dict(bias=None if bias is None else jnp.asarray(bias),
              key_mask=None if km is None else jnp.asarray(km))
    mod = jl.MultiHeadAttention(num_heads=H, qkv_bias_mode=mode, dtype=jnp.float32)
    jkv = None if kv is None else jnp.asarray(kv)
    params = _perturbed(mod.init(jax.random.PRNGKey(0), jnp.asarray(x), jkv, **jx), 8)
    want = mod.apply(params, jnp.asarray(x), jkv, **jx)

    port = tl.MultiHeadAttention(C, H, kv_dim=kv_w, qkv_bias_mode=mode, out_proj=True,
                                 dtype=torch.float32, device="cpu").eval()
    p = params["params"]
    with torch.no_grad():
        if mode == "qv":
            port.qkv.weight.copy_(torch.cat(
                [_t(p[n]["kernel"]).T for n in ("query", "key", "value")]))
            port.q_bias.copy_(_t(p["query"]["bias"]))
            port.v_bias.copy_(_t(p["value"]["bias"]))
        else:
            for n in ("query", "key", "value"):
                _load_linear(getattr(port, n), p[n])
        _load_linear(port.proj, p["out"])

    calls = {"tiny": 0, "flash": 0, "plain": 0}

    def spy(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    with mock.patch.object(tl, "tiny_block_attention",
                           spy("tiny", tl.tiny_block_attention)), \
            mock.patch.object(tl, "flash_attention", spy("flash", tl.flash_attention)), \
            mock.patch.object(tl, "dot_product_attention",
                              spy("plain", tl.dot_product_attention)), \
            torch.no_grad():
        got = port(_t(x), None if kv is None else _t(kv),
                   bias=None if bias is None else _t(bias),
                   key_mask=None if km is None else _t(km))
    assert calls == {k: int(k == route) for k in calls}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_modules_refuse_unported_options():
    # int8 projections (quant) and the static decode cache are ported: a
    # cached call returns the new cache (K / V written at the index) in
    # both; int8 stays serving-only, so training mode is refused
    for quant in (False, True):
        mha = tl.MultiHeadAttention(64, 2, quant=quant, device="cpu").eval()
        tl.init_weights(mha, torch.Generator().manual_seed(0))
        buf = torch.zeros(1, 2, 6, 32, dtype=torch.bfloat16)   # the compute dtype
        cache = {"k": buf, "v": buf, "index": 2}
        out, new = mha(torch.randn(1, 3, 64), cache=cache)
        assert out.shape == (1, 3, 64) and new["index"] == 2
        assert new["k"][:, :, 2:5].abs().sum() > 0 and new["k"][:, :, 5:].abs().sum() == 0
    with pytest.raises(ValueError, match="serving-only"):
        mha.train()(torch.zeros(1, 3, 64))
