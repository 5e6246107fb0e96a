"""The port's attention modules against the JAX package, in fp32 on the CPU.

On the CPU the kernel wrappers run their plain PyTorch versions; the JAX
public entry points route to their plain references too (the JAX package's
own tests hold its Pallas kernels to those references in interpret mode).
Tolerance: rtol = atol = 1e-5 (fp32, different summation orders)."""

import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from x2vlm_tpu.ops.attention import dot_product_attention as jax_dpa  # noqa: E402
from x2vlm_tpu.ops.flash_attention import flash_attention as jax_flash  # noqa: E402
from x2vlm_tpu.ops.tiny_attention import (  # noqa: E402
    _krow as jax_krow, _xla_reference as jax_tiny_reference,
    tiny_block_attention as jax_tiny,
)
from x2vlm_tpu_torch.ops.attention import dot_product_attention  # noqa: E402
from x2vlm_tpu_torch.ops.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_fwd, flash_attention_reference,
)
from x2vlm_tpu_torch.ops.tiny_attention import (  # noqa: E402
    tiny_attention_fwd, tiny_attention_reference, tiny_block_attention,
)

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


FLASH_CASES = {
    # name: (B, H, Sq, Skv, bias batch dim or None, mask kind, causal)
    "bias_shared_197": (2, 2, 197, 197, 1, None, False),
    "bias_per_batch": (2, 2, 130, 130, 2, None, False),
    "key_mask_fully_masked_row": (3, 2, 150, 150, None, "full_row", False),
    "causal": (2, 2, 140, 140, None, None, True),
    "cross_100x300": (2, 2, 100, 300, None, None, False),
}


@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_plain_matches_jax(name):
    B, H, Sq, Skv, bias_b, mask_kind, causal = FLASH_CASES[name]
    D = 64
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    q = rng.standard_normal((B, H, Sq, D)).astype(np.float32)
    k = rng.standard_normal((B, H, Skv, D)).astype(np.float32)
    v = rng.standard_normal((B, H, Skv, D)).astype(np.float32)
    bias = None if bias_b is None else \
        rng.standard_normal((bias_b, H, Sq, Skv)).astype(np.float32)
    key_mask = None
    if mask_kind == "full_row":
        key_mask = (rng.random((B, Skv)) > 0.3).astype(np.int32)
        key_mask[1] = 0  # batch row 1: every key masked -> finite average
    scale = D ** -0.5
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     bias=None if bias is None else jnp.asarray(bias),
                     key_mask=None if key_mask is None else jnp.asarray(key_mask),
                     causal=causal, scale=scale)
    out, lse = flash_attention_fwd(
        _t(q), _t(k), _t(v), None if bias is None else _t(bias),
        None if key_mask is None else _t(key_mask), causal, scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    assert np.isfinite(out.numpy()).all()

    # lse: log-sum-exp of the same masked fp32 logits, computed in JAX
    logits = jnp.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if bias is not None:
        logits = logits + bias
    if key_mask is not None:
        logits = jnp.where(jnp.asarray(key_mask)[:, None, None, :] != 0, logits, -1e30)
    if causal:
        logits = jnp.where(jnp.tril(jnp.ones((Sq, Skv), bool), Skv - Sq), logits, -1e30)
    np.testing.assert_allclose(
        lse.numpy(), np.asarray(jax.nn.logsumexp(logits, axis=-1, keepdims=True)),
        **TOL)
    # the public entry returns the same output
    np.testing.assert_allclose(
        flash_attention(_t(q), _t(k), _t(v),
                        bias=None if bias is None else _t(bias),
                        key_mask=None if key_mask is None else _t(key_mask),
                        causal=causal).numpy(), out.numpy(), rtol=0, atol=0)


TINY_CASES = {
    # name: (B, Sq, Skv, H, D, masked)
    "self_40x40_mask": (3, 40, 40, 12, 16, True),
    "cross_40x197": (2, 40, 197, 4, 32, False),
    "cross_40x200_mask": (2, 40, 200, 4, 32, True),
    "h16_d64": (2, 24, 30, 16, 64, True),
    "non_multiple_of_8": (2, 13, 27, 3, 8, True),
    "cross_40x200_full_row_masked": (2, 40, 200, 4, 32, "full_row"),
}


@pytest.mark.parametrize("name", sorted(TINY_CASES))
def test_tiny_plain_matches_jax(name):
    B, Sq, Skv, H, D, masked = TINY_CASES[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    q = rng.standard_normal((B, Sq, H * D)).astype(np.float32)
    k = rng.standard_normal((B, Skv, H * D)).astype(np.float32)
    v = rng.standard_normal((B, Skv, H * D)).astype(np.float32)
    key_mask = None
    if masked:
        key_mask = np.ones((B, Skv), np.int32)
        key_mask[0, Skv // 2:] = 0  # a padded row
        if masked == "full_row":
            key_mask[1] = 0  # batch row 1: every key masked -> P = 1/Skv
    scale = D ** -0.5
    want = jax_tiny(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), num_heads=H,
                    key_mask=None if key_mask is None else jnp.asarray(key_mask),
                    scale=scale)
    got = tiny_block_attention(_t(q), _t(k), _t(v), num_heads=H,
                               key_mask=None if key_mask is None else _t(key_mask),
                               scale=scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if masked == "full_row":  # the masked row averages the values of its Skv keys
        _, probs = tiny_attention_fwd(_t(q), _t(k), _t(v), H, _t(key_mask), scale=scale,
                                      return_probs=True)
        np.testing.assert_allclose(probs.numpy()[1], 1.0 / Skv, rtol=1e-6)
        np.testing.assert_allclose(got.numpy()[1],
                                   np.broadcast_to(v[1].mean(0), got.shape[1:]), **TOL)


def test_tiny_dropout_multiplier_and_probs_match_jax():
    """The same injected dropout multiplier through both plain versions; the
    fp32 probabilities are the pre-dropout softmax."""
    B, Sq, Skv, H, D = 2, 16, 24, 4, 16
    rng = np.random.default_rng(7)
    q = rng.standard_normal((B, Sq, H * D)).astype(np.float32) * D ** -0.5
    k = rng.standard_normal((B, Skv, H * D)).astype(np.float32)
    v = rng.standard_normal((B, Skv, H * D)).astype(np.float32)
    key_mask = np.ones((B, Skv), np.int32)
    key_mask[1, 20:] = 0
    rate = 0.1
    dmask = np.where(rng.random((B, Sq, H * Skv)) >= rate,
                     1.0 / (1.0 - rate), 0.0).astype(np.float32)
    want = jax_tiny_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jax_krow(jnp.asarray(key_mask)), jnp.asarray(dmask), H)
    out, probs = tiny_attention_fwd(_t(q), _t(k), _t(v), H, _t(key_mask),
                                    _t(dmask), scale=1.0, return_probs=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)

    q4 = q.reshape(B, Sq, H, D).transpose(0, 2, 1, 3)
    k4 = k.reshape(B, Skv, H, D).transpose(0, 2, 1, 3)
    logits = jnp.einsum("bhqd,bhkd->bhqk", q4, k4) + \
        jax_krow(jnp.asarray(key_mask))[:, None, None, :]
    p = np.asarray(jax.nn.softmax(logits, axis=-1)).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(probs.numpy(), p.reshape(B, Sq, H * Skv), **TOL)
    assert probs.dtype == torch.float32


def test_tiny_dropout_draws_from_explicit_generator():
    x = torch.randn(2, 8, 32, generator=torch.Generator().manual_seed(0))
    outs = [tiny_block_attention(x, x, x, num_heads=2, dropout_rate=0.5,
                                 training=True,
                                 generator=torch.Generator().manual_seed(3))
            for _ in range(2)]
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    eval_out = tiny_block_attention(x, x, x, num_heads=2, dropout_rate=0.5)
    assert not torch.equal(outs[0], eval_out)


@pytest.mark.parametrize("case", ["bias_explicit_mask", "causal_key_mask"])
def test_plain_dot_product_attention_matches_jax(case):
    B, H, S, D = 2, 3, 20, 16
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal((B, H, S, D)).astype(np.float32) for _ in range(3))
    kwargs_j, kwargs_t = {}, {}
    if case == "bias_explicit_mask":
        bias = rng.standard_normal((1, H, S, S)).astype(np.float32)
        mask = rng.random((B, 1, S, S)) > 0.2
        kwargs_j = dict(bias=jnp.asarray(bias), mask=jnp.asarray(mask))
        kwargs_t = dict(bias=_t(bias), mask=_t(mask))
    else:
        km = np.ones((B, S), np.int32)
        km[0, 15:] = 0
        kwargs_j = dict(key_mask=jnp.asarray(km), causal=True)
        kwargs_t = dict(key_mask=_t(km), causal=True)
    want = jax_dpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), impl="xla",
                   **kwargs_j)
    got = dot_product_attention(_t(q), _t(k), _t(v), **kwargs_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_wrappers_take_the_plain_version_on_cpu():
    """CPU tensors never launch a kernel: the launch counts stay put and the
    result is the plain version's, bit for bit."""
    f0, t0 = flash_attention_fwd.launches, tiny_attention_fwd.launches
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(1, 2, 130, 64, generator=gen)
    out, lse = flash_attention_fwd(q, q, q)
    ref_out, ref_lse = flash_attention_reference(q, q, q)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    x = torch.randn(2, 10, 64, generator=gen)
    out, probs = tiny_attention_fwd(x, x, x, 4, return_probs=True)
    ref_out, ref_probs = tiny_attention_reference(x, x, x, 4)
    assert torch.equal(out, ref_out) and torch.equal(probs, ref_probs)
    assert tiny_attention_fwd(x, x, x, 4)[1] is None
    assert (flash_attention_fwd.launches, tiny_attention_fwd.launches) == (f0, t0)
