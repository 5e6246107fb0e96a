"""The port's attention backward against ``jax.vjp`` of the JAX package's
attention, in fp32 on the CPU.

On the CPU the backward wrappers run their plain PyTorch versions
(``flash_attention_bwd_reference``, ``tiny_attention_bwd_reference``); the
JAX ``flash_attention`` routes to ``_xla_attention`` there and the tiny
attention to ``_xla_reference``, whose gradients are the reference. The same
numpy-seeded inputs, output gradient, key mask and dropout multiplier go
into both. Tolerance: rtol = atol = 1e-5 (fp32, different summation
orders); dbias of a batch-shared bias 1e-4, since it sums dS over the batch
rows (and the heads, for a head-shared bias) in another order.
"""

import zlib

import numpy as np
import pytest
from tests.torch_threads import few_torch_threads  # noqa: E402,F401 (autouse)

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from x2vlm_tpu.ops.flash_attention import flash_attention as jax_flash  # noqa: E402
from x2vlm_tpu.ops.tiny_attention import (  # noqa: E402
    _krow as jax_krow, _xla_reference as jax_tiny_reference,
)
from x2vlm_tpu_torch.ops.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_bwd, flash_attention_bwd_reference,
    flash_attention_fwd,
)
from x2vlm_tpu_torch.ops.tiny_attention import (  # noqa: E402
    _TinyAttention, tiny_attention_bwd, tiny_attention_bwd_reference,
    tiny_attention_fwd, tiny_block_attention, tiny_supported,
)

TOL = dict(rtol=1e-5, atol=1e-5)
TOL_SUM = dict(rtol=1e-4, atol=1e-4)

# the FLASH_CASES of test_torch_attention.py, plus a head-shared bias
FLASH_CASES = {
    # name: (B, H, Sq, Skv, bias shape or None, mask kind, causal)
    "bias_shared_197": (2, 2, 197, 197, (1, 2), None, False),
    "bias_per_batch": (2, 2, 130, 130, (2, 2), None, False),
    "bias_head_shared": (2, 3, 130, 130, (1, 1), None, False),
    "key_mask_fully_masked_row": (3, 2, 150, 150, None, "full_row", False),
    "causal": (2, 2, 140, 140, None, None, True),
    "cross_100x300": (2, 2, 100, 300, None, None, False),
    # the tensor-core route's ragged edges: 130 rows and 129 keys off every
    # 64 tile, a (1, H) bias; 197 x 200 with a bias and a key mask
    "ragged_130x129_bias": (2, 3, 130, 129, (1, 3), None, False),
    "key_mask_197x200_bias": (2, 2, 197, 200, (1, 2), "random", False),
}


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _flash_inputs(name):
    B, H, Sq, Skv, bias_bh, mask_kind, causal = FLASH_CASES[name]
    D = 64
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    q = rng.standard_normal((B, H, Sq, D)).astype(np.float32)
    k = rng.standard_normal((B, H, Skv, D)).astype(np.float32)
    v = rng.standard_normal((B, H, Skv, D)).astype(np.float32)
    dout = rng.standard_normal((B, H, Sq, D)).astype(np.float32)
    bias = None if bias_bh is None else \
        rng.standard_normal(bias_bh + (Sq, Skv)).astype(np.float32)
    key_mask = None
    if mask_kind is not None:
        key_mask = (rng.random((B, Skv)) > 0.3).astype(np.int32)
    if mask_kind == "full_row":
        key_mask[1] = 0  # batch row 1: every key masked -> the forward averages V
    return q, k, v, bias, key_mask, dout, causal, D ** -0.5


def _jax_flash_grads(q, k, v, bias, key_mask, dout, causal, scale):
    def f(q, k, v, bias):
        return jax_flash(q, k, v, bias=bias,
                         key_mask=None if key_mask is None else jnp.asarray(key_mask),
                         causal=causal, scale=scale)
    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     None if bias is None else jnp.asarray(bias))
    return [None if g is None else np.asarray(g) for g in vjp(jnp.asarray(dout))]


@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_bwd_reference_matches_jax(name):
    q, k, v, bias, key_mask, dout, causal, scale = _flash_inputs(name)
    want = _jax_flash_grads(q, k, v, bias, key_mask, dout, causal, scale)
    tb, tk = (None if x is None else _t(x) for x in (bias, key_mask))
    out, lse = flash_attention_fwd(_t(q), _t(k), _t(v), tb, tk, causal, scale)
    got = flash_attention_bwd_reference(_t(q), _t(k), _t(v), tb, tk, out, lse, _t(dout),
                                        causal, scale)
    for label, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        if w is None:
            assert g is None
            continue
        tol = TOL_SUM if label == "dbias" and bias.shape[:2] != q.shape[:2] else TOL
        np.testing.assert_allclose(g.numpy(), w, err_msg=label, **tol)
        assert g.shape == w.shape and np.isfinite(g.numpy()).all()


@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_autograd_matches_jax(name):
    """The public entry's autograd Function (its backward runs the wrapper,
    which takes the plain version on the CPU) against jax.vjp."""
    q, k, v, bias, key_mask, dout, causal, scale = _flash_inputs(name)
    want = _jax_flash_grads(q, k, v, bias, key_mask, dout, causal, scale)
    leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    tb = None if bias is None else _t(bias).requires_grad_()
    out = flash_attention(*leaves, bias=tb,
                          key_mask=None if key_mask is None else _t(key_mask),
                          causal=causal, scale=scale)
    out.backward(_t(dout))
    for label, leaf, w in zip(("dq", "dk", "dv", "dbias"), leaves + [tb], want):
        if w is None:
            continue
        tol = TOL_SUM if label == "dbias" and bias.shape[:2] != q.shape[:2] else TOL
        np.testing.assert_allclose(leaf.grad.numpy(), w, err_msg=label, **tol)


def test_flash_bwd_without_dbias():
    q, k, v, bias, key_mask, dout, causal, scale = _flash_inputs("bias_shared_197")
    out, lse = flash_attention_fwd(_t(q), _t(k), _t(v), _t(bias), None, causal, scale)
    dq, dk, dv, db = flash_attention_bwd(_t(q), _t(k), _t(v), _t(bias), None, out, lse,
                                         _t(dout), causal, scale, need_dbias=False)
    assert db is None
    ref = flash_attention_bwd_reference(_t(q), _t(k), _t(v), _t(bias), None, out, lse,
                                        _t(dout), causal, scale)
    for a, b in zip((dq, dk, dv), ref):
        assert torch.equal(a, b)


TINY_CASES = {
    # name: (B, Sq, Skv, H, D, masked, dropout)
    "self_40x40_mask_dropout": (3, 40, 40, 4, 16, True, True),
    "cross_40x200_mask_dropout": (2, 40, 200, 2, 32, True, True),
    "cross_40x197_no_mask": (2, 40, 197, 2, 32, False, False),
    "non_multiple_of_8": (2, 13, 27, 3, 8, True, True),
    "cross_40x200_full_row_masked": (2, 40, 200, 2, 32, "full_row", True),
}


def _tiny_inputs(name):
    B, Sq, Skv, H, D, masked, dropout = TINY_CASES[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    q = rng.standard_normal((B, Sq, H * D)).astype(np.float32)
    k = rng.standard_normal((B, Skv, H * D)).astype(np.float32)
    v = rng.standard_normal((B, Skv, H * D)).astype(np.float32)
    g = rng.standard_normal((B, Sq, H * D)).astype(np.float32)
    key_mask = None
    if masked:
        key_mask = np.ones((B, Skv), np.int32)
        key_mask[0, Skv // 2:] = 0
        if masked == "full_row":
            key_mask[1] = 0  # batch row 1: every key masked -> P = 1/Skv
    dmask = None
    if dropout:
        dmask = np.where(rng.random((B, Sq, H * Skv)) >= 0.1, 1.0 / 0.9,
                         0.0).astype(np.float32)
    return q, k, v, g, key_mask, dmask, H, D ** -0.5


def _jax_tiny_grads(q, k, v, g, key_mask, dmask, H, scale):
    krow = None if key_mask is None else jax_krow(jnp.asarray(key_mask))
    dm = None if dmask is None else jnp.asarray(dmask)

    def f(q, k, v):
        return jax_tiny_reference(q * jnp.float32(scale), k, v, krow, dm, H)
    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(x) for x in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("name", sorted(TINY_CASES))
def test_tiny_bwd_reference_matches_jax(name):
    q, k, v, g, key_mask, dmask, H, scale = _tiny_inputs(name)
    want = _jax_tiny_grads(q, k, v, g, key_mask, dmask, H, scale)
    dm = None if dmask is None else _t(dmask)
    _, probs = tiny_attention_fwd(_t(q), _t(k), _t(v), H,
                                  None if key_mask is None else _t(key_mask), dm,
                                  scale, return_probs=True)
    got = tiny_attention_bwd_reference(_t(q), _t(k), _t(v), probs, dm, _t(g), H, scale)
    for label, a, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), w, err_msg=label, **TOL)


@pytest.mark.parametrize("name", sorted(TINY_CASES))
def test_tiny_bwd_reference_with_out_matches_jax(name):
    """The plain backward taking its row sums from the forward's ``out``
    (as the key-tiled kernel does) gives the JAX gradients in fp32."""
    q, k, v, g, key_mask, dmask, H, scale = _tiny_inputs(name)
    want = _jax_tiny_grads(q, k, v, g, key_mask, dmask, H, scale)
    dm = None if dmask is None else _t(dmask)
    out, probs = tiny_attention_fwd(_t(q), _t(k), _t(v), H,
                                    None if key_mask is None else _t(key_mask), dm,
                                    scale, return_probs=True)
    got = tiny_attention_bwd_reference(_t(q), _t(k), _t(v), probs, dm, _t(g), H, scale,
                                       out=out)
    for label, a, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), w, err_msg=label, **TOL)


@pytest.mark.parametrize("name", sorted(TINY_CASES))
def test_tiny_autograd_matches_jax(name):
    q, k, v, g, key_mask, dmask, H, scale = _tiny_inputs(name)
    want = _jax_tiny_grads(q, k, v, g, key_mask, dmask, H, scale)
    leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    out = _TinyAttention.apply(*leaves, None if key_mask is None else _t(key_mask),
                               None if dmask is None else _t(dmask), H, scale)
    out.backward(_t(g))
    for label, leaf, w in zip(("dq", "dk", "dv"), leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), w, err_msg=label, **TOL)


def test_tiny_block_attention_keeps_its_dropout_multiplier_for_the_backward():
    """The multiplier drawn in the forward is the one the backward uses: the
    gradients equal autograd through the plain forward with the same draw."""
    B, Sq, H, D = 2, 12, 2, 16
    x = torch.randn(B, Sq, H * D, generator=torch.Generator().manual_seed(0))
    a = x.clone().requires_grad_()
    tiny_block_attention(a, a, a, num_heads=H, dropout_rate=0.3, training=True,
                         generator=torch.Generator().manual_seed(5)).sum().backward()
    from x2vlm_tpu_torch.ops.attention import dropout_multiplier
    dm = dropout_multiplier((B, Sq, H * Sq), 0.3, torch.Generator().manual_seed(5),
                            x.dtype, x.device)
    b = x.clone().requires_grad_()
    from x2vlm_tpu_torch.ops.tiny_attention import tiny_attention_reference
    tiny_attention_reference(b, b, b, H, None, dm, D ** -0.5)[0].sum().backward()
    np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), **TOL)


def test_tiny_dispatch_admits_only_shapes_both_kernels_fit():
    """Both kernels take every admitted shape: on the resident walk up to
    257 keys at Sq=40 (209 at Sq=64), on the key-tiled walk past that."""
    from x2vlm_tpu_torch.ops.tiny_attention import RESIDENT, TILED, tiny_walk

    assert tiny_supported(40, 40, 64) and tiny_supported(40, 200, 64)
    assert tiny_walk(40, 257, 64) == RESIDENT and tiny_walk(40, 258, 64) == TILED
    assert tiny_walk(64, 209, 64) == RESIDENT and tiny_walk(64, 210, 64) == TILED
    assert tiny_supported(40, 258, 64) and tiny_supported(40, 584, 64)
    assert tiny_supported(64, 210, 64)
    assert not tiny_supported(65, 40, 64)


def test_tiny_bwd_wrapper_takes_the_plain_version_on_cpu():
    q, k, v, g, key_mask, dmask, H, scale = _tiny_inputs("non_multiple_of_8")
    n0 = tiny_attention_bwd.launches
    out, probs = tiny_attention_fwd(_t(q), _t(k), _t(v), H, _t(key_mask), _t(dmask),
                                    scale, return_probs=True)
    got = tiny_attention_bwd(_t(q), _t(k), _t(v), probs, _t(dmask), _t(g), H, scale,
                             out=out)
    ref = tiny_attention_bwd_reference(_t(q), _t(k), _t(v), probs, _t(dmask), _t(g), H,
                                       scale)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert tiny_attention_bwd.launches == n0


@pytest.mark.parametrize("name", ["self_40x40_mask_dropout", "cross_40x200_full_row_masked",
                                  "cross_40x197_no_mask"])
def test_rowsum_g_out_is_the_softmax_backward_row_sum(name):
    """The key-tiled backward takes the softmax backward's row sums as
    rowsum(g * out) per head: equal to rowsum(dP * dm * P), dP = g . V^T,
    since out = (P * dm) . V; in fp32 with dropout on, with a partly masked
    batch row and (full_row) a wholly masked one."""
    q, k, v, g, key_mask, dmask, H, scale = _tiny_inputs(name)
    B, Sq, HD = q.shape
    Skv, D = k.shape[1], HD // H
    dm = None if dmask is None else _t(dmask)
    out, probs = tiny_attention_fwd(_t(q), _t(k), _t(v), H,
                                    None if key_mask is None else _t(key_mask), dm, scale,
                                    return_probs=True)
    heads = lambda t, n: t.view(B, n, H, D).transpose(1, 2)
    p = probs.view(B, Sq, H, Skv).transpose(1, 2)
    pu = p if dm is None else p * dm.view(B, Sq, H, Skv).transpose(1, 2)
    dp = torch.matmul(heads(_t(g), Sq), heads(_t(v), Skv).transpose(-1, -2))
    want = (dp * pu).sum(-1)                                   # (B, H, Sq)
    got = (heads(_t(g), Sq) * heads(out, Sq)).sum(-1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


class _StandInFn:
    def __init__(self, name, calls):
        self.name, self.calls = name, calls

    def __call__(self, *args):
        self.calls.append((self.name, args))
        return 0


@pytest.mark.parametrize("Sq,Skv", [(40, 584), (40, 258), (40, 200)])
def test_tiny_bwd_wrapper_passes_out_to_the_library(Sq, Skv, monkeypatch):
    """On meta tensors with a stand-in library: the backward wrapper hands
    the forward's out to the C entry (after g), on the key-tiled walk (40 x
    584, 40 x 258) and on the resident one (40 x 200) alike."""
    import contextlib
    import types

    from x2vlm_tpu_torch.ops import _build
    from x2vlm_tpu_torch.ops import tiny_attention as ta

    calls = []
    lib = type("Lib", (), {})()
    for fn_name in ta._SIGNATURES:
        setattr(lib, fn_name, _StandInFn(fn_name, calls))
    monkeypatch.setattr(_build, "load", lambda n: lib)
    monkeypatch.setattr(ta, "_check_cuda", lambda *a: None)   # meta tensors stand in
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(tiny_attention_bwd, "launches", 0)
    B, H, D = 2, 12, 64
    meta = dict(device="meta", dtype=torch.bfloat16)
    q, g, out = (torch.empty(B, Sq, H * D, **meta) for _ in range(3))
    k, v = (torch.empty(B, Skv, H * D, **meta) for _ in range(2))
    probs = torch.empty(B, Sq, H * Skv, device="meta")
    dm = torch.empty(B, Sq, H * Skv, **meta)
    operands = (q, k, v, probs, dm, g, out)
    ptrs = {id(t): 16 * (i + 1) for i, t in enumerate(operands)}   # meta tensors' are all 0
    monkeypatch.setattr(torch.Tensor, "data_ptr", lambda self: ptrs.get(id(self), 0))
    with pytest.raises(TypeError, match="out"):
        tiny_attention_bwd(q, k, v, probs, dm, g, H, D ** -0.5)
    assert calls == [] and tiny_attention_bwd.launches == 0
    dq, dk, dv = tiny_attention_bwd(q, k, v, probs, dm, g, H, D ** -0.5, out=out)
    (fn_name, c_args), = calls
    assert fn_name == "x2_tiny_attention_bwd"
    assert len(c_args) == len(ta._SIGNATURES[fn_name][0])
    # q k v probs dm | kind | g out | dq dk dv
    assert c_args[:5] + c_args[6:8] == tuple(16 * (i + 1) for i in range(7))
    assert c_args[11:17] == (B, Sq, Skv, H, D, 1)
    assert dq.shape == q.shape and dk.shape == k.shape and tiny_attention_bwd.launches == 1
