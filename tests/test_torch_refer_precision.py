"""The last host-side modules against the JAX package on the CPU:
``evalkit/refer.py`` (COCO RLE decode, mask IoU, the mask-scoring
grounding eval) and ``evalkit/grounding.grounding_eval_vlue`` (the bicubic
resize and the detection scoring) on written refs and RLE strings with
``hypothesis``-drawn masks and predictions; ``core/precision.py``
(``DynamicLossScale``'s scale sequence over a drawn run of finite and
non-finite steps, ``cast_floating``, ``all_finite``); and
``train/profiling.py`` (a trace written inside ``StepTimer``'s window)."""

import glob
import os

import numpy as np
import pytest
from tests.torch_threads import few_torch_threads  # noqa: E402,F401 (autouse)

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")

import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from x2vlm_tpu.core import precision as jax_precision  # noqa: E402
from x2vlm_tpu.evalkit import grounding as jax_grounding, refer as jax_refer  # noqa: E402
from x2vlm_tpu_torch.core import precision  # noqa: E402
from x2vlm_tpu_torch.evalkit import grounding, refer  # noqa: E402
from x2vlm_tpu_torch.train.profiling import StepTimer, maybe_trace_step  # noqa: E402

FAST = settings(max_examples=40, deadline=None, derandomize=True)


def rle_string(counts):
    """pycocotools' ``rleToString``: the counts from the third on
    delta-coded against the count two back, 5 bits a character from
    chr(48), 0x20 a continuation."""
    out = []
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = x != -1 if c & 0x10 else x != 0
            out.append(chr(48 + (c | 0x20 if more else c)))
    return "".join(out)


def rle_counts(mask):
    """Runs of the column-major mask, starting with a run of zeros."""
    flat = mask.T.reshape(-1)
    counts, val, run = [], 0, 0
    for v in flat:
        if v != val:
            counts.append(run)
            val, run = v, 0
        run += 1
    counts.append(run)
    return counts


masks = st.tuples(st.integers(1, 12), st.integers(1, 12), st.integers(0, 2 ** 31)).map(
    lambda t: (np.random.default_rng(t[2]).random((t[0], t[1])) <
               np.random.default_rng(t[2] + 1).random()).astype(np.uint8))


@FAST
@given(masks)
def test_rle_decode_equals_jax_on_strings_and_counts(mask):
    counts = rle_counts(mask)
    for rle in ({"size": list(mask.shape), "counts": rle_string(counts)},
                {"size": list(mask.shape), "counts": counts}):
        got = refer.rle_decode(rle)
        assert np.array_equal(got, jax_refer.rle_decode(rle))
        assert np.array_equal(got, mask)


@FAST
@given(masks, masks)
def test_mask_iou_equals_jax(a, b):
    b = np.resize(b, a.shape)
    assert refer.mask_iou(a, b) == jax_refer.mask_iou(a, b)


def preds(rng, n):
    return [rng.random(4).tolist() for _ in range(n)]


@FAST
@given(st.integers(0, 2 ** 31), st.floats(0.1, 0.9))
def test_grounding_eval_mask_equals_jax(seed, thresh):
    rng = np.random.default_rng(seed)
    refs = {}
    for i in range(6):
        h, w = rng.integers(4, 20, 2)
        mask = np.zeros((h, w), np.uint8)
        y0, x0 = rng.integers(0, h), rng.integers(0, w)
        mask[y0: y0 + rng.integers(1, h), x0: x0 + rng.integers(1, w)] = 1
        rle = {"size": [int(h), int(w)], "counts": rle_string(rle_counts(mask))}
        refs[i] = {"split": ("val", "testA", "testB")[i % 3], "rle": rle}
        if i % 2:
            refs[i].update(width=int(w), height=int(h))
    results = [{"ref_id": i % 7, "pred": p} for i, p in enumerate(preds(rng, 9))]
    got = refer.grounding_eval_mask(results, refs, iou_thresh=thresh)
    assert got == jax_refer.grounding_eval_mask(results, refs, iou_thresh=thresh)


@FAST
@given(st.integers(0, 2 ** 31), st.floats(0.0, 1.5))
def test_grounding_eval_vlue_equals_jax(seed, alpha):
    rng = np.random.default_rng(seed)
    test_json = []
    for i in range(4):
        h, w = (int(x) for x in rng.integers(10, 60, 2))
        dets = [[*(rng.random(2) * [w / 2, h / 2]), *(rng.random(2) * [w / 2, h / 2] + 1)]
                for _ in range(int(rng.integers(0, 5)))]
        test_json.append({"ref_id": i, "height": h, "width": w, "dets": dets,
                          "bbox": dets[0] if dets and i % 2 else
                          [1.0, 2.0, w / 3, h / 3]})
    results = [{"ref_id": i, "pred": rng.random(24 * 24).tolist()} for i in range(4)]
    got = grounding.grounding_eval_vlue(results, test_json, alpha)
    assert got == jax_grounding.grounding_eval_vlue(results, test_json, alpha)


@pytest.mark.parametrize("shape,size", [((24, 24), (37, 51)), ((24, 24), (12, 20)),
                                        ((5, 7), (5, 7))])
def test_the_bicubic_resize_is_torchs_and_the_jax_ones(shape, size):
    x = np.random.default_rng(0).standard_normal(shape)
    got = grounding._resize_bicubic(x, *size)
    assert np.array_equal(got, jax_grounding._resize_bicubic(x, *size))
    want = torch.nn.functional.interpolate(torch.tensor(x)[None, None], size=size,
                                           mode="bicubic", align_corners=False)[0, 0]
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-10, atol=1e-10)


@settings(max_examples=40, deadline=None, derandomize=True)
@given(st.lists(st.booleans(), min_size=1, max_size=40), st.sampled_from([1.0, 8.0, 1024.0]))
def test_dynamic_loss_scale_sequence_equals_jax(finite, init):
    got = precision.DynamicLossScale.create(init_scale=init, growth_interval=3)
    want = jax_precision.DynamicLossScale.create(init_scale=init, growth_interval=3)
    for f in finite:
        got, want = got.update(torch.tensor(f)), want.update(jnp.asarray(f))
        assert got.scale.item() == float(want.scale)
        assert got.good_steps.item() == int(want.good_steps)
        assert 1.0 <= got.scale.item() <= 1024.0


def test_loss_scaling_casts_and_finiteness_equal_jax():
    ls = precision.DynamicLossScale.create(init_scale=64.0)
    jls = jax_precision.DynamicLossScale.create(init_scale=64.0)
    loss = np.float32(1.37)
    assert ls.scale_loss(torch.tensor(loss)).item() == float(jls.scale_loss(jnp.asarray(loss)))
    g = {"a": np.arange(6, dtype=np.float32).reshape(2, 3), "b": [np.float32(3.5)]}
    got = ls.unscale_grads({"a": torch.tensor(g["a"]), "b": [torch.tensor(g["b"][0])]})
    want = jls.unscale_grads({"a": jnp.asarray(g["a"]), "b": [jnp.asarray(g["b"][0])]})
    assert np.array_equal(got["a"].numpy(), np.asarray(want["a"]))
    assert got["b"][0].item() == float(want["b"][0])
    tree = {"w": torch.ones(2), "i": torch.arange(3), "n": [torch.tensor(1.0)]}
    cast = precision.DEFAULT_POLICY.cast_to_compute(tree)
    assert cast["w"].dtype == torch.bfloat16 and cast["i"].dtype == torch.int64
    assert precision.FP32_POLICY.cast_to_compute(tree)["w"].dtype == torch.float32
    jax_tree = lambda t: {k: [jnp.asarray(x.numpy()) for x in v] if isinstance(v, list)
                          else jnp.asarray(v.numpy()) for k, v in t.items()}
    for n in (1.0, float("inf"), float("nan")):
        tree["n"][0] = torch.tensor(n)
        assert precision.all_finite(tree).item() == bool(jax_precision.all_finite(
            jax_tree(tree))) == (n == 1.0)
    assert precision.all_finite({}).item() and bool(jax_precision.all_finite({}))


def test_step_timer_writes_a_trace_inside_its_window(tmp_path):
    """Steps 1-3 traced (the JAX timer's window [1, 1 + 2] closes at the
    end of the first step >= 3): no trace before, one after."""
    timer = StepTimer(str(tmp_path / "trace"), start_step=1, num_steps=2)
    x = torch.randn(32, 32)
    found = []
    for step in range(5):
        timer.step_begin(step)
        y = x @ x
        assert timer.step_end(step, y) >= 0.0
        found.append(len(glob.glob(str(tmp_path / "trace" / "*.pt.trace.json"))))
    assert found == [0, 0, 0, 1, 1]
    with maybe_trace_step(str(tmp_path / "off"), enabled=False):
        x @ x
    assert not os.path.exists(tmp_path / "off")
    with maybe_trace_step(str(tmp_path / "on"), enabled=True):
        x @ x
    assert glob.glob(str(tmp_path / "on" / "*.pt.trace.json"))
