"""The tiny attention kernels' two routes, on the CPU: which kernel a launch
takes (``tiny_route``), each route's shared-memory need against Hopper's
per-block limit, the dispatch rule ``tiny_supported``, and the wrappers'
refusal to run the plain version for a CUDA tensor when the kernel cannot
be built. The kernels themselves run only on the card (``chip_smoke.py``
holds the C route rule and the C formulas equal to these)."""

import os

import numpy as np
import pytest
from tests.torch_threads import few_torch_threads  # noqa: E402,F401 (autouse)

torch = pytest.importorskip("torch")

from tests.test_torch_hygiene import _CudaStandIn  # noqa: E402
from x2vlm_tpu_torch.ops import _build  # noqa: E402
from x2vlm_tpu_torch.ops import tiny_attention as ta  # noqa: E402
from x2vlm_tpu_torch.ops.tiny_attention import (  # noqa: E402
    CUDA_CORE, RESIDENT, TENSOR_CORE, TILED, bwd_smem_bytes, smem_bytes, tiled_bwd_smem_bytes,
    tiled_smem_bytes, tiny_route, tiny_supported, tiny_walk,
)

SMEM_LIMIT = 232448          # bytes one block may use on Hopper
CUDA_CORE_FWD_40x200 = 111648  # the CUDA-core forward's need at 40x200, D=64
BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype,head_dim,route", [
    (BF16, 64, TENSOR_CORE),   # the main path: text 40x40, fusion 40x40 and 40x200
    (BF16, 16, TENSOR_CORE),
    (BF16, 32, TENSOR_CORE),
    (BF16, 128, TENSOR_CORE),
    (BF16, 8, CUDA_CORE),      # not a multiple of 16
    (BF16, 24, CUDA_CORE),
    (BF16, 144, CUDA_CORE),    # above 128
    (BF16, 256, CUDA_CORE),    # the backward contract's D=256
    (F32, 32, CUDA_CORE),      # fp32 keeps fp32 arithmetic at every head dim
    (F32, 64, CUDA_CORE),
    (F32, 128, CUDA_CORE),
    (F32, 256, CUDA_CORE),
])
def test_tiny_route(dtype, head_dim, route):
    assert tiny_route(dtype, head_dim) == route


# (Sq, Skv, D) of every shape the kernels are held to on the card: the main
# path's and the contract's (chip_smoke.py check_tiny / check_tiny_bwd; the
# CCLM cell's 64 x 64 and 64 x 200)
FWD_SHAPES = [(40, 40, 64), (40, 200, 64), (40, 56, 64), (40, 197, 64), (64, 420, 64), (13, 27, 32),
              (80, 50, 64), (1, 7, 128), (5, 9, 256), (17, 33, 16), (40, 77, 48),
              (24, 61, 96), (9, 45, 112), (64, 64, 64), (64, 200, 64)]
BWD_SHAPES = [(40, 40, 64), (40, 200, 64), (40, 56, 64), (40, 197, 64), (64, 209, 64), (13, 27, 32),
              (1, 7, 128), (5, 9, 256), (40, 257, 64), (40, 120, 128), (80, 50, 64),
              (17, 33, 16), (40, 77, 48), (24, 61, 96), (9, 45, 112), (64, 64, 64),
              (64, 200, 64)]


@pytest.mark.parametrize("Sq,Skv,D", FWD_SHAPES)
def test_forward_smem_fits_a_block_on_both_routes(Sq, Skv, D):
    for route in (CUDA_CORE, TENSOR_CORE):
        if route == TENSOR_CORE and tiny_route(BF16, D) != TENSOR_CORE:
            continue
        assert 0 < smem_bytes(Skv, D, route) <= SMEM_LIMIT, (route, Skv, D)


@pytest.mark.parametrize("Sq,Skv,D", BWD_SHAPES)
def test_backward_smem_fits_a_block_on_both_routes(Sq, Skv, D):
    for route in (CUDA_CORE, TENSOR_CORE):
        if route == TENSOR_CORE and tiny_route(BF16, D) != TENSOR_CORE:
            continue
        assert 0 < bwd_smem_bytes(Sq, Skv, D, route) <= SMEM_LIMIT, (route, Sq, Skv, D)


def test_tensor_core_forward_needs_less_smem_than_the_cuda_core_one():
    assert smem_bytes(200, 64) == CUDA_CORE_FWD_40x200
    assert smem_bytes(200, 64, TENSOR_CORE) < CUDA_CORE_FWD_40x200
    assert bwd_smem_bytes(40, 200, 64, TENSOR_CORE) < bwd_smem_bytes(40, 200, 64)


def test_every_shape_the_dispatch_admits_fits_the_tensor_core_kernels():
    """Each shape ``tiny_supported`` admits at a tensor-core head dim fits
    the tensor-core kernels of its walk: the resident ones where the
    CUDA-core resident kernels fit, the key-tiled ones past that."""
    for D in (16, 32, 48, 64, 80, 96, 112, 128):
        for Sq in range(1, ta.MAX_QUERY_LEN + 1):
            for Skv in range(1, 1000):
                assert tiny_supported(Sq, Skv, D), (Sq, Skv, D)
                if tiny_walk(Sq, Skv, D) == RESIDENT:
                    assert smem_bytes(Skv, D, TENSOR_CORE) <= SMEM_LIMIT, (Sq, Skv, D)
                    assert bwd_smem_bytes(Sq, Skv, D, TENSOR_CORE) <= SMEM_LIMIT, (Sq, Skv, D)
            for route in (CUDA_CORE, TENSOR_CORE):
                assert tiled_smem_bytes(Sq, D, route) <= SMEM_LIMIT, (route, Sq, D)
                assert tiled_bwd_smem_bytes(Sq, D, route) <= SMEM_LIMIT, (route, Sq, D)


def _supported_before(Sq, Skv, D):
    """The dispatch rule as the CUDA-core kernels alone set it."""
    fwd = 4 * (Skv * (D + 1) + Skv * D + 8 * Skv + 8 * D)
    bwd = 4 * (max(2 * Skv * (D + 1), 2 * Sq * D) + 2 * Sq * Skv + 16 * 4 * D)
    return Sq <= 64 and D <= 256 and fwd <= SMEM_LIMIT and bwd <= SMEM_LIMIT


@pytest.mark.parametrize("D", [16, 32, 64, 128, 256])
def test_tiny_supported_answers_are_unchanged(D):
    """Every shape the resident kernels alone admitted is still admitted, on
    the resident walk (its kernels and times unchanged); past them the
    key-tiled walk admits every short-query shape at D <= 128."""
    for Sq in (1, 13, 40, 64, 65):
        for Skv in list(range(1, 300, 7)) + [196, 197, 200, 209, 210, 257, 258, 420, 584]:
            before = _supported_before(Sq, Skv, D)
            if before:
                assert tiny_walk(Sq, Skv, D) == RESIDENT, (Sq, Skv, D)
            assert tiny_supported(Sq, Skv, D) == (before or (Sq <= 64 and D <= 128)), (Sq, Skv, D)


def test_dtype_scale_is_the_rounded_scale():
    for s in (64 ** -0.5, 60 ** -0.5, 1.0, 0.3):
        for dt in (BF16, F32):
            assert ta._dtype_scale(s, dt) == float(torch.tensor(s, dtype=dt))


class _FakeLib:
    """A loaded library's C functions, as ctypes presents them."""

    def __init__(self):
        for name in ta._SIGNATURES:
            setattr(self, name, type("CFunc", (), {})())


def test_typed_lib_types_each_library_object_once():
    """The mark lives on the library object, so a second library is typed
    even if it reuses the address of one that was freed."""
    first = _FakeLib()
    assert ta.typed_lib(first) is first
    for name, (argtypes, restype) in ta._SIGNATURES.items():
        assert getattr(first, name).argtypes == argtypes
        assert getattr(first, name).restype == restype
    first.x2_tiny_attention_fwd.argtypes = None   # typed once: not set again
    ta.typed_lib(first)
    assert first.x2_tiny_attention_fwd.argtypes is None
    second = _FakeLib()
    ta.typed_lib(second)
    assert second.x2_tiny_attention_fwd.argtypes == ta._SIGNATURES["x2_tiny_attention_fwd"][0]


class _Operand(_CudaStandIn):
    """A CUDA operand's metadata; the wrapper may ask for its contiguous form."""

    def contiguous(self):
        return self


@pytest.mark.parametrize("wrapper,dtype,head_dim", [
    ("tiny_attention_fwd", BF16, 64), ("tiny_attention_fwd", F32, 64),
    ("tiny_attention_fwd", BF16, 256),
    ("tiny_attention_bwd", BF16, 64), ("tiny_attention_bwd", F32, 64),
    ("tiny_attention_bwd", BF16, 256),
])
def test_tiny_wrappers_raise_for_cuda_without_the_library(wrapper, dtype, head_dim,
                                                          monkeypatch, tmp_path):
    """For a CUDA tensor the tiny wrappers launch a kernel (of either route)
    or raise: with no nvcc to build the library they raise, and never run
    the plain version or count a launch."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("the CUDA toolkit is installed: nvcc would build the library")
    monkeypatch.setattr(_build, "_LIBS", {})

    def no_fallback(*a, **k):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(ta, "tiny_attention_reference", no_fallback)
    monkeypatch.setattr(ta, "tiny_attention_bwd_reference", no_fallback)
    B, H = 2, 2
    Sq, Skv = (40, 200) if head_dim == 64 else (5, 9)   # shapes each route admits
    q, g = (_Operand((B, Sq, H * head_dim), dtype) for _ in range(2))
    k, v = (_Operand((B, Skv, H * head_dim), dtype) for _ in range(2))
    fn = getattr(ta, wrapper)
    before = (fn.launches, dict(fn.launches_by_route))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        if wrapper == "tiny_attention_fwd":
            fn(q, k, v, H, scale=head_dim ** -0.5, return_probs=True)
        else:
            fn(q, k, v, _Operand((B, Sq, H * Skv), F32), None, g, H, head_dim ** -0.5,
               out=_Operand((B, Sq, H * head_dim), dtype))
    assert (fn.launches, dict(fn.launches_by_route)) == before


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    rng = np.random.default_rng(0)
    B, Sq, Skv, H, D = 2, 5, 9, 2, 16
    q = torch.from_numpy(rng.standard_normal((B, Sq, H * D)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((B, Skv, H * D)).astype(np.float32))
            for _ in range(2))
    before = (ta.tiny_attention_fwd.launches, dict(ta.tiny_attention_fwd.launches_by_route))
    out, probs = ta.tiny_attention_fwd(q, k, v, H, scale=0.25, return_probs=True)
    ref, ref_probs = ta.tiny_attention_reference(q, k, v, H, scale=0.25)
    assert torch.equal(out, ref) and torch.equal(probs, ref_probs)
    assert (ta.tiny_attention_fwd.launches,
            dict(ta.tiny_attention_fwd.launches_by_route)) == before


def test_the_swin_fusion_shape_takes_the_resident_walk():
    """Swin-B's 50 image tokens, padded to 56: the fusion cross-attention
    (K / V projected from width 1024 to 768) runs 40 x 56 at D = 64 on the
    resident tensor-core kernels, as the JAX rule admits it."""
    from x2vlm_tpu.ops import tiny_attention as jta
    for B in (32, 96, 1024):
        assert jta.tiny_supported(B, 40, 56, 12, 64, has_mask=True, has_drop=True)
    assert tiny_supported(40, 56, 64) and tiny_walk(40, 56, 64) == RESIDENT
    assert tiny_route(BF16, 64) == TENSOR_CORE
    for route in (CUDA_CORE, TENSOR_CORE):
        assert smem_bytes(56, 64, route) < smem_bytes(200, 64, route) <= SMEM_LIMIT
        assert bwd_smem_bytes(40, 56, 64, route) < bwd_smem_bytes(40, 200, 64, route)


# ---- the key-tiled walk (the fusion cross-attention at 384 px: 40 x 584) ----

def test_the_384px_fusion_shape_takes_the_key_tiled_walk():
    from x2vlm_tpu.ops import tiny_attention as jta
    assert jta.tiny_supported(32, 40, 584, 12, 64, has_mask=True, has_drop=True)
    assert tiny_supported(40, 584, 64) and tiny_walk(40, 584, 64) == TILED
    # the resident kernels' need there, above the limit on every route
    assert smem_bytes(584, 64) > SMEM_LIMIT and bwd_smem_bytes(40, 584, 64) > SMEM_LIMIT
    assert bwd_smem_bytes(40, 584, 64, TENSOR_CORE) > SMEM_LIMIT
    # the tiled kernels' at the main path's shape (C formulas held equal on the
    # card, their constants to the sources' below): the forward's 3-stage ring
    # of K, V, mask and (fp32) multiplier rows and 4 warps' P blocks; the
    # backward's 2-stage ring of K, V, P and multiplier rows, g, Qs, the dL /
    # Pu planes and the row sums
    assert tiled_smem_bytes(40, 64, TENSOR_CORE) == \
        3 * (2 * 2 * 64 * 64 + 4 * 20 + 4 * 48 * 68) + 4 * 4 * 16 * 20 == 93680
    assert tiled_bwd_smem_bytes(40, 64, TENSOR_CORE) == \
        2 * (2 * 2 * 64 * 64 + 4 * 48 * 68) + 2 * 2 * 48 * (64 + 72) + 4 * 64 == 85248
    assert tiled_smem_bytes(40, 64) == 4 * (32 * 129 + 2 * 40 * 64 + 8 * 32)
    assert tiled_bwd_smem_bytes(40, 64) == 4 * (2 * 32 * 65 + 3 * 40 * 64 + 2 * 40 * 32)


@pytest.mark.parametrize("D", [32, 64, 128])
def test_tiny_supported_admits_every_shape_the_jax_rule_admits(D):
    """On a grid of Sq <= 64, Skv <= 1024: whatever the JAX rule admits (at
    the batch sizes and head counts of the fine-tune and the ITM rerank,
    with and without mask and dropout), the port admits, and the port admits
    every Sq <= 64 at D <= 128."""
    from x2vlm_tpu.ops import tiny_attention as jta
    for Sq in (1, 8, 16, 40, 64):
        for Skv in sorted(set(range(8, 1025, 61)) | {40, 200, 577, 584, 1024}):
            assert tiny_supported(Sq, Skv, D), (Sq, Skv, D)
            for B, H in ((32, 12), (1024, 12), (32, 16)):
                for mask, drop in ((True, True), (True, False), (False, False)):
                    if jta.tiny_supported(B, Sq, Skv, H, D, has_mask=mask, has_drop=drop):
                        assert tiny_supported(Sq, Skv, D), (B, Sq, Skv, H, D)
    assert not tiny_supported(65, 584, D) and not jta.tiny_supported(32, 65, 584, 12, D)


@pytest.mark.parametrize("Sq,D", [(1, 16), (40, 64), (64, 64), (64, 128), (13, 48)])
def test_tiled_smem_does_not_grow_with_skv(Sq, D):
    """The key-tiled formulas take no Skv; they fit a block at every Sq <= 64."""
    for route in (CUDA_CORE, TENSOR_CORE):
        assert 0 < tiled_smem_bytes(Sq, D, route) <= SMEM_LIMIT
        assert 0 < tiled_bwd_smem_bytes(Sq, D, route) <= SMEM_LIMIT
    assert tiny_walk(Sq, 4096, D) == TILED and tiny_supported(Sq, 4096, D)


@pytest.mark.parametrize("wrapper", ["tiny_attention_fwd", "tiny_attention_bwd"])
def test_wrappers_refuse_shapes_no_walk_takes(wrapper, monkeypatch):
    """Past the resident shapes at Sq > 64 (or D > 128) neither walk fits:
    the wrapper raises before it loads a library or counts a launch."""
    monkeypatch.setattr(_build, "load", lambda name: pytest.fail("loaded a library"))
    B, H, D, Sq, Skv = 2, 2, 64, 80, 600
    q, g = (_Operand((B, Sq, H * D), BF16) for _ in range(2))
    k, v = (_Operand((B, Skv, H * D), BF16) for _ in range(2))
    fn = getattr(ta, wrapper)
    before = (fn.launches, dict(fn.launches_by_walk))
    with pytest.raises(ValueError, match="key-tiled walk"):
        if wrapper == "tiny_attention_fwd":
            fn(q, k, v, H, return_probs=True)
        else:
            fn(q, k, v, _Operand((B, Sq, H * Skv), F32), None, g, H,
               out=_Operand((B, Sq, H * D), BF16))
    assert (fn.launches, dict(fn.launches_by_walk)) == before


_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "x2vlm_tpu_torch", "csrc")


def _constexpr(source: str, name: str) -> str:
    import re
    m = re.search(rf"constexpr int {name} = ([^;]+);", source)
    assert m, f"constexpr {name} not found"
    return m.group(1)


def test_tiled_smem_constants_are_the_sources():
    """The Python mirror of the key-tiled tensor-core kernels' shared memory
    takes its constants from the sources: key tile, ring depths, warps,
    scratch and plane widths, the multiplier's staging chunks (the C
    formulas themselves are held equal to the Python ones on the card)."""
    fwd = open(os.path.join(_CSRC, "tiny_attention_fwd.cu")).read()
    bwd = open(os.path.join(_CSRC, "tiny_attention_bwd.cu")).read()
    common = open(os.path.join(_CSRC, "common.cuh")).read()
    tc_fwd = fwd[fwd.index("namespace tc {"):]
    tc_bwd = bwd[bwd.index("namespace tc {"):]
    assert int(_constexpr(tc_fwd, "kKeyTile")) == int(_constexpr(tc_bwd, "kKeyTile")) == \
        ta._TC_KEY_TILE == 64
    assert int(_constexpr(tc_fwd, "kStages")) == ta._TC_FWD_STAGES
    assert int(_constexpr(tc_bwd, "kBwdStages")) == ta._TC_BWD_STAGES
    assert int(_constexpr(tc_fwd, "kThreads")) == 32 * ta._TC_FWD_WARPS
    assert int(_constexpr(tc_fwd, "kScratchLW")) == ta._TC_SCRATCH_LW
    assert _constexpr(tc_bwd, "kWLD") == "kKeyTile + 8" and ta._TC_PLANE_LD == 72
    assert int(_constexpr(common, "kTinyTiledMaxSq")) == ta._TILED_MAX_SQ
    assert "static constexpr int kChunks = 64 / kPerChunk + 1;" in common
    assert [ta._key_rows_words(n) for n in (1, 2, 4)] == [20, 36, 68]


def _variants_tool():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "tools" / "tiny_variants.py"
    spec = importlib.util.spec_from_file_location("tiny_variants", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("variant", ["base", "fwd_stages_2", "bwd_stages_3", "no_dm",
                                     "no_p_stores", "no_fwd_pass1_loads", "no_loads",
                                     "serve_no_math", "no_dq"])
def test_every_variant_patch_applies_to_the_source(variant):
    """``tools/tiny_variants.py`` times text patches of the key-tiled
    kernels' sources; each patch text of this tree's variants must be found
    once, and only the base variant leaves the sources as they are."""
    tool = _variants_tool()
    assert variant in tool.VARIANTS
    srcs = tool.patched_sources(variant)
    assert set(srcs) == {"tiny_attention_fwd.cu", "tiny_attention_bwd.cu", "common.cuh"}
    same = all(text == open(os.path.join(_CSRC, f)).read() for f, text in srcs.items())
    assert same == (variant == "base")


def _faults_tool():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "tools" / "fusion384_faults.py"
    spec = importlib.util.spec_from_file_location("fusion384_faults", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("variant", ["base", "model_pad_unmasked", "wrapper_mask_dropped",
                                     "tc_mask_ignored", "tc_tile_dropped", "cc_tile_dropped"])
def test_every_planted_fault_applies_to_the_source(variant):
    """``tools/fusion384_faults.py`` plants faults in copies of the port to
    read phase 8's hold on them; each patch text must be found once, and
    only the base variant leaves the sources as they are."""
    tool = _faults_tool()
    assert variant in tool.VARIANTS
    texts = tool.patched_sources(variant)
    same = all(text == open(os.path.join(tool.ROOT, f)).read() for f, text in texts.items())
    assert same == (variant == "base")
