"""The flash attention backward's two routes, on the CPU: which kernel a dQ
or dK/dV launch takes (``flash_bwd_route``), each route's shared-memory need
against Hopper's per-block limit, the C signatures the wrappers set once per
library, and the wrappers' refusal to run the plain version for a CUDA
tensor when the kernel cannot be built. The kernels themselves run only on
the card (``chip_smoke.py`` holds the C route rule and the C formulas equal
to these)."""

import ctypes
import importlib.util
import os
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.test_torch_hygiene import _CudaStandIn  # noqa: E402
from x2vlm_tpu_torch.ops import _build  # noqa: E402
from x2vlm_tpu_torch.ops import flash_attention as fa  # noqa: E402
from x2vlm_tpu_torch.ops.flash_attention import (  # noqa: E402
    BWD_KERNELS, CUDA_CORE, TENSOR_CORE, bwd_smem_bytes, flash_bwd_route,
)

SMEM_LIMIT = 232448   # bytes one block may use on Hopper
BF16, F32 = torch.bfloat16, torch.float32
CSRC = Path(fa.__file__).resolve().parent.parent / "csrc"


@pytest.mark.parametrize("dtype,head_dim,route", [
    (BF16, 64, TENSOR_CORE),   # the main path: BEiT-2 base, 12 heads of 64
    (BF16, 128, CUDA_CORE),
    (BF16, 192, CUDA_CORE),
    (BF16, 256, CUDA_CORE),
    (F32, 64, CUDA_CORE),      # fp32 keeps fp32 arithmetic at every head dim
    (F32, 128, CUDA_CORE),
    (F32, 192, CUDA_CORE),
    (F32, 256, CUDA_CORE),
])
def test_flash_bwd_route(dtype, head_dim, route):
    assert flash_bwd_route(dtype, head_dim) == route


def test_route_codes_are_the_c_enum():
    assert _build.ROUTE_CODES == {CUDA_CORE: 0, TENSOR_CORE: 1}
    assert BWD_KERNELS == {"dq": 0, "dkv": 1, "dbias": 2}


@pytest.mark.parametrize("bias_kind", [0, 1, 2])     # none, fp32, bf16
@pytest.mark.parametrize("route", [CUDA_CORE, TENSOR_CORE])
@pytest.mark.parametrize("head_dim", fa._HEAD_DIMS)
@pytest.mark.parametrize("kernel", ["dq", "dkv", "dbias"])
def test_bwd_smem_fits_a_block(kernel, head_dim, route, bias_kind):
    assert 0 < bwd_smem_bytes(kernel, head_dim, route, bias_kind) <= SMEM_LIMIT


def test_bwd_smem_at_the_main_path_head_dim():
    """D = 64: the CUDA-core kernels' fp32 tiles (83,200 / 99,840 B) against
    the tensor-core kernels' six bf16 64 x 64 tiles (+ lse / delta) and two
    stages of the bias tile, so that three blocks share an SM."""
    assert bwd_smem_bytes("dq", 64) == 83200
    assert bwd_smem_bytes("dkv", 64) == 99840
    assert bwd_smem_bytes("dq", 64, TENSOR_CORE) == 49152
    assert bwd_smem_bytes("dkv", 64, TENSOR_CORE) == 49152 + 1024
    bf16_bias = _build.OPERAND_KINDS[BF16]
    assert bwd_smem_bytes("dq", 64, TENSOR_CORE, bf16_bias) == 49152 + 2 * 64 * 36 * 4
    for kernel in ("dq", "dkv"):
        assert 3 * (bwd_smem_bytes(kernel, 64, TENSOR_CORE, bf16_bias) + 1024) <= 233472
    # the CUDA-core kernels and dBias stage no bias, whatever the route
    assert bwd_smem_bytes("dq", 64, CUDA_CORE, bf16_bias) == bwd_smem_bytes("dq", 64)
    assert bwd_smem_bytes("dbias", 64, TENSOR_CORE, bf16_bias) == bwd_smem_bytes("dbias", 64)


_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int,
            "long long": ctypes.c_longlong, "float": ctypes.c_float,
            "const char*": ctypes.c_char_p}


def _c_signatures(source: str):
    """name -> ([ctypes types of the parameters], result type) of each
    ``extern "C"`` function of a kernel source."""
    sigs = {}
    for ret, name, params in re.findall(
            r'extern "C" (int|long long|const char\*) (\w+)\(([^)]*)\)', source):
        types = [_C_TYPES[re.sub(r"\s+\w+$", "", p.strip())] for p in params.split(",")]
        sigs[name] = (types, _C_TYPES[ret])
    return sigs


@pytest.mark.parametrize("name", sorted(fa._SIGNATURES))
def test_signatures_match_the_c_entry_points(name):
    lib = "flash_attention_fwd" if name == "x2_flash_attention_fwd" else "flash_attention_bwd"
    c_sigs = _c_signatures((CSRC / f"{lib}.cu").read_text())
    argtypes, restype = fa._SIGNATURES[name]
    assert c_sigs[name] == (argtypes, restype)


def _variants_tool():
    path = Path(__file__).resolve().parent.parent / "tools" / "flash_bwd_variants.py"
    spec = importlib.util.spec_from_file_location("flash_bwd_variants", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("variant", ["base", "exp2f", "min_blocks_2", "min_blocks_4",
                                     "bias_per_element", "mask_runtime", "no_elementwise"])
def test_every_variant_patch_applies_to_the_source(variant):
    """``tools/flash_bwd_variants.py`` times text patches of the backward's
    source; each patch text must still be found exactly once."""
    tool = _variants_tool()
    assert variant in tool.VARIANTS
    src = tool.patched_source(variant)
    assert (src == (CSRC / "flash_attention_bwd.cu").read_text()) == (variant == "base")


class _FakeLib:
    """A loaded library's C functions, as ctypes presents them."""

    def __init__(self):
        for name in fa._SIGNATURES:
            setattr(self, name, type("CFunc", (), {})())


def test_typed_lib_types_each_library_object_once():
    """Set once per library object, not on every launch; a second library
    is typed even if it reuses the address of one that was freed."""
    first = _FakeLib()
    assert fa.typed_lib(first) is first
    for name, (argtypes, restype) in fa._SIGNATURES.items():
        assert getattr(first, name).argtypes == argtypes
        assert getattr(first, name).restype == restype
    first.x2_flash_attention_bwd_dq.argtypes = None   # typed once: not set again
    fa.typed_lib(first)
    assert first.x2_flash_attention_bwd_dq.argtypes is None
    second = _FakeLib()
    fa.typed_lib(second)
    assert second.x2_flash_attention_bwd_dq.argtypes == \
        fa._SIGNATURES["x2_flash_attention_bwd_dq"][0]


class _Operand(_CudaStandIn):
    """A CUDA operand's metadata; the wrapper may ask for its contiguous form."""

    def contiguous(self):
        return self


def _counts():
    return (fa.flash_attention_fwd.launches, dict(fa.flash_attention_bwd.launches),
            dict(fa.flash_attention_bwd.launches_by_route))


@pytest.mark.parametrize("wrapper,dtype,head_dim", [
    ("flash_attention_bwd", BF16, 64),    # tensor-core route
    ("flash_attention_bwd", F32, 64),     # CUDA-core route
    ("flash_attention_bwd", BF16, 128),   # CUDA-core route
    ("flash_attention_fwd", BF16, 64),
])
def test_flash_wrappers_raise_for_cuda_without_the_library(wrapper, dtype, head_dim,
                                                           monkeypatch, tmp_path):
    """For a CUDA tensor the flash wrappers launch a kernel (of either
    route) or raise: with no nvcc to build the library they raise, and never
    run the plain version or count a launch."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("the CUDA toolkit is installed: nvcc would build the library")
    monkeypatch.setattr(_build, "_LIBS", {})

    def no_fallback(*a, **k):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(fa, "flash_attention_reference", no_fallback)
    monkeypatch.setattr(fa, "flash_attention_bwd_reference", no_fallback)
    B, H, S = 2, 2, 197
    q, k, v, out, dout = (_Operand((B, H, S, head_dim), dtype) for _ in range(5))
    before = _counts()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        if wrapper == "flash_attention_fwd":
            fa.flash_attention_fwd(q, k, v, scale=head_dim ** -0.5)
        else:
            fa.flash_attention_bwd(q, k, v, None, None, out, _Operand((B, H, S, 1), F32), dout,
                                   scale=head_dim ** -0.5)
    assert _counts() == before


@pytest.mark.parametrize("dtype,head_dim", [(BF16, 64), (F32, 64), (BF16, 128)])
def test_cpu_tensors_take_the_plain_version_and_count_no_launch(dtype, head_dim):
    rng = np.random.default_rng(0)
    B, H, Sq, Skv = 2, 2, 20, 23
    mk = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    q, dout = mk(B, H, Sq, head_dim).to(dtype), mk(B, H, Sq, head_dim).to(dtype)
    k, v = mk(B, H, Skv, head_dim).to(dtype), mk(B, H, Skv, head_dim).to(dtype)
    bias = mk(1, H, Sq, Skv).to(dtype)
    km = torch.from_numpy((rng.random((B, Skv)) > 0.3).astype(np.int32))
    before = _counts()
    out, lse = fa.flash_attention_fwd(q, k, v, bias, km, scale=0.125)
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, bias, km, scale=0.125)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    got = fa.flash_attention_bwd(q, k, v, bias, km, out, lse, dout, scale=0.125)
    ref = fa.flash_attention_bwd_reference(q, k, v, bias, km, out, lse, dout, scale=0.125)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert _counts() == before
