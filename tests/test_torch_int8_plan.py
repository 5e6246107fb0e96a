"""K7's plan, on the CPU: the GEMM's tile plan and shared memory fixed in
``csrc/int8_matmul.cu`` against their Python mirror (``GEMM_PLAN``,
``gemm_smem_bytes``) and Hopper's per-block limit, the patches of
``tools/int8_variants.py``, the int8 library typed once, and the arguments
the two wrappers pass to their C entry points (driven on meta tensors with a
stand-in library). The kernels themselves run only on the card
(``chip_smoke.py`` holds the C plan and shared memory equal to these)."""

import contextlib
import importlib.util
import re
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from x2vlm_tpu_torch.ops import _build  # noqa: E402
from x2vlm_tpu_torch.ops import int8_matmul as im  # noqa: E402

CSRC = Path(im.__file__).resolve().parent.parent / "csrc"
# csrc constant -> GEMM_PLAN key
_CONSTS = {"BM": "block_m", "BN": "block_n", "BK": "block_k", "kStages": "stages",
           "kEpiBytes": "epi_bytes"}


def _variants_tool():
    path = Path(__file__).resolve().parent.parent / "tools" / "int8_variants.py"
    spec = importlib.util.spec_from_file_location("int8_variants", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _plan_of(source: str) -> dict:
    """The GEMM plan a kernel source fixes, read from its constexprs."""
    plan = {}
    for name, key in _CONSTS.items():
        m = re.search(rf"constexpr int {name} = (\d+);", source)
        assert m, f"constexpr {name} not found"
        plan[key] = int(m.group(1))
    return plan


def test_python_plan_is_the_source_plan():
    assert _plan_of((CSRC / "int8_matmul.cu").read_text()) == im.GEMM_PLAN


def test_smem_formula_matches_the_source():
    """gemm_smem_bytes is kGemmSmem's formula: at the plan of the source,
    128 + 128 rows of 128 bytes a stage, 5 stages, for each of the 2
    consumers 128 staged rows of 144 bytes and 128 + 2 x 128 fp32 scales,
    12 mbarriers, 1024 bytes of alignment slack."""
    src = (CSRC / "int8_matmul.cu").read_text()
    assert ("constexpr int kGemmSmem = 1024 + kStages * kStageBytes + 2 * BM * kEpiLd +\n"
            "                          2 * kParamFloats * 4 + (2 * kStages + 2) * 8;") in src
    assert im.gemm_smem_bytes() == (1024 + 5 * 256 * 128 + 2 * 128 * 144 + 2 * 384 * 4
                                    + 12 * 8) == 204896


@pytest.mark.parametrize("variant", ["base", "stages_3", "stages_4", "epi_256_stages_4",
                                     "gelu_no_tanh", "tanhf", "tanh_approx"])
def test_every_variant_patch_applies_and_its_plan_fits(variant):
    """``tools/int8_variants.py`` times text patches of the kernel source:
    each patch text must still be found once, only the base variant leaves
    the source as it is, the plan the patched source fixes is the tool's
    ``PLANS`` entry, and that plan fits in one block's shared memory (the
    plan depends on no shape: every launch of every main-path and
    contract shape takes the same block)."""
    tool = _variants_tool()
    assert set(tool.VARIANTS) == set(tool.PLANS)
    srcs = tool.patched_sources(variant)
    assert set(srcs) == {"int8_matmul.cu", "common.cuh"}
    same = all(text == (CSRC / fname).read_text() for fname, text in srcs.items())
    assert same == (variant == "base")
    plan = tool.PLANS[variant]
    assert _plan_of(srcs["int8_matmul.cu"]) == plan
    assert im.gemm_smem_bytes(plan) <= im.SMEM_LIMIT
    assert plan["block_m"] == plan["block_n"] == plan["block_k"] == 128


def test_larger_plans_do_not_fit():
    """The limit the plans are held to binds: 128 x 128 tiles take at most
    5 stages with 128-byte staging, 4 with 256-byte."""
    plan = im.GEMM_PLAN
    assert im.gemm_smem_bytes(dict(plan, stages=5)) <= im.SMEM_LIMIT
    assert im.gemm_smem_bytes(dict(plan, stages=6)) > im.SMEM_LIMIT
    assert im.gemm_smem_bytes(dict(plan, stages=4, epi_bytes=256)) <= im.SMEM_LIMIT
    assert im.gemm_smem_bytes(dict(plan, stages=5, epi_bytes=256)) > im.SMEM_LIMIT


class _FakeFn:
    """A C entry of a stand-in library: records its arguments, returns 0."""

    def __init__(self, name, calls):
        self.name, self.calls = name, calls

    def __call__(self, *args):
        self.calls.append((self.name, args))
        return 0


def _fake_lib(monkeypatch):
    calls = []
    lib = type("Lib", (), {})()
    for name in im._SIGNATURES:
        setattr(lib, name, _FakeFn(name, calls))
    monkeypatch.setattr(_build, "load", lambda name: lib)
    monkeypatch.setattr(im, "_check_cuda", lambda *a: None)   # meta tensors stand in
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    return lib, calls


def test_typed_lib_types_the_int8_library_once(monkeypatch):
    lib, _ = _fake_lib(monkeypatch)
    assert im.typed_lib(lib) is lib
    for name, (argtypes, restype) in im._SIGNATURES.items():
        assert getattr(lib, name).argtypes == argtypes
        assert getattr(lib, name).restype == restype
    lib.x2_int8_matmul.argtypes = None   # typed once: not set again
    im.typed_lib(lib)
    assert lib.x2_int8_matmul.argtypes is None


@pytest.mark.parametrize("in_dtype,out_dtype,act,with_bias", [
    (torch.bfloat16, torch.bfloat16, None, True),        # q/k/v, proj, fc2
    (torch.bfloat16, torch.bfloat16, "gelu_fast", True),  # fc1
    (torch.float32, torch.float32, "gelu", False),
])
def test_wrappers_pass_the_c_arguments(in_dtype, out_dtype, act, with_bias, monkeypatch):
    """On meta tensors (shapes without data) with a stand-in library: the
    quantize entry gets (M, K, dtype code), the GEMM entry (M, N, K, act
    code, out dtype code), each launch is counted once under its shape, and
    the outputs have the contract's shapes and types."""
    _, calls = _fake_lib(monkeypatch)
    for fn in (im.quantize_act, im.int8_matmul):
        monkeypatch.setattr(fn, "launches", 0)
        monkeypatch.setattr(fn, "launches_by_shape", type(fn.launches_by_shape)())
    meta = dict(device="meta")
    x = torch.empty(4, 50, 768, dtype=in_dtype, **meta)
    wq = torch.empty(2304, 768, dtype=torch.int8, **meta)
    sw = torch.empty(2304, **meta)
    bias = torch.empty(2304, **meta) if with_bias else None
    out = im.int8_matmul(x, wq, sw, bias, act=act, out_dtype=out_dtype)
    assert out.shape == (4, 50, 2304) and out.dtype == out_dtype
    assert [name for name, _ in calls] == ["x2_int8_quantize", "x2_int8_matmul"]
    q_args, g_args = calls[0][1], calls[1][1]
    assert q_args[3:6] == (200, 768, _build.DTYPE_CODES[in_dtype])
    assert (g_args[4] is None) == (bias is None)
    assert g_args[6:11] == (200, 2304, 768, im.ACTS[act], _build.DTYPE_CODES[out_dtype])
    assert im.quantize_act.launches == 1 and im.int8_matmul.launches == 1
    assert im.quantize_act.launches_by_shape == {(200, 768): 1}
    assert im.int8_matmul.launches_by_shape == {(200, 768, 2304): 1}
