"""Boundaries of the PyTorch port: it imports nothing of JAX or of the JAX
package, its entry points refuse to fall back to the CPU quietly, and its
kernel sources and build rules are in place."""

import ast
import importlib
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
from tests.torch_threads import few_torch_threads  # noqa: E402,F401 (autouse)

torch = pytest.importorskip("torch")

from x2vlm_tpu_torch.convert import convert_jax_params  # noqa: E402
from x2vlm_tpu_torch.models import (  # noqa: E402
    BEiT2, BEiT2Config, BertConfig, BertEncoder, XVLMConfig, XVLMForPretrain,
    XVLMForRetrieval,
)
from x2vlm_tpu_torch.ops import _build, layers  # noqa: E402
from x2vlm_tpu_torch.serving import RetrievalServer  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "x2vlm_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "chex", "x2vlm_tpu")
TINY = XVLMConfig(
    vision=BEiT2Config(image_res=32, patch_size=16, embed_dim=32, depth=1, num_heads=2),
    text=BertConfig(vocab_size=50, hidden_size=32, num_layers=2, fusion_layer=1,
                    num_heads=2, intermediate_size=64, encoder_width=32,
                    max_position_embeddings=16),
    embed_dim=8)


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_nothing_of_jax(path):
    bad = [m for m in _imported_roots(path)
           if m.split(".")[0] in FORBIDDEN]
    assert bad == [], f"{path} imports {bad}"


NATIVE_DIR_REF = re.compile(r"libdataplane|(^|[^\w/.])native/|/native[\"']")
HOST_SOURCES = sorted((ROOT / "x2vlm_tpu_torch" / "csrc_host").glob("*"))


@pytest.mark.parametrize("path", PORT_FILES + HOST_SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_names_not_the_jax_native_library(path):
    """No port file reads or names the JAX package's ``native/`` directory
    or its ``libdataplane.so``: the port builds its own copy of the data
    plane (``x2vlm_tpu_torch/csrc_host``) into ``build/``."""
    bad = [ln.strip() for ln in path.read_text().splitlines() if NATIVE_DIR_REF.search(ln)]
    assert bad == [], f"{path} names the JAX package's native library: {bad}"


def test_the_native_rule_catches_the_jax_library():
    for line in ('lib = "native/libdataplane.so"', 'os.path.join(ROOT, "x/native")',
                 "src = native/dataplane.cpp"):
        assert NATIVE_DIR_REF.search(line), line
    for line in ("from x2vlm_tpu_torch.data import native", "data/native.py",
                 'data_plane[name] = "native"'):
        assert not NATIVE_DIR_REF.search(line), line


def _module_level_roots(path):
    """The roots a file imports when it is imported: top-level statements
    (through if / try / with blocks), not function or class bodies."""
    def walk(stmts):
        for node in stmts:
            if isinstance(node, ast.Import):
                yield from (a.name for a in node.names)
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                yield node.module
            elif isinstance(node, (ast.If, ast.Try, ast.With)):
                for field in ("body", "orelse", "finalbody", "handlers"):
                    for sub in getattr(node, field, []) or []:
                        yield from walk(getattr(sub, "body", [sub]))
    yield from walk(ast.parse(path.read_text(), str(path)).body)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_needs_no_transformers_pil_or_yaml_to_import(path):
    """No port file imports ``transformers``, ``tokenizers`` or
    ``sentencepiece`` anywhere (the WordPiece and XLM-R tokenizers are the
    port's own; the card has none of the three), and none imports PIL or
    yaml when it is imported (only inside the functions that decode images
    or read YAML)."""
    anywhere = [m for m in _imported_roots(path)
                if m.split(".")[0] in ("transformers", "tokenizers", "sentencepiece")]
    assert anywhere == [], f"{path} imports {anywhere}"
    top = [m for m in _module_level_roots(path) if m.split(".")[0] in ("PIL", "yaml")]
    assert top == [], f"{path} imports {top} at module level"


def test_port_imports_with_transformers_pil_and_yaml_blocked():
    """Import every port module (and chip_smoke) in a fresh interpreter in
    which importing transformers, tokenizers, sentencepiece, PIL or yaml
    fails."""
    modules = [".".join(p.relative_to(ROOT).with_suffix("").parts) for p in PORT_FILES]
    modules = [m[:-len(".__init__")] if m.endswith(".__init__") else m for m in modules]
    code = ("import sys\n"
            "for name in ('transformers', 'tokenizers', 'sentencepiece', 'PIL', 'yaml'):\n"
            "    sys.modules[name] = None\n"
            f"for m in {modules!r}:\n"
            "    __import__(m)\n"
            "print('imported', len(" + repr(modules) + "))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "imported" in res.stdout


def test_port_imports_with_jax_blocked():
    """Import every port module (and chip_smoke) in a fresh interpreter in
    which importing jax, flax or the JAX package fails."""
    modules = [".".join(p.relative_to(ROOT).with_suffix("").parts)
               for p in PORT_FILES]
    modules = [m[:-len(".__init__")] if m.endswith(".__init__") else m for m in modules]
    code = ("import sys\n"
            f"for name in {list(FORBIDDEN)!r}:\n"
            "    sys.modules[name] = None\n"
            f"for m in {modules!r}:\n"
            "    __import__(m)\n"
            "print('imported', len(" + repr(modules) + "))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "imported" in res.stdout


@pytest.mark.parametrize("entry", [
    "XVLMForRetrieval", "XVLMForPretrain", "BEiT2", "BertEncoder", "PatchEmbed",
    "MultiHeadAttention", "convert_jax_params", "RetrievalServer.from_npz",
])
def test_entry_points_default_to_the_card(entry, tmp_path):
    """Without a GPU an entry point raises unless device='cpu' is given; the
    device is resolved before anything is read or allocated."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is valid here")
    npz = tmp_path / "params.npz"
    calls = {
        "XVLMForRetrieval": lambda **kw: XVLMForRetrieval(TINY, **kw),
        "XVLMForPretrain": lambda **kw: XVLMForPretrain(TINY, **kw),
        "BEiT2": lambda **kw: BEiT2(TINY.vision, **kw),
        "BertEncoder": lambda **kw: BertEncoder(TINY.text, **kw),
        "PatchEmbed": lambda **kw: layers.PatchEmbed(8, 4, **kw),
        "MultiHeadAttention": lambda **kw: layers.MultiHeadAttention(8, 2, **kw),
        "convert_jax_params": lambda **kw: convert_jax_params({}, **kw),
        "RetrievalServer.from_npz": lambda **kw: RetrievalServer.from_npz(npz, TINY, **kw),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()
    if entry == "convert_jax_params":
        with pytest.raises(KeyError):  # past the device check: empty params
            calls[entry](device="cpu")
    elif entry == "RetrievalServer.from_npz":
        with pytest.raises(FileNotFoundError):
            calls[entry](device="cpu")
    else:
        calls[entry](device="cpu")


def test_kernel_sources_and_build_rules():
    for name in _build.KERNELS:
        src = _build.CSRC / f"{name}.cu"
        text = src.read_text()
        assert f"x2_{name}" in text and "cudaGetLastError" in text
        assert "Replaces: x2vlm_tpu/ops/" in text
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    # the int8 kernel's IEEE division and unfused dequantize are bit-exact
    # against the plain version only without fast math
    assert not any("fast_math" in f or "fmad" in f for f in _build.NVCC_FLAGS)
    # the library name follows the source: an edit forces a rebuild
    assert _build._lib_path("flash_attention_fwd") != _build._lib_path("tiny_attention_fwd")
    assert _build.BUILD_DIR.relative_to(ROOT).parts[0] == "build"
    assert "/build/" in (ROOT / ".gitignore").read_text().split()


def _fake_nvcc(tmp_path, seconds):
    """A stand-in compiler: notes its start in ``calls.log``, sleeps, writes
    its ``-o`` file (an empty library is enough for the build's
    bookkeeping) and one log line, and notes its end."""
    nvcc = tmp_path / "nvcc"
    calls = tmp_path / "calls.log"
    nvcc.write_text("#!/bin/sh\n"
                    f"echo start >> {calls}\nsleep {seconds}\n"
                    'while [ "$1" != "-o" ]; do shift; done\n'
                    'echo built > "$2"\necho "ptxas info : Used 1 registers"\n'
                    f"echo end >> {calls}\n")
    nvcc.chmod(0o755)
    return str(nvcc)


def test_build_starts_every_compile_together_and_puts_each_in_place(monkeypatch, tmp_path):
    """``build`` starts one compiler a kernel, all before waiting for any,
    and renames each library into place from its temporary file."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc_path", lambda: _fake_nvcc(tmp_path, 1))
    started = []
    popen = subprocess.Popen

    def counting_popen(cmd, *a, **kw):
        started.append(Path(cmd[-1]).stem)
        return popen(cmd, *a, **kw)

    monkeypatch.setattr(_build.subprocess, "Popen", counting_popen)
    names = ("flash_attention_fwd", "tiny_attention_fwd", "int8_matmul")
    secs = _build.build(names)
    assert started == list(names)
    # every compile ran before the first ended
    assert (tmp_path / "calls.log").read_text().split() == ["start"] * 3 + ["end"] * 3
    assert set(secs) == set(names) and all(s > 0.5 for s in secs.values())
    assert all(_build._lib_path(n).is_file() for n in names)
    assert not list((tmp_path / "build").glob("*.tmp"))
    assert "Used 1 registers" in _build.ptxas_report("flash_attention_fwd")
    assert _build.build(names) == dict.fromkeys(names, 0.0)   # built once per source


def test_build_looks_up_the_compiler_once_a_call_and_not_when_built(monkeypatch, tmp_path):
    """One lookup of ``nvcc`` serves every compile of a ``build`` call; a
    call that finds every library built never looks (a host without the
    toolkit runs the libraries it has)."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    lookups = []

    def counting_nvcc_path():
        lookups.append(1)
        return _fake_nvcc(tmp_path, 0)

    monkeypatch.setattr(_build, "nvcc_path", counting_nvcc_path)
    names = ("flash_attention_fwd", "tiny_attention_fwd", "int8_matmul")
    _build.build(names)
    assert len(lookups) == 1
    _build.build(names)
    assert len(lookups) == 1

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    assert _build.build(names) == dict.fromkeys(names, 0.0)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this machine has the CUDA toolkit")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


@pytest.mark.parametrize("kernel", ["flash", "tiny"])
def test_gradients_flow_through_the_autograd_wrappers_on_cpu(kernel):
    """On CPU tensors the autograd Functions run the plain forward and
    backward versions; their gradients equal autograd through the plain
    forward version. The case runs in float64, which the plain versions
    keep end to end, so the comparison does not hang on the order of fp32
    sums (a thread count or an instruction set can change it)."""
    gen = torch.Generator().manual_seed(0)
    if kernel == "flash":
        from x2vlm_tpu_torch.ops.flash_attention import (
            flash_attention, flash_attention_reference,
        )
        shapes = [(2, 2, 130, 64)] * 3 + [(1, 2, 130, 130)]
        fused = lambda q, k, v, b: flash_attention(q, k, v, bias=b, scale=0.125)
        plain = lambda q, k, v, b: flash_attention_reference(q, k, v, b, scale=0.125)[0]
    else:
        from x2vlm_tpu_torch.ops.tiny_attention import (
            tiny_attention_reference, tiny_block_attention,
        )
        shapes = [(2, 10, 64), (2, 30, 64), (2, 30, 64)]
        fused = lambda q, k, v: tiny_block_attention(q, k, v, num_heads=4)
        plain = lambda q, k, v: tiny_attention_reference(q, k, v, 4, scale=0.25)[0]
    inputs = [torch.randn(s, generator=gen, dtype=torch.float64) for s in shapes]
    g = torch.randn(shapes[0], generator=gen, dtype=torch.float64)
    grads = []
    for fn in (fused, plain):
        leaves = [t.clone().requires_grad_() for t in inputs]
        fn(*leaves).backward(g)
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    # no grad wanted: the forward alone runs and nothing is saved
    with torch.no_grad():
        assert fused(*inputs).grad_fn is None


@pytest.mark.parametrize("name", _build.KERNELS)
def test_every_kernel_has_a_plain_version(name):
    """Each kernel library's module holds, beside every wrapper that counts
    launches, the plain ``*_reference`` the wrapper runs for CPU tensors."""
    module = importlib.import_module(
        f"x2vlm_tpu_torch.ops.{re.sub(r'_(fwd|bwd)$', '', name)}")
    assert f'_build.load("{name}")' in Path(module.__file__).read_text()
    wrappers = [f for f in vars(module).values()
                if callable(f) and hasattr(f, "launches")
                and getattr(f, "__module__", None) == module.__name__]
    assert wrappers, f"no launch-counting wrapper in {module.__name__}"
    for w in wrappers:
        ref = re.sub(r"_fwd$", "", w.__name__) + "_reference"
        assert callable(getattr(module, ref, None)), f"{w.__name__}: no {ref}"


class _CudaStandIn:
    """The metadata of a CUDA tensor, for a machine without a card: what the
    int8 wrappers read before they load their kernel library."""

    def __init__(self, shape, dtype):
        self.shape, self.dtype = torch.Size(shape), dtype
        self.device = torch.device("cuda", 0)

    def dim(self):
        return len(self.shape)

    def numel(self):
        return math.prod(self.shape)


@pytest.mark.parametrize("wrapper", ["quantize_act", "int8_matmul"])
def test_int8_wrappers_raise_for_cuda_without_the_library(wrapper, monkeypatch, tmp_path):
    """For a CUDA tensor the int8 wrappers launch the kernel or raise: with
    no nvcc to build the library they raise, and never run the plain
    version."""
    from x2vlm_tpu_torch.ops import int8_matmul as im
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("the CUDA toolkit is installed: nvcc would build the library")
    monkeypatch.setattr(_build, "_LIBS", {})

    def no_fallback(*a, **k):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(im, "quantize_act_reference", no_fallback)
    monkeypatch.setattr(im, "int8_matmul_reference", no_fallback)
    x = _CudaStandIn((4, 8, 32), torch.bfloat16)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        if wrapper == "quantize_act":
            im.quantize_act(x)
        else:
            im.int8_matmul(x, _CudaStandIn((16, 32), torch.int8),
                           _CudaStandIn((16,), torch.float32),
                           xq=_CudaStandIn((4, 8, 32), torch.int8),
                           sx=_CudaStandIn((4, 8, 1), torch.float32))
