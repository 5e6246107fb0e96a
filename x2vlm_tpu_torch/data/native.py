"""The native data plane: the port's ctypes binding of its own C++ decode and
augment library (``x2vlm_tpu_torch/csrc_host/dataplane.cpp``), the
counterpart of the JAX package's ``data/native.py``.

- ``NativeDecoder``: a batch of base64 strings or raw bytes -> (N, res,
  res, 3) float32, bicubic resize and CLIP normalisation (the eval decode
  of ``RetrievalEvalDataset(use_native_decode=True)``).
- ``NativeTrainTransform``: the pretraining transform in one C++ pass,
  decode -> RandomResizedCrop(0.2-1.0, bicubic) -> hflip(0.5) ->
  RandomAugment(2, 7) -> uint8 (res, res, 3).
- ``NativeBoxTransform``: the region stream's pixel path, a ROI decode of
  the crop the stream chose -> bicubic resample -> hflip -> the box
  augmentations -> uint8. The bbox-aware crop stays in Python: it needs the
  line's boxes.

Both train transforms set ``wants_bytes``: the streams of
``data/pretrain.py`` then hand them the encoded bytes and never decode
with PIL. The pixel ops follow Pillow's arithmetic (``pil_parity_failures``
holds each against PIL by the per-op rules), but the random parameters do
not come from the PIL path's draws: ``NativeTrainTransform`` draws one
64-bit seed a image from its ``rng`` and the library expands it into that
image's crop, flip and augmentation parameters by a splitmix64 stream, as
in the JAX package. So the native path is not bit-equal to PIL; it is
bit-equal to the JAX package's native path given the same seeds.

The library is compiled by ``g++`` at first use (never at import) into
``build/x2vlm_tpu_torch/`` at the repository root, named by a hash of its
source, the flags and the host CPU (the flags take ``-march=native``), and
written to a temporary file that is renamed into place, so processes that
race the build each end with the same whole library. Without ``g++`` or
the libjpeg / libpng headers it cannot build: ``load_dataplane`` then
returns ``None``, ``unavailable_reason`` says why, and the classes raise.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import random
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from x2vlm_tpu_torch.data.transforms import (
    _AUG_RANGES, BOX_AUGS, CLIP_MEAN, CLIP_STD, DEFAULT_AUGS,
)

__all__ = ["AUG_OP_IDS", "NativeBoxTransform", "NativeDecoder", "NativeTrainTransform",
           "build", "lib_path", "load_dataplane", "native_available", "pil_parity_failures",
           "unavailable_reason"]

SOURCE = Path(__file__).resolve().parents[1] / "csrc_host" / "dataplane.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "x2vlm_tpu_torch"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-shared")
LINK = ("-ljpeg", "-lpng", "-lpthread")
# op ids of the library's apply_aug_op, in transforms.DEFAULT_AUGS order
AUG_OP_IDS = {"Identity": 0, "AutoContrast": 1, "Equalize": 2, "Brightness": 3,
              "Sharpness": 4, "ShearX": 5, "ShearY": 6, "TranslateX": 7, "TranslateY": 8,
              "Rotate": 9}

_STATE = {"lib": None, "error": None}
_LOCK = threading.Lock()

_I64P, _F32P, _U8P, _I32P = (ctypes.POINTER(t) for t in (
    ctypes.c_int64, ctypes.c_float, ctypes.c_uint8, ctypes.c_int32))
_SIGNATURES = {
    "dp_decode_batch_b64": ([ctypes.c_char_p, _I64P, ctypes.c_int, ctypes.c_int, _F32P, _F32P,
                             _F32P, _U8P, ctypes.c_int, ctypes.c_int], ctypes.c_int),
    "dp_b64_decode": ([ctypes.c_char_p, ctypes.c_int64, _U8P], ctypes.c_int64),
    "dp_pretrain_batch_raw": ([ctypes.c_char_p, _I64P, ctypes.c_int, ctypes.c_int,
                               ctypes.POINTER(ctypes.c_uint64), ctypes.c_float, ctypes.c_float,
                               ctypes.c_float, _I32P, ctypes.c_int, ctypes.c_int,
                               ctypes.c_float, _U8P, _U8P, ctypes.c_int], ctypes.c_int),
    "dp_crop_resize_u8": ([_U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _U8P],
                          ctypes.c_int),
    "dp_aug_apply": ([_U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, _U8P],
                     ctypes.c_int),
    "dp_sample_params": ([ctypes.c_uint64, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                          ctypes.c_float, ctypes.c_float, _I32P, ctypes.c_int, ctypes.c_int,
                          ctypes.c_float, _I32P, _I32P, _F32P], ctypes.c_int),
    "dp_region_batch_raw": ([ctypes.c_char_p, _I64P, ctypes.c_int, ctypes.c_int, _I32P, _U8P,
                             _I32P, _F32P, ctypes.c_int, _U8P, _U8P, ctypes.c_int],
                            ctypes.c_int),
    "dp_image_dims": ([ctypes.c_char_p, ctypes.c_int64, _I32P], ctypes.c_int),
}
_SIGNATURES["dp_decode_batch_raw"] = _SIGNATURES["dp_decode_batch_b64"]
_SIGNATURES["dp_pretrain_batch_b64"] = _SIGNATURES["dp_pretrain_batch_raw"]


def _host_cpu() -> bytes:
    """The host CPU's model and feature flags (``-march=native`` builds for
    them, so a library built on one host is not reused on another)."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().split(b"\n\n")[0].splitlines()
    except OSError:
        return b""
    return b"\n".join(ln for ln in lines if ln.startswith((b"model name", b"flags")))


def lib_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS + LINK).encode())
    h.update(_host_cpu())
    return BUILD_DIR / f"dataplane-{h.hexdigest()[:16]}.so"


def build() -> float:
    """Compile the library if it is not built yet; the seconds it took (0.0
    when it was there). Raises ``RuntimeError`` with the compiler's output
    if ``g++`` is missing or fails."""
    out = lib_path()
    if out.is_file():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp), *LINK]
    t0 = time.perf_counter()
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"g++ could not run: {e}") from e
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ exited {res.returncode}: {res.stderr.strip()[-2000:]}")
    os.replace(tmp, out)
    return time.perf_counter() - t0


def load_dataplane() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if needed; ``None`` when it cannot
    be built or loaded (``unavailable_reason`` then says why). Tried once a
    process."""
    with _LOCK:
        if _STATE["lib"] is None and _STATE["error"] is None:
            try:
                build()
                lib = ctypes.CDLL(str(lib_path()))
                for name, (argtypes, restype) in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes, fn.restype = argtypes, restype
                _STATE["lib"] = lib
            except (RuntimeError, OSError, AttributeError) as e:
                _STATE["error"] = str(e)
        return _STATE["lib"]


def native_available() -> bool:
    return load_dataplane() is not None


def unavailable_reason() -> Optional[str]:
    """Why the library did not build or load, or ``None`` if it did."""
    load_dataplane()
    return _STATE["error"]


def _require() -> ctypes.CDLL:
    lib = load_dataplane()
    if lib is None:
        raise RuntimeError(f"native dataplane unavailable ({_STATE['error']})")
    return lib


def _blob(items: Sequence[bytes]):
    offsets = np.zeros(len(items) + 1, np.int64)
    np.cumsum([len(e) for e in items], out=offsets[1:])
    return b"".join(items), offsets


def _p(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


class NativeDecoder:
    """Batch decoder: base64 strings (or raw bytes) -> (N, res, res, 3)
    float32 normalised NHWC and a per-item ok mask."""

    FILTERS = {"bilinear": 0, "bicubic": 1}

    def __init__(self, image_res: int, num_threads: int = 8, mean=CLIP_MEAN, std=CLIP_STD,
                 filter: str = "bicubic"):
        self.lib = _require()
        self.res = image_res
        self.filter = self.FILTERS[filter]
        self.num_threads = num_threads
        self.mean = np.ascontiguousarray(mean, np.float32)
        self.std = np.ascontiguousarray(std, np.float32)

    def _call(self, fn, items: Sequence[bytes]):
        blob, offsets = _blob(items)
        n = len(items)
        out = np.empty((n, self.res, self.res, 3), np.float32)
        status = np.empty(n, np.uint8)
        fn(blob, _p(offsets, ctypes.c_int64), n, self.res, _p(self.mean, ctypes.c_float),
           _p(self.std, ctypes.c_float), _p(out, ctypes.c_float), _p(status, ctypes.c_uint8),
           self.num_threads, self.filter)
        return out, status.astype(bool)

    def decode_b64(self, items: Sequence[str]):
        return self._call(self.lib.dp_decode_batch_b64,
                          [s.encode() if isinstance(s, str) else s for s in items])

    def decode_raw(self, items: Sequence[bytes]):
        return self._call(self.lib.dp_decode_batch_raw, items)


class NativeTrainTransform:
    """The pretraining image transform in one C++ pass: decode ->
    RandomResizedCrop(scale, bicubic) -> hflip(``hflip_prob``) ->
    RandomAugment(n, m) -> uint8 (res, res, 3); one seed a image from
    ``rng``, expanded by the library (module docstring)."""

    wants_bytes = True

    def __init__(self, image_res: int, scale=(0.2, 1.0), n: int = 2, m: int = 7,
                 hflip_prob: float = 0.5, augs: Optional[Sequence[str]] = None, rng=None,
                 num_threads: int = 1):
        self.lib = _require()
        self.res = image_res
        self.scale = scale
        self.n = n
        self.m = m
        self.hflip_prob = hflip_prob
        self.rng = rng or random.Random()
        self.num_threads = num_threads
        self.cand = np.asarray([AUG_OP_IDS[a] for a in (augs or DEFAULT_AUGS)], np.int32)

    def transform_batch(self, items: Sequence[bytes], b64: bool = False):
        """Raw (or base64) encoded images -> ((N, res, res, 3) uint8, ok)."""
        n = len(items)
        blob, offsets = _blob(items)
        seeds = np.asarray([self.rng.getrandbits(64) for _ in range(n)], np.uint64)
        out = np.empty((n, self.res, self.res, 3), np.uint8)
        status = np.empty(n, np.uint8)
        fn = self.lib.dp_pretrain_batch_b64 if b64 else self.lib.dp_pretrain_batch_raw
        fn(blob, _p(offsets, ctypes.c_int64), n, self.res, _p(seeds, ctypes.c_uint64),
           float(self.scale[0]), float(self.scale[1]), float(self.hflip_prob),
           _p(self.cand, ctypes.c_int32), len(self.cand), self.n, float(self.m),
           _p(out, ctypes.c_uint8), _p(status, ctypes.c_uint8), self.num_threads)
        return out, status.astype(bool)

    def __call__(self, raw: bytes) -> np.ndarray:
        out, ok = self.transform_batch([raw])
        if not ok[0]:
            raise ValueError("broken image (native decode failed)")
        return out[0]


class NativeBoxTransform:
    """The region stream's pixel path in C++ (module docstring). The
    augmentation ops are drawn from this object's own ``rng``, as the PIL
    path's ``transforms.box_transform`` draws from its own."""

    wants_bytes = True

    def __init__(self, image_res: int, n: int = 2, m: int = 7,
                 augs: Optional[Sequence[str]] = None, rng=None, num_threads: int = 1):
        self.lib = _require()
        self.res = image_res
        self.n = n
        self.m = m
        self.augs = list(augs or BOX_AUGS)
        self.rng = rng or random.Random()
        self.num_threads = num_threads

    def image_dims(self, raw: bytes):
        wh = np.empty(2, np.int32)
        if not self.lib.dp_image_dims(raw, len(raw), _p(wh, ctypes.c_int32)):
            raise ValueError("broken image (header parse failed)")
        return int(wh[0]), int(wh[1])

    def region_batch(self, items: Sequence[bytes], boxes, flips):
        """Raw images, full-resolution crop boxes (x0, y0, cw, ch) and flip
        flags -> ((N, res, res, 3) uint8, ok)."""
        n = len(items)
        blob, offsets = _blob(items)
        boxes = np.ascontiguousarray(boxes, np.int32).reshape(n, 4)
        flips = np.ascontiguousarray(flips, np.uint8).reshape(n)
        ops = np.empty((n, self.n), np.int32)
        vals = np.empty((n, self.n), np.float32)
        for i in range(n):
            for a in range(self.n):
                name = self.rng.choice(self.augs)
                lo, hi = _AUG_RANGES[name]
                ops[i, a] = AUG_OP_IDS[name]
                vals[i, a] = lo + (hi - lo) * self.m / 10.0
        out = np.empty((n, self.res, self.res, 3), np.uint8)
        status = np.empty(n, np.uint8)
        self.lib.dp_region_batch_raw(
            blob, _p(offsets, ctypes.c_int64), n, self.res, _p(boxes, ctypes.c_int32),
            _p(flips, ctypes.c_uint8), _p(ops, ctypes.c_int32), _p(vals, ctypes.c_float),
            self.n, _p(out, ctypes.c_uint8), _p(status, ctypes.c_uint8), self.num_threads)
        return out, status.astype(bool)


def _aug_apply(lib, arr: np.ndarray, op: int, v: float) -> np.ndarray:
    out = np.empty_like(arr)
    lib.dp_aug_apply(_p(arr, ctypes.c_uint8), arr.shape[0], arr.shape[1], op, v,
                     _p(out, ctypes.c_uint8))
    return out


def _crop_resize(lib, arr: np.ndarray, box, res: int) -> np.ndarray:
    out = np.empty((res, res, 3), np.uint8)
    x0, y0, cw, ch = box
    lib.dp_crop_resize_u8(_p(arr, ctypes.c_uint8), arr.shape[1], arr.shape[0], x0, y0, cw, ch,
                          res, 1, _p(out, ctypes.c_uint8))
    return out


def pil_parity_failures(seed: int = 0) -> list:
    """Each pixel op of the library against Pillow on the same image and
    parameters, by the per-op rules: the LUT ops (AutoContrast, Equalize)
    and Identity exact; the nearest-neighbour affine ops (shears,
    translations, rotations) on under 2% of the pixels off (a coordinate
    that float rounding moves across a pixel boundary); Brightness within
    1 of 255; Sharpness within 2, and over 1 on under 1% of the pixels;
    the bicubic crop-resize, down and up, a median difference of at most
    1 and over 2 on under 2% of the pixels. Returns the rules broken, as
    strings (empty when every op holds)."""
    from PIL import Image, ImageEnhance, ImageOps

    from x2vlm_tpu_torch.data.transforms import _aug

    lib = _require()
    rng = np.random.default_rng(seed)
    img = lambda h=48, w=56: np.ascontiguousarray(rng.integers(0, 256, (h, w, 3), np.uint8))
    bad = []

    def diff(out, ref):
        return np.abs(out.astype(np.int16) - np.asarray(ref, np.int16))

    for name, fn in (("AutoContrast", ImageOps.autocontrast), ("Equalize", ImageOps.equalize)):
        for arr in (img(), (rng.integers(100, 121, (32, 32, 3))).astype(np.uint8)):
            d = diff(_aug_apply(lib, arr, AUG_OP_IDS[name], 0.0), fn(Image.fromarray(arr)))
            if d.max() != 0:
                bad.append(f"{name}: max difference {d.max()} (exact)")
    arr = img()
    if not np.array_equal(_aug_apply(lib, arr, AUG_OP_IDS["Identity"], 0.0), arr):
        bad.append("Identity: not the input")
    for v in (0.1, 1.0, 1.36, 1.9):
        d = diff(_aug_apply(lib, arr, AUG_OP_IDS["Brightness"], v),
                 ImageEnhance.Brightness(Image.fromarray(arr)).enhance(v))
        if d.max() > 1:
            bad.append(f"Brightness {v}: max difference {d.max()} (<= 1)")
    for v in (0.1, 1.36, 1.9):
        d = diff(_aug_apply(lib, arr, AUG_OP_IDS["Sharpness"], v),
                 ImageEnhance.Sharpness(Image.fromarray(arr)).enhance(v))
        if d.max() > 2 or (d > 1).mean() >= 0.01:
            bad.append(f"Sharpness {v}: max {d.max()}, share over 1 {(d > 1).mean():.4f}")
    for name, v in (("ShearX", 0.18), ("ShearX", -0.3), ("ShearY", 0.18), ("ShearY", -0.3),
                    ("TranslateX", 0.18), ("TranslateY", -0.18), ("Rotate", 12.0),
                    ("Rotate", -30.0)):
        d = diff(_aug_apply(lib, arr, AUG_OP_IDS[name], v), _aug(name, Image.fromarray(arr), v))
        share = (d != 0).any(-1).mean()
        if share >= 0.02:
            bad.append(f"{name} {v}: {share:.4f} of the pixels off (< 0.02)")
    arr = img(75, 90)
    for box, res in (((10, 5, 60, 64), 48), ((0, 0, 90, 75), 32), ((3, 2, 17, 21), 48)):
        x0, y0, cw, ch = box
        ref = Image.fromarray(arr).crop((x0, y0, x0 + cw, y0 + ch)).resize(
            (res, res), Image.BICUBIC)
        d = diff(_crop_resize(lib, arr, box, res), ref)
        if np.median(d) > 1 or (d > 2).mean() >= 0.02:
            bad.append(f"crop-resize {box} -> {res}: median {np.median(d)}, share over 2 "
                       f"{(d > 2).mean():.4f}")
    return bad
