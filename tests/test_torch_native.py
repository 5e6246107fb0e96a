"""The port's native data plane (``x2vlm_tpu_torch/data/native.py`` over its
own ``csrc_host/dataplane.cpp``) against the JAX package's
(``x2vlm_tpu.data.native``) on the CPU, bit for bit:

- the library: ``decode_raw`` / ``decode_b64`` (float32, normalised),
  ``transform_batch`` with the same seeds (raw and base64, a broken item
  among them), ``region_batch`` with the same boxes, flips and rng state;
- the port's streams on the native path against the JAX streams on theirs:
  the image stream (pixels, captions, masking and the broken count), the
  region stream (pixels and every row's metadata) and the video stream
  (a video's frames in one call);
- ``RetrievalEvalDataset(use_native_decode=True)``'s image batches (one
  decode call a batch) against the JAX dataset's, and its PIL fallback for
  a batch with a broken image;
- the racing build: two processes building into one directory both load
  the same whole library;
- each pixel op against PIL by the per-op rules (``pil_parity_failures``,
  the rules of ``tests/test_native_train_path.py``).

The JAX image stream transforms a chunk of images a call and the port one
image a call; both draw one seed a image from the transform's rng, so with
the stream's own rng apart (as here) the samples are equal. Every test
skips where the library cannot build (no ``g++`` or no libjpeg / libpng
headers): its absence is the launcher's ``native_aug: auto`` fallback."""

import base64
import io
import json
import os
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

pytest.importorskip("torch")

from x2vlm_tpu.data import native as jax_native  # noqa: E402
from x2vlm_tpu.data import transforms as JT  # noqa: E402
from x2vlm_tpu.data.pretrain import (  # noqa: E402
    ImageTextStream as JaxImageTextStream, RegionTextStream as JaxRegionTextStream,
    VideoTextStream as JaxVideoTextStream,
)
from x2vlm_tpu.data.retrieval import RetrievalEvalDataset as JaxRetrievalEvalDataset  # noqa: E402
from x2vlm_tpu.data.streaming import DistLineReader as JaxDistLineReader  # noqa: E402
from x2vlm_tpu.data.tokenization import (  # noqa: E402
    TextPreprocessor as JaxTextPreprocessor, build_tokenizer as jax_build_tokenizer,
)
from x2vlm_tpu_torch.data import native, transforms as T  # noqa: E402
from x2vlm_tpu_torch.data.pretrain import (  # noqa: E402
    ImageTextStream, RegionTextStream, VideoTextStream,
)
from x2vlm_tpu_torch.data.retrieval import RetrievalEvalDataset  # noqa: E402
from x2vlm_tpu_torch.data.streaming import DistLineReader  # noqa: E402
from x2vlm_tpu_torch.data.tokenization import BertWordPiece, TextPreprocessor  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
VOCAB = ("[PAD] [UNK] [CLS] [SEP] [MASK] a b c d e dog cat runs the quick brown fox "
         "jump ##s ##ing over lazy river bank small big red blue green house tree left "
         "right man on").split()
WORDS = VOCAB[5:]
RES, PATCH = 48, 16


@pytest.fixture(scope="module", autouse=True)
def _library():
    if not native.native_available():
        pytest.skip(f"native dataplane unavailable: {native.unavailable_reason()}")
    if not jax_native.native_available():
        pytest.skip("the JAX package's native dataplane is unavailable")


def _photo(rng, w, h):
    low = rng.integers(0, 256, (h // 16 + 1, w // 16 + 1, 3)).astype(np.float32)
    img = np.kron(low, np.ones((16, 16, 1), np.float32))[:h, :w]
    return np.clip(img + rng.normal(0, 12, img.shape), 0, 255).astype(np.uint8)


def _encode(arr, fmt):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format=fmt, **({"quality": 90} if fmt == "JPEG" else {}))
    return buf.getvalue()


def _images(rng, n=6):
    """JPEGs and PNGs of several sizes (down- and up-scaled to ``RES``)."""
    return [_encode(_photo(rng, 30 + 23 * i, 70 - 5 * i), "JPEG" if i % 2 else "PNG")
            for i in range(n)]


def test_decode_equals_jax_bit_for_bit():
    raws = _images(np.random.default_rng(0)) + [b"not an image"]
    for res in (RES, 64):
        got, ok = native.NativeDecoder(res, num_threads=3).decode_raw(raws)
        want, jok = jax_native.NativeDecoder(res, num_threads=3).decode_raw(raws)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype == np.float32 and ok.tolist() == jok.tolist()
        assert ok.tolist() == [True] * 6 + [False]
        b64 = [base64.b64encode(r).decode() for r in raws]
        got_b, ok_b = native.NativeDecoder(res).decode_b64(b64)
        np.testing.assert_array_equal(got_b, got)
        assert ok_b.tolist() == ok.tolist()


@pytest.mark.parametrize("b64", [False, True], ids=["raw", "b64"])
def test_transform_batch_equals_jax_with_the_same_seeds(b64):
    raws = _images(np.random.default_rng(1), 8)
    raws.insert(3, b"\xff\xd8 broken jpeg")
    items = [base64.b64encode(r) for r in raws] if b64 else raws
    for seed in (0, 5):
        got, ok = native.NativeTrainTransform(RES, rng=random.Random(seed),
                                              num_threads=2).transform_batch(items, b64=b64)
        want, jok = jax_native.NativeTrainTransform(RES, rng=random.Random(seed),
                                                    num_threads=2).transform_batch(items,
                                                                                   b64=b64)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.uint8 and ok.tolist() == jok.tolist()
        assert not ok[3] and ok.sum() == 8


def test_region_batch_equals_jax():
    rng = np.random.default_rng(2)
    raws = [_encode(_photo(rng, 90, 70), "JPEG"), _encode(_photo(rng, 64, 80), "PNG"),
            _encode(_photo(rng, 120, 100), "JPEG")]
    boxes = [(10, 5, 60, 50), (0, 0, 64, 80), (33, 20, 17, 41)]
    flips = [1, 0, 1]
    port = native.NativeBoxTransform(RES, rng=random.Random(4))
    ref = jax_native.NativeBoxTransform(RES, rng=random.Random(4))
    assert [port.image_dims(r) for r in raws] == [ref.image_dims(r) for r in raws]
    for _ in range(2):      # the second call from where the first left the rngs
        got, ok = port.region_batch(raws, boxes, flips)
        want, jok = ref.region_batch(raws, boxes, flips)
        np.testing.assert_array_equal(got, want)
        assert ok.all() and jok.all()
    assert port.rng.getstate() == ref.rng.getstate()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("native")
    (d / "bert").mkdir()
    (d / "bert" / "vocab.txt").write_text("\n".join(VOCAB))
    rng = np.random.default_rng(3)
    cap = lambda n: " ".join(rng.choice(WORDS, n))
    with open(d / "img.jsonl", "w") as f:
        for i in range(10):
            data = b"broken" if i == 4 else _encode(_photo(rng, 40 + 7 * i, 52),
                                                   "JPEG" if i % 2 else "PNG")
            f.write(json.dumps({"binary": base64.b64encode(data).decode(),
                                "desc": [cap(6), cap(8)] if i % 3 else cap(7)}) + "\n")
    with open(d / "regions.jsonl", "w") as f:
        for i in range(8):
            w, h = int(rng.integers(60, 100)), int(rng.integers(60, 100))
            elems = []
            for _ in range(int(rng.integers(1, 4))):
                bw, bh = int(rng.integers(4, w // 2)), int(rng.integers(4, h // 2))
                x, y = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
                elems.append({"bb": [x, y, bw, bh], "caption": cap(3)})
            if i % 3 == 0:
                elems[0]["caption"] = "the man on the left"
            line = {"binary": base64.b64encode(_encode(_photo(rng, w, h), "JPEG")).decode(),
                    "elems": elems}
            if i % 2:
                line["caption"] = cap(6)
            f.write(json.dumps(line) + "\n")
    with open(d / "videos.jsonl", "w") as f:
        for i in range(5):
            frames = [base64.b64encode(_encode(_photo(rng, 40, 36), "JPEG")).decode()
                      for _ in range(4 + i)]
            f.write(json.dumps({"frames": frames, "caption": cap(5)}) + "\n")
    return d


def _pre(corpus, seed, jax=False):
    tok = (jax_build_tokenizer(str(corpus / "bert")) if jax
           else BertWordPiece(str(corpus / "bert" / "vocab.txt")))
    cls = JaxTextPreprocessor if jax else TextPreprocessor
    return cls(tok, max_tokens=10, max_words=10, max_masks=3, rng=random.Random(seed))


def _assert_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            if k == "rows":
                _assert_equal(g[k], w[k])
                continue
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype, k


@pytest.mark.parametrize("seed", [0, 1])
def test_image_stream_native_equals_jax(corpus, seed):
    path = [str(corpus / "img.jsonl")]
    kw = dict(image_key="binary", caption_key="desc")
    port = ImageTextStream(DistLineReader(path, seed=1), _pre(corpus, seed),
                           native.NativeTrainTransform(RES, rng=random.Random(seed + 2)),
                           rng=random.Random(seed), **kw)
    ref = JaxImageTextStream(JaxDistLineReader(path, seed=1), _pre(corpus, seed, True),
                             jax_native.NativeTrainTransform(RES, rng=random.Random(seed + 2)),
                             rng=random.Random(seed), **kw)
    got = [s for s, _ in zip(port, range(14))]
    want = [s for s, _ in zip(ref, range(14))]
    _assert_equal(got, want)
    assert got[0]["image"].dtype == np.uint8 and got[0]["image"].shape == (RES, RES, 3)
    assert port.broken == ref.broken == 2   # line 4, once an epoch


@pytest.mark.parametrize("seed", [0, 1])
def test_region_stream_native_equals_jax(corpus, seed):
    path = [str(corpus / "regions.jsonl")]
    kw = dict(image_res=RES, patch_size=PATCH, max_regions=3, min_perc_in_image=0.5,
              careful_hflip=True)
    port = RegionTextStream(DistLineReader(path, seed=1), _pre(corpus, seed + 1),
                            native.NativeBoxTransform(RES, rng=random.Random(seed + 2)),
                            rng=random.Random(seed), **kw)
    ref = JaxRegionTextStream(JaxDistLineReader(path, seed=1), _pre(corpus, seed + 1, True),
                              jax_native.NativeBoxTransform(RES, rng=random.Random(seed + 2)),
                              rng=random.Random(seed), **kw)
    got = [s for s, _ in zip(port, range(12))]
    want = [s for s, _ in zip(ref, range(12))]
    _assert_equal(got, want)
    assert got[0]["image"].dtype == np.uint8
    assert any(r["is_image"] == 1 for s in got for r in s["rows"])


def test_video_stream_native_equals_jax(corpus):
    path = [str(corpus / "videos.jsonl")]
    port = VideoTextStream(DistLineReader(path, seed=1), _pre(corpus, 3),
                           native.NativeTrainTransform(RES, rng=random.Random(7)),
                           frame_len=3, rng=random.Random(5))
    ref = JaxVideoTextStream(JaxDistLineReader(path, seed=1), _pre(corpus, 3, True),
                             jax_native.NativeTrainTransform(RES, rng=random.Random(7)),
                             frame_len=3, rng=random.Random(5))
    got = [s for s, _ in zip(port, range(7))]
    want = [s for s, _ in zip(ref, range(7))]
    _assert_equal(got, want)
    assert got[0]["image"].shape == (3, RES, RES, 3) and got[0]["image"].dtype == np.uint8


def test_retrieval_eval_native_decode_equals_jax(corpus):
    images = corpus / "ret"
    images.mkdir(exist_ok=True)
    rng = np.random.default_rng(6)
    ann = []
    for i in range(5):
        (images / f"{i}.jpg").write_bytes(_encode(_photo(rng, 50 + 9 * i, 44), "JPEG"))
        ann.append({"image": f"{i}.jpg", "caption": [f"a dog {i}", "the cat"]})
    (images / "bad.jpg").write_bytes(b"broken")
    (corpus / "ret.json").write_text(json.dumps(ann + [{"image": "bad.jpg",
                                                       "caption": "a fox"}]))
    kw = dict(use_native_decode=True, image_res=RES)
    port = RetrievalEvalDataset(str(corpus / "ret.json"), T.test_transform(RES), str(images),
                                _pre(corpus, 0), **kw)
    ref = JaxRetrievalEvalDataset(str(corpus / "ret.json"), JT.test_transform(RES),
                                  str(images), _pre(corpus, 0, True), **kw)
    assert port.native is not None
    got, want = port.image_batch([0, 3, 4]), ref.image_batch([0, 3, 4])
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32 and got.shape == (3, RES, RES, 3)
    # a batch holding the broken image falls back to PIL, where it raises as PIL does
    with pytest.raises(Exception) as port_err:
        port.image_batch([1, 5])
    with pytest.raises(Exception) as ref_err:
        ref.image_batch([1, 5])
    assert type(port_err.value) is type(ref_err.value)


def test_pixel_ops_hold_against_pil():
    assert native.pil_parity_failures(0) == []
    assert native.pil_parity_failures(1) == []


def test_racing_builds_load_one_whole_library(tmp_path):
    """Two processes build the library into an empty directory at once:
    each compiles to a file of its own and renames it into place, so both
    load a whole library and decode alike."""
    code = (
        "import sys, numpy as np\n"
        "from pathlib import Path\n"
        "from x2vlm_tpu_torch.data import native\n"
        "native.BUILD_DIR = Path(sys.argv[1])\n"
        "assert native.native_available(), native.unavailable_reason()\n"
        "out, ok = native.NativeDecoder(16).decode_raw([open(sys.argv[2], 'rb').read()])\n"
        "print(native.lib_path().name, ok.all(), float(out.sum()))\n")
    img = tmp_path / "a.png"
    img.write_bytes(_encode(_photo(np.random.default_rng(5), 30, 30), "PNG"))
    build = tmp_path / "build"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(build), str(img)], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [e[-2000:] for _, e in outs]
    lines = [o.strip() for o, _ in outs]
    assert lines[0] == lines[1] and lines[0].split()[1] == "True"
    assert [p.name for p in build.iterdir()] == [lines[0].split()[0]]
