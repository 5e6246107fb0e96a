"""The port's host data plane against the JAX package's: image decode, the
ten RandomAugment ops and the three transforms (equal arrays), the
image-text and text streams (equal batches from the same shard and seeds,
broken samples counted, a stream of broken samples refused) and the line
reader's resumable cursor."""

import base64
import io
import json
import random
import sys

import numpy as np
import pytest
from tests.torch_threads import few_torch_threads  # noqa: E402,F401 (autouse)
from PIL import Image

from x2vlm_tpu.data import transforms as JT  # noqa: E402
from x2vlm_tpu.data.pretrain import (  # noqa: E402
    ImageTextStream as JaxImageTextStream, TextStream as JaxTextStream,
    _open_image as jax_open_image,
)
from x2vlm_tpu.data.streaming import DistLineReader as JaxDistLineReader  # noqa: E402
from x2vlm_tpu.data.tokenization import (  # noqa: E402
    TextPreprocessor as JaxTextPreprocessor, build_tokenizer as jax_build_tokenizer,
)
from x2vlm_tpu_torch.data import transforms as T  # noqa: E402
from x2vlm_tpu_torch.data.imageio import decode_image  # noqa: E402
from x2vlm_tpu_torch.data.loader import collate  # noqa: E402
from x2vlm_tpu_torch.data.pretrain import (  # noqa: E402
    BrokenStreamError, ImageTextStream, TextStream,
)
from x2vlm_tpu_torch.data.streaming import DistLineReader  # noqa: E402
from x2vlm_tpu_torch.data.tokenization import BertWordPiece, TextPreprocessor  # noqa: E402

VOCAB = ("[PAD] [UNK] [CLS] [SEP] [MASK] a b c d e dog cat runs the quick brown fox "
         "jump ##s ##ing over lazy river bank small big red blue green house tree").split()


def _image(rng, h=120, w=150):
    low = rng.integers(0, 256, (h // 30 + 1, w // 30 + 1, 3)).astype(np.float32)
    img = np.kron(low, np.ones((30, 30, 1), np.float32))[:h, :w]
    return np.clip(img + rng.normal(0, 12, img.shape), 0, 255).astype(np.uint8)


def _png(arr, mode=None):
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, format="PNG")
    return buf.getvalue()


# ---- decode ----

@pytest.mark.parametrize("fmt,mode", [("PNG", "RGB"), ("PNG", "RGBA"), ("PNG", "L"),
                                      ("PNG", "LA"), ("JPEG", "RGB")])
def test_decode_equals_jax(fmt, mode):
    rng = np.random.default_rng(0)
    arr = _image(rng)
    if mode == "RGBA":
        arr = np.concatenate([arr, rng.integers(0, 256, arr.shape[:2] + (1,), np.uint8)], 2)
    elif mode == "L":
        arr = arr[..., 0]
    elif mode == "LA":
        arr = np.stack([arr[..., 0], arr[..., 1]], 2)
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, format=fmt)
    data = buf.getvalue()
    want = np.asarray(jax_open_image({"b": base64.b64encode(data)}, "b", False))
    np.testing.assert_array_equal(np.asarray(decode_image(data)), want)


def test_decoding_without_pillow_names_it(monkeypatch):
    data = _png(_image(np.random.default_rng(1)))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="Pillow"):
        decode_image(data)


# ---- transforms ----

@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_pil_path_transforms_equal_jax(seed):
    img = Image.fromarray(_image(np.random.default_rng(seed), 90, 130))
    for port_f, jax_f in (
            (T.pretrain_transform(48, rng=random.Random(seed), as_float=False),
             JT.pretrain_transform(48, rng=random.Random(seed), as_float=False)),
            (T.pretrain_transform(48, rng=random.Random(seed)),
             JT.pretrain_transform(48, rng=random.Random(seed))),
            (T.train_transform(40, rng=random.Random(seed)),
             JT.train_transform(40, rng=random.Random(seed))),
            (T.test_transform(56), JT.test_transform(56))):
        for _ in range(3):
            np.testing.assert_array_equal(port_f(img), jax_f(img))


@pytest.mark.parametrize("name", sorted(T._AUG_RANGES))
def test_augment_ops_equal_jax(name):
    lo, hi = T._AUG_RANGES[name]
    fn, jlo, jhi = JT._AUG_OPS[name]
    assert (lo, hi) == (jlo, jhi)
    img = Image.fromarray(_image(np.random.default_rng(0), 97, 131))
    v = lo + (hi - lo) * 0.7
    np.testing.assert_array_equal(np.asarray(T._aug(name, img, v)), np.asarray(fn(img, v)))


# ---- streams and the line reader ----

@pytest.fixture(scope="module")
def shard(tmp_path_factory):
    d = tmp_path_factory.mktemp("shard")
    (d / "bert").mkdir()
    (d / "bert" / "vocab.txt").write_text("\n".join(VOCAB))
    rng = np.random.default_rng(0)
    words = VOCAB[5:]
    with open(d / "img.jsonl", "w") as f:
        for i in range(9):
            rec = {"binary": base64.b64encode(_png(_image(rng, 60, 70))).decode(),
                   "desc": [" ".join(rng.choice(words, 7)), " ".join(rng.choice(words, 4))]}
            if i == 4:
                rec["binary"] = "not an image"
            f.write(json.dumps(rec) + "\n")
    with open(d / "txt.jsonl", "w") as f:
        for _ in range(9):
            f.write(json.dumps({"text": " ".join(rng.choice(words, 9))}) + "\n")
    return d


def _pre(cls, tok, seed):
    return cls(tok, max_tokens=12, max_words=12, max_masks=4, rng=random.Random(seed))


def test_image_text_stream_equals_jax(shard):
    port_tok = BertWordPiece(str(shard / "bert" / "vocab.txt"))
    jax_tok = jax_build_tokenizer(str(shard / "bert"))
    port = ImageTextStream(DistLineReader([str(shard / "img.jsonl")], seed=3),
                           _pre(TextPreprocessor, port_tok, 1),
                           T.pretrain_transform(32, rng=random.Random(2), as_float=False),
                           rng=random.Random(4))
    ref = JaxImageTextStream(JaxDistLineReader([str(shard / "img.jsonl")], seed=3),
                             _pre(JaxTextPreprocessor, jax_tok, 1),
                             JT.pretrain_transform(32, rng=random.Random(2), as_float=False),
                             rng=random.Random(4))
    got = collate([s for s, _ in zip(port, range(12))])
    want = collate([s for s, _ in zip(ref, range(12))])
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert port.broken == ref.broken == 2   # line 4, once in each of two epochs


def test_text_stream_equals_jax(shard):
    port = TextStream(DistLineReader([str(shard / "txt.jsonl")], seed=0),
                      _pre(TextPreprocessor, BertWordPiece(str(shard / "bert" / "vocab.txt")), 5),
                      rng=random.Random(6))
    ref = JaxTextStream(JaxDistLineReader([str(shard / "txt.jsonl")], seed=0),
                        _pre(JaxTextPreprocessor, jax_build_tokenizer(str(shard / "bert")), 5),
                        rng=random.Random(6))
    got = collate([s for s, _ in zip(port, range(10))])
    want = collate([s for s, _ in zip(ref, range(10))])
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_a_stream_of_broken_samples_raises(shard, tmp_path):
    bad = tmp_path / "bad.jsonl"
    bad.write_text("".join(json.dumps({"binary": "xx", "desc": "a dog"}) + "\n"
                           for _ in range(3)))
    stream = ImageTextStream(DistLineReader([str(bad)]),
                             _pre(TextPreprocessor, BertWordPiece(
                                 str(shard / "bert" / "vocab.txt")), 0),
                             T.pretrain_transform(32, as_float=False),
                             max_consecutive_broken=5)
    with pytest.raises(BrokenStreamError, match="5 samples"):
        next(iter(stream))
    assert stream.broken == 5


@pytest.mark.parametrize("cut", [0, 3, 9, 10, 17])
def test_line_reader_resumes_from_its_state(tmp_path, cut):
    for i in range(3):
        (tmp_path / f"part{i}.jsonl").write_text("".join(f"{i}-{j}\n" for j in range(4)))
    paths = [str(tmp_path)]
    full = [x for x, _ in zip(DistLineReader(paths, seed=7), range(30))]
    assert full == [x for x, _ in zip(JaxDistLineReader(paths, seed=7), range(30))]
    reader = DistLineReader(paths, seed=7)
    it = iter(reader)
    head = [next(it) for _ in range(cut)]
    tail = [x for x, _ in zip(DistLineReader(paths, seed=7, start_state=reader.state()),
                              range(30 - cut))]
    assert head + tail == full


def test_prefetcher_close_stops_the_producer_and_closes_its_iterator():
    """A consumer that stops early: ``close`` ends the producer thread (it
    was blocked on a full queue) and closes the generator it read, so the
    generator's ``finally`` (an open file's ``with``) runs."""
    import threading

    from x2vlm_tpu_torch.data.loader import Prefetcher

    closed = threading.Event()

    def endless():
        try:
            i = 0
            while True:
                yield i
                i += 1
        finally:
            closed.set()

    pf = Prefetcher(endless(), depth=2)
    it = iter(pf)
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    pf.close()
    assert not pf.thread.is_alive() and closed.is_set()


def test_prefetcher_reraises_a_producer_error():
    from x2vlm_tpu_torch.data.loader import Prefetcher

    def broken():
        yield 1
        raise KeyError("boom")

    with pytest.raises(KeyError, match="boom"):
        list(Prefetcher(broken()))
