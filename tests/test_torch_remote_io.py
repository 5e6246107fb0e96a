"""The port's remote storage (``x2vlm_tpu_torch/core/io.py``) against the
JAX package's ``core/io.py``: the same calls on ``hdfs://`` and ``gs://``
paths through stand-in ``hdfs`` and ``gsutil`` tools (test_remote_staging.py's
``hdfs``, and a ``gsutil`` written here), each package under its own
prefix, give the same answers and leave the same remote files, byte for
byte. Then the port's readers on remote paths: ``list_data_files`` /
``DistLineReader`` and a ``.th`` import."""

import os
import stat
from pathlib import Path

import numpy as np
import pytest
from tests.torch_threads import few_torch_threads  # noqa: E402,F401 (autouse)

torch = pytest.importorskip("torch")

from tests.test_remote_staging import fake_hdfs  # noqa: E402,F401 (a fixture)

GSUTIL = """#!/usr/bin/env python3
import os, shutil, sys
ROOT = {root!r}
def local(p):
    assert p.startswith("gs://bkt/"), p
    return os.path.join(ROOT, p[len("gs://bkt/"):])
args = sys.argv[1:]
quiet = args[0] == "-q"
if quiet:
    args = args[1:]
op = args[0]
if op == "cat":
    sys.stdout.buffer.write(open(local(args[1]), "rb").read())
elif op == "ls":
    d = local(args[1])
    if not os.path.exists(d):
        sys.exit(1)
    for f in sorted(os.listdir(d)):
        print(args[1].rstrip("/") + "/" + f)
elif op == "stat":
    sys.exit(0 if os.path.isfile(local(args[1])) else 1)
elif op == "cp":
    rec = "-r" in args
    src, dst = [a for a in args[1:] if a != "-r"]
    if src == "-":
        os.makedirs(os.path.dirname(local(dst)), exist_ok=True)
        with open(local(dst), "wb") as f:
            shutil.copyfileobj(sys.stdin.buffer, f)
    elif src.startswith("gs://"):
        shutil.copy(local(src), dst)
    else:
        out = local(dst)
        if rec:
            shutil.copytree(src, os.path.join(out, os.path.basename(src.rstrip("/"))),
                            dirs_exist_ok=True)
        else:
            if out.endswith("/"):
                out = os.path.join(out, os.path.basename(src))
            os.makedirs(os.path.dirname(out), exist_ok=True)
            shutil.copy(src, out)
else:
    sys.exit(2)
"""


@pytest.fixture()
def remotes(fake_hdfs, tmp_path, monkeypatch):  # noqa: F811
    """{scheme: (path prefix, local root)} for hdfs:// and gs://."""
    gcs = tmp_path / "gcs_root"
    gcs.mkdir()
    script = tmp_path / "gbin" / "gsutil"
    script.parent.mkdir()
    script.write_text(GSUTIL.format(root=str(gcs)))
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{script.parent}:{os.environ['PATH']}")
    return {"hdfs": ("hdfs://test/", fake_hdfs), "gs": ("gs://bkt/", gcs)}


def _session(io, base: str, local: Path):
    """One sequence of every io call under ``base``; returns what each
    call answered, the remote prefix replaced by ``<R>``."""
    out = {}
    local.mkdir()
    (local / "run").mkdir()
    (local / "run" / "log.txt").write_text("step 1\nstep 2\n")
    (local / "run" / "ckpt").mkdir()
    (local / "run" / "ckpt" / "state.bin").write_bytes(bytes(range(256)) * 3)
    out["mkdir"] = io.hmkdir(base + "d")
    with io.hopen(base + "d/a.txt", "wb") as f:
        f.write(b"x\ny\n\nz\n")
    with io.hopen(base + "d/b.bin", "wb") as f:
        f.write(bytes(range(200)))
    with io.hopen(base + "d/a.txt", "r") as f:
        out["text"] = f.read()
    with io.hopen(base + "d/b.bin", "rb") as f:
        out["bytes"] = list(f.read())
    out["exists"] = [io.hexists(base + "d/a.txt"), io.hexists(base + "d/none.txt")]
    out["count"] = io.hcountline(base + "d/a.txt")
    out["copy_up"] = io.hcopy(str(local / "run" / "log.txt"), base + "d/log.txt")
    out["copy_down"] = io.hcopy(base + "d/b.bin", str(local / "b.bin"))
    out["down_bytes"] = list((local / "b.bin").read_bytes())
    fetched = io.fetch_local(base + "d/a.txt", str(local / "scratch"))
    out["fetched"] = [os.path.relpath(fetched, local), Path(fetched).read_text()]
    out["local_passes"] = io.fetch_local(str(local / "b.bin")) == str(local / "b.bin")
    io.mirror_to_remote(str(local / "run"), base + "mirror")
    out["list"] = [p.replace(base, "<R>") for p in io.hlist_files([base + "d"])]
    return out


def _tree(root: Path):
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


@pytest.mark.parametrize("scheme", ["hdfs", "gs"])
def test_io_equals_the_jax_io(scheme, remotes, tmp_path):
    from x2vlm_tpu.core import io as jax_io
    from x2vlm_tpu_torch.core import io as port_io

    prefix, root = remotes[scheme]
    got = _session(port_io, prefix + "port/", tmp_path / "port")
    want = _session(jax_io, prefix + "jax/", tmp_path / "jax")
    assert got == want
    assert got["text"] == "x\ny\n\nz\n" and got["count"] == 4 and got["exists"] == [True, False]
    assert sorted(got["list"]) == ["<R>d/a.txt", "<R>d/b.bin", "<R>d/log.txt"]
    assert _tree(root / "port") == _tree(root / "jax")
    assert _tree(root / "port" / "mirror") == _tree(tmp_path / "port" / "run")
    assert port_io.is_remote(prefix) and not port_io.is_remote(str(tmp_path))
    # a text write reaches the remote file (the JAX copy's is lost: its pipe
    # closes under the text wrapper's buffer)
    with port_io.hopen(prefix + "port/t.txt", "w") as f:
        f.write("one\ntwo\n")
    assert (root / "port" / "t.txt").read_text() == "one\ntwo\n"


def test_remote_streams_and_th_import(remotes, tmp_path):
    """``list_data_files`` lists a remote directory (markers dropped), a
    rank's ``DistLineReader`` streams its shard's lines from it, and
    ``load_torch_checkpoint`` reads a ``.th`` from ``hdfs://``."""
    from x2vlm_tpu.data.streaming import list_data_files as jax_list
    from x2vlm_tpu_torch.data.streaming import DistLineReader, list_data_files
    from x2vlm_tpu_torch.train.checkpoint import load_torch_checkpoint

    prefix, root = remotes["hdfs"]
    (root / "data").mkdir()
    for i in range(3):
        (root / "data" / f"p{i}.jsonl").write_text("".join(f"{{\"i\": {10 * i + j}}}\n"
                                                           for j in range(2)))
    (root / "data" / "_SUCCESS").write_text("")
    files = list_data_files([prefix + "data"])
    assert files == jax_list([prefix + "data"]) == [f"{prefix}data/p{i}.jsonl" for i in range(3)]
    readers = [DistLineReader([prefix + "data"], rank=k, world_size=2) for k in range(2)]
    # one epoch: each rank's shard, two lines a file
    lines = [[r["i"] for r, _ in zip(rd.iter_json(), range(2 * len(rd._epoch_files(0))))]
             for rd in readers]
    assert sorted(lines[0] + lines[1]) == [0, 1, 10, 11, 20, 21]
    sd = {"model": {"module.w": torch.arange(6.0).reshape(2, 3)}}
    torch.save(sd, root / "m.th")
    got = load_torch_checkpoint(prefix + "m.th")
    assert list(got) == ["w"]
    np.testing.assert_array_equal(got["w"].numpy(), np.arange(6.0).reshape(2, 3))
