"""Filesystem helpers of the launcher and the data streams (the port's copy
of x2vlm_tpu/core/io.py; reference utils/hdfs_io.py:24-128 and
utils/torch_io.py).

Scheme dispatch by prefix: ``hdfs://`` goes through the ``hdfs dfs``
command-line tool, ``gs://`` through ``gsutil``, anything else is a local
path. Remote reads and writes stream through the tool's standard output /
input; ``fetch_local`` stages a remote file in a local directory and
``mirror_to_remote`` copies a run's output directory to a remote one."""

from __future__ import annotations

import contextlib
import io
import os
import shutil
import subprocess
from typing import IO, Iterator, List

__all__ = ["hopen", "hlist_files", "hexists", "hmkdir", "hcopy", "hcountline",
           "fetch_local", "mirror_to_remote", "is_remote"]

_REMOTE = ("hdfs://", "gs://")


def is_remote(path: str) -> bool:
    return str(path).startswith(_REMOTE)


def _scheme(path: str) -> str:
    path = str(path)
    if path.startswith("hdfs://"):
        return "hdfs"
    if path.startswith("gs://"):
        return "gs"
    return "local"


@contextlib.contextmanager
def hopen(path: str, mode: str = "r") -> Iterator[IO]:
    """Open a local, ``hdfs://`` or ``gs://`` path; a remote one streams
    through its tool's pipe (reference hdfs_io.hopen:24-52). A remote text
    write flushes its wrapper into the pipe before closing it (the JAX
    copy closes the pipe under the wrapper, and a short text write is
    lost)."""
    scheme = _scheme(path)
    if scheme == "local":
        with open(path, mode) as f:
            yield f
        return
    binary = "b" in mode
    if "r" in mode:
        cmd = (["hdfs", "dfs", "-cat", path] if scheme == "hdfs"
               else ["gsutil", "cat", path])
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE)
        try:
            yield proc.stdout if binary else io.TextIOWrapper(proc.stdout)
        finally:
            proc.stdout.close()
            proc.wait()
    else:
        cmd = (["hdfs", "dfs", "-put", "-f", "-", path] if scheme == "hdfs"
               else ["gsutil", "cp", "-", path])
        proc = subprocess.Popen(cmd, stdin=subprocess.PIPE)
        f = proc.stdin if binary else io.TextIOWrapper(proc.stdin)
        try:
            yield f
        finally:
            f.close()   # a text wrapper flushes its buffer into the pipe first
            proc.wait()


def hlist_files(paths: List[str]) -> List[str]:
    """The files under each path (reference hdfs_io.hlist_files:55-82)."""
    out: List[str] = []
    for p in paths:
        scheme = _scheme(p)
        if scheme == "local":
            if os.path.isdir(p):
                out.extend(os.path.join(p, f) for f in sorted(os.listdir(p)))
            elif os.path.exists(p):
                out.append(p)
        elif scheme == "hdfs":
            res = subprocess.run(["hdfs", "dfs", "-ls", p], capture_output=True, text=True)
            for line in res.stdout.splitlines():
                parts = line.split()
                if len(parts) >= 8 and parts[-1].startswith("hdfs://"):
                    out.append(parts[-1])
        else:
            res = subprocess.run(["gsutil", "ls", p], capture_output=True, text=True)
            out.extend(line for line in res.stdout.splitlines() if line)
    return out


def hexists(path: str) -> bool:
    scheme = _scheme(path)
    if scheme == "local":
        return os.path.exists(path)
    cmd = (["hdfs", "dfs", "-test", "-e", path] if scheme == "hdfs"
           else ["gsutil", "-q", "stat", path])
    return subprocess.run(cmd, capture_output=True).returncode == 0


def hmkdir(path: str) -> bool:
    scheme = _scheme(path)
    if scheme == "local":
        os.makedirs(path, exist_ok=True)
        return True
    if scheme == "hdfs":
        return subprocess.run(["hdfs", "dfs", "-mkdir", "-p", path]).returncode == 0
    return True   # GCS has no directories


def hcopy(src: str, dst: str) -> bool:
    """Copy a file (or, like ``hdfs dfs -put / -get``, a whole directory)
    across the local / hdfs / gs schemes (reference hdfs_io.hcopy:85-96)."""
    ss, ds = _scheme(src), _scheme(dst)
    if ss == "local" and ds == "local":
        if os.path.isdir(src):
            shutil.copytree(src, os.path.join(dst, os.path.basename(src.rstrip("/"))),
                            dirs_exist_ok=True)
        else:
            shutil.copy(src, dst)
        return True
    if "hdfs" in (ss, ds):
        flag = "-put" if ss == "local" else "-get" if ds == "local" else "-cp"
        return subprocess.run(["hdfs", "dfs", flag, "-f", src, dst]).returncode == 0
    recursive = ["-r"] if ss == "local" and os.path.isdir(src) else []
    return subprocess.run(["gsutil", "cp", *recursive, src, dst]).returncode == 0


def fetch_local(path: str, scratch_dir: str = ".") -> str:
    """A remote file staged into ``scratch_dir``, its local path returned;
    a local path passes through (reference run.py:84-101 get_from_hdfs)."""
    if _scheme(path) == "local":
        return path
    os.makedirs(scratch_dir, exist_ok=True)
    local = os.path.join(scratch_dir, os.path.basename(path.rstrip("/")))
    if not hcopy(path, local):
        raise FileNotFoundError(f"failed to fetch {path}")
    return local


def mirror_to_remote(local_dir: str, remote_dir: str, names: List[str] = ()) -> None:
    """Copy a run's artifacts (log, config, result JSONs, checkpoints) from
    ``local_dir`` to ``remote_dir`` (reference Pretrain.py:368-375, run.py:
    495-506). ``names`` picks entries of ``local_dir``; empty: every one."""
    hmkdir(remote_dir)
    for name in names or sorted(os.listdir(local_dir)):
        src = os.path.join(local_dir, name)
        if os.path.exists(src):
            hcopy(src, remote_dir.rstrip("/") + "/" + ("" if os.path.isdir(src) else name))


def hcountline(path: str) -> int:
    n = 0
    with hopen(path, "r") as f:
        for _ in f:
            n += 1
    return n
