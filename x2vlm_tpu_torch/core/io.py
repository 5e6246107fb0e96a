"""Filesystem helpers of the launcher and the data streams (the port's copy
of x2vlm_tpu/core/io.py, local paths only).

The JAX package also streams ``hdfs://`` and ``gs://`` paths through their
command-line tools; the port takes them with multi-host training (ROADMAP
queue A4) and raises for them until then."""

from __future__ import annotations

import contextlib
from typing import IO, Iterator

__all__ = ["hopen", "is_remote", "require_local"]

_REMOTE = ("hdfs://", "gs://")


def is_remote(path: str) -> bool:
    return str(path).startswith(_REMOTE)


def require_local(path: str) -> str:
    if is_remote(path):
        raise NotImplementedError(
            f"{path}: hdfs:// and gs:// paths come with multi-host training "
            f"(ROADMAP queue A4); the port reads local paths")
    return path


@contextlib.contextmanager
def hopen(path: str, mode: str = "r") -> Iterator[IO]:
    with open(require_local(path), mode) as f:
        yield f
