"""Spawned process groups for the port's data-parallel tests (not a test
module): ``spawn(target, tmp_path)`` runs ``target(rank, world, tmp)`` in
``world`` fresh processes (the ``spawn`` context), each of which joins a
gloo group through a ``FileStore`` under ``tmp_path`` (no TCP port, so
parallel test workers never collide) with a timeout on every collective.
The parent waits for all of them under one deadline; on a hang it kills
every child and fails, and a child's exception comes back as its
traceback."""

from __future__ import annotations

import os
import time
import traceback
from pathlib import Path

GROUP_TIMEOUT_S = 60.0   # every collective of the group
JOIN_TIMEOUT_S = 150.0   # the whole spawn


def init_group(rank: int, world: int, tmp: str, fsdp: int = 1):
    from x2vlm_tpu_torch.core import mesh

    return mesh.initialize("cpu", fsdp=fsdp, init_method=f"file://{tmp}/store", rank=rank,
                           world_size=world, timeout_s=GROUP_TIMEOUT_S)


def _entry(target, rank: int, world: int, tmp: str) -> None:
    import torch

    torch.set_num_threads(2)
    try:
        target(rank, world, tmp)
    except BaseException:
        Path(tmp, f"error{rank}.txt").write_text(traceback.format_exc())
        os._exit(1)
    finally:
        from x2vlm_tpu_torch.core import mesh

        mesh.shutdown()


def spawn(target, tmp_path, world: int = 2, join_timeout_s: float = JOIN_TIMEOUT_S,
          meanwhile=None):
    """Run the ranks; ``meanwhile()``, if given, runs here while they do
    (the parent's own share of a test). Returns what it returned."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(target, r, world, str(tmp_path)))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + join_timeout_s
    try:
        result = meanwhile() if meanwhile is not None else None
    finally:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    errors = "\n".join(Path(tmp_path, f"error{r}.txt").read_text()
                       for r in range(world) if Path(tmp_path, f"error{r}.txt").exists())
    if hung:
        raise AssertionError(f"ranks {hung} still ran after {join_timeout_s} s and were "
                             f"killed\n{errors}")
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise AssertionError(f"exit codes {codes}\n{errors}")
    return result
