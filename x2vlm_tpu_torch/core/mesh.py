"""Process groups and the data-parallel collectives of a step (the port's
counterpart of x2vlm_tpu/core/mesh.py; reference accelerators/
apex_ddp_accelerator.py and models/xvlm.py:140-160).

One process drives one device. ``torchrun`` (or ``python -m
torch.distributed.run``) starts the processes and sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``;
:func:`initialize` reads them and joins the process group: NCCL with each
rank on ``cuda:LOCAL_RANK``, or gloo for ``--device cpu``. Without that
environment the world is 1 and no group is made (one process, one card).

The world is a (data, fsdp) grid as in the JAX mesh: ``fsdp`` consecutive
ranks form a parameter-sharding group (train/optim.py ``AdamW.shard``),
and every rank reads its own rows of the batch, so the global batch is
``batch_size * world``.

The losses of a train step see the global batch (``data_parallel``):

- ``gather_rows`` all-gathers a tensor along its first dim in rank order
  with a gradient: its backward sums the gathered gradient over the ranks
  and hands each rank its own rows, so the mean of the ranks' gradients
  (``all_reduce_grads``) is the gradient of the mean of the ranks' losses;
- each loss is written so that the mean of the ranks' values is the
  global-batch loss: a mean over rows stays a per-rank mean (every rank has
  as many rows), and a mean over a data-dependent count divides the rank's
  sum by ``batch_denominator`` (the global count over the world size).

Outside ``data_parallel`` (evaluation, serving, a step at world 1) every
helper is the identity and the arithmetic is the single-process one.
"""

from __future__ import annotations

import contextlib
import datetime
import os
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["initialize", "shutdown", "process_index", "process_count", "is_main_process",
           "local_device_count", "barrier", "shard_batch", "fsdp_size", "fsdp_rank",
           "fsdp_group", "data_parallel", "step_world", "gather_rows", "batch_denominator",
           "all_reduce_grads", "all_gather_object", "all_gather_array", "describe"]

_STATE: Dict = {"fsdp": 1, "fsdp_group": None, "device": None}
_IN_STEP = [False]
BUCKET_BYTES = 25 * 2 ** 20   # the gradient all-reduce's bucket (DDP's default size)


def initialize(device="cuda", *, fsdp: int = 1, init_method: Optional[str] = None,
               rank: Optional[int] = None, world_size: Optional[int] = None,
               timeout_s: float = 1800.0) -> torch.device:
    """Join the process group and return this rank's device.

    ``rank`` / ``world_size`` / ``init_method`` default to the launcher's
    environment (``env://``); a test passes its own (a ``file://`` store).
    Without ``RANK`` in the environment and no ``rank`` given, no group is
    made and ``device`` resolves as in a single-process run. A group that
    is already up is joined as it is."""
    from x2vlm_tpu_torch.device import resolve_device

    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    elif rank is None and "RANK" not in os.environ:
        if fsdp != 1:
            raise ValueError(f"--fsdp {fsdp} needs a process group of a world it divides; "
                             f"start the run with torchrun")
        _STATE.update(fsdp=1, fsdp_group=None, device=resolve_device(device))
        return _STATE["device"]
    else:
        rank = int(os.environ["RANK"]) if rank is None else rank
        world = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None else world_size
    if fsdp < 1 or world % fsdp:
        raise ValueError(f"world size {world} is not divisible by fsdp={fsdp}")
    kind = torch.device(device).type
    if kind == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = resolve_device(torch.device("cuda", local))
        torch.cuda.set_device(dev)
        backend = "nccl"
    elif kind == "cpu":
        dev, backend = torch.device("cpu"), "gloo"
    else:
        raise ValueError(f"no process-group backend for device {device!r}")
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=timeout_s))
    group = None
    if fsdp == world:
        group = dist.group.WORLD
    elif fsdp > 1:
        for k in range(world // fsdp):   # every rank makes every group
            g = dist.new_group(list(range(k * fsdp, (k + 1) * fsdp)))
            if k == rank // fsdp:
                group = g
    _STATE.update(fsdp=fsdp, fsdp_group=group, device=dev)
    return dev


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
    _STATE.update(fsdp=1, fsdp_group=None, device=None)


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    return process_index() == 0


def local_device_count() -> int:
    """The devices this process drives: one."""
    return 1


def describe() -> Dict:
    """The process group as a record: backend, world size, rank, device."""
    return {"backend": dist.get_backend() if dist.is_initialized() else None,
            "world_size": process_count(), "rank": process_index(),
            "fsdp": _STATE["fsdp"], "device": str(_STATE["device"])}


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def shard_batch(batch: Dict, device) -> Dict:
    """This rank's host batch (numpy) as tensors on its device: attention
    masks int32, other integer arrays int64, images and floats as they
    are."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        if t.dtype == torch.int32 and not k.endswith("atts"):
            t = t.long()
        out[k] = t.to(device, non_blocking=True)
    return out


def fsdp_size() -> int:
    return _STATE["fsdp"]


def fsdp_group():
    return _STATE["fsdp_group"]


def fsdp_rank() -> int:
    return process_index() % _STATE["fsdp"]


@contextlib.contextmanager
def data_parallel() -> Iterator[None]:
    """The losses computed inside see the global batch of the step."""
    prev = _IN_STEP[0]
    _IN_STEP[0] = True
    try:
        yield
    finally:
        _IN_STEP[0] = prev


def step_world() -> int:
    """The ranks whose rows make this loss's batch: the world inside
    :func:`data_parallel`, else 1."""
    return process_count() if _IN_STEP[0] else 1


def _all_gather(x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(process_count())]
    dist.all_gather(parts, x)
    return torch.cat(parts)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.rows = x.shape[0]
        return _all_gather(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        lo = process_index() * ctx.rows
        return grad[lo:lo + ctx.rows]


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` of every rank concatenated along dim 0 in rank order; the
    gradient of the whole flows back to each rank's rows, summed over the
    ranks. Every rank must pass as many rows."""
    return _GatherRows.apply(x) if x.requires_grad else _all_gather(x)


def batch_denominator(count: torch.Tensor) -> torch.Tensor:
    """The denominator of a mean over a data-dependent count (``count``,
    this rank's, at least 1 after the sum): at world N inside the step the
    global count over N, so the rank's sum over it averages over the ranks
    to the global mean; else ``count.clamp(min=1)``."""
    world = step_world()
    if world == 1:
        return count.clamp(min=1)
    total = count.detach().float().clone()
    dist.all_reduce(total)
    return total.clamp(min=1) / world


@torch.no_grad()
def all_reduce_grads(params: Sequence[torch.Tensor], bucket_bytes: int = BUCKET_BYTES
                     ) -> None:
    """Replace each ``.grad`` by its mean over the ranks, in buckets of
    about ``bucket_bytes`` (one flat all-reduce each). A parameter without
    a gradient counts as zeros and gets one, so every rank reduces the
    same buckets whatever its streams left unused."""
    if not dist.is_initialized():
        return
    world = process_count()
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for p in params:
        by_dtype.setdefault(p.grad.dtype, []).append(p)
    for group in by_dtype.values():
        bucket, size = [], 0
        for i, p in enumerate(group):
            bucket.append(p)
            size += p.grad.numel() * p.grad.element_size()
            if size >= bucket_bytes or i == len(group) - 1:
                flat = torch.cat([q.grad.reshape(-1) for q in bucket])
                dist.all_reduce(flat)
                flat.div_(world)
                off = 0
                for q in bucket:
                    n = q.grad.numel()
                    q.grad.copy_(flat[off:off + n].view_as(q.grad))
                    off += n
                bucket, size = [], 0


def all_gather_object(obj) -> List:
    """Every rank's ``obj`` in rank order (one element at world 1)."""
    if not dist.is_initialized():
        return [obj]
    out: List = [None] * process_count()
    dist.all_gather_object(out, obj)
    return out


def all_gather_array(arr: np.ndarray) -> np.ndarray:
    """Every rank's ``arr`` (one shape on all ranks) stacked in rank order,
    through a tensor collective on this rank's device."""
    if not dist.is_initialized():
        return np.asarray(arr)[None]
    t = torch.from_numpy(np.ascontiguousarray(arr)).to(_STATE["device"] or "cpu")
    return _all_gather(t[None]).cpu().numpy()
