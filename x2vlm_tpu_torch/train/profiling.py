"""Profiling hooks (the port's counterpart of x2vlm_tpu/train/profiling.py;
the reference has none, only wall-clock meters): a ``torch.profiler``
trace of a window of steps, written for TensorBoard, and a step timer
that waits for the card before it reads the clock."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch

__all__ = ["trace_window", "StepTimer", "maybe_trace_step"]


def _profiler(log_dir: str) -> torch.profiler.profile:
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(
        activities=acts, on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir))


@contextlib.contextmanager
def trace_window(log_dir: str) -> Iterator[None]:
    """Trace the enclosed block; the trace (``*.pt.trace.json``) lands in
    ``log_dir`` when the block ends."""
    with _profiler(log_dir):
        yield


def _sync(value) -> None:
    """Wait until ``value`` (a tensor) is computed: the card's queue for a
    CUDA tensor."""
    if torch.is_tensor(value) and value.is_cuda:
        torch.cuda.synchronize(value.device)


class StepTimer:
    """Wall-clock seconds a step, with an optional trace of the steps
    [start_step, start_step + num_steps)."""

    def __init__(self, log_dir: Optional[str] = None, start_step: int = -1,
                 num_steps: int = 0):
        self.log_dir = log_dir
        self.start_step = start_step
        self.stop_step = start_step + num_steps
        self._prof: Optional[torch.profiler.profile] = None
        self._t0 = None

    def step_begin(self, step: int) -> None:
        if self.log_dir and step == self.start_step and self._prof is None:
            self._prof = _profiler(self.log_dir)
            self._prof.start()
        self._t0 = time.perf_counter()

    def step_end(self, step: int, sync_value=None) -> float:
        """Seconds since :meth:`step_begin`, once ``sync_value`` (the step's
        output, a tensor) is computed; closes the trace after its last
        step."""
        _sync(sync_value)
        dt = time.perf_counter() - self._t0
        if self._prof is not None and step >= self.stop_step:
            self._prof.stop()
            self._prof = None
        return dt


@contextlib.contextmanager
def maybe_trace_step(log_dir: Optional[str], enabled: bool):
    if not (log_dir and enabled):
        yield
        return
    with trace_window(log_dir):
        yield
