"""Windowed metric logging (the port's copy of x2vlm_tpu/train/metrics.py;
reference utils/__init__.py:101-316 SmoothedValue / MetricLogger, on one
card with nothing to all-reduce).

``MetricLogger.update`` takes device scalars as they are and reads them all
in one copy when the meters are next read (a log line, ``to_dict``), so a
train step does not wait for the card and the host can queue the next one.
"""

from __future__ import annotations

import collections
import datetime
import time
from typing import Dict, Iterable, List, Optional

import torch

__all__ = ["SmoothedValue", "MetricLogger"]


class SmoothedValue:
    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = collections.deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        value = float(value)
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self):
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self):
        return sum(self.deque) / len(self.deque) if self.deque else 0.0

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg, value=self.value)


class MetricLogger:
    def __init__(self, delimiter: str = "  ", print_fn=print):
        self.meters: Dict[str, SmoothedValue] = collections.defaultdict(SmoothedValue)
        self.delimiter = delimiter
        self.print_fn = print_fn
        self._pending: List[Dict] = []

    def update(self, **kwargs):
        """Numbers or scalar tensors; tensors are read at the next flush."""
        self._pending.append(kwargs)

    def flush(self):
        """Move every pending value into its meter: one device-to-host copy
        per device for all pending tensors."""
        pending, self._pending = self._pending, []
        by_device: Dict[torch.device, List[torch.Tensor]] = collections.defaultdict(list)
        for d in pending:
            for v in d.values():
                if torch.is_tensor(v):
                    by_device[v.device].append(v.detach().float().reshape(()))
        read = {dev: iter(torch.stack(ts).tolist()) for dev, ts in by_device.items()}
        for d in pending:
            for k, v in d.items():
                self.meters[k].update(next(read[v.device]) if torch.is_tensor(v) else v)

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        self.flush()
        if name in self.meters:
            return self.meters[name]
        raise AttributeError(name)

    def __str__(self):
        self.flush()
        return self.delimiter.join(f"{k}: {m}" for k, m in self.meters.items())

    def to_dict(self) -> Dict[str, float]:
        self.flush()
        return {k: m.global_avg for k, m in self.meters.items()}

    def log_every(self, iterable: Iterable, print_freq: int,
                  header: str = "", total: Optional[int] = None):
        """Iterator wrapper printing loss/timing stats every `print_freq` steps
        with an ETA (reference MetricLogger.log_every, utils/__init__.py:209-264)."""
        i = 0
        start = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        end = time.time()
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0:
                if total:
                    eta = iter_time.global_avg * (total - i)
                    eta_str = str(datetime.timedelta(seconds=int(eta)))
                else:
                    eta_str = "?"
                self.print_fn(
                    f"{header} [{i}{f'/{total}' if total else ''}] eta: {eta_str} "
                    f"{self} time: {iter_time} data: {data_time}")
            i += 1
            end = time.time()
        elapsed = time.time() - start
        self.print_fn(f"{header} done in {datetime.timedelta(seconds=int(elapsed))} "
                      f"({elapsed / max(i, 1):.4f} s/it)")
