"""Batching + background prefetch (the port's copy of x2vlm_tpu/data/loader.py;
reference dataset/__init__.py:505-538).

Map-style path: per-host strided sampling over the index space (the
DistributedSampler contract) + thread-pool sample loading + a prefetch queue
that overlaps host image decode with device steps. Iterable path: batches a
sample generator. Everything yields dicts of stacked numpy arrays with static
shapes; the trainer moves them to the device.
"""

from __future__ import annotations

import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np

__all__ = ["collate", "batch_indices", "MapLoader", "iter_batches", "Prefetcher"]


def collate(samples: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    out = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        out[k] = np.stack(vals) if np.ndim(vals[0]) > 0 else np.asarray(vals)
    return out


def batch_indices(n: int, batch_size: int, *, shuffle: bool, seed: int,
                  epoch: int, host_id: int = 0, num_hosts: int = 1,
                  drop_last: bool = True) -> List[List[int]]:
    """Per-host batches of indices (DistributedSampler semantics: pad to a
    multiple of num_hosts by wrapping, then stride by host)."""
    idx = list(range(n))
    if shuffle:
        random.Random(seed + epoch).shuffle(idx)
    if num_hosts > 1:
        total = -(-n // num_hosts) * num_hosts
        idx = (idx + idx)[:total][host_id::num_hosts]
    batches = [idx[i:i + batch_size] for i in range(0, len(idx), batch_size)]
    if drop_last and batches and len(batches[-1]) < batch_size:
        batches.pop()
    return batches


class MapLoader:
    """Epoch iterator over a map-style dataset with parallel sample loading."""

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = True,
                 seed: int = 0, host_id: int = 0, num_hosts: int = 1,
                 num_workers: int = 8, drop_last: bool = True,
                 prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        n = len(self.dataset)
        per_host = -(-n // self.num_hosts) if self.num_hosts > 1 else n
        return per_host // self.batch_size if self.drop_last else \
            -(-per_host // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        batches = batch_indices(
            len(self.dataset), self.batch_size, shuffle=self.shuffle,
            seed=self.seed, epoch=self.epoch, host_id=self.host_id,
            num_hosts=self.num_hosts, drop_last=self.drop_last)

        def load(batch):
            return collate([self.dataset[i] for i in batch])

        if self.num_workers <= 1:
            for b in batches:
                yield load(b)
            return
        with ThreadPoolExecutor(self.num_workers) as pool:
            pending = [pool.submit(load, b) for b in batches[: self.prefetch + 1]]
            nxt = self.prefetch + 1
            while pending:
                fut = pending.pop(0)
                if nxt < len(batches):
                    pending.append(pool.submit(load, batches[nxt]))
                    nxt += 1
                yield fut.result()


def iter_batches(sample_iter: Iterable[Dict[str, np.ndarray]], batch_size: int
                 ) -> Iterator[Dict[str, np.ndarray]]:
    """Batch a sample generator (streaming/iterable datasets)."""
    buf: List[Dict[str, np.ndarray]] = []
    for s in sample_iter:
        buf.append(s)
        if len(buf) == batch_size:
            yield collate(buf)
            buf = []


class Prefetcher:
    """Background-thread prefetch queue around any batch iterator.

    Producer exceptions are captured and re-raised in the CONSUMER — a
    crashed stream must not masquerade as a clean end of data (the training
    loop would silently stop mid-epoch). :meth:`close` stops the producer
    and closes the iterator it was reading (a generator's open files), so a
    run that stops before its streams end leaves no thread behind."""

    def __init__(self, it: Iterable, depth: int = 2):
        self.it = iter(it)
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._done = object()
        self._error: Optional[BaseException] = None
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _put(self, x) -> bool:
        """Queue ``x`` unless :meth:`close` is called first."""
        while not self._stop.is_set():
            try:
                self.q.put(x, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self):
        try:
            for x in self.it:
                if not self._put(x):
                    break
        except BaseException as e:  # noqa: BLE001 — re-raised in consumer
            self._error = e
        finally:
            close = getattr(self.it, "close", None)
            if close is not None:
                close()
            self._put(self._done)

    def close(self, timeout: float = 10.0) -> None:
        self._stop.set()
        self.thread.join(timeout)

    def __iter__(self):
        while True:
            x = self.q.get()
            if x is self._done:
                if self._error is not None:
                    raise self._error
                return
            yield x
