"""The streaming line reader of pretraining (the port's counterpart of
x2vlm_tpu/data/streaming.py; reference dataset/dist_dataset.py:19-104): the
files shuffled by ``seed + epoch``, this rank's contiguous share of them
taken (``split_shard`` over ``world_size`` ranks, as the JAX package splits
them over hosts), repeated epoch after epoch and read line by line, with a
checkpointable cursor: ``state()`` -> {epoch, file_idx, line_idx} (an index
into the rank's own files) and ``DistLineReader(..., start_state=...)``
resumes mid-epoch. ``hdfs://`` and ``gs://`` paths list and stream through
core/io.py."""

from __future__ import annotations

import glob
import json
import os
import random
from typing import Dict, Iterator, List, Optional, Sequence

from x2vlm_tpu_torch.core.io import hlist_files, hopen, is_remote

__all__ = ["list_data_files", "split_shard", "DistLineReader"]


def list_data_files(paths: Sequence[str]) -> List[str]:
    """Expand directories / globs into files; drop _SUCCESS markers. A
    remote path lists through ``hlist_files``."""
    out: List[str] = []
    for p in paths:
        if is_remote(p):
            listed = sorted(f for f in hlist_files([p])
                            if not os.path.basename(f).startswith(("_", ".")))
            if not listed:
                raise FileNotFoundError(p)
            out.extend(listed)
        elif os.path.isdir(p):
            out.extend(sorted(
                os.path.join(p, f) for f in os.listdir(p)
                if not f.startswith("_") and not f.startswith(".")))
        elif any(c in p for c in "*?["):
            out.extend(sorted(glob.glob(p)))
        elif os.path.exists(p):
            out.append(p)
        else:
            raise FileNotFoundError(p)
    return out


def split_shard(items: Sequence, shard_id: int, num_shards: int) -> List:
    """The contiguous ``shard_id``-th of ``num_shards`` parts of ``items``
    (reference dist_dataset.py:98-104); parts differ by at most one item."""
    if num_shards <= 1:
        return list(items)
    per = len(items) / num_shards
    return list(items[round(per * shard_id):round(per * (shard_id + 1))])


class DistLineReader:
    """Iterates the non-empty lines of rank ``rank``'s share of the files,
    epoch after epoch."""

    def __init__(self, paths: Sequence[str], seed: int = 0,
                 start_state: Optional[Dict] = None, rank: int = 0, world_size: int = 1):
        self.files = list_data_files(paths)
        if not self.files:
            raise ValueError(f"no data files in {paths}")
        if len(self.files) < world_size:
            raise ValueError(f"{len(self.files)} data files in {paths} cannot give each of "
                             f"{world_size} ranks a share")
        self.seed = seed
        self.rank, self.world_size = rank, world_size
        self._state = dict(start_state or {"epoch": 0, "file_idx": 0, "line_idx": 0})

    def state(self) -> Dict:
        return dict(self._state)

    def _epoch_files(self, epoch: int) -> List[str]:
        files = list(self.files)
        random.Random(self.seed + epoch).shuffle(files)
        return split_shard(files, self.rank, self.world_size)

    def __iter__(self) -> Iterator[str]:
        epoch = self._state["epoch"]
        file_idx = self._state["file_idx"]
        line_idx = self._state["line_idx"]
        while True:
            files = self._epoch_files(epoch)
            while file_idx < len(files):
                with hopen(files[file_idx], "r") as f:
                    for i, line in enumerate(f):
                        if i < line_idx:
                            continue
                        self._state = {"epoch": epoch, "file_idx": file_idx,
                                       "line_idx": i + 1}
                        line = line.strip()
                        if line:
                            yield line
                file_idx += 1
                line_idx = 0
            epoch += 1
            file_idx = 0
            line_idx = 0
            self._state = {"epoch": epoch, "file_idx": 0, "line_idx": 0}

    def iter_json(self) -> Iterator[dict]:
        """The lines parsed as JSON; a line that does not parse is skipped
        (reference pretrain_dataset.py:236-240)."""
        for line in self:
            try:
                yield json.loads(line)
            except json.JSONDecodeError:
                continue
