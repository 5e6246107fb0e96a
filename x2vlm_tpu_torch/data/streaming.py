"""The streaming line reader of pretraining (the port's counterpart of
x2vlm_tpu/data/streaming.py; reference dataset/dist_dataset.py:19-104), for
one host and one reader: the files shuffled by ``seed + epoch``, repeated
epoch after epoch, read line by line, with a checkpointable cursor:
``state()`` -> {epoch, file_idx, line_idx} and
``DistLineReader(..., start_state=...)`` resumes mid-epoch. The JAX
package's split of the files over hosts and workers comes with multi-GPU
training (ROADMAP A4). Local paths only (core/io.py)."""

from __future__ import annotations

import glob
import json
import os
import random
from typing import Dict, Iterator, List, Optional, Sequence

from x2vlm_tpu_torch.core.io import hopen, require_local

__all__ = ["list_data_files", "DistLineReader"]


def list_data_files(paths: Sequence[str]) -> List[str]:
    """Expand directories / globs into files; drop _SUCCESS markers."""
    out: List[str] = []
    for p in paths:
        require_local(p)
        if os.path.isdir(p):
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


class DistLineReader:
    """Iterates the non-empty lines of the files, epoch after epoch."""

    def __init__(self, paths: Sequence[str], seed: int = 0,
                 start_state: Optional[Dict] = None):
        self.files = list_data_files(paths)
        if not self.files:
            raise ValueError(f"no data files in {paths}")
        self.seed = seed
        self._state = dict(start_state or {"epoch": 0, "file_idx": 0, "line_idx": 0})

    def state(self) -> Dict:
        return dict(self._state)

    def _epoch_files(self, epoch: int) -> List[str]:
        files = list(self.files)
        random.Random(self.seed + epoch).shuffle(files)
        return files

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
