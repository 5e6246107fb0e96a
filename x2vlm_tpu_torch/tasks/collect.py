"""Merging the ranks' eval results (the port's counterpart of
x2vlm_tpu/tasks/collect.py; reference dataset/utils.py:181-267: rank-sharded
JSON files, a barrier and a rank-0 merge with key dedup).

- ``collect_results_fs``: the shared-filesystem merge, the reference's
  protocol: each rank publishes ``{filename}_rank{r}.json`` atomically and
  rank 0 waits for every shard, merges, dedups and writes
  ``{filename}.json``;
- ``collect_results``: the in-memory merge over the process group
  (``all_gather_object``); every rank returns the merged list.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

from x2vlm_tpu_torch.core import mesh

__all__ = ["collect_results_fs", "collect_results", "dedup_by_key"]


def dedup_by_key(results: List[Dict], key: Optional[str]) -> List[Dict]:
    """The first result of each ``key`` value, in order (no key: all)."""
    if not key:
        return results
    seen = set()
    out = []
    for r in results:
        if r[key] not in seen:
            seen.add(r[key])
            out.append(r)
    return out


def collect_results_fs(results: List[Dict], result_dir: str, filename: str,
                       host_id: int, num_hosts: int, dedup_key: Optional[str] = None,
                       timeout_s: float = 600.0) -> Optional[List[Dict]]:
    """Write this rank's shard; rank 0 waits for every shard and merges.
    Returns the merged list on rank 0, None elsewhere."""
    os.makedirs(result_dir, exist_ok=True)
    shard = os.path.join(result_dir, f"{filename}_rank{host_id}.json")
    tmp = shard + ".tmp"
    with open(tmp, "w") as f:
        json.dump(results, f)
    os.replace(tmp, shard)   # atomic publish
    if host_id != 0:
        return None
    merged: List[Dict] = []
    deadline = time.time() + timeout_s
    for h in range(num_hosts):
        path = os.path.join(result_dir, f"{filename}_rank{h}.json")
        while not os.path.exists(path):
            if time.time() > deadline:
                raise TimeoutError(f"missing shard {path}")
            time.sleep(0.5)
        with open(path) as f:
            merged.extend(json.load(f))
    merged = dedup_by_key(merged, dedup_key)
    with open(os.path.join(result_dir, f"{filename}.json"), "w") as f:
        json.dump(merged, f)
    return merged


def collect_results(results: List[Dict], dedup_key: Optional[str] = None) -> List[Dict]:
    """Every rank's results in rank order, deduped by ``dedup_key``; at
    world 1 this rank's."""
    merged: List[Dict] = []
    for part in mesh.all_gather_object(results):
        merged.extend(part)
    return dedup_by_key(merged, dedup_key)
