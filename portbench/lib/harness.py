"""The harness: it finds a cell's configuration, traffic, driver, limits and
metric readers by the names in ``BENCHMARK.json``, runs the cell once and
prints the contract's result line.

Everything that belongs to one configuration, traffic mix, cell or metric
is a file of its own, found by name:

- ``configs/<config>.json``: the configuration (the ``file`` of its entry);
- ``traffic/<traffic>.json``: the mix's parameters; its ``driver`` names
  ``drivers/<driver>.py``, the general code of one kind of job;
- ``workloads/<cell>.json``: the cell's limits on the numbers that decide
  ``correct``;
- ``metrics/<metric>.py``: a reader, ``read(run) -> float or None``; a
  metric ``<name>.<suffix>`` without a file of its own is read by
  ``metrics/<name>.py``.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import resource
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

__all__ = ["ROOT", "BENCH", "HostNoise", "Run", "applies", "banned_modules", "cell_files",
           "load_json", "load_module", "metric_value", "result_line", "sync"]

BENCH = Path(__file__).resolve().parents[1]        # portbench/
ROOT = BENCH.parent                                # the checkout
BANNED = ("jax", "jaxlib", "flax", "x2vlm_tpu")    # top-level names, compared whole


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_files(manifest: Dict, cell: str, bench: Path = BENCH, root: Path = ROOT) -> Dict:
    """The workload entry, its configuration entry and file, its traffic
    file, its driver module and its limits, found by name."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if cell not in cells:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[cell]
    configs = {c["name"]: c for c in manifest["configs"]}
    c = configs[w["config"]]
    traffic = load_json(bench / "traffic" / f"{w['traffic']}.json")
    driver = load_module(bench / "drivers" / f"{traffic['driver']}.py",
                         f"portbench_driver_{traffic['driver']}")
    return {"workload": w, "config_entry": c, "config": load_json(root / c["file"]),
            "traffic": traffic, "driver": driver,
            "limits": load_json(bench / "workloads" / f"{cell}.json")["limits"]}


def applies(metric: Dict, cell: str, manifest: Dict) -> bool:
    """Whether ``metric`` is reported in ``cell``: the cells its
    ``workloads`` lists; without the key, every cell (an end-to-end
    metric) or every cell that reports the metric it moves (per layer)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        target = [m for m in manifest["end_to_end"] if m["name"] == metric["moves"]]
        return bool(target) and applies(target[0], cell, manifest)
    return True


def sync(device) -> None:
    """Wait for the card (nothing to wait for on the CPU)."""
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Run:
    """What a run measured, for the metric readers: ``setup_s``, the
    window's ``window`` record (seconds, counts, flops, spans), the traced
    sub-window's ``trace`` (lib/trace.Trace, or None) and the cell's name."""

    def __init__(self, cell: str, setup_s: float, window: Dict, trace=None):
        self.cell, self.setup_s, self.window, self.trace = cell, setup_s, window, trace


def metric_value(metric: Dict, run: Run, bench: Path = BENCH) -> Optional[float]:
    """The metric's reader: ``metrics/<name>.py``, or, where there is none,
    the reader of the name without its last suffix (``flash_roofline.py``
    for ``flash_roofline.retrieval``), which serves every suffix."""
    name = metric["name"]
    path = bench / "metrics" / f"{name}.py"
    if not path.is_file() and "." in name:
        name = name.rsplit(".", 1)[0]
        path = bench / "metrics" / f"{name}.py"
    reader = load_module(path, "portbench_metric_" + name.replace(".", "_"))
    return reader.read(run)


def banned_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name is a banned one, whole."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in list(modules) if m.split(".", 1)[0] in BANNED})


def result_line(correct: bool, attempted: int, failed: int, metrics: Dict, device: Dict,
                checks: List, breakdown: Optional[Dict] = None) -> str:
    """The last line of standard output; ``checks`` (name, value, limit)
    comes last."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in checks}
    return json.dumps(out)


def _steal_s() -> float:
    """CPU seconds the hypervisor has taken from this machine, over all its
    CPUs (``steal`` of /proc/stat; 0 where there is no such file)."""
    try:
        with open("/proc/stat") as f:
            return int(f.readline().split()[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        return 0.0


class HostNoise:
    """What took the host from the program in a window, for the record:
    Python's garbage collections (count, seconds), the CPU seconds stolen
    from the machine by its hypervisor (all CPUs), the process's
    involuntary context switches and its CPU seconds against the wall's."""

    def __enter__(self):
        self.gc_n, self.gc_s, self._t = 0, 0.0, 0.0
        gc.callbacks.append(self._gc)
        self._steal, self._wall = _steal_s(), time.time()
        self._cpu, self._ivcsw = time.process_time(), resource.getrusage(
            resource.RUSAGE_SELF).ru_nivcsw
        return self

    def _gc(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.gc_n += 1
            self.gc_s += time.perf_counter() - self._t

    def __exit__(self, *exc):
        gc.callbacks.remove(self._gc)
        self.record = {
            "gc_collections": self.gc_n, "gc_s": self.gc_s,
            "steal_cpu_s": _steal_s() - self._steal,
            "involuntary_switches": resource.getrusage(resource.RUSAGE_SELF).ru_nivcsw
            - self._ivcsw,
            "process_cpu_s": time.process_time() - self._cpu, "wall_s": time.time() - self._wall}


def env_caches(root: Path = ROOT) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port builds its kernels under ``build/x2vlm_tpu_torch`` there by
    itself); no library loads JAX on its own."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
