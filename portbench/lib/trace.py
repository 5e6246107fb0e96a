"""The traced sub-window: torch.profiler over a few steps or one pass, and
what the harness reads from its trace.

:class:`KernelTap` wraps the port's attention-kernel wrappers for the
traced sub-window only: each call runs inside a profiler annotation
``portbench.attn.<n>`` and records the call's bound per kernel
(``lib/roofline.py``), so every kernel launched inside the annotation is
attributed to its call and shapes. :func:`annotate` wraps any callable of
the program the same way (a driver names the optimizer's step with it).

:func:`traced` runs a callable under the profiler inside the annotation
``portbench.window`` (the card synchronised at both ends), writes the
chrome trace under ``TMPDIR`` and returns a :class:`Trace`, which reads:
the device's busy seconds (the union of kernel, copy and set intervals
inside the window), the window's seconds, the device seconds attributed
to an annotation, the attention kernels' roofline shares, the launches of
the port's kernels that no call claims, and the breakdown of device time
by kernel and of idle gaps by what the host was doing.
"""

from __future__ import annotations

import bisect
import collections
import functools
import itertools
import json
import os
import re
import tempfile
from typing import Callable, Dict, List, Optional, Tuple

import torch

from portbench.lib import roofline

__all__ = ["KernelTap", "Trace", "annotate", "traced", "PORT_KERNEL"]

# the symbols of the port's hand-written kernels (x2vlm_tpu_torch/csrc/*.cu)
PORT_KERNEL = re.compile(r"flash_(fwd|bwd)\w*_kernel|\btc::\w+_kernel|tiny_(fwd|bwd)\w*_kernel"
                         r"|dbias_sum_kernel|quantize_rows_kernel|gemm_kernel")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW = "portbench.window"
ATTN = "portbench.attn."


def _flash_kernel(name: str) -> str:
    if "dbias" in name:
        return "K4"
    if "dkv" in name:
        return "K3"
    if "dq" in name:
        return "K2"
    return "K1"


class KernelTap:
    """Context manager: the port's flash and tiny attention wrappers, as
    the layers and autograd functions call them (module attributes),
    replaced by annotated, bound-recording ones."""

    def __init__(self):
        self.calls: Dict[int, Dict[str, Tuple[float, float]]] = {}
        self.kind: Dict[int, str] = {}
        self._ids = itertools.count()
        self._saved = []

    def _wrap(self, module, attr: str, kind: str, bounds: Callable):
        orig = getattr(module, attr)

        def tapped(*args, **kwargs):
            n = next(self._ids)
            self.calls[n] = bounds(*args, **kwargs)
            self.kind[n] = kind
            with torch.profiler.record_function(f"{ATTN}{n}"):
                return orig(*args, **kwargs)

        # the wrapper counts its launches through its own module name: the
        # tapped one carries the same counters
        functools.update_wrapper(tapped, orig)
        self._saved.append((module, attr, orig))
        setattr(module, attr, tapped)

    def __enter__(self):
        from x2vlm_tpu_torch.ops import flash_attention as fa, tiny_attention as ta

        def flash_fwd(q, k, v, bias=None, key_mask=None, causal=False, scale=1.0):
            return {"K1": roofline.flash_fwd(q, k, v, bias, key_mask)}

        def flash_bwd(q, k, v, bias, key_mask, out, lse, dout, causal=False, scale=1.0,
                      need_dbias=True):
            b = roofline.flash_bwd(q, k, v, bias, key_mask, dbias=need_dbias)
            return {"K2": b["dq"], "K3": b["dkv"], **({"K4": b["dbias"]} if "dbias" in b
                                                      else {})}

        def tiny_fwd(q, k, v, num_heads, key_mask=None, dmask=None, scale=1.0,
                     return_probs=False):
            return {"K5": roofline.tiny_fwd(q, k, v, num_heads, key_mask, dmask, return_probs)}

        def tiny_bwd(q, k, v, probs, dmask, g, num_heads, scale=1.0, out=None):
            return {"K6": roofline.tiny_bwd(q, k, v, num_heads, dmask, probs)}

        self._wrap(fa, "flash_attention_fwd", "flash", flash_fwd)
        self._wrap(fa, "flash_attention_bwd", "flash", flash_bwd)
        self._wrap(ta, "tiny_attention_fwd", "tiny", tiny_fwd)
        self._wrap(ta, "tiny_attention_bwd", "tiny", tiny_bwd)
        return self

    def __exit__(self, *exc):
        for module, attr, orig in reversed(self._saved):
            setattr(module, attr, orig)
        self._saved.clear()


def annotate(obj, attr: str, label: str):
    """Replace ``obj.attr`` by a version that runs inside the profiler
    annotation ``label``; returns a function that puts the original back."""
    orig = getattr(obj, attr)

    def annotated(*args, **kwargs):
        with torch.profiler.record_function(label):
            return orig(*args, **kwargs)

    setattr(obj, attr, annotated)
    return lambda: setattr(obj, attr, orig)


class _Intervals:
    """Host intervals of one kind, by thread, for lookup (nested ones too)."""

    def __init__(self, events):
        by_tid = collections.defaultdict(list)
        for e in events:
            by_tid[e["tid"]].append((e["ts"], e["ts"] + e["dur"], e))
        self.by_tid = {t: sorted(v, key=lambda x: x[0]) for t, v in by_tid.items()}
        self.starts = {t: [x[0] for x in v] for t, v in self.by_tid.items()}

    def find(self, tid, ts):
        """The innermost interval of ``tid`` that holds ``ts``, or None."""
        v = self.by_tid.get(tid)
        if not v:
            return None
        i = bisect.bisect_right(self.starts[tid], ts) - 1
        for j in range(i, max(i - 64, -1), -1):
            if v[j][1] >= ts:
                return v[j][2]
        return None


class Trace:
    def __init__(self, events: List[Dict], tap: Optional[KernelTap] = None):
        x = [e for e in events if e.get("ph") == "X" and "dur" in e]
        windows = [e for e in x if e.get("cat") == "user_annotation" and e["name"] == WINDOW]
        if not windows:
            raise RuntimeError(f"the trace holds no {WINDOW} annotation")
        w = windows[0]
        self.w0, self.w1, self.main_tid = w["ts"], w["ts"] + w["dur"], w["tid"]
        self.window_s = w["dur"] * 1e-6
        device = [e for e in x if e.get("cat") in DEVICE_CATS
                  and e["ts"] < self.w1 and e["ts"] + e["dur"] > self.w0]
        self.kernels = [e for e in device if e.get("cat") == "kernel"]
        self.device = device
        launch = {e["args"]["correlation"]: e for e in x
                  if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
        self.launch_of = {}
        for k in self.kernels:
            c = k.get("args", {}).get("correlation")
            if c in launch:
                self.launch_of[id(k)] = launch[c]
        annotations = [e for e in x if e.get("cat") == "user_annotation"]
        self.annotations = annotations
        self.tap = tap
        self._attn = _Intervals([e for e in annotations if e["name"].startswith(ATTN)])
        self.host_ops = _Intervals([e for e in x if e.get("cat") in ("cpu_op", "user_annotation")
                                    and e["tid"] == self.main_tid and e["name"] != WINDOW])

    # ---------- the device ----------

    def busy_s(self) -> float:
        spans = sorted((max(e["ts"], self.w0), min(e["ts"] + e["dur"], self.w1))
                       for e in self.device)
        busy, end = 0.0, self.w0
        for lo, hi in spans:
            if hi <= end:
                continue
            busy += hi - max(lo, end)
            end = hi
        return busy * 1e-6

    def gaps(self) -> List[Tuple[float, float]]:
        spans = sorted((max(e["ts"], self.w0), min(e["ts"] + e["dur"], self.w1))
                       for e in self.device)
        out, end = [], self.w0
        for lo, hi in spans:
            if lo > end:
                out.append((end, lo))
            end = max(end, hi)
        if end < self.w1:
            out.append((end, self.w1))
        return out

    def annotated_device_s(self, label: str) -> Tuple[float, int]:
        """(device seconds of the kernels launched inside annotations named
        ``label``, the number of such annotations in the window)."""
        spans = _Intervals([e for e in self.annotations if e["name"] == label])
        n = sum(1 for e in self.annotations if e["name"] == label
                and self.w0 <= e["ts"] <= self.w1)
        total = 0.0
        for k in self.kernels:
            la = self.launch_of.get(id(k))
            if la is not None and spans.find(la["tid"], la["ts"]) is not None:
                total += k["dur"]
        return total * 1e-6, n

    # ---------- the attention kernels ----------

    def attribution(self):
        """({(call, kernel): device us}, port-kernel launches claimed by
        no call)."""
        times = collections.Counter()
        unattributed = 0
        for k in self.kernels:
            if not PORT_KERNEL.search(k["name"]):
                continue
            la = self.launch_of.get(id(k))
            ann = None if la is None else self._attn.find(la["tid"], la["ts"])
            if ann is None or self.tap is None:
                unattributed += 1
                continue
            n = int(ann["name"][len(ATTN):])
            kind = self.tap.kind.get(n)
            kern = _flash_kernel(k["name"]) if kind == "flash" else \
                ("K6" if "bwd" in k["name"] else "K5")
            times[(n, kern)] += k["dur"]
        return times, unattributed

    def roofline(self, kernels) -> Optional[float]:
        """Sum of the bounds over sum of the device times of every call's
        launches of ``kernels`` (e.g. ("K5", "K6")), in %; None if none ran."""
        times, _ = self.attribution()
        bound = spent = 0.0
        for (n, kern), us in times.items():
            if kern not in kernels:
                continue
            b, f = self.tap.calls[n][kern]
            bound += roofline.bound_ms(b, f)[0]
            spent += us * 1e-3
        return None if spent == 0.0 else 100.0 * bound / spent

    # ---------- breakdown ----------

    @staticmethod
    def _short(name: str) -> str:
        name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
        name = re.split(r"[<(]", name, maxsplit=1)[0]
        return name[:120]

    def breakdown(self) -> Dict[str, List]:
        ops = collections.Counter()
        for e in self.device:
            ops[self._short(e["name"])] += min(e["ts"] + e["dur"], self.w1) - max(e["ts"],
                                                                                 self.w0)
        idle = collections.Counter()
        for lo, hi in self.gaps():
            host = self.host_ops.find(self.main_tid, (lo + hi) / 2)
            idle["python" if host is None else self._short(host["name"])] += hi - lo
        top = lambda c: [[k, v * 1e-6] for k, v in c.most_common(10)]
        return {"device_ops": top(ops), "idle_gaps": top(idle)}


def traced(fn: Callable[[], None], tap: Optional[KernelTap] = None,
           warm: Optional[Callable[[], None]] = None) -> Trace:
    """Run ``fn`` under torch.profiler inside the window annotation, after
    ``warm`` (default ``fn``) has run once under the profiler's warm-up,
    whose events are dropped: the tracer's own start-up stays out of the
    window. The trace is written under TMPDIR and read back."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fd, path = tempfile.mkstemp(prefix="portbench_trace_", suffix=".json")
    os.close(fd)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    try:
        with profile(activities=acts, record_shapes=False,
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
            (warm or fn)()
            torch.cuda.synchronize()
            prof.step()
            with torch.profiler.record_function(WINDOW):
                fn()
                torch.cuda.synchronize()
            prof.step()
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return Trace(events, tap)
