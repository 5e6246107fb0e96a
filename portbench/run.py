"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cards the cell asks for.
Set-up (from process start: imports, the kernels' load or first build,
model, seeded weights, pool, the checked first steps) is ``setup_s``; then
the cell's driver measures for ``--seconds``. With ``--trace 1`` a short
traced sub-window follows and the per-layer metrics are reported instead
of the end-to-end ones. After that the program's state is freed and the
plain reference decides ``correct``. Every number compared is printed with
its limit on standard error and, under ``checks``, at the end of the
result line, which is the last line of standard output. Exits 2 without a
result when the cards are missing, and 3 when a banned module (JAX, flax,
the JAX package) was loaded.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.lib import harness  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(code: int, msg: str):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None, *, root=harness.ROOT, bench=harness.BENCH, device=None) -> int:
    """``root`` / ``bench``: where BENCHMARK.json and the benchmark's files
    are; ``device``: tests only, a device to run on without looking for
    the card (the CPU, with the kernels' plain versions)."""
    args = parse(argv)
    harness.env_caches(root)
    manifest = harness.load_json(root / "BENCHMARK.json")
    files = harness.cell_files(manifest, args.workload, bench, root)
    chips = int(files["workload"]["chips"])

    import torch

    if device is None:
        if not torch.cuda.is_available():
            fail(2, "no CUDA device: this benchmark measures the port on the card")
        if torch.cuda.device_count() < chips:
            fail(2, f"{torch.cuda.device_count()} CUDA devices, the cell asks for {chips}")
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        kind = torch.cuda.get_device_name(device)
    else:
        kind = str(device)
    print(f"portbench: {args.workload} seed {args.seed} on {kind} x {chips}",
          file=sys.stderr, flush=True)

    cell = files["driver"].Cell(files["config"], files["traffic"], args.seed, device)
    cell.setup()
    harness.sync(device)
    setup_s = time.time() - T_START
    print(f"portbench: setup_s {setup_s:.3f}", file=sys.stderr, flush=True)
    with harness.HostNoise() as noise:
        window = cell.window(args.seconds)
    print(f"portbench: window {json.dumps(window)}", file=sys.stderr, flush=True)
    print(f"portbench: host {json.dumps(noise.record)}", file=sys.stderr, flush=True)
    trace = cell.trace() if args.trace else None
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    run = harness.Run(args.workload, setup_s, window, trace)

    group = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in manifest[group]:
        if not harness.applies(m, args.workload, manifest):
            continue
        value = harness.metric_value(m, run, bench)
        if value is None:
            if group == "end_to_end":
                fail(1, f"{m['name']}: nothing to read in this cell")
            print(f"portbench: {m['name']}: nothing to read", file=sys.stderr)
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu", "kind": kind, "count": chips, "memory_peak_bytes": peak}
    breakdown = None
    if trace is not None:
        device_info["busy_s"] = trace.busy_s()
        device_info["window_s"] = trace.window_s
        _, unattributed = trace.attribution()
        print(f"portbench: port-kernel launches attributed to no call: {unattributed}",
              file=sys.stderr)
        breakdown = trace.breakdown()

    cell.release()
    numbers = cell.check()
    limits = files["limits"]
    for name, (value, where) in numbers.items():
        if name not in limits:
            print(f"portbench: reading {name} {value!r} (at {where}), not compared",
                  file=sys.stderr)
    checks, correct = [], True
    for name, limit in limits.items():
        value, where = numbers[name]
        ok = math.isfinite(value) and value <= limit
        correct &= ok
        checks.append((name, value, limit))
        print(f"portbench: check {name} {value!r} (at {where}) limit {limit!r} "
              f"{'ok' if ok else 'FAILED'}", file=sys.stderr)
    banned = harness.banned_modules()
    if banned:
        fail(3, f"banned modules loaded: {banned}")
    attempted = window.get("attempted", 1)
    failed = 0 if correct else attempted
    for name, value, limit in checks:
        print(f"{name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(harness.result_line(correct, attempted, failed, metrics, device_info, checks,
                              breakdown), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
