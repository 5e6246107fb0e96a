"""Readings that set a cell's limits on the card, in one process:

    python3 portbench/control.py --workload <cell> --program-seeds <n> ... \
        --control-seeds <n> ... [--fault-seeds <n> ...] [--out <file.json>]

For each program seed: the cell's set-up (the timed path at the cell's
sizes), the program's state freed, and the numbers that decide ``correct``
against the plain reference (the lower readings). For each control seed:
the control, the reference in float8 put in the program's place, read the
same way (the upper readings). For each fault seed of a training cell: the
fault "half of the batch left out, the mean taken over the rest", planted
in the reference put in the program's place. No timed window runs. The
card test ``tests/test_portbench_control.py`` calls :func:`control_numbers`.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.lib import harness  # noqa: E402


def halved(pool):
    """The pool's batches with the second half of their text rows left out
    (the images of a region batch kept)."""
    out = []
    for batches in pool:
        part = []
        for b in batches:
            rows = b["text_ids"].shape[0] // 2
            part.append({k: (v if k == "image" and "idx_to_group_img" in b else v[:rows])
                         for k, v in b.items()})
        out.append(part)
    return out


def control_numbers(files, seed: int, device, reference=None):
    """{number: (value, where)} of the control at ``seed``, at the cell's
    sizes: the reference in float8 put in the program's place and judged
    against the reference; for a training cell, with ``reference`` set to
    a pool transform (:func:`halved`), that fault planted in the reference
    put in the program's place instead. A training cell's readings that are
    not compared come with them."""
    driver = files["driver"]
    cell = driver.Cell(files["config"], files["traffic"], seed, device)
    if files["traffic"]["driver"] != "pretrain":
        gallery = driver.make_gallery(cell.tr, cell.m["text"]["vocab"], seed)
        ctl = driver.control_outputs(cell.m, cell.tr, gallery, seed, device)
        ref = driver.reference_outputs(cell.m, cell.tr, gallery, seed, device, ctl)
        return driver.numbers(ctl, ref)
    pool = driver.make_pool(cell.tr, cell.m["text"]["vocab"], seed)
    if reference is None:
        judged = driver.reference_readings(cell.m, cell.tr, pool, seed, device, cell.fresh,
                                           lowp=True)
    else:
        judged = driver.reference_readings(cell.m, cell.tr, reference(pool), seed, device,
                                           cell.fresh)
    ref = driver.reference_readings(cell.m, cell.tr, pool, seed, device, cell.fresh,
                                    first_grad=judged["first_grad"])
    return {**driver.numbers(judged, ref), **driver.not_compared(judged, ref)}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--program-seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[],
                   help="seeds of the half-batch fault (training cells)")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    harness.env_caches()
    manifest = harness.load_json(harness.ROOT / "BENCHMARK.json")
    files = harness.cell_files(manifest, args.workload)
    import torch
    device = torch.device("cuda", 0)
    driver = files["driver"]
    result = {"cell": args.workload, "program": {}, "control": {}, "half_batch": {}}

    def show(kind, seed, nums):
        flat = {k: v[0] for k, v in nums.items()}
        result[kind][str(seed)] = {k: list(v) for k, v in nums.items()}
        print(f"{kind} seed {seed}: {json.dumps(flat)}", flush=True)

    for seed in args.program_seeds:
        t0 = time.time()
        cell = driver.Cell(files["config"], files["traffic"], seed, device)
        cell.setup()
        cell.release()
        nums = cell.check()
        if hasattr(driver, "not_compared"):
            nums.update(driver.not_compared(cell.readings, cell.ref))
        show("program", seed, nums)
        del cell
        torch.cuda.empty_cache()
        print(f"  {time.time() - t0:.1f} s", flush=True)
    for seed in args.control_seeds:
        show("control", seed, control_numbers(files, seed, device))
        torch.cuda.empty_cache()
    for seed in args.fault_seeds:
        show("half_batch", seed, control_numbers(files, seed, device, reference=halved))
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
