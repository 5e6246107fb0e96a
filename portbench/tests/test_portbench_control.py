"""The control, the reference in float8 put in the program's place, comes
out as not correct: at each cell's own size on the card, and, on the CPU,
at a tiny width, where it reads worse than the program on every number of
the median kind."""

from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from portbench.control import control_numbers  # noqa: E402
from portbench.lib import harness  # noqa: E402

SEED = 2 ** 31 + 101


@pytest.fixture
def card():
    """The card, or a skip: decided here, when the test runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs the H100: the control is read at the cell's own size")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("cell", ["pretrain.base", "retrieval.base", "pretrain.large"])
def test_the_control_fails_a_limit_at_the_cells_size(card, cell):
    manifest = harness.load_json(harness.ROOT / "BENCHMARK.json")
    files = harness.cell_files(manifest, cell)
    nums = control_numbers(files, SEED, card)
    limits = files["limits"]
    assert any(v > limits[k] for k, (v, _) in nums.items() if k in limits), nums


@pytest.mark.parametrize("kind", ["pretrain", "retrieval"])
def test_the_control_reads_worse_than_the_program_at_a_tiny_width(kind):
    import test_portbench_harness as th

    over = th.TINY_PRETRAIN if kind == "pretrain" else th.TINY_RETRIEVAL
    cfg = json.loads((BENCH / "configs" / "x2vlm_base.json").read_text())
    cfg.update(yaml=th.TINY_YAML, model=th.TINY_MODEL)
    tr = copy.deepcopy(json.loads((BENCH / "traffic" / f"{over['from']}.json").read_text()))
    tr.update({k: v for k, v in over.items() if k not in ("from", "cell")})
    files = {"config": cfg, "traffic": tr,
             "driver": harness.load_module(BENCH / "drivers" / f"{kind}.py", f"ctl_{kind}")}
    device = torch.device("cpu")
    cell = files["driver"].Cell(cfg, tr, SEED, device)
    cell.setup()
    cell.window(0.0)
    cell.release()
    prog = cell.check()
    ctl = control_numbers(files, SEED, device)
    keys = [k for k in prog if "median" in k] or list(prog)
    assert keys
    for k in keys:
        assert ctl[k][0] > prog[k][0], (k, ctl[k], prog[k])
