"""CPU tests of the benchmark's harness: a cell, configuration, traffic mix
and metric written as new files run by name with no edit to the harness;
each driver's set-up, window and check at a tiny width on the CPU (the
kernels' plain versions) end in a result line of the contract's form; the
import rule. Run: ``python -m pytest portbench/tests -q``."""

from __future__ import annotations

import copy
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(ROOT))

from portbench import run as run_mod  # noqa: E402
from portbench.lib import harness  # noqa: E402

TINY_MODEL = {
    "vision": {"width": 64, "depth": 2, "heads": 2, "patch_size": 16, "mlp_ratio": 4.0,
               "ln_eps": 1e-6, "drop_path_rate": 0.1},
    "text": {"vocab": 30522, "hidden": 64, "layers": 3, "fusion_layer": 2, "heads": 2,
             "intermediate": 128, "max_positions": 512, "type_vocab": 2, "ln_eps": 1e-12,
             "hidden_dropout": 0.1, "attn_dropout": 0.1},
    "embed_dim": 32,
}
TINY_YAML = {
    "use_beit_v2": True, "patch_size": 16, "text_encoder": "bert-base-uncased",
    "vision_config_inline": {"vision_width": 64, "patch_size": 16, "num_hidden_layers": 2,
                             "num_attention_heads": 2},
    "text_num_hidden_layers": 3, "text_fusion_start_at": 2, "embed_dim": 32, "temp": 0.07,
    "text_config_inline": {"hidden_size": 64, "num_heads": 2, "intermediate_size": 128,
                           "encoder_width": 64},
    "accelerator": {"MIXED_PRECISION": "bf16"},
}


# the tiny cells' own limits: at width 64 a loss moves more with bf16
# rounding (the ITC loss ~0.4-1% against ~0.02% at the published widths)
TINY_LIMITS = {
    "tiny.pretrain": {"loss_gap": 0.05, "change_gap": 0.27, "loss_median_gap": 0.0034,
                      "change_median_gap": 0.12, "feature_gap": 0.05},
    "tiny.retrieval": {"feature_gap": 0.05, "embed_gap": 0.041, "shortlist_gap": 0.0098,
                       "itm_gap": 0.097},
}


def tiny_tree(tmp_path: Path, traffic_overrides: dict) -> Path:
    """A copy of the benchmark with one more cell ``tiny.<driver>``: its
    configuration, traffic mix, limits and a new per-layer metric, all new
    files, and their BENCHMARK.json entries."""
    root = tmp_path / "checkout"
    bench = root / "portbench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((BENCH / "configs" / "x2vlm_base.json").read_text())
    cfg.update(name="tiny", yaml=TINY_YAML, model=TINY_MODEL)
    (bench / "configs" / "tiny.json").write_text(json.dumps(cfg))
    base_traffic = json.loads((BENCH / "traffic" / f"{traffic_overrides['from']}.json")
                              .read_text())
    traffic = copy.deepcopy(base_traffic)
    traffic.update({k: v for k, v in traffic_overrides.items() if k != "from"})
    (bench / "traffic" / "tiny_mix.json").write_text(json.dumps(traffic))
    cell = f"tiny.{traffic['driver']}"
    (bench / "workloads" / f"{cell}.json").write_text(json.dumps({"limits": TINY_LIMITS[cell]}))
    (bench / "metrics" / "tiny_setup_share.py").write_text(
        "def read(run):\n    return 100.0 * run.setup_s / (run.setup_s + run.window['seconds'])\n")
    manifest["configs"].append({"name": "tiny", "source": "https://arxiv.org/abs/2211.12402",
                                "file": "portbench/configs/tiny.json", "reduced": [],
                                "why": "test"})
    manifest["workloads"].append({"name": cell, "config": "tiny", "traffic": "tiny_mix",
                                  "chips": 1, "why": "test"})
    e2e = [m for m in manifest["end_to_end"] if m["name"] != "setup_s"
           and cell.split(".")[1] in m["name"]][0]
    e2e.setdefault("workloads", []).append(cell)
    manifest["end_to_end"].append({"name": "tiny_setup_share", "unit": "%", "better": "lower",
                                   "bound": 0.25, "source": "host_clock",
                                   "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    return root


def run_cell(root: Path, cell: str, capsys, seconds=1.0, seed=2 ** 31 + 7):
    code = run_mod.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                         "--trace", "0"], root=root, bench=root / "portbench",
                        device=torch.device("cpu"))
    assert code == 0
    out = capsys.readouterr()
    last = json.loads(out.out.strip().splitlines()[-1])
    return last, out.err


TINY_PRETRAIN = {"from": "pretrain_b128", "cell": "pretrain.base", "image_res": 32,
                 "image_batch": 4, "region_batch": 6, "max_images": 3, "pool": 3,
                 "yaml": {**json.loads((BENCH / "traffic" / "pretrain_b128.json").read_text())
                          ["yaml"], "images": {"batch_size": 4}}}


def test_new_files_run_by_name_and_end_in_a_contract_line(tmp_path, capsys):
    root = tiny_tree(tmp_path, TINY_PRETRAIN)
    last, err = run_cell(root, "tiny.pretrain", capsys)
    assert list(last)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(last)[-1] == "checks"
    assert set(last["metrics"]) == {"setup_s", "pretrain_samples_per_s", "tiny_setup_share"}
    for m in last["metrics"].values():
        assert m["value"] > 0 and isinstance(m["unit"], str)
    assert last["device"]["count"] == 1
    assert last["attempted"] >= 1
    # the tiny model at bf16 against the fp32 reference: gaps of rounding
    assert last["correct"], err
    tail = err.splitlines()[-len(last["checks"]):]
    for name, line in zip(last["checks"], tail):
        assert line.startswith(f"{name} ") and " limit " in line


def test_the_command_imports_no_banned_module(tmp_path):
    code = ("import sys; sys.argv=['x']; sys.path.insert(0, %r); import portbench.run, "
            "portbench.drivers.pretrain, portbench.lib.trace; "
            "import x2vlm_tpu_torch.tasks.pretrain, x2vlm_tpu_torch.run; "
            "from portbench.lib import harness; print(harness.banned_modules())" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip() == "[]"


def test_banned_names_are_compared_whole():
    mods = {"x2vlm_tpu_torch": 1, "x2vlm_tpu_torch.ops": 1, "jaxtyping": 1, "flaxen": 1}
    assert harness.banned_modules(mods) == []
    assert harness.banned_modules({**mods, "jax.numpy": 1, "x2vlm_tpu": 1}) == \
        ["jax.numpy", "x2vlm_tpu"]


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        src = path.read_text()
        for name in ("x2vlm_tpu", "jax", "flax", "portbench"):
            assert f"import {name}" not in src and f"from {name}" not in src, (path, name)


TINY_RETRIEVAL = {"from": "flickr_eval_384", "cell": "retrieval.base", "image_res": 32,
                  "images": 6, "captions_per_image": 2, "k_test": 4, "rerank_rows": 2,
                  "batch_size_test": 4, "batch_size_test_text": 4, "check_image_rows": 3,
                  "check_text_rows": 4, "reference_batch": 4, "reference_pairs": 16}


def test_retrieval_cell_runs_by_name_and_ends_in_a_contract_line(tmp_path, capsys):
    root = tiny_tree(tmp_path, TINY_RETRIEVAL)
    last, err = run_cell(root, "tiny.retrieval", capsys)
    assert set(last["metrics"]) == {"setup_s", "retrieval_pairs_per_s", "tiny_setup_share"}
    assert last["attempted"] % (6 * 4 + 12 * 4) == 0
    assert set(last["checks"]) == {"feature_gap", "embed_gap", "shortlist_gap", "itm_gap"}
    assert last["correct"], err


def test_trace_reader_on_a_written_trace():
    """Busy time is the union of device intervals inside the window; a
    port kernel launched inside an attention call's annotation is
    attributed to it, one launched outside is counted, not dropped."""
    from portbench.lib import trace as tl

    tap = tl.KernelTap()
    tap.calls = {0: {"K5": (3.35e9, 0.0)}}   # bound 1 ms of bytes
    tap.kind = {0: "tiny"}
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": tl.WINDOW, "ts": 0, "dur": 10000,
         "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": f"{tl.ATTN}0", "ts": 100, "dur": 50,
         "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 110, "dur": 5,
         "tid": 1, "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 300, "dur": 5,
         "tid": 1, "args": {"correlation": 8}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 3000, "dur": 4000, "tid": 1},
        {"ph": "X", "cat": "kernel", "name": "void (anonymous namespace)::tc::fwd_kernel<4>()",
         "ts": 1000, "dur": 2000, "tid": 9, "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "void tiny_fwd_kernel()", "ts": 2500,
         "dur": 1000, "tid": 9, "args": {"correlation": 8}},
    ]
    tr = tl.Trace(ev, tap)
    assert tr.window_s == pytest.approx(0.01)
    assert tr.busy_s() == pytest.approx(0.0025)
    times, unattributed = tr.attribution()
    assert unattributed == 1 and times[(0, "K5")] == 2000
    assert tr.roofline(("K5", "K6")) == pytest.approx(50.0)
    assert tr.roofline(("K1",)) is None
    bd = tr.breakdown()
    assert bd["idle_gaps"][0][0] == "aten::mm"


def test_a_suffixed_metric_is_read_by_its_base_name():
    """``flash_roofline.retrieval`` has no file of its own: the reader of
    ``flash_roofline`` serves it; the idle share comes from the untraced
    window and the traced device seconds a step."""
    class FakeTrace:
        steps = 3

        def busy_s(self):
            return 1.5

        def roofline(self, kernels):
            return 42.0

    run = harness.Run("x", 1.0, {"seconds": 10.0, "steps": 4}, FakeTrace())
    assert harness.metric_value({"name": "flash_roofline.retrieval"}, run) == 42.0
    assert harness.metric_value({"name": "device_idle_share.pretrain"}, run) == \
        pytest.approx(80.0)
    passes = harness.Run("x", 1.0, {"seconds": 10.0, "passes": 2}, FakeTrace())
    assert harness.metric_value({"name": "device_idle_share.retrieval"}, passes) == \
        pytest.approx(90.0)


def test_host_noise_counts_the_collections_in_its_window():
    import gc

    with harness.HostNoise() as noise:
        gc.collect()
    rec = noise.record
    assert rec["gc_collections"] >= 1 and rec["gc_s"] >= 0.0
    assert rec["steal_cpu_s"] >= 0.0 and rec["wall_s"] > 0.0
    assert noise._gc not in gc.callbacks


def _unchanged_step(self):
    """AdamW's step that reads the gradient and leaves the state as it was."""
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]
    self.count += 1
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


def _half_batch(forward):
    def half(self, batch, *args, **kwargs):
        rows = batch["text_ids"].shape[0] // 2
        region = "idx_to_group_img" in batch
        return forward(self, {k: v if (k == "image" and region) or v is None else v[:rows]
                              for k, v in batch.items()}, *args, **kwargs)
    return half


def _altered_answer(scores):
    """``retrieval_scores`` with one answer of every row altered."""
    def altered(*args, **kwargs):
        i2t, t2i = scores(*args, **kwargs)
        for m in (i2t, t2i):   # each row's first shortlisted answer
            for r in range(m.shape[0]):
                m[r, np.argmax(m[r] != -100.0)] += 1.0
        return i2t, t2i
    return altered



@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_a_broken_training_step_reads_incorrect(tmp_path, capsys, monkeypatch, fault):
    """The timed path broken underneath, the rest of a run as it is:
    ``correct`` comes out false."""
    from x2vlm_tpu_torch.models.heads import XVLMForPretrain
    from x2vlm_tpu_torch.train.optim import AdamW

    if fault == "state_unchanged":
        monkeypatch.setattr(AdamW, "step", _unchanged_step)
    else:
        monkeypatch.setattr(XVLMForPretrain, "forward",
                            _half_batch(XVLMForPretrain.forward))
    root = tiny_tree(tmp_path, TINY_PRETRAIN)
    last, err = run_cell(root, "tiny.pretrain", capsys)
    assert not last["correct"], err
    assert last["failed"] == last["attempted"]


def test_an_altered_answer_reads_incorrect(tmp_path, capsys, monkeypatch):
    from x2vlm_tpu_torch.tasks import retrieval as task

    monkeypatch.setattr(task, "retrieval_scores", _altered_answer(task.retrieval_scores))
    root = tiny_tree(tmp_path, TINY_RETRIEVAL)
    last, err = run_cell(root, "tiny.retrieval", capsys)
    assert not last["correct"], err
