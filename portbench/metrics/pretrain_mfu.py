"""pretrain_mfu: the model FLOPs of the steps the window completed
(lib/flops.py: forward x 3, recomputation not counted) over the window's
seconds times the H100's dense bf16 peak, %."""

from portbench.lib.roofline import BF16_FLOP_PER_S


def read(run):
    if "samples" not in run.window.get("counts", {}):
        return None
    return 100.0 * run.window["flops"] / (run.window["seconds"] * BF16_FLOP_PER_S)
