"""retrieval_mfu: the model FLOPs of the window's eval passes (encode and
rerank, forward only, lib/flops.py) over their seconds times the H100's
dense bf16 peak, %."""

from portbench.lib.roofline import BF16_FLOP_PER_S


def read(run):
    if "pairs" not in run.window.get("counts", {}):
        return None
    return 100.0 * run.window["flops"] / (run.window["seconds"] * BF16_FLOP_PER_S)
