"""flash_roofline.<suffix>: the flash attention kernels' (K1-K4) share of their
roofline over the traced sub-window: the sum of each call's bound over the
sum of its kernels' device time, %."""


def read(run):
    return None if run.trace is None else run.trace.roofline(("K1", "K2", "K3", "K4"))
