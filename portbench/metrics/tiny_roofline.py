"""tiny_roofline.<suffix>: the tiny attention kernels' (K5, K6) share of their
roofline over the traced sub-window: the sum of each call's bound over the
sum of its kernels' device time, %."""


def read(run):
    return None if run.trace is None else run.trace.roofline(("K5", "K6"))
