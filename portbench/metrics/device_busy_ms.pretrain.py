"""device_busy_ms.pretrain: device milliseconds a step in the traced
sub-window (the union of kernel, copy and set intervals over the steps
traced). The tracer slows the host, not the card: with the untraced
window's step time it gives the untraced idle share."""


def read(run):
    tr = run.trace
    if tr is None or not getattr(tr, "steps", 0):
        return None
    return 1e3 * tr.busy_s() / tr.steps
