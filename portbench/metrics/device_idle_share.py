"""device_idle_share.<suffix>: the share of the untraced window in which
the card ran nothing, %: 1 - (device seconds a step or pass in the traced
sub-window x the steps or passes the window completed) / the window's
seconds. The tracer slows the host, not the card, so the device seconds
carry over; the window is the run's own, untraced."""


def read(run):
    tr, w = run.trace, run.window
    units = w.get("steps", w.get("passes"))
    if tr is None or not getattr(tr, "steps", 0) or not units or w["seconds"] <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.steps * units / w["seconds"])
