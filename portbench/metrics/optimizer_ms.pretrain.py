"""optimizer_ms.pretrain: device milliseconds a step of the kernels that
AdamW's step launches, over the traced steps."""


def read(run):
    tr = run.trace
    if tr is None:
        return None
    seconds, calls = tr.annotated_device_s("portbench.optimizer")
    return None if calls == 0 else 1e3 * seconds / calls
