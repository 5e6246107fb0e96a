"""setup_s: seconds from process start to the first timed step or pass
(imports, the kernels' load or build, model, weights, traffic, warm-up)."""


def read(run):
    return run.setup_s
