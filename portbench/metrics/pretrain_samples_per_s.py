"""pretrain_samples_per_s: text rows of both streams (image-text and
region-text) over every step the window completed, over the window's wall
time, which ends when the card has finished."""


def read(run):
    n = run.window.get("counts", {}).get("samples")
    return None if n is None else n / run.window["seconds"]
