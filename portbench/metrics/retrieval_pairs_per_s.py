"""retrieval_pairs_per_s: ITM pairs scored, both directions, over the
window's complete eval passes, over those passes' wall time."""


def read(run):
    n = run.window.get("counts", {}).get("pairs")
    return None if n is None else n / run.window["seconds"]
