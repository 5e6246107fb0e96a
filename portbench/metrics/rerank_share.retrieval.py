"""rerank_share.retrieval: the window's rerank seconds (``retrieval_scores``)
over its pass seconds (``encode_corpus`` and ``retrieval_scores``), each
call timed by the harness with the card synchronised at its end, %."""


def read(run):
    spans = run.window.get("spans", {})
    if "rerank_s" not in spans:
        return None
    return 100.0 * spans["rerank_s"] / (spans["rerank_s"] + spans["encode_s"])
