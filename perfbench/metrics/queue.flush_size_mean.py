"""queue.flush_size_mean: requests per flush of the AsyncRetrievalEngine over
the window (its own `stats()["batch_size_mean"]`)."""


def read(res, ctx):
    st = res.extra.get("stats") if res.extra.get("kind") == "serve" else None
    return None if not st or "batch_size_mean" not in st else st["batch_size_mean"]
