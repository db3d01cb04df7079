"""queue.serve_p95_ms: the 95th percentile of every request's latency over
the untraced window, from when it was due to its resolved future, in ms.
At the cell's rate it is set by the requests that queue behind the
interpreter's full collections, so it swings from run to run more than a
bound can hold; it is read here, beside the queue's own numbers."""


def read(res, ctx):
    return res.extra.get("p95_ms") if res.extra.get("kind") == "serve" else None
