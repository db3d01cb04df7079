"""engine.dispatch_ms_p50: the median host time of the engine's
`retrieve_many_device` calls over the window (bucketing, staging, replays
enqueued), timed by the benchmark around the engine's method, in ms."""

import numpy as np


def read(res, ctx):
    calls = res.extra.get("dispatch_s") if res.extra.get("kind") == "serve" else None
    return None if not calls else float(np.percentile(np.asarray(calls) * 1e3, 50))
