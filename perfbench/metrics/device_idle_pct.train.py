"""device_idle_pct.train: the share of one whole traced chunk (its staging,
replays and read-back) in which no device operation ran, in %."""


def read(res, ctx):
    if res.trace is None or res.extra.get("kind") != "train":
        return None
    return 100.0 * res.trace.idle_share
