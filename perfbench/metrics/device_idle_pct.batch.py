"""device_idle_pct.batch: the share of the traced retrieve_many call in which
no device operation ran, in %."""


def read(res, ctx):
    if res.trace is None or res.extra.get("kind") != "batch":
        return None
    return 100.0 * res.trace.idle_share
