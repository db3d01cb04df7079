"""device_idle_pct.serve: the share of the traced stretch of the serving
window in which no device operation ran, in %."""


def read(res, ctx):
    if res.trace is None or res.extra.get("kind") != "serve":
        return None
    return 100.0 * res.trace.idle_share
