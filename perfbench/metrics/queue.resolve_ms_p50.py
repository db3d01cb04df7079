"""queue.resolve_ms_p50: the median of the flushes' `queue.resolve` span, from
the plan put on the resolver queue to the flush's last future set (the wait
for a free resolver and the engine's gather inside), in ms (the program's
recorder)."""

from perfbench.harness import recorder


def read(res, ctx):
    return recorder.quantile_ms("queue.resolve", 0.5)
