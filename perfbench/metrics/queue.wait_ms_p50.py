"""queue.wait_ms_p50: the median of the requests' `queue.wait` span, from
submit() to the cut of their flush, in ms (the program's recorder)."""

from perfbench.harness import recorder


def read(res, ctx):
    return recorder.quantile_ms("queue.wait", 0.5)
