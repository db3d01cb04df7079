"""engine.gather_ms_p50: the median self time of the engine's `engine.gather`
span (finalize_many less its `engine.wait` event waits: the host's stacking
of rows), in ms (the program's recorder)."""

from perfbench.harness import recorder


def read(res, ctx):
    return recorder.quantile_ms("engine.gather", 0.5, self_time=True)
