"""engine.launch_ms_p50: the median of the engine's `engine.launch` span, a
bucket group's graph replays with their copies, in ms (the program's
recorder)."""

from perfbench.harness import recorder


def read(res, ctx):
    return recorder.quantile_ms("engine.launch", 0.5)
