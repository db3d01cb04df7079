"""mfu.train: the frozen stage-2 step FLOP count times the window's steps,
over the window's time and the card's dense bf16 peak (989 TFLOP/s), in %."""

from perfbench.harness.flops import PEAK_FLOPS


def read(res, ctx):
    x = res.extra
    if x.get("kind") != "train":
        return None
    return 100.0 * x["flops_per_step"] * x["steps"] / x["window_s"] / PEAK_FLOPS["bfloat16"]
