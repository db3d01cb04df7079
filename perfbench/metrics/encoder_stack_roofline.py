"""encoder_stack_roofline: the encoder_stack function's share of its roofline in the
traced stretch (perfbench/harness/roofline.py, perfbench/rooflines/encoder_stack.*), in %."""

from perfbench.harness.roofline import share_pct


def read(res, ctx):
    return share_pct(res, "encoder_stack")
