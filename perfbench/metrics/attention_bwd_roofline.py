"""attention_bwd_roofline: the attention_bwd function's share of its roofline in the
traced stretch (perfbench/harness/roofline.py, perfbench/rooflines/attention_bwd.*), in %."""

from perfbench.harness.roofline import share_pct


def read(res, ctx):
    return share_pct(res, "attention_bwd")
