"""attention_fwd_roofline: the attention_fwd function's share of its roofline in the
traced stretch (perfbench/harness/roofline.py, perfbench/rooflines/attention_fwd.*), in %."""

from perfbench.harness.roofline import share_pct


def read(res, ctx):
    return share_pct(res, "attention_fwd")
