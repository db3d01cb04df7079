"""moe_experts_roofline: the MoE blocks' grouped expert products' share of
their roofline in the traced chunk (perfbench/harness/roofline.py,
perfbench/rooflines/moe_experts.*), in %."""

from perfbench.harness.roofline import share_pct


def read(res, ctx):
    return share_pct(res, "moe_experts")
