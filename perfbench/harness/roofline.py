"""A kernel function's share of its roofline in the traced stretch: the least
time the card could take for the calls the stretch made (per call the larger
of operations over the peak of its dtype and bytes over the HBM peak, from
perfbench/rooflines/<function>.py), over the device time of the kernels that
the function launched (their names in perfbench/rooflines/<function>.json).
None where the stretch made no such call or launched no such kernel."""

from __future__ import annotations

from typing import Optional

from perfbench.harness import registry
from perfbench.harness.flops import PEAK_BYTES, PEAK_FLOPS


def least_seconds(function: str, shape: dict) -> float:
    ops, nbytes = registry.module("rooflines", function).work(shape)
    return max(ops / PEAK_FLOPS[shape["dtype"]], nbytes / PEAK_BYTES)


def share_pct(res, function: str) -> Optional[float]:
    calls = res.extra.get("calls", {}).get(function)
    if not calls or res.trace is None:
        return None
    least = sum(least_seconds(function, shape) * n for shape, n in calls)
    _, seconds = res.trace.seconds_of(registry.roofline_names(function))
    if seconds <= 0.0:
        return None
    return 100.0 * least / seconds
