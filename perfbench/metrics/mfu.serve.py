"""mfu.serve: the retrieval FLOPs of the requests dispatched in the traced
stretch, at their real history lengths (perfbench/harness/flops.py), over
the device's busy time in that stretch and the dense bf16 peak, in %. A
share of the window could not move at a fixed offered rate."""

from perfbench.harness.flops import PEAK_FLOPS, query_flops


def read(res, ctx):
    lengths = res.extra.get("traced_lengths") if res.extra.get("kind") == "serve" else None
    if not lengths or res.trace is None or res.trace.busy_s <= 0:
        return None
    cfg = ctx.config
    L, K, k = cfg["rqvae"]["n_layers"], cfg["rqvae"]["codebook_size"], cfg["t5"]["top_k"]
    work = sum(query_flops(cfg["t5"], L, K, k, n) for n in lengths)
    return 100.0 * work / res.trace.busy_s / PEAK_FLOPS["bfloat16"]
