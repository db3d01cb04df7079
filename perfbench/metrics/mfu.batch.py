"""mfu.batch: the retrieval FLOPs of the users returned in the window, at
their real history lengths (perfbench/harness/flops.py), over the window's
time and the dense bf16 peak, in %."""

from perfbench.harness.flops import PEAK_FLOPS, query_flops


def read(res, ctx):
    x = res.extra
    if x.get("kind") != "batch" or not x.get("lengths"):
        return None
    cfg = ctx.config
    L, K, k = cfg["rqvae"]["n_layers"], cfg["rqvae"]["codebook_size"], cfg["t5"]["top_k"]
    per = {}
    for n in x["lengths"]:
        per[n] = per.get(n, 0) + 1
    work = sum(c * query_flops(cfg["t5"], L, K, k, n) for n, c in per.items())
    return 100.0 * work / x["window_s"] / PEAK_FLOPS["bfloat16"]
