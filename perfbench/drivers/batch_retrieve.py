"""An offline job that recomputes every user's top k: a closed loop with one
caller.

Set-up: the serving stack from the seed (perfbench/harness/serving.py) and
every bucket that the traffic's history lengths reach captured. Window:
`RetrievalEngine.retrieve_many` over `call_users` users at a time, in order
through the traffic's users (wrapping around), the next call made when the
last returned, until `seconds` have passed; no call is cut, and the rate is
all the users returned over all the window's time. Then the answers of a
sample of them are compared with the reference.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from perfbench.harness import serving, stats
from perfbench.harness.cell import Check, Context, Result, free_memory
from perfbench.harness.trace import DeviceTrace


def _histories(ctx: Context):
    """Every user's history less the held-out item, in user order."""
    from perfbench.harness import traffic

    items, lengths = traffic.histories(ctx.traffic, ctx.config["data"]["items"], ctx.seed, ctx.device)
    items, lengths = items.cpu().numpy(), lengths.cpu().numpy()
    return [items[u, : lengths[u] - 1].astype(np.int32) for u in range(items.shape[0])]


def setup(ctx: Context):
    prog = serving.build(ctx)
    hists = _histories(ctx)
    prog.warm(prog.reached_item_buckets(np.asarray([len(h) for h in hists])))
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    return prog, hists


def window(ctx: Context, prog, hists, seconds: float):
    """Calls until `seconds` have passed. Returns (answers by user, users
    returned, seconds, the next call's users)."""
    n, users = ctx.traffic["call_users"], len(hists)
    got, start = {}, 0
    t0 = time.perf_counter()
    while True:
        idx = [(start + j) % users for j in range(n)]
        res = prog.engine.retrieve_many([hists[i] for i in idx], idx)
        for j, i in enumerate(idx):
            got[i] = (res.item_ids[j], res.sem_ids[j], res.log_probas[j])
        start += n
        if time.perf_counter() - t0 >= seconds:
            break
    return got, start, time.perf_counter() - t0, [(start + j) % users for j in range(n)]


def _answers(got: dict, idx) -> dict:
    return {"item_ids": np.stack([got[i][0] for i in idx]), "sem_ids": np.stack([got[i][1] for i in idx]),
            "log_probas": np.stack([got[i][2] for i in idx])}



def controls(ctx: Context, compared: dict) -> Dict[str, Dict[str, float]]:
    """The numbers of the control (the reference at fp8, its own index judged,
    in the program's place) over the users and index that `run` compared."""
    return serving.controls(ctx, **compared)


def encoder_calls(ctx: Context, prog, traced) -> dict:
    """Kernel 3's calls in the traced call: one a dispatched bucket whose
    encoder rows reach the kernel's gate, rebuilt by the engine's bucketing."""
    from rqvae_tpu_torch.models.t5 import FUSED_ENCODE_MIN_LEN

    e, cfg = prog.engine, ctx.config
    t5, L = cfg["t5"], cfg["rqvae"]["n_layers"]
    groups: Dict[int, int] = {}
    for h in traced:
        ib = e._bucket_for(max(min(len(h), e.max_items), 1), e.item_buckets)
        groups[ib] = groups.get(ib, 0) + 1
    calls = []
    cap = e.batch_buckets[-1]
    for ib, m in groups.items():
        if ib * (L + 1) < FUSED_ENCODE_MIN_LEN:
            continue
        for s in range(0, m, cap):
            bb = e._bucket_for(min(cap, m - s), e.batch_buckets)
            calls.append(({"B": bb, "L": ib * (L + 1), "d": t5["d_model"], "H": t5["num_heads"], "dk": t5["d_kv"],
                           "dff": t5["d_ff"], "layers": t5["num_layers"], "dtype": t5["dtype"]}, 1))
    return {"encoder_stack": calls}


def run(ctx: Context) -> Result:
    dev = ctx.device
    prog, hists = setup(ctx)
    setup_s = time.time() - ctx.t0
    got, n_users, window_s, after = window(ctx, prog, hists, ctx.seconds)
    tracer = traced = None
    if ctx.trace:  # one more call, traced, after the window
        tracer, traced = DeviceTrace(), [hists[i] for i in after]
        with tracer.window():
            prog.engine.retrieve_many(traced, after)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    returned = list(got)
    cap = ctx.traffic["max_items"]
    extra = {"kind": "batch", "users": n_users, "window_s": window_s,
             "lengths": [min(len(hists[i % len(hists)]), cap) for i in range(n_users)]}
    if traced:
        extra["calls"] = encoder_calls(ctx, prog, traced)
    table = prog.cached_ids.cpu().numpy()
    idx = serving.sample(ctx, returned, hists)
    served, sample = _answers(got, idx), [hists[i] for i in idx]
    del prog, got
    free_memory(dev)
    numbers = serving.compare(ctx, table, sample, served)
    checks = [Check(name, value, float(ctx.limits[name])) for name, value in numbers.items()]
    extra["compared"] = {"table": table, "hists": sample}
    e2e = {"setup_s": setup_s, "retrieve_users_per_s": stats.rate(n_users, window_s)}
    return Result(e2e=e2e, attempted=n_users, failed=0, checks=checks, memory_peak_bytes=peak,
                  trace=tracer.finish() if tracer else None, extra=extra)
