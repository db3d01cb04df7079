"""Online retrieval under an open loop of independent users.

Set-up: the serving stack from the seed (perfbench/harness/serving.py) and
every bucket the traffic's history lengths reach captured; an
`AsyncRetrievalEngine` at the traffic's queue settings. Window: requests due
at the times of a Poisson process at the traffic's fixed `rate` go into
`submit()` (the main thread sleeps until each is due); each is timed from
when it was due to when its future resolved, a resolver thread's callback
reading the clock. Requests still open when the window closes are waited
for, up to a minute: a late answer counts its whole wait, one that never
comes or fails counts in `failed`. How late the generator ran is printed on
standard error. Then the queue is closed and the answers of a sample are
compared with the reference. A traced run adds, after the window, a second
open loop of `trace_seconds` at the same rate, profiled from before its
first request to after its last answer, its stretch from `trace_from` to
`trace_to` summarised; the queue's and the engine's per-layer numbers come
from the untraced window.
"""

from __future__ import annotations

import functools
import sys
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench.harness import serving, stats, traffic
from perfbench.harness.cell import Check, Context, Result, free_memory
from perfbench.harness.trace import DeviceTrace

GRACE_S = 60.0


class DispatchTimer:
    """Host time of each `retrieve_many_device` call of the engine, and the
    history lengths it dispatched, with the call's start on the host clock."""

    def __init__(self, engine):
        self.calls: List[tuple] = []  # (start, seconds, [lengths])
        inner = engine.retrieve_many_device
        lock = threading.Lock()

        def timed(histories, user_ids=None):
            t = time.perf_counter()
            plan = inner(histories, user_ids)
            dt = time.perf_counter() - t
            with lock:
                self.calls.append((t, dt, [min(len(h), engine.max_items) for h in histories]))
            return plan

        engine.retrieve_many_device = timed


def open_loop(queue, hists: List[np.ndarray], due: np.ndarray, keep: set, tracer: Optional[DeviceTrace],
              trace_at: tuple) -> dict:
    """Submit each request at its due time. A resolver's callback reads the
    clock and keeps the answer only of the requests in `keep` (holding every
    future and answer would grow the heap that Python's collector walks).
    Waits for every request, at most a minute past the last."""
    n = len(due)
    done, submitted = np.full(n, np.nan), np.full(n, np.nan)
    errors = np.zeros(n, dtype=bool)
    kept: Dict[int, object] = {}
    left, lock, all_done = [n], threading.Lock(), threading.Event()
    t0 = time.perf_counter()

    def finish(i, fut):
        done[i] = time.perf_counter() - t0
        if fut.exception() is not None:
            errors[i] = True
        elif i in keep:
            kept[i] = fut.result()
        with lock:
            left[0] -= 1
            if left[0] == 0:
                all_done.set()

    stretch = None
    for i in range(n):
        if tracer is not None and stretch is None and due[i] >= trace_at[0]:
            tracer.mark()
            stretch = [time.perf_counter(), None]
        if stretch is not None and stretch[1] is None and due[i] >= trace_at[1]:
            tracer.unmark()
            stretch[1] = time.perf_counter()
        wait_s = t0 + due[i] - time.perf_counter()
        if wait_s > 0:
            time.sleep(wait_s)
        submitted[i] = time.perf_counter() - t0
        queue.submit(hists[i], user_id=i).add_done_callback(functools.partial(finish, i))
    if stretch is not None and stretch[1] is None:
        tracer.unmark()
        stretch[1] = time.perf_counter()
    all_done.wait(timeout=GRACE_S)
    ok = np.flatnonzero(~np.isnan(done) & ~errors)
    return {"t0": t0, "submitted": submitted, "done": done, "ok": ok, "kept": kept, "stretch": stretch}


def serve(ctx: Context, prog, rate: float, seconds: float, tracer: Optional[DeviceTrace] = None):
    """One open-loop window at `rate` for `seconds` through a new queue."""
    from rqvae_tpu_torch.serving.queue import AsyncRetrievalEngine

    tr = ctx.traffic
    due = traffic.poisson_due_times(rate, seconds, ctx.seed)
    hists = serving.requests(ctx, len(due))
    keep = set(serving.sample(ctx, range(len(due)), hists).tolist())
    timer = DispatchTimer(prog.engine)
    queue = AsyncRetrievalEngine(prog.engine, max_delay_ms=tr["max_delay_ms"], max_in_flight=tr["max_in_flight"])
    if tracer is not None:
        tracer.start()  # before the loop, with the queue idle
    try:
        w = open_loop(queue, hists, due, keep, tracer, (seconds * tr["trace_from"], seconds * tr["trace_to"]))
        w["stats"] = queue.stats()
    finally:
        if tracer is not None:
            tracer.stop()  # every request answered: the queue is idle again
        queue.close()
        del prog.engine.retrieve_many_device  # the engine's own method again
    return {**w, "due": due, "hists": hists, "timer": timer}


def answers(w: dict) -> tuple:
    """(request indices, their answers) of the kept requests that were answered."""
    idx = sorted(set(w["kept"]) & set(w["ok"].tolist()))
    rs = [w["kept"][i] for i in idx]
    return idx, {"item_ids": np.stack([r.item_ids for r in rs]), "sem_ids": np.stack([r.sem_ids for r in rs]),
                 "log_probas": np.stack([r.log_probas for r in rs])}


def backlog(w: dict, at: float) -> int:
    """Requests submitted by `at` (s from the window's start) and not done by then."""
    done = np.nan_to_num(w["done"], nan=np.inf)
    return int(np.sum((w["submitted"] <= at) & (done > at)))


def setup(ctx: Context):
    prog = serving.build(ctx)
    lengths = [len(h) for h in serving.requests(ctx, 4096)]
    prog.warm(prog.reached_item_buckets(np.asarray(lengths)))
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    return prog



def controls(ctx: Context, compared: dict) -> Dict[str, Dict[str, float]]:
    """The numbers of the control (the reference at fp8, its own index judged,
    in the program's place) over the requests and index that `run` compared."""
    return serving.controls(ctx, **compared)


def run(ctx: Context) -> Result:
    dev, tr = ctx.device, ctx.traffic
    prog = setup(ctx)
    setup_s = time.time() - ctx.t0
    w = serve(ctx, prog, tr["rate"], ctx.seconds)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    lat = stats.latencies_from_due(w["due"][w["ok"]], w["done"][w["ok"]]) * 1e3
    late = (w["submitted"] - w["due"]) * 1e3
    print(f"perfbench: generator late by p50 {np.percentile(late, 50):.3f} ms, p99 {np.percentile(late, 99):.3f}"
          f" ms, max {late.max():.3f} ms over {len(late)} requests; backlog at the middle "
          f"{backlog(w, ctx.seconds / 2)}, at the end {backlog(w, ctx.seconds)}", file=sys.stderr)
    extra = {"kind": "serve", "stats": w["stats"], "dispatch_s": [c[1] for c in w["timer"].calls]}
    tracer = None
    if ctx.trace:  # a second, shorter open loop at the same rate after the window, its middle traced
        tracer = DeviceTrace()
        wt = serve(ctx, prog, tr["rate"], tr["trace_seconds"], tracer)
        if wt["stretch"] is not None:
            a, b = wt["stretch"]
            traced = [c for c in wt["timer"].calls if a <= c[0] <= b]
            extra["traced_lengths"] = [n for c in traced for n in c[2]]
            extra["calls"] = decoder_calls(ctx, prog, traced)
        del wt
    table = prog.cached_ids.cpu().numpy()
    idx, got = answers(w)
    hists = [w["hists"][i] for i in idx]
    n_due, n_ok = len(w["due"]), len(w["ok"])
    del prog, w
    free_memory(dev)
    numbers = serving.compare(ctx, table, hists, got)
    checks = [Check(name, value, float(ctx.limits[name])) for name, value in numbers.items()]
    extra["compared"] = {"table": table, "hists": hists}
    extra["p95_ms"] = stats.percentile(lat, 95)
    e2e = {"setup_s": setup_s, "serve_p50_ms": stats.percentile(lat, 50)}
    return Result(e2e=e2e, attempted=n_due, failed=n_due - n_ok, checks=checks, memory_peak_bytes=peak,
                  trace=tracer.finish() if tracer else None, extra=extra)


def decoder_calls(ctx: Context, prog, traced: list) -> dict:
    """Kernel 2's calls in the traced stretch: three a dispatched bucket
    (level 0 over one position of one beam, then k beams of 2 and of 3
    positions), at the bucket's batch and encoder rows, rebuilt from the
    dispatch calls' lengths by the engine's own bucketing."""
    e, cfg = prog.engine, ctx.config
    t5, L = cfg["t5"], cfg["rqvae"]["n_layers"]
    counts: Dict[tuple, int] = {}
    for _, _, lengths in traced:
        groups: Dict[int, int] = {}
        for n in lengths:
            ib = e._bucket_for(max(n, 1), e.item_buckets)
            groups[ib] = groups.get(ib, 0) + 1
        for ib, m in groups.items():
            cap = e.batch_buckets[-1]
            for s in range(0, m, cap):
                bb = e._bucket_for(min(cap, m - s), e.batch_buckets)
                counts[(bb, ib)] = counts.get((bb, ib), 0) + 1
    calls = []
    base = {"d": t5["d_model"], "H": t5["num_heads"], "dk": t5["d_kv"], "dff": t5["d_ff"],
            "layers": t5["num_layers"], "dtype": t5["dtype"]}
    for (bb, ib), n in counts.items():
        Le = ib * (L + 1)
        if Le > 128:  # the decoder-stack kernel's gate: beyond it the plain decoder runs
            continue
        for h in range(L):
            calls.append(({**base, "B": bb, "beams": 1 if h == 0 else t5["top_k"], "T": h + 1, "Le": Le}, n))
    return {"decoder_stack": calls}
