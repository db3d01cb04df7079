#!/usr/bin/env python3
"""What the program's tracing costs, on the card's host.

  python3 perfbench/tracing_cost.py spans [--n 100000]
  python3 perfbench/tracing_cost.py cell --workload <cell> --seed <n> --seconds <s> --profile <0|1>

`spans`: the host time of one span of rqvae_tpu_torch's recorder
(utils/profiling.py) and of one counter, with no profiler running, under a
torch profiler of the CPU activity that records every thread (on its own
thread and on another), and under one that records only its own thread (a
span on another thread then opens a range nobody keeps); one JSON line.

`cell`: one untraced run of the cell as perfbench/run.py makes it, with
`--profile 1` under a torch profiler of the CPU activity that records every
thread, from before set-up to after the comparison; one JSON line with the
end-to-end metrics and the program's spans (count, total, mean and
percentiles). Runs with and without, on the same seeds and card, give the
host's cost of tracing on (the card's own trace, CUPTI, is not in it).
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from perfbench.harness import env  # noqa: E402

T0 = env.process_start_time()


def _per_call_ns(fn, n: int) -> float:
    t = time.perf_counter_ns()
    for i in range(n):
        fn(i)
    return (time.perf_counter_ns() - t) / n


def spans(n: int) -> dict:
    import torch

    from rqvae_tpu_torch.utils import profiling

    rec = profiling.Recorder(profiling.ROOT)

    def bare(i):
        pass

    def span(i):
        with rec.span("cost.span"):
            pass

    def span_args(i):
        with rec.span("cost.span", {"flush": i}):
            pass

    def counter(i):
        rec.count("cost.count", value=1.0)

    def elsewhere(fn, m):
        out = []
        t = threading.Thread(target=lambda: out.append(_per_call_ns(fn, m)))
        t.start()
        t.join()
        return out[0]

    base = _per_call_ns(bare, n)
    out = {"loop_ns": base,
           "off": {"span_ns": _per_call_ns(span, n) - base, "span_args_ns": _per_call_ns(span_args, n) - base,
                   "count_ns": _per_call_ns(counter, n) - base}}
    m = max(n // 20, 1000)
    cpu = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=cpu, **profiling.all_threads()):
        out["on_all_threads"] = {"span_ns": _per_call_ns(span, m) - base,
                                 "span_args_ns": _per_call_ns(span_args, m) - base,
                                 "other_thread_span_ns": elsewhere(span, m) - base,
                                 "count_ns": _per_call_ns(counter, m) - base}
    with torch.profiler.profile(activities=cpu):
        out["on_own_thread"] = {"other_thread_span_ns": elsewhere(span, m) - base}
    out["card"] = env.card_limits()
    return out


def cell_run(workload: str, seed: int, seconds: float, profile: bool) -> dict:
    env.set_caches(ROOT)
    import torch

    from perfbench.harness import cell, registry
    from rqvae_tpu_torch.utils import profiling

    bench = registry.benchmark()
    entry = registry.cell(bench, workload)
    ctx = cell.context(workload, seed, seconds, False, "cuda:0", T0)
    prof = None
    if profile:
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU], **profiling.all_threads())
        prof.__enter__()
    try:
        res = cell.run(ctx)
    finally:
        if prof is not None:
            t = time.perf_counter()
            prof.__exit__(None, None, None)
            stop_s = time.perf_counter() - t
    line = cell.result_line(bench, ctx, res, entry["chips"])
    out = {"workload": workload, "seed": seed, "profile": int(profile), "correct": line["correct"],
           "failed": line["failed"], "attempted": line["attempted"],
           "metrics": {k: v["value"] for k, v in line["metrics"].items()}, "card": env.card_limits()}
    if prof is not None:
        out["profiler_stop_s"] = stop_s
        out["host_events"] = len(prof.profiler.kineto_results.events())
    out["spans"] = {name: {"count": a.count, "values": a.values, "total_s": a.total, "mean_ms": 1e3 * a.mean,
                           "p50_ms": 1e3 * a.quantile(0.5), "p95_ms": 1e3 * a.quantile(0.95),
                           "self_p50_ms": 1e3 * a.quantile(0.5, self_time=True)}
                    for name, a in profiling.ROOT.snapshot().items() if a.values}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="what", required=True)
    s = sub.add_parser("spans")
    s.add_argument("--n", type=int, default=100_000)
    c = sub.add_parser("cell")
    c.add_argument("--workload", required=True)
    c.add_argument("--seed", type=int, required=True)
    c.add_argument("--seconds", type=float, required=True)
    c.add_argument("--profile", type=int, choices=(0, 1), required=True)
    args = p.parse_args(argv)
    if args.what == "spans":
        out = spans(args.n)
    else:
        out = cell_run(args.workload, args.seed, args.seconds, bool(args.profile))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
