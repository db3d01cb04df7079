#!/usr/bin/env python3
"""The knee of an open-loop serving cell: the lowest Poisson rate at which
completions fall behind arrivals on any seed.

  python3 perfbench/sweep_knee.py --workload <cell> --rates 3000,4000,5000 --seeds 7,8,9 --seconds 20

One set-up, then one window a rate and seed, each through a new queue at the
traffic's settings. A window keeps pace when no request fails, the requests
done by its end are at least 99% of those submitted by then, and the
backlog (requests submitted and not done), read every half second from the
first second on, grows by a least-squares slope of at most 1% of the rate
per second: completions within 1% of arrivals over the whole window, which
a single stall of the collector does not tip. Prints one JSON line a window,
with the count, total and longest pause (ms) of Python's cyclic collector by
generation, and last a line with the knee and four fifths of it.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from perfbench.harness import env  # noqa: E402

SHARE = 0.99  # completions by the window's end over submissions by then
SLOPE = 0.01  # the backlog's growth per second over the rate


def pace(w: dict, rate: float, seconds: float, backlog) -> dict:
    """The keep-pace test's readings of one window."""
    import numpy as np

    done = np.nan_to_num(w["done"], nan=np.inf)
    submitted = int(np.sum(w["submitted"] <= seconds))
    share = float(np.sum(done <= seconds)) / max(submitted, 1)
    at = np.arange(1.0, seconds + 1e-9, 0.5)
    slope = float(np.polyfit(at, [backlog(w, t) for t in at], 1)[0])
    failed = len(w["due"]) - len(w["ok"])
    return {"done_share": share, "backlog_slope_per_s": slope, "failed": failed,
            "keeps_pace": bool(failed == 0 and share >= SHARE and slope <= SLOPE * rate)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seeds", default="7")
    p.add_argument("--seconds", type=float, default=20.0)
    args = p.parse_args(argv)
    env.set_caches(ROOT)
    import numpy as np
    import torch

    from perfbench.harness import cell, registry, stats

    if not torch.cuda.is_available():
        print("sweep_knee: no CUDA device", file=sys.stderr)
        return 2
    print(f"sweep_knee: card {env.card_limits()}", file=sys.stderr)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctx = cell.context(args.workload, seeds[0], args.seconds, False, "cuda:0", time.time())
    driver = registry.module("drivers", ctx.traffic["driver"])
    prog = driver.setup(ctx)
    pauses = {}
    started = {}

    def collector(phase, info):  # how long Python's cyclic collector held the process
        if phase == "start":
            started[0] = time.perf_counter()
        elif 0 in started:
            g = info["generation"]
            n, total, worst = pauses.get(g, (0, 0.0, 0.0))
            dt = time.perf_counter() - started.pop(0)
            pauses[g] = (n + 1, total + dt, max(worst, dt))

    gc.callbacks.append(collector)
    behind = []
    for rate in [float(r) for r in args.rates.split(",")]:
        for seed in seeds:  # the traffic of each seed over the first seed's stack
            pauses.clear()
            w = driver.serve(dataclasses.replace(ctx, seed=seed), prog, rate, args.seconds)
            ok = w["ok"]
            lat = stats.latencies_from_due(w["due"][ok], w["done"][ok]) * 1e3
            row = {"rate": rate, "seed": seed, "requests": len(w["due"]),
                   **pace(w, rate, args.seconds, driver.backlog),
                   "p50_ms": stats.percentile(lat, 50), "p95_ms": stats.percentile(lat, 95),
                   "p99_ms": stats.percentile(lat, 99), "backlog_mid": driver.backlog(w, args.seconds / 2),
                   "backlog_end": driver.backlog(w, args.seconds), "flush_mean": w["stats"].get("batch_size_mean"),
                   "late_p99_ms": float(np.percentile((w["submitted"] - w["due"]) * 1e3, 99)),
                   "gc_pauses": {g: [n, round(t * 1e3, 3), round(m * 1e3, 3)] for g, (n, t, m) in
                                 sorted(pauses.items())}}
            if not row["keeps_pace"]:
                behind.append(rate)
            print(json.dumps(row), flush=True)
            del w
    gc.callbacks.remove(collector)
    knee = min(behind) if behind else None
    print(json.dumps({"knee": knee, "offer": None if knee is None else 0.8 * knee}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
