#!/usr/bin/env python3
"""Readings that a cell's limits are set from.

  python3 perfbench/check_limits.py --workload <cell> --seeds 11,12,13 --controls 3 [--seconds 3] [--out FILE]

For each seed: one run of the cell as perfbench/run.py makes it, with a
window of `--seconds` (a training cell runs at least one whole chunk, a
batch cell one call), and the numbers it compared, of the program against
the plain reference; for the first `--controls` seeds also, from the same
compared inputs, those of the control (the reference in the program's
place, one precision below the configuration's) and of each planted fault
the driver knows. The lower reading of a number is its largest over the
program's seeds, the upper its smallest over a control's or a fault's. One
process, the seeds one after another. Writes a JSON object per seed as a
line to stdout (and to --out).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from perfbench.harness import env  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    env.set_caches(ROOT)
    import torch

    from perfbench.harness import cell, registry

    if not torch.cuda.is_available():
        print("check_limits: no CUDA device", file=sys.stderr)
        return 2
    print(f"check_limits: card {env.card_limits()}", file=sys.stderr)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    out = open(args.out, "a") if args.out else None
    try:
        for i, seed in enumerate(seeds):
            t = time.perf_counter()
            ctx = cell.context(args.workload, seed, args.seconds, False, "cuda:0", time.time())
            res = cell.run(ctx)
            got = {"correct": res.correct, "program": {c.name: c.value for c in res.checks}}
            if i < args.controls:
                got.update(registry.module("drivers", ctx.traffic["driver"]).controls(ctx, res.extra["compared"]))
            del res
            row = json.dumps({"workload": args.workload, "seed": seed, "seconds": time.perf_counter() - t, **got})
            print(row, flush=True)
            if out:
                out.write(row + "\n")
                out.flush()
            torch.cuda.empty_cache()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
