#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result as the last line.

  python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds rqvae_tpu_torch. With --trace 0 the
line holds the cell's end-to-end metrics, with --trace 1 its per-layer
metrics read from the profiler's trace. It exits non-zero and prints no
result without the CUDA devices the cell asks for, and if jax, jaxlib,
flax, optax, orbax or rqvae_tpu was loaded.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from perfbench.harness import env  # noqa: E402

T0 = env.process_start_time()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    env.set_caches(ROOT)
    from perfbench.harness import cell, registry

    bench = registry.benchmark()
    entry = registry.cell(bench, args.workload)
    import torch

    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < entry["chips"]:
        print(f"perfbench: {args.workload} needs {entry['chips']} CUDA device(s); found {found}", file=sys.stderr)
        return 2
    print(f"perfbench: card {env.card_limits()}", file=sys.stderr)
    ctx = cell.context(args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0", T0)
    res = cell.run(ctx)
    line = cell.result_line(bench, ctx, res, entry["chips"])
    banned = env.banned_loaded()
    if banned:
        print(f"perfbench: modules that must not be loaded were loaded: {banned}", file=sys.stderr)
        return 3
    for text in cell.check_lines(res):
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
