"""One run of one cell: the context a driver gets, the result it returns,
and the line the run prints.

A driver (perfbench/drivers/<kind>.py) sets up the program from the seed,
warms every shape its traffic reaches, measures for `seconds`, reads the
peak memory, frees the program's state and then compares what the timed path
produced with the plain reference. Each number compared sits beside its
limit; the run is correct when every number is at or under its limit.
"""

from __future__ import annotations

import gc
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from perfbench.harness import registry
from perfbench.harness.trace import Summary


@dataclass
class Context:
    cell: str
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t0: float  # time.time() at process start
    config: dict
    traffic: dict
    limits: dict


@dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit  # NaN fails


@dataclass
class Result:
    e2e: Dict[str, float]
    attempted: int
    failed: int
    checks: List[Check]
    memory_peak_bytes: int
    trace: Optional[Summary] = None
    extra: dict = field(default_factory=dict)  # what per-layer readers read

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c.ok for c in self.checks)


def context(cell_name: str, seed: int, seconds: float, trace: bool, device, t0: float,
            overrides: Optional[dict] = None) -> Context:
    """The cell's files read by name; `overrides` replaces whole sections
    (config, traffic, limits) for tests at small sizes."""
    spec = registry.workload(cell_name)
    parts = {"config": registry.config(spec["config"]), "traffic": registry.traffic(spec["traffic"]),
             "limits": spec["limits"]}
    parts.update(overrides or {})
    return Context(cell_name, int(seed), float(seconds), bool(trace), torch.device(device), t0, **parts)


def run(ctx: Context) -> Result:
    driver = registry.module("drivers", ctx.traffic["driver"])
    return driver.run(ctx)


def result_line(bench: dict, ctx: Context, res: Result, chips: int) -> dict:
    """The contract's last line: end-to-end metrics untraced, per-layer
    metrics traced (a reader that finds nothing is left out), then the
    numbers compared beside their limits under the last key."""
    metrics = {}
    if ctx.trace:
        for m in registry.per_layer(bench, ctx.cell):
            value = registry.module("metrics", m["name"]).read(res, ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in registry.end_to_end(bench, ctx.cell):
            metrics[m["name"]] = {"value": float(res.e2e[m["name"]]), "unit": m["unit"]}
    dev = ctx.device
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": chips, "memory_peak_bytes": int(res.memory_peak_bytes)}
    line = {"correct": res.correct, "attempted": int(res.attempted), "failed": int(res.failed),
            "metrics": metrics, "device": device}
    if ctx.trace and res.trace is not None:
        device["busy_s"] = res.trace.busy_s
        device["window_s"] = res.trace.window_s
        line["breakdown"] = res.trace.breakdown()
    line["checks"] = {c.name: {"value": _finite(c.value), "limit": c.limit} for c in res.checks}
    return line


def _finite(x: float):
    """A number as JSON can hold it: NaN and infinities as strings."""
    return x if math.isfinite(x) else str(x)


def free_memory(dev: torch.device) -> None:
    """Drop the program's freed blocks before the reference runs on the card."""
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def check_lines(res: Result) -> List[str]:
    return [f"check {c.name} {c.value:.6g} limit {c.limit:.6g} {'ok' if c.ok else 'FAILED'}" for c in res.checks]
