"""Tracing and timing harness (port of rqvae_tpu/utils/profiling.py).

The JAX package captures `jax.profiler` traces and times jitted calls with
the compile apart; here `torch.profiler` captures the host and the card
(a Chrome trace, viewable in Perfetto or chrome://tracing), and `timeit`
keeps the first call (kernel builds, graph captures, cuBLAS set-up) apart
from the steady state, each run ended by a device synchronise.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict

import torch


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str, name: str = "trace.json"):
    """Capture a profiler trace of the block: `with trace("out/trace"): step(...)`.
    Writes `log_dir/name`, a Chrome trace (host and, with a card, device)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            _sync()
    prof.export_chrome_trace(os.path.join(log_dir, name))


def timeit(fn: Callable, *args, warmup: int = 1, runs: int = 10, **kwargs) -> Dict[str, float]:
    """Seconds of the first call (builds, captures and set-up included) and
    of a steady-state call (the mean of `runs` after `warmup - 1` more),
    each ended by a device synchronise."""
    t0 = time.perf_counter()
    fn(*args, **kwargs)
    _sync()
    first = time.perf_counter() - t0

    for _ in range(max(warmup - 1, 0)):
        fn(*args, **kwargs)
    _sync()

    t0 = time.perf_counter()
    for _ in range(runs):
        fn(*args, **kwargs)
    _sync()
    per_call = (time.perf_counter() - t0) / runs
    return {
        "first_call_s": first,
        "steady_state_s": per_call,
        "calls_per_sec": 1.0 / per_call if per_call > 0 else float("inf"),
    }


def annotate(name: str):
    """A named profiler region: `with annotate("tokenize"): ...` shows up in
    the captured trace."""
    return torch.profiler.record_function(name)
