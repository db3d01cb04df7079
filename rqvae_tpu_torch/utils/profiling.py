"""Spans, counters and traces of the program (port of rqvae_tpu/utils/profiling.py).

The JAX package captures `jax.profiler` traces and times jitted calls with
the compile apart; here `torch.profiler` captures the host and the card (a
Chrome trace, viewable in Perfetto or chrome://tracing), `timeit` keeps the
first call (kernel builds, graph captures, cuBLAS set-up) apart from the
steady state, and a `Recorder` keeps the program's own spans and counters.

A span times a block on `time.perf_counter_ns()` and adds its duration to an
aggregate per name: count, total, minimum, maximum and a histogram of fixed
log-spaced bins (16 a factor of two, from about 1 us to 1.5 days), from which
the percentiles are read to within 2.2%. Its self time, the duration less
that of the spans nested in it on its thread, is kept beside. While a torch
profiler runs, on any thread, the span also opens a profiler range of the
same name, so it lands in the trace on the profiler's clock, nested under its
enclosing span, with a marker range inside for each of its `args` (`flush=12`);
with no profiler running it costs two clock reads, one flag read and the
increments, never a profiler range. No span opens inside code that a CUDA
graph captures: a captured body runs on the host once, at its capture.

The process has one root `Recorder`, `ROOT`; a component may hold a child
(`Recorder(ROOT)`), whose records also go to the root. Every update, from any
thread, holds one re-entrant lock for the increment alone: re-entrant because
a collection's callback (`gc.callbacks`) may record on a thread that holds it.
"""

from __future__ import annotations

import contextlib
import math
import os
import threading
import time
from typing import Callable, Dict, Iterable, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

BINS_PER_OCTAVE = 16
LOW_OCTAVE = -20  # the first bin starts at 2**-20 (0.95 us, when the values are seconds)
N_BINS = 37 * BINS_PER_OCTAVE  # up to 2**17

_LOCK = threading.RLock()
_local = threading.local()


def _bin(v: float) -> int:
    if v <= 0.0:
        return 0
    i = int((math.log2(v) - LOW_OCTAVE) * BINS_PER_OCTAVE)
    return 0 if i < 0 else (N_BINS - 1 if i >= N_BINS else i)


def _bin_middle(i: int) -> float:
    return 2.0 ** ((i + 0.5) / BINS_PER_OCTAVE + LOW_OCTAVE)


class Aggregate:
    """One name's records: `count` events (a counter's `n`), and of the
    `values` among them (seconds for a span) the total, minimum, maximum and
    histogram; a span's self time beside."""

    __slots__ = ("count", "values", "total", "min", "max", "hist", "self_total", "self_hist")

    def __init__(self):
        self.count = self.values = 0
        self.total = self.self_total = 0.0
        self.min, self.max = math.inf, -math.inf
        self.hist = [0] * N_BINS
        self.self_hist = [0] * N_BINS

    def copy(self) -> "Aggregate":
        out = Aggregate()
        out.count, out.values, out.total, out.self_total = self.count, self.values, self.total, self.self_total
        out.min, out.max, out.hist, out.self_hist = self.min, self.max, list(self.hist), list(self.self_hist)
        return out

    @property
    def mean(self) -> float:
        return self.total / self.values if self.values else math.nan

    def quantile(self, q: float, self_time: bool = False) -> float:
        """The q-quantile (0 < q <= 1) of the values, or of a span's self
        times: the middle of its bin, held within the values' range."""
        if not self.values:
            return math.nan
        hist = self.self_hist if self_time else self.hist
        rank, seen = max(1.0, q * self.values), 0
        for i, c in enumerate(hist):
            seen += c
            if seen >= rank:
                return min(max(_bin_middle(i), 0.0 if self_time else self.min), self.max)
        return self.max


class Span:
    """A timed block of a `Recorder` (its `span()`): a context manager.
    `start` (a `perf_counter_ns` stamp) backdates the duration, for a span
    that another thread began; `stop()` ends the duration before the block
    does and returns its end stamp, for a caller that hands the stamp on."""

    __slots__ = ("_chain", "name", "args", "t0", "t1", "_children", "_parent", "_range")

    def __init__(self, chain: tuple, name: str, args: Optional[dict], start: Optional[int]):
        self._chain, self.name, self.args, self.t0 = chain, name, args, start
        self.t1: Optional[int] = None
        self._children = 0
        self._range = None

    def __enter__(self) -> "Span":
        if profiler_running():
            self._range = _open_range(self.name, self.args)
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self._parent = stack[-1] if stack else None
        stack.append(self)
        if self.t0 is None:
            self.t0 = time.perf_counter_ns()
        return self

    def stop(self) -> int:
        if self.t1 is None:
            self.t1 = time.perf_counter_ns()
            d = self.t1 - self.t0
            _add(self._chain, self.name, 1, d * 1e-9, (d - self._children) * 1e-9)
        return self.t1

    def __exit__(self, *exc) -> None:
        t1 = self.stop()
        stack = _local.stack
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        if self._parent is not None:
            self._parent._children += t1 - self.t0
        if self._range is not None:
            self._range.__exit__(None, None, None)


def _add(chain: tuple, name: str, n: int, v: Optional[float], own: Optional[float] = None) -> None:
    """`n` events of `name` and the value `v` (self part `own`, default all
    of it) into every recorder of `chain`."""
    if v is not None:
        i = _bin(v)
        if own is None or own == v:
            own, j = v, i
        else:
            j = _bin(own)
    with _LOCK:
        for rec in chain:
            agg = rec._aggs.get(name)
            if agg is None:
                agg = rec._aggs[name] = Aggregate()
            agg.count += n
            if v is not None:
                agg.values += 1
                agg.total += v
                agg.self_total += own
                if v < agg.min:
                    agg.min = v
                if v > agg.max:
                    agg.max = v
                agg.hist[i] += 1
                agg.self_hist[j] += 1


class Recorder:
    """Aggregates of spans and counters by name; a child's records also go to
    its parent's, up to the root."""

    def __init__(self, parent: Optional["Recorder"] = None):
        self._aggs: Dict[str, Aggregate] = {}
        self._chain: tuple = (self,) if parent is None else (self,) + parent._chain

    def span(self, name: str, args: Optional[dict] = None, start: Optional[int] = None) -> Span:
        """`with rec.span("engine.gather"): ...` adds the block's seconds to
        the aggregate `name`."""
        return Span(self._chain, name, args, start)

    def record(self, name: str, seconds: Iterable[float]) -> None:
        """Durations measured elsewhere (seconds), one record each."""
        values = [float(s) for s in seconds]
        with _LOCK:
            for s in values:
                _add(self._chain, name, 1, s)

    def count(self, name: str, n: int = 1, value: Optional[float] = None) -> None:
        """`n` more events of `name`, and optionally a value into its histogram."""
        _add(self._chain, name, n, None if value is None else float(value))

    def snapshot(self) -> Dict[str, Aggregate]:
        """A copy of every aggregate by name."""
        with _LOCK:
            return {k: v.copy() for k, v in dict(self._aggs).items()}

    def reset(self) -> None:
        with _LOCK:
            self._aggs = {}


ROOT = Recorder()


def span(name: str, args: Optional[dict] = None, start: Optional[int] = None) -> Span:
    """A span of the root recorder."""
    return ROOT.span(name, args, start)


def count(name: str, n: int = 1, value: Optional[float] = None) -> None:
    """A counter of the root recorder."""
    ROOT.count(name, n, value)


def profiler_running() -> bool:
    """Whether a torch profiler is recording, read the same on every thread
    (the C-level `torch.autograd._profiler_enabled()` reads False on threads
    other than the one that started it)."""
    return _autograd_profiler._is_profiler_enabled


def _open_range(name: str, args: Optional[dict]):
    """A profiler range, entered, with an instant range inside for each
    argument, named `key=value`: torch keeps no arguments of a range in a
    trace that records every thread, and the marker lets a trace viewer find
    the spans of one flush on every thread."""
    r = torch.profiler.record_function(name)
    r.__enter__()
    for k, v in (args or {}).items():
        with torch.profiler.record_function(f"{k}={v}"):
            pass
    return r


def all_threads() -> dict:
    """The profiler's setting that records the ranges of every thread, not
    only the starting one's, where this torch has it."""
    try:
        from torch._C._profiler import _ExperimentalConfig

        return {"experimental_config": _ExperimentalConfig(profile_all_threads=True)}
    except (ImportError, TypeError):
        return {}


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str, name: str = "trace.json"):
    """Capture a profiler trace of the block: `with trace("out/trace"): step(...)`.
    Writes `log_dir/name`, a Chrome trace (host and, with a card, device) of
    every thread's spans. Stop the program's threads' work (close a serving
    queue) inside the block."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities, **all_threads()) as prof:
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
