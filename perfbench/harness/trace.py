"""The profiler's trace of a stretch of the window, reduced to device time.

`DeviceTrace` runs torch.profiler (CPU and CUDA activity, CUPTI) over a
block marked `perfbench.window` and keeps, not the trace, but its summary:

- busy_s: the time in which at least one device operation ran (kernels,
  copies and sets; the union of their intervals), inside the window;
- window_s: the window's length on the same clock;
- seconds by device operation name, and the launch count of each;
- idle gaps: each stretch in which no device operation ran, named by the
  innermost host event that covered its middle (what the host was doing),
  summed by that name.
"""

from __future__ import annotations

import bisect
import contextlib
import re
from typing import Dict, List, Optional, Tuple

import torch

WINDOW = "perfbench.window"


class Summary:
    def __init__(self, window_s: float, busy_s: float, ops: Dict[str, Tuple[int, float]],
                 gaps: Dict[str, float]):
        self.window_s, self.busy_s, self.ops, self.gaps = window_s, busy_s, ops, gaps

    @property
    def idle_share(self) -> float:
        return max(0.0, 1.0 - self.busy_s / self.window_s)

    def seconds_of(self, names: List[str]) -> Tuple[int, float]:
        """(launches, device seconds) of the operations whose function name
        is one of `names` (matched as whole identifiers)."""
        pat = re.compile(r"\b(" + "|".join(re.escape(n) for n in names) + r")\b")
        count, secs = 0, 0.0
        for name, (n, s) in self.ops.items():
            if pat.search(name):
                count += n
                secs += s
        return count, secs

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(((k, v[1]) for k, v in self.ops.items()), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k[:120], s] for k, s in ops], "idle_gaps": [[k[:120], s] for k, s in gaps]}


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def summarize(device: List[Tuple[str, int, int]], host: List[Tuple[str, int, int]],
              window: Tuple[int, int]) -> Summary:
    """Reduce device events and host events (name, start ns, end ns) inside
    `window` (start ns, end ns)."""
    w0, w1 = window
    ops: Dict[str, Tuple[int, float]] = {}
    spans = []
    for name, a, b in device:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        n, s = ops.get(name, (0, 0.0))
        ops[name] = (n + 1, s + (b - a) * 1e-9)
        spans.append((a, b))
    busy = _merge(spans)
    busy_ns = sum(b - a for a, b in busy)
    host = sorted((a, b, name) for name, a, b in host if b > w0 and a < w1)
    starts = [h[0] for h in host]
    gaps: Dict[str, float] = {}
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        mid = (g0 + g1) // 2
        label = "no host event"
        i = bisect.bisect_right(starts, mid) - 1
        while i >= 0:  # the latest-starting host event that still covers mid
            if host[i][1] >= mid:
                label = host[i][2]
                break
            i -= 1
        gaps[label] = gaps.get(label, 0.0) + (g1 - g0) * 1e-9
    return Summary((w1 - w0) * 1e-9, busy_ns * 1e-9, ops, gaps)


class DeviceTrace:
    """The profiler over one stretch of a run.

    `start()` sets the profiler up, lets it warm (CUPTI's start is slow and
    the first kernels after it can go missing) and records from there on;
    `mark()` and `unmark()` bound the stretch that the summary reads;
    `stop()` collects the events and `finish()`, outside any measured
    window, reduces them to `summary`. Start and stop while no other thread
    launches work on the card: stopping the profiler under a serving
    queue's threads has hung a run. `window()` does all of it around a block."""

    def __init__(self):
        self.summary: Optional[Summary] = None
        self._prof = None
        self._mark = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, schedule

        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                             schedule=schedule(wait=0, warmup=1, active=1, repeat=1))
        self._prof.__enter__()  # the warm-up step: tracing set up, nothing kept
        self._prof.step()  # record from here

    def mark(self) -> None:
        from torch.profiler import record_function

        self._mark = record_function(WINDOW)
        self._mark.__enter__()

    def unmark(self) -> None:
        torch.cuda.synchronize()
        self._mark.__exit__(None, None, None)

    def stop(self) -> None:
        self._prof.step()  # the recorded step ends: its events are collected
        self._prof.__exit__(None, None, None)

    @contextlib.contextmanager
    def window(self):
        self.start()
        self.mark()
        try:
            yield
        finally:
            self.unmark()
            self.stop()

    def finish(self) -> Optional[Summary]:
        """Reduce the recorded stretch (once) and drop the profiler's events."""
        if self._prof is not None:
            self.summary = self._reduce(self._prof)
            self._prof = None
        return self.summary

    @staticmethod
    def _reduce(prof) -> Summary:
        cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
        device, host, window = [], [], None
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            a = e.start_ns()
            b = a + e.duration_ns()
            if e.device_type() == cuda:
                if e.is_user_annotation() or name.startswith(("ProfilerStep", "perfbench.")):
                    continue
                device.append((name, a, b))
            elif e.device_type() == cpu:
                if name == WINDOW:
                    window = (a, b)
                elif not name.startswith("ProfilerStep"):  # the schedule's step spans everything
                    host.append((name, a, b))
        if window is None:
            raise RuntimeError("the profiler recorded no window")
        if not device:
            raise RuntimeError("the profiler recorded no device operation: CUDA activity was not traced")
        return summarize(device, host, window)
