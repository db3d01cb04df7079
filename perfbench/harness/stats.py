"""Statistics over a whole window: rates over all its work and all its time,
and percentiles over all its requests (never a median of chunks or gaps)."""

from __future__ import annotations

from typing import Sequence

import numpy as np


def rate(work: float, seconds: float) -> float:
    """Work per second over the whole window."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return float(work) / float(seconds)


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) of all values, linear between ranks."""
    v = np.asarray(values, dtype=np.float64)
    if v.size == 0:
        raise ValueError("no values")
    return float(np.percentile(v, q))


def latencies_from_due(due_s: Sequence[float], done_s: Sequence[float]) -> np.ndarray:
    """Each request's latency from when it was due (not from when the
    generator got to it), so a late generator or a stall counts in full."""
    return np.asarray(done_s, dtype=np.float64) - np.asarray(due_s, dtype=np.float64)
