"""The program's own spans and counters: the aggregates of
rqvae_tpu_torch/utils/profiling.py's root recorder, read by the per-layer
metrics whose source is `program_counter`. They cover the whole run: set-up,
window and traced stretch. A program that keeps no recorder, or a span with
no records, gives nothing to read."""

from __future__ import annotations

from typing import Optional


def aggregates() -> dict:
    """The root recorder's aggregates by name; {} without a recorder."""
    try:
        from rqvae_tpu_torch.utils import profiling
    except ImportError:
        return {}
    root = getattr(profiling, "ROOT", None)
    return {} if root is None else root.snapshot()


def quantile_ms(name: str, q: float, self_time: bool = False) -> Optional[float]:
    """A span's q-quantile in ms (of its self time with `self_time`)."""
    agg = aggregates().get(name)
    return None if agg is None or not agg.values else 1e3 * agg.quantile(q, self_time)
