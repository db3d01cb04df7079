"""setup.capture_s: the seconds of the run's CUDA graph captures, the
engine's buckets (`engine.capture`) and the training step (`train.capture`),
each its eager run, collection, capture and instantiation (the program's
recorder)."""

from perfbench.harness import recorder


def read(res, ctx):
    aggs = recorder.aggregates()
    caps = [aggs[n] for n in ("engine.capture", "train.capture") if n in aggs and aggs[n].values]
    return sum(a.total for a in caps) if caps else None
