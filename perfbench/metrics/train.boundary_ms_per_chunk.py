"""train.boundary_ms_per_chunk: the host's work between two chunks while the
card has nothing queued, the `train.draws` and `train.stage` spans' seconds
over the chunks staged, in ms (the program's recorder)."""

from perfbench.harness import recorder


def read(res, ctx):
    aggs = recorder.aggregates()
    stage, draws = aggs.get("train.stage"), aggs.get("train.draws")
    if stage is None or not stage.values:
        return None
    return 1e3 * (stage.total + (draws.total if draws is not None else 0.0)) / stage.values
