"""The per-layer metrics read from the program's own recorder: each reader
over a root recorder filled by hand, over an empty one, and over a program
that keeps none (the parent of the recorder), where it gives nothing."""

import pytest

from perfbench.harness import registry

NAMES = ["queue.wait_ms_p50", "queue.resolve_ms_p50", "queue.gc_pause_pct", "engine.launch_ms_p50",
         "engine.gather_ms_p50", "train.boundary_ms_per_chunk", "setup.capture_s"]


def _filled():
    from rqvae_tpu_torch.utils import profiling

    rec = profiling.Recorder()
    rec.record("queue.wait", [0.001, 0.002, 0.004])
    rec.record("queue.resolve", [0.010, 0.030])
    rec.count("queue.gc_pause.0", value=0.25)
    rec.count("queue.gc_pause.2", value=0.75)
    rec.count("queue.open", value=20.0)
    rec.count("queue.open", value=30.0)
    rec.record("engine.launch", [0.0008])
    rec.record("engine.capture", [1.5, 2.5])
    rec.record("train.capture", [4.0])
    rec.record("train.draws", [0.0005] * 200)  # two chunks of 100 steps
    rec.record("train.stage", [0.002, 0.004])
    return rec


def _read(name):
    return registry.module("metrics", name).read(None, None)


def test_each_reader_over_a_recorder_filled_by_hand(monkeypatch):
    from rqvae_tpu_torch.utils import profiling

    rec = _filled()
    profiling._add(rec._chain, "engine.gather", 1, 0.005, 0.002)  # 5 ms, of it 3 ms in its event waits
    monkeypatch.setattr(profiling, "ROOT", rec)
    want = {"queue.wait_ms_p50": 2.0, "queue.resolve_ms_p50": 10.0, "queue.gc_pause_pct": 2.0,
            "engine.launch_ms_p50": 0.8, "engine.gather_ms_p50": 2.0, "train.boundary_ms_per_chunk": 53.0,
            "setup.capture_s": 8.0}
    for name in NAMES:
        assert _read(name) == pytest.approx(want[name], rel=0.03), name


@pytest.mark.parametrize("keeps", ["empty", "none"])
def test_each_reader_reads_nothing_where_nothing_was_recorded(monkeypatch, keeps):
    from rqvae_tpu_torch.utils import profiling

    if keeps == "empty":
        monkeypatch.setattr(profiling, "ROOT", profiling.Recorder())
    else:
        monkeypatch.delattr(profiling, "ROOT")
    assert all(_read(name) is None for name in NAMES)

