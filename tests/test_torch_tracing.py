"""The port's span recorder (rqvae_tpu_torch/utils/profiling.py) on the CPU:
percentiles from its fixed bins, nesting and self time, a child's records in
the root, no profiler range while no profiler runs, spans on the profiler's
clock, the queue's spans from its resolver threads in an exported trace,
every request's latency as the sum of its three records, and the queue's
collections counted."""

import gc
import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from rqvae_tpu_torch.models import retrieval as tr
from rqvae_tpu_torch.models.quantize import QuantizeForwardMode
from rqvae_tpu_torch.models.rqvae import RqVae, RqVaeConfig
from rqvae_tpu_torch.serving.engine import RetrievalEngine
from rqvae_tpu_torch.serving.queue import AsyncRetrievalEngine
from rqvae_tpu_torch.serving.retriever import Retriever
from rqvae_tpu_torch.tokenizer.semids import SemanticIdTokenizer
from rqvae_tpu_torch.utils import profiling


@pytest.fixture(scope="module")
def engine():
    """A small CPU engine: 40 items of 3 x 8 ids, a T5 of width 16."""
    rq = RqVae(RqVaeConfig(input_dim=16, embed_dim=8, hidden_dims=(16,), codebook_size=8, n_layers=3,
                           codebook_mode=QuantizeForwardMode.STE), device="cpu", seed=0)
    tok = SemanticIdTokenizer(rq, device="cpu")
    tok.precompute_corpus_ids(np.random.default_rng(0).normal(size=(40, 16)).astype(np.float32))
    model = tr.EncoderDecoderRetrievalModel(tr.RetrievalConfig(
        num_hierarchies=3, codebook_size=8, t5_d_model=16, t5_d_kv=8, t5_num_heads=2, t5_d_ff=32, t5_num_layers=1,
        top_k_for_generation=4), device="cpu", seed=0)
    return RetrievalEngine(Retriever(model, tok, device="cpu"), max_items=6, batch_buckets=(1, 4))


def _requests(n):
    rng = np.random.default_rng(1)
    return [rng.integers(0, 40, rng.integers(1, 7)).astype(np.int32) for _ in range(n)]


class FakeClock:
    def __init__(self):
        self.ns = 10**12

    def __call__(self):
        return self.ns


def test_percentiles_from_the_bins():
    rec = profiling.Recorder()
    values = np.random.default_rng(0).lognormal(-5.0, 1.5, 5000)
    rec.record("x", values)
    agg = rec.snapshot()["x"]
    assert agg.count == agg.values == 5000
    assert agg.total == pytest.approx(values.sum()) and agg.mean == pytest.approx(values.mean())
    assert agg.min == values.min() and agg.max == values.max()
    for q in (0.5, 0.95, 0.99):
        want = np.quantile(values, q, method="inverted_cdf")
        assert abs(agg.quantile(q) / want - 1) <= 2 ** (1 / 32) - 1 + 1e-9  # half a bin
    assert agg.quantile(1.0) == values.max()
    rec.count("n", 3)
    rec.count("n", value=2.5)
    n = rec.snapshot()["n"]
    assert (n.count, n.values, n.total) == (4, 1, 2.5)
    rec.reset()
    assert rec.snapshot() == {}


def test_nesting_self_time_and_child_to_root(monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(profiling.time, "perf_counter_ns", clock)
    root = profiling.Recorder()
    child = profiling.Recorder(root)
    grandchild = profiling.Recorder(child)
    with child.span("outer"):
        clock.ns += 3_000_000
        with grandchild.span("inner"):
            clock.ns += 5_000_000
        clock.ns += 2_000_000
    with child.span("late", start=clock.ns - 4_000_000) as sp:
        end = sp.stop()
        clock.ns += 1_000_000
    assert end == clock.ns - 1_000_000
    for rec in (root, child):
        got = rec.snapshot()
        assert got["outer"].total == pytest.approx(0.010)
        assert got["outer"].self_total == pytest.approx(0.005)
        assert got["outer"].quantile(0.5, self_time=True) == pytest.approx(0.005, rel=0.03)
        assert got["inner"].total == got["inner"].self_total == pytest.approx(0.005)
        assert got["late"].total == pytest.approx(0.004)  # backdated, stopped before the block ended
    assert set(grandchild.snapshot()) == {"inner"}
    assert set(child.snapshot()) == {"outer", "inner", "late"}


def test_the_flag_is_read_on_every_thread_and_no_range_opens_without_a_profiler(monkeypatch):
    opened = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function", lambda *a: opened.append(a) or real(*a))
    seen = {}

    def other():
        seen["running"] = profiling.profiler_running()
        with profiling.Recorder().span("off-thread", {"flush": 1}):
            pass

    rec = profiling.Recorder()
    assert not profiling.profiler_running()
    for _ in range(100):
        with rec.span("quiet", {"flush": 3}):
            pass
    assert opened == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert profiling.profiler_running()
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    assert seen["running"] is True  # where torch.autograd._profiler_enabled() reads False
    assert ("off-thread",) in opened and ("flush=1",) in opened


def test_a_span_lands_on_the_profilers_clock():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        offset = time.time_ns() - time.perf_counter_ns()
        with profiling.Recorder().span("clocked") as sp:
            torch.ones(8) + 1
    events = [e for e in prof.profiler.kineto_results.events() if e.name() == "clocked"]
    assert len(events) == 1
    assert abs(events[0].start_ns() - (sp.t0 + offset)) < 1_000_000
    assert abs(events[0].duration_ns() - (sp.t1 - sp.t0)) < 1_000_000


def test_the_queues_resolver_threads_reach_an_exported_trace(engine, tmp_path):
    with profiling.trace(str(tmp_path)):
        q = AsyncRetrievalEngine(engine, max_delay_ms=1.0)
        try:
            futs = [q.submit(h) for h in _requests(6)]
            for f in futs:
                f.result(timeout=60)
        finally:
            q.close()
    events = [e for e in json.load(open(os.path.join(tmp_path, "trace.json")))["traceEvents"] if e.get("ph") == "X"]
    main = threading.get_native_id()

    def marks(name):
        out = {}
        for e in (e for e in events if e["name"] == name):
            inside = [m["name"] for m in events if m["tid"] == e["tid"] and m["name"].startswith("flush=")
                      and e["ts"] <= m["ts"] <= e["ts"] + e["dur"]]
            out[inside[0]] = e["tid"]
        return out

    resolve, dispatch = marks("queue.resolve"), marks("queue.dispatch")
    assert resolve and set(resolve) == set(dispatch)  # one flush's spans share its marker
    assert main not in resolve.values() and main not in dispatch.values()
    assert all(resolve[f] != dispatch[f] for f in resolve)  # resolver and worker threads
    assert any(e["name"] == "engine.gather" for e in events)


class LoggingRecorder(profiling.Recorder):
    """A queue recorder that also keeps every record and span."""

    def __init__(self):
        super().__init__(profiling.ROOT)
        self.records, self.spans = [], []

    def record(self, name, seconds):
        seconds = list(seconds)
        stack = getattr(profiling._local, "stack", None)
        self.records.append((name, seconds, stack[-1].args if stack else None))
        super().record(name, seconds)

    def span(self, name, args=None, start=None):
        sp = super().span(name, args, start)
        self.spans.append(sp)
        return sp


def test_every_latency_is_its_wait_dispatch_and_resolve(engine):
    q = AsyncRetrievalEngine(engine, max_delay_ms=2.0, autostart=False)
    q.recorder = log = LoggingRecorder()
    q.start()
    try:
        futs = []
        for h in _requests(40):
            futs.append(q.submit(h))
            time.sleep(0.001)
        for f in futs:
            f.result(timeout=60)
    finally:
        q.close()
    waits = [s for name, s, _ in log.records if name == "queue.wait"]
    lat = {args["flush"]: s for name, s, args in log.records if name == "queue.latency"}
    part = {(sp.name, sp.args["flush"]): (sp.t1 - sp.t0) * 1e-9 for sp in log.spans}
    assert len(waits) == len(lat) == q.flushes > 1 and sum(map(len, waits)) == 40
    for flush, wait in enumerate(waits, 1):
        served = part[("queue.dispatch", flush)] + part[("queue.resolve", flush)]
        assert len(lat[flush]) == len(wait)
        np.testing.assert_allclose(lat[flush], np.asarray(wait) + served, rtol=0, atol=1e-9)


def test_stats_keep_their_keys_and_count_collections(engine):
    q = AsyncRetrievalEngine(engine, max_delay_ms=1.0)
    try:
        for f in [q.submit(h) for h in _requests(5)]:
            f.result(timeout=60)
        gc.collect()
        s = q.stats()
    finally:
        q.close()
    assert {"requests", "flushes", "rejected", "shed", "admitted", "latency_p50_s", "latency_p95_s",
            "latency_p99_s", "latency_mean_s", "batch_size_mean", "batch_size_max", "wait_p50_s",
            "backpressure_s", "resolve_p50_s", "gc_pauses", "gc_pause_s"} <= set(s)
    assert s["requests"] == 5 and 1 <= s["batch_size_max"] <= 4
    assert 0 <= s["wait_p50_s"] <= s["latency_p50_s"] <= s["latency_p95_s"] <= s["latency_p99_s"]
    assert s["gc_pauses"] >= 1 and s["gc_pause_s"] > 0  # the forced full collection
    assert q.recorder.snapshot()["queue.gc_pause.2"].count >= 1
    assert q.recorder.snapshot()["queue.open"].total > 0
    assert q._on_gc not in gc.callbacks


def test_concurrent_records_lose_no_update():
    root = profiling.Recorder()
    child = profiling.Recorder(root)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(500):
                with child.span("s"):
                    pass
                child.count("c", value=1.0)

        threads = [threading.Thread(target=work) for _ in range(2 * (os.cpu_count() or 4))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    n = 500 * len(threads)
    for rec in (root, child):
        got = rec.snapshot()
        assert got["s"].count == got["s"].values == sum(got["s"].hist) == n
        assert got["c"].count == n and got["c"].total == n
