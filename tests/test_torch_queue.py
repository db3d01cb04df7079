"""The port's async queue on the CPU, mirroring the 17 cases of
tests/test_queue.py: submit() returns exactly what the engine returns (and
the JAX engine, on the same weights), batching coalesces, the delay bound
flushes a lone request, failures resolve futures, backpressure and
admission control hold. Every wait has a timeout."""

import time

import numpy as np
import pytest

from rqvae_tpu.serving.engine import RetrievalEngine as JEngine
from rqvae_tpu.serving.retriever import Retriever as JRetriever

from rqvae_tpu_torch.serving.engine import RetrievalEngine
from rqvae_tpu_torch.serving.queue import AsyncRetrievalEngine

from tests.torch_serving_fixture import both_packages


@pytest.fixture(scope="module")
def packages():
    return both_packages()


@pytest.fixture
def mk(packages):
    def make(batch_buckets=(1, 2, 4), max_items=8, **kw):
        _, r, hist = packages
        eng = RetrievalEngine(r, max_items=max_items, batch_buckets=batch_buckets)
        return r, eng, AsyncRetrievalEngine(eng, **kw), hist

    return make


class TestManualFlush:
    def test_submit_matches_retrieve_many(self, mk, packages):
        """Deterministic (manual-flush) coalescing: per-request futures
        resolve to the engine's own rows."""
        r, eng, q, hist = mk(autostart=False)
        requests = [hist[0][:3], hist[1][:8], hist[2][:5], hist[3][:2], hist[4][:8]]
        requests = [np.asarray(h, np.int32)[np.asarray(h) >= 0] for h in requests]
        futs = [q.submit(h, uid) for uid, h in enumerate(requests)]
        assert not any(f.done() for f in futs)
        assert q.flush() == 5
        expected = eng.retrieve_many(requests, list(range(5)))
        (jm, jparams, jtok), _, _ = packages
        jax_rows = JEngine(JRetriever(jm, jparams, jtok), max_items=8,
                           batch_buckets=(1, 2, 4)).retrieve_many(requests, list(range(5)))
        np.testing.assert_array_equal(expected.item_ids, np.asarray(jax_rows.item_ids))
        np.testing.assert_array_equal(expected.sem_ids, np.asarray(jax_rows.sem_ids))
        for i, f in enumerate(futs):
            res = f.result(timeout=0)
            np.testing.assert_array_equal(res.sem_ids, expected.sem_ids[i])
            np.testing.assert_array_equal(res.item_ids, expected.item_ids[i])
            # queue cuts batches by arrival (4 then 1) while the direct call
            # groups all 5 -> different batch-bucket shapes, so float
            # reductions may reassociate (ids stay exact, as in test_engine)
            np.testing.assert_allclose(
                res.log_probas, expected.log_probas[i], rtol=1e-4, atol=1e-5
            )

    def test_coalescing_respects_batch_cap(self, mk):
        """6 queued requests with cap 4 -> flushes of 4 then 2."""
        _, eng, q, hist = mk(batch_buckets=(1, 2, 4), autostart=False)
        h = np.asarray(hist[0][:4], np.int32)
        futs = [q.submit(h) for _ in range(6)]
        assert q.flush() == 6
        assert q.flushes == 2
        for f in futs:
            assert f.result(timeout=0).item_ids.shape == (5,)

    def test_close_drains_without_worker(self, mk):
        _, _, q, hist = mk(autostart=False)
        fut = q.submit(np.asarray(hist[0][:4], np.int32))
        q.close()
        assert fut.result(timeout=0).item_ids.shape == (5,)
        try:
            q.submit(np.asarray(hist[0][:4], np.int32))
            raise AssertionError("submit after close must raise")
        except RuntimeError:
            pass


class TestWorkerThread:
    def test_delay_flushes_lone_request(self, mk):
        """A single request must be served within the delay bound without
        ever filling a batch bucket."""
        _, _, q, hist = mk(max_delay_ms=20.0)
        with q:
            fut = q.submit(np.asarray(hist[0][:4], np.int32))
            res = fut.result(timeout=30)
            assert res.item_ids.shape == (5,)
        assert q.flushes == 1

    def test_burst_coalesces(self, mk):
        """A burst submitted while the worker waits out the delay window
        lands in fewer flushes than requests."""
        _, eng, q, hist = mk(max_delay_ms=500.0)
        eng.warmup()  # every bucket run once, so a dispatch is short against the window
        with q:
            h = np.asarray(hist[0][:4], np.int32)
            futs = [q.submit(h, uid) for uid in range(4)]
            for f in futs:
                assert f.result(timeout=30).item_ids.shape == (5,)
        # cap = 4: the 4-burst should cut at most 2 batches even if the
        # worker raced the first submit
        assert q.flushes <= 2
        assert q.requests == 4

    def test_sustained_traffic(self, mk):
        """Steady submits through the live worker all resolve correctly
        and match a direct engine run request-by-request."""
        _, eng, q, hist = mk(max_delay_ms=5.0)
        reqs = [np.asarray(hist[i % len(hist)][: 2 + i % 7], np.int32) for i in range(12)]
        reqs = [h[h >= 0] for h in reqs]
        with q:
            futs = [q.submit(h, uid) for uid, h in enumerate(reqs)]
            results = [f.result(timeout=60) for f in futs]
        for uid, (h, res) in enumerate(zip(reqs, results)):
            direct = eng.retrieve_many([h], [uid])
            np.testing.assert_array_equal(res.sem_ids, direct.sem_ids[0])
            np.testing.assert_array_equal(res.item_ids, direct.item_ids[0])

    def test_exception_propagates(self, mk):
        """Engine failures resolve futures exceptionally instead of hanging."""
        _, eng, q, _ = mk(autostart=False)
        fut = q.submit(np.asarray([0, 1], np.int32))
        eng.retriever = None  # force an AttributeError inside the flush
        q.flush()
        try:
            fut.result(timeout=0)
            raise AssertionError("future should carry the engine failure")
        except AttributeError:
            pass

    def test_stats(self, mk):
        """Latency percentiles and batch-size stats accumulate per flush."""
        _, eng, q, hist = mk(autostart=False)
        reqs = [np.asarray(h, np.int32)[np.asarray(h) >= 0][:4] for h in hist[:5]]
        futs = [q.submit(h) for h in reqs]
        q.flush()
        [f.result(timeout=0) for f in futs]
        s = q.stats()
        assert s["requests"] == 5 and s["flushes"] >= 1
        assert 0 <= s["latency_p50_s"] <= s["latency_p95_s"] <= s["latency_p99_s"]
        assert s["batch_size_mean"] > 0 and s["batch_size_max"] <= 4  # cap = largest bucket

    def test_async_dispatch_failure_propagates_and_worker_survives(self, mk):
        """Worker-path (pipelined) flushes: a failure while ENQUEUING the
        bucket batches (retrieve_many_device) must resolve that flush's
        futures exceptionally and leave the worker serving later requests."""
        _, eng, q, _ = mk(max_delay_ms=1.0)
        with q:
            real = eng.retrieve_many_device
            eng.retrieve_many_device = None  # TypeError inside _dispatch_async
            f1 = q.submit(np.asarray([0, 1], np.int32))
            try:
                f1.result(timeout=60)
                raise AssertionError("future should carry the dispatch failure")
            except TypeError:
                pass
            eng.retrieve_many_device = real
            f2 = q.submit(np.asarray([2, 3], np.int32))
            assert f2.result(timeout=60) is not None  # worker still alive

    def test_async_fetch_failure_propagates_and_resolver_survives(self, mk):
        """A failure in the host FETCH (finalize_many, resolver thread) must
        resolve that flush's futures exceptionally, not hang them, and the
        resolver must keep settling later flushes."""
        _, eng, q, _ = mk(max_delay_ms=1.0)
        with q:
            real = eng.finalize_many
            eng.finalize_many = None  # TypeError inside _run_resolver
            f1 = q.submit(np.asarray([0, 1], np.int32))
            try:
                f1.result(timeout=60)
                raise AssertionError("future should carry the fetch failure")
            except TypeError:
                pass
            eng.finalize_many = real
            f2 = q.submit(np.asarray([2, 3], np.int32))
            assert f2.result(timeout=60) is not None  # resolver still alive

    def test_resolver_pool_settles_out_of_order(self, mk):
        """The result stage is a pool: a slow flush must not serialize later
        flushes behind it. Flush 1's finalize parks until flush 2 has fully
        settled, which only concurrent resolvers can do."""
        import threading

        _, eng, q, _ = mk(max_delay_ms=1.0, max_in_flight=4)
        real = eng.finalize_many
        gate = threading.Event()
        first = threading.Event()

        def slow_finalize(n, plan, _real=real):
            if not first.is_set():
                first.set()
                assert gate.wait(timeout=30), "later flush never settled concurrently"
            return _real(n, plan)

        eng.finalize_many = slow_finalize
        with q:
            f1 = q.submit(np.asarray([0, 1], np.int32))
            t0 = time.time()
            while q.flushes < 1 and time.time() - t0 < 10:
                time.sleep(0.005)  # make sure f1's flush is cut before f2 arrives
            f2 = q.submit(np.asarray([2, 3], np.int32))
            assert f2.result(timeout=30) is not None  # settles while f1 is parked
            gate.set()
            assert f1.result(timeout=30) is not None

    def test_max_in_flight_backpressure_is_exact(self, mk):
        """At most max_in_flight flushes may be dispatched-but-unsettled,
        even with more resolver threads than slots: the semaphore, not the
        resolve queue, is the bound (a bounded queue stops counting a flush
        the moment a resolver picks it up)."""
        import threading

        _, eng, q, _ = mk(max_delay_ms=1.0, max_in_flight=1, resolver_threads=2)
        gate = threading.Event()
        real_fin = eng.finalize_many
        real_dev = eng.retrieve_many_device
        dev_calls = []

        def blocking_finalize(n, plan, _real=real_fin):
            assert gate.wait(timeout=30)
            return _real(n, plan)

        def counting_dev(*a, **k):
            dev_calls.append(1)
            return real_dev(*a, **k)

        eng.finalize_many = blocking_finalize
        eng.retrieve_many_device = counting_dev
        with q:
            f1 = q.submit(np.asarray([0, 1], np.int32))
            t0 = time.time()
            while not dev_calls and time.time() - t0 < 10:
                time.sleep(0.005)
            f2 = q.submit(np.asarray([2, 3], np.int32))
            time.sleep(0.3)  # worker must be parked at the in-flight semaphore
            assert len(dev_calls) == 1
            gate.set()
            assert f1.result(timeout=30) is not None
            assert f2.result(timeout=30) is not None
        assert len(dev_calls) == 2

    def test_worker_survives_concurrent_manual_flush(self, mk):
        """A manual flush() that drains the queue while the worker sits in
        its delay wait must not kill the worker (regression: the wake-up
        re-evaluation once read a separate oldest-enqueue clock, which the
        flush reset to None; now it re-derives from _pending[0])."""
        _, eng, q, hist = mk(max_delay_ms=200.0)
        with q:
            f1 = q.submit(np.asarray([0, 1], np.int32))
            time.sleep(0.05)  # worker is now waiting out the delay budget
            q.flush()  # drain from the caller's thread
            assert f1.result(timeout=60) is not None
            time.sleep(0.3)  # let the worker wake from its stale timeout
            f2 = q.submit(np.asarray([2, 3], np.int32))
            assert f2.result(timeout=60) is not None  # worker still alive


class TestAdmissionControl:
    """Overload semantics: bounded queue depth
    rejects at submit(); deadlines shed still-queued requests at batch-cut
    time. All failures are typed and the queue stays healthy after."""

    def test_overload_rejects_with_typed_error(self, mk):
        from rqvae_tpu_torch.serving.queue import QueueOverloadedError

        _, eng, q, hist = mk(autostart=False, max_queue_depth=3)
        h = np.asarray(hist[0][:4], np.int32)
        futs = [q.submit(h) for _ in range(5)]
        # rejects resolve IMMEDIATELY (no flush needed), admits stay pending
        for f in futs[:3]:
            assert not f.done()
        for f in futs[3:]:
            assert f.done()
            try:
                f.result(timeout=0)
                assert False, "expected QueueOverloadedError"
            except QueueOverloadedError:
                pass
        assert q.flush() == 3
        for f in futs[:3]:
            assert f.result(timeout=0).item_ids.shape == (5,)
        s = q.stats()
        assert s["rejected"] == 2 and s["admitted"] == 3 and s["requests"] == 5
        # queue stays healthy: depth freed by the flush admits again
        f = q.submit(h)
        assert q.flush() == 1
        assert f.result(timeout=0).item_ids.shape == (5,)

    def test_deadline_sheds_queued_requests(self, mk):
        from rqvae_tpu_torch.serving.queue import DeadlineExceededError

        _, eng, q, hist = mk(autostart=False, deadline_ms=20.0)
        h = np.asarray(hist[0][:4], np.int32)
        expired = [q.submit(h) for _ in range(2)]
        time.sleep(0.06)  # both deadlines elapse while queued
        fresh = q.submit(h)  # enqueued now: 20 ms budget still live
        assert q.flush() == 1  # only the fresh request is dispatched
        for f in expired:
            try:
                f.result(timeout=0)
                assert False, "expected DeadlineExceededError"
            except DeadlineExceededError:
                pass
        assert fresh.result(timeout=0).item_ids.shape == (5,)
        assert q.stats()["shed"] == 2

    def test_per_request_deadline_override(self, mk):
        from rqvae_tpu_torch.serving.queue import DeadlineExceededError

        _, eng, q, hist = mk(autostart=False)  # no queue-level deadline
        h = np.asarray(hist[0][:4], np.int32)
        tight = q.submit(h, deadline_ms=1.0)
        loose = q.submit(h)
        time.sleep(0.02)
        assert q.flush() == 1
        try:
            tight.result(timeout=0)
            assert False, "expected DeadlineExceededError"
        except DeadlineExceededError:
            pass
        assert loose.result(timeout=0).item_ids.shape == (5,)

    def test_worker_path_reject_keeps_serving(self, mk):
        """With the worker live and depth=0 every submit rejects instantly,
        and re-raising the bound (depth=None path) serves normally — the
        reject path never wedges the worker/resolver threads."""
        from rqvae_tpu_torch.serving.queue import QueueOverloadedError

        _, eng, q, hist = mk(autostart=True, max_queue_depth=0, max_delay_ms=1.0)
        h = np.asarray(hist[0][:4], np.int32)
        try:
            f = q.submit(h)
            try:
                f.result(timeout=60)
                assert False, "expected QueueOverloadedError"
            except QueueOverloadedError:
                pass
            q.max_queue_depth = None  # lift the bound: worker serves again
            f2 = q.submit(h)
            assert f2.result(timeout=60).item_ids.shape == (5,)
            s = q.stats()
            assert s["rejected"] == 1 and s["admitted"] == 1
        finally:
            q.close()
