"""Async micro-batching front end (port of rqvae_tpu/serving/queue.py).

`AsyncRetrievalEngine.submit()` returns a `concurrent.futures.Future` at
once; a single dispatch worker thread coalesces queued requests and flushes
them through the engine (`RetrievalEngine.retrieve_many_device`: one CUDA
graph replay per bucket group on the card) when enough requests wait to fill
the largest batch bucket, or when the oldest has waited `max_delay_ms`.

The wait for a flush's results (`finalize_many`, which waits on the
dispatch's event and reads its pinned host buffers) runs on a pool of
resolver threads, so the worker dispatches the next flush meanwhile; a
`max_in_flight` semaphore bounds the flushes dispatched but not settled.
`max_queue_depth` rejects a submit past that many pending requests
(QueueOverloadedError), and a request still queued past its deadline is shed
at batch-cut time (DeadlineExceededError). A submitted request resolves to
exactly its row of `retrieve_many` over the same flush.

Every request is stamped on one clock (`time.perf_counter_ns`), so that its
latency is exactly the sum of three records of the queue's `Recorder` (a
child of utils/profiling.py's root): `queue.wait`, from `submit()` to the
cut of its flush; `queue.dispatch`, its flush's from the cut until the plan
goes on the resolver queue (the wait on the in-flight semaphore inside it as
`queue.backpressure`); `queue.resolve`, from there to the flush's last future
set (the wait for a free resolver and `finalize_many` inside it). The spans of
one flush carry its number as `flush`. While the queue is open a
`gc.callbacks` hook counts Python's collections and their pauses by
generation (`queue.gc_pause.<generation>`); `queue.open` counts the seconds
the queue was open, at `close()`.
"""

from __future__ import annotations

import gc
import queue as _queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Optional

import numpy as np
import torch

from rqvae_tpu_torch.serving.engine import RetrievalEngine
from rqvae_tpu_torch.serving.retriever import RetrievalResult
from rqvae_tpu_torch.utils import profiling

GC_PAUSES = tuple(f"queue.gc_pause.{g}" for g in range(3))


class QueueOverloadedError(RuntimeError):
    """Admission rejected: the pending queue is at max_queue_depth. Past
    saturation a bounded queue rejects excess load at submit() time rather
    than admitting it into a backlog where every request is served too late.
    The future returned by submit() resolves with this error; the queue stays
    healthy."""


class DeadlineExceededError(TimeoutError):
    """Shed after admission: the request was still queued when its deadline
    elapsed, so it was dropped at batch-cut time rather than dispatched."""


class AsyncRetrievalEngine:
    """Micro-batching request queue over a `RetrievalEngine`.

    Args:
      engine: the shape-bucketed batch engine to dispatch through.
      max_delay_ms: tail-latency bound — a queued request never waits
        longer than this for co-batching before a flush is forced.
      autostart: start the worker thread immediately. Tests (and callers
        that want deterministic batching) can pass False and call
        `flush()` manually.
      max_in_flight: backpressure — at most this many flushes dispatched
        but not yet resolved (bounds device result buffers held alive).
      resolver_threads: size of the host-fetch pool; defaults to
        max_in_flight (one resolver per in-flight slot, so every
        in-flight flush's transfers drain concurrently).
      max_queue_depth: admission control — at most this many requests
        pending (queued, not yet dispatched). A submit() past the bound
        returns a Future already failed with QueueOverloadedError; the
        caller sees the rejection immediately instead of an unbounded
        wait. None = admit everything (legacy behavior; p50 then grows
        with backlog depth without limit past the saturation knee).
      deadline_ms: default per-request deadline measured from enqueue.
        A request still PENDING when its deadline elapses is shed at
        batch-cut time (future fails with DeadlineExceededError) rather
        than dispatched, so the device never computes results nobody can
        use. Overridable per request via submit(deadline_ms=...).
        None = no deadline.
    """

    def __init__(
        self,
        engine: RetrievalEngine,
        max_delay_ms: float = 5.0,
        autostart: bool = True,
        max_in_flight: int = 4,
        resolver_threads: Optional[int] = None,
        max_queue_depth: Optional[int] = None,
        deadline_ms: Optional[float] = None,
    ):
        self.engine = engine
        self.max_delay_ns = int(max_delay_ms * 1e6)
        self.max_queue_depth = max_queue_depth
        self.default_deadline_ns = None if deadline_ms is None else int(deadline_ms * 1e6)
        self._cap = engine.batch_buckets[-1]
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        # (history, user_id, Future, enqueue ns, deadline ns|None);
        # deque so a deep backlog
        # doesn't pay O(n) list re-slicing per flush. The delay bound always
        # derives from _pending[0]'s TRUE enqueue time — no separate
        # "oldest" clock that a flush would reset to now() (which silently
        # extended survivors' deadlines past max_delay_ms).
        self._pending: deque = deque()
        self._shutdown = False
        self._worker: Optional[threading.Thread] = None
        # Backpressure: at most max_in_flight flushes dispatched but not
        # yet settled. A semaphore (acquired before dispatch, released
        # after settle/fail) keeps that invariant exact under a resolver
        # POOL — a bounded queue alone would stop counting a flush the
        # moment a resolver picked it up.
        self._in_flight = max(1, max_in_flight)
        self._inflight_sem = threading.BoundedSemaphore(self._in_flight)
        self._resolve_q: _queue.Queue = _queue.Queue()
        # one resolver per in-flight slot by default: each in-flight flush
        # can drain its (already started) transfers concurrently
        self._n_resolvers = (
            self._in_flight if resolver_threads is None else max(1, resolver_threads)
        )
        self._resolvers: list = []
        # observability
        self.flushes = 0
        self.requests = 0
        self.rejected = 0  # admission-control rejects (QueueOverloadedError)
        self.shed = 0  # post-admission deadline sheds (DeadlineExceededError)
        self.recorder = profiling.Recorder(profiling.ROOT)  # read through stats()
        self._opened_ns: Optional[int] = None
        self._gc_t0: Optional[int] = None
        if autostart:
            self.start()

    # ---- lifecycle ----

    def start(self) -> None:
        if self._opened_ns is None:
            self._opened_ns = time.perf_counter_ns()
            gc.callbacks.append(self._on_gc)
        if self._worker is None or not self._worker.is_alive():
            self._shutdown = False
            self._worker = threading.Thread(
                target=self._run, name="rqvae-serving-queue", daemon=True
            )
            self._worker.start()
        self._resolvers = [t for t in self._resolvers if t.is_alive()]
        for i in range(len(self._resolvers), self._n_resolvers):
            t = threading.Thread(
                target=self._run_resolver, name=f"rqvae-serving-resolver-{i}", daemon=True
            )
            t.start()
            self._resolvers.append(t)

    def close(self) -> None:
        """Drain the queue, then stop the worker and resolvers."""
        with self._cond:
            self._shutdown = True
            self._cond.notify_all()
        if self._worker is not None and self._worker.is_alive():
            self._worker.join()
        live = [t for t in self._resolvers if t.is_alive()]
        for _ in live:
            self._resolve_q.put(None)  # sentinels AFTER the worker's last put
        for t in live:
            t.join()
        self._resolvers = []
        # a close() without a worker (autostart=False) still drains
        self.flush()
        if self._opened_ns is not None:
            gc.callbacks.remove(self._on_gc)
            self.recorder.count("queue.open", value=(time.perf_counter_ns() - self._opened_ns) * 1e-9)
            self._opened_ns = None

    def _on_gc(self, phase: str, info: dict) -> None:
        """gc.callbacks hook: a collection's pause, on whichever thread ran it
        (no collection starts inside another)."""
        if phase == "start":
            self._gc_t0 = time.perf_counter_ns()
        elif self._gc_t0 is not None:
            pause = (time.perf_counter_ns() - self._gc_t0) * 1e-9
            self._gc_t0 = None
            self.recorder.count(GC_PAUSES[info["generation"]], value=pause)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---- submission ----

    def submit(self, history, user_id: int = 0, deadline_ms: Optional[float] = None) -> Future:
        """Enqueue one request (1-D item-id history). Returns a Future
        resolving to a per-request RetrievalResult (arrays of shape [k],
        [k, L], [k]) — identical to that request's row out of
        `RetrievalEngine.retrieve_many`.

        Overload: if max_queue_depth is set and the pending queue is full,
        the returned Future is ALREADY failed with QueueOverloadedError —
        rejection is signalled through the same channel as every other
        outcome, so callers/load-generators handle it uniformly.
        deadline_ms overrides the queue-level default for this request."""
        h = np.asarray(history, np.int32)
        assert h.ndim == 1, "submit() takes a single 1-D history"
        fut: Future = Future()
        dl = self.default_deadline_ns if deadline_ms is None else int(deadline_ms * 1e6)
        now = time.perf_counter_ns()
        with self._cond:
            if self._shutdown:
                raise RuntimeError("AsyncRetrievalEngine is closed")
            self.requests += 1
            if (
                self.max_queue_depth is not None
                and len(self._pending) >= self.max_queue_depth
            ):
                self.rejected += 1
                fut.set_exception(
                    QueueOverloadedError(
                        f"queue at max_queue_depth={self.max_queue_depth}"
                    )
                )
                return fut
            self._pending.append((h, int(user_id), fut, now,
                                  None if dl is None else now + dl))
            self._cond.notify_all()
        return fut

    # ---- batching / dispatch ----

    def _take_batch(self) -> tuple:
        """Under the lock: pop up to `cap` LIVE requests. Returns
        (batch, expired, cut time): expired requests (deadline already
        passed at cut time) are popped alongside and must be failed by the
        caller OUTSIDE the lock via _fail_expired (set_exception runs
        done-callbacks in the calling thread; a callback that re-submits
        would deadlock on the condition lock)."""
        batch, expired = [], []
        now = time.perf_counter_ns()
        while self._pending and len(batch) < self._cap:
            item = self._pending.popleft()
            if item[4] is not None and now > item[4]:
                expired.append(item)
            else:
                batch.append(item)
        self.shed += len(expired)
        return batch, expired, now

    @staticmethod
    def _fail_expired(expired: list) -> None:
        for item in expired:
            item[2].set_exception(
                DeadlineExceededError("request shed: deadline elapsed while queued")
            )

    def _record_flush(self, batch: list, cut: int) -> dict:
        """Count a flush cut at `cut` and its requests' waits; returns the
        arguments its spans carry."""
        self.flushes += 1
        self.recorder.count("queue.flush_size", value=len(batch))
        self.recorder.record("queue.wait", [(cut - b[3]) * 1e-9 for b in batch])
        return {"flush": self.flushes}

    def _settle(self, batch: list, res, resolve: profiling.Span) -> None:
        """Resolve a flush's futures from the fetched host result; the last
        one set ends the flush's `queue.resolve` span and every latency."""
        futs = [b[2] for b in batch]
        for i, f in enumerate(futs):
            f.set_result(RetrievalResult(*(np.asarray(a)[i] for a in res)))
        done = resolve.stop()
        self.recorder.record("queue.latency", [(done - b[3]) * 1e-9 for b in batch])

    def _fail(self, batch: list, e: Exception) -> None:
        for _, _, f, *_rest in batch:  # resolve every waiter, never deadlock
            if not f.done():
                f.set_exception(e)

    def _dispatch(self, batch: list, cut: int) -> None:
        """Synchronous flush (manual mode / final drain): dispatch, fetch,
        resolve in one step."""
        if not batch:
            return
        args = self._record_flush(batch, cut)
        rec = self.recorder
        with rec.span("queue.dispatch", args, start=cut) as dispatch:
            try:
                plan = self.engine.retrieve_many_device([b[0] for b in batch], [b[1] for b in batch])
            except Exception as e:
                self._fail(batch, e)
                return
            put = dispatch.stop()
        with rec.span("queue.resolve", args, start=put) as resolve:
            try:
                res = self.engine.finalize_many(len(batch), plan)
            except Exception as e:
                self._fail(batch, e)
                return
            self._settle(batch, res, resolve)

    def _dispatch_async(self, batch: list, cut: int) -> None:
        """Worker path: dispatch the bucket replays and hand the unfetched
        plan to the resolver pool, so the wait for one flush's results
        overlaps the next flush's dispatch."""
        if not batch:
            return
        args = self._record_flush(batch, cut)
        rec = self.recorder
        with rec.span("queue.dispatch", args, start=cut) as dispatch:
            with rec.span("queue.backpressure", args):
                self._inflight_sem.acquire()  # blocks at max_in_flight unsettled
            try:
                plan = self.engine.retrieve_many_device(
                    [b[0] for b in batch], [b[1] for b in batch]
                )
            except Exception as e:
                self._inflight_sem.release()
                self._fail(batch, e)
                return
            self._resolve_q.put((batch, plan, dispatch.stop(), args))

    def _run_resolver(self) -> None:
        while True:
            item = self._resolve_q.get()
            if item is None:
                return
            batch, plan, put, args = item
            with self.recorder.span("queue.resolve", args, start=put) as resolve:
                try:
                    res = self.engine.finalize_many(len(batch), plan)
                except Exception as e:
                    self._fail(batch, e)
                    continue
                finally:
                    self._inflight_sem.release()
                self._settle(batch, res, resolve)

    def stats(self) -> dict:
        """Service-level observability since the queue was made, from its
        recorder: end-to-end latency percentiles (submit -> result, seconds),
        the dispatch batch-size distribution, the median wait for a flush and
        resolve, the seconds spent at the in-flight bound, and Python's
        collections while open. Thread-safe snapshot."""
        agg = self.recorder.snapshot()
        out = {
            "requests": self.requests,
            "flushes": self.flushes,
            # admission control: the latency percentiles below cover admitted
            # and served requests; rejected and shed ones are counted here
            "rejected": self.rejected,
            "shed": self.shed,
            "admitted": self.requests - self.rejected,
        }
        lat, sizes = agg.get("queue.latency"), agg.get("queue.flush_size")
        if lat is not None:
            out.update(latency_p50_s=lat.quantile(0.5), latency_p95_s=lat.quantile(0.95),
                       latency_p99_s=lat.quantile(0.99), latency_mean_s=lat.mean)
        if sizes is not None:
            out.update(batch_size_mean=sizes.mean, batch_size_max=int(sizes.max))
        for key, name in (("wait_p50_s", "queue.wait"), ("resolve_p50_s", "queue.resolve")):
            if name in agg:
                out[key] = agg[name].quantile(0.5)
        out["backpressure_s"] = agg["queue.backpressure"].total if "queue.backpressure" in agg else 0.0
        pauses = [agg[n] for n in GC_PAUSES if n in agg]
        out["gc_pauses"] = sum(a.count for a in pauses)
        out["gc_pause_s"] = sum(a.total for a in pauses)
        return out

    def flush(self) -> int:
        """Synchronously dispatch everything currently queued (manual mode
        or final drain). Returns the number of requests served."""
        served = 0
        while True:
            with self._cond:
                if not self._pending:
                    return served
                batch, expired, cut = self._take_batch()
            self._fail_expired(expired)
            served += len(batch)
            self._dispatch(batch, cut)

    def _run(self) -> None:
        if self.engine.device.type == "cuda":
            torch.cuda.set_device(self.engine.device)  # the thread replays on the engine's card
        while True:
            with self._cond:
                while not self._pending and not self._shutdown:
                    self._cond.wait()
                if self._shutdown:
                    break
                # batch is full -> cut now; otherwise wait out the oldest
                # request's delay budget, waking early if the cap fills.
                # Re-check `self._pending` each wake: a concurrent manual
                # flush() may have drained the queue entirely.
                while (
                    self._pending
                    and len(self._pending) < self._cap
                    and not self._shutdown
                    and (left := self._pending[0][3] + self.max_delay_ns - time.perf_counter_ns()) > 0
                ):
                    self._cond.wait(timeout=left * 1e-9)
                batch, expired, cut = self._take_batch()
            self._fail_expired(expired)
            self._dispatch_async(batch, cut)
        self.flush()  # drain whatever arrived before close()
