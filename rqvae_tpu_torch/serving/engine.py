"""Shape-bucketed request batching, one CUDA graph per bucket (port of
rqvae_tpu/serving/engine.py).

Each request's history is padded with -1 up to the next ITEM bucket (masked
positions are exact no-ops), requests are grouped per bucket, and a group's
batch is padded up to the next BATCH bucket with empty rows, dropped on
return. Every (batch, items) bucket is one fixed shape, the counterpart of
the JAX package's one compiled program per shape.

On the card each bucket runs as one CUDA graph of the whole query
(`Retriever.shard_body`: tokenization from the table, the encoder, every
beam level and the inverse lookup), captured once, at `warmup()` or at the
bucket's first use, after one eager run on the engine's side stream (which
builds the kernel libraries and sets their launch attributes outside the
capture), with unreachable objects collected first (a graph of a dead
reference cycle, such as a training step runner's, destroyed by Python's
collector during a capture would invalidate it). All graphs share one
memory pool: their replays run one after another on that stream. A dispatch
writes its requests into pinned host memory, copies them into the graph's
static inputs without blocking, replays, and copies the three results into
pinned host buffers of its own, then records an event; `finalize_many` waits on the event. A capture that
fails raises: the card has no eager fallback. CPU tensors run eagerly, as
the tests run them.

Over a mesh-sharded Retriever (serving/retriever.py, `mesh=`) every batch
bucket is rounded up to a multiple of the mesh's 'data' size, as the JAX
engine rounds its buckets, and a bucket is one graph per shard, each
captured on its shard's device (`Retriever.shard_body` on its rows), with a
stream and a memory pool per device; a dispatch replays every shard's graph
and the event is recorded after all of them.

Spans (utils/profiling.py, the root recorder): `engine.dispatch` over
`retrieve_many_device`, `engine.launch` over a bucket group's replays (with
their copies) or its eager run, `engine.gather` over `finalize_many` and
`engine.wait` over each event wait in it (the gather's self time is the
host's stacking of rows), `engine.capture` over a bucket's capture with
`capture.eager`, `capture.collect` and `capture.record` (capture and
instantiate) inside.
"""

from __future__ import annotations

import gc
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from rqvae_tpu_torch.serving.retriever import RetrievalResult, Retriever
from rqvae_tpu_torch.utils import profiling
from rqvae_tpu_torch.utils.device import end_failed_capture


def _default_item_buckets(max_items: int) -> tuple:
    """Powers of two from 8 below max_items, and max_items itself."""
    buckets = []
    b = 8
    while b < max_items:
        buckets.append(b)
        b *= 2
    buckets.append(max_items)
    return tuple(buckets)


class BucketGraph(NamedTuple):
    """One shard of a captured bucket: static device inputs, the graph,
    static outputs (a bucket is a tuple of them, one per shard)."""

    hist: torch.Tensor  # [bb / shards, ib] int32
    uids: torch.Tensor  # [bb] int32
    noise: Optional[List[torch.Tensor]]  # sampled candidates: each level's Gumbel noise
    graph: "torch.cuda.CUDAGraph"
    out: RetrievalResult


class _InFlight(NamedTuple):
    """A replayed dispatch: its results' pinned host copies and the event
    recorded after the copies."""

    host: RetrievalResult
    event: "torch.cuda.Event"


class RetrievalEngine:
    """Batched, shape-bucketed front end over `Retriever`.

    `max_items` is the longest history served; a longer one keeps its most
    recent `max_items` items. On the card each bucket replays a CUDA graph;
    elsewhere it runs eagerly. Batch buckets are rounded up to multiples of
    the retriever's `batch_multiple` (its mesh's 'data' size; 1 without a
    mesh)."""

    def __init__(
        self,
        retriever: Retriever,
        max_items: int,
        item_buckets: Optional[Sequence[int]] = None,
        batch_buckets: Sequence[int] = (1, 4, 16, 64),
    ):
        self.retriever = retriever
        self.max_items = int(max_items)
        self.item_buckets = tuple(sorted(item_buckets) if item_buckets else _default_item_buckets(self.max_items))
        if self.item_buckets[-1] < self.max_items:
            raise ValueError("the largest item bucket must cover max_items")
        m = retriever.batch_multiple
        self.batch_buckets = tuple(sorted({max(-(-b // m) * m, m) for b in batch_buckets}))
        self.shape_counts: dict = {}  # batches run at each (batch, items) shape
        self.device = retriever.device
        self.use_graphs = self.device.type == "cuda"
        self.graphs: dict = {}  # (batch bucket, item bucket) -> (BucketGraph of each shard, ...)
        self.captures = 0  # buckets captured so far: a served shape captured once stays captured
        if self.use_graphs:
            devices = [s.table.device for s in retriever.shards]
            self.streams = {d: torch.cuda.Stream(d) for d in dict.fromkeys(devices)}
            self.pools = {d: torch.cuda.graph_pool_handle() for d in self.streams}
            self.stream = self.streams[self.device]

    def _bucket_for(self, n: int, buckets: tuple) -> int:
        for b in buckets:
            if n <= b:
                return b
        return buckets[-1]

    # ---- graphs ----

    def _capture_shard(self, body, dev: torch.device, bb: int, ib: int) -> BucketGraph:
        """The graph of `body` over bb rows of ib items on `dev`."""
        r = self.retriever
        hist = torch.full((bb, ib), -1, dtype=torch.int32, device=dev)
        hist[:, 0] = 0  # one valid item per row
        uids = torch.zeros(bb, dtype=torch.int32, device=dev)
        noise = r.draw_noise(bb)
        if noise is not None:
            noise = [g.to(dev) for g in noise]
        stream = self.streams[dev]
        with torch.cuda.device(dev):
            stream.wait_stream(torch.cuda.current_stream(dev))
            with profiling.span("capture.eager"), torch.no_grad(), torch.cuda.stream(stream):
                body(hist, uids, noise)  # eager: builds, loads and sets up every kernel first
            graph = torch.cuda.CUDAGraph(keep_graph=True)  # kept, so its nodes can be read (debug_dump)
            with profiling.span("capture.collect"):
                gc.collect()  # no graph of a dead cycle may be destroyed while this one captures
            try:
                # thread_local: a resolver thread's event waits do not void a capture
                with profiling.span("capture.record"):
                    with torch.no_grad(), torch.cuda.graph(graph, pool=self.pools[dev], stream=stream,
                                                           capture_error_mode="thread_local"):
                        out = body(hist, uids, noise)
                    graph.instantiate()
            except Exception as e:
                end_failed_capture(dev)
                raise RuntimeError(f"CUDA graph capture of bucket (batch {bb}, items {ib}) failed: {e}") from e
        return BucketGraph(hist, uids, noise, graph, out)

    def _capture(self, bb: int, ib: int) -> tuple:
        """A bucket's graphs: each shard's on its device (one without a mesh)."""
        r = self.retriever
        rows = bb // r.batch_multiple
        self.captures += 1
        with profiling.span("engine.capture"):
            return tuple(self._capture_shard(lambda h, u, n, i=i: r.shard_body(i, h, u, n), s.table.device, rows,
                                             ib) for i, s in enumerate(r.shards))

    def graph_for(self, bb: int, ib: int) -> tuple:
        """The bucket's graph, captured at first use."""
        g = self.graphs.get((bb, ib))
        if g is None:
            with self.retriever._lock, torch.cuda.device(self.device):
                g = self.graphs.get((bb, ib))  # another thread may have captured it meanwhile
                if g is None:
                    g = self.graphs[(bb, ib)] = self._capture(bb, ib)
        return g

    def _replay(self, padded: np.ndarray, users: np.ndarray) -> _InFlight:
        bb, ib = padded.shape
        shards = self.graph_for(bb, ib)
        r = self.retriever
        rows = bb // len(shards)
        hist_host = torch.from_numpy(padded).pin_memory()
        uids_host = torch.from_numpy(users).pin_memory()
        host = RetrievalResult(*(torch.empty((bb, *t.shape[1:]), dtype=t.dtype, pin_memory=True)
                                 for t in shards[0].out))
        event = torch.cuda.Event()
        with r._lock, profiling.span("engine.launch"):
            for i, g in enumerate(shards):
                part = slice(i * rows, (i + 1) * rows)
                noise = r.draw_noise(rows)  # each shard draws its own
                dev = g.hist.device
                with torch.cuda.device(dev), torch.cuda.stream(self.streams[dev]):
                    g.hist.copy_(hist_host[part], non_blocking=True)
                    g.uids.copy_(uids_host[part], non_blocking=True)
                    if noise is not None:
                        for buf, n in zip(g.noise, noise):
                            buf.copy_(n.pin_memory(), non_blocking=True)
                    g.graph.replay()
                    for h, t in zip(host, g.out):
                        h[part].copy_(t, non_blocking=True)
            for stream in self.streams.values():  # the event follows every shard's copies
                if stream is not self.stream:
                    self.stream.wait_stream(stream)
            event.record(self.stream)
        return _InFlight(host, event)

    # ---- batching ----

    def _run_group_device(self, hists, uids, item_bucket):
        """Dispatch one bucket-shaped batch: a graph replay on the card
        (returns the in-flight copies) or an eager retrieve on the CPU
        (returns its result). Callers slice rows after `finalize_many`."""
        n = len(hists)
        bb = self._bucket_for(n, self.batch_buckets)
        padded = np.full((bb, item_bucket), -1, np.int32)
        users = np.zeros((bb,), np.int32)
        for i, h in enumerate(hists):
            padded[i, : len(h)] = h
            users[i] = uids[i]
        self.shape_counts[(bb, item_bucket)] = self.shape_counts.get((bb, item_bucket), 0) + 1
        if self.use_graphs:
            return self._replay(padded, users)
        with profiling.span("engine.launch"):
            return self.retriever.retrieve(padded, users)

    def retrieve_many_device(
        self,
        histories: Sequence[np.ndarray],  # per-request 1-D item-id arrays
        user_ids: Optional[Sequence[int]] = None,
    ) -> list:
        """Dispatch phase of retrieve_many: bucket the requests, dispatch one
        batch per (batch, items) bucket group, and return the plan of
        (request indices, result) pairs without waiting for the results;
        `finalize_many` turns the plan into the stacked host result."""
        if user_ids is None:
            user_ids = [0] * len(histories)
        if len(user_ids) != len(histories):
            raise ValueError(f"{len(user_ids)} user ids for {len(histories)} histories")
        with profiling.span("engine.dispatch"):
            cleaned = []
            for h in histories:  # drop pad markers, keep the most recent max_items
                h = np.asarray(h, np.int32)
                h = h[h >= 0]
                cleaned.append(h[-self.max_items:])
            groups: dict = {}
            for i, h in enumerate(cleaned):
                groups.setdefault(self._bucket_for(max(len(h), 1), self.item_buckets), []).append(i)
            plan = []
            cap = self.batch_buckets[-1]
            for item_bucket, idxs in sorted(groups.items()):
                for s in range(0, len(idxs), cap):  # oversize groups split at the largest batch bucket
                    chunk = idxs[s: s + cap]
                    res = self._run_group_device([cleaned[i] for i in chunk], [user_ids[i] for i in chunk],
                                                 item_bucket)
                    plan.append((chunk, res))
            return plan

    @staticmethod
    def finalize_many(n_requests: int, plan: list) -> RetrievalResult:
        """Fetch phase: wait for each group's results and stack per-request
        rows (numpy) in request order."""
        with profiling.span("engine.gather"):
            out = [None] * n_requests
            for chunk, res in plan:
                if isinstance(res, _InFlight):
                    with profiling.span("engine.wait"):
                        res.event.synchronize()
                    res = res.host
                host = [t.cpu().numpy() for t in res]
                for j, i in enumerate(chunk):
                    out[i] = [a[j] for a in host]
            return RetrievalResult(*(np.stack(cols) for cols in zip(*out)))

    def retrieve_many(
        self,
        histories: Sequence[np.ndarray],
        user_ids: Optional[Sequence[int]] = None,
    ) -> RetrievalResult:
        """Serve variable-length requests; results stack in request order."""
        return self.finalize_many(len(histories), self.retrieve_many_device(histories, user_ids))

    def warmup(self) -> int:
        """Capture every (batch, items) bucket's graph on the card, or run each
        bucket once on the CPU. Returns the number of buckets."""
        n = 0
        for ib in self.item_buckets:
            for bb in self.batch_buckets:
                if self.use_graphs:
                    self.graph_for(bb, ib)
                else:
                    dummy = np.full((bb, ib), -1, np.int32)
                    dummy[:, 0] = 0
                    self.retriever.retrieve(dummy, np.zeros((bb,), np.int32))
                n += 1
        return n
