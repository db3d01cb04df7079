"""The port's bucketed engine on the CPU (eager), mirroring the single-device
cases of tests/test_engine.py, and held against the JAX engine: the same
weights and histories give the same item ids and beams.

Padding to buckets is invisible: a bucketed request's beams equal the
direct retrieve at the request's own shape (ids exact, log_probas within
rtol 1e-4, atol 1e-5: padded shapes sum in another order)."""

import numpy as np
import pytest

from rqvae_tpu.serving.engine import RetrievalEngine as JEngine
from rqvae_tpu.serving.retriever import Retriever as JRetriever

from rqvae_tpu_torch.serving.engine import RetrievalEngine, _default_item_buckets

from tests.torch_serving_fixture import both_packages


@pytest.fixture(scope="module")
def packages():
    return both_packages()


def _mk(packages, max_items=8, batch_buckets=(1, 2, 4)):
    _, r, hist = packages
    return r, RetrievalEngine(r, max_items=max_items, batch_buckets=batch_buckets), hist


def _clean(h):
    h = np.asarray(h, np.int32)
    return h[h >= 0]


def test_default_item_buckets():
    assert _default_item_buckets(8) == (8,)
    assert _default_item_buckets(20) == (8, 16, 20)
    assert _default_item_buckets(200) == (8, 16, 32, 64, 128, 200)


def test_bucket_rounding(packages):
    _, eng, _ = _mk(packages, max_items=20)
    assert eng.item_buckets == (8, 16, 20) and eng.batch_buckets == (1, 2, 4) and not eng.use_graphs
    assert eng._bucket_for(3, eng.item_buckets) == 8
    assert eng._bucket_for(9, eng.item_buckets) == 16
    assert eng._bucket_for(17, eng.item_buckets) == 20


def test_bucketed_equals_direct_and_jax(packages):
    """Each request's engine row equals the direct retrieve at the request's
    own shape, and the JAX engine's row over the same weights."""
    (jm, jparams, jtok), _, _ = packages
    r, eng, hist = _mk(packages)
    requests = [hist[0][:3], hist[1][:8], hist[2][:5], hist[3][:2], hist[4][:8]]
    out = eng.retrieve_many(requests)
    assert out.item_ids.shape == (5, 5) and out.sem_ids.shape == (5, 5, 3)
    for i, h in enumerate(requests):
        direct = r.retrieve(_clean(h)[None, :])
        np.testing.assert_array_equal(out.sem_ids[i], direct.sem_ids.numpy()[0])
        np.testing.assert_array_equal(out.item_ids[i], direct.item_ids.numpy()[0])
        np.testing.assert_allclose(out.log_probas[i], direct.log_probas.numpy()[0], rtol=1e-4, atol=1e-5)
    want = JEngine(JRetriever(jm, jparams, jtok), max_items=8, batch_buckets=(1, 2, 4)).retrieve_many(requests)
    np.testing.assert_array_equal(out.item_ids, np.asarray(want.item_ids))
    np.testing.assert_array_equal(out.sem_ids, np.asarray(want.sem_ids))
    np.testing.assert_allclose(out.log_probas, np.asarray(want.log_probas), rtol=1e-4, atol=1e-5)


def test_batch_padding_rows_are_dropped(packages):
    _, eng, hist = _mk(packages, batch_buckets=(4,))
    out = eng.retrieve_many([hist[0][:4]])  # 1 request in a batch-4 bucket
    assert out.item_ids.shape == (1, 5)
    assert eng.shape_counts == {(4, 8): 1}


def test_truncation_keeps_most_recent(packages):
    r, eng, hist = _mk(packages, max_items=4)
    h = _clean(hist[1])
    assert len(h) >= 6
    out = eng.retrieve_many([h])
    np.testing.assert_array_equal(out.sem_ids[0], r.retrieve(h[-4:][None, :]).sem_ids.numpy()[0])


def test_grouping_and_order(packages):
    """Requests come back in input order even when bucket groups split and
    reorder the dispatches."""
    _, eng, hist = _mk(packages, batch_buckets=(1, 2))
    requests = [hist[i][: (3 if i % 2 else 8)] for i in range(5)]
    out = eng.retrieve_many(requests)
    for i, h in enumerate(requests):
        np.testing.assert_array_equal(out.sem_ids[i], eng.retrieve_many([h]).sem_ids[0])
    assert all(shape[1] == 8 for shape in eng.shape_counts)


def test_warmup_runs_every_bucket(packages):
    _, eng, _ = _mk(packages, batch_buckets=(1, 2))
    assert eng.warmup() == len(eng.item_buckets) * len(eng.batch_buckets)
    with pytest.raises(ValueError, match="max_items"):
        RetrievalEngine(packages[1], max_items=20, item_buckets=(8, 16))


def test_the_captured_body_reads_nothing_back_to_the_host(packages):
    """What a CUDA graph captures (`Retriever._retrieve_body`) must make no
    host read (.item(), nonzero) and no tensor from host data (a copy to
    the card): recorded op by op on the CPU, as a rehearsal of the capture."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    banned = {"_local_scalar_dense", "nonzero", "lift_fresh", "lift_fresh_copy", "item"}

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.add(func.__name__.split(".")[0])
            return func(*args, **(kwargs or {}))

    _, r, hist = packages
    h, u = torch.as_tensor(hist, dtype=torch.int32), torch.zeros(len(hist), dtype=torch.int32)
    with torch.no_grad():
        r._retrieve_body(h, u)  # the eager run the engine makes before each capture
        with Record() as rec:
            r._retrieve_body(h, u)
    assert "searchsorted" in rec.ops and not rec.ops & banned, rec.ops & banned
    with Record() as probe:  # the recorder does see what it bans
        torch.tensor([1, 2]).sum().item()
    assert probe.ops & banned
