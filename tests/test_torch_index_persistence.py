"""Saved indexes, corpus growth and the grown retriever, port against JAX on
the CPU, mirroring tests/test_corpus_extension.py (same corpus of 200 items
with engineered duplicate tuples, the first 128 indexed, the rest admitted).

Integers exact: cached ids and dedup columns, prefix tables, beam sem_ids
and item ids; log_probas within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rqvae_tpu.data.schemas import SeqBatch
from rqvae_tpu.models import retrieval as jr
from rqvae_tpu.serving import beam as jbeam
from rqvae_tpu.serving.retriever import Retriever as JRetriever
from rqvae_tpu.tokenizer.semids import SemanticIdTokenizer as JTokenizer

from rqvae_tpu_torch.models import retrieval as tr
from rqvae_tpu_torch.models.quantize import QuantizeForwardMode
from rqvae_tpu_torch.models.rqvae import RqVae, RqVaeConfig
from rqvae_tpu_torch.serving import beam as tbeam
from rqvae_tpu_torch.serving.engine import RetrievalEngine
from rqvae_tpu_torch.serving.retriever import Retriever
from rqvae_tpu_torch.tokenizer.semids import SemanticIdTokenizer
from rqvae_tpu_torch.utils.convert import load_jax_params

from tests.test_corpus_extension import N, N_OLD, _features, _vae

DEC = dict(num_hierarchies=3, codebook_size=8, t5_d_model=32, t5_d_kv=8, t5_num_heads=4, t5_d_ff=64,
           t5_num_layers=1, top_k_for_generation=5)


@pytest.fixture(scope="module")
def setup():
    """The JAX RQ-VAE and features of tests/test_corpus_extension.py, the
    port's RQ-VAE with the same weights, and a small decoder in both."""
    data, feats = _features()
    rq, rq_params = _vae(feats)
    trq = load_jax_params(RqVae(RqVaeConfig(input_dim=16, embed_dim=8, hidden_dims=(16,), codebook_size=8,
                                            n_layers=3, codebook_mode=QuantizeForwardMode.STE), device="cpu"),
                          jax.device_get(rq_params))
    jtok = JTokenizer(rq, rq_params)
    jtok.precompute_corpus_ids(feats)
    hist = np.asarray(data["seq_items"][:6, :8])
    batch = SeqBatch(user_ids=jnp.zeros(6, jnp.int32), ids=jnp.asarray(hist), ids_fut=jnp.zeros(6, jnp.int32),
                     x=jnp.zeros((6, 0, 0)), x_fut=jnp.zeros((6, 0)), seq_mask=jnp.asarray(hist >= 0))
    jm = jr.EncoderDecoderRetrievalModel(jr.RetrievalConfig(**DEC, t5_dropout=0.0))
    init = jax.jit(lambda rngs, b: jm.init(rngs, b, training=True))
    params = jax.device_get(init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, jtok(batch)))
    tm = load_jax_params(tr.EncoderDecoderRetrievalModel(tr.RetrievalConfig(**DEC), device="cpu"), params)
    return dict(feats=feats, hist=hist, rq=rq, rq_params=rq_params, trq=trq, jtok=jtok, jm=jm, params=params, tm=tm)


def _tok(s, feats):
    t = SemanticIdTokenizer(s["trq"], device="cpu")
    t.precompute_corpus_ids(feats)
    return t


def test_tokenizer_geometry(setup):
    t = SemanticIdTokenizer(setup["trq"], device="cpu")
    assert (t.n_layers, t.sem_ids_dim) == (setup["jtok"].n_layers, setup["jtok"].sem_ids_dim) == (3, 4)
    np.testing.assert_allclose(t._index_fingerprint(), setup["jtok"]._index_fingerprint(), rtol=1e-12)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_saved_index_crosses_packages(setup, tmp_path, direction):
    path = str(tmp_path / "index.npz")
    want = np.asarray(setup["jtok"].cached_ids)
    if direction == "jax_to_port":
        setup["jtok"].save_index(path)
        got = SemanticIdTokenizer(setup["trq"], device="cpu").load_index(path)
        assert got.dtype == torch.int32
        got = got.numpy()
    else:
        _tok(setup, setup["feats"]).save_index(path)
        got = np.asarray(JTokenizer(setup["rq"], setup["rq_params"]).load_index(path))
    np.testing.assert_array_equal(got, want)


def test_foreign_rqvae_index_is_refused(setup, tmp_path):
    path = str(tmp_path / "index.npz")
    setup["jtok"].save_index(path)
    other = RqVae(setup["trq"].config, device="cpu")
    other.load_state_dict(setup["trq"].state_dict())
    with torch.no_grad():
        other.codebooks.add_(0.5)
    with pytest.raises(ValueError, match="different RQ-VAE"):
        SemanticIdTokenizer(other, device="cpu").load_index(path)
    bare = SemanticIdTokenizer(setup["trq"], device="cpu")
    with pytest.raises(RuntimeError):
        bare.save_index(str(tmp_path / "x.npz"))
    with pytest.raises(RuntimeError):
        bare.extend_corpus_ids(setup["feats"][:4])


def test_extend_corpus_ids_equals_jax_and_a_rebuild(setup):
    feats = setup["feats"]
    grown = _tok(setup, feats[:N_OLD])
    new_rows = grown.extend_corpus_ids(feats[N_OLD:])
    jgrown = JTokenizer(setup["rq"], setup["rq_params"])
    jgrown.precompute_corpus_ids(feats[:N_OLD])
    jrows = jgrown.extend_corpus_ids(feats[N_OLD:])
    full = _tok(setup, feats).cached_ids.numpy()
    np.testing.assert_array_equal(new_rows.numpy(), np.asarray(jrows))
    np.testing.assert_array_equal(grown.cached_ids.numpy(), full)
    np.testing.assert_array_equal(full, np.asarray(setup["jtok"].cached_ids))
    dedup = full[:, -1]
    assert dedup[100] >= 1 and dedup[150] >= 1 and dedup[185] >= 2 and dedup[190] >= 1


def test_two_step_extension(setup):
    feats = setup["feats"]
    grown = _tok(setup, feats[:N_OLD])
    grown.extend_corpus_ids(feats[N_OLD:170])
    grown.extend_corpus_ids(feats[170:])
    np.testing.assert_array_equal(grown.cached_ids.numpy(), np.asarray(setup["jtok"].cached_ids))


@pytest.mark.parametrize("dense_limit", [1 << 26, 1])
def test_extend_prefix_table_equals_jax_and_a_rebuild(setup, dense_limit):
    """Dense bitmaps (the default) and sorted, capacity-padded levels
    (dense_limit=1), extended in place."""
    ids = np.array(setup["jtok"].cached_ids)[:, :3]
    kw = dict(dense_limit=dense_limit, capacity=N)
    grown = tbeam.build_prefix_table(torch.from_numpy(ids[:N_OLD]), 8, **kw)
    storage = [t.data_ptr() for t in grown.level_keys]
    assert tbeam.extend_prefix_table(grown, torch.from_numpy(ids[N_OLD:]), 8, n_valid_old=N_OLD) is grown
    assert [t.data_ptr() for t in grown.level_keys] == storage
    full = tbeam.build_prefix_table(torch.from_numpy(ids), 8, **kw)
    jgrown = jbeam.extend_prefix_table(jbeam.build_prefix_table(jnp.asarray(ids[:N_OLD]), 8, **kw),
                                       jnp.asarray(ids[N_OLD:]), 8, n_valid_old=N_OLD)
    for g, f, j in zip(grown.level_keys, full.level_keys, jgrown.level_keys):
        np.testing.assert_array_equal(g.numpy(), f.numpy())
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))


def test_extend_prefix_table_capacity_overflow(setup):
    ids = np.array(setup["jtok"].cached_ids)[:, :3]
    grown = tbeam.build_prefix_table(torch.from_numpy(ids[:N_OLD]), 8, dense_limit=1, capacity=N_OLD + 4)
    with pytest.raises(ValueError, match="capacity"):
        tbeam.extend_prefix_table(grown, torch.from_numpy(ids[N_OLD:]), 8, n_valid_old=N_OLD)


def _assert_same(a, b):
    np.testing.assert_array_equal(np.asarray(a.sem_ids), np.asarray(b.sem_ids))
    np.testing.assert_array_equal(np.asarray(a.item_ids), np.asarray(b.item_ids))
    np.testing.assert_allclose(np.asarray(a.log_probas), np.asarray(b.log_probas), rtol=0, atol=1e-5)


def test_retriever_extension_serves_as_a_rebuilt_one_in_place(setup):
    feats, hist, tm = setup["feats"], setup["hist"], setup["tm"]
    r_grown = Retriever(tm, _tok(setup, feats[:N_OLD]), device="cpu", capacity=N)
    r_full = Retriever(tm, _tok(setup, feats), device="cpu")
    j_full = JRetriever(setup["jm"], setup["params"], setup["jtok"])
    old_hist = np.where(hist < N_OLD, hist, -1)
    r_grown.retrieve(old_hist)
    ptrs = [t.data_ptr() for t in r_grown.corpus_tensors()]
    assert r_grown.extend_corpus(feats[N_OLD:]) == N and r_grown.n_items == N
    assert [t.data_ptr() for t in r_grown.corpus_tensors()] == ptrs
    for h in (old_hist, hist):  # histories over old items, and ones that name new items
        got = r_grown.retrieve(h)
        _assert_same(got, r_full.retrieve(h))
        _assert_same(got, j_full.retrieve(h))
    # a grown sorted view keeps the sentinel rule: pad slots map to item -1
    r_pad = Retriever(tm, _tok(setup, feats[:N_OLD]), device="cpu", capacity=N + 8)
    r_pad.extend_corpus(feats[N_OLD:])
    assert int((r_pad._sorted_items == -1).sum()) == 8 and int(r_pad._sorted_keys[-1]) == r_pad._sentinel
    _assert_same(r_pad.retrieve(hist), r_full.retrieve(hist))


def test_retriever_capacity_exceeded_raises(setup):
    feats = setup["feats"]
    r = Retriever(setup["tm"], _tok(setup, feats[:N_OLD]), device="cpu", capacity=N)
    r.extend_corpus(feats[N_OLD:N - 8])
    with pytest.raises(ValueError, match="capacity"):
        r.extend_corpus(np.concatenate([feats[N - 8:], feats[:8]]))
    assert r.n_items == N - 8 and r.tokenizer.cached_ids.shape[0] == N - 8  # a refused extension changes nothing


def test_extension_through_the_engine(setup):
    feats, hist, tm = setup["feats"], setup["hist"], setup["tm"]
    r_grown = Retriever(tm, _tok(setup, feats[:N_OLD]), device="cpu", capacity=N)
    eng = RetrievalEngine(r_grown, max_items=8, batch_buckets=(1, 2, 4))
    eng.warmup()
    r_grown.extend_corpus(feats[N_OLD:])
    reqs = [np.asarray(h, np.int32)[np.asarray(h) >= 0] for h in hist[:3]]
    reqs.append(np.asarray([N_OLD, N_OLD + 5, 3], np.int32))  # names new items
    got = eng.retrieve_many(reqs)
    want = RetrievalEngine(Retriever(tm, _tok(setup, feats), device="cpu"), max_items=8,
                           batch_buckets=(1, 2, 4)).retrieve_many(reqs)
    _assert_same(got, want)
