"""Scale-out serving of the port on a mesh of CPU devices (['cpu', 'cpu'] and
['cpu'] x 3: the shards run one after another on one device), against the
unsharded port and the JAX package's mesh paths, over the serving fixture of
tests/test_retriever.py (tests/torch_serving_fixture.py):

- the sharded index build (SemanticIdTokenizer(mesh=)) equals the unsharded
  one exactly, ids and dedup column, for a corpus the mesh divides and one
  it does not, and equals the JAX tokenizer's mesh build
  (tests/test_tokenizer.py:68-73, test_parallel.py:188-219);
- Retriever(mesh=) equals the plain Retriever on deterministic beams (ids
  exact, log-probas atol 1e-5: shards sum at another batch size), padding a
  batch the mesh does not divide; with sampled candidates each shard draws
  its own noise, and given noise it equals the plain Retriever fed the same;
- corpus growth on a mesh-built tokenizer and a mesh Retriever serves what a
  full build serves (tests/test_corpus_extension.py:316-318);
- the engine over a mesh Retriever rounds its batch buckets up to the mesh
  size and equals direct retrieval (tests/test_engine.py:60-80).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from rqvae_tpu.tokenizer.semids import SemanticIdTokenizer as JTokenizer

from rqvae_tpu_torch.parallel.mesh import make_mesh
from rqvae_tpu_torch.serving.engine import RetrievalEngine
from rqvae_tpu_torch.serving.retriever import Retriever
from rqvae_tpu_torch.tokenizer.semids import SemanticIdTokenizer

from tests.test_retriever import _setup
from tests.torch_serving_fixture import both_packages

MESH = make_mesh(devices=["cpu", "cpu"])


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def packages():
    data = _setup()[0]
    return both_packages(), np.asarray(data["item_features"])


@pytest.mark.parametrize("n_shards,n_items", [(2, None), (2, 301), (3, None)])
def test_sharded_index_build_equals_the_unsharded_one(packages, n_shards, n_items):
    (_, r, _), feats = packages
    feats = feats[:n_items]
    plain = SemanticIdTokenizer(r.tokenizer.model, device="cpu").precompute_corpus_ids(feats)
    mesh = make_mesh(devices=["cpu"] * n_shards)
    tok = SemanticIdTokenizer(r.tokenizer.model, mesh=mesh)
    assert tok.device == torch.device("cpu") and tok.mesh is mesh
    got = tok.precompute_corpus_ids(feats)
    assert torch.equal(got, plain)
    assert int(plain[:, -1].max()) > 0  # duplicate tuples: the dedup column counts across the shards


def test_sharded_index_build_equals_the_jax_mesh_build(packages):
    ((_, _, jtok), r, _), feats = packages
    jmesh = JMesh(np.array(jax.devices()[:2]), ("data",))
    want = np.asarray(JTokenizer(jtok.model, jtok.params, tokenize_batch_size=128, mesh=jmesh)
                      .precompute_corpus_ids(feats))
    got = SemanticIdTokenizer(r.tokenizer.model, mesh=MESH).precompute_corpus_ids(feats)
    np.testing.assert_array_equal(got.numpy(), want)


def _same(a, b):
    assert torch.equal(a.item_ids, b.item_ids) and torch.equal(a.sem_ids, b.sem_ids)
    torch.testing.assert_close(a.log_probas, b.log_probas, atol=1e-5, rtol=0)


@pytest.mark.parametrize("batch", [6, 5])
def test_sharded_retrieval_equals_plain_retrieval(packages, batch):
    (_, r, hist), feats = packages
    tok = SemanticIdTokenizer(r.tokenizer.model, mesh=MESH)
    tok.precompute_corpus_ids(feats)
    rm = Retriever(r.model, tok, mesh=MESH)
    assert rm.batch_multiple == 2 and len(rm.shards) == 2 and rm.shards[0] is rm.shards[1]
    users = np.arange(batch, dtype=np.int32)
    _same(rm.retrieve(hist[:batch], users), r.retrieve(hist[:batch], users))


def test_sampled_shards_draw_their_own_noise(packages):
    (_, r, hist), feats = packages
    cfg = dataclasses.replace(r.model.config, sample_candidates=True)
    model = type(r.model)(cfg, device="cpu")
    model.load_state_dict(r.model.state_dict())
    tok = SemanticIdTokenizer(r.tokenizer.model, mesh=MESH)
    tok.precompute_corpus_ids(feats)
    rm = Retriever(model, tok, mesh=MESH, seed=4)
    plain = Retriever(model, r.tokenizer, device="cpu", seed=4)
    noise = plain.draw_noise(6)
    _same(rm.retrieve(hist, noise=noise), plain.retrieve(hist, noise=noise))  # fed the same: the same beams
    # drawn: each shard takes its own draw of its 3 rows from the retriever's generator
    drawn = Retriever(model, tok, mesh=MESH, seed=4)
    fed = Retriever(model, tok, mesh=MESH, seed=4)
    shard0, shard1 = fed.draw_noise(3), fed.draw_noise(3)
    assert not torch.equal(shard0[0], shard1[0])
    own = [torch.cat([a, b]) for a, b in zip(shard0, shard1)]
    torch.manual_seed(0)  # global state plays no part
    _same(drawn.retrieve(hist), rm.retrieve(hist, noise=own))


def test_corpus_growth_on_a_mesh_built_tokenizer(packages):
    (_, r, hist), feats = packages
    n_old = 200
    tok = SemanticIdTokenizer(r.tokenizer.model, mesh=MESH)
    tok.precompute_corpus_ids(feats[:n_old])
    grown = Retriever(r.model, tok, mesh=MESH, capacity=len(feats))
    old_hist = np.where(hist < n_old, hist, -1)
    assert grown.extend_corpus(feats[n_old:]) == len(feats)
    assert torch.equal(tok.cached_ids, r.tokenizer.cached_ids)  # what a full build gives
    _same(grown.retrieve(old_hist), r.retrieve(old_hist))


def test_engine_over_a_mesh_retriever_rounds_buckets_and_matches_direct(packages):
    (_, r, hist), feats = packages
    tok = SemanticIdTokenizer(r.tokenizer.model, mesh=MESH)
    tok.precompute_corpus_ids(feats)
    eng = RetrievalEngine(Retriever(r.model, tok, mesh=MESH), max_items=8, batch_buckets=(1, 3, 4))
    assert eng.batch_buckets == (2, 4)  # rounded up to multiples of the mesh size
    requests = [hist[0][:3], hist[1][:8], hist[2][:5]]
    out = eng.retrieve_many(requests)
    assert out.item_ids.shape == (3, 5) and eng.shape_counts == {(4, 8): 1}
    for i, h in enumerate(requests):
        h = np.asarray(h, np.int32)
        direct = r.retrieve(h[h >= 0][None, :])
        np.testing.assert_array_equal(out.sem_ids[i], direct.sem_ids.numpy()[0])
        np.testing.assert_array_equal(out.item_ids[i], direct.item_ids.numpy()[0])
