"""Serving as it is deployed, on the CPU: JAX-written checkpoints through
`Retriever.from_checkpoints` in both packages, the saved index on a second
start, and the stage-2 trainer over a `.msgpack` RQ-VAE.

The committed fixture (tests/fixtures/jax_synthetic/, regenerated by its
make_fixture.py) holds checkpoints that flax wrote and what the JAX package
served for them; the card reads the same files
(tests/test_torch_paths_gpu.py::test_checkpoint_interop). The port's index is built at precision="f32", the
precision of the CPU comparisons. Item ids exact, log_probas within 1e-5.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from rqvae_tpu.serving.retriever import Retriever as JRetriever

from rqvae_tpu_torch.data.registry import RecDataset
from rqvae_tpu_torch.serving.retriever import Retriever
from rqvae_tpu_torch.tokenizer.semids import SemanticIdTokenizer
from rqvae_tpu_torch.train import train_decoder

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "jax_synthetic")
RQ = os.path.join(FIXTURE, "rqvae", "checkpoint_299.msgpack")
DEC = os.path.join(FIXTURE, "decoder", "checkpoint_400.msgpack")
LOGP_ATOL = 1e-5


@pytest.fixture(scope="module")
def fixture():
    with np.load(os.path.join(FIXTURE, "inputs_and_results.npz")) as z:
        return {k: z[k] for k in z.files}


def _port(index_path=None, **kw):
    return Retriever.from_checkpoints(RQ, DEC, np.load(os.path.join(FIXTURE, "inputs_and_results.npz"))["item_features"],
                                      index_path=index_path, device="cpu", precision="f32", **kw)


def test_fixture_serves_what_jax_served(fixture):
    r = _port()
    assert r.model.config.n_candidates == 64 and r.model.config.t5_d_kv == 16
    out = r.retrieve(fixture["histories"])
    np.testing.assert_array_equal(out.item_ids.numpy(), fixture["item_ids"])
    np.testing.assert_array_equal(out.sem_ids.numpy(), fixture["sem_ids"])
    np.testing.assert_allclose(out.log_probas.numpy(), fixture["log_probas"], rtol=0, atol=LOGP_ATOL)
    # and the JAX package, run now, still serves the stored results
    jout = JRetriever.from_checkpoints(RQ, DEC, fixture["item_features"]).retrieve(fixture["histories"])
    np.testing.assert_array_equal(np.asarray(jout.item_ids), fixture["item_ids"])


def test_second_start_loads_the_saved_index(fixture, tmp_path, monkeypatch):
    path = str(tmp_path / "index.npz")
    first = _port(index_path=path)
    assert os.path.exists(path)

    def no_build(self, item_features):
        raise AssertionError("the second start built the index")

    monkeypatch.setattr(SemanticIdTokenizer, "precompute_corpus_ids", no_build)
    second = _port(index_path=path, capacity=80)
    assert torch.equal(second.tokenizer.cached_ids, first.tokenizer.cached_ids) and second.capacity == 80
    a, b = first.retrieve(fixture["histories"]), second.retrieve(fixture["histories"])
    assert torch.equal(a.item_ids, b.item_ids) and torch.equal(a.log_probas, b.log_probas)
    # an index the JAX package saved starts the port too
    jpath = str(tmp_path / "jax_index.npz")
    JRetriever.from_checkpoints(RQ, DEC, fixture["item_features"], index_path=jpath)
    third = _port(index_path=jpath)
    assert torch.equal(third.tokenizer.cached_ids, first.tokenizer.cached_ids)


def test_refuses_swapped_checkpoints():
    with pytest.raises(ValueError, match="not an RQ-VAE"):
        Retriever.from_checkpoints(DEC, DEC, np.zeros((4, 64), np.float32), device="cpu")


def test_stage2_trainer_starts_from_a_jax_rqvae(tmp_path):
    """The shipped decoder configs name a `.msgpack` RQ-VAE; the port's
    trainer reads the JAX package's file (weights bit-equal)."""
    rq = train_decoder.load_rqvae(RQ, None, "cpu", seed=0)
    with np.load(os.path.join(FIXTURE, "inputs_and_results.npz")) as z:
        feats = z["item_features"]
    jr = JRetriever.from_checkpoints(RQ, DEC, feats)
    np.testing.assert_array_equal(rq.codebooks.detach().numpy(), np.asarray(jr.tokenizer.params["params"]["codebooks"]))
    local = tmp_path / "rq"
    shutil.copytree(os.path.dirname(RQ), local)
    s = train_decoder.train(
        iterations=2, dataset=RecDataset.SYNTHETIC, dataset_folder=str(tmp_path / "ds"),
        pretrained_rqvae_path=str(local / "checkpoint_299.msgpack"), save_dir_root=str(tmp_path / "dec"),
        batch_size=16, t5_d_model=32, t5_num_heads=4, t5_d_ff=64, t5_num_layers=1, top_k_for_generation=5,
        warmup_steps=5, partial_eval_every=1000, full_eval_every=1000, vae_input_dim=64, vae_codebook_size=64,
        device="cpu")
    assert np.isfinite(s["total_loss"])


def test_from_checkpoints_needs_a_card_unless_told_cpu(monkeypatch, fixture):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Retriever.from_checkpoints(RQ, DEC, fixture["item_features"])
    from rqvae_tpu_torch.serving.engine import RetrievalEngine

    eng = RetrievalEngine(_port(), max_items=8, batch_buckets=(16,))  # a CPU retriever: eager, no graphs
    assert not eng.use_graphs and eng.retrieve_many(list(fixture["histories"])).item_ids.shape == (16, 10)
