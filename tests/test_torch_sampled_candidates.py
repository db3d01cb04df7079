"""Sampled-candidate generation, port against JAX on the CPU.

The port cannot draw jax.random's bits, so each level's Gumbel noise is the
noise JAX draws (ops/gumbel.py::sample_gumbel of fold_in(rng, h), the key
JAX's generate() hands its level h), passed to the port. Small widths (L=3,
K=8, d 32, 2 layers, k=5, n_candidates=6), f32: sem_ids exact, log_probas
within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rqvae_tpu.models import retrieval as jr
from rqvae_tpu.ops import gumbel as jgumbel

from rqvae_tpu_torch.models import retrieval as tr
from rqvae_tpu_torch.ops import gumbel as tgumbel
from rqvae_tpu_torch.ops.dedup import pack_sem_id_tuples
from rqvae_tpu_torch.serving.retriever import Retriever
from rqvae_tpu_torch.utils.convert import load_jax_params

from tests.test_torch_retrieval import FIELDS, K, L, _batch, _jit_method, _tables, k

SAMPLED = dict(sample_candidates=True, n_candidates=6)


def _jax_noise(rng, B):
    """Level h's Gumbel noise as JAX's generate() draws it."""
    shapes = [(B, K)] + [(B, k, K)] * (L - 1)
    return [np.asarray(jgumbel.sample_gumbel(jax.random.fold_in(rng, h), s)) for h, s in enumerate(shapes)]


@pytest.fixture(scope="module")
def sampled_models():
    jcfg = jr.RetrievalConfig(**FIELDS, **SAMPLED, t5_dropout=0.0, t5_fused_decode="off")
    jm = jr.EncoderDecoderRetrievalModel(jcfg)
    b = _batch(np.random.RandomState(0), np.zeros((4, L), np.int64))
    rngs = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}
    params = jax.device_get(jax.jit(lambda r, x: jm.init(r, x, training=True))(rngs, b))
    tm = load_jax_params(tr.EncoderDecoderRetrievalModel(tr.RetrievalConfig(**FIELDS, **SAMPLED), device="cpu"),
                         params)
    return jm, params, tm, _jit_method(jm, jr.EncoderDecoderRetrievalModel.generate)


@pytest.mark.parametrize("n", [1, 5, 8])
def test_sample_without_replacement_fed_jax_noise(n):
    logp = jax.nn.log_softmax(jax.random.normal(jax.random.PRNGKey(3), (6, 4, K)), axis=-1)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jgumbel.sample_without_replacement(key, logp, n))
    g = np.asarray(jgumbel.sample_gumbel(key, logp.shape))
    got = tgumbel.sample_without_replacement(torch.from_numpy(np.array(logp)), n, noise=torch.from_numpy(g))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # distinct within every row, and a generator draws as well as given noise
    assert all(len(set(row)) == n for row in got.reshape(-1, n).tolist())
    drawn = tgumbel.sample_without_replacement(torch.from_numpy(np.array(logp)), n,
                                               generator=torch.Generator().manual_seed(0))
    assert drawn.shape == got.shape and all(len(set(row)) == n for row in drawn.reshape(-1, n).tolist())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_generate_sampled_equals_jax(sampled_models, seed):
    jm, params, tm, jgen = sampled_models
    corpus = np.random.RandomState(4 + seed).randint(0, K, (60, L)).astype(np.int32)
    jt, tt = _tables(corpus)
    b = _batch(np.random.RandomState(seed), corpus, n_items=4)
    rng = jax.random.PRNGKey(100 + seed)
    want = jgen(params, b.sem_ids, b.seq_mask, b.user_ids, jt, rng)
    noise = [torch.from_numpy(g) for g in _jax_noise(rng, b.sem_ids.shape[0])]
    got = tm.generate(torch.tensor(np.asarray(b.sem_ids)), torch.tensor(np.asarray(b.seq_mask)),
                      torch.tensor(np.asarray(b.user_ids)), tt, noise=noise)
    np.testing.assert_array_equal(got.sem_ids.numpy(), np.asarray(want.sem_ids))
    np.testing.assert_allclose(got.log_probas.numpy(), np.asarray(want.log_probas), rtol=0, atol=1e-5)


def test_sampled_beams_are_valid_and_distinct(sampled_models):
    """Properties over several draws: every beam with a finite score is a
    corpus tuple, and no tuple appears twice among a query's beams."""
    _, _, tm, _ = sampled_models
    corpus = np.random.RandomState(9).randint(0, K, (40, L)).astype(np.int32)
    _, tt = _tables(corpus)
    keys = set(pack_sem_id_tuples(torch.from_numpy(corpus), K).tolist())
    b = _batch(np.random.RandomState(9), corpus, n_items=3)
    g = torch.Generator().manual_seed(5)
    for _ in range(4):
        noise = [tgumbel.sample_gumbel(s, g) for s in tm.sampling_noise_shapes(b.sem_ids.shape[0])]
        out = tm.generate(torch.tensor(np.asarray(b.sem_ids)), torch.tensor(np.asarray(b.seq_mask)),
                          torch.tensor(np.asarray(b.user_ids)), tt, noise=noise)
        got = pack_sem_id_tuples(out.sem_ids, K)
        valid = out.log_probas > -1e8
        assert bool(valid.any())
        assert all(key in keys for key in got[valid].tolist())
        for row, ok in zip(got.tolist(), valid.tolist()):
            row = [key for key, v in zip(row, ok) if v]
            assert len(row) == len(set(row))
        assert bool((torch.diff(out.log_probas, dim=1) <= 0).all())


def test_retriever_advances_its_generator(sampled_models):
    """Each retrieve() draws fresh noise from the retriever's own generator
    (a fixed seed reproduces the sequence of calls)."""
    from rqvae_tpu_torch.models.rqvae import RqVae, RqVaeConfig
    from rqvae_tpu_torch.tokenizer.semids import SemanticIdTokenizer

    _, _, tm, _ = sampled_models
    rq = RqVae(RqVaeConfig(input_dim=16, embed_dim=8, hidden_dims=(16,), codebook_size=K, n_layers=L),
               device="cpu", seed=3)
    tok = SemanticIdTokenizer(rq, device="cpu")
    tok.precompute_corpus_ids(np.random.RandomState(0).randn(80, 16).astype(np.float32))
    hist = np.random.RandomState(1).randint(0, 80, (6, 4)).astype(np.int32)
    a, b = (Retriever(tm, tok, device="cpu", seed=7) for _ in range(2))
    first = [a.retrieve(hist), b.retrieve(hist)]
    second = a.retrieve(hist)
    assert torch.equal(first[0].sem_ids, first[1].sem_ids)  # one seed, one sequence
    noise = Retriever(tm, tok, device="cpu", seed=7).draw_noise(6)
    again = a.retrieve(hist, noise=noise)  # the first call's noise, given
    assert torch.equal(again.sem_ids, first[0].sem_ids)
    assert second.sem_ids.shape == first[0].sem_ids.shape
