"""Port parity, serving side: prefix tables, constrained beam search and the
Retriever of rqvae_tpu_torch against rqvae_tpu on the CPU.

Small widths (L=3, K=8, d 32, dk 8, H 4, dff 64, 2 layers, k=5), f32.
Prefix bitmaps, sorted keys, beam sem_ids and item_ids exact; log_probas
rtol=1e-4, atol=1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rqvae_tpu.data.schemas import TokenizedSeqBatch as JBatch
from rqvae_tpu.data.synthetic import SyntheticConfig, generate
from rqvae_tpu.models import retrieval as jr
from rqvae_tpu.models.quantize import QuantizeForwardMode as JMode
from rqvae_tpu.models.rqvae import RqVae as JRqVae
from rqvae_tpu.models.rqvae import RqVaeConfig as JRqVaeConfig
from rqvae_tpu.serving import beam as jbeam
from rqvae_tpu.serving.retriever import Retriever as JRetriever
from rqvae_tpu.tokenizer.semids import SemanticIdTokenizer as JTokenizer

from rqvae_tpu_torch.models import retrieval as tr
from rqvae_tpu_torch.models import t5 as tt5
from rqvae_tpu_torch.models.quantize import QuantizeForwardMode
from rqvae_tpu_torch.models.rqvae import RqVae, RqVaeConfig
from rqvae_tpu_torch.serving import beam as tbeam
from rqvae_tpu_torch.serving.retriever import Retriever
from rqvae_tpu_torch.tokenizer.semids import SemanticIdTokenizer
from rqvae_tpu_torch.utils.convert import load_jax_params

L, K, k = 3, 8, 5
FIELDS = dict(
    num_hierarchies=L, codebook_size=K, t5_d_model=32, t5_d_kv=8, t5_num_heads=4, t5_d_ff=64,
    t5_num_layers=2, top_k_for_generation=k,
)
LOGP_TOL = dict(rtol=1e-4, atol=1e-5)
USER_BINS = dict(num_user_bins=7)


def _models(seed=0, **over):
    jcfg = jr.RetrievalConfig(**FIELDS, **over, t5_dropout=0.0, t5_fused_decode="off")
    jm = jr.EncoderDecoderRetrievalModel(jcfg)
    batch = _batch(np.random.RandomState(seed), np.zeros((4, L), np.int64))
    rngs = {"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(seed + 1)}
    params = jax.device_get(jax.jit(lambda r, b: jm.init(r, b, training=True))(rngs, batch))
    return jm, params, _port(params, **over)


def _jit_method(jm, method):
    """jm.apply(params, *args, method=method), jitted: one compile instead of
    an eager dispatch per op."""
    return jax.jit(lambda params, *args: jm.apply(params, *args, method=method))


def _port(params, **over):
    tcfg = tr.RetrievalConfig(**FIELDS, **over)
    return load_jax_params(tr.EncoderDecoderRetrievalModel(tcfg, device="cpu"), params)


def _batch(r, corpus, B=6, n_items=4):
    """A tokenized history batch as the tokenizer emits it (dedup column 0)."""
    D = L + 1
    table = np.concatenate([corpus, np.zeros((len(corpus), 1), corpus.dtype)], 1)
    items = r.randint(0, len(corpus), (B, n_items))
    lengths = r.randint(1, n_items + 1, B)
    mask = np.repeat(np.arange(n_items)[None, :] < lengths[:, None], D, axis=1)
    sem = np.where(mask, table[items].reshape(B, -1), -1).astype(np.int32)
    return JBatch(
        user_ids=jnp.asarray(r.randint(0, 100, B)), sem_ids=jnp.asarray(sem),
        sem_ids_fut=jnp.asarray(table[items[:, 0]].astype(np.int32)), seq_mask=jnp.asarray(mask),
        token_type_ids=jnp.asarray(np.tile(np.arange(D), (B, n_items))),
        token_type_ids_fut=jnp.asarray(np.tile(np.arange(D), (B, 1))),
    )


def _tables(corpus, **kw):
    jt = jbeam.build_prefix_table(jnp.asarray(corpus), K, **kw)
    tt = tbeam.build_prefix_table(torch.from_numpy(corpus), K, **kw)
    return jt, tt


def _generate_both(models, tm, corpus, seed=1, n_items=4, **table_kw):
    jm, params, _, jgen = models
    jt, tt = _tables(corpus, **table_kw)
    b = _batch(np.random.RandomState(seed), corpus, n_items=n_items)
    want = jgen(params, b.sem_ids, b.seq_mask, b.user_ids, jt)
    got = tm.generate(torch.tensor(np.asarray(b.sem_ids)), torch.tensor(np.asarray(b.seq_mask)),
                      torch.tensor(np.asarray(b.user_ids)), tt)
    return want, got


@pytest.fixture(scope="module")
def models():
    """One model for the module, with hashed user bins so the encoder's
    user embedding runs too; with its jitted JAX generate."""
    jm, params, tm = _models(**USER_BINS)
    return jm, params, tm, _jit_method(jm, jr.EncoderDecoderRetrievalModel.generate)


@pytest.mark.parametrize("dense_limit,capacity", [(1 << 26, None), (8, None), (8, 90)])
def test_prefix_tables_exact(dense_limit, capacity):
    r = np.random.RandomState(0)
    corpus = r.randint(0, K, (70, L)).astype(np.int32)
    jt, tt = _tables(corpus, dense_limit=dense_limit, capacity=capacity)
    assert jt.bits == tt.bits
    for a, b in zip(jt.level_keys, tt.level_keys):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for level in range(L):
        parents = r.randint(0, K ** level, (4, 3)).astype(np.int32)
        np.testing.assert_array_equal(
            tbeam.valid_children(tt, level, torch.from_numpy(parents)).numpy(),
            np.asarray(jbeam.valid_children(jt, level, jnp.asarray(parents))),
        )
        keys = r.randint(0, K ** (level + 1), (5, 2)).astype(np.int32)
        np.testing.assert_array_equal(
            tbeam.is_valid_prefix(tt, level, torch.from_numpy(keys)).numpy(),
            np.asarray(jbeam.is_valid_prefix(jt, level, jnp.asarray(keys))),
        )
    p, c = np.array([[1, 2]], np.int32), np.array([[3, 4]], np.int32)
    np.testing.assert_array_equal(
        tbeam.extend_keys(tt, torch.from_numpy(p), torch.from_numpy(c)).numpy(),
        np.asarray(jbeam.extend_keys(jt, jnp.asarray(p), jnp.asarray(c))),
    )
    if capacity:
        assert int(tt.level_keys[-1][-1]) == tbeam._sentinel(torch.int32) == jbeam._sentinel(jnp.int32)


def test_strip_dedup_col():
    x = np.arange(16).reshape(2, 8)
    np.testing.assert_array_equal(tr.strip_dedup_col(torch.from_numpy(x), 4, 3).numpy(),
                                  np.asarray(jr.strip_dedup_col(jnp.asarray(x), 4, 3)))


def test_encoder_forward_sep_and_user_bins(models):
    jm, params, tm, _ = models
    b = _batch(np.random.RandomState(3), np.random.RandomState(4).randint(0, K, (20, L)))
    ids = jr.strip_dedup_col(b.sem_ids, L + 1, L)
    mask = jr.strip_dedup_col(b.seq_mask.astype(jnp.int32), L + 1, L)
    uids = b.user_ids - 50  # negative ids too: remainder follows the divisor's sign
    want_enc, want_mask = _jit_method(jm, jr.EncoderDecoderRetrievalModel.encoder_forward)(params, ids, mask, uids)
    got_enc, got_mask = tm.encoder_forward(torch.tensor(np.asarray(ids)), torch.tensor(np.asarray(mask)),
                                           torch.tensor(np.asarray(uids)))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    np.testing.assert_allclose(got_enc.detach().numpy(), np.asarray(want_enc), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("fused_decode", ["auto", "off"])
@pytest.mark.parametrize("dense_limit", [1 << 26, 8])
def test_generate_matches_jax(models, fused_decode, dense_limit):
    tm = _port(models[1], **USER_BINS, t5_fused_decode=fused_decode)
    corpus = np.random.RandomState(5).randint(0, K, (60, L)).astype(np.int32)
    want, got = _generate_both(models, tm, corpus, dense_limit=dense_limit)
    assert tm.decoder.use_fused_decode(16) == (fused_decode == "auto")
    np.testing.assert_array_equal(got.sem_ids.numpy(), np.asarray(want.sem_ids))
    np.testing.assert_allclose(got.log_probas.numpy(), np.asarray(want.log_probas), **LOGP_TOL)
    assert (got.log_probas > -1e8).all()  # a full corpus: every beam valid


@pytest.mark.parametrize("fused_encode,kernel", [("auto", "encoder_stack"), ("off", "attention")])
def test_generate_long_rows_matches_jax(models, monkeypatch, fused_encode, kernel):
    """The long-row slice as a whole, at a small size: histories of 6 items
    give 6 x (3 + 1) + 1 = 25 encoder rows, past the two long-row gates
    (patched down from 512 to 16) and past the decoder gate (patched down
    from 128 to 8), so the encoder takes its kernel's route (the encoder
    stack by default, the attention kernel per layer with
    t5_fused_encode="off") and the decoder the plain per-level path. Beam ids
    equal the JAX package's XLA path exactly, in f32."""
    monkeypatch.setattr(tt5, "FUSED_ENCODE_MIN_LEN", 16)
    monkeypatch.setattr(tt5, "FUSED_ATTENTION_MIN_LEN", 16)
    monkeypatch.setattr(tt5, "FUSED_DECODE_MAX_LEN", 8)
    calls = {"encoder_stack": 0, "attention": 0, "decoder_stack": 0}
    for name, attr in (("encoder_stack", "t5_encoder_stack_infer"), ("attention", "t5_attention"),
                       ("decoder_stack", "t5_decoder_stack_infer")):
        def counting(*a, _fn=getattr(tt5, attr), _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(tt5, attr, counting)
    tm = _port(models[1], **USER_BINS, t5_fused_encode=fused_encode)
    assert not tm.decoder.use_fused_decode(25)
    corpus = np.random.RandomState(6).randint(0, K, (60, L)).astype(np.int32)
    want, got = _generate_both(models, tm, corpus, seed=3, n_items=6)
    assert calls == {"encoder_stack": int(kernel == "encoder_stack"),
                     "attention": 2 * int(kernel == "attention"), "decoder_stack": 0}
    np.testing.assert_array_equal(got.sem_ids.numpy(), np.asarray(want.sem_ids))
    np.testing.assert_allclose(got.log_probas.numpy(), np.asarray(want.log_probas), **LOGP_TOL)


def test_generate_ties_with_few_valid_children(models):
    """Fewer than k valid children per level: invalid candidates all score
    -1e9 (+ the beam's log-prob, which rounds away), so the top-k tie order
    decides the beams; it must be jax.lax.top_k's lower-index-first."""
    corpus = np.array([[6, 1, 2], [6, 1, 5], [2, 7, 0]], np.int32)
    want, got = _generate_both(models, models[2], corpus, seed=2)
    np.testing.assert_array_equal(got.sem_ids.numpy(), np.asarray(want.sem_ids))
    np.testing.assert_allclose(got.log_probas.numpy(), np.asarray(want.log_probas), **LOGP_TOL)
    n_valid = (got.log_probas > -1e8).sum(1)
    assert (n_valid == 3).all() and (got.log_probas[:, 3:] == -1e9).all()


def test_sampled_candidates_not_ported(models):
    """Sampled candidates are ported now (tests/test_torch_sampled_candidates.py);
    as JAX's generate() without an rng, the port's without the noise raises."""
    tm = tr.EncoderDecoderRetrievalModel(tr.RetrievalConfig(**FIELDS, sample_candidates=True), device="cpu")
    tt = tbeam.build_prefix_table(torch.zeros(2, L, dtype=torch.int32), K)
    with pytest.raises(ValueError, match="noise"):
        tm.generate(torch.zeros(1, 4, dtype=torch.int32), torch.ones(1, 4, dtype=torch.bool), None, tt)
    noise = [torch.zeros(s) for s in tm.sampling_noise_shapes(1)]
    out = tm.generate(torch.zeros(1, 4, dtype=torch.int32), torch.ones(1, 4, dtype=torch.bool), None, tt, noise=noise)
    assert out.sem_ids.shape == (1, k, L) and bool((out.sem_ids[0, 0] == 0).all())


def test_retriever_end_to_end_matches_jax(models):
    """The whole slice: both packages build their own index over the same
    corpus with the same RQ-VAE, and serve the same histories."""
    data = generate(SyntheticConfig(n_items=200, n_users=20, input_dim=16, max_seq_len=8, seed=9))
    vfields = dict(input_dim=16, embed_dim=8, hidden_dims=(16,), codebook_size=K, n_layers=L)
    jrq = JRqVae(JRqVaeConfig(**vfields, codebook_mode=JMode.STE))
    rngs = {"params": jax.random.PRNGKey(0), "gumbel": jax.random.PRNGKey(1)}
    rq_params = jax.device_get(jax.jit(lambda r, x: jrq.init(r, x, 0.2))(rngs, data["item_features"][:8]))
    trq = load_jax_params(RqVae(RqVaeConfig(**vfields, codebook_mode=QuantizeForwardMode.STE), device="cpu"),
                          rq_params)
    # codebooks drawn from the corpus residuals, level by level, so the
    # index holds many distinct tuples (a U(0, 1) codebook maps most items
    # to one code)
    res = trq.encode(torch.from_numpy(data["item_features"])).detach()
    rows = np.random.RandomState(2).permutation(len(res))
    cbs = []
    for level in range(L):
        cb = res[rows[level * K:(level + 1) * K]]
        cbs.append(cb)
        res = res - cb[torch.cdist(res, cb).argmin(1)]
    rq_params["params"]["codebooks"] = torch.stack(cbs).numpy()
    trq = load_jax_params(trq, rq_params)
    jtok = JTokenizer(jrq, rq_params)
    jtok.precompute_corpus_ids(data["item_features"])
    ttok = SemanticIdTokenizer(trq, device="cpu")
    ttok.precompute_corpus_ids(data["item_features"])
    np.testing.assert_array_equal(ttok.cached_ids.numpy(), np.asarray(jtok.cached_ids))

    jm, params, tm, _ = models
    hist = data["seq_items"][:6, :8]
    want = JRetriever(jm, params, jtok).retrieve(hist)
    got = Retriever(tm, ttok, device="cpu").retrieve(hist)
    np.testing.assert_array_equal(got.item_ids.numpy(), np.asarray(want.item_ids))
    np.testing.assert_array_equal(got.sem_ids.numpy(), np.asarray(want.sem_ids))
    np.testing.assert_allclose(got.log_probas.numpy(), np.asarray(want.log_probas), **LOGP_TOL)
    items = got.item_ids.numpy()
    assert (items >= 0).any()
    cached = ttok.cached_ids.numpy()
    for b, j in zip(*np.nonzero(items >= 0)):
        np.testing.assert_array_equal(cached[items[b, j], :L], got.sem_ids[b, j].numpy())
        assert cached[items[b, j], L] == 0  # duplicates resolve to the earliest item
