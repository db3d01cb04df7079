"""Port parity, RQ-VAE side: rqvae_tpu_torch against rqvae_tpu on the CPU.

Same inputs (numpy, seeded), same weights (JAX params through the weight
bridge). Tolerances: f32 floats atol=rtol=1e-5; ids, dedup column and
packed keys exact. Seeds are chosen so no row sits at an argmin near-tie,
and the tests assert that.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rqvae_tpu.models import quantize as jq
from rqvae_tpu.models.mlp import MLP as JMLP
from rqvae_tpu.models.rqvae import RqVae as JRqVae
from rqvae_tpu.models.rqvae import RqVaeConfig as JRqVaeConfig
from rqvae_tpu.models.rqvae import kmeans_init_codebooks
from rqvae_tpu.ops import dedup as jdedup
from rqvae_tpu.ops.pallas.rq_encode import encoder_weights_from_params
from rqvae_tpu.ops.pallas.rq_encode import fused_encode_quantize as j_fused_encode_quantize
from rqvae_tpu.tokenizer.semids import SemanticIdTokenizer as JTokenizer
from rqvae_tpu.data.schemas import SeqBatch as JSeqBatch

from rqvae_tpu_torch.data.schemas import SeqBatch
from rqvae_tpu_torch.models import quantize as tq
from rqvae_tpu_torch.models.mlp import MLP
from rqvae_tpu_torch.models.rqvae import RqVae, RqVaeConfig
from rqvae_tpu_torch.ops import dedup as tdedup
from rqvae_tpu_torch.ops.cuda.rq_encode import (
    fused_encode_quantize,
    fused_encode_quantize_plain,
    pallas_supported,
)
from rqvae_tpu_torch.tokenizer.semids import SemanticIdTokenizer
from rqvae_tpu_torch.utils.convert import load_jax_params

FIELDS = dict(input_dim=32, embed_dim=8, hidden_dims=(24, 16), codebook_size=16, n_layers=3)
TOL = dict(atol=1e-5, rtol=1e-5)


def _pair(seed=0, n=256, **over):
    """(jax model, jax params, port model, features) on clustered data."""
    fields = {**FIELDS, **over}
    jcfg = JRqVaeConfig(**fields, codebook_mode=jq.QuantizeForwardMode.STE)
    tcfg = RqVaeConfig(**fields, codebook_mode=tq.QuantizeForwardMode.STE)
    r = np.random.RandomState(seed)
    centers = r.randn(12, fields["input_dim"]) * 2
    x = (centers[r.randint(0, 12, n)] + 0.3 * r.randn(n, fields["input_dim"])).astype(np.float32)
    jm = JRqVae(jcfg)
    rngs = {"params": jax.random.PRNGKey(seed), "gumbel": jax.random.PRNGKey(seed + 1)}
    params = jax.jit(lambda r, x: jm.init(r, x, 0.2))(rngs, x[:16])
    if not (fields.get("sim_vq") or fields.get("codebook_normalize")):
        params = kmeans_init_codebooks(jax.random.PRNGKey(seed + 2), jm, params, jnp.asarray(x), max_iters=10)
    params = jax.device_get(params)
    tm = load_jax_params(RqVae(tcfg, device="cpu"), params)
    return jm, params, tm, x


@pytest.fixture(scope="module")
def pair():
    return _pair(seed=4)


def _min_gap(residuals, codebooks):
    """Smallest top-2 L2 distance gap over rows and levels, in float64,
    relative to the size of the terms f32 sums to get the distances
    (||r||^2 + ||c||^2): f32 rounding moves a distance by ~1e-7 of that."""
    gaps = []
    for level in range(codebooks.shape[0]):
        r = residuals[:, level].astype(np.float64)
        c = codebooks[level].astype(np.float64)
        d = ((r[:, None, :] - c[None]) ** 2).sum(-1)
        top2 = np.sort(d, axis=1)[:, :2]
        scale = (r * r).sum(-1) + (c * c).sum(-1).max()
        gaps.append((top2[:, 1] - top2[:, 0]) / scale)
    return float(np.min(gaps))


def test_mlp_matches_flax():
    r = np.random.RandomState(3)
    x = r.randn(7, 32).astype(np.float32)
    for normalize in (False, True):
        jm = JMLP(hidden_dims=(24, 16), out_dim=8, normalize=normalize)
        params = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
        tm = load_jax_params(MLP(32, (24, 16), 8, normalize=normalize), params)
        want = np.asarray(jm.apply(params, jnp.asarray(x)))
        got = tm(torch.from_numpy(x)).detach().numpy()
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("distance", ["L2", "COSINE"])
def test_codebook_distances(distance):
    r = np.random.RandomState(4)
    x, cb = r.randn(9, 8).astype(np.float32), r.randn(16, 8).astype(np.float32)
    want = np.asarray(jq.codebook_distances(jnp.asarray(x), jnp.asarray(cb), jq.QuantizeDistance[distance]))
    got = tq.codebook_distances(torch.from_numpy(x), torch.from_numpy(cb), tq.QuantizeDistance[distance])
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_effective_codebook_simvq_and_normalize():
    jm, params, tm, _ = _pair(seed=5, sim_vq=True, codebook_normalize=True)
    for level in range(3):
        want = np.asarray(jm.apply(params, level, method=JRqVae.effective_codebook))
        got = tm.effective_codebook(level).detach().numpy()
        np.testing.assert_allclose(got, want, **TOL)
    assert not pallas_supported(tm.config)


def test_get_semantic_ids(pair):
    jm, params, tm, x = pair
    want = jm.apply(params, jnp.asarray(x), training=False, method=JRqVae.get_semantic_ids)
    got = tm.get_semantic_ids(torch.from_numpy(x))
    assert _min_gap(np.asarray(want.residuals), np.asarray(params["params"]["codebooks"])) > 1e-4
    np.testing.assert_array_equal(got.sem_ids.numpy(), np.asarray(want.sem_ids))
    assert got.sem_ids.dtype == torch.int32
    np.testing.assert_allclose(got.embeddings.numpy(), np.asarray(want.embeddings), **TOL)
    np.testing.assert_allclose(got.residuals.numpy(), np.asarray(want.residuals), **TOL)
    np.testing.assert_allclose(got.quantize_loss.numpy(), np.asarray(want.quantize_loss), **TOL)
    z = np.asarray(want.embeddings).sum(1)
    np.testing.assert_allclose(
        tm.decode(torch.from_numpy(z)).detach().numpy(),
        np.asarray(jm.apply(params, jnp.asarray(z), method=JRqVae.decode)), **TOL,
    )


def test_dedup_and_packing():
    r = np.random.RandomState(6)
    ids = r.randint(0, 4, (500, 3)).astype(np.int32)  # 64 tuples: many duplicates
    want_keys = np.asarray(jdedup.pack_sem_id_tuples(jnp.asarray(ids), 4))
    got_keys = tdedup.pack_sem_id_tuples(torch.from_numpy(ids), 4)
    assert got_keys.dtype == torch.int32
    np.testing.assert_array_equal(got_keys.numpy(), want_keys)
    want = np.asarray(jdedup.dedup_counts_from_keys(jnp.asarray(want_keys)))
    got = tdedup.dedup_counts_from_keys(got_keys)
    np.testing.assert_array_equal(got.numpy(), want)
    assert [tdedup.id_bits(k) for k in (1, 2, 3, 256, 257)] == [jdedup.id_bits(k) for k in (1, 2, 3, 256, 257)]


def test_pack_int64_beyond_31_bits():
    ids = np.array([[255, 255, 255, 255], [1, 2, 3, 4]], np.int64)  # 4 x 8 bits = 32 bits
    got = tdedup.pack_sem_id_tuples(torch.from_numpy(ids), 256)
    assert got.dtype == torch.int64
    assert got.tolist() == [(1 << 32) - 1, (1 << 24) + (2 << 16) + (3 << 8) + 4]


def test_tokenizer_index_and_lookup(pair):
    jm, params, tm, x = pair
    jtok = JTokenizer(jm, params, use_pallas=False)
    want = np.asarray(jtok.precompute_corpus_ids(x))
    tok = SemanticIdTokenizer(tm, device="cpu", tokenize_batch_size=100)
    got = tok.precompute_corpus_ids(x)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[:, 3].max() > 0  # the data has duplicate tuples
    n = x.shape[0]
    r = np.random.RandomState(7)
    ids = r.randint(0, n, (4, 5))
    ids[0, 3:] = -1
    ids[1, 0] = n + 5  # out of range: both ends clamp
    fut = np.array([3, -1, n + 9, 0])
    mask = ids >= 0
    jout = jtok(JSeqBatch(jnp.arange(4), jnp.asarray(ids), jnp.asarray(fut), None, None, jnp.asarray(mask)))
    tout = tok(SeqBatch(torch.arange(4), torch.from_numpy(ids), torch.from_numpy(fut), None, None,
                        torch.from_numpy(mask)))
    for name in ("sem_ids", "sem_ids_fut", "seq_mask", "token_type_ids", "token_type_ids_fut"):
        np.testing.assert_array_equal(getattr(tout, name).numpy(), np.asarray(getattr(jout, name)), name)


def test_rq_encode_plain_matches_xla_path(pair):
    jm, params, tm, x = pair
    want = np.asarray(jm.apply(params, jnp.asarray(x), training=False, method=JRqVae.get_semantic_ids).sem_ids)
    got = fused_encode_quantize_plain(
        torch.from_numpy(x), tm.encoder.kernels(), tm.codebooks.detach(), n_levels=3
    )
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper takes the plain version for CPU tensors only
    wrapped = fused_encode_quantize(torch.from_numpy(x), tm.encoder.kernels(), tm.codebooks.detach(), 3)
    np.testing.assert_array_equal(wrapped.numpy(), want)
    # bf16 is computed, not refused: on CPU tensors by the plain bf16 version
    # (held against the Pallas kernel in tests/test_torch_rq_encode_bf16.py)
    wrapped16 = fused_encode_quantize(torch.from_numpy(x), tm.encoder.kernels(), tm.codebooks.detach(), 3,
                                      precision="bf16")
    want16 = fused_encode_quantize_plain(torch.from_numpy(x), tm.encoder.kernels(), tm.codebooks.detach(), 3,
                                         precision="bf16")
    assert wrapped16.dtype == torch.int32 and wrapped16.shape == (x.shape[0], 3)
    np.testing.assert_array_equal(wrapped16.numpy(), want16.numpy())
    with pytest.raises(ValueError, match="precision"):
        fused_encode_quantize(torch.from_numpy(x), tm.encoder.kernels(), tm.codebooks.detach(), 3,
                              precision="fp16")


def test_rq_encode_plain_matches_pallas_interpret(pair):
    jm, params, tm, x = pair
    want = np.asarray(j_fused_encode_quantize(
        jnp.asarray(x[:64]), encoder_weights_from_params(params), params["params"]["codebooks"],
        n_levels=3, block_rows=64, precision="f32", interpret=True,
    ))
    got = fused_encode_quantize_plain(torch.from_numpy(x[:64]), tm.encoder.kernels(), tm.codebooks.detach(), 3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_rq_encode_plain_at_the_ml32m_widths():
    """The widths the ML-32M tokenizer runs (788 -> 512 -> 256 -> 128 -> 64),
    on a few hundred rows: the plain version's ids equal the JAX XLA path's."""
    jm, params, tm, x = _pair(seed=9, n=300, input_dim=788, embed_dim=64, hidden_dims=(512, 256, 128))
    want = jm.apply(params, jnp.asarray(x), training=False, method=JRqVae.get_semantic_ids)
    assert _min_gap(np.asarray(want.residuals), np.asarray(params["params"]["codebooks"])) > 1e-4
    weights = tm.encoder.kernels()
    assert [tuple(w.shape) for w in weights] == [(788, 512), (512, 256), (256, 128), (128, 64)]
    got = fused_encode_quantize(torch.from_numpy(x), weights, tm.codebooks.detach(), 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want.sem_ids))
