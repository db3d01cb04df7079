"""Port parity, attention side: the keep bits of rqvae_tpu_torch's hash
dropout and the attention kernel's plain version against rqvae_tpu on the CPU.

Keep bits are integers and must be equal. Attention outputs: f32
atol=rtol=1e-5; bf16 atol=rtol=2e-2 (one bf16 rounding of an O(1) output is
up to 4e-3 relative, and the two frameworks sum the f32 products in another
order, so a p or an output can round the other way).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rqvae_tpu.ops import hash_dropout as jhd
from rqvae_tpu.ops.pallas import attention as jattn

from rqvae_tpu_torch.ops import hash_dropout as thd
from rqvae_tpu_torch.ops.cuda.attention import t5_attention, t5_attention_backward_plain, t5_attention_plain

F32 = dict(atol=1e-5, rtol=1e-5)
BF16 = dict(atol=2e-2, rtol=2e-2)
SEED = 1234


def _inputs(B=3, H=2, Lq=24, Lk=24, dk=8, seed=0, dtype=np.float32):
    r = np.random.RandomState(seed)
    q, k, v = (r.randn(B, H, L, dk).astype(dtype) for L in (Lq, Lk, Lk))
    bias = r.randn(H, Lq, Lk).astype(np.float32)
    mask = (r.rand(B, Lk) > 0.3).astype(np.int32)
    mask[:, 0] = 1
    return q, k, v, bias, mask


def _t(q, k, v, bias, mask, dtype=torch.float32):
    """Torch operands: q, k, v at the compute dtype, bias f32, mask int32."""
    return [*(torch.from_numpy(a).to(dtype) for a in (q, k, v)), torch.from_numpy(bias), torch.from_numpy(mask)]


@pytest.mark.parametrize("seed,rate", [(0, 0.1), (SEED, 0.5), (-7, 0.25), (2**31 - 1, 0.999999999)])
def test_hash_keep_bits_exact(seed, rate):
    counters = np.concatenate([np.arange(5000), 2**32 - 1 - np.arange(5000), [0x80000000, 0x7FFFFFFF]])
    want = np.asarray(jhd.hash_keep_bits(jnp.asarray(counters, jnp.uint32), jnp.asarray(seed, jnp.int32), rate))
    got = thd.hash_keep_bits(torch.from_numpy(counters.astype(np.int64)), seed, rate)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < got.float().mean() < 1 or rate > 0.99


@pytest.mark.parametrize("shape", [(7,), (3, 1, 5), (2, 3, 4, 5)])
def test_keep_mask_exact(shape):
    want = np.asarray(jhd.keep_mask(jnp.asarray(SEED, jnp.int32), shape, 0.3))
    np.testing.assert_array_equal(thd.keep_mask(SEED, shape, 0.3).numpy(), want)
    with pytest.raises(ValueError, match="overflows"):
        thd.keep_mask(SEED, (2**16, 2**16), 0.3)


def test_attention_keep_mask_exact_and_wraps_like_uint32():
    """The kernel's counter ((b*H + h)*Lq + q)*Lk + k against the reference's
    oracle, and at batch rows whose counter passes 2^32 (the oracle itself
    cannot be asked there: its mask would hold 2^32 elements)."""
    want = np.asarray(jattn.dropout_keep_oracle(SEED, 3, 2, 5, 7, 0.2))
    np.testing.assert_array_equal(thd.attention_keep_mask(SEED, 3, 2, 5, 7, 0.2).numpy(), want)
    # two batch rows from b0 = 596,523 on: their counters span 2^32
    B0, H, Lq, Lk = 596_523, 6, 40, 30
    got = thd.attention_keep_mask(SEED, 2, H, Lq, Lk, 0.2, b0=B0)
    b, h, q, k = np.meshgrid(np.arange(B0, B0 + 2), np.arange(H), np.arange(Lq), np.arange(Lk), indexing="ij")
    exact = ((b * H + h) * Lq + q) * Lk + k  # int64, no wrap
    assert exact.min() < 2**32 <= exact.max()
    u32 = lambda a: jnp.asarray(a % 2**32, jnp.uint32)
    wrapped = ((u32(b) * jnp.uint32(H) + u32(h)) * jnp.uint32(Lq) + u32(q)) * jnp.uint32(Lk) + u32(k)
    np.testing.assert_array_equal(np.asarray(wrapped), exact % 2**32)
    want = np.asarray(jhd.hash_keep_bits(wrapped, jnp.asarray(SEED, jnp.int32), 0.2))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype,tol", [("float32", F32), ("bfloat16", BF16)])
def test_plain_matches_reference(causal, dtype, tol):
    q, k, v, bias, mask = _inputs()
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = jattn.attention_reference(jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
                                     jnp.asarray(bias), jnp.asarray(mask), causal=causal)
    got = t5_attention_plain(*_t(q, k, v, bias, mask, dtype=tdt), causal=causal)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), **tol)


@pytest.mark.parametrize("dtype,tol", [("float32", F32), ("bfloat16", BF16)])
def test_plain_dropout_matches_reference_with_oracle_mask(dtype, tol):
    q, k, v, bias, mask = _inputs(Lq=20, Lk=28, seed=1)
    rate = 0.3
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    keep = jattn.dropout_keep_oracle(SEED, 3, 2, 20, 28, rate)
    want = jattn.attention_reference(jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
                                     jnp.asarray(bias), jnp.asarray(mask), dropout_keep=keep, dropout_rate=rate)
    got = t5_attention(*_t(q, k, v, bias, mask, dtype=tdt), torch.tensor([SEED], dtype=torch.int32),
                       dropout_rate=rate)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), **tol)
    other = t5_attention(*_t(q, k, v, bias, mask, dtype=tdt), SEED + 1, dropout_rate=rate)
    assert not torch.equal(got, other)


def test_plain_fully_masked_row_is_finite_and_uniform():
    q, k, v, bias, mask = _inputs(seed=2)
    mask[1] = 0
    want = np.asarray(jattn.attention_reference(*map(jnp.asarray, (q, k, v, bias, mask))))
    got = t5_attention_plain(*_t(q, k, v, bias, mask)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **F32)
    # every key at -1e9: the softmax is uniform, so the row is the mean of v
    np.testing.assert_allclose(got[1], np.broadcast_to(v[1].mean(1, keepdims=True), got[1].shape), atol=1e-5)


def test_plain_chunks_batch_rows_identically(monkeypatch):
    import rqvae_tpu_torch.ops.cuda.attention as mod

    args = _t(*_inputs(B=5, seed=3))
    whole = t5_attention_plain(*args, SEED, causal=True, dropout_rate=0.2)
    monkeypatch.setattr(mod, "_PLAIN_CHUNK_ELEMS", 2 * 2 * 24 * 24)  # two batch rows at a time
    np.testing.assert_array_equal(t5_attention_plain(*args, SEED, causal=True, dropout_rate=0.2).numpy(),
                                  whole.numpy())


def test_plain_matches_pallas_interpret():
    q, k, v, bias, mask = _inputs(seed=4)
    rate = 0.25
    want = jattn.t5_attention(*map(jnp.asarray, (q, k, v, bias, mask)), jnp.asarray([SEED], jnp.int32),
                              causal=True, dropout_rate=rate, block_b=2, interpret=True)
    got = t5_attention(*_t(q, k, v, bias, mask), SEED, causal=True, dropout_rate=rate)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_wrapper_checks():
    q, k, v, bias, mask = _t(*_inputs())
    with pytest.raises(ValueError, match="bias"):
        t5_attention(q, k, v, bias[:, :5], mask)
    with pytest.raises(ValueError, match="mask"):
        t5_attention(q, k, v, bias, mask.float())
    with pytest.raises(ValueError, match="causal"):
        t5_attention(q[:, :, :5], k, v, bias[:, :5], mask, causal=True)
    with pytest.raises(ValueError, match="dropout_rate"):
        t5_attention(q, k, v, bias, mask, dropout_rate=1.0)
    with pytest.raises(ValueError, match="do"):
        t5_attention_backward_plain(q, k, v, bias, mask, 0, q[:, :, :5])
    out = t5_attention(q.clone().requires_grad_(), k, v, bias, mask)  # inputs that require grad are taken
    assert out.requires_grad
    with pytest.raises(ValueError, match="unsupported device"):
        t5_attention(*(t.to("meta") for t in (q, k, v, bias, mask)))
