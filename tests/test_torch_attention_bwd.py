"""Port parity, attention backward: gradients of rqvae_tpu_torch's
`t5_attention` (q, k, v, bias) against `jax.grad` through rqvae_tpu's Pallas
attention in interpret mode, with the same seed, on the CPU (where the port
runs its plain backward).

f32: atol 2e-5 (the JAX package's own tolerance for this backward), rtol 1e-5.
bf16: atol 6e-2, rtol 3e-2: dq, dk, dv are rounded to bf16 once (up to 4e-3
relative), and the two frameworks sum the f32 products in another order, so
single pd or ds elements round the other way before their products.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rqvae_tpu.ops.pallas import attention as jattn

from rqvae_tpu_torch.ops.cuda import attention as tattn
from rqvae_tpu_torch.ops.cuda.attention import (
    backward_groups,
    t5_attention,
    t5_attention_backward_plain,
    t5_attention_plain,
)

F32 = dict(atol=2e-5, rtol=1e-5)
BF16 = dict(atol=6e-2, rtol=3e-2)
SEED = 4321


def _inputs(B=3, H=2, Lq=24, Lk=24, dk=8, seed=0, masked_row=None):
    r = np.random.RandomState(seed)
    q, k, v, do = (r.randn(B, H, L, dk).astype(np.float32) for L in (Lq, Lk, Lk, Lq))
    bias = r.randn(H, Lq, Lk).astype(np.float32)
    lengths = r.randint(1, Lk + 1, B)  # ragged key masks
    mask = (np.arange(Lk)[None, :] < lengths[:, None]).astype(np.int32)
    if masked_row is not None:
        mask[masked_row] = 0  # a row with every key masked
    return q, k, v, bias, mask, do


def _jax_grads(q, k, v, bias, mask, do, jdt, causal, rate):
    qj, kj, vj, doj = (jnp.asarray(a, jdt) for a in (q, k, v, do))
    seed = jnp.asarray([SEED], jnp.int32)

    def f(qq, kk, vv, bb):
        out = jattn.t5_attention(qq, kk, vv, bb, jnp.asarray(mask), seed, causal=causal, dropout_rate=rate,
                                 block_b=2, interpret=True)
        return jnp.sum(out.astype(jnp.float32) * doj.astype(jnp.float32))

    return [np.asarray(g.astype(jnp.float32)) for g in jax.grad(f, argnums=(0, 1, 2, 3))(qj, kj, vj, jnp.asarray(bias))]


def _torch_grads(q, k, v, bias, mask, do, tdt, causal, rate):
    qt, kt, vt = (torch.from_numpy(a).to(tdt).requires_grad_() for a in (q, k, v))
    bt = torch.from_numpy(bias).requires_grad_()
    out = t5_attention(qt, kt, vt, bt, torch.from_numpy(mask), SEED, causal=causal, dropout_rate=rate)
    out.backward(torch.from_numpy(do).to(tdt))
    return [g.grad.float().numpy() for g in (qt, kt, vt, bt)]


@pytest.mark.parametrize("dtype,tol", [("float32", F32), ("bfloat16", BF16)])
@pytest.mark.parametrize(
    "shape,causal,rate,masked_row",
    [(dict(), False, 0.0, None), (dict(), False, 0.2, 1), (dict(), True, 0.2, None),
     (dict(Lq=20, Lk=28, B=4), False, 0.2, 0), (dict(Lq=16, Lk=40, H=3, dk=16), False, 0.0, None)],
    ids=["plain", "dropout-masked-row", "causal-dropout", "lq-ne-lk-dropout", "lq-ne-lk"],
)
def test_gradients_match_pallas_backward(dtype, tol, shape, causal, rate, masked_row):
    q, k, v, bias, mask, do = _inputs(seed=3, masked_row=masked_row, **shape)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = _jax_grads(q, k, v, bias, mask, do, jdt, causal, rate)
    got = _torch_grads(q, k, v, bias, mask, do, tdt, causal, rate)
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, w, err_msg=name, **tol)
    assert np.abs(got[3]).max() > 0  # the bias gradient is summed over the batch, not dropped


@pytest.mark.parametrize("causal,rate", [(False, 0.0), (True, 0.25)])
def test_plain_backward_matches_autograd_through_plain_forward(causal, rate, monkeypatch):
    """In f32 no rounding point acts, so the hand-written backward is the
    derivative of the plain forward: autograd through it must agree."""
    q, k, v, bias, mask, do = _inputs(B=5, seed=5, masked_row=2)
    monkeypatch.setattr(tattn, "_PLAIN_CHUNK_ELEMS", 2 * 2 * 24 * 24)  # two batch rows at a time
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, bias)]
    out = t5_attention_plain(*ts, torch.from_numpy(mask), SEED, causal=causal, dropout_rate=rate)
    want = torch.autograd.grad(out, ts, torch.from_numpy(do))
    got = t5_attention_backward_plain(*(t.detach() for t in ts), torch.from_numpy(mask), SEED,
                                      torch.from_numpy(do), causal=causal, dropout_rate=rate)
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=name, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_two_backward_calls_are_bit_equal(dtype):
    q, k, v, bias, mask, do = _inputs(seed=6)
    a = _torch_grads(q, k, v, bias, mask, do, dtype, True, 0.3)
    b = _torch_grads(q, k, v, bias, mask, do, dtype, True, 0.3)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    other = _torch_grads(q, k, v, bias, mask, do, dtype, True, 0.0)
    assert not np.array_equal(a[0], other[0])  # the dropout mask reaches the backward


def test_backward_takes_a_tensor_seed_and_none_for_mask_and_seed():
    q, k, v, bias, mask, do = _inputs(seed=7)
    qt = torch.from_numpy(q).requires_grad_()
    mt = torch.from_numpy(mask)
    seed = torch.tensor([SEED], dtype=torch.int32)
    out = t5_attention(qt, torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(bias), mt, seed, dropout_rate=0.2)
    out.backward(torch.from_numpy(do))
    want = _torch_grads(q, k, v, bias, mask, do, torch.float32, False, 0.2)[0]
    np.testing.assert_array_equal(qt.grad.numpy(), want)
    assert mt.grad is None and seed.grad is None


@pytest.mark.parametrize("B,H,Lq,want_max", [(640, 6, 80, 160), (64, 6, 800, 16), (4, 2, 24, 1), (9, 1, 16, 2)])
def test_backward_groups_cover_the_batch(B, H, Lq, want_max):
    """The dq/dbias pass's batch groups: a few, none empty, all rows covered."""
    g = backward_groups(B, H, Lq)
    rows = -(-B // g)
    assert 1 <= g <= want_max and g <= max(1, B // 4)
    assert (g - 1) * rows < B <= g * rows
