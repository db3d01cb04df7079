"""Port parity, T5 side: rqvae_tpu_torch stacks and the decoder-stack plain
version against rqvae_tpu's XLA path on the CPU.

Small widths (d 32, dk 8, H 4, dff 64, 2 layers). Tolerances: f32
atol=rtol=1e-5 for one op, 1e-4 after two layers; bf16 atol=rtol=5e-2;
relative position buckets exact.
"""

import functools
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rqvae_tpu.models import t5 as jt5

from rqvae_tpu_torch.models import t5 as tt5
from rqvae_tpu_torch.ops.cuda.decoder_stack import t5_decoder_stack_infer
from rqvae_tpu_torch.utils.convert import load_jax_params

JCFG = jt5.T5StackConfig(
    d_model=32, d_kv=8, num_heads=4, d_ff=64, num_layers=2, dropout=0.0, fused_decode="off",
    fused_encode="off", fused_attention="off",
)
TCFG = tt5.T5StackConfig(d_model=32, d_kv=8, num_heads=4, d_ff=64, num_layers=2)
F32 = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=5e-2, rtol=5e-2)


@functools.lru_cache(maxsize=None)
def _decoder_params(dtype):
    """Decoder-stack params (their shapes do not depend on beams or T)."""
    js = jt5.T5Stack(replace(JCFG, dtype=dtype), is_decoder=True)
    x, enc, m = np.zeros((2, 1, 32), np.float32), np.zeros((2, 3, 32), np.float32), np.ones((2, 3), np.int32)
    init = jax.jit(lambda key, x, e, m: js.init(key, x, enc_out=e, enc_mask=m))
    return js, jax.device_get(init(jax.random.PRNGKey(0), x, enc, m))


def _decoder(beams, T, B=4, Le=6, seed=0, dtype="float32"):
    """JAX decoder stack, its params, the port's copy, and numpy inputs."""
    r = np.random.RandomState(seed)
    x = r.randn(B * beams, T, 32).astype(np.float32)
    enc = r.randn(B, Le, 32).astype(np.float32)
    enc_mask = (r.rand(B, Le) > 0.3).astype(np.int32)
    enc_mask[:, 0] = 1
    js, params = _decoder_params(dtype)
    ts = load_jax_params(tt5.T5Stack(replace(TCFG, dtype=dtype), is_decoder=True), params)
    return js, params, ts, x, enc, enc_mask


def _xla_decode(js, params, x, enc, enc_mask, beams):
    """The JAX XLA decoder stack, jitted (one compile, not one per op)."""
    fn = jax.jit(lambda p, x, e, m: js.apply(p, x, enc_out=e, enc_mask=m, beams=beams))
    return np.asarray(fn(params, x, enc, enc_mask))


def _jax_cross_kv(js, params, enc):
    return jax.jit(lambda p, e: js.apply(p, e, method=jt5.T5Stack.cross_kv))(params, enc)


@pytest.mark.parametrize("bidirectional", [True, False])
def test_relative_position_bucket_exact(bidirectional):
    rp = np.arange(-400, 401, dtype=np.int32)
    want = np.asarray(jt5.relative_position_bucket(jnp.asarray(rp), bidirectional, 32, 128))
    got = tt5.relative_position_bucket(torch.from_numpy(rp), bidirectional, 32, 128)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm(dtype):
    x = np.random.RandomState(1).randn(5, 32).astype(np.float32) * 3
    jn = jt5.RMSNorm(1e-6)
    params = jax.device_get(jn.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    params["params"]["weight"] = np.linspace(0.5, 1.5, 32).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = np.asarray(jn.apply(params, jnp.asarray(x).astype(jdt)).astype(jnp.float32))
    tn = load_jax_params(tt5.RMSNorm(32, 1e-6), params)
    got = tn(torch.from_numpy(x).to(tdt))
    assert got.dtype == torch.float32  # bf16 normalized * f32 scale promotes, as in JAX
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dtype,tol", [("float32", F32), ("bfloat16", BF16)])
def test_encoder_stack(dtype, tol):
    r = np.random.RandomState(2)
    x = r.randn(3, 10, 32).astype(np.float32)
    mask = (r.rand(3, 10) > 0.3).astype(np.int32)
    mask[:, 0] = 1
    js = jt5.T5Stack(replace(JCFG, dtype=dtype), is_decoder=False)
    params = jax.device_get(jax.jit(lambda k, x, m: js.init(k, x, self_mask=m))(jax.random.PRNGKey(1), x, mask))
    want = np.asarray(jax.jit(lambda p, x, m: js.apply(p, x, self_mask=m))(params, x, mask))
    ts = load_jax_params(tt5.T5Stack(replace(TCFG, dtype=dtype)), params)
    got = ts(torch.from_numpy(x), self_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), want, **tol)


@pytest.mark.parametrize("dtype,tol", [("float32", F32), ("bfloat16", BF16)])
def test_decoder_stack_beam_folded(dtype, tol):
    beams, T = 3, 2
    js, params, ts, x, enc, enc_mask = _decoder(beams, T, dtype=dtype)
    want = _xla_decode(js, params, x, enc, enc_mask, beams)
    kv = ts.cross_kv(torch.from_numpy(enc))
    got = ts(torch.from_numpy(x), enc_out=torch.from_numpy(enc),
             enc_mask=torch.from_numpy(enc_mask), beams=beams)
    got_cached = ts(torch.from_numpy(x), enc_mask=torch.from_numpy(enc_mask), beams=beams, cross_kv=kv)
    np.testing.assert_allclose(got.detach().numpy(), want, **tol)
    np.testing.assert_array_equal(got_cached.detach().numpy(), got.detach().numpy())
    # the stacked cross K/V cache holds the JAX per-layer kv_heads
    jkv = _jax_cross_kv(js, params, enc)
    for i, (k, v) in enumerate(jkv):
        np.testing.assert_allclose(kv[0][i].float().detach().numpy(), np.asarray(k.astype(jnp.float32)), **tol)
        np.testing.assert_allclose(kv[1][i].float().detach().numpy(), np.asarray(v.astype(jnp.float32)), **tol)


@pytest.mark.parametrize(
    "beams,T,dtype,tol",
    [(1, 1, "float32", F32), (3, 2, "float32", F32), (5, 3, "float32", F32), (3, 2, "bfloat16", BF16)],
)
def test_fused_decode_plain_matches_xla(beams, T, dtype, tol):
    """The decoder-stack kernel's plain version (what the wrapper runs on
    CPU tensors) against the JAX XLA decoder stack."""
    js, params, ts, x, enc, enc_mask = _decoder(beams, T, dtype=dtype)
    B = enc.shape[0]
    want = _xla_decode(js, params, x, enc, enc_mask, beams)
    with torch.no_grad():
        got = ts.fused_decode(
            torch.from_numpy(x).reshape(B, beams * T, -1), ts.cross_kv(torch.from_numpy(enc)),
            torch.from_numpy(enc_mask), beams, ts.decode_weights(),
        )
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy().reshape(B * beams, T, -1), want, **tol)


def test_fused_decode_plain_matches_pallas_interpret():
    beams, T = 3, 2
    js, params, ts, x, enc, enc_mask = _decoder(beams, T)
    B = enc.shape[0]
    jkv = _jax_cross_kv(js, params, enc)
    want = np.asarray(js.apply(
        params, jnp.asarray(x).reshape(B, beams * T, -1), jkv, jnp.asarray(enc_mask), beams,
        interpret=True, method=jt5.T5Stack.fused_decode,
    ))
    with torch.no_grad():
        got = ts.fused_decode(
            torch.from_numpy(x).reshape(B, beams * T, -1), ts.cross_kv(torch.from_numpy(enc)),
            torch.from_numpy(enc_mask), beams, ts.decode_weights(),
        )
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_fused_decode_gate_keeps_reference_value():
    ts = tt5.T5Stack(TCFG, is_decoder=True)
    assert tt5.FUSED_DECODE_MAX_LEN == jt5.FUSED_DECODE_MAX_LEN == 128
    assert ts.use_fused_decode(128) and not ts.use_fused_decode(129)
    assert not tt5.T5Stack(replace(TCFG, fused_decode="off"), is_decoder=True).use_fused_decode(8)


def test_decoder_stack_wrapper_checks_shapes():
    _, _, ts, x, enc, enc_mask = _decoder(1, 1)
    w = ts.decode_weights()
    kc, vc = ts.cross_kv(torch.from_numpy(enc))
    xf = torch.from_numpy(x).reshape(4, 1, 32)
    bias = torch.zeros(4, 1, 1)
    mask = torch.zeros(4, 6)
    with pytest.raises(ValueError, match="bias_fold"):
        t5_decoder_stack_infer(xf, *w, torch.zeros(4, 2, 2), kc, vc, mask, eps=1e-6)
    with pytest.raises(ValueError, match="kc"):
        t5_decoder_stack_infer(xf, *w, bias, kc[:, :2], vc, mask, eps=1e-6)
    with pytest.raises(ValueError, match="unsupported device"):
        t5_decoder_stack_infer(xf.to("meta"), *w, bias, kc, vc, mask, eps=1e-6)
