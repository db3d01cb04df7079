"""Port parity, long-row encoder: the encoder-stack kernel's plain version
and the port's routing against rqvae_tpu on the CPU.

Small widths (d 32, dk 8, H 4, dff 64, 2 layers), rows of 11 and 16 (11 is
no multiple of 8: the reference pads such rows, the port does not), ragged
key masks. Tolerances against the XLA stack: f32 atol=rtol=1e-4 (two layers
of f32 sums in another order), bf16 atol=rtol=5e-2 (a bf16 rounding of the
residual stream flipped by summation order carries through the layers);
against the Pallas kernel in interpret mode, f32 atol=rtol=1e-5.
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
from rqvae_tpu_torch.ops.cuda import attention as attention_mod
from rqvae_tpu_torch.ops.cuda import encoder_stack as encoder_mod
from rqvae_tpu_torch.ops.cuda.encoder_stack import t5_encoder_stack_infer, t5_encoder_stack_plain
from rqvae_tpu_torch.utils.convert import load_jax_params

JCFG = jt5.T5StackConfig(
    d_model=32, d_kv=8, num_heads=4, d_ff=64, num_layers=2, dropout=0.0, fused_decode="off",
    fused_encode="off", fused_attention="off",
)
TCFG = tt5.T5StackConfig(d_model=32, d_kv=8, num_heads=4, d_ff=64, num_layers=2)
F32 = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=5e-2, rtol=5e-2)


@functools.lru_cache(maxsize=None)
def _params(dtype):
    js = jt5.T5Stack(replace(JCFG, dtype=dtype))
    x, m = np.zeros((2, 4, 32), np.float32), np.ones((2, 4), np.int32)
    return js, jax.device_get(jax.jit(lambda k, x, m: js.init(k, x, self_mask=m))(jax.random.PRNGKey(3), x, m))


def _setup(L, dtype="float32", B=3, seed=0, masked=True, **tcfg):
    """The JAX XLA encoder stack, its params, the port's copy and numpy inputs
    with ragged key masks (histories of different lengths, padded)."""
    r = np.random.RandomState(seed)
    x = r.randn(B, L, 32).astype(np.float32)
    lengths = r.randint(1, L + 1, B)
    lengths[0] = L
    mask = (np.arange(L)[None, :] < lengths[:, None]).astype(np.int32) if masked else None
    js, params = _params(dtype)
    ts = load_jax_params(tt5.T5Stack(replace(TCFG, dtype=dtype, **tcfg)), params)
    return js, params, ts, x, mask


def _xla(js, params, x, mask):
    return np.asarray(jax.jit(lambda p, x, m: js.apply(p, x, self_mask=m))(params, x, mask))


@pytest.fixture
def small_gates(monkeypatch):
    """Both 512 gates of the port down to 8 (the reference is driven through
    its XLA path and its explicit interpret-mode calls, which need no gate)."""
    monkeypatch.setattr(tt5, "FUSED_ENCODE_MIN_LEN", 8)
    monkeypatch.setattr(tt5, "FUSED_ATTENTION_MIN_LEN", 8)
    monkeypatch.setattr(tt5, "FUSED_ATTENTION_MIN_TILE", 8)


@pytest.mark.parametrize("L,masked", [(11, True), (16, True), (16, False)])
@pytest.mark.parametrize("dtype,tol", [("float32", F32), ("bfloat16", BF16)])
def test_plain_matches_xla_stack(L, masked, dtype, tol):
    js, params, ts, x, mask = _setup(L, dtype, masked=masked)
    want = _xla(js, params, x, mask)
    with torch.no_grad():
        got = ts.fused_encode(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, **tol)


@pytest.mark.parametrize("dtype,tol", [("float32", dict(atol=1e-5, rtol=1e-5)), ("bfloat16", BF16)])
def test_plain_matches_pallas_interpret(dtype, tol):
    js, params, ts, x, mask = _setup(11, dtype, seed=1)
    want = np.asarray(js.apply(params, jnp.asarray(x), jnp.asarray(mask), interpret=True,
                               method=jt5.T5Stack.fused_encode))
    with torch.no_grad():
        got = ts.fused_encode(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, **tol)


def test_fully_masked_row_matches_xla_and_is_finite():
    """An all-padding history: every key at -1e9 gives the uniform softmax of
    the XLA path, finite; query rows are never masked."""
    js, params, ts, x, mask = _setup(11, seed=2)
    mask[1] = 0
    want = _xla(js, params, x, mask)
    with torch.no_grad():
        got = ts.fused_encode(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **F32)


def test_encode_operands_layout():
    """The operand layout of the reference's fused_encode, without its row
    padding: per-head projections, block 0's bidirectional bias, additive mask."""
    js, params, ts, x, mask = _setup(11)
    ops = ts.encode_operands(torch.from_numpy(x), torch.from_numpy(mask))
    xk, wq, wk, wv, wo, wi, wo2, ln_s, ln_f, ln_final, bias, madd = ops
    p = params["params"]
    kern = lambda i, name: p[f"block_{i}"]["self_attn"][name]["kernel"]
    for i in range(2):
        np.testing.assert_array_equal(wq[i].detach().numpy(), kern(i, "q").reshape(32, 4, 8).transpose(1, 0, 2))
        np.testing.assert_array_equal(wo[i].detach().numpy(), kern(i, "o").reshape(4, 8, 32))
        np.testing.assert_array_equal(wi[i].detach().numpy(), p[f"block_{i}"]["ffn"]["wi"]["kernel"])
        np.testing.assert_array_equal(wo2[i].detach().numpy(), p[f"block_{i}"]["ffn"]["wo"]["kernel"])
    assert xk.shape == (3, 11, 32) and bias.shape == (4, 11, 11) and ln_final.shape == (32,)
    rel = jnp.asarray(p["block_0"]["self_attn"]["rel_bias"])
    pos = jnp.arange(11)
    buckets = jt5.relative_position_bucket(pos[None, :] - pos[:, None], True, 32, 128)
    np.testing.assert_array_equal(bias.detach().numpy(), np.asarray(rel[buckets].transpose(2, 0, 1)))
    np.testing.assert_array_equal(madd.numpy(), np.where(mask != 0, 0.0, -1e9).astype(np.float32))
    with pytest.raises(ValueError, match="encoder stacks"):
        tt5.T5Stack(TCFG, is_decoder=True).encode_operands(torch.from_numpy(x), None)


@pytest.mark.parametrize("route", ["encoder_stack", "attention", "plain"])
def test_forward_routes_by_the_gates_and_matches_xla(small_gates, monkeypatch, route):
    """T5Stack.forward takes the encoder-stack kernel first, the attention
    kernel per layer with fused_encode="off", the plain path with both off;
    every route gives the XLA stack's output."""
    calls = {"encoder_stack": 0, "attention": 0}

    def counting(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(tt5, "t5_encoder_stack_infer", counting("encoder_stack", encoder_mod.t5_encoder_stack_infer))
    monkeypatch.setattr(tt5, "t5_attention", counting("attention", attention_mod.t5_attention))
    modes = {"encoder_stack": {}, "attention": dict(fused_encode="off"),
             "plain": dict(fused_encode="off", fused_attention="off")}[route]
    js, params, ts, x, mask = _setup(11, **modes)
    want = _xla(js, params, x, mask)
    with torch.no_grad():
        got = ts(torch.from_numpy(x), self_mask=torch.from_numpy(mask))
        short = ts(torch.from_numpy(x[:, :7]), self_mask=torch.from_numpy(mask[:, :7]))  # under the gates
    np.testing.assert_allclose(got.numpy(), want, **F32)
    assert calls == {"encoder_stack": int(route == "encoder_stack"), "attention": 2 * int(route == "attention")}
    np.testing.assert_allclose(short.numpy(), _xla(js, params, x[:, :7], mask[:, :7]), **F32)


def test_gates_equal_the_reference():
    """The gate values and what they decide, against the reference with its
    device check forced past ("on")."""
    assert tt5.FUSED_ENCODE_MIN_LEN == jt5.FUSED_ENCODE_MIN_LEN == 512
    assert tt5.FUSED_DECODE_MAX_LEN == jt5.FUSED_DECODE_MAX_LEN == 128
    assert tt5.FUSED_ATTENTION_MIN_LEN == 512 and tt5.FUSED_ATTENTION_MIN_TILE == 16
    for mode, jmode in (("auto", "on"), ("off", "off")):
        tenc = tt5.T5Stack(replace(TCFG, fused_encode=mode))
        jenc = jt5.T5Stack(replace(JCFG, fused_encode=jmode))
        for L in (16, 511, 512, 800, 801):
            for training in (False, True):
                assert tenc.use_fused_encode(L, training) == jenc.use_fused_encode(L, training), (mode, L)
        tatt = tt5.T5Attention(replace(TCFG, fused_attention=mode))
        jatt = jt5.T5Attention(replace(JCFG, fused_attention=jmode))
        for lq, lk in ((1, 800), (15, 800), (16, 16), (511, 800), (512, 512), (800, 800), (800, 511), (30, 80)):
            for training in (False, True):
                assert tatt._use_fused(lq, lk, training) == jatt._use_fused(lq, lk, training), (mode, lq, lk)
    assert not tt5.T5Stack(TCFG, is_decoder=True).use_fused_encode(800)
    with pytest.raises(ValueError, match="fused_encode"):
        tt5.T5StackConfig(fused_encode="interpret")


def test_wrapper_checks_shapes_and_device():
    _, _, ts, x, mask = _setup(11)
    ops = list(ts.encode_operands(torch.from_numpy(x), torch.from_numpy(mask)))
    with torch.no_grad():
        assert torch.equal(t5_encoder_stack_infer(*ops, eps=1e-6), t5_encoder_stack_plain(*ops, eps=1e-6))
    bad = list(ops)
    bad[10] = ops[10][:, :5]
    with pytest.raises(ValueError, match="bias"):
        t5_encoder_stack_infer(*bad, eps=1e-6)
    bad = list(ops)
    bad[11] = ops[11].to(torch.int32)
    with pytest.raises(ValueError, match="mask"):
        t5_encoder_stack_infer(*bad, eps=1e-6)
    with pytest.raises(ValueError, match="unsupported device"):
        t5_encoder_stack_infer(*(t.to("meta") for t in ops), eps=1e-6)
