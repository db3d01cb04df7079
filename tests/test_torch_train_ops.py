"""Port parity, the training path's small operations against rqvae_tpu on the
CPU: hash_dropout (values and gradient exact in f32), embedding_lookup's
matmul gradient, the inverse-sqrt schedule, AdamW against optax (5 updates
with clipping), window sampling (integers exact) and the hit metrics.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rqvae_tpu.data import jax_sampling as jsamp
from rqvae_tpu.ops import embedding as jemb
from rqvae_tpu.ops import hash_dropout as jhd
from rqvae_tpu.ops import metrics as jmet
from rqvae_tpu.ops import schedules as jsched
from rqvae_tpu.train import state as jstate

from rqvae_tpu_torch.data import sampling as tsamp
from rqvae_tpu_torch.models.t5 import DropoutSeeds
from rqvae_tpu_torch.ops import hash_dropout as thd
from rqvae_tpu_torch.ops import metrics as tmet
from rqvae_tpu_torch.ops import schedules as tsched
from rqvae_tpu_torch.ops.embedding import embedding_lookup
from rqvae_tpu_torch.train.state import adamw
from rqvae_tpu_torch.utils.convert import grads_from_jax


@pytest.mark.parametrize("seed,rate,shape", [(123, 0.1, (5, 7, 16)), (-9, 0.5, (300,)), (2**31 - 1, 0.25, (4, 1, 33))])
def test_hash_dropout_values_and_gradient_exact(seed, rate, shape):
    r = np.random.RandomState(0)
    x, g = r.randn(*shape).astype(np.float32), r.randn(*shape).astype(np.float32)
    want, vjp = jax.vjp(lambda a: jhd.hash_dropout(a, jnp.asarray(seed, jnp.int32), rate), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = thd.hash_dropout(xt, seed, rate)
    got.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]))
    assert 0 < (got == 0).float().mean() < 1


def test_hash_dropout_bf16_scales_at_its_dtype():
    x = np.random.RandomState(1).randn(64, 48).astype(np.float32)
    want = jhd.hash_dropout(jnp.asarray(x, jnp.bfloat16), jnp.asarray(77, jnp.int32), 0.1)
    got = thd.hash_dropout(torch.from_numpy(x).bfloat16(), 77, 0.1)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_int32_keep_bits_equal_the_uint32_hash_past_2_31():
    """The int32 mask arithmetic against the JAX uint32 hash on counters in
    both halves of the uint32 range."""
    counters = np.concatenate([np.arange(4000), 2**31 - 2000 + np.arange(4000), 2**32 - 1 - np.arange(4000)])
    for seed, rate in [(0, 0.1), (-7, 0.6), (2**31 - 1, 0.9)]:
        want = np.asarray(jhd.hash_keep_bits(jnp.asarray(counters, jnp.uint32), jnp.asarray(seed, jnp.int32), rate))
        got = thd._keep_bits_i32(thd._as_i32(torch.from_numpy(counters.astype(np.int64))), seed, rate)
        np.testing.assert_array_equal(got.numpy(), want)


# a rank's part of a global [6, 10, 16] array: the whole of it, batch rows 2-3
# (data parallelism: offset and total), columns 4-11 of each row (tensor
# parallelism: rows of 8 in global rows of 16)
DROP_SLICES = [((slice(None),), 0, None, None), ((slice(2, 4),), 2 * 160, 960, None),
               ((Ellipsis, slice(4, 12)), 4, 960, (8, 16))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("index,offset,total,row", DROP_SLICES)
def test_hash_dropout_slices_equal_the_jax_global_op(dtype, index, offset, total, row):
    """The CPU route of hash_dropout on a rank's slice (offset and total, or
    row) against that slice of JAX's hash_dropout over the global array:
    values and gradient bit for bit; hash_dropout_plain gives the same values;
    the kernel's counters do not tick."""
    from rqvae_tpu_torch.ops.cuda.hash_dropout import hash_dropout_cuda
    from rqvae_tpu_torch.utils import profiling

    r = np.random.RandomState(3)
    x, g = r.randn(6, 10, 16).astype(np.float32), r.randn(6, 10, 16).astype(np.float32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)
    want, vjp = jax.vjp(lambda a: jhd.hash_dropout(a, jnp.asarray(-31, jnp.int32), 0.3), jnp.asarray(x, jdt))
    want_g = vjp(jnp.asarray(g, jdt))[0]
    before = (hash_dropout_cuda.launches, profiling.ROOT.snapshot().get("hash_dropout.kernel"))
    xt = torch.from_numpy(np.ascontiguousarray(x[index])).to(tdt).requires_grad_()
    got = thd.hash_dropout(xt, -31, 0.3, offset, total, row)
    got.backward(torch.from_numpy(np.ascontiguousarray(g[index])).to(tdt))
    as_f32 = lambda a: np.asarray(a[index].astype(jnp.float32))
    np.testing.assert_array_equal(got.detach().float().numpy(), as_f32(want))
    np.testing.assert_array_equal(xt.grad.float().numpy(), as_f32(want_g))
    assert torch.equal(thd.hash_dropout_plain(xt.detach(), -31, 0.3, offset, total, row), got.detach())
    after = (hash_dropout_cuda.launches, profiling.ROOT.snapshot().get("hash_dropout.kernel"))
    assert after[0] == before[0] and (after[1] is None) == (before[1] is None)
    assert after[1] is None or after[1].count == before[1].count


_THRESH = thd.keep_threshold(0.1)
_SEED = torch.tensor([5], dtype=torch.int32)


@pytest.mark.parametrize("x,seed,kw,match", [
    (torch.zeros(8, dtype=torch.float16), _SEED, {}, "float32 or bfloat16"),
    (torch.zeros(8, dtype=torch.float64), _SEED, {}, "float32 or bfloat16"),
    (torch.zeros(8), _SEED, dict(offset=-1), "uint32"),
    (torch.zeros(8), _SEED, dict(offset=2**32), "uint32"),
    (torch.zeros(8), _SEED, dict(thresh=2**32), "uint32"),
    (torch.zeros(8), _SEED, dict(row=(0, 4)), "rows of"),
    (torch.zeros(8), _SEED, dict(row=(5, 4)), "rows of"),
    (torch.zeros(8), _SEED.long(), {}, "1-element int32"),
    (torch.zeros(8), torch.tensor([5, 6], dtype=torch.int32), {}, "1-element int32"),
    (torch.zeros(8), _SEED, {}, "CUDA device"),
])
def test_hash_dropout_kernel_wrapper_refuses_before_loading(monkeypatch, x, seed, kw, match):
    """What the kernel does not take raises ValueError before the library
    is loaded; nothing falls back to the plain route."""
    import rqvae_tpu_torch.ops.cuda.hash_dropout as hdk

    monkeypatch.setattr(hdk, "load_library", lambda *a: pytest.fail("the library was loaded"))
    args = {**dict(thresh=_THRESH, scale=thd.keep_scale(0.1, x.dtype), offset=0, row=None), **kw}
    with pytest.raises(ValueError, match=match):
        hdk.hash_dropout_cuda(x, seed, **args)


def test_embedding_lookup_gradient_accumulates_duplicates():
    r = np.random.RandomState(2)
    table = r.randn(12, 6).astype(np.float32)
    ids = r.randint(0, 12, (4, 9))
    ids[0, :4] = 3  # duplicates add up
    g = r.randn(4, 9, 6).astype(np.float32)
    out, vjp = jax.vjp(lambda t: jemb.embedding_lookup(t, jnp.asarray(ids)), jnp.asarray(table))
    tt = torch.from_numpy(table).requires_grad_()
    got = embedding_lookup(tt, torch.from_numpy(ids))
    got.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(out))
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]), atol=1e-6, rtol=1e-6)
    # a bf16 gradient goes through a bf16 one-hot and comes back at the table's dtype
    want16 = vjp(jnp.asarray(g, jnp.bfloat16).astype(jnp.float32))[0]
    tt.grad = None
    embedding_lookup(tt, torch.from_numpy(ids)).to(torch.bfloat16).backward(torch.from_numpy(g).bfloat16())
    assert tt.grad.dtype == torch.float32
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(want16), atol=1e-5, rtol=1e-5)


def test_inverse_sqrt_schedule_values():
    js, ts = jsched.inverse_sqrt_schedule(3e-3, 5), tsched.inverse_sqrt_schedule(3e-3, 5)
    for count in (0, 1, 4, 5, 6, 50, 9999):
        assert ts(count) == pytest.approx(float(js(count)), rel=1e-6)
    assert ts(3) == 3e-3 and ts(19) == pytest.approx(3e-3 * 0.5)
    sched = tsched.TemperatureScheduler(1.0, 0.1, 1e-3, 4)
    last = [sched.get_t(i) for i in range(40)][-1]
    assert tsched.gumbel_temperature_at(39, 1.0, 0.1, 1e-3, 4) == pytest.approx(last, rel=1e-6)
    assert float(jsched.gumbel_temperature_at(39, 1.0, 0.1, 1e-3, 4)) == pytest.approx(last, rel=1e-5)


@pytest.mark.parametrize("max_grad_norm", [None, 0.5])
def test_adamw_matches_optax(max_grad_norm):
    """5 updates on random gradients; with 0.5 the global norm (about 7)
    clips every step. Parameters rtol 2e-6 / atol 5e-7 (a few f32 steps of a
    parameter near 2: the port applies decay and step as p (1 - lr wd) - lr u,
    optax as p - lr (u + wd p)); moments rtol 1e-5."""
    r = np.random.RandomState(3)
    params = {"a": {"kernel": r.randn(6, 4).astype(np.float32)}, "b": r.randn(5).astype(np.float32)}
    grads = [{"a": {"kernel": r.randn(6, 4).astype(np.float32)}, "b": r.randn(5).astype(np.float32)} for _ in range(5)]
    tx = jstate.adamw(jsched.inverse_sqrt_schedule(1e-2, 2), weight_decay=0.1, max_grad_norm=max_grad_norm)
    jp, opt_state = jax.tree_util.tree_map(jnp.asarray, params), None
    opt_state = tx.init(jp)
    tp = {k: torch.nn.Parameter(v.clone()) for k, v in grads_from_jax(params).items()}
    opt = adamw(tp.values(), tsched.inverse_sqrt_schedule(1e-2, 2), weight_decay=0.1, max_grad_norm=max_grad_norm)
    for g in grads:
        updates, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, v in grads_from_jax(g).items():
            tp[k].grad = v.clone()
        opt.step()
    want = grads_from_jax(jax.device_get(jp))
    for k in tp:
        np.testing.assert_allclose(tp[k].detach().numpy(), want[k].numpy(), rtol=2e-6, atol=5e-7, err_msg=k)
    adam = [s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu")][0]
    mu, nu = grads_from_jax(jax.device_get(adam.mu)), grads_from_jax(jax.device_get(adam.nu))
    for i, k in enumerate(tp):
        np.testing.assert_allclose(opt.mu[i].numpy(), mu[k].numpy(), rtol=1e-5, atol=1e-8)
        np.testing.assert_allclose(opt.nu[i].numpy(), nu[k].numpy(), rtol=1e-5, atol=1e-8)
    assert opt.count == 5 and opt.lr() == pytest.approx(1e-2 * (2 / 6) ** 0.5)
    state = opt.state_dict()
    fresh = adamw([torch.nn.Parameter(p.detach().clone()) for p in tp.values()], 1e-2)
    fresh.load_state_dict(state)
    assert fresh.count == 5 and torch.equal(fresh.nu[0], opt.nu[0])


def _sequences(r, R=30, T=14):
    items = r.randint(0, 50, (R, T)).astype(np.int32)
    lengths = r.randint(1, T + 1, R).astype(np.int32)
    items[np.arange(T)[None, :] >= lengths[:, None]] = -1
    return items, lengths


@pytest.mark.parametrize("leave_two_out", [True, False])
def test_subsample_windows_integer_equality(leave_two_out):
    r = np.random.RandomState(4)
    items, lengths = _sequences(r)
    row_idx = r.randint(0, 30, 64).astype(np.int32)
    u_start, u_end = r.rand(64).astype(np.float32), r.rand(64).astype(np.float32)
    want = jsamp.subsample_windows_from_draws(jnp.asarray(u_start), jnp.asarray(u_end), jnp.asarray(items),
                                              jnp.asarray(lengths), jnp.asarray(row_idx), 6, leave_two_out)
    got = tsamp.subsample_windows_from_draws(torch.from_numpy(u_start), torch.from_numpy(u_end), torch.from_numpy(items),
                                             torch.from_numpy(lengths), torch.from_numpy(row_idx), 6, leave_two_out)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_eval_windows_integer_equality():
    r = np.random.RandomState(5)
    items, lengths = _sequences(r)
    row_idx = r.randint(0, 30, 40).astype(np.int32)
    hist_end = np.maximum(lengths[row_idx] - 2, 0).astype(np.int32)
    want = jsamp.eval_windows(jnp.asarray(items), jnp.asarray(lengths), jnp.asarray(row_idx), jnp.asarray(hist_end), 6)
    got = tsamp.eval_windows(torch.from_numpy(items), torch.from_numpy(lengths), torch.from_numpy(row_idx),
                             torch.from_numpy(hist_end), 6)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_topk_hit_metrics_equality():
    r = np.random.RandomState(6)
    actual = r.randint(0, 3, (40, 3))
    top_k = r.randint(0, 3, (40, 10, 3))
    top_k[:5, 0] = actual[:5]  # some first-beam hits
    want = jmet.topk_hit_metrics(jnp.asarray(actual), jnp.asarray(top_k), (1, 5, 10))
    got = tmet.topk_hit_metrics(torch.from_numpy(actual), torch.from_numpy(top_k), (1, 5, 10))
    assert set(got) == set(want)
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-6), k
    ja, ta = jmet.TopKAccumulator((1, 5)), tmet.TopKAccumulator((1, 5))
    for acc in (ja, ta):
        acc.accumulate(actual[:20], top_k[:20])
        acc.accumulate(actual[20:], top_k[20:])
    assert ta.reduce() == pytest.approx(ja.reduce(), rel=1e-6)
    assert 0 < ta.reduce()["h@1"] <= ta.reduce()["h@5"] <= 1


def test_dropout_seeds_come_from_the_generator_only():
    torch.manual_seed(0)  # global state is not read
    first = DropoutSeeds.draw(torch.Generator().manual_seed(5), 2, 70)
    torch.manual_seed(1)
    assert torch.equal(first, DropoutSeeds.draw(torch.Generator().manual_seed(5), 2, 70))
    assert first.shape == (2, 128) and first.dtype == torch.int32 and DropoutSeeds.columns(44) == 64
    flat = first.flatten().tolist()
    assert len(set(flat)) > 250 and all(0 <= s < 2**31 - 1 for s in flat)
    assert not torch.equal(first, DropoutSeeds.draw(torch.Generator().manual_seed(6), 2, 70))
    # blocks of 64 drawn row after row: the draws of a generator that handed
    # out one block per forward pass, in the same order
    g = torch.Generator().manual_seed(5)
    blocks = [torch.randint(0, 2**31 - 1, (64,), generator=g) for _ in range(4)]
    assert torch.equal(first.flatten().long(), torch.cat(blocks))
