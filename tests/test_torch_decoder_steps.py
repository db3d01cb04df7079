"""Port parity, the training step as a whole: rqvae_tpu_torch's loss,
gradients and optimizer steps against rqvae_tpu on the CPU.

Small widths (L=3, K=8, d 32, dk 8, H 4, dff 64, 2 layers, batch 6, encoder
rows 24, so the attention-kernel gate of 16 is open in training). JAX params go
through `state_dict_from_jax`, both sides see the same tokenized batch.
Dropout is 0 here: JAX's PRNG stream cannot be reproduced, so dropout is held
per operation (tests/test_torch_train_ops.py, tests/test_torch_attention_bwd.py)
and by a property test below. The JAX side runs its attention through the
Pallas kernels in interpret mode (forward and backward) and, once, through XLA.

f32: loss and loss_d rtol 1e-5; logits atol 1e-4; every gradient atol 2e-5 +
rtol 1e-3 (sums over 6 x 24 positions in another order); parameters after 3
clipped AdamW updates atol 1e-4, 3% of the 3e-3 that three updates at LR 1e-3
move a parameter (Adam's first steps move every parameter by about the LR
whatever its gradient's size, so a gradient entry near 0 that differs in the
7th digit moves its parameter by a visible share of a step).
bf16: loss rtol 2e-2, logits atol 0.15. bf16 gradients are noisy at this size
in either framework: a pre-activation near 0 that rounds to the other side of
the ReLU switches a whole gradient term, and JAX's own bf16 gradient lies 5%
(mean over tensors) and up to 25% (worst tensor) of a tensor's largest entry
away from its f32 gradient. So the port's bf16 gradient is held to the f32
gradient as JAX's is: per tensor within 30% of the largest entry of either
bf16 gradient and of the f32 one, and on the mean over tensors no further from
the f32 gradient than 1.5 x JAX's bf16 gradient is.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rqvae_tpu.data.schemas import TokenizedSeqBatch as JBatch
from rqvae_tpu.models import retrieval as jr
from rqvae_tpu.ops import schedules as jsched
from rqvae_tpu.train import decoder_steps as jsteps
from rqvae_tpu.train import state as jstate

from rqvae_tpu_torch.data.schemas import TokenizedSeqBatch
from rqvae_tpu_torch.models import retrieval as tr
from rqvae_tpu_torch.ops import schedules as tsched
from rqvae_tpu_torch.ops.cuda.attention import t5_attention
from rqvae_tpu_torch.train import decoder_steps as tsteps
from rqvae_tpu_torch.train.state import adamw
from rqvae_tpu_torch.utils.convert import grads_from_jax, load_jax_params

L, K = 3, 8
FIELDS = dict(num_hierarchies=L, codebook_size=K, t5_d_model=32, t5_d_kv=8, t5_num_heads=4, t5_d_ff=64,
              t5_num_layers=2, top_k_for_generation=5, num_user_bins=7)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads, and several test
    workers that each start a thread per core slow one another down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed=0, B=6, n_items=6):
    """A tokenized batch as the tokenizer emits it, as numpy arrays."""
    r = np.random.RandomState(seed)
    D = L + 1
    table = np.concatenate([r.randint(0, K, (40, L)), np.zeros((40, 1), np.int64)], 1)
    items = r.randint(0, 40, (B, n_items))
    lengths = r.randint(1, n_items + 1, B)
    mask = np.repeat(np.arange(n_items)[None, :] < lengths[:, None], D, axis=1)
    return dict(
        user_ids=r.randint(0, 100, B).astype(np.int32),
        sem_ids=np.where(mask, table[items].reshape(B, -1), -1).astype(np.int32),
        sem_ids_fut=table[r.randint(0, 40, B)].astype(np.int32), seq_mask=mask,
        token_type_ids=np.tile(np.arange(D), (B, n_items)).astype(np.int32),
        token_type_ids_fut=np.tile(np.arange(D), (B, 1)).astype(np.int32),
    )


def _jbatch(b):
    return JBatch(**{k: jnp.asarray(v) for k, v in b.items()})


def _tbatch(b):
    return TokenizedSeqBatch(**{k: torch.from_numpy(v) for k, v in b.items()})


@functools.lru_cache(maxsize=None)
def _jax_model(dtype, fused):
    cfg = jr.RetrievalConfig(**FIELDS, t5_dropout=0.0, t5_dtype=dtype, t5_fused_attention=fused, t5_fused_decode="off")
    jm = jr.EncoderDecoderRetrievalModel(cfg)
    rngs = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}
    params = jax.device_get(jax.jit(lambda r, b: jm.init(r, b, training=True))(rngs, _jbatch(_batch())))
    return jm, params


def _port(params, dtype, **over):
    cfg = tr.RetrievalConfig(**FIELDS, t5_dtype=dtype, **{"t5_dropout": 0.0, **over})
    return load_jax_params(tr.EncoderDecoderRetrievalModel(cfg, device="cpu"), params)


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(dtype, fused, seed):
    """(ModelOutput, gradients under the port's names) of the JAX model on
    _batch(seed)."""
    jm, params = _jax_model(dtype, fused)
    b = _batch(seed=seed)

    def loss_fn(p):
        out = jm.apply(p, _jbatch(b), training=True, rngs={"dropout": jax.random.PRNGKey(2)})
        return out.loss, out

    (_, out), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    return out, grads_from_jax(jax.device_get(grads))


@pytest.mark.parametrize("dtype,fused", [("float32", "interpret"), ("float32", "off"), ("bfloat16", "interpret")])
def test_loss_and_every_gradient_match(dtype, fused):
    _, params = _jax_model(dtype, fused)
    b = _batch(seed=1)
    want, want_grads = _jax_value_and_grad(dtype, fused, 1)
    tm = _port(params, dtype)
    before = t5_attention.launches
    got = tm(_tbatch(b), training=True)
    got.loss.backward()
    assert t5_attention.launches == before  # CPU tensors never count as kernel launches
    f32 = dtype == "float32"
    np.testing.assert_allclose(got.loss.item(), float(want.loss), rtol=1e-5 if f32 else 2e-2)
    np.testing.assert_allclose(got.loss_d.detach().numpy(), np.asarray(want.loss_d), rtol=1e-5 if f32 else 2e-2)
    np.testing.assert_allclose(got.logits.detach().numpy(), np.asarray(want.logits), atol=1e-4 if f32 else 0.15, rtol=0)
    assert got.logits.shape == (6, L, K) and got.loss_d.shape == (L,)
    named = dict(tm.named_parameters())
    assert set(named) == set(want_grads)
    exact = None if f32 else _jax_value_and_grad("float32", "off", 1)[1]  # same params: init does not depend on dtype
    port_off, jax_off = [], []
    for name, p in named.items():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        g, w = p.grad.numpy(), want_grads[name].numpy()
        if f32:
            np.testing.assert_allclose(g, w, atol=2e-5, rtol=1e-3, err_msg=name)
            continue
        e = exact[name].numpy()
        top = np.abs(e).max()
        assert np.abs(g - w).max() <= 0.3 * top and np.abs(g - e).max() <= 0.3 * top, name
        port_off.append(np.abs(g - e).max() / top)
        jax_off.append(np.abs(w - e).max() / top)
    if not f32:
        assert np.mean(port_off) <= 1.5 * np.mean(jax_off), (np.mean(port_off), np.mean(jax_off))
    assert named["encoder.block.0.self_attn.rel_bias"].grad.abs().max() > 0  # through the kernel's dbias


def test_three_optimizer_steps_match():
    """3 updates of make_decoder_train_step on 3 batches: clip on (the first
    gradient's norm is above 0.5), warm-up 1, so the LR decays inside the test."""
    jm, params = _jax_model("float32", "interpret")
    tx = jstate.adamw(jsched.inverse_sqrt_schedule(1e-3, 1), weight_decay=0.1, max_grad_norm=0.5)
    jstep = jsteps.make_decoder_train_step(jm, tx)
    state = jstate.TrainState.create(jax.tree_util.tree_map(jnp.asarray, params), tx)
    tm = _port(params, "float32")
    opt = adamw(tm.parameters(), tsched.inverse_sqrt_schedule(1e-3, 1), weight_decay=0.1, max_grad_norm=0.5)
    tstep = tsteps.make_decoder_train_step(tm, opt)
    for i in range(3):
        b = _batch(seed=10 + i)
        state, jmet = jstep(state, _jbatch(b), jax.random.PRNGKey(i))
        tmet = tstep(_tbatch(b))
        np.testing.assert_allclose(tmet["total_loss"].item(), float(jmet["total_loss"]), rtol=2e-5)
        for key in ("seq_length_p25", "seq_length_p50", "seq_length_p75", "seq_length_p90", "seq_length_p100"):
            assert tmet[key].item() == pytest.approx(float(jmet[key]), rel=1e-6), key
    want = grads_from_jax(jax.device_get(state.params))
    moved = 0.0
    start = grads_from_jax(params)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-4, rtol=0, err_msg=name)
        moved = max(moved, float((p.detach() - start[name]).abs().max()))
    assert moved > 1e-3 and opt.count == 3 and opt.lr() == pytest.approx(1e-3 * 0.5)


def _store(seed=0, R=24, T=12, n_items=32):
    r = np.random.RandomState(seed)
    seq_items = r.randint(0, n_items, (R, T)).astype(np.int64)
    seq_lengths = r.randint(5, T + 1, R).astype(np.int64)
    seq_items[np.arange(T)[None, :] >= seq_lengths[:, None]] = -1
    cached = r.randint(0, K, (n_items, L + 1)).astype(np.int32)
    cached[:, -1] = 0
    return [torch.from_numpy(a) for a in (seq_items, seq_lengths, r.randint(0, 100, R).astype(np.int64), cached)]


def test_accumulated_equals_one_big_batch():
    """accum = 2 micro-batches of B rows (deterministic windows, no dropout)
    against one batch of 2B rows through the plain step: same update."""
    _, params = _jax_model("float32", "interpret")
    seq_items, seq_lengths, user_ids, cached = _store()
    B, ml = 8, 6
    row_idx = torch.from_numpy(np.random.RandomState(1).randint(0, 24, 2 * B))
    build = tsteps._make_micro_batch_fn(ml, True, False)
    big = build(seq_items, seq_lengths, user_ids, cached, row_idx, None, None)

    ta, tb = _port(params, "float32"), _port(params, "float32")
    oa, ob = adamw(ta.parameters(), 1e-3, max_grad_norm=1.0), adamw(tb.parameters(), 1e-3, max_grad_norm=1.0)
    fused = tsteps.make_decoder_fused_train_step(ta, oa, max_seq_len=ml, leave_two_out=True, subsample=False, accum=2)
    ma = fused(seq_items, seq_lengths, user_ids, cached, row_idx, torch.Generator().manual_seed(0))
    mb = tsteps.make_decoder_train_step(tb, ob)(big)
    # the two micro-batch means average to the big batch's mean (equal sizes)
    np.testing.assert_allclose(ma["total_loss"].item(), mb["total_loss"].item(), rtol=1e-5)
    np.testing.assert_allclose(ma["loss_d"].numpy(), mb["loss_d"].numpy(), rtol=1e-5)
    for (name, pa), pb in zip(ta.named_parameters(), tb.parameters()):
        np.testing.assert_allclose(pa.grad.numpy(), pb.grad.numpy(), atol=2e-6, rtol=1e-4, err_msg=name)
        np.testing.assert_allclose(pa.detach().numpy(), pb.detach().numpy(), atol=1e-5, rtol=0, err_msg=name)


def test_fused_step_subsamples_and_reports_quantiles():
    _, params = _jax_model("float32", "interpret")
    seq_items, seq_lengths, user_ids, cached = _store(seed=2)
    tm = _port(params, "float32")
    opt = adamw(tm.parameters(), 1e-3)
    step = tsteps.make_decoder_fused_train_step(tm, opt, max_seq_len=6, leave_two_out=True, subsample=True, accum=1)
    row_idx = torch.from_numpy(np.random.RandomState(3).randint(0, 24, 8))
    a = step(seq_items, seq_lengths, user_ids, cached, row_idx, torch.Generator().manual_seed(4))
    assert set(a) == {"total_loss", "loss_d", "seq_length_p25", "seq_length_p50", "seq_length_p75",
                      "seq_length_p90", "seq_length_p100"}
    assert torch.isfinite(a["total_loss"]) and a["loss_d"].shape == (L,)
    # windows of 2..5 history items, 4 tokens each
    assert 8 <= a["seq_length_p25"].item() <= a["seq_length_p100"].item() <= 24
    lengths = torch.tensor([4.0, 8.0, 8.0, 12.0, 24.0])
    batch = TokenizedSeqBatch(None, None, None, torch.arange(24)[None, :] < lengths[:, None], None, None)
    want = jsteps._debug_metrics(JBatch(None, None, None, jnp.asarray(batch.seq_mask.numpy()), None, None))
    for k, v in tsteps._debug_metrics(batch).items():
        assert v.item() == pytest.approx(float(want[k]), rel=1e-6), k


@pytest.mark.parametrize("hash_dropout", [True, False])
def test_dropout_follows_the_generator(hash_dropout):
    """Same generator seed -> same loss and gradients; another seed -> another
    loss; no generator while training with dropout -> refused; eval ignores it."""
    _, params = _jax_model("float32", "interpret")
    tm = _port(params, "float32", t5_dropout=0.2, t5_hash_dropout=hash_dropout)
    b = _tbatch(_batch(seed=5))
    torch.manual_seed(0)
    a = tm(b, training=True, generator=torch.Generator().manual_seed(11))
    a.loss.backward()
    grad_a = tm.heads.grad.clone()
    tm.zero_grad()
    torch.manual_seed(1)  # global state plays no part
    a2 = tm(b, training=True, generator=torch.Generator().manual_seed(11))
    a2.loss.backward()
    assert torch.equal(a.loss, a2.loss) and torch.equal(grad_a, tm.heads.grad)
    other = tm(b, training=True, generator=torch.Generator().manual_seed(12))
    assert not torch.equal(a.loss, other.loss)
    with pytest.raises(ValueError, match="generator"):
        tm(b, training=True)
    assert torch.equal(tm(b, training=False).loss, tm(b).loss)
    assert not torch.equal(tm(b).loss, a.loss)


def test_config_surface():
    cfg = tr.RetrievalConfig()
    ref = jr.RetrievalConfig()
    for name in ("t5_dropout", "t5_hash_dropout", "t5_remat", "t5_fused_attention", "t5_dtype"):
        assert getattr(cfg, name) == getattr(ref, name), name
    assert cfg.t5.dropout == 0.1 and cfg.t5.hash_dropout is True
    assert tr.RetrievalConfig(t5_remat=True).t5.remat is True and cfg.t5.remat is False
    assert tr.RetrievalConfig(t5_fused_attention="on", t5_fused_decode="on", t5_fused_encode="on").t5.fused_attention == "on"
    with pytest.raises(ValueError, match="fused_attention"):
        tr.RetrievalConfig(t5_fused_attention="interpret").t5
