"""Chunks of training steps (train/step_graph.py) on the CPU: the body that a
CUDA graph captures on the card, run eagerly through the same staged buffers.

- A chunk of k steps takes the k steps of the eager fused step bit for bit
  (parameters, both moments, the count, each step's metrics), in both stages,
  with hash dropout, 2 accumulated micro-batches, and in stage 1 the Gumbel
  noise with the temperature anneal computed on the device.
- A chunk's metrics are the means over its steps (the step-order sum over k),
  and the trainers log them at a chunk's end, as the JAX trainers log their
  scan's means.
- k steps of the port against k steps of the JAX package on the same batches
  (no dropout: JAX's PRNG stream cannot be reproduced), at the tolerances of
  tests/test_torch_decoder_steps.py and tests/test_torch_rqvae_train.py's
  test_three_optimizer_steps_match.
- The chunk rule equals the JAX trainers' on a table of cadences; a resume
  at a chunk boundary repeats an unbroken run bit for bit; the step bodies
  make no host read and no tensor from host data (recorded op by op, as
  tests/test_torch_engine.py rehearses the serving capture).
- Device seeds: hash dropout and the attention keep mask from a 1-element
  int32 tensor give rqvae_tpu/ops/hash_dropout.py::keep_mask's bits, seeds of
  2^31 and more included; kernels 4 and 5's plain versions with a tensor seed
  against the Pallas kernels in interpret mode on both routes' shapes.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from rqvae_tpu.models import retrieval as jr
from rqvae_tpu.models.quantize import QuantizeForwardMode as JMode
from rqvae_tpu.models.rqvae import RqVae as JRqVae
from rqvae_tpu.models.rqvae import RqVaeConfig as JRqVaeConfig
from rqvae_tpu.ops import hash_dropout as jhd
from rqvae_tpu.ops import schedules as jsched
from rqvae_tpu.ops.pallas import attention as jattn
from rqvae_tpu.train import decoder_steps as jdsteps
from rqvae_tpu.train import rqvae_steps as jrsteps
from rqvae_tpu.train import state as jstate

from rqvae_tpu_torch.data.registry import RecDataset
from rqvae_tpu_torch.models import retrieval as tr
from rqvae_tpu_torch.models.quantize import QuantizeForwardMode
from rqvae_tpu_torch.models.rqvae import RqVae, RqVaeConfig
from rqvae_tpu_torch.ops import hash_dropout as thd
from rqvae_tpu_torch.ops import schedules as tsched
from rqvae_tpu_torch.ops.cuda.attention import t5_attention_backward_plain, t5_attention_plain
from rqvae_tpu_torch.train import decoder_steps as tdsteps
from rqvae_tpu_torch.train import rqvae_steps as trsteps
from rqvae_tpu_torch.train import train_decoder, train_rqvae
from rqvae_tpu_torch.train.state import adamw
from rqvae_tpu_torch.train.step_graph import step_generator, step_rows, steps_per_loop
from rqvae_tpu_torch.utils import checkpoint as ckpt
from rqvae_tpu_torch.utils.convert import grads_from_jax, load_jax_params

L, K = 3, 8
FIELDS = dict(num_hierarchies=L, codebook_size=K, t5_d_model=32, t5_d_kv=8, t5_num_heads=4, t5_d_ff=64,
              t5_num_layers=2, top_k_for_generation=5, num_user_bins=7)
RQ_FIELDS = dict(input_dim=24, embed_dim=8, hidden_dims=(16, 12), codebook_size=16, n_layers=3)
ROWS, B = 24, 6


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _store(seed=0, T=12, n_items=32):
    r = np.random.RandomState(seed)
    seq_items = r.randint(0, n_items, (ROWS, T)).astype(np.int64)
    seq_lengths = r.randint(5, T + 1, ROWS).astype(np.int64)
    seq_items[np.arange(T)[None, :] >= seq_lengths[:, None]] = -1
    cached = r.randint(0, K, (n_items, L + 1)).astype(np.int32)
    cached[:, -1] = 0
    return tuple(torch.from_numpy(a) for a in (seq_items, seq_lengths, r.randint(0, 100, ROWS).astype(np.int64),
                                               cached))


def _decoder(dropout=0.1, **over):
    return tr.EncoderDecoderRetrievalModel(tr.RetrievalConfig(**FIELDS, t5_dropout=dropout, **over), device="cpu",
                                           seed=0)


def _opt(model):
    return adamw(model.parameters(), tsched.inverse_sqrt_schedule(1e-3, 2), weight_decay=0.1, max_grad_norm=0.5)


def _assert_same_state(ma, oa, mb, ob):
    for (name, pa), pb in zip(ma.named_parameters(), mb.parameters()):
        assert torch.equal(pa, pb), name
    for a, b in zip(oa.mu + oa.nu, ob.mu + ob.nu):
        assert torch.equal(a, b)
    assert oa.count == ob.count


def _eager_decoder_steps(model, opt, store, seed, steps, accum, max_seq_len=6):
    fused = tdsteps.make_decoder_fused_train_step(model, opt, max_seq_len=max_seq_len, accum=accum)
    return [fused(*store, torch.from_numpy(step_rows(seed, s, ROWS, accum * B)), step_generator(seed, s))
            for s in steps]


def _step_sum(metrics, key):
    """The step-order float32 sum of one metric over steps, as a chunk sums it."""
    total = torch.zeros_like(metrics[0][key])
    for m in metrics:
        total = total + m[key]
    return total


@pytest.mark.parametrize("accum", [1, 2])
def test_decoder_chunk_takes_the_eager_steps_bit_for_bit(accum):
    store, k, seed = _store(), 3, 5
    a, b = _decoder(), _decoder()
    oa, ob = _opt(a), _opt(b)
    chunk = tdsteps.make_decoder_graph_train_step(a, oa, max_seq_len=6, n_steps=k, batch_size=B, accum=accum)
    chunk.bind(*store)
    chunk.chunks.stage([chunk.draws(seed, s, ROWS) for s in range(k)])
    eager = _eager_decoder_steps(b, ob, store, seed, range(k), accum)
    running = {key: torch.zeros_like(v) for key, v in eager[0].items()}
    for m in eager:  # step by step: each replay adds exactly the eager step's metrics
        chunk.chunks.replay(1)
        for key, v in m.items():
            running[key] = running[key] + v
            assert torch.equal(chunk.chunks.sums[key], running[key]), key
    _assert_same_state(a, oa, b, ob)
    assert oa.count == k and set(chunk.chunks.sums) == set(eager[0])


def test_chunk_metrics_are_the_means_of_its_steps():
    store, k, seed = _store(seed=1), 4, 2
    a, b = _decoder(), _decoder()
    oa, ob = _opt(a), _opt(b)
    chunk = tdsteps.make_decoder_graph_train_step(a, oa, max_seq_len=6, n_steps=k, batch_size=B)
    got = chunk(*store, [chunk.draws(seed, s, ROWS) for s in range(k)])
    eager = _eager_decoder_steps(b, ob, store, seed, range(k), 1)
    for key in got:
        assert torch.equal(got[key], _step_sum(eager, key) / k), key
    assert not torch.equal(got["total_loss"], eager[-1]["total_loss"])  # the mean, not the last step
    # a second chunk goes on from where the first stopped (the draws of steps k..2k-1)
    got2 = chunk(*store, [chunk.draws(seed, s, ROWS) for s in range(k, 2 * k)])
    eager2 = _eager_decoder_steps(b, ob, store, seed, range(k, 2 * k), 1)
    assert torch.equal(got2["total_loss"], _step_sum(eager2, "total_loss") / k)
    _assert_same_state(a, oa, b, ob)
    with pytest.raises(ValueError, match="same tensors"):
        chunk(*_store(seed=1), [chunk.draws(seed, 0, ROWS)])
    with pytest.raises(ValueError, match="chunk"):
        chunk(*store, [chunk.draws(seed, s, ROWS) for s in range(k + 1)])


def _rqvae(mode=QuantizeForwardMode.GUMBEL_SOFTMAX, seed=0):
    return RqVae(RqVaeConfig(**RQ_FIELDS, codebook_mode=mode), device="cpu", seed=seed)


def _features(n=64, seed=0):
    r = np.random.RandomState(seed)
    centers = r.randn(6, RQ_FIELDS["input_dim"]) * 2
    return torch.from_numpy((centers[r.randint(0, 6, n)] + 0.3 * r.randn(n, RQ_FIELDS["input_dim"]))
                            .astype(np.float32))


@pytest.mark.parametrize("mode", [QuantizeForwardMode.GUMBEL_SOFTMAX, QuantizeForwardMode.ROTATION_TRICK])
def test_rqvae_chunk_takes_the_eager_steps_bit_for_bit(mode):
    """Gumbel noise from the staged uniforms and the anneal computed on the
    device from the step number; 2 micro-batches of 8."""
    x, k, seed, A, Bs = _features(), 4, 3, 2, 8
    t_fn = functools.partial(tsched.gumbel_temperature_at, t0=1.0, min_t=0.1, anneal_rate=0.05, step_size=2)
    a, b = _rqvae(mode), _rqvae(mode)
    oa, ob = adamw(a.parameters(), 1e-3, weight_decay=0.1), adamw(b.parameters(), 1e-3, weight_decay=0.1)
    chunk = trsteps.make_rqvae_graph_train_step(a, oa, n_steps=k, accum=A, batch_size=Bs, t_fn=t_fn)
    got = chunk(x, [chunk.draws(seed, s, len(x)) for s in range(k)])
    eager_step = trsteps.make_rqvae_index_train_step(b, ob)
    eager = [eager_step(x, torch.from_numpy(step_rows(seed, s, len(x), A * Bs).reshape(A, Bs)),
                        step_generator(seed, s), t_fn(torch.tensor(s))) for s in range(k)]
    for key in got:
        assert torch.equal(got[key], _step_sum(eager, key) / k), key
    _assert_same_state(a, oa, b, ob)
    assert float(eager[-1]["gumbel_t"]) == pytest.approx(t_fn(k - 1)) and float(eager[-1]["gumbel_t"]) < 1.0


def test_the_trainers_log_chunk_means(tmp_path, monkeypatch):
    """train_decoder.train and train_rqvae.train with the automatic chunk
    (log_every 2 -> 2 steps a chunk): the logged total_loss at each chunk end
    is the chunk's mean, computed from the steps of an eager run."""
    kw = dict(iterations=4, log_every=2, dataset_folder=str(tmp_path / "ds"), dataset=RecDataset.SYNTHETIC,
              vae_input_dim=64, vae_n_cat_feats=0, vae_hidden_dims=[32], vae_embed_dim=8, vae_codebook_size=16,
              vae_n_layers=3, batch_size=8, device="cpu")
    dec = dict(t5_d_model=32, t5_num_heads=4, t5_d_ff=64, t5_num_layers=1, top_k_for_generation=5,
               partial_eval_every=1000, full_eval_every=1000, save_model_every=1000, full_eval_max_batches=1, **kw)
    logged = {}
    for spl in (None, 1):
        seen = []
        monkeypatch.setattr(train_decoder.MetricLogger, "log",
                            lambda self, it, m, echo=False, seen=seen: seen.append((it, m)))
        train_decoder.train(save_dir_root=str(tmp_path / f"dec{spl}"), steps_per_loop=spl,
                            **{**dec, "log_every": 1 if spl == 1 else 2})
        logged[spl] = {it: m["total_loss"] for it, m in seen if "total_loss" in m}
    per_step = logged[1]
    assert sorted(logged[None]) == [1, 3] and sorted(per_step) == [0, 1, 2, 3]
    for end in (1, 3):
        want = (torch.tensor(per_step[end - 1]) + torch.tensor(per_step[end])) / 2
        assert logged[None][end] == float(want), end

    rq = dict(eval_every=1000, save_model_every=1000, **kw)
    for spl in (None, 1):
        seen = []
        monkeypatch.setattr(train_rqvae.MetricLogger, "log",
                            lambda self, it, m, echo=False, seen=seen: seen.append((it, m)))
        train_rqvae.train(save_dir_root=str(tmp_path / f"rq{spl}"), steps_per_loop=spl,
                          **{**rq, "log_every": 1 if spl == 1 else 2})
        logged[spl] = {it: m["total_loss"] for it, m in seen if "total_loss" in m}
    for end in (1, 3):
        want = (torch.tensor(logged[1][end - 1]) + torch.tensor(logged[1][end])) / 2
        assert logged[None][end] == float(want), end


# ---- against the JAX package ----

@functools.lru_cache(maxsize=None)
def _jax_decoder():
    cfg = jr.RetrievalConfig(**FIELDS, t5_dropout=0.0, t5_dtype="float32", t5_fused_attention="off",
                             t5_fused_decode="off")
    jm = jr.EncoderDecoderRetrievalModel(cfg)
    store = _store()
    build = jdsteps._make_batch_builder(6, True, False)
    example = build(*(jnp.asarray(t.numpy()) for t in store), jnp.arange(B), None, None)
    params = jax.device_get(jm.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                                    example, training=True))
    return jm, params


def test_decoder_chunk_matches_the_jax_steps():
    """3 steps of a chunk (deterministic windows, no dropout, clipped AdamW
    with the LR decaying) against 3 JAX fused steps on the same rows: loss
    rtol 2e-5, parameters atol 1e-4 (the tolerances of
    tests/test_torch_decoder_steps.py::test_three_optimizer_steps_match)."""
    jm, params = _jax_decoder()
    store, k, seed = _store(), 3, 9
    tx = jstate.adamw(jsched.inverse_sqrt_schedule(1e-3, 1), weight_decay=0.1, max_grad_norm=0.5)
    jstep = jdsteps.make_decoder_fused_train_step(jm, tx, max_seq_len=6, subsample=False)
    state = jstate.TrainState.create(jax.tree_util.tree_map(jnp.asarray, params), tx)
    tm = load_jax_params(tr.EncoderDecoderRetrievalModel(tr.RetrievalConfig(**FIELDS, t5_dropout=0.0), device="cpu"),
                         params)
    opt = adamw(tm.parameters(), tsched.inverse_sqrt_schedule(1e-3, 1), weight_decay=0.1, max_grad_norm=0.5)
    chunk = tdsteps.make_decoder_graph_train_step(tm, opt, max_seq_len=6, n_steps=1, batch_size=B, subsample=False)
    jstore = [jnp.asarray(t.numpy()) for t in store]
    for s in range(k):
        draws = chunk.draws(seed, s, ROWS)
        state, jmet = jstep(state, *jstore, jnp.asarray(draws["row_idx"].reshape(-1), jnp.int32),
                            jax.random.PRNGKey(s))
        tmet = chunk(*store, [draws])
        np.testing.assert_allclose(tmet["total_loss"].item(), float(jmet["total_loss"]), rtol=2e-5)
    want = grads_from_jax(jax.device_get(state.params))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-4, rtol=0, err_msg=name)
    assert opt.count == k == int(state.step)


def test_rqvae_chunk_matches_the_jax_steps():
    """A chunk of 3 stage-1 steps (STE, 2 micro-batches) against 3 JAX
    index steps on the same rows: losses rtol 1e-5, parameters atol 1e-5
    (tests/test_torch_rqvae_train.py::test_three_optimizer_steps_match)."""
    x = _features(n=64, seed=4)
    jm = JRqVae(JRqVaeConfig(**RQ_FIELDS, codebook_mode=JMode.STE))
    params = jax.device_get(jm.init({"params": jax.random.PRNGKey(0), "gumbel": jax.random.PRNGKey(1)},
                                    jnp.asarray(x[:8].numpy()), 0.2, training=True))
    tx = jstate.adamw(1e-3, weight_decay=0.1)
    jstep = jrsteps.make_rqvae_index_train_step(jm, tx)
    state = jstate.TrainState.create(jax.tree_util.tree_map(jnp.asarray, params), tx)
    tm = load_jax_params(RqVae(RqVaeConfig(**RQ_FIELDS, codebook_mode=QuantizeForwardMode.STE), device="cpu"), params)
    opt = adamw(tm.parameters(), 1e-3, weight_decay=0.1)
    chunk = trsteps.make_rqvae_graph_train_step(tm, opt, n_steps=3, accum=2, batch_size=16)
    draws = [chunk.draws(1, s, 64) for s in range(3)]
    jsum = 0.0
    for d in draws:
        state, jmet = jstep(state, jnp.asarray(x.numpy()), jnp.asarray(d["idx"], jnp.int32), jax.random.PRNGKey(0),
                            jnp.float32(0.2))
        jsum += float(jmet["total_loss"])
    got = chunk(x, draws)
    np.testing.assert_allclose(got["total_loss"].item(), jsum / 3, rtol=1e-5)
    want = grads_from_jax(jax.device_get(state.params))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-5, rtol=0, err_msg=name)


# ---- the chunk rule, resume, the captured bodies ----

def _jax_rule(steps_per_loop_, cadences):
    """rqvae_tpu/train/train_decoder.py's chunk rule, as written there."""
    spl = 1
    if steps_per_loop_ != 1:
        auto = math.gcd(*cadences)
        if steps_per_loop_ is None:
            spl = max(1, math.gcd(auto, 500))
        else:
            spl = max(1, math.gcd(steps_per_loop_, auto))
    return spl


@pytest.mark.parametrize("requested", [None, 1, 2, 50, 100, 1000, 7])
def test_steps_per_loop_rule_equals_the_jax_trainers(requested):
    table = [
        [100, 10000, 1_000_000, 5000, 1000],  # decoder_amazon
        [100, 20000, 1_000_000, 5000, 5000],  # decoder_ml32m
        [100, 400000, 5000, 5000],  # rqvae_amazon
        [100, 50000, 10000, 10000],  # rqvae_ml32m
        [500, 400000, 5000, 5000],  # rqvae_fullbudget
        [4, 12, 1_000_000, 6, 12],
        [100, 7, 1000, 1000, 1000],
        [1000, 2000, 1000],
    ]
    for cadences in table:
        assert steps_per_loop(requested, cadences) == _jax_rule(requested, cadences), cadences
    assert steps_per_loop(None, table[0]) == 100 and steps_per_loop(None, [1000, 2000]) == 500


def test_resume_at_a_chunk_boundary_repeats_an_unbroken_run(tmp_path):
    """8 stage-2 iterations in chunks of 2 against 4, a checkpoint, and 4
    more (hash dropout on): the same parameters and moments, bit for bit."""
    kw = dict(dataset_folder=str(tmp_path / "ds"), dataset=RecDataset.SYNTHETIC, vae_input_dim=64,
              vae_n_cat_feats=0, vae_hidden_dims=[32], vae_embed_dim=8, vae_codebook_size=16, vae_n_layers=3,
              batch_size=8, t5_d_model=32, t5_num_heads=4, t5_d_ff=64, t5_num_layers=1, top_k_for_generation=5,
              t5_dropout=0.1, partial_eval_every=1000, full_eval_every=1000, save_model_every=1000,
              full_eval_max_batches=1, log_every=2, seed=4, device="cpu")
    whole = train_decoder.train(iterations=8, save_dir_root=str(tmp_path / "a"), **kw)
    train_decoder.train(iterations=4, save_dir_root=str(tmp_path / "b"), **kw)
    rest = train_decoder.train(iterations=4, save_dir_root=str(tmp_path / "b"), auto_resume=True, **kw)
    a, b = ckpt.load_checkpoint(whole["checkpoint_path"]), ckpt.load_checkpoint(rest["checkpoint_path"])
    assert a["step"] == b["step"] == 7 and a["opt_state"]["count"] == b["opt_state"]["count"] == 8
    for name in a["params"]:
        assert torch.equal(a["params"][name], b["params"][name]), name
    for ma, mb in zip(a["opt_state"]["mu"] + a["opt_state"]["nu"], b["opt_state"]["mu"] + b["opt_state"]["nu"]):
        assert torch.equal(ma, mb)
    assert whole["total_loss"] == rest["total_loss"]


BANNED = {"_local_scalar_dense", "nonzero", "lift_fresh", "lift_fresh_copy", "item"}


class _Record(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.add(func.__name__.split(".")[0])
        return func(*args, **(kwargs or {}))


def test_the_step_bodies_read_nothing_back_to_the_host():
    """What a step graph captures (StepChunks._one_step over each stage's
    body) makes no host read and no tensor from host data: recorded op by op
    after one warm-up run, as the capture follows one eager run."""
    store = _store()
    model = _decoder()
    chunk = tdsteps.make_decoder_graph_train_step(model, _opt(model), max_seq_len=6, n_steps=2, batch_size=B,
                                                  accum=2)
    chunk.bind(*store)
    chunk.chunks.stage([chunk.draws(0, s, ROWS) for s in range(2)])
    chunk.chunks.replay(1)
    with _Record() as rec:
        chunk.chunks.replay(1)
    assert {"bitwise_xor_", "index_select", "_foreach_add_"} <= rec.ops and not rec.ops & BANNED, rec.ops & BANNED

    x = _features()
    t_fn = functools.partial(tsched.gumbel_temperature_at, t0=1.0, min_t=0.1, anneal_rate=0.05, step_size=2)
    rq = _rqvae()
    chunk = trsteps.make_rqvae_graph_train_step(rq, adamw(rq.parameters(), 1e-3), n_steps=2, accum=2, batch_size=8,
                                                t_fn=t_fn)
    chunk.features = x
    chunk.chunks.stage([chunk.draws(0, s, len(x)) for s in range(2)])
    chunk.chunks.replay(1)
    with _Record() as rec:
        chunk.chunks.replay(1)
    assert {"log", "exp", "_foreach_add_"} <= rec.ops and not rec.ops & BANNED, rec.ops & BANNED
    with _Record() as probe:  # the recorder does see what it bans
        torch.tensor([1, 2]).sum().item()
    assert probe.ops & BANNED


# ---- device seeds: the keep bits and kernels 4 and 5's plain versions ----

SEEDS = [0, 77, 2**31 - 1, 2**31, 2**32 - 5]


@pytest.mark.parametrize("seed", SEEDS)
def test_device_seed_keep_bits_equal_the_jax_keep_mask(seed):
    """A 1-element int32 tensor holding the seed's uint32 bits (negative past
    2^31) gives the JAX keep_mask's bits, in hash_dropout and in the
    attention kernel's counter layout."""
    t = thd.seed_tensor(seed)
    assert t.dtype == torch.int32 and t.shape == (1,)
    want = np.asarray(jhd.keep_mask(jnp.asarray(np.uint32(seed)), (6, 5, 33), 0.1))
    np.testing.assert_array_equal(thd.keep_mask(t, (6, 5, 33), 0.1).numpy(), want)
    x = np.random.RandomState(seed % 97).randn(6, 5, 33).astype(np.float32)
    got = thd.hash_dropout(torch.from_numpy(x), t, 0.1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jhd.hash_dropout(jnp.asarray(x), jnp.asarray(np.uint32(seed)), 0.1)))
    Bt, H, Lq, Lk = 3, 2, 5, 7
    counter = np.arange(Bt * H * Lq * Lk, dtype=np.uint32).reshape(Bt, H, Lq, Lk)
    want = np.asarray(jhd.hash_keep_bits(jnp.asarray(counter), jnp.asarray(np.uint32(seed)), 0.25))
    np.testing.assert_array_equal(thd.attention_keep_mask(t, Bt, H, Lq, Lk, 0.25).numpy(), want)
    np.testing.assert_array_equal(thd.attention_keep_mask(seed, Bt, H, Lq, Lk, 0.25).numpy(), want)


def _attention_inputs(Bt, H, Lq, Lk, dk, seed):
    r = np.random.RandomState(seed)
    q, k, v = (r.randn(Bt, H, n, dk).astype(np.float32) * 0.5 for n in (Lq, Lk, Lk))
    bias = r.randn(H, Lq, Lk).astype(np.float32) * 0.1
    mask = (np.arange(Lk)[None, :] < r.randint(1, Lk + 1, Bt)[:, None]).astype(np.int32)
    do = r.randn(Bt, H, Lq, dk).astype(np.float32)
    return q, k, v, bias, mask, do


@pytest.mark.parametrize("Lq,Lk,seed", [(20, 20, 11), (24, 40, 2**31 + 3), (16, 16, -5)])
def test_attention_plain_versions_with_a_device_seed_match_pallas(Lq, Lk, seed):
    """t5_attention_plain and t5_attention_backward_plain with the seed as a
    1-element int32 tensor, dropout 0.1, against the Pallas forward and its
    VJP in interpret mode (whole-row lengths and a longer key row)."""
    q, k, v, bias, mask, do = _attention_inputs(3, 2, Lq, Lk, 16, abs(seed) % 1000)
    seed32 = np.uint32(seed % 2**32).astype(np.int32)
    jseed = jnp.asarray([seed32], jnp.int32)

    def jf(q_, k_, v_, b_):
        return jattn.t5_attention(q_, k_, v_, b_, jnp.asarray(mask), jseed, causal=False, dropout_rate=0.1,
                                  interpret=True)

    jout, vjp = jax.vjp(jf, *(jnp.asarray(a) for a in (q, k, v, bias)))
    jgrads = vjp(jnp.asarray(do))
    tseed = torch.tensor([int(seed32)], dtype=torch.int32)
    tq, tk, tv, tb = (torch.from_numpy(a) for a in (q, k, v, bias))
    tm = torch.from_numpy(mask)
    out = t5_attention_plain(tq, tk, tv, tb, tm, tseed, dropout_rate=0.1)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=2e-5, rtol=0)
    grads = t5_attention_backward_plain(tq, tk, tv, tb, tm, tseed, torch.from_numpy(do), dropout_rate=0.1)
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-5, rtol=1e-4, err_msg=name)
    other = t5_attention_plain(tq, tk, tv, tb, tm, tseed + 1, dropout_rate=0.1)
    assert not torch.equal(out, other)
