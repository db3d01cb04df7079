"""`amp=True` (rqvae_tpu_torch/ops/amp.py) on the CPU.

The JAX trainers' amp sets `jax_default_matmul_precision="bfloat16"`, which
changes nothing on the CPU; neither does the port's flag, whose bf16 products
run on the card only (`aten::mm.dtype` has no CPU kernel). So:

- inside the flag, CPU products are the float32 products bit for bit, and
  3 steps of each stage with amp=True equal 3 JAX steps under the bf16 matmul
  precision at the f32 tolerances of tests/test_torch_step_graphs.py;
- the bf16 route's arithmetic is checked here with the card's
  `mm(..., out_dtype=float32)` replaced by a float32 product of the same
  bf16 operands (`emulated_card`): forward and both gradients equal that
  formula, each step launches 3 products per trainable product (1 where the
  input needs no gradient) and reads nothing back to the host, and the
  trainers route their steps through it.

The card's own products are held to the same formula in
tests/test_torch_kernels_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rqvae_tpu.models.quantize import QuantizeForwardMode as JMode
from rqvae_tpu.models.rqvae import RqVae as JRqVae
from rqvae_tpu.models.rqvae import RqVaeConfig as JRqVaeConfig
from rqvae_tpu.ops import schedules as jsched
from rqvae_tpu.train import decoder_steps as jdsteps
from rqvae_tpu.train import rqvae_steps as jrsteps
from rqvae_tpu.train import state as jstate

from rqvae_tpu_torch.data.registry import RecDataset
from rqvae_tpu_torch.models import retrieval as tr
from rqvae_tpu_torch.models.quantize import QuantizeForwardMode
from rqvae_tpu_torch.models.rqvae import RqVae, RqVaeConfig
from rqvae_tpu_torch.ops import amp
from rqvae_tpu_torch.ops import schedules as tsched
from rqvae_tpu_torch.train import decoder_steps as tdsteps
from rqvae_tpu_torch.train import rqvae_steps as trsteps
from rqvae_tpu_torch.train import train_decoder
from rqvae_tpu_torch.train.state import adamw
from rqvae_tpu_torch.utils import profiling
from rqvae_tpu_torch.utils.convert import grads_from_jax, load_jax_params
from tests.test_torch_step_graphs import (
    B, BANNED, FIELDS, ROWS, RQ_FIELDS, _features, _jax_decoder, _Record, _store,
)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def emulated_card(monkeypatch):
    """The bf16 route on CPU tensors: every tensor counts as on the card, and
    the card's product of bf16 operands with float32 sums is a float32
    product of them, rounded to the output dtype (tests/test_torch_dense.py
    takes it too). Yields the list of the output dtypes of the products
    launched, one entry a product."""
    launched = []

    def mm(a, b, out_dtype):
        launched.append(out_dtype)
        return (a.float() @ b.float()).to(out_dtype)

    monkeypatch.setattr(amp, "on_card", lambda x: True)
    monkeypatch.setattr(amp, "_mm", mm)
    return launched


def counted(name: str) -> int:
    """The multiply-adds counted under `name` in the root recorder."""
    agg = profiling.ROOT.snapshot().get(name)
    return 0 if agg is None else agg.count


def _rounded(t):
    return t.detach().to(torch.bfloat16).float()


def test_amp_is_the_float32_product_on_the_cpu():
    g = torch.Generator().manual_seed(0)
    x, w = torch.randn(5, 7, 12, generator=g), torch.randn(9, 12, generator=g)
    a, b = torch.randn(3, 4, 12, generator=g), torch.randn(3, 12, 6, generator=g)
    matmul = torch.backends.cuda.matmul
    before = (counted("amp.bf16"), matmul.allow_bf16_reduced_precision_reduction)
    with amp.bf16_products(True):
        assert amp._enabled and not matmul.allow_bf16_reduced_precision_reduction
        assert not amp.active(x)
        y, c = amp.linear(x, w), amp.matmul(a, b)
    assert torch.equal(y, F.linear(x, w)) and torch.equal(c, a @ b)
    assert (counted("amp.bf16"), matmul.allow_bf16_reduced_precision_reduction) == before and not amp._enabled
    with amp.bf16_products(False):
        assert not amp._enabled


@pytest.mark.parametrize("case", ["linear", "linear_input_without_grad", "batched"])
def test_the_bf16_route_rounds_the_operands_and_sums_in_float32(case, emulated_card):
    g = torch.Generator().manual_seed(1)
    if case == "batched":
        a = torch.randn(3, 10, 16, generator=g).requires_grad_(True)
        b = torch.randn(3, 16, 5, generator=g).requires_grad_(True)
        fn, want = amp.matmul, lambda: _rounded(a) @ _rounded(b)
    else:
        a = torch.randn(4, 6, 16, generator=g).requires_grad_(case == "linear")
        b = torch.randn(5, 16, generator=g).requires_grad_(True)
        fn, want = amp.linear, lambda: _rounded(a) @ _rounded(b).t()
    gy = torch.randn(want().shape, generator=g)
    n0, c0 = len(emulated_card), counted("amp.bf16")
    with amp.bf16_products(True):
        y = fn(a, b)
        y.backward(gy)
    n = 2 if case == "linear_input_without_grad" else 3
    assert emulated_card[n0:] == [torch.float32] * n
    assert counted("amp.bf16") - c0 == n * a.numel() * 5  # each product: a's rows x 16 x 5
    torch.testing.assert_close(y, want(), rtol=1e-6, atol=1e-6)
    g16 = _rounded(gy)
    if case == "batched":
        da, db = g16 @ _rounded(b).transpose(1, 2), _rounded(a).transpose(1, 2) @ g16
    else:
        da = g16 @ _rounded(b)
        db = (g16.reshape(-1, 5).t() @ _rounded(a).reshape(-1, 16))
    torch.testing.assert_close(b.grad, db, rtol=1e-6, atol=1e-5)
    if a.requires_grad:
        torch.testing.assert_close(a.grad, da, rtol=1e-6, atol=1e-5)
    else:
        assert a.grad is None
    # the route differs from the float32 product: the operands were rounded
    assert not torch.allclose(y, (a @ b.t()) if case != "batched" else a @ b, rtol=0, atol=1e-7)


def _decoder_products(fields) -> int:
    """3 products per trainable product of one stage-2 forward: 6 dense per
    encoder block, 10 per decoder block, and the heads."""
    n = 6 * fields["t5_num_layers"] + 10 * fields["t5_num_layers"] + 1
    return 3 * n


def test_amp_steps_launch_their_products_and_read_nothing_back(emulated_card):
    """What a step graph captures with amp: one step's count of bf16 products
    and no host read, in both stages, 2 micro-batches each."""
    store = _store()
    model = tr.EncoderDecoderRetrievalModel(tr.RetrievalConfig(**FIELDS, t5_dropout=0.1), device="cpu", seed=0)
    opt = adamw(model.parameters(), tsched.inverse_sqrt_schedule(1e-3, 2), weight_decay=0.1, max_grad_norm=0.5)
    chunk = tdsteps.make_decoder_graph_train_step(model, opt, max_seq_len=6, n_steps=2, batch_size=B, accum=2,
                                                  amp=True)
    chunk.bind(*store)
    chunk.chunks.stage([chunk.draws(0, s, ROWS) for s in range(2)])
    chunk.chunks.replay(1)
    n0 = len(emulated_card)
    with _Record() as rec:
        chunk.chunks.replay(1)
    assert len(emulated_card) - n0 == 2 * _decoder_products(FIELDS)
    assert "mm" in rec.ops and not rec.ops & BANNED, rec.ops & BANNED

    x = _features()
    rq = RqVae(RqVaeConfig(**RQ_FIELDS), device="cpu", seed=0)
    chunk = trsteps.make_rqvae_graph_train_step(rq, adamw(rq.parameters(), 1e-3), n_steps=2, accum=2, batch_size=8,
                                                amp=True)
    chunk.features = x
    chunk.chunks.stage([chunk.draws(0, s, len(x)) for s in range(2)])
    chunk.chunks.replay(1)
    n0 = len(emulated_card)
    with _Record() as rec:
        chunk.chunks.replay(1)
    n_lin = len(RQ_FIELDS["hidden_dims"]) + 1  # per MLP; the first encoder layer's input needs no gradient
    assert len(emulated_card) - n0 == 2 * (3 * 2 * n_lin - 1)
    assert not rec.ops & BANNED, rec.ops & BANNED


def test_decoder_amp_chunk_matches_the_jax_amp_steps():
    """3 stage-2 steps with amp=True against 3 JAX fused steps under
    jax.default_matmul_precision("bfloat16"), on the CPU: the f32 tolerances
    of tests/test_torch_step_graphs.py::test_decoder_chunk_matches_the_jax_steps."""
    jm, params = _jax_decoder()
    store, k, seed = _store(), 3, 9
    tx = jstate.adamw(jsched.inverse_sqrt_schedule(1e-3, 1), weight_decay=0.1, max_grad_norm=0.5)
    jstep = jdsteps.make_decoder_fused_train_step(jm, tx, max_seq_len=6, subsample=False)
    state = jstate.TrainState.create(jax.tree_util.tree_map(jnp.asarray, params), tx)
    tm = load_jax_params(tr.EncoderDecoderRetrievalModel(tr.RetrievalConfig(**FIELDS, t5_dropout=0.0), device="cpu"),
                         params)
    opt = adamw(tm.parameters(), tsched.inverse_sqrt_schedule(1e-3, 1), weight_decay=0.1, max_grad_norm=0.5)
    chunk = tdsteps.make_decoder_graph_train_step(tm, opt, max_seq_len=6, n_steps=1, batch_size=B, subsample=False,
                                                  amp=True)
    jstore = [jnp.asarray(t.numpy()) for t in store]
    with jax.default_matmul_precision("bfloat16"):
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


def test_rqvae_amp_chunk_matches_the_jax_amp_steps():
    """A chunk of 3 stage-1 steps with amp=True (STE, 2 micro-batches)
    against 3 JAX index steps under the bf16 matmul precision: losses rtol
    1e-5, parameters atol 1e-5."""
    x = _features(n=64, seed=4)
    jm = JRqVae(JRqVaeConfig(**RQ_FIELDS, codebook_mode=JMode.STE))
    params = jax.device_get(jm.init({"params": jax.random.PRNGKey(0), "gumbel": jax.random.PRNGKey(1)},
                                    jnp.asarray(x[:8].numpy()), 0.2, training=True))
    tx = jstate.adamw(1e-3, weight_decay=0.1)
    jstep = jrsteps.make_rqvae_index_train_step(jm, tx)
    state = jstate.TrainState.create(jax.tree_util.tree_map(jnp.asarray, params), tx)
    tm = load_jax_params(RqVae(RqVaeConfig(**RQ_FIELDS, codebook_mode=QuantizeForwardMode.STE), device="cpu"), params)
    opt = adamw(tm.parameters(), 1e-3, weight_decay=0.1)
    chunk = trsteps.make_rqvae_graph_train_step(tm, opt, n_steps=3, accum=2, batch_size=16, amp=True)
    draws = [chunk.draws(1, s, 64) for s in range(3)]
    jsum = 0.0
    with jax.default_matmul_precision("bfloat16"):
        for d in draws:
            state, jmet = jstep(state, jnp.asarray(x.numpy()), jnp.asarray(d["idx"], jnp.int32),
                                jax.random.PRNGKey(0), jnp.float32(0.2))
            jsum += float(jmet["total_loss"])
    got = chunk(x, draws)
    np.testing.assert_allclose(got["total_loss"].item(), jsum / 3, rtol=1e-5)
    want = grads_from_jax(jax.device_get(state.params))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-5, rtol=0, err_msg=name)


def test_the_stage2_trainer_takes_amp(tmp_path, emulated_card):
    """train_decoder.train(amp=True) at t5_dtype="float32" runs its steps on
    the bf16 route (emulated here): each step launches its products, and the
    loss stays within the bf16 tests' 2e-2 of the float32 run's."""
    kw = dict(iterations=2, batch_size=8, dataset=RecDataset.SYNTHETIC, dataset_folder=str(tmp_path / "ds"),
              vae_input_dim=64, vae_n_cat_feats=0, vae_hidden_dims=[32], vae_embed_dim=8, vae_codebook_size=16,
              vae_n_layers=3, t5_d_model=32, t5_num_heads=4, t5_d_ff=64, t5_num_layers=1, top_k_for_generation=5,
              warmup_steps=5, partial_eval_every=1000, full_eval_every=1000, full_eval_max_batches=1,
              steps_per_loop=1, t5_dtype="float32", device="cpu")
    runs = {}
    for flag in (False, True):
        n0 = len(emulated_card)
        runs[flag] = train_decoder.train(amp=flag, save_dir_root=str(tmp_path / f"amp{flag}"), **kw)
        runs[flag]["products"] = len(emulated_card) - n0
    per_step = 3 * (6 + 10 + 1)
    assert runs[False]["products"] == 0 and runs[True]["products"] == 2 * per_step
    assert runs[True]["total_loss"] != runs[False]["total_loss"]
    np.testing.assert_allclose(runs[True]["total_loss"], runs[False]["total_loss"], rtol=2e-2)
