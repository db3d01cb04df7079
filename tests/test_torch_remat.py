"""`t5_remat` on the CPU: each T5 block of a training forward rematerialised in
the backward pass (torch.utils.checkpoint, the counterpart of the JAX model's
`nn.remat`).

- With dropout 0.1 (hash masks from the sites' fixed seeds, in the attention
  plain version and at the other sites) the loss and every gradient equal
  those without remat bit for bit: the recomputed blocks read the same seeds.
- A chunk of steps with remat equals one without, bit for bit.
- Against the JAX model with t5_remat=True (its XLA attention; no dropout:
  JAX's PRNG stream cannot be reproduced), at the fused step's tolerances of
  tests/test_torch_decoder_steps.py (loss rtol 1e-5, gradients atol 2e-5 +
  rtol 1e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rqvae_tpu.data.schemas import TokenizedSeqBatch as JBatch
from rqvae_tpu.models import retrieval as jr

from rqvae_tpu_torch.data.schemas import TokenizedSeqBatch
from rqvae_tpu_torch.models import retrieval as tr
from rqvae_tpu_torch.models.t5 import DropoutSeeds
from rqvae_tpu_torch.ops.cuda.attention import t5_attention
from rqvae_tpu_torch.train import decoder_steps as tdsteps
from rqvae_tpu_torch.train.state import adamw
from rqvae_tpu_torch.utils.convert import grads_from_jax, load_jax_params

L, K = 3, 8
FIELDS = dict(num_hierarchies=L, codebook_size=K, t5_d_model=32, t5_d_kv=8, t5_num_heads=4, t5_d_ff=64,
              t5_num_layers=2, top_k_for_generation=5, num_user_bins=7)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed=0, B=6, n_items=6):
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


def _tbatch(b):
    return TokenizedSeqBatch(**{k: torch.from_numpy(v) for k, v in b.items()})


def _loss_and_grads(model, batch, seeds):
    model.zero_grad()
    out = model(batch, training=True, seeds=seeds)
    out.loss.backward()
    return out.loss.detach(), {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("fused", ["auto", "off"])
def test_remat_equals_no_remat_bit_for_bit_with_dropout(fused):
    """fused "auto": attention through the kernel's autograd function (its
    plain version here), "off": the plain attention with its weights'
    dropout site."""
    kw = dict(**FIELDS, t5_dropout=0.1, t5_fused_attention=fused)
    plain = tr.EncoderDecoderRetrievalModel(tr.RetrievalConfig(**kw), device="cpu", seed=3)
    remat = tr.EncoderDecoderRetrievalModel(tr.RetrievalConfig(**kw, t5_remat=True), device="cpu", seed=3)
    assert remat.encoder.cfg.remat and not plain.encoder.cfg.remat
    seeds = DropoutSeeds.draw(torch.Generator().manual_seed(8), 1, plain.n_dropout_sites)[0]
    b = _tbatch(_batch(seed=2))
    la, ga = _loss_and_grads(plain, b, seeds)
    lb, gb = _loss_and_grads(remat, b, seeds)
    assert torch.equal(la, lb)
    for name in ga:
        assert torch.equal(ga[name], gb[name]), name
    assert not torch.equal(la, _loss_and_grads(plain, b, seeds + 1)[0])  # the seeds do reach the masks
    assert plain.n_dropout_sites == (2 + 4 * 2) + (2 + 6 * 2)


def test_remat_chunk_equals_a_chunk_without_remat():
    r = np.random.RandomState(0)
    seq_items = r.randint(0, 32, (24, 12)).astype(np.int64)
    seq_lengths = r.randint(5, 13, 24).astype(np.int64)
    seq_items[np.arange(12)[None, :] >= seq_lengths[:, None]] = -1
    cached = r.randint(0, K, (32, L + 1)).astype(np.int32)
    cached[:, -1] = 0
    store = [torch.from_numpy(a) for a in (seq_items, seq_lengths, r.randint(0, 100, 24), cached)]
    models, opts, chunks = [], [], []
    for remat in (False, True):
        m = tr.EncoderDecoderRetrievalModel(tr.RetrievalConfig(**FIELDS, t5_dropout=0.1, t5_remat=remat),
                                            device="cpu", seed=1)
        o = adamw(m.parameters(), 1e-3, max_grad_norm=1.0)
        c = tdsteps.make_decoder_graph_train_step(m, o, max_seq_len=6, n_steps=2, batch_size=6, accum=2)
        models.append(m), opts.append(o)
        chunks.append(c(*store, [c.draws(5, s, 24) for s in range(2)]))
    assert torch.equal(chunks[0]["total_loss"], chunks[1]["total_loss"])
    for (name, pa), pb in zip(models[0].named_parameters(), models[1].parameters()):
        assert torch.equal(pa, pb), name
    for a, b in zip(opts[0].mu + opts[0].nu, opts[1].mu + opts[1].nu):
        assert torch.equal(a, b)


def test_remat_matches_the_jax_model_with_remat():
    cfg = jr.RetrievalConfig(**FIELDS, t5_dropout=0.0, t5_dtype="float32", t5_fused_attention="off",
                             t5_fused_decode="off", t5_remat=True)
    jm = jr.EncoderDecoderRetrievalModel(cfg)
    b = _batch(seed=1)
    jb = JBatch(**{k: jnp.asarray(v) for k, v in b.items()})
    params = jax.device_get(jm.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, jb,
                                    training=True))

    def loss_fn(p):
        out = jm.apply(p, jb, training=True, rngs={"dropout": jax.random.PRNGKey(2)})
        return out.loss, out

    (_, want), want_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    want_grads = grads_from_jax(jax.device_get(want_grads))
    tm = load_jax_params(tr.EncoderDecoderRetrievalModel(
        tr.RetrievalConfig(**FIELDS, t5_dropout=0.0, t5_remat=True), device="cpu"), params)
    before = t5_attention.launches
    got = tm(_tbatch(b), training=True)
    got.loss.backward()
    assert t5_attention.launches == before  # CPU tensors take the plain versions
    np.testing.assert_allclose(got.loss.item(), float(want.loss), rtol=1e-5)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(), atol=2e-5, rtol=1e-3, err_msg=name)
