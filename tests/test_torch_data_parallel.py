"""The port's data-parallel training steps on 2 real processes over gloo
(tests/torch_dist_worker.py, launched once for the module), held against the
JAX package's mesh steps and against one process of the port.

- Stage 2: `make_decoder_train_step(..., replicas)` on 2 ranks of 4 rows
  against rqvae_tpu's `make_decoder_train_step` over a 2-device mesh (the
  same params through `state_dict_from_jax`, the same 3 batches, dropout 0.1
  with the same site seeds: the JAX sites' `dropout_seed` is fed the port's
  seed row in call order, which is the port's site order). f32: losses rtol
  1e-5, parameters after 3 clipped AdamW updates atol 1e-4 (as
  tests/test_torch_decoder_steps.py holds one process). Against one process
  of the port: losses rtol 2e-6 (tests/test_multiprocess.py's bound: the sums
  are taken in another order), parameters atol 1e-6. The two ranks are
  bit-equal.
- The shard_map step (tests/test_shardmap_step.py:48-98): without dropout it
  equals the one-process step (loss rtol 1e-5, parameters atol 1e-5); with
  dropout each rank's seeds are its own and its masks are not the global
  batch's.
- Stage 1 (tests/test_parallel.py:38-91): STE on 2 ranks (2 micro-batches of
  2 x 8 rows, batch axis 1) against rqvae_tpu's `make_rqvae_train_step` on a
  2-device mesh, loss rel 1e-5, parameters atol 2e-5, p_unique_ids equal;
  Gumbel mode on 2 ranks against one process of the port (losses rtol 2e-6,
  p_unique_ids over the gathered ids equal).
"""

import itertools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rqvae_tpu.data.schemas import TokenizedSeqBatch as JBatch
from rqvae_tpu.models import retrieval as jr
from rqvae_tpu.models.quantize import QuantizeForwardMode as JMode
from rqvae_tpu.models.rqvae import RqVae as JRqVae, RqVaeConfig as JRqVaeConfig
from rqvae_tpu.ops import hash_dropout as jhash
from rqvae_tpu.ops import schedules as jsched
from rqvae_tpu.parallel.mesh import batch_sharding, make_mesh, replicate_pytree
from rqvae_tpu.train import decoder_steps as jsteps
from rqvae_tpu.train import rqvae_steps as jrq
from rqvae_tpu.train import state as jstate

from rqvae_tpu_torch.data.schemas import TokenizedSeqBatch
from rqvae_tpu_torch.models import retrieval as tr
from rqvae_tpu_torch.models.quantize import QuantizeForwardMode
from rqvae_tpu_torch.models.rqvae import RqVae, RqVaeConfig
from rqvae_tpu_torch.models.t5 import DropoutSeeds
from rqvae_tpu_torch.ops import schedules as tsched
from rqvae_tpu_torch.train import decoder_steps as tsteps
from rqvae_tpu_torch.train.rqvae_steps import make_rqvae_train_step
from rqvae_tpu_torch.train.state import adamw
from rqvae_tpu_torch.utils.convert import grads_from_jax, load_jax_params
from torch_dist_worker import launch

L, K, B, STEPS = 3, 8, 8, 3
FIELDS = dict(num_hierarchies=L, codebook_size=K, t5_d_model=32, t5_d_kv=8, t5_num_heads=4, t5_d_ff=64,
              t5_num_layers=2, top_k_for_generation=5, num_user_bins=7)
OPT = dict(lr=1e-3, warmup=100, wd=0.01, max_grad_norm=1.0)
RQ_FIELDS = dict(input_dim=24, embed_dim=8, hidden_dims=(16,), codebook_size=16, n_layers=3, n_cat_feats=0)
RQ_OPT = dict(lr=1e-3, wd=0.01)
A, RQ_B = 2, 16


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed, n_items=6):
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


def _jax_decoder(dropout):
    jm = jr.EncoderDecoderRetrievalModel(jr.RetrievalConfig(**FIELDS, t5_dropout=dropout))
    rngs = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}
    b = JBatch(**{k: jnp.asarray(v) for k, v in _batch(0).items()})
    return jm, jax.device_get(jax.jit(lambda r: jm.init(r, b, training=True))(rngs))


def _port_decoder(params, dropout):
    return load_jax_params(tr.EncoderDecoderRetrievalModel(tr.RetrievalConfig(**FIELDS, t5_dropout=dropout),
                                                           device="cpu"), params)


def _port_opt(model, opt):
    return adamw(model.parameters(), tsched.inverse_sqrt_schedule(opt["lr"], opt["warmup"]), weight_decay=opt["wd"],
                 max_grad_norm=opt["max_grad_norm"])


def _jax_rqvae(mode):
    jm = JRqVae(JRqVaeConfig(**RQ_FIELDS, codebook_mode=mode))
    x0 = jnp.asarray(np.random.RandomState(0).randn(RQ_B, 24).astype(np.float32))
    return jm, jax.device_get(jm.init({"params": jax.random.PRNGKey(0), "gumbel": jax.random.PRNGKey(1)}, x0, 0.2,
                                      training=True))


def _rq_xs():
    r = np.random.RandomState(4)
    return [r.randn(A, RQ_B, 24).astype(np.float32) for _ in range(STEPS)]


@pytest.fixture(scope="module")
def inputs():
    jm, params = _jax_decoder(0.1)
    model = _port_decoder(params, 0.1)
    seeds = DropoutSeeds.draw(torch.Generator().manual_seed(7), 1, model.n_dropout_sites)[0]
    _, rq_params = _jax_rqvae(JMode.STE)
    return dict(jm=jm, params=params, seeds=seeds, n_sites=model.n_dropout_sites,
                batches=[_batch(10 + i) for i in range(STEPS)], rq_params=rq_params)


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """Every scenario's result on each of the 2 ranks (one launch)."""
    root = tmp_path_factory.mktemp("dp")
    sd = str(root / "decoder.pt")
    torch.save(_port_decoder(inputs["params"], 0.1).state_dict(), sd)
    batches = [{k: torch.from_numpy(v) for k, v in b.items()} for b in inputs["batches"]]
    torch.save({"batches": batches, "seeds": [inputs["seeds"]] * STEPS}, str(root / "drop.pt"))
    torch.save({"batches": batches[:1], "seeds": None}, str(root / "nodrop.pt"))
    rq = load_jax_params(RqVae(RqVaeConfig(**RQ_FIELDS, codebook_mode=QuantizeForwardMode.STE), device="cpu"),
                         inputs["rq_params"])
    torch.save(rq.state_dict(), str(root / "rq.pt"))
    torch.save([torch.from_numpy(x) for x in _rq_xs()], str(root / "x.pt"))
    dec = dict(kind="decoder_step", state_dict=sd, opt=OPT)
    rq_sc = dict(kind="rqvae_step", state_dict=str(root / "rq.pt"), x=str(root / "x.pt"), opt=RQ_OPT, gen_seed=3,
                 gumbel_t=0.2)
    spec = {"out": str(root), "scenarios": [
        dict(dec, name="dp", config={**FIELDS, "t5_dropout": 0.1}, batches=str(root / "drop.pt")),
        dict(dec, name="sm_nodrop", config={**FIELDS, "t5_dropout": 0.0}, batches=str(root / "nodrop.pt"),
             shardmap=True),
        dict(dec, name="sm_drop", config={**FIELDS, "t5_dropout": 0.1}, batches=str(root / "drop.pt"),
             shardmap=True),
        dict(rq_sc, name="rq_ste", config={**RQ_FIELDS, "codebook_mode": "STE"}),
        dict(rq_sc, name="rq_gumbel", config={**RQ_FIELDS, "codebook_mode": "GUMBEL_SOFTMAX"}),
    ]}
    with open(root / "spec.json", "w") as f:
        json.dump(spec, f)
    lines = launch(2, str(root / "spec.json"), timeout=240)
    assert [(l["rank"], l["world"], l["backend"]) for l in lines] == [(0, 2, "gloo"), (1, 2, "gloo")]
    return {sc["name"]: [torch.load(root / f"{sc['name']}.rank{r}.pt") for r in range(2)]
            for sc in spec["scenarios"]}


def _bit_equal(a, b):
    for x, y in zip(a["metrics"], b["metrics"]):
        assert all(torch.equal(x[k], y[k]) for k in x)
    assert all(torch.equal(a["params"][k], b["params"][k]) for k in a["params"])


def _one_process(params, batches, seeds, dropout):
    model = _port_decoder(params, dropout)
    opt = _port_opt(model, OPT)
    step = tsteps.make_decoder_train_step(model, opt)
    metrics = [step(_tbatch(b), seeds=seeds) for b in batches]
    return metrics, model


def test_stage2_ranks_equal_the_jax_mesh_step(inputs, ranks):
    _bit_equal(*ranks["dp"])
    got = ranks["dp"][0]
    n_sites = inputs["n_sites"]
    calls = itertools.count()
    # the JAX sites draw their seeds in the port's site order: feed them the port's row
    fed = lambda rng: jnp.int32(int(inputs["seeds"][next(calls) % n_sites]))
    tx = jstate.adamw(jsched.inverse_sqrt_schedule(OPT["lr"], OPT["warmup"]), weight_decay=OPT["wd"],
                      max_grad_norm=OPT["max_grad_norm"])
    mesh = make_mesh(n_data=2, n_model=1, devices=jax.devices()[:2])
    state = replicate_pytree(mesh, jstate.TrainState.create(jax.tree_util.tree_map(jnp.asarray, inputs["params"]),
                                                            tx))
    step = jsteps.make_decoder_train_step(inputs["jm"], tx)
    sh = batch_sharding(mesh, batch_axis=0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jhash, "dropout_seed", fed)
        for i, b in enumerate(inputs["batches"]):
            jb = JBatch(**{k: jax.device_put(v, sh) for k, v in b.items()})
            state, jm = step(state, jb, jax.random.PRNGKey(i))
            np.testing.assert_allclose(got["metrics"][i]["total_loss"].item(), float(jm["total_loss"]), rtol=1e-5)
            np.testing.assert_allclose(got["metrics"][i]["loss_d"].numpy(), np.asarray(jm["loss_d"]), rtol=1e-5)
            for k in tsteps.SEQ_LENGTH_KEYS:  # quantiles over the global batch, not a mean of the ranks'
                assert got["metrics"][i][k].item() == pytest.approx(float(jm[k]), rel=1e-6), k
    assert next(calls) == n_sites  # one trace, every site fed once
    want = grads_from_jax(jax.device_get(state.params))
    for name, p in got["params"].items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=1e-4, rtol=0, err_msg=name)


def test_stage2_two_ranks_equal_one(inputs, ranks):
    metrics, model = _one_process(inputs["params"], inputs["batches"], inputs["seeds"], 0.1)
    got = ranks["dp"][1]
    np.testing.assert_allclose([m["total_loss"].item() for m in got["metrics"]],
                               [m["total_loss"].item() for m in metrics], rtol=2e-6)
    for k in tsteps.SEQ_LENGTH_KEYS:
        assert [m[k].item() for m in got["metrics"]] == [m[k].item() for m in metrics]
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(got["params"][name].numpy(), p.numpy(), atol=1e-6, rtol=0, err_msg=name)


def test_shardmap_step_without_dropout_equals_the_one_process_step(inputs, ranks):
    _bit_equal(*ranks["sm_nodrop"])
    metrics, model = _one_process(inputs["params"], inputs["batches"][:1], None, 0.0)
    got = ranks["sm_nodrop"][0]
    np.testing.assert_allclose(got["metrics"][0]["total_loss"].item(), metrics[0]["total_loss"].item(), rtol=1e-5)
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(got["params"][name].numpy(), p.numpy(), atol=1e-5, rtol=0, err_msg=name)


def test_shardmap_step_draws_its_own_masks_per_rank(ranks):
    a, b = ranks["sm_drop"]
    _bit_equal(a, b)
    assert bool((a["seed_rows"][0] != b["seed_rows"][0]).all())  # each rank's seeds are its own
    assert all(np.isfinite(m["total_loss"].item()) for m in a["metrics"])
    dp = ranks["dp"][0]  # the same seed row, but global masks: other losses
    assert all(x["total_loss"].item() != y["total_loss"].item() for x, y in zip(a["metrics"], dp["metrics"]))


def test_stage1_ranks_equal_the_jax_mesh_step(inputs, ranks):
    _bit_equal(*ranks["rq_ste"])
    got = ranks["rq_ste"][0]
    jm = JRqVae(JRqVaeConfig(**RQ_FIELDS, codebook_mode=JMode.STE))
    tx = jstate.adamw(RQ_OPT["lr"], weight_decay=RQ_OPT["wd"])
    step = jrq.make_rqvae_train_step(jm, tx)
    mesh = make_mesh(n_data=2, n_model=1, devices=jax.devices()[:2])
    state = replicate_pytree(mesh, jstate.TrainState.create(jax.tree_util.tree_map(jnp.asarray, inputs["rq_params"]),
                                                            tx))
    for i, x in enumerate(_rq_xs()):
        xs = jax.device_put(x, batch_sharding(mesh, batch_axis=1))
        state, jmet = step(state, xs, jax.random.PRNGKey(i), jnp.float32(0.2))
        assert got["metrics"][i]["total_loss"].item() == pytest.approx(float(jmet["total_loss"]), rel=1e-5)
        assert got["metrics"][i]["p_unique_ids"].item() == pytest.approx(float(jmet["p_unique_ids"]), abs=1e-7)
    want = grads_from_jax(jax.device_get(state.params))
    for name, p in got["params"].items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=2e-5, rtol=0, err_msg=name)


@pytest.mark.parametrize("name,mode", [("rq_ste", QuantizeForwardMode.STE),
                                       ("rq_gumbel", QuantizeForwardMode.GUMBEL_SOFTMAX)])
def test_stage1_two_ranks_equal_one(inputs, ranks, name, mode):
    _bit_equal(*ranks[name])
    model = load_jax_params(RqVae(RqVaeConfig(**RQ_FIELDS, codebook_mode=mode), device="cpu"), inputs["rq_params"])
    opt = adamw(model.parameters(), RQ_OPT["lr"], weight_decay=RQ_OPT["wd"])
    step = make_rqvae_train_step(model, opt)
    got = ranks[name][1]
    for i, x in enumerate(_rq_xs()):
        m = step(torch.from_numpy(x), torch.Generator().manual_seed(3 + i), 0.2)
        np.testing.assert_allclose(got["metrics"][i]["total_loss"].item(), m["total_loss"].item(), rtol=2e-6)
        np.testing.assert_allclose(got["metrics"][i]["emb_norms"].numpy(), m["emb_norms"].numpy(), rtol=2e-6)
        assert got["metrics"][i]["p_unique_ids"].item() == m["p_unique_ids"].item()  # one share over all rows
    for k, p in model.state_dict().items():
        np.testing.assert_allclose(got["params"][k].numpy(), p.numpy(), atol=1e-6, rtol=0, err_msg=k)
