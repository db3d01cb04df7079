"""The plain reference against rqvae_tpu_torch's CPU path at tiny sizes, in
float32, where the two must agree to rounding: the keep bits, the index, a
training step and three AdamW steps, and constrained beam search with the
inverse lookup. (The tests may import the program; the reference may not.)"""

import time
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench.harness import cell, registry, serving, weights
from perfbench.reference import hashing
from perfbench.reference import rqvae as rq_ref
from perfbench.reference.precision import Precision

REPO_ROOT = Path(__file__).resolve().parents[2]
TINY_RQ = {"input_dim": 32, "hidden_dims": [16, 8], "embed_dim": 8, "codebook_size": 16, "n_layers": 3,
           "n_cat_feats": 0, "codebook_mode": "STE"}
TINY_T5 = {"d_model": 64, "num_heads": 2, "d_kv": 32, "d_ff": 128, "num_layers": 2, "dropout": 0.1,
           "dtype": "float32", "top_k": 4, "rel_buckets": 32, "rel_max_distance": 128, "layer_norm_eps": 1e-6}
TINY_TRAIN = {"batch_size": 16, "learning_rate": 1e-3, "weight_decay": 1e-4, "warmup_steps": 10000, "iterations": 8,
              "log_every": 4, "save_model_every": 8, "partial_eval_every": 8, "full_eval_every": 8, "max_seq_len": 5}
TINY_LIMITS = {"loss_gap": 1.0, "grad_norm_gap": 1.0, "update_norm_gap": 1.0, "index_ids_differ": 1.0,
               "beam_choice_gap": 1.0, "beam_tuple_bad": 0.0, "beam_logp_gap": 1.0, "item_lookup_wrong": 0.0}


def tiny(rq=None, t5=None, train=None, traffic=None):
    """Overrides for a cell at a size a CPU test holds."""
    tr = {"driver": "train", "rows": 200, "length_base": 5, "length_extra_mean": 3.0, "length_sigma": 0.8,
          "length_max": 8, "max_items": 6, "item_buckets": [4, 6], "batch_buckets": [1, 4, 16], "rate": 40.0,
          "max_delay_ms": 5.0, "max_in_flight": 4, "trace_seconds": 0.5, "trace_from": 0.3, "trace_to": 0.6,
          "call_users": 32}
    return {"config": {"name": "tiny", "rqvae": {**TINY_RQ, **(rq or {})}, "t5": {**TINY_T5, **(t5 or {})},
                       "train": {**TINY_TRAIN, **(train or {})},
                       "data": {"users": 200, "items": 100, "interactions": 1000}},
            "traffic": {**tr, **(traffic or {})}, "limits": dict(TINY_LIMITS)}


def tiny_ctx(seed=2**31 + 5, **kw):
    torch.set_num_threads(2)
    return cell.context("amazon-beauty.train", seed, 0.2, False, "cpu", time.time(), tiny(**kw))


# ---- keep bits ----

@pytest.mark.parametrize("seed", [0, 12345, 2**31 - 1, -7, -(2**31)])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_keep_bits_equal_the_programs(seed, rate):
    from rqvae_tpu_torch.ops.hash_dropout import attention_keep_mask, keep_mask

    want = keep_mask(torch.tensor([seed], dtype=torch.int32), (3, 5, 7), rate)
    assert torch.equal(hashing.keep_mask((3, 5, 7), seed, rate, "cpu"), want)
    att = attention_keep_mask(torch.tensor([seed], dtype=torch.int32), 3, 2, 5, 6, rate)
    assert torch.equal(hashing.keep_mask((3, 2, 5, 6), seed, rate, "cpu"), att)


# ---- the index ----

@pytest.mark.parametrize("mode,n_cat", [("STE", 0), ("ROTATION_TRICK", 4)])
def test_index_equals_the_tokenizers(mode, n_cat):
    from rqvae_tpu_torch.models.quantize import QuantizeForwardMode
    from rqvae_tpu_torch.models.rqvae import RqVae, RqVaeConfig
    from rqvae_tpu_torch.tokenizer.semids import SemanticIdTokenizer

    rq = {**TINY_RQ, "codebook_mode": mode, "n_cat_feats": n_cat}
    x = weights.item_features(rq, 300, 11, "cpu")
    w = weights.rqvae_weights(rq, x, 11)
    model = RqVae(RqVaeConfig(input_dim=32, embed_dim=8, hidden_dims=(16, 8), codebook_size=16, n_layers=3,
                              n_cat_feats=n_cat, codebook_mode=QuantizeForwardMode[mode]), device="cpu")
    model.load_state_dict(w)
    got = SemanticIdTokenizer(model, device="cpu").precompute_corpus_ids(x)
    want = rq_ref.corpus_ids(w, x, Precision("f32"))
    assert torch.equal(got.long(), want)
    assert int(want[:, 3].max()) > 0  # the tiny corpus has duplicate tuples: the dedup column is exercised


# ---- training ----

@pytest.mark.parametrize("over", [
    {},  # Le = 20: the attention kernels' route (their plain versions on the CPU)
    {"train": {"max_seq_len": 3}},  # Le = 12: plain attention in the encoder too
    {"rq": {"codebook_mode": "ROTATION_TRICK", "n_cat_feats": 4}},
])
def test_training_steps_equal_the_programs(over):
    drv = registry.module("drivers", "train")
    ctx = tiny_ctx(**over)
    prog, got = drv.setup(ctx)
    del prog
    ref = drv.reference_steps(ctx, got["draws"], got["table"])
    n = drv.compare(got, ref, 3)
    assert n["loss_gap"] < 1e-5 and n["grad_norm_gap"] < 1e-5
    assert n["update_norm_gap"] < 1e-4  # Adam's first steps are about lr x sign(g): a sign near 0 moves a bit
    assert n["index_ids_differ"] == 0.0


def test_adamw_equals_the_programs():
    from rqvae_tpu_torch.train.state import adamw

    from perfbench.reference.train import AdamW

    g = torch.Generator().manual_seed(3)
    p0 = [torch.randn(4, 5, generator=g), torch.randn(7, generator=g)]
    grads = [[torch.randn_like(p) for p in p0] for _ in range(3)]
    mine = [p.clone() for p in p0]
    ref = AdamW(mine, 1e-3, 1e-4)
    theirs = [torch.nn.Parameter(p.clone()) for p in p0]
    opt = adamw(theirs, 1e-3, weight_decay=1e-4)
    for gs in grads:
        ref.step(gs)
        for p, gr in zip(theirs, gs):
            p.grad = gr.clone()
        opt.step()
    for a, b in zip(mine, theirs):
        torch.testing.assert_close(a, b.detach(), rtol=1e-6, atol=1e-7)


# ---- serving ----

@pytest.mark.parametrize("kind", ["serve_poisson", "batch_retrieve"])
def test_beam_search_equals_the_programs(kind):
    ctx = tiny_ctx(traffic={"driver": kind})
    drv = registry.module("drivers", kind)
    if kind == "serve_poisson":
        prog = drv.setup(ctx)
        hists = serving.requests(ctx, 48)
    else:
        prog, hists = drv.setup(ctx)
        hists = hists[:48]
    res = prog.engine.retrieve_many(hists, list(range(len(hists))))
    table = prog.cached_ids
    ref = serving.reference_answers(ctx, table.long(), hists, "f32")
    assert np.array_equal(ref["sem_ids"], res.sem_ids)
    assert np.array_equal(ref["item_ids"], res.item_ids)
    np.testing.assert_allclose(ref["log_probas"], res.log_probas, rtol=1e-5, atol=1e-4)
    served = {"sem_ids": res.sem_ids, "log_probas": res.log_probas, "item_ids": res.item_ids}
    n = serving.compare(ctx, table.cpu().numpy(), hists, served)
    assert n["index_ids_differ"] == 0.0 and n["item_lookup_wrong"] == 0.0 and n["beam_logp_gap"] < 1e-4
    assert n["beam_tuple_bad"] == 0.0 and n["beam_choice_gap"] < 1e-4
