"""The port's paths driven end to end on the card: the build, serving as it is
deployed, both trainers and their features, and the raw-file pipelines.

Run on a machine with an NVIDIA card and nvcc, with the kernel tests:
    python -m pytest --noconftest -m gpu -q tests/test_torch_kernels_gpu.py tests/test_torch_paths_gpu.py
Without a card every test here skips (the check is in the fixture). The file
imports torch and the port only, so it runs where JAX is missing.

Each test zeroes the kernel wrappers' launch counters first and asserts the
launches its path makes. A CUDA graph's capture ticks them twice for what it
records (its eager run and the recording itself); a replay ticks nothing.
Widths are the published ones (configs/*.gin); user and item counts and
iterations are cut to what still reaches every launch asserted.
"""

import dataclasses
import functools
import gc
import gzip
import json
import os

import numpy as np
import pytest
import torch

from rqvae_tpu_torch.data.registry import RecDataset
from rqvae_tpu_torch.models.retrieval import EncoderDecoderRetrievalModel
from rqvae_tpu_torch.models.rqvae import RqVae
from rqvae_tpu_torch.ops.cuda.attention import t5_attention
from rqvae_tpu_torch.ops.cuda.decoder_stack import t5_decoder_stack_infer
from rqvae_tpu_torch.ops.cuda.encoder_stack import t5_encoder_stack_infer
from rqvae_tpu_torch.ops.cuda.hash_dropout import hash_dropout_cuda
from rqvae_tpu_torch.ops.cuda.rq_encode import fused_encode_quantize
from rqvae_tpu_torch.serving.retriever import Retriever
from rqvae_tpu_torch.tokenizer.semids import SemanticIdTokenizer
from rqvae_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from rqvae_tpu_torch.utils.config import apply_config
from torch_gpu_common import cuda  # noqa: F401 (the fixture)
from torch_gpu_common import (AMAZON, ML32M, T5, gin_rqvae, item_corpus, make_rqvae, retrieval_model, seed_codebooks,
                              write_training_inputs)

pytestmark = pytest.mark.gpu

GEOS = {"amazon": AMAZON, "ml32m": ML32M}
BATCH = 64  # serving queries a call
CALLS = 3
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "jax_synthetic")


# ---- launch counts ----

WRAPPERS = {"rq_encode": fused_encode_quantize, "decoder_stack": t5_decoder_stack_infer,
            "encoder_stack": t5_encoder_stack_infer, "attention": t5_attention, "hash_dropout": hash_dropout_cuda}


def zero_launches():
    for fn in WRAPPERS.values():
        fn.launches = 0
    t5_attention.backward_launches = 0


def launches():
    """Each kernel wrapper's launches since zero_launches; kernel 4's backward as attention_bwd."""
    return {**{name: fn.launches for name, fn in WRAPPERS.items()}, "attention_bwd": t5_attention.backward_launches}


# ---- data and weights from seeds ----

def histories(n_items, length, seed):
    """BATCH histories of `length` item ids, each 1..length long, -1 padded."""
    r = np.random.RandomState(seed)
    ids = r.randint(0, n_items, (BATCH, length))
    lengths = r.randint(1, length + 1, BATCH)
    return np.where(np.arange(length)[None, :] < lengths[:, None], ids, -1).astype(np.int32)


def train_kwargs(geo, folder, rq_ckpt):
    """configs/decoder_amazon.gin's and decoder_ml32m.gin's stage-2 settings."""
    return dict(batch_size=geo["batch"], learning_rate=1e-3, weight_decay=1e-4, dataset_folder=folder,
                dataset=RecDataset.SYNTHETIC, pretrained_rqvae_path=rq_ckpt, vae_input_dim=geo["input_dim"],
                vae_embed_dim=geo["embed_dim"], vae_hidden_dims=[512, 256, 128], vae_codebook_size=256,
                vae_n_cat_feats=0, vae_n_layers=3, top_k_for_generation=10, should_add_sep_token=True,
                t5_dropout=0.1, t5_dtype="bfloat16", warmup_steps=10000, seed=0,
                **{k: v for k, v in T5.items() if k != "t5_d_kv"})


def write_item_dataset(root, x, seed):
    """The processed dataset file the stage-1 trainer reads: the corpus rows
    and a seeded 95/5 train/eval item split. Returns the dataset folder."""
    r = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "processed"))
    np.savez(os.path.join(root, "processed", "data.npz"), item_features=x.numpy(),
             item_is_train=r.rand(x.shape[0]) > 0.05, dataset_name=np.asarray("synthetic"))
    return root


def read_log(save_dir):
    with open(os.path.join(save_dir, "logs", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def check_summary(summary):
    assert np.isfinite(summary["total_loss"]), summary
    assert all(0.0 <= summary[k] <= 1.0 for k in ("h@1", "h@5", "h@10", "ndcg")), summary
    assert summary["checkpoint_path"] is not None


# ---- the build ----

def spills(log):
    """(entry function, spill store bytes, spill load bytes) of each kernel in
    an `nvcc -Xptxas -v` log."""
    rows, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill stores" in line and name:
            words = line.split()
            rows.append((name, int(words[words.index("spill") - 2]), int(words[-4])))
    return rows


def test_tensor_core_kernels_spill_nothing(cuda):
    """_build.build_all builds the six libraries and keeps each one's ptxas
    log; the tensor-core kernels of kernels 1-3 spill no register."""
    from rqvae_tpu_torch.ops.cuda import _build

    logs = _build.build_all()
    assert {"rq_encode", "decoder_stack", "encoder_stack", "attention", "attention_bwd", "hash_dropout"} <= set(logs)
    for name in ("rq_encode", "decoder_stack", "encoder_stack"):
        tc = [row for row in spills(logs[name]) if "tc_kernel" in row[0]]
        assert tc and all(stores == loads == 0 for _, stores, loads in tc), (name, tc)


# ---- serving ----

def check_results(results, cached):
    """Shapes, finite sorted log-probs, corpus-valid beams, repeated calls equal."""
    first = results[0].sem_ids.cpu()
    for out in results:
        items, sem, logp = out.item_ids.cpu(), out.sem_ids.cpu(), out.log_probas.cpu()
        assert items.shape == (BATCH, 10) and sem.shape == (BATCH, 10, 3)
        assert torch.isfinite(logp).all() and (logp[:, 1:] <= logp[:, :-1]).all()
        valid = items >= 0
        assert valid.any() and (cached[items[valid], :3] == sem[valid]).all()
        assert torch.equal(logp > -1e8, valid)
        assert torch.equal(first, sem)


def route_agreement(a, b):
    """Shares of queries with all beams equal and with the first beam equal,
    and the mean share of a query's beams that the other result returns too."""
    ia, ib = a.sem_ids.cpu(), b.sem_ids.cpu()
    in_b = (ia[:, :, None, :] == ib[:, None, :, :]).all(3).any(2)
    return ((ia == ib).all(2).all(1).float().mean().item(), (ia[:, 0] == ib[:, 0]).all(1).float().mean().item(),
            in_b.float().mean().item())


def jax_checkpoints(root, rq, model):
    """The weights as the JAX package's checkpoint files."""
    from rqvae_tpu_torch.utils.convert import jax_params_from_state_dict

    return (save_checkpoint(os.path.join(root, "rqvae"), 0, jax_params_from_state_dict(rq), config=rq.config,
                            fmt="msgpack"),
            save_checkpoint(os.path.join(root, "decoder"), 0, jax_params_from_state_dict(model), config=model.config,
                            fmt="msgpack"))


def with_config(model, **over):
    """The model's weights under a config with `over` replaced."""
    dev = next(model.parameters()).device
    other = EncoderDecoderRetrievalModel(dataclasses.replace(model.config, **over), device=dev)
    other.load_state_dict(model.state_dict())
    return other


@pytest.mark.parametrize("geo", list(GEOS))
def test_serving_main_path(cuda, tmp_path, geo):
    """Serving as deployed at a published width, bf16: seeded weights written
    as the JAX package's checkpoint files; a first Retriever.from_checkpoints
    start builds and saves the index (kernel 1 once), a second loads it
    (kernel 1 no time); 3 retrieve() calls of 64 histories: corpus-valid
    beams, sorted finite log-probs, repeated calls equal. Amazon (Le 80):
    kernel 2 three times a call. ML-32M (Le 800): kernel 3 once a call,
    kernels 2 and 4 never (the plain decoder); with t5_fused_encode="off"
    kernel 4 four times a call. The two encoder routes compute one function
    in another summation order: in f32 all 10 beams equal on >= 95% of the
    queries; in bf16, where a flipped rounding trades beams near a tie, the
    first beam equal on >= 80% and >= 90% of the beams shared."""
    g = GEOS[geo]
    rq, x = make_rqvae(g, cuda)
    paths = jax_checkpoints(str(tmp_path), rq, retrieval_model("bfloat16", cuda))
    index = str(tmp_path / "index.npz")
    for built in (1, 0):
        zero_launches()
        r = Retriever.from_checkpoints(*paths, x.numpy(), index_path=index, device=cuda)
        assert launches()["rq_encode"] == built
    hist = histories(x.shape[0], g["history"], seed={"amazon": 3, "ml32m": 7}[geo])
    zero_launches()
    results = [r.retrieve(hist) for _ in range(CALLS)]
    got = launches()
    kernel2, kernel3 = (CALLS * 3, 0) if geo == "amazon" else (0, CALLS)
    assert (got["decoder_stack"], got["encoder_stack"], got["attention"]) == (kernel2, kernel3, 0), got
    cached = r.tokenizer.cached_ids.cpu()
    check_results(results, cached)
    if geo == "amazon":
        return
    off = Retriever(with_config(r.model, t5_fused_encode="off"), r.tokenizer, device=cuda)
    zero_launches()
    results_off = [off.retrieve(hist) for _ in range(CALLS)]
    got = launches()
    assert (got["attention"], got["encoder_stack"], got["decoder_stack"]) == (4 * CALLS, 0, 0), got
    check_results(results_off, cached)
    _, top1, overlap = route_agreement(results[-1], results_off[-1])
    assert top1 >= 0.8 and overlap >= 0.9, (top1, overlap)
    f32 = [Retriever(with_config(r.model, t5_dtype="float32", **kw), r.tokenizer, device=cuda).retrieve(hist)
           for kw in ({}, {"t5_fused_encode": "off"})]
    assert route_agreement(*f32)[0] >= 0.95


def fixture_inputs():
    with np.load(os.path.join(FIXTURE, "inputs_and_results.npz")) as z:
        return {k: z[k] for k in z.files}


FIXTURE_CHECKPOINTS = (os.path.join(FIXTURE, "rqvae", "checkpoint_299.msgpack"),
                       os.path.join(FIXTURE, "decoder", "checkpoint_400.msgpack"))


def test_checkpoint_interop(cuda):
    """The committed checkpoints that flax wrote (tests/fixtures/jax_synthetic/)
    served on the card in f32 through from_checkpoints: item ids and beams
    equal to the JAX package's stored results, log-probas within 1e-4."""
    fx = fixture_inputs()
    r = Retriever.from_checkpoints(*FIXTURE_CHECKPOINTS, fx["item_features"], device=cuda, precision="f32")
    out = r.retrieve(fx["histories"])
    np.testing.assert_array_equal(out.item_ids.cpu().numpy(), fx["item_ids"])
    np.testing.assert_array_equal(out.sem_ids.cpu().numpy(), fx["sem_ids"])
    assert np.abs(out.log_probas.cpu().numpy() - fx["log_probas"]).max() <= 1e-4


def test_sampled_candidates_card_against_cpu(cuda):
    """sample_candidates=True over the fixture's weights in f32, card against
    CPU, both fed the same Gumbel noise: all beams equal on >= 95% of the
    queries; a valid beam maps to an item."""
    fx = fixture_inputs()
    out, noise = {}, None
    for name, device in (("card", cuda), ("cpu", "cpu")):
        base = Retriever.from_checkpoints(*FIXTURE_CHECKPOINTS, fx["item_features"], device=device, precision="f32")
        cfg = dataclasses.replace(base.model.config, sample_candidates=True, n_candidates=16)
        model = EncoderDecoderRetrievalModel(cfg, device=device)
        model.load_state_dict(base.model.state_dict())
        r = Retriever(model, base.tokenizer, device=device, seed=41)
        noise = r.draw_noise(fx["histories"].shape[0]) if noise is None else noise
        out[name] = r.retrieve(fx["histories"], noise=noise)
    card, host = out["card"], out["cpu"]
    assert (card.sem_ids.cpu() == host.sem_ids).all(2).all(1).float().mean().item() >= 0.95
    valid = card.log_probas.cpu() > -1e8
    assert valid.any() and (card.item_ids.cpu()[valid] >= 0).all()


def test_queue_over_the_amazon_engine(cuda):
    """An AsyncRetrievalEngine over the Amazon engine (bf16, its bucket
    graphs) at two offered rates: every future equals its flush's
    retrieve_many row, recomputed; past saturation, with a bounded queue and
    a deadline, the futures' rejects and sheds are the queue's counts."""
    import time

    from rqvae_tpu_torch.serving.engine import RetrievalEngine
    from rqvae_tpu_torch.serving.queue import AsyncRetrievalEngine, DeadlineExceededError, QueueOverloadedError

    rq, x = make_rqvae(AMAZON, cuda)
    tok = SemanticIdTokenizer(rq, device=cuda)
    tok.precompute_corpus_ids(x.to(cuda))
    eng = RetrievalEngine(Retriever(retrieval_model("bfloat16", cuda), tok, device=cuda), max_items=AMAZON["history"])
    eng.warmup()
    flushes, real = [], eng.retrieve_many_device

    def recording(hists, user_ids=None):
        flushes.append((list(hists), list(user_ids)))
        return real(hists, user_ids)

    eng.retrieve_many_device = recording
    rng = np.random.RandomState(31)

    def requests(count):
        return [rng.randint(0, x.shape[0], rng.randint(1, eng.max_items + 1)).astype(np.int32) for _ in range(count)]

    def offer(q, reqs, rate):
        t0, futs = time.perf_counter(), []
        for i, h in enumerate(reqs):
            if rate:
                time.sleep(max(0.0, t0 + i / rate - time.perf_counter()))
            futs.append((h, q.submit(h, i)))
        return futs

    for rate in (250.0, 1000.0):
        flushes.clear()
        with AsyncRetrievalEngine(eng, max_delay_ms=2.0) as q:
            futs = offer(q, requests(256), rate)
            results = {id(h): f.result(timeout=120) for h, f in futs}
        assert flushes
        for hists, uids in flushes:
            want = eng.finalize_many(len(hists), real(hists, uids))
            for j, h in enumerate(hists):
                assert all(np.array_equal(a, w[j]) for a, w in zip(results[id(h)], want))
    with AsyncRetrievalEngine(eng, max_delay_ms=2.0, max_queue_depth=256, deadline_ms=50.0) as q:
        outcome = {"served": 0, "rejected": 0, "shed": 0}
        for _, f in offer(q, requests(2048), None):
            try:
                f.result(timeout=120)
                outcome["served"] += 1
            except QueueOverloadedError:
                outcome["rejected"] += 1
            except DeadlineExceededError:
                outcome["shed"] += 1
    stats = q.stats()
    assert (outcome["rejected"], outcome["shed"]) == (stats["rejected"], stats["shed"]), (outcome, stats)


# ---- stage-2 training ----

@pytest.mark.parametrize("geo", list(GEOS))
def test_stage2_trainer(cuda, tmp_path, geo):
    """train_decoder.train at a published width, bf16, dropout 0.1, steps one
    by one (log_every=1), the full evaluation on one batch; kernels 4 and 5
    once a layer a micro-batch. Amazon (batch 640): 5 iterations with both
    evaluations, then a resumed iteration accumulating 2 micro-batches:
    kernels 4 and 5 4 x 7 times, kernel 2 three times an evaluation batch (2).
    ML-32M (batch 64, Le 800): 3 iterations, kernels 4 and 5 4 x 3 times,
    kernel 3 once (the evaluation batch), kernel 2 never. Finite losses,
    hits@k and NDCG in [0, 1]; the hash-dropout kernel the same count each
    micro-batch. Then the step the trainer is made of: every parameter gets a
    finite non-zero gradient on the first step and moves, and one seed gives
    one first-step loss."""
    from rqvae_tpu_torch.ops.schedules import inverse_sqrt_schedule
    from rqvae_tpu_torch.train.decoder_steps import make_decoder_fused_train_step
    from rqvae_tpu_torch.train.state import adamw
    from rqvae_tpu_torch.train.train_decoder import step_generator, step_rows, train

    g = GEOS[geo]
    rq, x = make_rqvae(g, cuda)
    folder, rq_ckpt, data = write_training_inputs(str(tmp_path), g, rq, x, seed=12)
    kw = dict(train_kwargs(g, folder, rq_ckpt), full_eval_max_batches=1, log_every=1, device=cuda)
    save = str(tmp_path / "dec")
    zero_launches()
    if geo == "amazon":
        first = train(iterations=5, save_dir_root=save, partial_eval_every=5, full_eval_every=5, **kw)
        resumed = train(iterations=1, save_dir_root=save, gradient_accumulate_every=2, auto_resume=True,
                        partial_eval_every=1000, full_eval_every=1000, **kw)
        micro, kernel2, kernel3 = 5 + 2, 3 * 2, 0
        assert np.isfinite(first["eval_loss"]) and resumed["checkpoint_path"].endswith("checkpoint_5.pt")
        summaries = (first, resumed)
    else:
        summaries = (train(iterations=3, save_dir_root=save, partial_eval_every=1000, full_eval_every=1000, **kw),)
        micro, kernel2, kernel3 = 3, 0, 1
    got = launches()
    assert (got["attention"], got["attention_bwd"], got["decoder_stack"], got["encoder_stack"]) == (
        4 * micro, 4 * micro, kernel2, kernel3), got
    assert got["rq_encode"] >= 1 and got["hash_dropout"] > 0 and got["hash_dropout"] % micro == 0, got
    for summary in summaries:
        check_summary(summary)

    cached = SemanticIdTokenizer(rq, device=cuda).precompute_corpus_ids(x.to(cuda))
    tables = [torch.as_tensor(data[k], device=cuda) for k in ("seq_items", "seq_lengths", "user_ids")] + [cached]
    rows = torch.as_tensor(step_rows(0, 0, g["users"], g["batch"])).to(cuda)
    losses = []
    for _ in range(2):
        model = retrieval_model("bfloat16", cuda, t5_dropout=0.1)
        opt = adamw(model.parameters(), inverse_sqrt_schedule(1e-3, 10000), weight_decay=1e-4)
        step = make_decoder_fused_train_step(model, opt, max_seq_len=g["history"], leave_two_out=True, subsample=True)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        losses.append(float(step(*tables, rows, step_generator(0, 0))["total_loss"]))
        for n, p in model.named_parameters():
            assert p.grad is not None and torch.isfinite(p.grad).all() and (p.grad != 0).any(), n
            assert not torch.equal(p.detach(), before[n]), n
    assert np.isfinite(losses[0]) and losses[0] == losses[1]


def test_remat_at_ml32m(cuda):
    """One ML-32M stage-2 step (batch 64, Le 800, bf16, dropout 0.1) with
    t5_remat=True against False, the same batch and seeds: the loss and every
    gradient bit-equal; kernel 4 runs 4 times without remat and 8 with it
    (each encoder layer's forward again in the backward), kernel 5 4 times,
    the hash-dropout kernel more often with remat."""
    from rqvae_tpu_torch.models.t5 import DropoutSeeds
    from rqvae_tpu_torch.train.decoder_steps import _make_micro_batch_fn
    from rqvae_tpu_torch.train.step_graph import step_generator, step_rows

    users, T, n_items = ML32M["users"], ML32M["history"] + 2, ML32M["items"]
    r = np.random.RandomState(22)
    lengths = r.randint(10, T + 1, users)
    seq_items = np.where(np.arange(T)[None, :] < lengths[:, None], r.randint(0, n_items, (users, T)), -1)
    cached = r.randint(0, 256, (n_items, 4)).astype(np.int32)
    cached[:, 3] = 0
    tables = [torch.as_tensor(a, device=cuda) for a in (seq_items, lengths, np.arange(users), cached)]
    g = step_generator(0, 0)
    rows = torch.as_tensor(step_rows(0, 0, users, ML32M["batch"]), device=cuda)
    u_start, u_end = (torch.rand(ML32M["batch"], generator=g).to(cuda) for _ in range(2))
    batch = _make_micro_batch_fn(ML32M["history"], True, True)(*tables, rows, u_start, u_end)
    out = {}
    for remat in (False, True):
        model = retrieval_model("bfloat16", cuda, t5_dropout=0.1, t5_remat=remat)
        seeds = DropoutSeeds.draw(torch.Generator().manual_seed(3), 1, model.n_dropout_sites)[0].to(cuda)
        zero_launches()
        res = model(batch, training=True, seeds=seeds)
        res.loss.backward()
        out[remat] = (res.loss.detach(), {n: p.grad for n, p in model.named_parameters()}, launches())
    (la, ga, ka), (lb, gb, kb) = out[False], out[True]
    assert torch.equal(la, lb) and all(torch.equal(ga[n], gb[n]) for n in ga)
    assert (ka["attention"], ka["attention_bwd"], kb["attention"], kb["attention_bwd"]) == (4, 4, 8, 4), (ka, kb)
    assert kb["hash_dropout"] > ka["hash_dropout"] > 0


# ---- the trainers as rqvae_tpu's are configured and resumed ----

def amp_against_float32(make, run, k, params0):
    """From one state, k steps through the step graph with amp, without it,
    and without it from the bf16-rounded parameters: the amp losses within
    rtol 2e-2 of the float32 route's (the stage-2 bf16 tests' tolerance), and
    its parameters (per tensor |p - p_f32| / |p_f32 - p_0|, the mean) no
    further from the float32 run's than 1.5 x the rounded start's run is:
    AdamW's first updates are lr x sign(g), so any bf16-sized perturbation
    flips the entries whose gradient lies below it. Returns the kernel
    launches of each route's capture."""
    runs, counted = {}, {}
    for name, amp in (("amp", True), ("f32", False), ("f32_bf16_start", False)):
        model, step = make(k, amp)
        if name == "f32_bf16_start":
            with torch.no_grad():
                for p in model.parameters():
                    p.copy_(p.to(torch.bfloat16).float())
        draws = [step.draws(0, s) for s in range(k)]
        zero_launches()
        losses = [float(run(step, [d])["total_loss"]) for d in draws]  # a chunk of one: one replay a step
        counted[name] = launches()
        assert step.chunks.replays == k
        runs[name] = (model, losses)

    def distance(a, b):
        ratios = []
        for (n, pa), pb in zip(a.named_parameters(), b.parameters()):
            moved = float((pb.detach() - params0[n]).norm())
            if moved > 0:
                ratios.append(float((pa.detach() - pb.detach()).norm()) / moved)
        return float(np.mean(ratios))

    (amp_model, amp_losses), (f32_model, f32_losses) = runs["amp"], runs["f32"]
    assert all(np.isfinite(amp_losses))
    assert max(abs(a - b) / abs(b) for a, b in zip(amp_losses, f32_losses)) <= 2e-2, (amp_losses, f32_losses)
    assert distance(amp_model, f32_model) <= 1.5 * distance(runs["f32_bf16_start"][0], f32_model)
    return counted


def test_amp_trainer(cuda, tmp_path):
    """amp=True (ops/amp.py: bf16 operands, float32 sums) at the Amazon
    widths, through the step graphs: stage 2 at decoder_amazon.gin's T5 in
    float32 (batch 640, Le 80, dropout 0.1, 4 steps) and stage 1 at
    configs/rqvae_amazon.gin (8 steps), each against the float32 route
    (amp_against_float32); kernels 4 and 5 take their float32 route (the
    CUDA cores) in both stage-2 graphs, a step's worth each in the capture.
    Then 20 amp=True steps of train_rqvae.train: finite losses, the
    evaluation's index build (kernel 1)."""
    import functools

    from rqvae_tpu_torch.ops.cuda.attention import attention_route
    from rqvae_tpu_torch.ops.schedules import inverse_sqrt_schedule
    from rqvae_tpu_torch.train import train_rqvae
    from rqvae_tpu_torch.train.decoder_steps import make_decoder_graph_train_step
    from rqvae_tpu_torch.train.rqvae_steps import make_rqvae_graph_train_step
    from rqvae_tpu_torch.train.state import adamw

    users, batch, T = AMAZON["users"], AMAZON["batch"], AMAZON["history"] + 2
    r = np.random.RandomState(23)
    lengths = r.randint(8, T + 1, users)
    seq_items = np.where(np.arange(T)[None, :] < lengths[:, None], r.randint(0, AMAZON["items"], (users, T)), -1)
    cached = r.randint(0, 256, (AMAZON["items"], 4)).astype(np.int32)
    cached[:, 3] = 0
    tables = [torch.as_tensor(a, device=cuda) for a in (seq_items, lengths, np.arange(users), cached)]

    def make2(n_steps, amp):
        model = retrieval_model("float32", cuda, t5_dropout=0.1)
        opt = adamw(model.parameters(), inverse_sqrt_schedule(1e-3, 10000), weight_decay=1e-4)
        step = make_decoder_graph_train_step(model, opt, max_seq_len=AMAZON["history"], n_steps=n_steps,
                                             batch_size=batch, amp=amp)
        step.draws = functools.partial(step.draws, n_rows=users)
        return model, step

    params0 = {n: p.detach().clone() for n, p in retrieval_model("float32", cuda).named_parameters()}
    counted = amp_against_float32(make2, lambda step, d: step(*tables, d), 4, params0)
    assert attention_route(80, 80, 64, torch.float32) == attention_route(80, 80, 64, torch.float32,
                                                                         backward=True) == "cuda_cores"
    for name in ("amp", "f32"):
        assert (counted[name]["attention"], counted[name]["attention_bwd"]) == (2 * 4, 2 * 4), counted

    gin = "configs/rqvae_amazon.gin"
    cfg, st = gin_rqvae(gin)
    corpus = item_corpus(AMAZON["items"], cfg, seed=15)
    xs = corpus.to(cuda)
    rq0 = RqVae(cfg, device=cuda, seed=5)
    seed_codebooks(rq0, xs, seed=6)

    def make1(n_steps, amp):
        model = RqVae(cfg, device=cuda)
        model.load_state_dict(rq0.state_dict())
        opt = adamw(model.parameters(), st["learning_rate"], weight_decay=st["weight_decay"])
        step = make_rqvae_graph_train_step(model, opt, n_steps=n_steps, accum=1, batch_size=st["batch_size"], amp=amp)
        step.draws = functools.partial(step.draws, n_items=xs.shape[0])
        return model, step

    amp_against_float32(make1, lambda step, d: step(xs, d), 8,
                        {n: p.detach().clone() for n, p in rq0.named_parameters()})

    folder = write_item_dataset(str(tmp_path / "data"), corpus, seed=13)
    zero_launches()
    s = apply_config(train_rqvae.train, gin, iterations=20, eval_every=20, save_model_every=20, log_every=10,
                     amp=True, dataset=RecDataset.SYNTHETIC, dataset_folder=folder,
                     save_dir_root=str(tmp_path / "rq"), device=cuda)
    assert np.isfinite(s["total_loss"]) and np.isfinite(s["eval_total_loss"]), s
    assert launches()["rq_encode"] >= 1


@pytest.mark.parametrize("stage", ["stage1", "stage2"])
def test_resume_from_the_jax_layout(cuda, tmp_path, stage):
    """A trainer at its shipped Amazon settings: N steps unbroken against N/2
    steps, the checkpoint rewritten as the JAX package's file (params and
    optax opt_state, utils/checkpoint.py::export_jax_checkpoint), and a new
    trainer resuming from that file for N/2 steps: step, count, parameters
    and both moments bit-equal. Stage 2: decoder_amazon.gin's widths in bf16,
    4 steps; stage 1: configs/rqvae_amazon.gin, 20 steps."""
    from rqvae_tpu_torch.train import train_rqvae
    from rqvae_tpu_torch.train.train_decoder import train
    from rqvae_tpu_torch.utils.checkpoint import export_jax_checkpoint

    root = str(tmp_path)
    if stage == "stage2":
        n, rq_x = 4, make_rqvae(AMAZON, cuda)
        folder, rq_ckpt, _ = write_training_inputs(os.path.join(root, "s2"), AMAZON, *rq_x, seed=12)
        kw = dict(train_kwargs(AMAZON, folder, rq_ckpt), partial_eval_every=1000, full_eval_every=1000,
                  full_eval_max_batches=1, save_model_every=1000, log_every=2, device=cuda)
        run = lambda save, **over: train(save_dir_root=os.path.join(root, save), **kw, **over)  # noqa: E731
        resume = "pretrained_decoder_path"
    else:
        n, gin = 20, "configs/rqvae_amazon.gin"
        corpus = item_corpus(AMAZON["items"], gin_rqvae(gin)[0], seed=15)
        folder = write_item_dataset(os.path.join(root, "s1"), corpus, seed=13)
        run = lambda save, **over: apply_config(  # noqa: E731
            train_rqvae.train, gin, dataset=RecDataset.SYNTHETIC, dataset_folder=folder, eval_every=10**6,
            save_model_every=10**6, log_every=n // 2, save_dir_root=os.path.join(root, save), device=cuda, **over)
        resume = "pretrained_rqvae_path"
    whole = run("whole", iterations=n)
    half = run("half", iterations=n // 2)
    jax_file = export_jax_checkpoint(half["checkpoint_path"], os.path.join(root, "jax"))
    rest = run("rest", iterations=n // 2, **{resume: jax_file})
    a, b = load_checkpoint(whole["checkpoint_path"]), load_checkpoint(rest["checkpoint_path"])
    assert a["step"] == b["step"] and a["opt_state"]["count"] == b["opt_state"]["count"]
    assert all(torch.equal(a["params"][k], b["params"][k]) for k in a["params"])
    assert all(torch.equal(u, v) for u, v in zip(a["opt_state"]["mu"] + a["opt_state"]["nu"],
                                                b["opt_state"]["mu"] + b["opt_state"]["nu"]))


def test_sampled_evaluation_and_hub_export(cuda, tmp_path, capsys, monkeypatch):
    """One stage-2 trainer run at the Amazon settings with
    sample_candidates=True and push_vae_to_hf=True (2 steps in one chunk of
    graph replays, the full evaluation once on one batch of 640): kernels 4
    and 5 a step's worth twice in the capture, kernel 2 three times in the
    evaluation; its beams, hits@k and NDCG equal those of a generate fed the
    same noise (the generator of (seed, 999)). The push fails without a
    network and says the local export is kept; utils/hub.py::from_pretrained
    on that export gives the trainer's RQ-VAE, whose bf16 index build
    (kernel 1 once) equals it ID for ID."""
    from rqvae_tpu_torch.data.datasets import SeqDataset
    from rqvae_tpu_torch.data.registry import ensure_dataset
    from rqvae_tpu_torch.ops.metrics import TopKAccumulator
    from rqvae_tpu_torch.serving.beam import build_prefix_table
    from rqvae_tpu_torch.train import train_decoder as TD
    from rqvae_tpu_torch.utils import hub

    rq, x = make_rqvae(AMAZON, cuda)
    folder, rq_ckpt, _ = write_training_inputs(str(tmp_path), AMAZON, rq, x, seed=12)
    kw = train_kwargs(AMAZON, folder, rq_ckpt)
    beams, steps, make_generate, make_step = [], [], TD.make_generate_fn, TD.make_decoder_graph_train_step

    def recording_generate_fn(model):  # the trainer's beams, recorded as they are
        generate = make_generate(model)

        def run(batch, table, noise=None):
            out = generate(batch, table, noise)
            beams.append(out.sem_ids.clone())
            return out
        return run

    def recording_step(*args, **kwargs):  # the trainer's step runner
        steps.append(make_step(*args, **kwargs))
        return steps[-1]

    monkeypatch.setattr(TD, "make_generate_fn", recording_generate_fn)
    monkeypatch.setattr(TD, "make_decoder_graph_train_step", recording_step)
    zero_launches()
    s = TD.train(iterations=2, sample_candidates=True, push_vae_to_hf=True, full_eval_every=2,
                 full_eval_max_batches=1, partial_eval_every=1000, save_model_every=1000, log_every=2,
                 save_dir_root=str(tmp_path / "dec"), device=cuda, **kw)
    monkeypatch.undo()
    got = launches()
    assert [st.chunks.replays for st in steps] == [2]
    assert (got["attention"], got["attention_bwd"], got["decoder_stack"]) == (2 * 4, 2 * 4, 3), got
    assert got["rq_encode"] >= 1
    check_summary(s)
    export = str(tmp_path / "dec" / "rqvae_export")
    hub_lines = [line for line in capsys.readouterr().out.splitlines() if line.startswith("[hub]")]
    assert len(hub_lines) == 1 and hub_lines[0].endswith(f"local export kept at {export}"), hub_lines

    restored = load_checkpoint(s["checkpoint_path"])
    cfg = restored["config"]
    assert cfg.sample_candidates and cfg.n_candidates < cfg.codebook_size
    model = EncoderDecoderRetrievalModel(cfg, device=cuda)
    model.load_state_dict(restored["params"])
    tokenizer = SemanticIdTokenizer(rq, device=cuda)
    cached = tokenizer.precompute_corpus_ids(x.to(cuda))
    eval_data = SeqDataset(ensure_dataset(folder, RecDataset.SYNTHETIC), split="test")
    eb, valid = next(iter(eval_data.iter_eval_batches(AMAZON["batch"], with_features=False)))
    tok = tokenizer(eb)
    noise = TD.eval_noise(model, tok, kw["seed"], 0)
    gen = TD.make_generate_fn(model)(tok, build_prefix_table(cached[:, :3], 256), noise)
    acc = TopKAccumulator(ks=[1, 5, 10])
    acc.accumulate(actual=tok.sem_ids_fut[:valid, :3].cpu(), top_k=gen.sem_ids[:valid].cpu())
    want = acc.reduce()
    assert want == {k: s[k] for k in want}
    assert len(beams) == 1 and torch.equal(beams[0], gen.sem_ids)

    assert sorted(os.listdir(export)) == ["config.json", "flax_model.msgpack"]
    vcfg, state = hub.from_pretrained(export)
    assert vcfg == rq.config
    rq2 = RqVae(vcfg, device=cuda)
    rq2.load_state_dict(state)
    zero_launches()
    assert torch.equal(SemanticIdTokenizer(rq2, device=cuda).precompute_corpus_ids(x.to(cuda)), cached)
    assert launches()["rq_encode"] == 1


# ---- stage-1 training ----

# (config file, items: Amazon's cut from 65,536; ML-32M's movie count 87,585, no multiple of a 64-row block)
STAGE1 = {"amazon": ("configs/rqvae_amazon.gin", 16384), "ml32m": ("configs/rqvae_ml32m.gin", 87585)}


@pytest.mark.parametrize("geo", list(STAGE1))
def test_stage1_trainer(cuda, tmp_path, geo):
    """train_rqvae.train at a config file's settings (Amazon: STE, batch 640;
    ML-32M: the rotation trick, 20 binary features, batch 64), steps one by
    one, evaluations and dead-code restarts every 10: 40 iterations unbroken
    against 25 + a resumed 15. Kernel 1 once an evaluation (its bf16 index
    build) and no other kernel; finite losses; the reconstruction loss falls
    (mean of the first 5 steps against the last 5); the resumed run's first
    loss and its final parameters equal the unbroken run's bit for bit."""
    from rqvae_tpu_torch.train import train_rqvae

    gin, n_items = STAGE1[geo]
    it, split, every = 40, 25, 10  # the split off the restart cadence: a run skips a restart at its last step
    folder = write_item_dataset(str(tmp_path / "data"), item_corpus(n_items, gin_rqvae(gin)[0], seed=14), seed=13)

    def run(save, **kw):
        return apply_config(train_rqvae.train, gin, dataset=RecDataset.SYNTHETIC, dataset_folder=folder,
                            eval_every=every, codebook_restart_every=every, save_model_every=10**6, log_every=1,
                            save_dir_root=str(tmp_path / save), device=cuda, **kw)

    zero_launches()
    whole = run("whole", iterations=it)
    run("split", iterations=split)
    rest = run("split", iterations=it - split, auto_resume=True)
    got = launches()
    logs = {name: read_log(str(tmp_path / name)) for name in ("whole", "split")}
    steps = {name: {r["step"]: r for r in recs if "reconstruction_loss" in r} for name, recs in logs.items()}
    evals = sum(1 for recs in logs.values() for r in recs if "rqvae_entropy" in r)
    evals_of = lambda a, b: sum((i + 1) % every == 0 or i + 1 == b for i in range(a, b))  # noqa: E731
    assert evals == evals_of(0, it) + evals_of(0, split) + evals_of(split, it)
    assert got["rq_encode"] == evals and got["decoder_stack"] == got["encoder_stack"] == got["attention"] == 0, got
    assert all(np.isfinite(r["total_loss"]) for recs in steps.values() for r in recs.values())
    recon = [steps["whole"][i]["reconstruction_loss"] for i in range(it)]
    assert np.mean(recon[-5:]) < np.mean(recon[:5]), recon
    assert steps["split"][split]["total_loss"] == steps["whole"][split]["total_loss"]
    assert rest["checkpoint_path"].endswith(f"checkpoint_{it - 1}.pt")
    a, b = load_checkpoint(whole["checkpoint_path"]), load_checkpoint(rest["checkpoint_path"])
    assert all(torch.equal(a["params"][k], b["params"][k]) for k in a["params"])


# ---- scale-out: two ranks sharing the card (gloo) ----

# two ranks' logged losses against one process's, relative: bf16 kernels (stage 2) or f32 (stage 1), the
# batch split in two and summed in another order. A few times what sound runs read on an H100 (3.04e-5 and
# 2.99e-7); each gate's control, a fault planted in rank 1, must read above it
DP_RTOL = {2: 1e-4, 1: 3e-6}
DP_FAULT = {2: "dropout_rows_from_0", 1: "grads_left_out"}


def rel_diffs(losses, want):
    return max(abs(losses[s] - want[s]) / abs(want[s]) for s in want)


@pytest.mark.parametrize("stage", [2, 1])
def test_two_ranks_share_one_card_in_the_trainers(cuda, tmp_path, stage):
    """Each trainer's command line (configs/decoder_amazon.gin, 4 steps;
    rqvae_amazon.gin, 20 steps with evaluations at 10 and 20) on two ranks
    that share the card over gloo, 2 x 320 rows, in chunks of 2 steps that
    run eagerly, against one process at the same settings, whose chunks are
    step-graph replays: every logged loss within DP_RTOL, the ranks'
    summaries equal, and a control run with DP_FAULT planted in rank 1
    (stage 2: its dropout counted from row 0; stage 1: its gradients left
    out of the mean) outside DP_RTOL. Stage 2: kernels 4 and 5 launch 4 a
    step on each rank, from b0 = 0 and 320. Stage 1: each rank evaluates,
    with one kernel-1 launch an evaluation."""
    from rqvae_tpu_torch.train import train_decoder, train_rqvae
    from torch_dist_worker import launch

    cadences = dict(dataset="%data.registry.RecDataset.SYNTHETIC", save_model_every=1000, log_every=2,
                    steps_per_loop=2)
    if stage == 2:
        rq, x = make_rqvae(AMAZON, cuda)
        folder, rq_ckpt, _ = write_training_inputs(str(tmp_path), AMAZON, rq, x, seed=12)
        del rq
        gin, module = "configs/decoder_amazon.gin", train_decoder
        over = dict(pretrained_rqvae_path=f'"{rq_ckpt}"', partial_eval_every=1000, full_eval_every=1000,
                    full_eval_max_batches=1, seed=0, iterations=4)
    else:
        gin, module = "configs/rqvae_amazon.gin", train_rqvae
        # Amazon Beauty's 65,536 items, on which the f32 rtol was read (16,384 read 2.8e-5 from step 7 on)
        folder = write_item_dataset(str(tmp_path / "data"), item_corpus(65536, gin_rqvae(gin)[0], seed=15), seed=13)
        over = dict(iterations=20, eval_every=10)

    def argv(save):
        kw = dict(cadences, dataset_folder=f'"{folder}"', save_dir_root=f'"{tmp_path / save}"', **over)
        return [gin, *(f"{k}={v}" for k, v in kw.items())]

    module.main(argv("one"))  # one process, the parent, first: it builds the kernels the ranks load
    gc.collect()
    torch.cuda.empty_cache()
    spec = {"out": str(tmp_path), "device": "cuda", "scenarios": [
        dict(kind="cli", name="two", stage=stage, argv=argv("two")),
        dict(kind="cli", name="fault", stage=stage, argv=argv("fault"), fault=DP_FAULT[stage])]}
    with open(tmp_path / "spec.json", "w") as f:
        json.dump(spec, f)
    lines = launch(2, str(tmp_path / "spec.json"), timeout=400)
    assert [line["backend"] for line in lines] == ["gloo", "gloo"]
    ranks = [torch.load(tmp_path / f"two.rank{r}.pt") for r in range(2)]
    losses = {name: {r["step"]: r["total_loss"] for r in read_log(str(tmp_path / name)) if "total_loss" in r}
              for name in ("one", "two", "fault")}
    assert sorted(losses["one"]) == sorted(losses["two"]) == sorted(losses["fault"]) and len(losses["one"]) >= 2
    print(json.dumps({"losses": losses, "rtol": DP_RTOL[stage]}))
    assert rel_diffs(losses["two"], losses["one"]) <= DP_RTOL[stage]
    assert rel_diffs(losses["fault"], losses["one"]) > DP_RTOL[stage]
    a, b = (r["summary"] for r in ranks)
    assert all(a[k] == b.get(k) for k in a if k != "iterations_per_sec" and not k.endswith("_ms"))
    for rank, r in enumerate(ranks):
        assert r["graphs"] and not any(r["graphs"]), r["graphs"]  # the chunks ran eagerly
        got = r["launches"]
        if stage == 2:
            assert got["attention"] == got["attention_bwd"] == 4 * 4, got
            assert {b0 for _, b0, _, _ in r["attention_calls"]} == {320 * rank}, r["attention_calls"]
        else:
            assert got["rq_encode"] == 2 and got["attention"] == 0, got


TP = dict(rows=128, steps=2, lr=1e-3, rtol=3e-5)  # the steps' losses against one process's, f32


def tp_batches(n, seed):
    """n seeded stage-2 batches of TP["rows"] rows at the Amazon geometry (20
    items of 3 codes and the dedup column), as the worker's dicts."""
    r = np.random.RandomState(seed)
    rows, items, D = TP["rows"], AMAZON["history"], 4
    out = []
    for _ in range(n):
        mask = np.repeat(np.arange(items)[None, :] < r.randint(3, items + 1, rows)[:, None], D, axis=1)
        sem = np.where(mask, r.randint(0, 256, (rows, items * D)), -1)
        sem[:, 3::4] = np.where(mask[:, 3::4], 0, -1)
        fut = np.concatenate([r.randint(0, 256, (rows, 3)), np.zeros((rows, 1), int)], 1)
        out.append({"user_ids": torch.from_numpy(r.randint(0, 1000, rows).astype(np.int32)),
                    "sem_ids": torch.from_numpy(sem.astype(np.int32)),
                    "sem_ids_fut": torch.from_numpy(fut.astype(np.int32)), "seq_mask": torch.from_numpy(mask),
                    "token_type_ids": torch.from_numpy(np.tile(np.arange(D), (rows, items)).astype(np.int32)),
                    "token_type_ids_fut": torch.from_numpy(np.tile(np.arange(D), (rows, 1)).astype(np.int32))})
    return out


def test_tensor_parallel_ranks_share_one_card(cuda, tmp_path):
    """Two ranks sharing the card over gloo, a 1 x 2 mesh (parallel/mesh.py::
    make_process_mesh), eager, at the Amazon T5 in f32 with dropout 0.1.
    Generation with the model cut to each rank's shards equals the whole
    model's: beams exactly, log-probs within 1e-4. Two steps follow one
    process's: losses within TP["rtol"]; the gathered parameters within
    3 x steps x LR (Adam's first steps are about lr x sign(g), so a last-bit
    difference in a gradient near 0 moves an entry by up to the LR a step in
    either run); the ranks' gathered parameters bit-equal. Each rank launched
    kernels 4 and 5 over its 3 heads from h0 = 0 and 3, 4 a step, and kernel
    2 three times to generate; a control run with rank 1's masks drawn from
    h0 = 0 falls outside the loss tolerance."""
    from rqvae_tpu_torch.data.schemas import TokenizedSeqBatch
    from rqvae_tpu_torch.models.t5 import DropoutSeeds
    from rqvae_tpu_torch.serving.beam import build_prefix_table
    from rqvae_tpu_torch.train.decoder_steps import make_decoder_train_step
    from rqvae_tpu_torch.train.state import adamw
    from torch_dist_worker import launch

    model = retrieval_model("float32", cuda, t5_dropout=0.1, num_user_bins=1000)
    cfg = dataclasses.asdict(model.config)
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, tmp_path / "sd.pt")
    seeds = DropoutSeeds.draw(torch.Generator().manual_seed(90), TP["steps"], model.n_dropout_sites)
    batches = tp_batches(TP["steps"], 91)
    corpus = torch.from_numpy(np.random.RandomState(95).randint(0, 256, (20000, 3)))
    torch.save({"batches": batches, "seeds": list(seeds), "corpus": corpus}, tmp_path / "b.pt")
    common = dict(kind="tp_step", device="cuda", config=cfg, state_dict=str(tmp_path / "sd.pt"), n_data=1,
                  n_model=2, opt=dict(lr=TP["lr"], wd=0.01, max_grad_norm=1.0), batches=str(tmp_path / "b.pt"),
                  steps=TP["steps"])
    spec = {"out": str(tmp_path), "device": "cuda", "scenarios": [
        dict(common, name="tp", generate=True), dict(common, name="fault", fault="heads_from_0")]}
    with open(tmp_path / "spec.json", "w") as f:
        json.dump(spec, f)
    lines = launch(2, str(tmp_path / "spec.json"), timeout=300)
    assert [line["backend"] for line in lines] == ["gloo", "gloo"]
    ranks = [torch.load(tmp_path / f"tp.rank{r}.pt") for r in range(2)]
    fault = torch.load(tmp_path / "fault.rank1.pt")
    with torch.no_grad():
        b = batches[0]
        gen = model.generate(*(b[k].to(cuda) for k in ("sem_ids", "seq_mask", "user_ids")),
                             build_prefix_table(corpus.to(cuda), 256))
    step = make_decoder_train_step(model, adamw(model.parameters(), TP["lr"], weight_decay=0.01, max_grad_norm=1.0))
    want = [step(TokenizedSeqBatch(**{k: v.to(cuda) for k, v in bt.items()}), seeds=seeds[i].to(cuda))
            ["total_loss"].item() for i, bt in enumerate(batches)]
    rel = lambda r: max(abs(m["total_loss"].item() - w) / abs(w) for m, w in zip(r["metrics"], want))  # noqa: E731
    print(json.dumps({"losses_one_process": want, "rel": [rel(r) for r in ranks], "fault_rel": rel(fault)}))
    for rank, r in enumerate(ranks):
        assert torch.equal(r["generate"]["sem_ids"], gen.sem_ids.cpu()) and r["still_sharded"]
        assert (r["generate"]["log_probas"] - gen.log_probas.cpu()).abs().max() <= 1e-4
        assert rel(r) <= TP["rtol"]
        for k, p in model.state_dict().items():
            assert (r["params"][k] - p.cpu()).abs().max() <= 3 * TP["steps"] * TP["lr"], k
        assert {(h0, total) for _, _, h0, total in r["attention_calls"]} == {(3 * rank, 6)}, r["attention_calls"]
        got = r["launches"]
        assert got["attention"] == got["attention_bwd"] == 4 * TP["steps"] and got["decoder_stack"] == 3, got
    assert all(torch.equal(ranks[0]["params"][k], ranks[1]["params"][k]) for k in ranks[0]["params"])
    assert rel(fault) > TP["rtol"]


# ---- the raw-file pipelines ----

# Amazon Beauty's P5 layout cut from 22,363 users, 12,101 items and 198,502 interactions (every user at
# least 5); ML-1M's "::" files at its 3,883 movies (no multiple of a 64-row block) and 18 genres, users cut
# from 6,040 (stride-1 windows of 200 over every user make a 1.6 GB array on the host)
P5 = dict(users=2000, items=1500, interactions=20000)
ML1M = dict(movies=3883, max_movie_id=3952, users=200, mean_ratings=165, min_ratings=20)
ML1M_GENRES = ["Action", "Adventure", "Animation", "Children's", "Comedy", "Crime", "Documentary", "Drama",
               "Fantasy", "Film-Noir", "Horror", "Musical", "Mystery", "Romance", "Sci-Fi", "Thriller", "War",
               "Western"]
WORDS = ("matte velvet hydrating serum cream rose argan silk gloss shea lotion mineral radiant repair daily "
         "night tint balm cleanser tonic glow clay charcoal vitamin peony citrus jasmine mask oil gel").split()


def zipf_probs(n, r, a=0.9):
    """Zipf-like popularity over n ids in a seeded random order."""
    p = 1.0 / (np.arange(n) + 10.0) ** a
    return p[r.permutation(n)] / p.sum()


def write_p5_raw(root, seed):
    """P5-layout raw files of the Beauty split under root/raw/beauty
    (sequential_data.txt, datamaps.json, meta.json.gz): every user at least 5
    items, Zipf-like item popularity, seeded titles, brands, categories and
    prices."""
    r = np.random.RandomState(seed)
    U, N, total = P5["users"], P5["items"], P5["interactions"]
    weights = r.pareto(1.5, U) + 1.0
    lengths = 5 + r.multinomial(total - 5 * U, weights / weights.sum())
    items = r.choice(N, total, p=zipf_probs(N, r)) + 1
    raw = os.path.join(root, "raw", "beauty")
    os.makedirs(raw)
    with open(os.path.join(raw, "sequential_data.txt"), "w") as f:
        at = 0
        for u, n in enumerate(lengths, 1):
            f.write(f"{u} " + " ".join(map(str, items[at:at + n])) + "\n")
            at += n
    with open(os.path.join(raw, "datamaps.json"), "w") as f:
        json.dump({"item2id": {f"B{i:09d}": str(i) for i in range(1, N + 1)}}, f)
    with gzip.open(os.path.join(raw, "meta.json.gz"), "wt") as f:
        for i in range(1, N + 1):
            meta = {"asin": f"B{i:09d}", "title": " ".join(r.choice(WORDS, r.randint(2, 7))).title(),
                    "brand": f"Brand {r.randint(400)}",
                    "categories": [["Beauty", ["Skin Care", "Makeup", "Hair Care", "Fragrance"][r.randint(4)]]],
                    "price": round(float(r.gamma(2.0, 9.0)), 2)}
            f.write(repr(meta) + "\n")


def write_ml1m_raw(root, seed):
    """ML-1M's "::" layout under root/raw (movies.dat, users.dat, ratings.dat,
    ISO-8859-1): Zipf-like movie popularity, each user's ratings over
    increasing timestamps with ties."""
    r = np.random.RandomState(seed)
    raw = os.path.join(root, "raw")
    os.makedirs(raw)
    ids = np.sort(r.choice(np.arange(1, ML1M["max_movie_id"] + 1), ML1M["movies"], replace=False))
    with open(os.path.join(raw, "movies.dat"), "w", encoding="ISO-8859-1") as f:
        for m in ids:
            genres = "|".join(sorted(set(r.choice(ML1M_GENRES, r.randint(1, 4)))))
            f.write(f"{m}::{' '.join(r.choice(WORDS, r.randint(1, 5))).title()} ({r.randint(1919, 2001)})::{genres}\n")
    ages, U = ["1", "18", "25", "35", "45", "50", "56"], ML1M["users"]
    with open(os.path.join(raw, "users.dat"), "w", encoding="ISO-8859-1") as f:
        for u in range(1, U + 1):
            f.write(f"{u}::{'FM'[r.randint(2)]}::{ages[r.randint(7)]}::{r.randint(21)}::{r.randint(10000, 99999)}\n")
    pop = zipf_probs(len(ids), r)
    with open(os.path.join(raw, "ratings.dat"), "w") as f:
        for u in r.permutation(U) + 1:
            n = min(len(ids), ML1M["min_ratings"] + r.geometric(1.0 / (ML1M["mean_ratings"] - 19)))
            movies = ids[r.choice(len(ids), n, replace=False, p=pop)]
            t = 956703932 + np.cumsum(r.randint(0, 3, n))  # steps of 0: tied timestamps
            f.write("".join(f"{u}::{m}::{r.randint(1, 6)}::{ts}\n" for m, ts in zip(movies, t)))


@pytest.mark.parametrize("dataset", ["amazon", "ml1m"])
def test_raw_file_pipeline(cuda, tmp_path, capsys, dataset):
    """Raw files written here -> rqvae_tpu_torch.parity_run.main on the card
    (the port's pipeline with the hashed text encoder, stage 1, stage 2, the
    full evaluation; budgets cut with --set): the processed file's shapes,
    both checkpoints, metrics in [0, 1], the last line printed. Amazon
    (rqvae_amazon.gin, decoder_amazon.gin): kernel 1 in stage 1's evaluation
    and stage 2's index build, kernel 2 in the full evaluation, kernels 4 and
    5 in the steps. ML-1M (rqvae_ml1m.gin: kernel 1 at 786 inputs;
    decoder_ml1m.gin's windows of 200: kernel 3 in the full evaluation)."""
    from rqvae_tpu_torch import parity_run

    root = str(tmp_path)
    data_dir = os.path.join(root, "data")
    if dataset == "amazon":
        write_p5_raw(data_dir, seed=80)
        sets = ["s1.iterations=40", "s2.iterations=8", "s2.full_eval_max_batches=2"]
    else:
        write_ml1m_raw(data_dir, seed=81)
        sets = ["s1.iterations=30", "s2.iterations=4", "s2.full_eval_max_batches=1", "s2.partial_eval_every=1000000"]
    argv = ["--dataset", dataset, "--device", cuda.type, "--encoder", "hash", "--quick", "--workdir", data_dir,
            "--outdir", os.path.join(root, "out"), "--out", os.path.join(root, "parity.json")]
    zero_launches()
    capsys.readouterr()
    result = parity_run.main(argv + [arg for s in sets for arg in ("--set", s)])
    got = launches()
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == {"dataset": dataset, **result["metrics"]}
    for stage in ("stage1", "stage2"):
        assert os.path.exists(result[stage]["checkpoint_path"])
    metrics = result["metrics"]
    assert {"h@1", "h@5", "h@10", "ndcg"} <= set(metrics) and all(0.0 <= v <= 1.0 for v in metrics.values())
    data = np.load(os.path.join(data_dir, "processed", "data.npz"))
    if dataset == "amazon":
        assert data["item_features"].shape == (P5["items"], 768) and data["item_features"].dtype == np.float32
        assert data["seq_items"].shape[0] == P5["users"] and int(data["seq_lengths"].sum()) == P5["interactions"]
        assert int(data["max_seq_len"]) == 20
        assert got["rq_encode"] >= 2 and got["decoder_stack"] >= 3 and got["attention"] >= 4, got
        assert got["attention_bwd"] == got["attention"], got
    else:
        assert data["item_features"].shape[1] == 786 and 0 < data["item_features"].shape[0] <= ML1M["movies"]
        assert data["seq_items"].shape[1] == 200 and data["user_features"].shape == (ML1M["users"], 3)
        assert got["rq_encode"] >= 2 and got["encoder_stack"] >= 1, got
        assert got["attention"] >= 4 and got["attention_bwd"] >= 4, got
