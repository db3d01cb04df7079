"""Measured train-step time and MFU (port of rqvae_tpu/train/perf.py).

Each measure builds the real step (stage 1: train/rqvae_steps.py's body;
stage 2: the fused sample -> tokenize -> forward / backward -> AdamW body of
train/decoder_steps.py) as a chunk of steps, each step one replay of its CUDA
graph on the card, and times it differentially: (t(r2) - t(r1)) / (r2 - r1)
over r1 and r2 replays cancels what a call costs once (staging the draws, the
final read-back), as the JAX package's differential timing cancels its
dispatch round trip.

Nothing can be skipped: every replay updates the parameters from gradients
that depend on the step before, and `run(r)` ends by reading back a sum over
one parameter plus the chunk's metric sums, which the steps compute (the
stage-1 p_unique_ids sort, the stage-2 sequence-length quantiles included).

The defaults are the Amazon flagship (configs/rqvae_amazon.gin,
configs/decoder_amazon.gin). `bf16=True` is the JAX measure's bf16 matmul
precision, the trainers' `amp` (ops/amp.py): bf16 operands with float32
sums in stage 1's MLPs, and in stage 2's float32 products and heads. MFU is
against the H100 SXM's dense bf16 peak (utils/flops.py::PEAK_FLOPS),
whatever the step's dtype, so that the two stages, both dtypes and both
routes read on one scale. Runs on the card; on the CPU (for
the tests, at small sizes) the same chunks run eagerly, and the returned
times are the CPU's.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from rqvae_tpu_torch.utils import flops as flops_lib
from rqvae_tpu_torch.utils.device import DeviceLike, resolve_device

PEAK = "h100_sxm_bf16"


def differential_time(run, r1: int = 5, r2: int = 55, reps: int = 3, clock=time.perf_counter) -> float:
    """Per-iteration time of `run(r)` (r serially dependent iterations per
    call, ended by a read-back): best of `reps` per point, the two trip
    counts interleaved so a slow window hits both."""
    run(r1)  # warm-up (the same graph for both trip counts)
    run(r2)
    t = {r1: float("inf"), r2: float("inf")}
    for _ in range(reps):
        for r in (r1, r2):
            t0 = clock()
            run(r)
            t[r] = min(t[r], clock() - t0)
    if t[r2] <= t[r1]:
        raise RuntimeError(
            f"differential timing failed: t({r2})={t[r2]:.4f}s <= t({r1})={t[r1]:.4f}s"
        )
    return (t[r2] - t[r1]) / (r2 - r1)


def _runner(chunks, draws, first_param, keys):
    """run(r): stage the pre-drawn steps, replay r of them, read back a sum
    over one parameter plus the metric sums."""

    def run(r: int) -> float:
        chunks.stage(draws)
        chunks.replay(r)
        total = first_param.detach().sum()
        for k in keys:
            total = total + chunks.sums[k].sum()
        return float(total)

    return run


def measure_stage1_step(
    batch: int = 640,
    input_dim: int = 768,
    hidden_dims=(512, 256, 128),
    embed_dim: int = 32,
    codebook_size: int = 256,
    n_layers: int = 3,
    n_items: int = 20000,
    bf16: bool = False,
    r1: int = 50,
    r2: int = 550,
    device: DeviceLike = None,
) -> dict:
    """Stage-1 (RQ-VAE, STE) train-step time and MFU at the given geometry;
    `bf16`: the amp route."""
    from rqvae_tpu_torch.models.quantize import QuantizeForwardMode
    from rqvae_tpu_torch.models.rqvae import RqVae, RqVaeConfig
    from rqvae_tpu_torch.train.rqvae_steps import make_rqvae_graph_train_step
    from rqvae_tpu_torch.train.state import adamw

    dev = resolve_device(device)
    cfg = RqVaeConfig(
        input_dim=input_dim, embed_dim=embed_dim, hidden_dims=tuple(hidden_dims),
        codebook_size=codebook_size, n_layers=n_layers, n_cat_feats=0,
        codebook_mode=QuantizeForwardMode.STE,
    )
    model = RqVae(cfg, device=dev, seed=0)
    rng = np.random.RandomState(0)
    features = torch.as_tensor(rng.randn(n_items, input_dim).astype(np.float32), device=dev)
    step = make_rqvae_graph_train_step(model, adamw(model.parameters(), 1e-3, weight_decay=1e-4),
                                       n_steps=r2, accum=1, batch_size=batch, amp=bf16)
    step.features = features
    draws = [step.draws(7, i, n_items) for i in range(r2)]
    run = _runner(step.chunks, draws, next(model.parameters()), ("total_loss", "p_unique_ids"))
    sec = differential_time(run, r1=r1, r2=r2)
    f = flops_lib.rqvae_train_step_flops(batch, input_dim, hidden_dims, embed_dim, codebook_size, n_layers)
    return {
        "seconds_per_step": sec,
        "examples_per_sec": batch / sec,
        "flops_per_step": f,
        "mfu": flops_lib.mfu(f, sec, PEAK),
        "peak": PEAK,
        "batch": batch,
        "device": _device_name(dev),
    }


def measure_stage2_step(
    batch: int = 640,
    max_seq_len: int = 20,
    d_model: int = 384,
    num_heads: int = 6,
    d_kv: int = 64,
    d_ff: int = 1024,
    num_layers: int = 4,
    codebook_size: int = 256,
    n_hierarchies: int = 3,
    n_rows: int = 2000,
    n_corpus: int = 20000,
    dtype: str = "bfloat16",
    bf16: bool = False,
    r1: int = 5,
    r2: int = 55,
    device: DeviceLike = None,
    **cfg_overrides,
) -> dict:
    """Stage-2 (retrieval) fused train-step time and MFU: on-device window
    subsampling, cached-table tokenization, forward / backward with dropout
    0.1 (kernels 4 and 5 for the attention), AdamW. Defaults: the Amazon
    flagship (bf16). `bf16`: the amp route (with dtype="float32", the
    products of `dense` and the heads in bf16 with f32 sums)."""
    from rqvae_tpu_torch.models.retrieval import EncoderDecoderRetrievalModel, RetrievalConfig
    from rqvae_tpu_torch.train.decoder_steps import make_decoder_graph_train_step
    from rqvae_tpu_torch.train.state import adamw

    dev = resolve_device(device)
    cfg = RetrievalConfig(
        num_hierarchies=n_hierarchies, codebook_size=codebook_size,
        t5_d_model=d_model, t5_num_heads=num_heads, t5_d_kv=d_kv, t5_d_ff=d_ff,
        t5_num_layers=num_layers, t5_dropout=0.1, top_k_for_generation=10,
        t5_dtype=dtype, **cfg_overrides,
    )
    model = EncoderDecoderRetrievalModel(cfg, device=dev, seed=0)
    rng = np.random.RandomState(0)
    total_len = max_seq_len + 2
    seq_items = torch.as_tensor(rng.randint(0, n_corpus, (n_rows, total_len)), dtype=torch.int32, device=dev)
    seq_lengths = torch.as_tensor(rng.randint(3, total_len + 1, n_rows), dtype=torch.int32, device=dev)
    user_ids = torch.arange(n_rows, dtype=torch.int32, device=dev)
    ids = rng.randint(0, codebook_size, (n_corpus, n_hierarchies))
    cached = torch.as_tensor(np.concatenate([ids, np.zeros((n_corpus, 1), np.int64)], 1), dtype=torch.int32,
                             device=dev)
    step = make_decoder_graph_train_step(model, adamw(model.parameters(), 1e-3, weight_decay=0.01), max_seq_len,
                                         n_steps=r2, batch_size=batch, amp=bf16)
    step.bind(seq_items, seq_lengths, user_ids, cached)
    draws = [step.draws(7, i, n_rows) for i in range(r2)]
    run = _runner(step.chunks, draws, next(model.parameters()), ("total_loss", "seq_length_p50"))
    sec = differential_time(run, r1=r1, r2=r2)
    tokens_per_item = n_hierarchies + (1 if cfg.should_add_sep_token else 0)
    enc_len = max_seq_len * tokens_per_item
    dec_len = n_hierarchies + 1  # BOS + teacher-forced targets
    f = flops_lib.retrieval_train_step_flops(
        batch, enc_len, dec_len, d_model, num_heads, d_kv, d_ff, num_layers, codebook_size, n_hierarchies,
    )
    return {
        "seconds_per_step": sec,
        "examples_per_sec": batch / sec,
        "flops_per_step": f,
        "mfu": flops_lib.mfu(f, sec, PEAK),
        "peak": PEAK,
        "batch": batch,
        "enc_len": enc_len,
        "device": _device_name(dev),
    }


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
