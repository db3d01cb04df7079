"""Drive the PyTorch/CUDA port's serving and training paths on one NVIDIA card
and check them.

    python3 chip_smoke.py

Two published geometries, served and trained, weights made from seeds. Amazon Beauty:
RQ-VAE 768 -> [512, 256, 128] -> 32, 20-item histories (encoder rows
Le = 80), 65,536 synthetic items. MovieLens-32M: RQ-VAE 788 -> [512, 256,
128] -> 64, 200-item histories (Le = 800), 87,585 synthetic items (the
dataset's movie count, no multiple of the 64 rows of an rq_encode block). Both:
3 x 256 codebooks; T5 d_model 384, 6 heads, d_kv 64, d_ff 1024, 4+4 layers,
bf16, top-k 10, batches of 64 histories.

   1. card: name, count, power limit, torch/CUDA versions; builds the five
      CUDA kernels from rqvae_tpu_torch/csrc (one nvcc per source, in
      parallel) and prints each kernel's ptxas registers and spills; the
      tensor-core kernels of encoder_stack, decoder_stack and rq_encode must
      spill nothing;
   2. rq_encode kernel against its plain version on the card (Amazon width;
      each rq_encode phase prints its route, which must be "cuda_cores" in
      f32 and "tensor_cores" in bf16, the rows per block, the shared memory
      a block asks for and ptxas's registers and spills of each kernel-1
      kernel), precision="f32": identical ids except rows at an argmin near-tie: a
      level whose top-2 distance gap, in float64, is below 1e-5 of
      ||res||^2 + max ||c||^2, the size of the terms the f32 distances are
      summed from; then in bf16, the index build's default: identical ids
      except rows in the bf16 near-tie set (a level whose top-2 gap along the
      bf16 path is within what one bf16 step of every residual element can
      move it), integer-valued cases (every f32 sum exact, so the rounding
      points alone decide) bit-equal: two at small widths and two at the
      Amazon widths, which take the tensor-core route; two launches
      bit-equal; the rows whose ids differ from a float64 model of the
      tensor-core route's sums (tc_sum_model_ids), reported; and the index
      build's time in bf16 beside f32;
   3. decoder_stack kernel against its plain version on the card (B = 64,
      Le = 80, kT = 1, 20, 30): max abs error <= 1e-3 in f32 and <= 6e-2 in
      bf16 (bf16 rounding of the residual stream over 4 layers: a summation
      order that differs in the last f32 bit can flip a bf16 rounding, and the
      flip carries through the later layers); bf16 must take the tensor-core
      route; each row prints its route, the shared memory a block asks for,
      the error's mean and the count of entries above half the bound; two
      launches must give the same bits;
   4. the Amazon main path with the launch counts zeroed first: index build
      (rq_encode, bf16), Retriever, 3 retrieve() calls; requires 1 rq_encode launch
      and 3 levels x 3 calls decoder_stack launches, corpus-valid beams and
      sorted finite log-probs; then one more retrieve() under torch.profiler;
   5. that path in f32, card (kernels) against CPU (plain versions), each
      building its own index (the card's by rq_encode at precision="f32"): ids identical except near-tie rows, all 10
      beams identical on >= 95% of the queries;
   6. rq_encode at the ML-32M width, 87,585 x 788, as in 2, both precisions;
      then at the ML-1M width (configs/rqvae_ml1m.gin: 786 inputs, not a
      multiple of 4, on 3,883 items, the dataset's movie count), as in 2;
   7. attention kernel against its plain version at q, k, v [64, 6, 800, 64]
      (bf16: the tiled route) and at the Amazon training shape
      [640, 6, 80, 64] (bf16: the whole-row route), with ragged key masks and
      one row with every key masked, f32 and bf16, dropout rate 0 and 0.1
      (the same seed on both sides: a 1-element int32 tensor on the card,
      which the kernels read, as training passes it), and a causal case at
      L = 512; the keep bits that kernels 4 and 5 apply with a device seed,
      read off identity blocks, equal the plain version's for seeds 77, 78
      and 2^31 + 5 on all three routes, 77 and 78 apart: max abs error
      <= 2e-5 in f32 and <= 3.2e-2 in bf16 (one bf16 step, 2^-5, of an output
      between 4 and 8 whose f32 sum lands across a rounding boundary; the two
      sides sum in another order); SDPA's time at both shapes;
   8. encoder_stack kernel against its plain version at x [64, 800, 384] with
      ragged history lengths: max abs error <= 1e-3 in f32; in bf16 <= 0.15 at
      the worst element and <= 4e-3 in the mean (flipped bf16 roundings of
      the residual stream carry through 4 layers); routes, shared memory,
      error distribution and bit-equal repeats as in 3;
   9. the ML-32M main path, counts zeroed first: index build, Retriever in
      bf16, 3 retrieve() calls of 64 histories of 1..200 items; requires
      rq_encode >= 1, encoder_stack == 3, decoder_stack == 0 and attention == 0
      launches (Le = 800 closes the decoder gate: the plain decoder runs);
      then, counts zeroed again, the same calls with t5_fused_encode="off":
      attention == 4 layers x 3 calls, encoder_stack == 0. The two routes
      compute one function in another summation order: in f32 all 10 beams
      must be equal on >= 95% of the queries. In bf16 a flipped rounding moves
      a log-prob by up to some tenths at these random weights, so beams near a
      tie trade places: there the first beam must be equal on >= 80% of the
      queries and the routes must share >= 90% of their beams, and the share
      with all 10 equal is printed beside that of the "off" route against
      plain torch attention (routes that differ inside attention only); then
      one default-route retrieve() under torch.profiler;
  10. the ML-32M path in f32 on 8 queries, card (kernels) against CPU (plain
      versions): all 10 beams identical on >= 95% of the queries;
  11. attention backward kernel against its plain version at the two training
      shapes, q, k, v, dout [640, 6, 80, 64] and [64, 6, 800, 64], f32 and bf16,
      dropout rate 0 and 0.1 (same seed on both sides), ragged key masks and
      one row with every key masked, and a causal case: dq, dk, dv and dbias
      each within 4e-6 of the tensor's largest entry in f32 (a few f32 steps:
      sums of up to 800 terms taken in another order) and within 2^-7 of it in
      bf16 (one bf16 step of the largest output, when an f32 sum lands across
      a rounding boundary; dbias, summed in f32, within 1e-4); two launches
      bit-equal; the backward's p equal in bits to the forward's at L = 64,
      80 and 800 in both dtypes, so on every route (read off 64-wide identity
      blocks of v and dout); times of the kernel, its plain version and the library's
      backward (autograd through scaled_dot_product_attention, no dropout);
      the forward kernel's time at the Amazon training shape;
  12. stage-2 training at the ML-32M width through train_decoder.train, counts
      zeroed first: 87,585 items, 20,000 synthetic users of 10..202 items
      (histories of up to 200, encoder rows Le = 800), batch 64, bf16, dropout
      0.1, 3 iterations and one full-eval batch; requires attention forward ==
      backward == 4 layers x 3 micro-batches, encoder_stack == 1 (the eval
      batch), finite losses and hits@k in [0, 1]; then 3 timed steps of the
      same step function (host clock, synchronised) and the peak device memory;
  13. stage-2 training at the Amazon width through train_decoder.train, counts
      zeroed first: 65,536 items, 22,363 synthetic users (Amazon Beauty's user
      count) of 8..22 items, batch 640, bf16, dropout 0.1, weight decay 1e-4:
      5 iterations with the loss-only and the full evaluation (one batch),
      then a resumed run of 1 iteration with gradient_accumulate_every=2;
      requires attention forward == backward == 4 x 7 micro-batches,
      decoder_stack == 3 levels x 2 eval batches, rq_encode >= 1. Then, with
      the step function it is made of: every parameter has a finite, non-zero
      gradient on the first step and has moved after it, the same seed gives
      the same first-step loss twice (bit-equal), and 5 timed steps;
  14. one training step in f32 with dropout 0.1 and the same seeds at batch 32,
      card (kernels) against CPU (plain versions): loss rtol 1e-5, every
      gradient within 2e-4 of the tensor's largest entry;
  15. one Amazon training step under torch.profiler: device time by kernel,
      launches, the device's idle share, the shares of the attention kernels
      and of the cuBLAS products; beside it the CUDA-event time of the
      hash-dropout masks at the encoder's dropout sites, forward and backward;
  16. stage-1 (RQ-VAE) training at the Amazon width through train_rqvae.train
      at configs/rqvae_amazon.gin's settings (768 -> [512, 256, 128] -> 32,
      3 x 256, STE, batch 640, LR 1e-3, weight decay 1e-4, k-means init on
      20,000 samples) on 65,536 unit-norm items, counts zeroed first: 40
      iterations unbroken, then the same run as 25 + a resumed 15, with
      evaluations and dead-code restarts every 10; requires rq_encode
      launches == evaluations (each one bf16 index build) and no other
      kernel, finite losses, a falling reconstruction loss, the resumed
      step's loss equal to the unbroken run's and the final parameters
      bit-equal; prints the k-means init ms, each evaluation's index build
      ms, the diversity metrics, 10 timed steps (host clock, synchronised)
      and one step under torch.profiler;
  17. the same at configs/rqvae_ml32m.gin's settings (788 = 768 dense + 20
      binary genre features -> [512, 256, 128] -> 64, rotation trick, batch
      64, LR 1e-4, weight decay 0.01) on 87,585 items;
  18. one f32 stage-1 step at each of the two settings, the same weights and
      batch, card against CPU: loss rtol 1e-5, every gradient within 2e-4 of
      its largest entry (batch rows at an f32 argmin near-tie left out).

  19. rq_encode_packed: kernel 1's emit_packed epilogue at the Amazon width,
      f32 and bf16: ids equal to an unpacked launch's, the key column equal
      to pack_sem_id_tuples of them; the epilogue's extra ms;
  20. checkpoint_interop: the committed checkpoints that flax wrote
      (tests/fixtures/jax_synthetic/) served on the card through
      Retriever.from_checkpoints in f32: item ids and beams equal to the JAX
      package's stored results, log-probas within 1e-4;
  21. sampled_candidates: sample_candidates=True over the fixture's weights,
      card against CPU in f32, both fed the same Gumbel noise: all beams
      equal on >= 95% of the queries;
  22. serve_amazon and serve_ml32m: seeded full-width weights written as
      JAX-format checkpoints; a first from_checkpoints start builds and saves
      the index (rq_encode launched once), a second loads it (no time);
      RetrievalEngine.warmup() captures one CUDA graph per (batch, items)
      bucket (Amazon 4 x 3, ML-32M 4 x 6); per bucket the encoder and decoder
      routes, the replay equal to eager bit for bit, each launch of kernels 2
      and 3 in the bucket's eager call held against its plain version on the
      same operands (the gates of phases 3 and 8; the bf16 decoder, whose
      tokens come from the bf16 index, to phase 8's bf16 pair), the nodes of
      the engine's graph (its debug dump, kernels demangled) equal by name to
      one eager call's launches (profiler), eager and replayed ms (CUDA events
      and host clock) and one profiled replay's device ms and idle share;
      retrieve_many over 256 mixed-length
      histories equal to the eager engine's; the graph pool's memory;
  23. corpus_growth: at the Amazon width with capacity n + 4,096, the 4,096
      items admitted after capture (kernel 1 once, no corpus tensor moved),
      the ids and dedup column equal to a full rebuild's, and the replays
      equal to an engine over the rebuilt corpus, admitted items returned;
  24. queue: an AsyncRetrievalEngine over the Amazon engine at two offered
      rates (every future equal to its flush's retrieve_many row; p50 / p99
      latency and flush sizes printed), then past saturation with a bounded
      queue and deadlines (rejects and sheds printed, not gated).

  Training as the JAX trainers run it (chunks of steps_per_loop steps, each
  step one replay of a CUDA graph of the whole step), run after phase 18:
  25. train_rqvae_graph_amazon, train_rqvae_graph_ml32m: stage 1 at
      configs/rqvae_amazon.gin (STE, batch 640) and rqvae_ml32m.gin (rotation
      trick, batch 64), codebooks seeded from the data: from one state, 8
      steps one by one (steps_per_loop=1) twice, against 2 chunks of 4
      replays: parameters and AdamW moments bit-equal (or, if the two eager
      runs differ, no further apart than they are), each chunk's metrics the
      mean of its eager steps' bit for bit, the graph's nodes by demangled
      name equal to one eager step's profiled launches; eager and replayed
      host ms, the graph's card ms (CUDA events), a replay's idle share;
  26. train_rqvae_graph_amazon_gumbel: the same in Gumbel-softmax mode with
      the temperature annealed on the device from the step number;
  27. train_perf: train/perf.py's measure_stage1_step() and
      measure_stage2_step() at their defaults (the Amazon flagship) and stage
      2 at the ML-32M geometry: seconds per step by differential timing of
      graph replays, examples/s, flops and MFU against the bf16 peak; a
      200-step train_rqvae.train run at rqvae_amazon.gin's settings with
      steps_per_loop=1 against the automatic chunk (100);
  28. train_graph_amazon: stage 2 at configs/decoder_amazon.gin's widths
      (batch 640, Le 80, bf16, dropout 0.1): 8 eager steps twice against 2
      chunks of 4 replays, the gates of 25; the graph holds kernel 4 x 4 and
      kernel 5 x 4 (its launches in the kernels line: nodes x replays; the
      wrappers' counters, zeroed first, do not tick on a replay); capture s
      and the graph pool's memory;
  29. train_graph_ml32m: the same at decoder_ml32m.gin's (batch 64, Le
      800: the tiled routes), 4 eager steps against 2 chunks of 2;
  30. remat: one ML-32M stage-2 step with t5_remat=True against False,
      dropout 0.1, the same seeds: loss and every gradient bit-equal; kernel
      4 launched 8 times with remat (each encoder layer's forward again in
      the backward), 4 without; the peak memory of both.

  The trainers as rqvae_tpu's are configured and resumed, at the Amazon
  widths, run after phase 27:
  31. train_amp: amp=True (ops/amp.py: bf16 operands, float32 sums, cuBLAS)
      in stage 2 at t5_dtype="float32" (batch 640, Le 80, dropout 0.1, 4
      steps) and in stage 1 at configs/rqvae_amazon.gin (8 steps): from one
      state, the amp steps one by one twice against the amp step graph
      (bit-equal, as in 25), the graph without amp, and the graph without
      amp from the bf16-rounded parameters; losses within rtol 2e-2 of the
      float32 run's and the parameters no further from it than 1.5 x the
      rounded start's run is (AMP_PARAM_FACTOR); the graph's bf16 GEMM nodes
      (cuBLAS `nvjet` kernels) equal to one step's bf16 products and none
      without amp; kernels 4 and 5 in both stage-2 graphs on their float32
      route (cuda_cores); replay ms of every graph; perf.py's step time and
      MFU of both routes in both stages; 20 amp=True steps of
      train_rqvae.train;
  32. resume_jax_layout: train_decoder.train at decoder_amazon.gin's
      settings (bf16) for 4 steps unbroken against 2 steps, the checkpoint
      rewritten as the JAX package's file with its optax opt_state
      (export_jax_checkpoint) and 2 more steps of a trainer resuming from
      it; train_rqvae.train at rqvae_amazon.gin's, 20 against 10 + 10: step,
      count, parameters and both moments bit-equal to the unbroken run;
  33. sampled_eval: train_decoder.train with sample_candidates=True (2
      steps, the full evaluation once on one batch of 640): its beams
      (recorded as its generate returns them) and its hits@k and NDCG equal
      those of a generate fed the same noise (the generator of (seed,
      999)); kernel 2's launches in that generate held against their plain
      version; the share of queries whose beams equal the deterministic
      generate's; sampled and deterministic generate ms;
  34. hub_export: the same run with push_vae_to_hf=True prints that the push
      failed and the local export is kept at save_dir_root/rqvae_export;
      utils/hub.py::from_pretrained on it gives an RQ-VAE whose bf16 index
      build (kernel 1) equals the trainer's RQ-VAE's, ID for ID.

Each phase prints one JSON line. Then the `kernels` line, the card's
`nvidia-smi` name and power limit, and last `{"ok": true, "device": ...}`.
Any failed check raises: the script exits non-zero and prints no last line.
Without a CUDA device it exits with code 1 before printing anything.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

H100_F32_FLOPS = 67e12  # float32 on CUDA cores (H100 SXM data sheet)
H100_BF16_FLOPS = 989e12  # bf16 tensor cores, dense
H100_BYTES_PER_S = 3.35e12  # HBM3

BATCH = 64
CALLS = 3
AMAZON = dict(items=65536, history=20, input_dim=768, embed_dim=32)
ML32M = dict(items=87585, history=200, input_dim=788, embed_dim=64)
ML1M = dict(items=3883, input_dim=786, embed_dim=32)  # configs/rqvae_ml1m.gin; MovieLens-1M's movie count
CPU_QUERIES_ML32M = 8
ID_NEAR_TIE = 1e-5  # top-2 gap relative to ||res||^2 + max ||c||^2
DECODER_TOL = {torch.float32: 1e-3, torch.bfloat16: 6e-2}
ATTENTION_TOL = {torch.float32: 2e-5, torch.bfloat16: 3.2e-2}
# attention backward, relative to the tensor's largest entry: (dq, dk, dv; dbias)
ATTENTION_BWD_TOL = {torch.float32: (4e-6, 4e-6), torch.bfloat16: (2.0 ** -7, 1e-4)}
TRAIN_AMAZON = dict(users=22363, min_len=8, max_len=22, max_seq_len=20, batch=640)
TRAIN_ML32M = dict(users=20000, min_len=10, max_len=202, max_seq_len=200, batch=64)
TRAIN_CPU_BATCH = 32
# stage 1: an unbroken run of `iterations` against `split` + a resume for the rest (the split
# is off the restart cadence: the trainer skips a restart at a run's last iteration, as JAX's does)
RQ_TRAIN = dict(iterations=40, split=25, eval_every=10, restart_every=10, timed_steps=10)
TRAIN_GRAD_TOL = 2e-4  # card vs CPU in f32, relative to the gradient tensor's largest entry
T5 = dict(t5_d_model=384, t5_num_heads=6, t5_d_ff=1024, t5_num_layers=4)
ENCODER_TOL = {torch.float32: (1e-3, 1e-5), torch.bfloat16: (1.5e-1, 4e-3)}  # (max, mean) abs error
BEAMS_SAME_MIN = 0.95
BF16_TOP1_MIN, BF16_OVERLAP_MIN = 0.8, 0.9  # two bf16 routes: first beam equal; beams in common
DEVICE = "cuda"  # the card; a CPU rehearsal of the control flow may set "cpu"
PTXAS = {}  # each source's ptxas rows, from phase 1
DEVICE_COPY = "device copy or memset"  # profile_call's one name for them
RANK_TIMEOUT_S = 240  # a data-parallel phase's processes, together
REPO_DIR = os.path.dirname(os.path.abspath(__file__))  # the ranks run the trainers' CLI from here
# two ranks' logged losses against one process's, relative: bf16 kernels (stage 2) or f32
# (stage 1), the batch split in two and summed in another order. A few times the sound runs'
# reading on an H100 (3.04e-5 and 2.99e-7, the same in every run); the planted faults of
# dp_two_ranks_phase and dp_stage1_phase read 5.9e-4 and 8.8e-4 and must stay above
DP_BF16_RTOL = 1e-4
DP_F32_RTOL = 3e-6
KERNEL_KEYS = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
               "bound_ms", "bound_by", "library_ms")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def sync() -> None:
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def reset_peak_memory() -> None:
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()


def peak_memory() -> int:
    return torch.cuda.max_memory_allocated() if DEVICE == "cuda" else 0


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of `fn` on the current stream (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def abba_ms(name_a: str, fa, name_b: str, fb, reps: int) -> dict:
    """Two functions' cuda_ms timed in the order a, b, b, a, each the mean
    of its two: a drift across the four (the first timed paying for a warm
    up) cancels in their comparison."""
    ta = cuda_ms(fa, reps, warmup=1)
    tb = cuda_ms(fb, reps, warmup=1) + cuda_ms(fb, reps, warmup=1)
    return {name_a: (ta + cuda_ms(fa, reps, warmup=1)) / 2, name_b: tb / 2}


def bound_ms(flops: float, peak: float, nbytes: float):
    t_ops, t_bytes = flops / peak * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def peak_flops(dtype: torch.dtype) -> float:
    return H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS


def nbytes_of(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).split(".")[-1]


def error_distribution(got: torch.Tensor, want: torch.Tensor, tol: float) -> dict:
    """max and mean abs error, and how many entries lie above half the bound."""
    diff = (got - want).abs()
    return {"max_abs_err": float(diff.max().item()), "mean_abs_err": float(diff.mean().item()),
            "above_half_tol": int((diff > tol / 2).sum().item()), "entries": diff.numel()}


def ptxas_summary(log: str) -> list:
    """Each kernel of an `nvcc -Xptxas -v` log: [name, registers, spill stores
    and spill loads in bytes], the name demangled enough to read."""
    rows, name = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
            # the kernel's own name follows its length, after the namespace
            m = re.search(r"(?:_cu_[0-9a-f]{8}|4attn)(\d+)", name)
            if m:
                name = name[m.end():m.end() + int(m.group(1))] + name[m.end() + int(m.group(1)):][:12]
        elif "spill stores" in ln and name:
            words = ln.split()
            rows.append([name[:60], None, int(words[words.index("spill") - 2]), int(words[-4])])
        elif "Used" in ln and "registers" in ln and rows and rows[-1][1] is None:
            words = ln.split()
            rows[-1][1] = int(words[words.index("registers,") - 1])
    return rows


def make_corpus(n: int, dim: int, seed: int) -> torch.Tensor:
    """Clustered item features on the CPU: 256 centers, unit per-item noise."""
    g = torch.Generator().manual_seed(seed)
    centers = torch.randn(256, dim, generator=g)
    return centers[torch.randint(0, 256, (n,), generator=g)] + torch.randn(n, dim, generator=g)


def init_codebooks_from_data(rq, x: torch.Tensor, seed: int) -> None:
    """Seed each level's codebook with residuals of random corpus items,
    jittered, so the index holds many distinct tuples (U(0, 1) codebooks on
    a random encoder send most items to one code) and no two codewords, nor
    a codeword and an item's residual, coincide (which would tie argmins
    exactly)."""
    g = torch.Generator().manual_seed(seed)
    K = rq.config.codebook_size
    with torch.no_grad():
        res = rq.encode(x[torch.randperm(x.shape[0], generator=g)[:8192].to(x.device)])
        for level in range(rq.config.n_layers):
            cb = res[torch.randperm(res.shape[0], generator=g)[:K].to(x.device)]
            cb = cb + 0.1 * res.std() * torch.randn(cb.shape, generator=g).to(x.device)
            rq.codebooks[level].copy_(cb)
            res = res - cb[torch.cdist(res, cb).argmin(1)]


def f64_near_tie_rows(x, weights, codebooks) -> torch.Tensor:
    """Rows where some level's top-2 L2 distance gap, in float64 along the
    float64 argmin path, is below ID_NEAR_TIE of ||res||^2 + max ||c||^2
    (f32 rounding moves a distance by ~1e-7 of that)."""
    h = x.double()
    for i, w in enumerate(weights):
        h = h @ w.double()
        if i != len(weights) - 1:
            h = torch.relu(h)
    near = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    cbs = codebooks.double()
    for level in range(cbs.shape[0]):
        d = torch.cdist(h, cbs[level]) ** 2
        top2 = torch.topk(d, 2, dim=1, largest=False)
        scale = (h * h).sum(1) + (cbs[level] ** 2).sum(1).max()
        near |= (top2.values[:, 1] - top2.values[:, 0]) < ID_NEAR_TIE * scale
        h = h - cbs[level][top2.indices[:, 0]]
    return near


def histories(n_items: int, length: int, seed: int) -> np.ndarray:
    """BATCH histories of `length` item ids, each 1..length long, -1 padded."""
    r = np.random.RandomState(seed)
    ids = r.randint(0, n_items, (BATCH, length))
    lengths = r.randint(1, length + 1, BATCH)
    return np.where(np.arange(length)[None, :] < lengths[:, None], ids, -1).astype(np.int32)


def profile_call(fn, top: int = 8, by_name: bool = False) -> dict:
    """Device time of one call of `fn` by kernel (torch.profiler, CUPTI),
    after one warm call and a warm-up step inside the profiler (without it
    the first kernels of the window can go missing): the call's host time,
    the summed device time and launch count, the device's idle share of the
    call, the `top` kernels by device time, and if `by_name` the count of
    each kernel by name, device copies and memsets under one name (host
    transfers apart). The schedule's `ProfilerStep*` row is a device row
    spanning the whole step, not a launch: it is left out."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        prof.step()
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and not e.key.startswith("ProfilerStep")]
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    device_ms = sum(e.self_device_time_total for e in rows) / 1e3
    out = {
        "host_ms": host_ms, "device_ms": device_ms, "device_launches": sum(e.count for e in rows),
        "device_idle_share": max(0.0, 1.0 - device_ms / host_ms) if host_ms else None,
        "kernels": [{"name": e.key[:60], "count": e.count, "ms": e.self_device_time_total / 1e3}
                    for e in rows[:top]],
    }
    if not by_name:
        return out
    names, transfers = {}, 0
    for e in rows:
        if "HtoD" in e.key or "DtoH" in e.key:
            transfers += e.count
            continue
        key = DEVICE_COPY if e.key.lower().startswith(("memcpy", "memset")) else e.key
        names[key] = names.get(key, 0) + e.count
    return {**out, "names": names, "transfers": transfers}


def make_rqvae(geo: dict, dev):
    """The geometry's RQ-VAE with data-seeded codebooks, and its corpus on the
    CPU and on `dev`."""
    from rqvae_tpu_torch.models.quantize import QuantizeForwardMode
    from rqvae_tpu_torch.models.rqvae import RqVae, RqVaeConfig

    vcfg = RqVaeConfig(input_dim=geo["input_dim"], embed_dim=geo["embed_dim"], hidden_dims=(512, 256, 128),
                       codebook_size=256, n_layers=3, codebook_mode=QuantizeForwardMode.STE)
    x_cpu = make_corpus(geo["items"], vcfg.input_dim, seed=0)
    x = x_cpu.to(dev)
    rq = RqVae(vcfg, device=dev, seed=0)
    init_codebooks_from_data(rq, x, seed=1)
    return rq, x_cpu, x


def retrieval_model(dtype: str, dev, **over):
    from rqvae_tpu_torch.models.retrieval import EncoderDecoderRetrievalModel, RetrievalConfig

    cfg = RetrievalConfig(num_hierarchies=3, codebook_size=256, t5_d_model=384, t5_d_kv=64, t5_num_heads=6,
                          t5_d_ff=1024, t5_num_layers=4, top_k_for_generation=10, should_add_sep_token=True,
                          t5_dtype=dtype, **over)
    return EncoderDecoderRetrievalModel(cfg, device=dev, seed=2)


def rq_encode_layout(x: torch.Tensor, weights, cbs, precision: str) -> dict:
    """Kernel 1's route for these operands, its rows per block and the shared
    memory a block asks for (from the library), and ptxas's registers and
    spills for each kernel-1 kernel."""
    import ctypes

    from rqvae_tpu_torch.ops.cuda import rq_encode as R

    dims, K = [x.shape[1], *(w.shape[1] for w in weights)], cbs.shape[1]
    route = R.rq_encode_route(dims, K, dims[-1], precision)
    widths, kp = R.prepared_widths(dims, K)
    lib = R._library()
    smem = lib.rq_encode_smem_bytes((ctypes.c_int * len(widths))(*widths), len(weights), kp, R.ROUTES.index(route))
    return {"route": route, "rows_per_block": lib.rq_encode_rows_per_block(), "smem_bytes": smem,
            "ptxas": PTXAS.get("rq_encode")}


def rq_encode_phase(phase: str, rq, x: torch.Tensor):
    """rq_encode kernel against its plain version over the corpus `x`; returns
    the kernel's row of the `kernels` line and the near-tie rows."""
    from rqvae_tpu_torch.ops.cuda.rq_encode import fused_encode_quantize, fused_encode_quantize_plain

    n = x.shape[0]
    with torch.no_grad():
        weights, cbs = rq.encoder.kernels(), rq.codebooks.detach()
        got = fused_encode_quantize(x, weights, cbs, 3, precision="f32")
        sync()
        want = fused_encode_quantize_plain(x, weights, cbs, 3, precision="f32")
        near = f64_near_tie_rows(x, weights, cbs)
        differ = (got != want).any(1)
        outside = differ & ~near
        check(int(outside.sum()) == 0, f"{phase}: {int(outside.sum())} rows differ away from near-ties")
        enc_ms = cuda_ms(lambda: fused_encode_quantize(x, weights, cbs, 3, precision="f32"), reps=20)
        enc_plain_ms = cuda_ms(lambda: fused_encode_quantize_plain(x, weights, cbs, 3, precision="f32"), reps=20)
    K, D = cbs.shape[1], cbs.shape[2]
    macs = sum(w.shape[0] * w.shape[1] for w in weights) + 3 * K * D
    b_ms, b_by = bound_ms(2 * n * macs, H100_F32_FLOPS, nbytes_of(x, *weights, cbs, got))
    row = {
        "name": "rq_encode", "route": "cuda", "source": "rqvae_tpu_torch/csrc/rq_encode.cu",
        "replaces": "rqvae_tpu/ops/pallas/rq_encode.py:137",
        "max_abs_err": float((got - want)[~near].abs().max().item()) if (~near).any() else 0.0,
        "ms": enc_ms, "plain_ms": enc_plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }
    layout = rq_encode_layout(x, weights, cbs, "f32")
    check(layout["route"] == "cuda_cores", f"{phase}: float32 took {layout['route']}")
    emit({"phase": phase, "items": n, "widths": [x.shape[1], *(w.shape[1] for w in weights)], **layout,
          "rows_differ": int(differ.sum()), "near_tie_rows": int(near.sum()),
          "differ_outside_near_ties": int(outside.sum()),
          "kernel_ms": enc_ms, "plain_ms": enc_plain_ms, "bound_ms": b_ms, "bound_by": b_by})
    return row, near


def bf16_ulp(v):
    """One bf16 step at each value of v (float64): 2^(floor(log2 |v|) - 7); 0 at 0."""
    return torch.exp2(torch.floor(torch.log2(v.abs())) - 7)


def bf16_near_tie_rows(x, weights, codebooks):
    """Rows where some level's top-2 distance gap, in float64 along the bf16
    path (kernel 1's rounding points), is within the most that one bf16 step
    of every element of the level's residual can move it,
    2 sum_i ulp(res_i) |c1_i - c2_i|: a float32 sum taken in another order
    can move a value across a bf16 rounding boundary, one bf16 step."""
    r16 = lambda t: t.to(torch.bfloat16).double()
    h = r16(x.double())
    for i, w in enumerate(weights):
        h = h @ r16(w.double())
        h = r16(torch.relu(h) if i != len(weights) - 1 else h)
    cb32 = codebooks.double()
    cb, cb2 = r16(cb32), (cb32 ** 2).sum(-1)
    near = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    for level in range(cb.shape[0]):
        top2 = torch.topk(cb2[level][None] - 2 * h @ cb[level].T, 2, dim=1, largest=False)
        c1, c2 = cb[level][top2.indices[:, 0]], cb[level][top2.indices[:, 1]]
        near |= top2.values[:, 1] - top2.values[:, 0] <= 2 * (bf16_ulp(h) * (c1 - c2).abs()).sum(1)
        h = r16(h - c1)
    return near


def tc_sum_model_ids(x, weights, codebooks) -> torch.Tensor:
    """Kernel 1's bf16 ids as its tensor-core route sums them, modelled in
    float64: each k step's products (8 deep in the first layer, 16 after)
    summed exactly and rounded toward zero to float32, as the tensor cores
    round their sums, and the steps added in float32 in ascending k."""
    r16 = lambda t: t.to(torch.bfloat16).float()

    def rz(v):
        f = v.float()
        return torch.where(f.double().abs() > v.abs(), torch.nextafter(f, torch.zeros_like(f)), f)

    def mm(a, b, step):
        acc = torch.zeros(a.shape[0], b.shape[1], device=a.device)
        for k0 in range(0, a.shape[1], step):
            acc = acc + rz(a[:, k0:k0 + step].double() @ b[k0:k0 + step].double())
        return acc

    h = r16(x)
    for i, w in enumerate(weights):
        h = mm(h, r16(w), 8 if i == 0 else 16)
        h = r16(torch.relu(h) if i != len(weights) - 1 else h)
    cb32 = codebooks.float()
    cb2, cb = (cb32 * cb32).sum(-1), r16(cb32)
    ids = []
    for level in range(cb.shape[0]):
        idx = (cb2[level][None] - 2.0 * mm(h, cb[level].T.contiguous(), 16)).argmin(-1)
        h = r16(h - cb[level][idx])
        ids.append(idx.to(torch.int32))
    return torch.stack(ids, 1)


def integer_bf16_case(seed: int, n: int = 512, k: int = 16, d: int = 8):
    """Integer-valued x, weights and codebooks whose float32 sums are exact in
    any order and whose bf16 roundings change values, so kernel 1's bf16 ids
    are a function of its rounding points alone (odd codewords, mostly not
    bf16 values; one duplicated, an exact tie the lower index takes)."""
    from rqvae_tpu_torch.ops.cuda.rq_encode import round_bf16

    r = np.random.RandomState(seed)
    x = torch.from_numpy(r.randint(-3, 4, (n, 32)).astype(np.float32))
    weights = [torch.from_numpy(r.randint(-a, a + 1, shape).astype(np.float32))
               for a, shape in ((3, (32, 24)), (2, (24, 16)), (1, (16, d)))]
    h = x
    for i, w in enumerate(weights):
        h = round_bf16(torch.relu(h @ w) if i < 2 else h @ w)
    cbs = []
    for _ in range(3):
        cb = h[torch.from_numpy(r.choice(n, k, replace=False))] + torch.from_numpy(r.randint(-20, 21, (k, d))).float()
        cb = torch.where(cb % 2 == 0, cb + 1, cb)
        cb[k - 3] = cb[2]
        cbs.append(cb)
        dist = (cb * cb).sum(-1)[None] - 2 * h @ round_bf16(cb).T
        h = round_bf16(h - round_bf16(cb)[dist.argmin(-1)])
    return x, weights, torch.stack(cbs)


def integer_bf16_case_wide(seed: int, n: int = 1024, widths=(768, 512, 256, 128, 32), k: int = 256):
    """integer_bf16_case at the Amazon widths, which take the tensor-core
    route: x in {-1, 0, 1}, sparse weights in {-1, 0, 1} (one entry in 4, 16,
    16 and 32 nonzero, so every float32 sum stays below 2^24 and is exact in
    any order and alignment, while layer outputs pass 256 and bf16 rounds
    them), codewords odd integers near residuals (one duplicated)."""
    from rqvae_tpu_torch.ops.cuda.rq_encode import round_bf16

    r = np.random.RandomState(seed)
    x = torch.from_numpy(r.randint(-1, 2, (n, widths[0])).astype(np.float32))
    weights = []
    for (a, b), every in zip(zip(widths[:-1], widths[1:]), (4, 16, 16, 32)):
        w = r.randint(-1, 2, (a, b)) * (r.randint(0, every, (a, b)) == 0)
        weights.append(torch.from_numpy(w.astype(np.float32)))
    h = x
    for i, w in enumerate(weights):
        h = round_bf16(torch.relu(h @ w) if i < len(weights) - 1 else h @ w)
    cbs = []
    for _ in range(3):
        cb = h[torch.from_numpy(r.choice(n, k, replace=False))]
        cb = cb + torch.from_numpy(r.randint(-200, 201, (k, widths[-1]))).float()
        cb = torch.where(cb % 2 == 0, cb + 1, cb)
        cb[k - 3] = cb[2]
        cbs.append(cb)
        dist = (cb * cb).sum(-1)[None] - 2 * h @ round_bf16(cb).T
        h = round_bf16(h - round_bf16(cb)[dist.argmin(-1)])
    return x, weights, torch.stack(cbs)


def rq_encode_bf16_phase(phase: str, rq, x: torch.Tensor, dev) -> dict:
    """rq_encode in bf16 (the index build's default) against its plain bf16
    version over the corpus `x`, the integer-valued case bit for bit, two
    launches bit-equal, and the index build in bf16 beside f32; returns the
    numbers for the kernel's row of the `kernels` line."""
    from rqvae_tpu_torch.ops.cuda.rq_encode import fused_encode_quantize, fused_encode_quantize_plain

    n = x.shape[0]
    with torch.no_grad():
        weights, cbs = rq.encoder.kernels(), rq.codebooks.detach()
        got = fused_encode_quantize(x, weights, cbs, 3, precision="bf16")
        again = fused_encode_quantize(x, weights, cbs, 3, precision="bf16")
        sync()
        check(torch.equal(got, again), f"{phase}: two launches differ")
        want = fused_encode_quantize_plain(x, weights, cbs, 3, precision="bf16")
        near = bf16_near_tie_rows(x, weights, cbs)
        differ = (got != want).any(1)
        outside = differ & ~near
        check(int(outside.sum()) == 0, f"{phase}: {int(outside.sum())} rows differ outside the bf16 near-ties")
        model_differ = int((got != tc_sum_model_ids(x, weights, cbs)).any(1).sum())  # reported, not gated
        f32_ids = fused_encode_quantize(x, weights, cbs, 3, precision="f32")
        exact = {}
        for case, make in (("", integer_bf16_case), ("amazon_widths_", integer_bf16_case_wide)):
            for seed in (0, 2):
                xi, wi, ci = make(seed)
                k_ids = fused_encode_quantize(xi.to(dev), [w.to(dev) for w in wi], ci.to(dev), 3, precision="bf16")
                want_i = fused_encode_quantize_plain(xi, wi, ci, 3, precision="bf16")
                exact[f"{case}{seed}"] = bool(torch.equal(k_ids.cpu(), want_i))
        check(all(exact.values()), f"{phase}: integer-valued inputs differ from the plain version: {exact}")
        wide = rq_encode_layout(xi, wi, ci, "bf16")["route"]
        check(wide == "tensor_cores", f"{phase}: the Amazon-width integer case took {wide}")
        k_ms = cuda_ms(lambda: fused_encode_quantize(x, weights, cbs, 3, precision="bf16"), reps=20)
        p_ms = cuda_ms(lambda: fused_encode_quantize_plain(x, weights, cbs, 3, precision="bf16"), reps=20)
    K, D = cbs.shape[1], cbs.shape[2]
    macs = sum(w.shape[0] * w.shape[1] for w in weights) + 3 * K * D
    b_ms, b_by = bound_ms(2 * n * macs, H100_BF16_FLOPS, nbytes_of(x, *weights, cbs, got))
    index_ms = {prec: build_index(rq, x, dev, precision=prec)[2] for prec in ("bf16", "f32", "bf16", "f32")}
    layout = rq_encode_layout(x, weights, cbs, "bf16")
    check(layout["route"] == "tensor_cores", f"{phase}: bf16 took {layout['route']}")
    emit({"phase": phase, "items": n, "widths": [x.shape[1], *(w.shape[1] for w in weights)], **layout,
          "rows_differ": int(differ.sum()), "bf16_near_tie_rows": int(near.sum()),
          "differ_outside_near_ties": int(outside.sum()),
          "rows_differ_from_f32": int((got != f32_ids).any(1).sum()), "rows_differ_from_sum_model": model_differ,
          "integer_case_bit_equal": exact,
          "bit_equal_repeat": True, "kernel_ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
          "index_build_ms_bf16": index_ms["bf16"], "index_build_ms_f32": index_ms["f32"]})
    return {"bf16_ms": k_ms, "bf16_plain_ms": p_ms, "bf16_bound_ms": b_ms, "bf16_bound_by": b_by,
            "bf16_rows_differ": int(differ.sum()), "bf16_near_tie_rows": int(near.sum())}


def attention_inputs(B, H, L, dk, dtype, dev, seed):
    """Random q, k, v, bias and ragged key masks; row 0 has every key masked."""
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(B, H, L, dk, generator=g).to(dtype).to(dev) for _ in range(3))
    bias = torch.randn(H, L, L, generator=g).to(dev)
    lengths = torch.randint(1, L + 1, (B,), generator=g)
    mask = (torch.arange(L)[None, :] < lengths[:, None]).to(torch.int32)
    mask[0] = 0
    return q, k, v, bias, mask.to(dev)


def attention_phase(dev) -> dict:
    """attention kernel against its plain version at the long-row shape and
    at the Amazon training shape; returns the kernel's row of the `kernels`
    line (bf16, no dropout at the long-row shape: what the fused_encode="off"
    route launches; the Amazon shape's numbers beside it)."""
    from rqvae_tpu_torch.ops.cuda.attention import attention_route, t5_attention, t5_attention_plain

    H, L, dk = 6, ML32M["history"] * 4, 64
    seed = torch.tensor([77], dtype=torch.int32, device=dev)  # the seed in device memory, as training passes it
    rows, kernel_row, amazon = [], None, {}
    L_am = AMAZON["history"] * 4
    cases = [(dt, B, Lc, False, rate) for B, Lc in ((BATCH, L), (TRAIN_AMAZON["batch"], L_am))
             for dt in (torch.float32, torch.bfloat16) for rate in (0.0, 0.1)]
    cases.append((torch.bfloat16, 8, 512, True, 0.0))
    with torch.no_grad():
        for dt, B, Lc, causal, rate in cases:
            q, k, v, bias, mask = attention_inputs(B, H, Lc, dk, dt, dev, seed=5)
            kw = dict(causal=causal, dropout_rate=rate)
            got = t5_attention(q, k, v, bias, mask, seed, **kw)
            sync()
            want = t5_attention_plain(q, k, v, bias, mask, seed, **kw)
            err = float((got.float() - want.float()).abs().max().item())
            what = f"attention {dtype_name(dt)} L={Lc} causal={causal} rate={rate}"
            check(got.dtype == dt and bool(torch.isfinite(got).all()), f"{what}: non-finite output")
            check(bool(torch.isfinite(got[0]).all()), f"{what}: the fully masked row is not finite")
            check(err <= ATTENTION_TOL[dt], f"{what}: max abs err {err}")
            k_ms = cuda_ms(lambda: t5_attention(q, k, v, bias, mask, seed, **kw), reps=5, warmup=1)
            p_ms = cuda_ms(lambda: t5_attention_plain(q, k, v, bias, mask, seed, **kw), reps=2, warmup=1)
            b_ms, b_by = bound_ms(4 * B * H * Lc * Lc * dk, peak_flops(dt), nbytes_of(q, k, v, got, bias, mask))
            row = {"dtype": dtype_name(dt), "B": B, "L": Lc, "causal": causal, "dropout_rate": rate,
                   "route": attention_route(Lc, Lc, dk, dt), "max_abs_err": err, "tol": ATTENTION_TOL[dt],
                   "kernel_ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by}
            if not causal and rate == 0.0:
                # the yardstick: one library call of the same function (timed here, used nowhere in the port)
                add = (bias[None] + torch.where(mask != 0, 0.0, -1e9)[:, None, None, :]).to(dt)
                lib = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=add, scale=1.0)
                # row 0 (every key masked) left out: the call adds bias + mask before the scores
                lib_err = float((lib()[1:].float() - want[1:].float()).abs().max().item())
                row.update(library_ms=cuda_ms(lib, reps=5, warmup=1), library_max_abs_err=lib_err)
                del add
                if dt == torch.bfloat16 and Lc == L:
                    kernel_row = {
                        "name": "attention", "route": "cuda", "source": "rqvae_tpu_torch/csrc/attention.cu",
                        "replaces": "rqvae_tpu/ops/pallas/attention.py:184", "max_abs_err": err,
                        "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": row["library_ms"], "ml32m_route": row["route"], "ml32m_ms": k_ms,
                    }
            if dt == torch.bfloat16 and Lc == L_am:
                amazon[rate] = row
            rows.append(row)
            del q, k, v, bias, mask, got, want
    emit({"phase": "attention", "H": H, "dk": dk, "rows": rows, "device_seed_keep_bits": device_seed_keep_bits(dev)})
    # the Amazon training shape: dropout 0.1, as the training forward runs it; the bound and the
    # library's time there without dropout (the one library call has none)
    kernel_row.update(amazon_route=amazon[0.1]["route"], amazon_ms=amazon[0.1]["kernel_ms"],
                      amazon_plain_ms=amazon[0.1]["plain_ms"], amazon_max_abs_err=amazon[0.1]["max_abs_err"],
                      amazon_bound_ms=amazon[0.1]["bound_ms"], amazon_bound_by=amazon[0.1]["bound_by"],
                      amazon_no_dropout_ms=amazon[0.0]["kernel_ms"], amazon_library_ms=amazon[0.0]["library_ms"])
    return kernel_row


def device_seed_keep_bits(dev) -> dict:
    """Kernels 4 and 5 with the seed as a 1-element int32 tensor on the card:
    the keep bits each applies, read off identity blocks (forward: with v the
    identity on keys 0..63, out[..., :64] is the dropped p of those keys;
    backward, hashing its bits itself: with dout the identity on queries
    0..63, dv^T[:, :, :64] is the dropped p of those queries), against
    attention_keep_mask's bits from the same tensor on unmasked keys; bf16 at
    L = 80 (whole rows) and 800 (tiled), f32 (CUDA cores) at 80. Seeds 77,
    78 and 2^31 + 5 (a negative int32, the reference's uint32 bits): each
    equal to the plain version's bits, 77 and 78 different from each other.
    Then seed 77 with b0 = B (the launch's rows are global rows B .. 2B - 1,
    as a data-parallel rank's): equal to attention_keep_mask's bits at b0 =
    B, and other bits than at b0 = 0."""
    from rqvae_tpu_torch.ops.cuda import attention as A
    from rqvae_tpu_torch.ops.hash_dropout import attention_keep_mask

    rate, B, H = 0.1, 2, 3
    seeds = torch.tensor([77, 78, -(2**31) + 5], dtype=torch.int32, device=dev)
    rows = []
    for dt, L in ((torch.bfloat16, 80), (torch.bfloat16, 800), (torch.float32, 80)):
        g = torch.Generator().manual_seed(4)
        q, k = (0.5 * torch.randn(B, H, L, 64, generator=g)).to(dt).to(dev), \
            (0.5 * torch.randn(B, H, L, 64, generator=g)).to(dt).to(dev)
        bias = (0.1 * torch.randn(H, L, L, generator=g)).to(dev)
        mask = (torch.rand(B, L, generator=g) > 0.2).to(torch.int32).to(dev)
        eye = torch.zeros(L, 64)
        eye[torch.arange(64), torch.arange(64)] = 1.0
        eye = eye.to(dt).to(dev).expand(B, H, L, 64).contiguous()
        keys = mask.bool()[:, None, None, :]
        kernel_bits, same = [], []
        for i in range(3):
            s = seeds[i:i + 1]
            want = attention_keep_mask(s, B, H, L, L, rate, dev)
            with torch.no_grad():
                out, m, l, _ = A._forward_cuda(q, k, eye, bias, mask, s, False, rate, True)
                dv = A._backward_cuda(q, k, eye, bias, mask, s, eye, m, l, False, rate)[2]
            fwd = (out != 0) & keys[..., :64]
            bwd = (dv.transpose(-1, -2) != 0) & keys
            same.append(bool(torch.equal(fwd, want[..., :64] & keys[..., :64]))
                        and bool(torch.equal(bwd, want[:, :, :64, :] & keys)))
            kernel_bits.append(fwd)
        differ = not torch.equal(kernel_bits[0], kernel_bits[1])
        want = attention_keep_mask(seeds[:1], B, H, L, L, rate, dev, b0=B)
        with torch.no_grad():
            out, m, l, _ = A._forward_cuda(q, k, eye, bias, mask, seeds[:1], False, rate, True, b0=B)
            dv = A._backward_cuda(q, k, eye, bias, mask, seeds[:1], eye, m, l, False, rate, b0=B)[2]
        fwd_b0 = (out != 0) & keys[..., :64]
        same_b0 = (bool(torch.equal(fwd_b0, want[..., :64] & keys[..., :64]))
                   and bool(torch.equal((dv.transpose(-1, -2) != 0) & keys, want[:, :, :64, :] & keys)))
        differ_b0 = not torch.equal(fwd_b0, kernel_bits[0])
        what = f"device seed keep bits {dtype_name(dt)} L={L} ({A.attention_route(L, L, 64, dt)})"
        check(all(same), f"{what}: kernel bits against the plain version's for seeds 77, 78, 2^31 + 5: {same}")
        check(differ, f"{what}: seeds 77 and 78 keep the same bits")
        check(same_b0, f"{what}: kernel bits at b0 = {B} against the plain version's")
        check(differ_b0, f"{what}: b0 = {B} keeps the bits of b0 = 0")
        rows.append({"dtype": dtype_name(dt), "L": L, "route": A.attention_route(L, L, 64, dt),
                     "equal_to_plain": same, "seeds_77_78_differ": differ, "b0": B,
                     "b0_equal_to_plain": same_b0, "b0_differs_from_0": differ_b0,
                     "kept_share": float(kernel_bits[0].sum()) / float(keys[..., :64].expand_as(fwd).sum())})
    return {"seeds": [77, 78, 2**31 + 5], "rate": rate, "rows": rows}


def attention_b0_phase(dev) -> dict:
    """Kernels 4 and 5 launched with b0 = B, the first global row of a
    data-parallel rank that holds B rows, at both attention geometries
    ([640, 6, 80, 64], whole rows; [64, 6, 800, 64], key tiles; bf16 and f32,
    dropout 0.1): the output and dq, dk, dv are bit-equal to rows B .. 2B - 1
    of the same launches over the batch doubled at b0 = 0 (the global batch
    whose slice the rank holds; dbias sums over the rows, so it is held to
    the plain version only); they are within the attention tolerances of the
    plain versions at b0 = B, and other than at b0 = 0. Returns each row with
    the kernels' times at b0 = 0 and b0 = B (bf16 rows: the training
    geometries' dtype)."""
    from rqvae_tpu_torch.ops.cuda import attention as A

    H, dk, rate = 6, 64, 0.1
    seed = torch.tensor([77], dtype=torch.int32, device=dev)
    rows = []
    for name, B, L in (("amazon", TRAIN_AMAZON["batch"], AMAZON["history"] * 4), ("ml32m", BATCH, ML32M["history"] * 4)):
        for dt in (torch.bfloat16, torch.float32):
            q, k, v, bias, mask, do = attention_bwd_inputs(B, H, L, dk, dt, dev, seed=6)
            what = f"attention b0 {name} {dtype_name(dt)}"

            def fwd(b0, ops=(q, k, v, mask)):
                return A._forward_cuda(ops[0], ops[1], ops[2], bias, ops[3], seed, False, rate, True, b0=b0)

            def bwd(b0, f, ops=(q, k, v, mask, do)):
                qq, kk, vv, mm, dd = ops
                return A._backward_cuda(qq, kk, vv, bias, mm, seed, dd, f[1], f[2], False, rate, keep_bits=f[3], b0=b0)

            with torch.no_grad():
                f_b, f_0 = fwd(B), fwd(0)
                g_b = bwd(B, f_b)
                doubled = tuple(torch.cat([t, t]) for t in (q, k, v, mask, do))
                f_2 = fwd(0, doubled[:4])
                g_2 = bwd(0, f_2, doubled)
                slice_equal = bool(torch.equal(f_b[0], f_2[0][B:])) and all(
                    torch.equal(a, b[B:]) for a, b in zip(g_b[:3], g_2[:3]))
                check(slice_equal, f"{what}: b0 = {B} differs from rows {B}.. of the doubled batch at b0 = 0")
                check(not torch.equal(f_b[0], f_0[0]), f"{what}: b0 = {B} gives the output of b0 = 0")
                want = A.t5_attention_plain(q, k, v, bias, mask, seed, dropout_rate=rate, b0=B)
                err = float((f_b[0].float() - want.float()).abs().max().item())
                check(err <= ATTENTION_TOL[dt], f"{what}: forward max abs err {err} against the plain version")
                errs = {}
                for gname, g, w in zip(("dq", "dk", "dv", "dbias"), g_b,
                                       A.t5_attention_backward_plain(q, k, v, bias, mask, seed, do,
                                                                     dropout_rate=rate, b0=B)):
                    top = float(w.float().abs().max().item())
                    gerr = float((g.float() - w.float()).abs().max().item())
                    tol = ATTENTION_BWD_TOL[dt][gname == "dbias"]
                    check(gerr <= tol * top, f"{what}: {gname} max abs err {gerr} over {tol} x {top}")
                    errs[gname] = gerr
                del doubled, f_2, g_2, want
                times = abba_ms("forward_ms_b0_0", lambda: fwd(0), "forward_ms_b0_B", lambda: fwd(B), reps=5)
                times.update(abba_ms("backward_ms_b0_0", lambda: bwd(0, f_0), "backward_ms_b0_B",
                                     lambda: bwd(B, f_b), reps=3))
            rows.append({"shape": name, "dtype": dtype_name(dt), "B": B, "L": L, "b0": B,
                         "route": A.attention_route(L, L, dk, dt), "backward_route":
                         A.attention_route(L, L, dk, dt, backward=True), "slice_of_doubled_bit_equal": slice_equal,
                         "forward_max_abs_err": err, "backward_max_abs_err": errs, **times})
            del q, k, v, bias, mask, do, f_b, f_0, g_b
            torch.cuda.empty_cache()
    emit({"phase": "attention_b0", "H": H, "dk": dk, "dropout_rate": rate, "rows": rows})
    return {r["shape"]: {k: r[k] for k in r if k.endswith("_ms_b0_0") or k.endswith("_ms_b0_B")}
            for r in rows if r["dtype"] == "bfloat16"}


def encoder_stack_phase(models: dict, dev) -> dict:
    """encoder_stack kernel against its plain version at the ML-32M rows, with
    each model's own encoder weights; two launches bit-equal; returns the bf16
    row of the `kernels` line."""
    from rqvae_tpu_torch.ops.cuda import encoder_stack as E
    from rqvae_tpu_torch.ops.cuda._build import load_library
    from rqvae_tpu_torch.ops.cuda.attention import attention_route
    from rqvae_tpu_torch.ops.cuda.encoder_stack import (encoder_stack_route, t5_encoder_stack_infer,
                                                        t5_encoder_stack_plain)

    lib = load_library("encoder_stack", E._FUNCTIONS)  # the shared memory a rows block asks for
    L = ML32M["history"] * 4
    g = torch.Generator().manual_seed(6)
    x = torch.randn(BATCH, L, 384, generator=g).to(dev)  # the scale of the N(0, 1) id embeddings
    lengths = torch.randint(1, ML32M["history"] + 1, (BATCH,), generator=g) * 4
    mask = (torch.arange(L)[None, :] < lengths[:, None]).to(torch.int32).to(dev)
    rows, kernel_row = [], None
    with torch.no_grad():
        for dt, model in models.items():
            enc = model.encoder
            cfg, eps = enc.cfg, enc.cfg.layer_norm_eps
            NL, H, dk, d, dff = cfg.num_layers, cfg.num_heads, cfg.d_kv, cfg.d_model, cfg.d_ff
            ops = enc.encode_operands(x, mask)
            y = t5_encoder_stack_infer(*ops, eps=eps)
            sync()
            y_again = t5_encoder_stack_infer(*ops, eps=eps)
            sync()
            y_plain = t5_encoder_stack_plain(*ops, eps=eps)
            tol, mean_tol = ENCODER_TOL[dt]
            errs = error_distribution(y, y_plain, tol)
            err, mean_err = errs["max_abs_err"], errs["mean_abs_err"]
            check(bool(torch.isfinite(y).all()), f"encoder_stack {dtype_name(dt)}: non-finite output")
            check(err <= tol and mean_err <= mean_tol,
                  f"encoder_stack {dtype_name(dt)}: max abs err {err}, mean {mean_err}")
            check(torch.equal(y, y_again), f"encoder_stack {dtype_name(dt)}: two launches differ")
            k_ms = cuda_ms(lambda: t5_encoder_stack_infer(*ops, eps=eps), reps=3, warmup=1)
            p_ms = cuda_ms(lambda: t5_encoder_stack_plain(*ops, eps=eps), reps=2, warmup=1)
            flops = 2 * BATCH * L * d * NL * (4 * H * dk + 2 * dff) + 2 * BATCH * NL * H * L * L * 2 * dk
            b_ms, b_by = bound_ms(flops, peak_flops(dt), nbytes_of(*ops, y))
            route = encoder_stack_route(d, dk, H * dk, dff, dt)
            rows.append({"dtype": dtype_name(dt), "route": route, "attention_route": attention_route(L, L, dk, dt),
                         "smem_bytes": lib.encoder_stack_smem_bytes(int(dt == torch.bfloat16), d, dk, H * dk, dff),
                         **errs, "tol": tol,
                         "mean_tol": mean_tol, "bit_equal": True, "kernel_ms": k_ms, "plain_ms": p_ms,
                         "bound_ms": b_ms, "bound_by": b_by, "flops": flops})
            if dt == torch.bfloat16:
                check(route == "tensor_cores", f"encoder_stack bf16 at the ML-32M widths takes the {route} route")
                kernel_row = {
                    "name": "encoder_stack", "route": "cuda", "source": "rqvae_tpu_torch/csrc/encoder_stack.cu",
                    "replaces": "rqvae_tpu/ops/pallas/encoder_stack.py:179", "max_abs_err": err,
                    "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                    "kernel_route": route,
                }
            del ops, y, y_again, y_plain
    emit({"phase": "encoder_stack", "B": BATCH, "L": L, "rows": rows})
    return kernel_row


def decoder_stack_phase(models: dict, rq, x, hist, dev) -> dict:
    """decoder_stack kernel against its plain version at the Amazon path's
    three levels; two launches bit-equal; returns the kernel's row of the
    `kernels` line."""
    from rqvae_tpu_torch.models.retrieval import strip_dedup_col
    from rqvae_tpu_torch.ops.cuda import decoder_stack as D
    from rqvae_tpu_torch.ops.cuda._build import load_library
    from rqvae_tpu_torch.ops.cuda.decoder_stack import (decoder_stack_route, t5_decoder_stack_infer,
                                                        t5_decoder_stack_plain)
    from rqvae_tpu_torch.tokenizer.semids import SemanticIdTokenizer, _tokenize_from_cache

    lib = load_library("decoder_stack", D._FUNCTIONS)  # the shared memory a block asks for

    def index(precision):
        tok = SemanticIdTokenizer(rq, device=dev, precision=precision)
        return tok.precompute_corpus_ids(x)

    def levels(model, cached_ids, g):
        """(beams, T, the decoder's operands) of the Amazon path's three levels."""
        h = torch.from_numpy(hist).to(dev)
        tok = _tokenize_from_cache(cached_ids, torch.zeros(BATCH, dtype=torch.int32, device=dev),
                                   h, torch.zeros(BATCH, dtype=torch.int32, device=dev), h >= 0)
        ids = strip_dedup_col(tok.sem_ids, 4, 3)
        mask = strip_dedup_col(tok.seq_mask.to(torch.int32), 4, 3)
        enc, enc_mask = model.encoder_forward(ids, mask)
        dec = model.decoder
        kv, w = dec.cross_kv(enc), dec.decode_weights()
        for beams, T in ((1, 1), (10, 2), (10, 3)):
            prefix = torch.randint(0, 256, (BATCH * beams, T - 1), generator=g).to(dev)
            embs = model._decoder_embs(prefix, BATCH * beams).reshape(BATCH, beams * T, -1)
            yield beams, T, dec.decode_operands(embs, kv, enc_mask, beams, w)

    f32_ids = index("f32")  # the histories' tokens as in every earlier run
    decoder_rows, kernel_row = [], None
    g = torch.Generator().manual_seed(4)
    for dt, model in models.items():
        with torch.no_grad():
            dec = model.decoder
            eps = dec.cfg.layer_norm_eps
            for beams, T, ops in levels(model, f32_ids, g):
                enc_rows = ops[14].shape[3]
                y = t5_decoder_stack_infer(*ops, eps=eps)
                sync()
                y_again = t5_decoder_stack_infer(*ops, eps=eps)
                sync()
                y_plain = t5_decoder_stack_plain(*ops, eps=eps)
                errs = error_distribution(y, y_plain, DECODER_TOL[dt])
                err = errs["max_abs_err"]
                check(bool(torch.isfinite(y).all()), f"decoder_stack {dt} kT={beams * T}: non-finite output")
                check(err <= DECODER_TOL[dt], f"decoder_stack {dt} kT={beams * T}: max abs err {err}")
                check(torch.equal(y, y_again), f"decoder_stack {dt} kT={beams * T}: two launches differ")
                k_ms = cuda_ms(lambda: t5_decoder_stack_infer(*ops, eps=eps), reps=10)
                p_ms = cuda_ms(lambda: t5_decoder_stack_plain(*ops, eps=eps), reps=10)
                kt, cfg = beams * T, dec.cfg
                NL, H, dk, d, dff, Le = cfg.num_layers, cfg.num_heads, cfg.d_kv, cfg.d_model, cfg.d_ff, enc_rows
                flops = 2 * BATCH * kt * NL * (6 * d * H * dk + 2 * d * dff) + 4 * BATCH * NL * H * kt * (kt + Le) * dk
                b_ms, b_by = bound_ms(flops, peak_flops(dt), nbytes_of(*ops, y))
                route = decoder_stack_route(kt, d, dk, H * dk, dff, Le, dt)
                if dt == torch.bfloat16:
                    check(route == "tensor_cores", f"decoder_stack bf16 kT={kt} takes the {route} route")
                decoder_rows.append({"dtype": dtype_name(dt), "kT": kt, "route": route,
                                     "blocks_per_row": 2 if route == "tensor_cores" else 1,
                                     "smem_bytes": lib.decoder_stack_smem_bytes(int(dt == torch.bfloat16), kt, d, dk,
                                                                                H * dk, dff, Le), **errs,
                                     "tol": DECODER_TOL[dt], "bit_equal": True, "kernel_ms": k_ms, "plain_ms": p_ms,
                                     "bound_ms": b_ms, "bound_by": b_by})
                if dt == torch.bfloat16 and kt == 30:  # the main path's largest level
                    kernel_row = {
                        "name": "decoder_stack", "route": "cuda",
                        "source": "rqvae_tpu_torch/csrc/decoder_stack.cu",
                        "replaces": "rqvae_tpu/ops/pallas/decoder_stack.py:231",
                        "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                        "bound_by": b_by, "library_ms": None, "kernel_route": route,
                        "ms_by_kT": {str(r["kT"]): r["kernel_ms"] for r in decoder_rows if r["dtype"] == "bfloat16"},
                    }
                del ops, y, y_again, y_plain
    # the bf16 levels once more, the histories tokenized by the bf16 index (the tokenizer's
    # default): reported beside the gate and not held to it (PERF.md section 7)
    bf16_index_rows = []
    model = models[torch.bfloat16]
    with torch.no_grad():
        for beams, T, ops in levels(model, index("bf16"), torch.Generator().manual_seed(4)):
            eps = model.decoder.cfg.layer_norm_eps
            y, y_plain = t5_decoder_stack_infer(*ops, eps=eps), t5_decoder_stack_plain(*ops, eps=eps)
            errs = error_distribution(y, y_plain, DECODER_TOL[torch.bfloat16])
            errs["above_tol"] = int(((y - y_plain).abs() > DECODER_TOL[torch.bfloat16]).sum())
            bf16_index_rows.append({"kT": beams * T, **errs})
    emit({"phase": "decoder_stack", "B": BATCH, "Le": enc_rows, "rows": decoder_rows,
          "bf16_rows_with_bf16_index_tokens": bf16_index_rows})
    return kernel_row


class LaunchCounts:
    """The wrappers' launch counters (the attention wrapper counts forwards
    and backwards apart): zeroed before a path, read after."""

    def __init__(self):
        from rqvae_tpu_torch.ops.cuda.attention import t5_attention
        from rqvae_tpu_torch.ops.cuda.decoder_stack import t5_decoder_stack_infer
        from rqvae_tpu_torch.ops.cuda.encoder_stack import t5_encoder_stack_infer
        from rqvae_tpu_torch.ops.cuda.rq_encode import fused_encode_quantize

        self.wrappers = {"rq_encode": fused_encode_quantize, "decoder_stack": t5_decoder_stack_infer,
                         "encoder_stack": t5_encoder_stack_infer, "attention": t5_attention}

    def zero(self) -> None:
        for fn in self.wrappers.values():
            fn.launches = 0
        self.wrappers["attention"].backward_launches = 0

    def read(self) -> dict:
        return {**{name: fn.launches for name, fn in self.wrappers.items()},
                "attention_bwd": self.wrappers["attention"].backward_launches}

    def restore(self, counts: dict) -> None:
        """Set the counters back to what `read` returned, dropping launches
        made since (those that hold a kernel against its plain version)."""
        for name, fn in self.wrappers.items():
            fn.launches = counts[name]
        self.wrappers["attention"].backward_launches = counts["attention_bwd"]


def retrieve_calls(retriever, hist):
    """CALLS retrieve() calls: their host-clock ms and their results."""
    call_ms, results = [], []
    for _ in range(CALLS):
        t0 = time.perf_counter()
        out = retriever.retrieve(hist)
        sync()
        call_ms.append((time.perf_counter() - t0) * 1e3)
        results.append(out)
    return call_ms, results


def check_results(results, cached_np: np.ndarray, batch: int) -> None:
    """Shapes, finite sorted log-probs, corpus-valid beams, repeated calls equal."""
    first = results[0].sem_ids.cpu().numpy()
    for out in results:
        items, sem, logp = out.item_ids.cpu().numpy(), out.sem_ids.cpu().numpy(), out.log_probas.cpu().numpy()
        check(items.shape == (batch, 10) and sem.shape == (batch, 10, 3), f"shapes {items.shape} {sem.shape}")
        check(bool(np.isfinite(logp).all()), "non-finite log_probas")
        check(bool((np.diff(logp, axis=1) <= 0).all()), "log_probas not sorted")
        valid = items >= 0
        check(bool(valid.any()), "no beam resolved to a corpus item")
        check(bool((cached_np[items[valid], :3] == sem[valid]).all()), "item_ids do not map to their sem_ids")
        check(bool(((logp > -1e8) == valid).all()), "a valid beam has no item, or an item has an invalid beam")
        check(bool((first == sem).all()), "repeated calls differ")


def build_index(rq, x, dev, precision: str = "bf16"):
    """SemanticIdTokenizer over the corpus (its default precision, bf16, unless
    told); the build's host-clock ms."""
    from rqvae_tpu_torch.tokenizer.semids import SemanticIdTokenizer

    sync()
    t0 = time.perf_counter()
    tok = SemanticIdTokenizer(rq, device=dev, precision=precision)
    cached = tok.precompute_corpus_ids(x)
    sync()
    return tok, cached, (time.perf_counter() - t0) * 1e3


def beams_same(a, b) -> float:
    """Share of queries whose beams are all identical."""
    return (a.sem_ids.cpu() == b.sem_ids.cpu()).all(2).all(1).float().mean().item()


def route_agreement(a, b) -> dict:
    """How far two routes' results agree: the share of queries with all beams
    identical, with the first beam identical, the mean share of a query's
    beams that the other route also returns, and the largest difference of
    the first beam's log-prob."""
    ia, ib = a.sem_ids.cpu(), b.sem_ids.cpu()
    in_b = (ia[:, :, None, :] == ib[:, None, :, :]).all(3).any(2)
    return {"all_beams_same": beams_same(a, b),
            "top1_same": (ia[:, 0] == ib[:, 0]).all(1).float().mean().item(),
            "beam_overlap": in_b.float().mean().item(),
            "top1_log_proba_max_abs_diff": float((a.log_probas[:, 0] - b.log_probas[:, 0]).abs().max().item())}


def card_vs_cpu(phase: str, rq, x_cpu, x, near, model_card, hist, dev, **over) -> None:
    """The path in f32: card (kernels) against CPU (plain versions), each with
    its own index (the card's built by the kernel in f32; the CPU's takes the
    model's f32 path)."""
    from rqvae_tpu_torch.models.rqvae import RqVae
    from rqvae_tpu_torch.serving.retriever import Retriever
    from rqvae_tpu_torch.tokenizer.semids import SemanticIdTokenizer

    tok = SemanticIdTokenizer(rq, device=dev, precision="f32")
    cached_np = tok.precompute_corpus_ids(x).cpu().numpy()
    rq_cpu = RqVae(rq.config, device="cpu")
    rq_cpu.load_state_dict({k: v.cpu() for k, v in rq.state_dict().items()})
    tok_cpu = SemanticIdTokenizer(rq_cpu, device="cpu")
    cached_cpu = tok_cpu.precompute_corpus_ids(x_cpu).numpy()
    near_np = near.cpu().numpy()
    id_differ = (cached_cpu[:, :3] != cached_np[:, :3]).any(1)
    check(not (id_differ & ~near_np).any(), f"{phase}: card and CPU index ids differ away from near-ties")
    model_cpu = retrieval_model("float32", "cpu", **over)
    card = Retriever(model_card, tok, device=dev).retrieve(hist)
    host = Retriever(model_cpu, tok_cpu, device="cpu").retrieve(hist)
    same = beams_same(card, host)
    logp_err = float((card.log_probas.cpu() - host.log_probas).abs().max().item())
    check(same >= BEAMS_SAME_MIN, f"{phase}: all beams identical on {same:.3f} of queries")
    emit({"phase": phase, "queries": int(hist.shape[0]), "index_rows_differ": int(id_differ.sum()),
          "index_rows_near_tie": int(near_np.sum()), "queries_all_beams_same": same,
          "log_probas_max_abs_diff": logp_err})


def attention_bwd_inputs(B, H, L, dk, dtype, dev, seed):
    q, k, v, bias, mask = attention_inputs(B, H, L, dk, dtype, dev, seed)
    do = torch.randn(B, H, L, dk, generator=torch.Generator().manual_seed(seed + 1)).to(dtype).to(dev)
    return q, k, v, bias, mask, do


def backward_p_equals_forward_p(dtype, dev, rate: float, causal: bool, L: int, blocks) -> bool:
    """With v the identity on keys 64j .. 64j + 63 and dout the identity on
    queries 64i .. 64i + 63 (dk = 64), the forward's out[64i:] and the
    backward's dv^T[:, 64j:] are the same 64 x 64 block of the rounded,
    dropped p: equal bits mean the backward rebuilt the forward's p exactly.
    L = 64 and 80 take the whole-row routes in bf16, L = 800 the tiled ones."""
    from rqvae_tpu_torch.ops.cuda import attention as A

    B, H = 3, 3
    g = torch.Generator().manual_seed(8)
    q, k = (torch.randn(B, H, L, 64, generator=g).to(dtype).to(dev) for _ in range(2))
    bias = torch.randn(H, L, L, generator=g).to(dev)
    mask = (torch.rand(B, L, generator=g) > 0.2).to(torch.int32).to(dev)

    def block_eye(j):
        e = torch.zeros(L, 64)
        idx = torch.arange(64 * j, min(L, 64 * j + 64))
        e[idx, idx - 64 * j] = 1.0
        return e.to(dtype).to(dev).expand(B, H, L, 64).contiguous()

    same = True
    for i, j in blocks:
        v, do = block_eye(j), block_eye(i)
        out, m, l, bits = A._forward_cuda(q, k, v, bias, mask, 9, causal, rate, True)
        dv = A._backward_cuda(q, k, v, bias, mask, 9, do, m, l, causal, rate, keep_bits=bits)[2]
        rows, cols = slice(64 * i, min(L, 64 * i + 64)), slice(64 * j, min(L, 64 * j + 64))
        n_r, n_c = rows.stop - rows.start, cols.stop - cols.start
        same &= bool(torch.equal(dv.transpose(-1, -2)[:, :, :n_r, cols], out[:, :, rows, :n_c]))
    return same


def attention_bwd_phase(dev):
    """attention backward kernel against its plain version at the two training
    shapes; returns its row of the `kernels` line (bf16, dropout 0.1, the
    Amazon shape: what every encoder layer of an Amazon step launches) and
    the forward kernel's time at that shape."""
    from rqvae_tpu_torch.ops.cuda import attention as A

    H, dk = 6, 64
    seed = torch.tensor([77], dtype=torch.int32, device=dev)  # the seed in device memory, as training passes it
    shapes = {"amazon": (TRAIN_AMAZON["batch"], AMAZON["history"] * 4), "ml32m": (TRAIN_ML32M["batch"], ML32M["history"] * 4)}
    cases = [(name, dt, False, rate) for name in shapes for dt in (torch.float32, torch.bfloat16) for rate in (0.0, 0.1)]
    cases.append(("amazon", torch.bfloat16, True, 0.1))
    rows, kernel_row, fwd_amazon = [], None, {}
    for name, dt, causal, rate in cases:
        B, L = shapes[name]
        q, k, v, bias, mask, do = attention_bwd_inputs(B, H, L, dk, dt, dev, seed=5)
        kw = dict(causal=causal, dropout_rate=rate)
        what = f"attention_bwd {name} {dtype_name(dt)} causal={causal} rate={rate}"
        with torch.no_grad():
            out, m, l, bits = A._forward_cuda(q, k, v, bias, mask, seed, causal, rate, True)
            run = lambda: A._backward_cuda(q, k, v, bias, mask, seed, do, m, l, causal, rate, keep_bits=bits)
            got = run()
            sync()
            again = run()
            if bits is not None:  # the forward's keep bits are the hash's: the same gradients, bit for bit
                hashed = A._backward_cuda(q, k, v, bias, mask, seed, do, m, l, causal, rate)
                check(all(torch.equal(a, b) for a, b in zip(got, hashed)),
                      f"{what}: the backward with the forward's keep bits differs from the one that hashes them")
                del hashed
            want = A.t5_attention_backward_plain(q, k, v, bias, mask, seed, do, **kw)
            check(bool(torch.equal(out, A.t5_attention(q, k, v, bias, mask, seed, **kw))),
                  f"{what}: the forward that writes its row statistics differs from the forward")
            errs = {}
            for gname, g, a, w in zip(("dq", "dk", "dv", "dbias"), got, again, want):
                check(bool(torch.isfinite(g).all()), f"{what}: non-finite {gname}")
                check(bool(torch.equal(g, a)), f"{what}: two launches give different {gname}")
                top = float(w.float().abs().max().item())
                err = float((g.float() - w.float()).abs().max().item())
                tol = ATTENTION_BWD_TOL[dt][gname == "dbias"]
                check(err <= tol * top, f"{what}: {gname} max abs err {err} over {tol} x {top}")
                errs[gname] = {"max_abs_err": err, "largest": top}
            k_ms = cuda_ms(run, reps=3, warmup=1)
            # the same backward hashing its keep bits anew, where the forward wrote them
            hash_ms = None if bits is None else cuda_ms(
                lambda: A._backward_cuda(q, k, v, bias, mask, seed, do, m, l, causal, rate), reps=3, warmup=1)
            p_ms = cuda_ms(lambda: A.t5_attention_backward_plain(q, k, v, bias, mask, seed, do, **kw), reps=2, warmup=1)
            f_ms = cuda_ms(lambda: A._forward_cuda(q, k, v, bias, mask, seed, causal, rate, True), reps=5, warmup=1)
        # 5 products; q, k, v, dout, bias, mask read once, dq, dk, dv, dbias written once
        b_ms, b_by = bound_ms(10 * B * H * L * L * dk, peak_flops(dt), nbytes_of(q, k, v, do, bias, mask, *got))
        row = {"shape": name, "dtype": dtype_name(dt), "B": B, "L": L, "causal": causal, "dropout_rate": rate,
               "route": A.attention_route(L, L, dk, dt, backward=True), "errors": errs, "tol_rel": list(ATTENTION_BWD_TOL[dt]), "bit_equal": True, "kernel_ms": k_ms,
               "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "forward_kernel_ms": f_ms,
               "kernel_ms_hashing_keep_bits": hash_ms,
               "groups": A.backward_groups(B, H, L, L, dk, dt)}
        if not causal and rate == 0.0:
            # the yardstick: the library's backward of the same function (timed here, used nowhere in the port)
            ql, kl, vl, bl = (t.detach().clone().requires_grad_() for t in (q, k, v, bias))
            add = (bl[None] + torch.where(mask != 0, 0.0, -1e9)[:, None, None, :]).to(dt)
            lib_out = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=add, scale=1.0)
            lib = lambda: torch.autograd.grad(lib_out, (ql, kl, vl, bl), do, retain_graph=True)
            lib_dq = lib()[0]
            # row 0 (every key masked) left out: the call adds bias + mask before the scores
            row["library_max_abs_err_dq"] = float((lib_dq[1:].float() - want[0][1:].float()).abs().max().item())
            row["library_ms"] = cuda_ms(lib, reps=3, warmup=1)
            del ql, kl, vl, bl, add, lib_out, lib_dq
        rows.append(row)
        if name == "amazon" and not causal:
            fwd_amazon[(dtype_name(dt), rate)] = f_ms
        if name == "amazon" and dt == torch.bfloat16 and not causal and rate == 0.1:
            kernel_row = {
                "name": "attention_bwd", "route": "cuda", "source": "rqvae_tpu_torch/csrc/attention_bwd.cu",
                "replaces": "rqvae_tpu/ops/pallas/attention.py:205",
                "max_abs_err": max(e["max_abs_err"] for e in errs.values()), "ms": k_ms, "plain_ms": p_ms,
                "bound_ms": b_ms, "bound_by": b_by,
            }
        del q, k, v, bias, mask, do, got, again, want, out, m, l, bits
        torch.cuda.empty_cache()
    by = {(r["shape"], r["dtype"], r["dropout_rate"], r["causal"]): r for r in rows}
    am, ml = by[("amazon", "bfloat16", 0.1, False)], by[("ml32m", "bfloat16", 0.1, False)]
    kernel_row.update(
        library_ms=by[("amazon", "bfloat16", 0.0, False)]["library_ms"], amazon_route=am["route"],
        amazon_ms=am["kernel_ms"], ml32m_route=ml["route"], ml32m_ms=ml["kernel_ms"], ml32m_plain_ms=ml["plain_ms"],
        ml32m_bound_ms=ml["bound_ms"], ml32m_bound_by=ml["bound_by"],
        ml32m_library_ms=by[("ml32m", "bfloat16", 0.0, False)]["library_ms"])
    p_blocks = {64: [(0, 0)], 80: [(0, 0), (1, 0), (0, 1)], 800: [(0, 0), (12, 12), (5, 9)]}
    p_bits = {f"{dtype_name(dt)}_L{L}_rate{rate}_causal{causal}":
              backward_p_equals_forward_p(dt, dev, rate, causal, L, blocks)
              for dt in (torch.float32, torch.bfloat16) for rate, causal in ((0.0, False), (0.2, True))
              for L, blocks in p_blocks.items()}
    check(all(p_bits.values()), f"attention_bwd: the backward's p differs from the forward's: {p_bits}")
    emit({"phase": "attention_bwd", "H": H, "dk": dk, "backward_p_equals_forward_p": p_bits, "rows": rows})
    return kernel_row, {f"{d}_rate{r}": ms for (d, r), ms in fwd_amazon.items()}


def make_sequences(geo: dict, n_items: int, seed: int):
    """Synthetic user histories, leave-two-out layout: [users, max_len] item
    ids right-padded with -1, and their lengths (min_len..max_len)."""
    r = np.random.RandomState(seed)
    lengths = r.randint(geo["min_len"], geo["max_len"] + 1, geo["users"]).astype(np.int64)
    items = r.randint(0, n_items, (geo["users"], geo["max_len"])).astype(np.int64)
    items[np.arange(geo["max_len"])[None, :] >= lengths[:, None]] = -1
    return items, lengths


def write_training_inputs(root: str, geo: dict, rq, x_cpu: torch.Tensor, seed: int):
    """The processed dataset file and the frozen RQ-VAE's checkpoint, as
    train_decoder.train reads them. Returns (dataset folder, checkpoint path,
    the dataset's arrays)."""
    from rqvae_tpu_torch.utils.checkpoint import save_checkpoint

    seq_items, seq_lengths = make_sequences(geo, x_cpu.shape[0], seed)
    data = {"item_features": x_cpu.numpy(), "item_is_train": np.ones(x_cpu.shape[0], bool), "seq_items": seq_items,
            "seq_lengths": seq_lengths, "user_ids": np.arange(geo["users"], dtype=np.int64),
            "max_seq_len": np.int64(geo["max_seq_len"]), "dataset_name": np.asarray("synthetic")}
    os.makedirs(os.path.join(root, "data", "processed"))
    np.savez(os.path.join(root, "data", "processed", "data.npz"), **data)
    ckpt = save_checkpoint(os.path.join(root, "rqvae"), 0, rq.state_dict(), None, rq.config)
    return os.path.join(root, "data"), ckpt, data


def train_kwargs(geo: dict, vae: dict, dataset_folder: str, rq_ckpt: str, dtype: str = "bfloat16") -> dict:
    """The published stage-2 settings (configs/decoder_amazon.gin, decoder_ml32m.gin)."""
    from rqvae_tpu_torch.data.registry import RecDataset

    return dict(batch_size=geo["batch"], learning_rate=1e-3, weight_decay=1e-4, dataset_folder=dataset_folder,
                dataset=RecDataset.SYNTHETIC, pretrained_rqvae_path=rq_ckpt, vae_input_dim=vae["input_dim"],
                vae_embed_dim=vae["embed_dim"], vae_hidden_dims=[512, 256, 128], vae_codebook_size=256,
                vae_n_cat_feats=0, vae_n_layers=3, top_k_for_generation=10, should_add_sep_token=True,
                t5_dropout=0.1, t5_dtype=dtype, warmup_steps=10000, seed=0, **T5)


def training_parts(geo: dict, data: dict, rq, x, dev, dtype: str, cached=None):
    """What train_decoder.train is made of, held here so that a step can be
    inspected and timed: model, optimizer, the fused step and its operands
    (`cached`: an id table to use in place of this device's own index)."""
    from rqvae_tpu_torch.ops.schedules import inverse_sqrt_schedule
    from rqvae_tpu_torch.tokenizer.semids import SemanticIdTokenizer
    from rqvae_tpu_torch.train.decoder_steps import make_decoder_fused_train_step
    from rqvae_tpu_torch.train.state import adamw

    if cached is None:
        cached = SemanticIdTokenizer(rq, device=dev).precompute_corpus_ids(x)
    model = retrieval_model(dtype, dev, t5_dropout=0.1)
    opt = adamw(model.parameters(), inverse_sqrt_schedule(1e-3, 10000), weight_decay=1e-4)
    step = make_decoder_fused_train_step(model, opt, max_seq_len=geo["max_seq_len"], leave_two_out=True,
                                         subsample=True)
    tables = [torch.as_tensor(data[k], device=dev) for k in ("seq_items", "seq_lengths", "user_ids")] + [cached]
    return model, opt, step, tables


def run_steps(step, tables, geo: dict, dev, n: int, first: int = 0):
    """n training steps (numbers first .. first + n - 1 of seed 0): their
    host-clock ms (synchronised) and losses."""
    from rqvae_tpu_torch.train.train_decoder import step_generator, step_rows

    ms, losses = [], []
    for it in range(first, first + n):
        sync()
        t0 = time.perf_counter()
        rows = torch.as_tensor(step_rows(0, it, geo["users"], geo["batch"])).to(dev)
        metrics = step(*tables, rows, step_generator(0, it))
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["total_loss"]))
    return ms, losses


def check_summary(phase: str, summary: dict) -> None:
    check(bool(np.isfinite(summary["total_loss"])), f"{phase}: loss {summary['total_loss']}")
    for k in ("h@1", "h@5", "h@10", "ndcg"):
        check(0.0 <= summary[k] <= 1.0, f"{phase}: {k} = {summary[k]}")
    check(summary["checkpoint_path"] is not None, f"{phase}: no checkpoint written")


def train_ml32m_phase(rq, x_cpu, x, counts, dev) -> dict:
    """Stage-2 training at the ML-32M width through the trainer's entry point;
    returns the path's launch counts."""
    from rqvae_tpu_torch.train.train_decoder import train

    geo, L = TRAIN_ML32M, ML32M["history"] * 4
    with tempfile.TemporaryDirectory() as root:
        folder, rq_ckpt, data = write_training_inputs(root, geo, rq, x_cpu, seed=11)
        kw = train_kwargs(geo, ML32M, folder, rq_ckpt)
        reset_peak_memory()
        counts.zero()
        summary = train(iterations=3, save_dir_root=os.path.join(root, "dec"), partial_eval_every=1000,
                        full_eval_every=1000, full_eval_max_batches=1, log_every=1, device=dev, **kw)
        sync()
        got = counts.read()
        peak_train_call = peak_memory()
    check(got["attention"] == 4 * 3 and got["attention_bwd"] == 4 * 3 and got["encoder_stack"] == 1
          and got["decoder_stack"] == 0 and got["rq_encode"] >= 1, f"ML-32M training launches {got}")
    check_summary("train_path_ml32m", summary)
    model, opt, step, tables = training_parts(geo, data, rq, x, dev, "bfloat16")
    run_steps(step, tables, geo, dev, 1)  # warm
    reset_peak_memory()
    step_ms, losses = run_steps(step, tables, geo, dev, 3, first=1)
    peak_step = peak_memory()
    check(all(np.isfinite(losses)), f"train_path_ml32m: losses {losses}")
    emit({"phase": "train_path_ml32m", "items": int(x.shape[0]), "users": geo["users"], "batch": geo["batch"],
          "Le": L, "dtype": "bfloat16", "dropout": 0.1, "iterations": 3, "launches": got,
          "summary": {k: v for k, v in summary.items() if isinstance(v, float)}, "step_ms": step_ms,
          "step_losses": losses, "peak_memory_bytes_train_call": peak_train_call, "peak_memory_bytes_step": peak_step})
    del model, opt, step, tables
    torch.cuda.empty_cache()
    return got


def train_amazon_phase(rq, x_cpu, x, counts, dev):
    """Stage-2 training at the Amazon width through the trainer's entry point
    (5 iterations, both evaluations, then a resumed iteration that accumulates
    2 micro-batches) and the checks on its step function; returns the path's
    launch counts and the parts for the later phases."""
    from rqvae_tpu_torch.train.train_decoder import train

    geo = TRAIN_AMAZON
    with tempfile.TemporaryDirectory() as root:
        folder, rq_ckpt, data = write_training_inputs(root, geo, rq, x_cpu, seed=12)
        kw = train_kwargs(geo, AMAZON, folder, rq_ckpt)
        save_dir = os.path.join(root, "dec")
        counts.zero()
        t0 = time.perf_counter()
        first = train(iterations=5, save_dir_root=save_dir, partial_eval_every=5, full_eval_every=5,
                      full_eval_max_batches=1, log_every=1, device=dev, **kw)
        resumed = train(iterations=1, save_dir_root=save_dir, gradient_accumulate_every=2, auto_resume=True,
                        partial_eval_every=1000, full_eval_every=1000, full_eval_max_batches=1, log_every=1,
                        device=dev, **kw)
        sync()
        train_s = time.perf_counter() - t0
        got = counts.read()
    micro = 5 + 2
    check(got["attention"] == 4 * micro and got["attention_bwd"] == 4 * micro and got["decoder_stack"] == 3 * 2
          and got["rq_encode"] >= 1 and got["encoder_stack"] == 0, f"Amazon training launches {got}")
    for name, summary in (("first", first), ("resumed", resumed)):
        check_summary(f"train_path {name}", summary)
    check(bool(np.isfinite(first["eval_loss"])), f"train_path: eval loss {first['eval_loss']}")
    check(resumed["checkpoint_path"].endswith("checkpoint_5.pt"), f"resumed run wrote {resumed['checkpoint_path']}")

    # the step function, inspected: gradients, movement, determinism, time
    model, opt, step, tables = training_parts(geo, data, rq, x, dev, "bfloat16")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    _, loss_a = run_steps(step, tables, geo, dev, 1)
    for n, p in model.named_parameters():
        check(p.grad is not None and bool(torch.isfinite(p.grad).all()) and bool((p.grad != 0).any()),
              f"train_path: gradient of {n} is missing, non-finite or all zero")
        check(not torch.equal(p.detach(), before[n]), f"train_path: {n} did not move")
    model2, _, step2, tables2 = training_parts(geo, data, rq, x, dev, "bfloat16")
    _, loss_b = run_steps(step2, tables2, geo, dev, 1)
    check(loss_a == loss_b, f"train_path: same seed, first-step losses {loss_a} and {loss_b}")
    del model2, step2, tables2, before
    step_ms, losses = run_steps(step, tables, geo, dev, 5, first=1)
    check(all(np.isfinite(losses)), f"train_path: losses {losses}")
    emit({"phase": "train_path", "items": int(x.shape[0]), "users": geo["users"], "batch": geo["batch"],
          "Le": AMAZON["history"] * 4, "dtype": "bfloat16", "dropout": 0.1, "iterations": 5,
          "resumed_iterations": 1, "resumed_accumulate": 2, "micro_batches": micro, "launches": got,
          "train_calls_s": train_s, "summary": {k: v for k, v in first.items() if isinstance(v, float)},
          "resumed_total_loss": resumed["total_loss"], "first_step_loss_twice": [loss_a[0], loss_b[0]],
          "step_ms": step_ms, "step_losses": losses})
    return got, (model, opt, step, tables, data)


def train_card_vs_cpu_phase(data: dict, rq, x, dev) -> None:
    """One f32 training step with dropout, the same seeds: card (kernels)
    against CPU (plain versions)."""
    from rqvae_tpu_torch.train.train_decoder import step_generator, step_rows

    geo = {**TRAIN_AMAZON, "batch": TRAIN_CPU_BATCH}
    rows = torch.as_tensor(step_rows(0, 0, geo["users"], geo["batch"]))
    result, cached = {}, None
    # both sides tokenize from the card's index: the two devices' indexes differ
    # at argmin near-ties (phase 5), and this phase compares the training step
    for name, d in {"card": dev, "cpu": torch.device("cpu")}.items():
        model, opt, step, tables = training_parts(geo, data, rq, x, d, "float32", cached=cached)
        cached = tables[3].cpu()
        metrics = step(*tables, rows.to(d), step_generator(0, 0))
        result[name] = (float(metrics["total_loss"]), {n: p.grad.detach().cpu() for n, p in model.named_parameters()})
    loss_card, loss_cpu = result["card"][0], result["cpu"][0]
    check(abs(loss_card - loss_cpu) <= 1e-5 * abs(loss_cpu), f"train_card_vs_cpu_f32: loss {loss_card} vs {loss_cpu}")
    worst, worst_name = 0.0, None
    for n, g in result["cpu"][1].items():
        rel = float((g - result["card"][1][n]).abs().max() / g.abs().max())
        if rel > worst:
            worst, worst_name = rel, n
    check(worst <= TRAIN_GRAD_TOL, f"train_card_vs_cpu_f32: gradient of {worst_name} differs by {worst} of its largest entry")
    emit({"phase": "train_card_vs_cpu_f32", "batch": TRAIN_CPU_BATCH, "dropout": 0.1, "loss_card": loss_card,
          "loss_cpu": loss_cpu, "worst_gradient_rel_diff": worst,
          "worst_gradient": worst_name, "tol_rel": TRAIN_GRAD_TOL})


def write_item_dataset(root: str, x_cpu: torch.Tensor, seed: int) -> str:
    """The processed dataset file the stage-1 trainer reads: the corpus rows
    and a seeded 95/5 train/eval item split. Returns the dataset folder."""
    r = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "processed"))
    np.savez(os.path.join(root, "processed", "data.npz"), item_features=x_cpu.numpy(),
             item_is_train=r.rand(x_cpu.shape[0]) > 0.05, dataset_name=np.asarray("synthetic"))
    return root


def read_log(log_dir: str) -> list:
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def rqvae_train_parts(gin: str, ckpt_path: str, dev):
    """The stage-1 step function at a config file's settings, from a
    checkpoint the trainer wrote: (model, step)."""
    from rqvae_tpu_torch.models.rqvae import RqVae
    from rqvae_tpu_torch.train.rqvae_steps import make_rqvae_index_train_step
    from rqvae_tpu_torch.train.state import adamw
    from rqvae_tpu_torch.utils.checkpoint import load_checkpoint
    from rqvae_tpu_torch.utils.config import parse_config_file

    settings = parse_config_file(gin)
    restored = load_checkpoint(ckpt_path)
    model = RqVae(restored["config"], device=dev)
    model.load_state_dict(restored["params"])
    opt = adamw(model.parameters(), settings["learning_rate"], weight_decay=settings["weight_decay"])
    return model, make_rqvae_index_train_step(model, opt)


def train_rqvae_phase(phase: str, gin: str, x_cpu: torch.Tensor, counts, dev) -> dict:
    """Stage-1 training through train_rqvae.train at a config file's settings
    (iterations and cadences cut): an unbroken run against the same run
    split in two with a resume; returns the path's launch counts."""
    from rqvae_tpu_torch.data.registry import RecDataset
    from rqvae_tpu_torch.train import train_rqvae as T
    from rqvae_tpu_torch.train.train_decoder import step_rows
    from rqvae_tpu_torch.utils.checkpoint import load_checkpoint
    from rqvae_tpu_torch.utils.config import apply_config, parse_config_file

    it, split = RQ_TRAIN["iterations"], RQ_TRAIN["split"]
    settings = parse_config_file(gin)
    with tempfile.TemporaryDirectory() as root:
        folder = write_item_dataset(os.path.join(root, "data"), x_cpu, seed=13)
        common = dict(dataset=RecDataset.SYNTHETIC, dataset_folder=folder, eval_every=RQ_TRAIN["eval_every"],
                      codebook_restart_every=RQ_TRAIN["restart_every"], save_model_every=10**6, log_every=1,
                      device=dev)
        run = lambda save, **kw: apply_config(T.train, gin, save_dir_root=os.path.join(root, save), **common, **kw)
        counts.zero()
        t0 = time.perf_counter()
        whole = run("whole", iterations=it)
        first = run("split", iterations=split)
        rest = run("split", iterations=it - split, auto_resume=True)
        sync()
        train_s = time.perf_counter() - t0
        got = counts.read()
        logs = {name: read_log(os.path.join(root, name, "logs")) for name in ("whole", "split")}
        a, b = load_checkpoint(whole["checkpoint_path"]), load_checkpoint(rest["checkpoint_path"])
        same_params = all(torch.equal(a["params"][k], b["params"][k]) for k in a["params"])
        # steady-state step time, with the step function the trainer is made of
        is_train = np.load(os.path.join(folder, "processed", "data.npz"))["item_is_train"]
        features = x_cpu[torch.from_numpy(is_train)].to(dev)
        model, step = rqvae_train_parts(gin, whole["checkpoint_path"], dev)
        batch = settings["batch_size"]
        step_ms = []
        for i in range(3 + RQ_TRAIN["timed_steps"]):
            idx = torch.as_tensor(step_rows(0, 1000 + i, features.shape[0], batch).reshape(1, batch))
            sync()
            t1 = time.perf_counter()
            step(features, idx.to(dev), None, 0.2)
            sync()
            step_ms.append((time.perf_counter() - t1) * 1e3)
        step_ms = step_ms[3:]
        profiled = profile_call(lambda: step(features, idx.to(dev), None, 0.2))
        del model, step, features
    steps = {name: {r["step"]: r for r in recs if "reconstruction_loss" in r} for name, recs in logs.items()}
    evals = [r for recs in logs.values() for r in recs if "rqvae_entropy" in r]
    evals_of = lambda a, b: sum((i + 1) % RQ_TRAIN["eval_every"] == 0 or i + 1 == b for i in range(a, b))
    want_evals = evals_of(0, it) + evals_of(0, split) + evals_of(split, it)
    check(len(evals) == want_evals, f"{phase}: {len(evals)} evaluations, want {want_evals}")
    check(got["rq_encode"] == len(evals) and got["decoder_stack"] == got["encoder_stack"] == got["attention"] == 0,
          f"{phase}: launches {got} for {len(evals)} evaluations")
    losses = [r["total_loss"] for recs in steps.values() for r in recs.values()]
    check(all(np.isfinite(losses)), f"{phase}: non-finite losses")
    recon = [steps["whole"][i]["reconstruction_loss"] for i in range(it)]
    recon_first, recon_last = float(np.mean(recon[:5])), float(np.mean(recon[-5:]))
    check(recon_last < recon_first, f"{phase}: reconstruction loss, mean of 5 steps, {recon_first} -> {recon_last}")
    first_resumed = (steps["split"][split]["total_loss"], steps["whole"][split]["total_loss"])
    check(first_resumed[0] == first_resumed[1], f"{phase}: resumed step {split} loss {first_resumed}")
    check(same_params, f"{phase}: the resumed run's parameters differ from the unbroken run's")
    check(whole["checkpoint_path"] and rest["checkpoint_path"].endswith(f"checkpoint_{it - 1}.pt"),
          f"{phase}: checkpoints {whole['checkpoint_path']}, {rest['checkpoint_path']}")
    emit({"phase": phase, "config": gin, "items": int(x_cpu.shape[0]), "batch": settings["batch_size"],
          "widths": [settings["vae_input_dim"], *settings["vae_hidden_dims"], settings["vae_embed_dim"]],
          "mode": settings["vae_codebook_mode"].name, "n_cat_feats": settings["vae_n_cat_feats"],
          "learning_rate": settings["learning_rate"], "weight_decay": settings["weight_decay"],
          "iterations": [it, split, it - split], "eval_every": RQ_TRAIN["eval_every"],
          "restart_every": RQ_TRAIN["restart_every"], "launches": got, "evaluations": len(evals),
          "train_calls_s": train_s, "kmeans_init_ms": [whole["kmeans_init_ms"], first["kmeans_init_ms"]],
          "index_build_ms": [r["index_build_ms"] for r in evals], "step_ms": step_ms, "step_profile": profiled,
          "reconstruction_loss_first_last_5": [recon_first, recon_last], "resumed_step_loss_equal": first_resumed,
          "resumed_params_bit_equal": same_params,
          "diversity": {k: whole[k] for k in ("codebook_usage_0", "codebook_usage_1", "codebook_usage_2",
                                              "rqvae_entropy", "max_id_duplicates", "p_unique_ids")},
          "eval_total_loss": whole["eval_total_loss"]})
    return got


def train_rqvae_card_vs_cpu_phase(corpora: dict, dev) -> None:
    """One f32 stage-1 step at each config file's widths and batch (Amazon:
    STE; ML-32M: rotation trick, 20 categorical features), the same weights
    and batch, card (plain torch on the card) against CPU: loss rtol 1e-5,
    every gradient within 2e-4 of its largest entry. The batch leaves out
    rows at an f32 argmin near-tie, where the two devices may pick another
    codeword."""
    from rqvae_tpu_torch.models.rqvae import RqVae, RqVaeConfig
    from rqvae_tpu_torch.train.rqvae_steps import make_rqvae_train_step
    from rqvae_tpu_torch.train.state import adamw
    from rqvae_tpu_torch.utils.config import parse_config_file

    rows = []
    for name, (gin, x_cpu) in corpora.items():
        st = parse_config_file(gin)
        cfg = RqVaeConfig(input_dim=st["vae_input_dim"], embed_dim=st["vae_embed_dim"],
                          hidden_dims=tuple(st["vae_hidden_dims"]), codebook_size=st["vae_codebook_size"],
                          n_layers=st["vae_n_layers"], commitment_weight=st["commitment_weight"],
                          n_cat_feats=st["vae_n_cat_feats"], codebook_mode=st["vae_codebook_mode"])
        rq = RqVae(cfg, device="cpu", seed=5)
        cand = x_cpu[-4 * st["batch_size"]:]  # the batch's candidates, apart from the codebooks' source rows
        init_codebooks_from_data(rq, x_cpu[: min(20000, x_cpu.shape[0] - cand.shape[0])], seed=6)
        with torch.no_grad():
            near = f64_near_tie_rows(cand, rq.encoder.kernels(), rq.codebooks.detach())
        batch = cand[~near][: st["batch_size"]]
        result = {}
        for side, d in (("card", dev), ("cpu", torch.device("cpu"))):
            model = RqVae(cfg, device=d)
            model.load_state_dict(rq.state_dict())
            step = make_rqvae_train_step(model, adamw(model.parameters(), st["learning_rate"],
                                                      weight_decay=st["weight_decay"]))
            m = step(batch[None].to(d), None, 0.2)
            result[side] = (float(m["total_loss"]), {n: p.grad.detach().cpu() for n, p in model.named_parameters()})
        loss_card, loss_cpu = result["card"][0], result["cpu"][0]
        check(abs(loss_card - loss_cpu) <= 1e-5 * abs(loss_cpu), f"train_rqvae_card_vs_cpu {name}: loss {loss_card} vs {loss_cpu}")
        worst, worst_name = 0.0, None
        for n, g in result["cpu"][1].items():
            rel = float((g - result["card"][1][n]).abs().max() / g.abs().max())
            if rel > worst:
                worst, worst_name = rel, n
        check(worst <= TRAIN_GRAD_TOL, f"train_rqvae_card_vs_cpu {name}: gradient of {worst_name} differs by {worst}")
        rows.append({"config": gin, "mode": cfg.codebook_mode.name, "batch": int(batch.shape[0]),
                     "near_tie_rows_left_out": int(near.sum()), "loss_card": loss_card, "loss_cpu": loss_cpu,
                     "worst_gradient_rel_diff": worst, "worst_gradient": worst_name})
    emit({"phase": "train_rqvae_card_vs_cpu", "tol_rel": TRAIN_GRAD_TOL, "loss_rtol": 1e-5, "rows": rows})


def item_corpus(n: int, dim: int, n_cat: int, seed: int) -> torch.Tensor:
    """Stage-1 training rows: make_corpus rows with the dense columns at unit
    norm, as sentence-T5 item embeddings are, and the last n_cat columns
    binary and cluster-correlated (the ML-32M items' genre flags)."""
    x = make_corpus(n, dim, seed)
    dense = x[:, : dim - n_cat]
    x[:, : dim - n_cat] = dense / dense.norm(dim=1, keepdim=True)
    if n_cat:
        x[:, -n_cat:] = (x[:, -n_cat:] > 1.0).float()
    return x


def train_profile_phase(step, tables, dev, top: int = 12) -> None:
    """One Amazon training step under torch.profiler (CUPTI), and the
    CUDA-event time of the hash-dropout masks at the encoder's sites."""
    from torch.profiler import ProfilerActivity, profile

    from rqvae_tpu_torch.ops.hash_dropout import hash_dropout

    geo = TRAIN_AMAZON
    run_steps(step, tables, geo, dev, 1, first=20)  # warm
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ms, _ = run_steps(step, tables, geo, dev, 1, first=21)
    rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    device_ms = sum(e.self_device_time_total for e in rows) / 1e3
    share = lambda pick: sum(e.self_device_time_total for e in rows if pick(e.key.lower())) / 1e3 / device_ms
    attention_fwd = lambda k: any(s in k for s in ("attention_rows_kernel", "attention_tiled_kernel", "attention_kernel"))
    attention_bwd = lambda k: any(s in k for s in ("bwd_", "delta_kernel", "dkv_kernel", "dq_dbias_kernel",
                                                   "reduce_groups_kernel"))
    gemm = lambda k: "gemm" in k or "cutlass" in k or "cublas" in k
    # the masks of the encoder's dropout sites of one micro-batch: input, two
    # sublayer outputs per layer and the final output at [B * Le, d], the FFN's
    # inner activation per layer at [B * Le, d_ff]; each built forward and backward
    n_tok = geo["batch"] * AMAZON["history"] * 4
    sites = [((n_tok, 384), 2 + 2 * 4), ((n_tok, 1024), 4)]
    dropout_ms = 0.0
    for shape, count in sites:
        h = torch.randn(shape, device=dev).to(torch.bfloat16)
        dropout_ms += 2 * count * cuda_ms(lambda: hash_dropout(h, 123, 0.1), reps=5, warmup=1)
    emit({"phase": "train_profile", "host_ms": ms[0], "device_ms": device_ms,
          "device_launches": sum(e.count for e in rows),
          "device_idle_share": max(0.0, 1.0 - device_ms / ms[0]),
          "share_attention_forward": share(attention_fwd), "share_attention_backward": share(attention_bwd),
          "share_gemm": share(gemm), "hash_dropout_encoder_sites_ms": dropout_ms,
          "hash_dropout_encoder_sites_share_of_device_ms": dropout_ms / device_ms,
          "kernels": [{"name": e.key[:60], "count": e.count, "ms": e.self_device_time_total / 1e3}
                      for e in rows[:top]]})


# ---- training as the JAX trainers run it: step graphs, remat, step time and MFU ----

# stage 2: n eager steps (steps_per_loop=1) against n / chunk chunks of `chunk` replays
TRAIN_GRAPH = {"amazon": dict(eager=8, chunk=4), "ml32m": dict(eager=4, chunk=2)}
RQ_GRAPH = dict(eager=8, chunk=4)  # stage 1, the same


def attention_launches_in(names: dict) -> dict:
    """Kernel 4's and kernel 5's launches among kernel names (a graph's nodes
    or a profile): one forward kernel per kernel-4 launch; kernel 5 launches
    one kernel on the whole-row route and three on the others (and a group
    reduction), counted by its first."""
    fwd = sum(c for n, c in names.items() if re.search(r"attn::attention_(rows_|tiled_)?kernel[<(]", n))
    bwd = sum(c for n, c in names.items()
              if re.search(r"::(bwd_rows_kernel|bwd_delta_tiled_kernel|delta_kernel)[<(]", n))
    return {"attention": fwd, "attention_bwd": bwd}


def same_state(model_a, opt_a, model_b, opt_b) -> dict:
    """Largest abs difference of the parameters and of the moments (0.0 when
    bit-equal), and whether all are bit-equal."""
    pa, pb = list(model_a.parameters()), list(model_b.parameters())
    ma, mb = opt_a.mu + opt_a.nu, opt_b.mu + opt_b.nu
    return {"bit_equal": all(torch.equal(a, b) for a, b in zip(pa + ma, pb + mb)),
            "params_max_abs_diff": max(float((a.detach() - b.detach()).abs().max()) for a, b in zip(pa, pb)),
            "moments_max_abs_diff": max(float((a - b).abs().max()) for a, b in zip(ma, mb)),
            "count": [opt_a.count, opt_b.count]}


def chunk_means_equal(chunks: list, eager: list, chunk: int) -> bool:
    """Each chunk's metrics equal the step-order float32 sum of its eager
    steps' over the chunk's length, bit for bit."""
    for c, means in enumerate(chunks):
        for key, v in means.items():
            total = torch.zeros_like(v)
            for m in eager[c * chunk:(c + 1) * chunk]:
                total = total + m[key]
            if not torch.equal(v, total / chunk):
                return False
    return True


def graph_gate(phase: str, eager_twice: dict, graph: dict) -> dict:
    """The graph against the eager steps: bit-equal, or, if two eager runs of
    the same steps are not bit-equal on this card, no further from the eager
    run than the two eager runs are from each other (reported)."""
    if eager_twice["bit_equal"]:
        check(graph["bit_equal"], f"{phase}: the graph's state differs from the eager steps': {graph}")
    else:
        check(graph["params_max_abs_diff"] <= eager_twice["params_max_abs_diff"]
              and graph["moments_max_abs_diff"] <= eager_twice["moments_max_abs_diff"],
              f"{phase}: eager runs differ by {eager_twice}; the graph by {graph}")
    return {"eager_twice": eager_twice, "graph_vs_eager": graph,
            "gate": "bit_equal" if eager_twice["bit_equal"] else "eager_vs_eager"}


def replay_timing(chunks, replays: int) -> dict:
    """Host ms per replay of `replays` staged steps (synchronised), the
    graph's CUDA-event ms on the card, and one profiled replay's device time
    and the card's idle share of it. The draws must be staged; the step
    index is reset before the timed replays and before each profiled one."""
    sync()
    chunks.index.zero_()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    chunks.replay(replays)
    end.record()
    sync()
    host = (time.perf_counter() - t0) * 1e3 / replays
    card = start.elapsed_time(end) / replays

    def one():
        chunks.index.zero_()
        chunks.replay(1)

    prof = profile_call(one)
    return {"replayed_host_ms": host, "graph_card_ms": card,
            "replay_profile": {k: prof[k] for k in ("host_ms", "device_ms", "device_launches", "device_idle_share")}}


def graph_against_eager(phase: str, graph, chunks_eager, tmp: str) -> dict:
    """The graph's nodes by demangled name against one eager step's profiled
    launches (a chunk runner of one step, its index reset between runs
    without a launch; up to three profiles: a profile can drop events)."""
    nodes = graph_nodes(graph, tmp)
    fresh = [torch.zeros_like(chunks_eager.index) for _ in range(12)]

    def one():
        chunks_eager.index = fresh.pop()
        chunks_eager._one_step()

    for _ in range(3):
        prof = profile_call(one, by_name=True)
        if prof["names"] == nodes:
            break
    names = prof["names"]
    differ = {n[:90]: [nodes.get(n, 0), names.get(n, 0)] for n in set(nodes) | set(names)
              if nodes.get(n, 0) != names.get(n, 0)}
    check(not differ, f"{phase}: kernels by name, graph against an eager step: {differ}")
    return {"nodes": sum(nodes.values()), "copies": nodes.get(DEVICE_COPY, 0),
            "eager_step": {k: prof[k] for k in ("host_ms", "device_ms", "device_launches", "device_idle_share")},
            "attention_nodes": attention_launches_in(nodes)}


def eager_runs(make, run_step, n: int) -> tuple:
    """(model, optimizer, step, per-step metrics, per-step host ms, draws) of
    steps 0 .. n - 1 of seed 0 one by one (steps_per_loop=1) from a fresh
    `make(1)`."""
    model, opt, step = make(1)
    draws = [step.draws(0, s) for s in range(n)]
    ms, metrics = [], []
    for d in draws:
        sync()
        t0 = time.perf_counter()
        metrics.append(run_step(step, [d]))
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
    return model, opt, step, metrics, ms, draws


def train_graph_phase(phase: str, geo: dict, rq, x, dev, counts, eager: int, chunk: int) -> dict:
    """Stage-2 steps as the JAX trainer runs them, at a published width: from
    one state, n_eager steps one by one (steps_per_loop=1), twice, against
    n_eager / chunk chunks through the step's CUDA graph; returns the
    replays' launches of kernels 4 and 5, read off the graph's nodes (the
    wrappers' counters, zeroed before the chunks, do not tick on a replay)."""
    n_eager = eager
    from rqvae_tpu_torch.ops.schedules import inverse_sqrt_schedule
    from rqvae_tpu_torch.tokenizer.semids import SemanticIdTokenizer
    from rqvae_tpu_torch.train.decoder_steps import make_decoder_graph_train_step
    from rqvae_tpu_torch.train.state import adamw

    seq_items, seq_lengths = make_sequences(geo, x.shape[0], seed=21)
    cached = SemanticIdTokenizer(rq, device=dev).precompute_corpus_ids(x)
    tables = [torch.as_tensor(a, device=dev) for a in (seq_items, seq_lengths, np.arange(geo["users"]))] + [cached]

    def make(n_steps):
        model = retrieval_model("bfloat16", dev, t5_dropout=0.1)
        opt = adamw(model.parameters(), inverse_sqrt_schedule(1e-3, 10000), weight_decay=1e-4)
        step = make_decoder_graph_train_step(model, opt, max_seq_len=geo["max_seq_len"], n_steps=n_steps,
                                             batch_size=geo["batch"])
        step.draws = functools.partial(step.draws, n_rows=geo["users"])
        return model, opt, step

    run_step = lambda step, d: step(*tables, d)
    me, oe, se, eager, eager_ms, draws = eager_runs(make, run_step, n_eager)
    again = eager_runs(make, run_step, n_eager)
    model, opt, step = make(chunk)
    step.bind(*tables)
    sync()
    torch.cuda.empty_cache()  # as the capture does on entry: the reserved bytes after it are the pool's
    mem0, res0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    reset_peak_memory()
    t0 = time.perf_counter()
    step.chunks.capture()
    sync()
    capture_s = time.perf_counter() - t0
    pool = {"allocated_bytes": torch.cuda.memory_allocated() - mem0,
            "reserved_bytes": torch.cuda.memory_reserved() - res0, "peak_bytes": peak_memory() - mem0}
    counts.zero()
    chunks = [run_step(step, draws[i:i + chunk]) for i in range(0, n_eager, chunk)]
    sync()
    ticked = counts.read()
    check(not any(ticked.values()), f"{phase}: wrappers ticked during replays: {ticked}")
    replays = step.chunks.replays
    gate = graph_gate(phase, same_state(me, oe, *again[:2]), same_state(me, oe, model, opt))
    means_equal = chunk_means_equal(chunks, eager, chunk)
    check(means_equal, f"{phase}: a chunk's means differ from the means of its eager steps")
    losses = [float(m["total_loss"]) for m in eager]
    check(all(np.isfinite(losses)), f"{phase}: losses {losses}")
    with tempfile.TemporaryDirectory() as tmp:
        nodes = graph_against_eager(phase, step.chunks.graph, se.chunks, tmp)
    per_step = nodes["attention_nodes"]
    check(per_step == {"attention": 4, "attention_bwd": 4}, f"{phase}: kernels 4 and 5 in the graph: {per_step}")
    step.chunks.stage(draws[:chunk])
    timing = replay_timing(step.chunks, chunk)
    emit({"phase": phase, "batch": geo["batch"], "Le": geo["max_seq_len"] * 4, "dtype": "bfloat16", "dropout": 0.1,
          "eager_steps": n_eager, "chunk": chunk, "chunks": len(chunks), "replays": replays, **gate,
          "chunk_means_equal_eager_means": means_equal, "losses": losses,
          "chunk_total_loss": [float(c["total_loss"]) for c in chunks], "eager_host_ms": eager_ms, **timing,
          "graph_nodes": nodes, "capture_s": capture_s, "graph_pool": pool})
    del me, oe, se, again, model, opt, step, tables, cached
    torch.cuda.empty_cache()
    return {k: v * replays for k, v in per_step.items()}


def train_rqvae_graph_phase(phase: str, gin: str, x_cpu: torch.Tensor, dev, mode=None, anneal=False) -> None:
    """Stage-1 steps at a config file's settings (codebooks seeded from the
    data): n eager steps, twice, against chunks through the step's CUDA
    graph, from one state; `mode` overrides the file's estimator, `anneal`
    puts a temperature anneal on the device."""
    from rqvae_tpu_torch.models.rqvae import RqVae, RqVaeConfig
    from rqvae_tpu_torch.ops.schedules import gumbel_temperature_at
    from rqvae_tpu_torch.train.rqvae_steps import make_rqvae_graph_train_step
    from rqvae_tpu_torch.train.state import adamw
    from rqvae_tpu_torch.utils.config import parse_config_file

    st = parse_config_file(gin)
    cfg = RqVaeConfig(input_dim=st["vae_input_dim"], embed_dim=st["vae_embed_dim"],
                      hidden_dims=tuple(st["vae_hidden_dims"]), codebook_size=st["vae_codebook_size"],
                      n_layers=st["vae_n_layers"], commitment_weight=st["commitment_weight"],
                      n_cat_feats=st["vae_n_cat_feats"], codebook_mode=mode or st["vae_codebook_mode"])
    t_fn = functools.partial(gumbel_temperature_at, t0=1.0, min_t=0.1, anneal_rate=0.05,
                             step_size=2) if anneal else None
    x = x_cpu.to(dev)

    def make(n_steps):
        model = RqVae(cfg, device=dev, seed=5)
        init_codebooks_from_data(model, x, seed=6)
        opt = adamw(model.parameters(), st["learning_rate"], weight_decay=st["weight_decay"])
        step = make_rqvae_graph_train_step(model, opt, n_steps=n_steps, accum=1, batch_size=st["batch_size"],
                                           gumbel_t=1.0, t_fn=t_fn)
        step.draws = functools.partial(step.draws, n_items=x.shape[0])
        return model, opt, step

    run_step = lambda step, d: step(x, d)
    n, chunk = RQ_GRAPH["eager"], RQ_GRAPH["chunk"]
    me, oe, se, eager, eager_ms, draws = eager_runs(make, run_step, n)
    again = eager_runs(make, run_step, n)
    model, opt, step = make(chunk)
    chunks = [run_step(step, draws[i:i + chunk]) for i in range(0, n, chunk)]
    sync()
    gate = graph_gate(phase, same_state(me, oe, *again[:2]), same_state(me, oe, model, opt))
    means_equal = chunk_means_equal(chunks, eager, chunk)
    check(means_equal, f"{phase}: a chunk's means differ from the means of its eager steps")
    losses = [float(m["total_loss"]) for m in eager]
    check(all(np.isfinite(losses)), f"{phase}: losses {losses}")
    with tempfile.TemporaryDirectory() as tmp:
        nodes = graph_against_eager(phase, step.chunks.graph, se.chunks, tmp)
    step.chunks.stage(draws[:chunk])
    timing = replay_timing(step.chunks, chunk)
    emit({"phase": phase, "config": gin, "mode": cfg.codebook_mode.name, "batch": st["batch_size"],
          "anneal_on_device": anneal, "temperatures": [float(m["gumbel_t"]) for m in eager],
          "eager_steps": n, "chunk": chunk, "replays": step.chunks.replays, **gate,
          "chunk_means_equal_eager_means": means_equal, "losses": losses, "eager_host_ms": eager_ms, **timing,
          "graph_nodes": nodes})
    del me, oe, se, again, model, opt, step, x
    torch.cuda.empty_cache()


def remat_phase(rq, x, dev, counts) -> dict:
    """One ML-32M stage-2 step's loss and gradients with t5_remat=True against
    False, dropout 0.1, the same batch and seeds: bit-equal; the peak memory
    of each. Returns the launches of kernels 4 and 5."""
    from rqvae_tpu_torch.models.t5 import DropoutSeeds
    from rqvae_tpu_torch.tokenizer.semids import SemanticIdTokenizer
    from rqvae_tpu_torch.train.decoder_steps import _make_micro_batch_fn
    from rqvae_tpu_torch.train.step_graph import step_generator, step_rows

    geo = TRAIN_ML32M
    seq_items, seq_lengths = make_sequences(geo, x.shape[0], seed=22)
    cached = SemanticIdTokenizer(rq, device=dev).precompute_corpus_ids(x)
    tables = [torch.as_tensor(a, device=dev) for a in (seq_items, seq_lengths, np.arange(geo["users"]))] + [cached]
    g = step_generator(0, 0)
    rows = torch.as_tensor(step_rows(0, 0, geo["users"], geo["batch"]), device=dev)
    u_start, u_end = (torch.rand(geo["batch"], generator=g).to(dev) for _ in range(2))
    batch = _make_micro_batch_fn(geo["max_seq_len"], True, True)(*tables, rows, u_start, u_end)
    out = {}
    for remat in (False, True):
        model = retrieval_model("bfloat16", dev, t5_dropout=0.1, t5_remat=remat)
        seeds = DropoutSeeds.draw(torch.Generator().manual_seed(3), 1, model.n_dropout_sites)[0].to(dev)
        sync()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        reset_peak_memory()
        counts.zero()
        res = model(batch, training=True, seeds=seeds)
        res.loss.backward()
        sync()
        launched = {k: v for k, v in counts.read().items() if k.startswith("attention")}
        out[remat] = (res.loss.detach(), {n: p.grad for n, p in model.named_parameters()},
                      peak_memory() - base, launched)
        del model, res
    (la, ga, pa, ka), (lb, gb, pb, kb) = out[False], out[True]
    same = bool(torch.equal(la, lb)) and all(torch.equal(ga[n], gb[n]) for n in ga)
    check(same, "remat: the loss or a gradient with t5_remat=True differs from t5_remat=False")
    check(ka == {"attention": 4, "attention_bwd": 4} and kb == {"attention": 8, "attention_bwd": 4},
          f"remat: kernel launches {ka} without, {kb} with (the recompute runs each encoder layer's forward again)")
    emit({"phase": "remat", "batch": geo["batch"], "Le": geo["max_seq_len"] * 4, "dtype": "bfloat16",
          "dropout": 0.1, "loss": float(la), "loss_and_gradients_bit_equal": same,
          "peak_step_bytes": {"remat_off": pa, "remat_on": pb}, "launches": {"remat_off": ka, "remat_on": kb}})
    del out, tables, cached, batch
    torch.cuda.empty_cache()
    return {k: ka[k] + kb[k] for k in ka}


def train_perf_phase(x_cpu: torch.Tensor, dev) -> None:
    """train/perf.py's measures at their defaults (the Amazon flagship, both
    stages) and stage 2 at the ML-32M geometry; a 200-step stage-1 run of
    train_rqvae.train at configs/rqvae_amazon.gin's settings with
    steps_per_loop=1 against the automatic chunk (100 here)."""
    from rqvae_tpu_torch.data.registry import RecDataset
    from rqvae_tpu_torch.train import perf
    from rqvae_tpu_torch.train import train_rqvae as T
    from rqvae_tpu_torch.utils.config import apply_config

    rows = {"stage1_amazon": perf.measure_stage1_step(device=dev),
            "stage2_amazon": perf.measure_stage2_step(device=dev),
            "stage2_ml32m": perf.measure_stage2_step(batch=TRAIN_ML32M["batch"],
                                                     max_seq_len=TRAIN_ML32M["max_seq_len"],
                                                     n_rows=TRAIN_ML32M["users"], r1=3, r2=23, device=dev)}
    for name, r in rows.items():
        check(r["seconds_per_step"] > 0 and 0 < r["mfu"] < 1, f"train_perf {name}: {r}")
    runs = {}
    with tempfile.TemporaryDirectory() as root:
        folder = write_item_dataset(os.path.join(root, "data"), x_cpu, seed=13)
        for spl in (1, None):
            t0 = time.perf_counter()
            s = apply_config(T.train, "configs/rqvae_amazon.gin", iterations=200, eval_every=200,
                             save_model_every=200, log_every=100, steps_per_loop=spl, dataset=RecDataset.SYNTHETIC,
                             dataset_folder=folder, save_dir_root=os.path.join(root, f"rq{spl}"), device=dev)
            sync()
            runs["steps_per_loop_1" if spl == 1 else "steps_per_loop_auto"] = {
                "wall_s": time.perf_counter() - t0, "iterations_per_sec": s["iterations_per_sec"],
                "kmeans_init_ms": s["kmeans_init_ms"], "total_loss": s["total_loss"]}
    for name, r in runs.items():
        check(bool(np.isfinite(r["total_loss"])), f"train_perf {name}: loss {r['total_loss']}")
    emit({"phase": "train_perf", "peak": "h100_sxm_bf16", **rows, "train_rqvae_200_steps": runs})


# ---- the trainers as rqvae_tpu's are configured and resumed: amp, optax-layout resume, sampled eval, hub ----

AMP_STEPS = {"stage2": 4, "stage1": 8}  # steps of each route from one state
AMP_LOSS_RTOL = 2e-2  # the stage-2 bf16 tests' loss tolerance (tests/test_torch_decoder_steps.py)
# AdamW's first updates are lr x sign(g), so any bf16-sized perturbation flips the entries whose gradient
# is below it: the amp run's parameters are held to no further from the f32 run (mean over tensors of
# |p - p_f32| / |p_f32 - p_0|) than 1.5 x an f32 run started from the bf16-rounded parameters is, as
# tests/test_torch_decoder_steps.py holds a bf16 gradient to 1.5 x JAX's own bf16 gradient's distance
AMP_PARAM_FACTOR = 1.5
RESUME_STEPS = {"stage2": 4, "stage1": 20}  # unbroken, against half + a resume from the JAX-format file


def bf16_gemms_in(names: dict) -> int:
    """cuBLAS's bf16 GEMM kernels among kernel names: on the H100 the
    `nvjet` kernels (float32 products with TF32 off run `sm80_xmma_gemm_f32f32`
    and CUTLASS `simt_sgemm` kernels; a split-K reduction is a kernel of its
    own and not counted)."""
    return sum(c for n, c in names.items() if n.startswith("nvjet") or ("gemm" in n and "bf16" in n))


def amp_distance(model_amp, model_f32, params0: dict) -> dict:
    """Per tensor |p_amp - p_f32| / |p_f32 - p_0| (tensors that moved): the
    mean, the largest and its name."""
    ratios = {}
    for (name, a), b in zip(model_amp.named_parameters(), model_f32.parameters()):
        moved = float((b.detach() - params0[name]).norm())
        if moved > 0:
            ratios[name] = float((a.detach() - b.detach()).norm()) / moved
    worst = max(ratios, key=ratios.get)
    return {"mean": float(np.mean(list(ratios.values()))), "max": ratios[worst], "max_at": worst,
            "tensors": len(ratios)}


def one_step_at_a_time(step, run_step, draws: list) -> list:
    """Each step's metrics from a chunk runner: one draw per call (a chunk
    of one step), each a replay of its graph on the card."""
    return [run_step(step, [d]) for d in draws]


def gemm_names(names: dict) -> dict:
    """The GEMM-like kernels among kernel names, for a failure's message."""
    return {n[:80]: c for n, c in names.items() if re.search(r"gemm|nvjet|xmma|cutlass", n, re.I)}


def round_to_bf16_(model) -> None:
    """Every parameter rounded to bf16 and back, in place."""
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(p.to(torch.bfloat16).float())


def graph_launches(nodes: dict) -> dict:
    """The port's kernels among a graph's nodes, kernels 4 and 5 apart."""
    ours = our_kernels(nodes)
    return {"rq_encode": ours["rq_encode"], "decoder_stack": ours["decoder_stack"],
            "encoder_stack": ours["encoder_stack"], **attention_launches_in(nodes)}


def add_launches(*parts: dict) -> dict:
    out = {}
    for part in parts:
        for k, v in part.items():
            out[k] = out.get(k, 0) + v
    return out


def capture_uncounted(chunks, counts) -> None:
    """The capture of `chunks`' graph (at its first replay) leaves the
    wrappers' counters as they were: a capture records launches without
    making them, and its eager warm-up is set-up, as in train_graph_phase.
    A graph's launches are its nodes x its replays (replayed_launches)."""
    capture = chunks.capture

    def run():
        before = counts.read()
        capture()
        counts.restore(before)
    chunks.capture = run


def replayed_launches(steps: list, tmp: str) -> dict:
    """The port's kernels launched by the graph replays of step runners:
    each graph's nodes x its replays (a runner without a graph: nothing)."""
    parts = [{k: v * s.chunks.replays for k, v in graph_launches(graph_nodes(s.chunks.graph, tmp)).items()}
             for s in steps if s.chunks.graph is not None]
    return add_launches(*parts)


@contextlib.contextmanager
def recorded_steps(module, factory: str, counts, steps: list):
    """`module.factory` (a trainer's step-runner factory) wrapped while the
    block runs: each runner it makes is appended to `steps`, its capture
    uncounted (capture_uncounted)."""
    make = getattr(module, factory)

    def recording(*args, **kwargs):
        step = make(*args, **kwargs)
        capture_uncounted(step.chunks, counts)
        steps.append(step)
        return step

    setattr(module, factory, recording)
    try:
        yield steps
    finally:
        setattr(module, factory, make)


def amp_routes(phase: str, make, run_step, k: int, params0: dict, tmp: str, counts) -> dict:
    """From one state, k steps with amp one by one twice, through the step
    graph, through the graph without amp, and without amp from the
    bf16-rounded state (the yardstick of AMP_PARAM_FACTOR): the graph against
    the eager steps (bit-equal, or no further apart than two eager runs),
    losses and parameters against the float32 route by the bf16 measure, the
    graph's bf16 GEMM nodes equal to the bf16 products of one step, kernels
    4 and 5 in the graphs, then the replay times. Returns the routes' rows
    and, under "launches", the port's kernels that every step of the phase
    launched: the eager steps' counters and each graph's nodes x replays
    (the counters, zeroed after the eager steps, must not tick again)."""
    from rqvae_tpu_torch.ops import amp as amp_lib

    n0 = amp_lib.products
    counts.zero()
    me, oe, se, eager, eager_ms, draws = eager_runs(functools.partial(make, amp=True), run_step, k)
    products = (amp_lib.products - n0) / k
    again = eager_runs(functools.partial(make, amp=True), run_step, k)
    eager_launches = counts.read()
    counts.zero()
    runs, rows = {}, {}
    for name, amp in (("amp", True), ("f32", False), ("f32_bf16_start", False)):
        model, opt, step = make(k, amp=amp)
        capture_uncounted(step.chunks, counts)
        if name == "f32_bf16_start":
            round_to_bf16_(model)
        metrics = one_step_at_a_time(step, run_step, draws)
        sync()
        nodes = graph_nodes(step.chunks.graph, tmp)
        runs[name] = (model, opt, step)
        rows[name] = {"losses": [float(m["total_loss"]) for m in metrics], "bf16_gemm_nodes": bf16_gemms_in(nodes),
                      "nodes": sum(nodes.values()), "attention_nodes": attention_launches_in(nodes),
                      "gemm_kernels": gemm_names(nodes)}
    amp_row, f32_row = rows["amp"], rows["f32"]
    gate = graph_gate(phase, same_state(me, oe, *again[:2]), same_state(me, oe, *runs["amp"][:2]))
    eager_losses = [float(m["total_loss"]) for m in eager]
    check(amp_row["losses"] == eager_losses or not gate["eager_twice"]["bit_equal"],
          f"{phase}: graph losses {amp_row['losses']} against eager {eager_losses}")
    check(products > 0 and amp_row["bf16_gemm_nodes"] == products,
          f"{phase}: {amp_row['bf16_gemm_nodes']} bf16 GEMM nodes in the graph for {products} bf16 products a "
          f"step; GEMM kernels {amp_row['gemm_kernels']}")
    check(f32_row["bf16_gemm_nodes"] == 0,
          f"{phase}: {f32_row['bf16_gemm_nodes']} bf16 GEMM nodes without amp: {f32_row['gemm_kernels']}")
    check(all(np.isfinite(amp_row["losses"])), f"{phase}: losses {amp_row['losses']}")
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(amp_row["losses"], f32_row["losses"])]
    check(max(loss_rel) <= AMP_LOSS_RTOL, f"{phase}: amp losses {amp_row['losses']} against f32 {f32_row['losses']}")
    dist = amp_distance(runs["amp"][0], runs["f32"][0], params0)
    yardstick = amp_distance(runs["f32_bf16_start"][0], runs["f32"][0], params0)
    check(dist["mean"] <= AMP_PARAM_FACTOR * yardstick["mean"],
          f"{phase}: parameters against the f32 route {dist}, the bf16-rounded start's {yardstick}")
    for name, (_, _, step) in runs.items():
        step.chunks.stage(draws)
        rows[name].update(replay_timing(step.chunks, k))
        rows[name]["replays"] = step.chunks.replays
    ticked = counts.read()
    check(not any(ticked.values()), f"{phase}: wrappers ticked during the graphs' replays: {ticked}")
    launches = add_launches(eager_launches, replayed_launches([step for _, _, step in runs.values()], tmp))
    out = {"steps": k, "bf16_products_per_step": products, **gate, "launches": launches,
           "eager_launches": eager_launches, "eager_host_ms": eager_ms,
           "eager_losses": eager_losses, "loss_rel_diff_vs_f32": loss_rel, "params_vs_f32": dist,
           "params_vs_f32_of_the_bf16_rounded_start": yardstick, **rows}
    del me, oe, se, again, runs
    gc.collect()  # the step runners close over themselves: free their graphs and pools now
    torch.cuda.empty_cache()
    return out


def train_amp_phase(rq, x, corpus_cpu: torch.Tensor, counts, dev) -> dict:
    """amp=True at the Amazon widths, on the card: stage 2 at
    t5_dtype="float32" (batch 640, Le 80, dropout 0.1) and stage 1 at
    configs/rqvae_amazon.gin through the replayed step graphs (amp_routes),
    perf.py's step time and MFU of both routes in both stages, and a few
    amp=True stage-1 trainer steps. Returns the launches of the port's
    kernels in the routes' steps (counters of the eager steps, nodes x
    replays of the graphs) and in the trainer run (its counters, its step
    graph's nodes x replays); perf.py's timed steps are not counted."""
    from rqvae_tpu_torch.data.registry import RecDataset
    from rqvae_tpu_torch.models.rqvae import RqVae, RqVaeConfig
    from rqvae_tpu_torch.ops.cuda.attention import attention_route
    from rqvae_tpu_torch.ops.schedules import inverse_sqrt_schedule
    from rqvae_tpu_torch.tokenizer.semids import SemanticIdTokenizer
    from rqvae_tpu_torch.train import perf
    from rqvae_tpu_torch.train import train_rqvae as T
    from rqvae_tpu_torch.train.decoder_steps import make_decoder_graph_train_step
    from rqvae_tpu_torch.train.rqvae_steps import make_rqvae_graph_train_step
    from rqvae_tpu_torch.train.state import adamw
    from rqvae_tpu_torch.utils.config import apply_config, parse_config_file

    geo = TRAIN_AMAZON
    seq_items, seq_lengths = make_sequences(geo, x.shape[0], seed=23)
    cached = SemanticIdTokenizer(rq, device=dev).precompute_corpus_ids(x)
    tables = [torch.as_tensor(a, device=dev) for a in (seq_items, seq_lengths, np.arange(geo["users"]))] + [cached]

    def make2(n_steps, amp):
        model = retrieval_model("float32", dev, t5_dropout=0.1)
        opt = adamw(model.parameters(), inverse_sqrt_schedule(1e-3, 10000), weight_decay=1e-4)
        step = make_decoder_graph_train_step(model, opt, max_seq_len=geo["max_seq_len"], n_steps=n_steps,
                                             batch_size=geo["batch"], amp=amp)
        step.draws = functools.partial(step.draws, n_rows=geo["users"])
        return model, opt, step

    params0 = {n: p.detach().clone() for n, p in retrieval_model("float32", dev).named_parameters()}
    with tempfile.TemporaryDirectory() as tmp:
        stage2 = amp_routes("train_amp stage2", make2, lambda step, d: step(*tables, d), AMP_STEPS["stage2"],
                            params0, tmp, counts)
    routes = {"forward": attention_route(80, 80, 64, torch.float32),
              "backward": attention_route(80, 80, 64, torch.float32, backward=True)}
    check(routes == {"forward": "cuda_cores", "backward": "cuda_cores"}, f"train_amp: f32 attention routes {routes}")
    for name in ("amp", "f32"):
        check(stage2[name]["attention_nodes"] == {"attention": 4, "attention_bwd": 4},
              f"train_amp stage2 {name}: kernels 4 and 5 in the graph {stage2[name]['attention_nodes']}")
    eager = stage2["eager_launches"]
    check(eager["attention"] == eager["attention_bwd"] == 4 * 2 * AMP_STEPS["stage2"],
          f"train_amp stage2: the eager steps' launches {eager}")
    del params0, tables, cached
    torch.cuda.empty_cache()

    gin = "configs/rqvae_amazon.gin"
    st = parse_config_file(gin)
    cfg = RqVaeConfig(input_dim=st["vae_input_dim"], embed_dim=st["vae_embed_dim"],
                      hidden_dims=tuple(st["vae_hidden_dims"]), codebook_size=st["vae_codebook_size"],
                      n_layers=st["vae_n_layers"], commitment_weight=st["commitment_weight"],
                      n_cat_feats=st["vae_n_cat_feats"], codebook_mode=st["vae_codebook_mode"])
    xs = corpus_cpu.to(dev)

    def make1(n_steps, amp):
        model = RqVae(cfg, device=dev, seed=5)
        init_codebooks_from_data(model, xs, seed=6)
        opt = adamw(model.parameters(), st["learning_rate"], weight_decay=st["weight_decay"])
        step = make_rqvae_graph_train_step(model, opt, n_steps=n_steps, accum=1, batch_size=st["batch_size"],
                                           amp=amp)
        step.draws = functools.partial(step.draws, n_items=xs.shape[0])
        return model, opt, step

    model0 = RqVae(cfg, device=dev, seed=5)
    init_codebooks_from_data(model0, xs, seed=6)
    params0 = {n: p.detach().clone() for n, p in model0.named_parameters()}
    with tempfile.TemporaryDirectory() as tmp:
        stage1 = amp_routes("train_amp stage1", make1, lambda step, d: step(xs, d), AMP_STEPS["stage1"], params0, tmp,
                            counts)
    del model0, params0

    perf_rows = {
        "stage2_f32": perf.measure_stage2_step(dtype="float32", r1=2, r2=12, device=dev),
        "stage2_f32_amp": perf.measure_stage2_step(dtype="float32", bf16=True, r1=2, r2=12, device=dev),
        "stage1": perf.measure_stage1_step(device=dev),
        "stage1_amp": perf.measure_stage1_step(bf16=True, device=dev),
    }
    for name, r in perf_rows.items():
        check(r["seconds_per_step"] > 0 and 0 < r["mfu"] < 1, f"train_amp perf {name}: {r}")
    with tempfile.TemporaryDirectory() as root:
        folder = write_item_dataset(os.path.join(root, "data"), corpus_cpu, seed=13)
        counts.zero()
        with recorded_steps(T, "make_rqvae_graph_train_step", counts, []) as steps:
            s = apply_config(T.train, gin, iterations=20, eval_every=20, save_model_every=20, log_every=10, amp=True,
                             dataset=RecDataset.SYNTHETIC, dataset_folder=folder,
                             save_dir_root=os.path.join(root, "rq"), device=dev)
        sync()
        trainer = add_launches(counts.read(), replayed_launches(steps, root))
        replays = [st.chunks.replays for st in steps]
        del steps
    check(bool(np.isfinite(s["total_loss"])) and bool(np.isfinite(s["eval_total_loss"])),
          f"train_amp: amp=True trainer losses {s['total_loss']}, {s['eval_total_loss']}")
    check(trainer["rq_encode"] >= 1, f"train_amp: the trainer's evaluation launched no index build: {trainer}")
    emit({"phase": "train_amp", "stage2": {"config": "decoder_amazon.gin widths, t5_dtype float32",
                                           "batch": geo["batch"], "Le": geo["max_seq_len"] * 4, "dropout": 0.1,
                                           **stage2},
          "stage1": {"config": gin, "batch": st["batch_size"], **stage1}, "attention_routes_f32": routes,
          "perf": perf_rows, "trainer_amp_20_steps": {**{k: s[k] for k in ("total_loss", "eval_total_loss",
                                                                          "iterations_per_sec", "index_build_ms")},
                                                       "graph_replays": replays, "launches": trainer}})
    return add_launches(stage2["launches"], stage1["launches"], trainer)


def resume_jax_layout_phase(rq, x_cpu, corpus_cpu: torch.Tensor, dev) -> None:
    """Both trainers at their shipped Amazon settings: N steps unbroken
    against N/2 steps, the checkpoint rewritten as the JAX package's file
    (params and optax opt_state, utils/checkpoint.py::export_jax_checkpoint),
    and a new trainer resuming from that file for N/2 steps: step, count,
    parameters and both moments bit-equal."""
    from rqvae_tpu_torch.data.registry import RecDataset
    from rqvae_tpu_torch.train import train_rqvae as T
    from rqvae_tpu_torch.train.train_decoder import train
    from rqvae_tpu_torch.utils.checkpoint import export_jax_checkpoint, load_checkpoint
    from rqvae_tpu_torch.utils.config import apply_config

    def compare(stage: str, whole: dict, rest: dict, jax_file: str) -> dict:
        a, b = load_checkpoint(whole["checkpoint_path"]), load_checkpoint(rest["checkpoint_path"])
        j = load_checkpoint(jax_file)
        same = {"step": a["step"] == b["step"], "count": a["opt_state"]["count"] == b["opt_state"]["count"],
                "params": all(torch.equal(a["params"][k], b["params"][k]) for k in a["params"]),
                "moments": all(torch.equal(x, y) for x, y in zip(a["opt_state"]["mu"] + a["opt_state"]["nu"],
                                                                  b["opt_state"]["mu"] + b["opt_state"]["nu"]))}
        check(all(same.values()), f"resume_jax_layout {stage}: against the unbroken run {same}")
        return {"bit_equal": same, "step": b["step"], "count": b["opt_state"]["count"],
                "jax_file": os.path.basename(jax_file), "jax_file_bytes": os.path.getsize(jax_file),
                "opt_state_keys": sorted(j["opt_state"]), "total_loss": [whole["total_loss"], rest["total_loss"]]}

    out = {}
    with tempfile.TemporaryDirectory() as root:
        n = RESUME_STEPS["stage2"]
        folder, rq_ckpt, _ = write_training_inputs(os.path.join(root, "s2"), TRAIN_AMAZON, rq, x_cpu, seed=12)
        kw = dict(train_kwargs(TRAIN_AMAZON, AMAZON, folder, rq_ckpt), partial_eval_every=1000, full_eval_every=1000,
                  full_eval_max_batches=1, save_model_every=1000, log_every=2, device=dev)
        t0 = time.perf_counter()
        whole = train(iterations=n, save_dir_root=os.path.join(root, "whole"), **kw)
        half = train(iterations=n // 2, save_dir_root=os.path.join(root, "half"), **kw)
        jax_file = export_jax_checkpoint(half["checkpoint_path"], os.path.join(root, "jax"))
        rest = train(iterations=n // 2, pretrained_decoder_path=jax_file, save_dir_root=os.path.join(root, "rest"),
                     **kw)
        out["stage2"] = {"config": "decoder_amazon.gin (bf16)", "steps": [n, n // 2, n // 2],
                         "train_calls_s": time.perf_counter() - t0, **compare("stage2", whole, rest, jax_file)}

        n = RESUME_STEPS["stage1"]
        folder = write_item_dataset(os.path.join(root, "s1"), corpus_cpu, seed=13)
        gin = "configs/rqvae_amazon.gin"
        run = lambda save, **kw1: apply_config(  # noqa: E731
            T.train, gin, dataset=RecDataset.SYNTHETIC, dataset_folder=folder, eval_every=10**6,
            save_model_every=10**6, log_every=n // 2, save_dir_root=os.path.join(root, save), device=dev, **kw1)
        t0 = time.perf_counter()
        whole = run("rq_whole", iterations=n)
        half = run("rq_half", iterations=n // 2)
        jax_file = export_jax_checkpoint(half["checkpoint_path"], os.path.join(root, "rq_jax"))
        rest = run("rq_rest", iterations=n // 2, pretrained_rqvae_path=jax_file)
        out["stage1"] = {"config": gin, "steps": [n, n // 2, n // 2], "train_calls_s": time.perf_counter() - t0,
                         **compare("stage1", whole, rest, jax_file)}
    emit({"phase": "resume_jax_layout", **out})


def sampled_eval_and_hub_phases(rq, x_cpu, x, counts, dev) -> dict:
    """One stage-2 trainer run at the Amazon settings with
    sample_candidates=True and push_vae_to_hf=True (2 steps, the full
    evaluation once, one batch of 640): it finishes; its beams, hits@k and
    NDCG equal a generate fed the same noise (the generator of (seed, 999));
    kernel 2 held against its plain version on that call's operands; the
    sampled and the deterministic generate's ms. Then the export: the kept
    path printed, and the tokenizer from_pretrained gives builds its bf16
    index (kernel 1) ID for ID as the trainer's RQ-VAE. Returns the trainer
    run's launches (the path; not the checks' calls after it): its counters,
    its step graph's capture uncounted, and the graph's nodes x replays."""
    import dataclasses
    import io

    from rqvae_tpu_torch.data.datasets import SeqDataset
    from rqvae_tpu_torch.data.registry import RecDataset, ensure_dataset
    from rqvae_tpu_torch.models.retrieval import EncoderDecoderRetrievalModel
    from rqvae_tpu_torch.models.rqvae import RqVae
    from rqvae_tpu_torch.ops.metrics import TopKAccumulator
    from rqvae_tpu_torch.serving.beam import build_prefix_table
    from rqvae_tpu_torch.tokenizer.semids import SemanticIdTokenizer
    from rqvae_tpu_torch.train import train_decoder as TD
    from rqvae_tpu_torch.train.decoder_steps import make_generate_fn
    from rqvae_tpu_torch.train.train_decoder import eval_noise
    from rqvae_tpu_torch.utils import hub
    from rqvae_tpu_torch.utils.checkpoint import load_checkpoint

    geo = TRAIN_AMAZON
    with tempfile.TemporaryDirectory() as root:
        folder, rq_ckpt, _ = write_training_inputs(root, geo, rq, x_cpu, seed=12)
        kw = train_kwargs(geo, AMAZON, folder, rq_ckpt)
        printed, beams = io.StringIO(), []
        make_generate = TD.make_generate_fn

        def recording_generate_fn(model):  # the trainer's beams, recorded as they are
            generate = make_generate(model)

            def run(batch, table, noise=None):
                out = generate(batch, table, noise)
                beams.append(out.sem_ids.clone())
                return out
            return run

        counts.zero()
        t0 = time.perf_counter()
        TD.make_generate_fn = recording_generate_fn
        try:
            with contextlib.redirect_stdout(printed), \
                    recorded_steps(TD, "make_decoder_graph_train_step", counts, []) as steps:
                s = TD.train(iterations=2, sample_candidates=True, push_vae_to_hf=True, full_eval_every=2,
                             full_eval_max_batches=1, partial_eval_every=1000, save_model_every=1000, log_every=2,
                             save_dir_root=os.path.join(root, "dec"), device=dev, **kw)
        finally:
            TD.make_generate_fn = make_generate
        sync()
        train_s = time.perf_counter() - t0
        counted = counts.read()
        check(counted["attention"] == counted["attention_bwd"] == 0,
              f"sampled_eval: the wrappers ticked outside the step graph's capture: {counted}")
        replays = [st.chunks.replays for st in steps]
        check(replays == [2], f"sampled_eval: the trainer's step graph replays {replays}")
        got = add_launches(counted, replayed_launches(steps, root))
        del steps
        export = os.path.join(root, "dec", "rqvae_export")
        hub_lines = [line for line in printed.getvalue().splitlines() if line.startswith("[hub]")]
        check(len(hub_lines) == 1 and hub_lines[0].endswith(f"local export kept at {export}"),
              f"hub_export: printed {hub_lines}")
        check_summary("sampled_eval", s)
        check(got["decoder_stack"] == 3 and got["rq_encode"] >= 1
              and got["attention"] == got["attention_bwd"] == 4 * 2, f"sampled_eval: launches {got}")

        restored = load_checkpoint(s["checkpoint_path"])
        cfg = restored["config"]
        check(cfg.sample_candidates and cfg.n_candidates < cfg.codebook_size, f"sampled_eval: config {cfg}")
        model = EncoderDecoderRetrievalModel(cfg, device=dev)
        model.load_state_dict(restored["params"])
        tokenizer = SemanticIdTokenizer(rq, device=dev)
        cached = tokenizer.precompute_corpus_ids(x)
        prefix_table = build_prefix_table(cached[:, :3], 256)
        eval_data = SeqDataset(ensure_dataset(folder, RecDataset.SYNTHETIC), split="test")
        eb, valid = next(iter(eval_data.iter_eval_batches(geo["batch"], with_features=False)))
        tok = tokenizer(eb)
        noise = eval_noise(model, tok, kw["seed"], 0)
        generate = make_generate_fn(model)
        gen = generate(tok, prefix_table, noise)
        acc = TopKAccumulator(ks=[1, 5, 10])
        acc.accumulate(actual=tok.sem_ids_fut[:valid, :3].cpu(), top_k=gen.sem_ids[:valid].cpu())
        want = acc.reduce()
        check(want == {k: s[k] for k in want}, f"sampled_eval: trainer {s} against generate fed its noise {want}")
        same_as_trainer = len(beams) == 1 and bool(torch.equal(beams[0], gen.sem_ids))
        check(same_as_trainer, "sampled_eval: the trainer's beams differ from a generate fed the same noise")
        rows = kernels_against_plain(lambda: generate(tok, prefix_table, noise), counts)
        check(len(rows) == 3 and all(r["kernel"] == "decoder_stack" for r in rows),
              f"sampled_eval: kernel-2 launches held {rows}")
        det = EncoderDecoderRetrievalModel(dataclasses.replace(cfg, sample_candidates=False), device=dev)
        det.load_state_dict(restored["params"])
        det_generate = make_generate_fn(det)
        det_ids = det_generate(tok, prefix_table).sem_ids
        same_beams = float((det_ids == gen.sem_ids).all(-1).all(-1).float().mean())
        times = {"sampled_generate_ms": host_ms(lambda: generate(tok, prefix_table, noise)),
                 "deterministic_generate_ms": host_ms(lambda: det_generate(tok, prefix_table)),
                 "noise_draw_ms": host_ms(lambda: eval_noise(model, tok, kw["seed"], 0))}
        emit({"phase": "sampled_eval", "batch": geo["batch"], "n_candidates": cfg.n_candidates,
              "metrics": {k: s[k] for k in want}, "generate_fed_the_same_noise": want,
              "trainer_beams_equal_generate_fed_the_same_noise": same_as_trainer, "launches": got,
              "train_calls_s": train_s, "kernel_2_against_plain": rows,
              "queries_with_the_deterministic_beams": same_beams, **times})

        files = {f: os.path.getsize(os.path.join(export, f)) for f in sorted(os.listdir(export))}
        check(set(files) == {"config.json", "flax_model.msgpack"}, f"hub_export: files {files}")
        vcfg, state = hub.from_pretrained(export)
        check(vcfg == rq.config, f"hub_export: config {vcfg}")
        rq2 = RqVae(vcfg, device=dev)
        rq2.load_state_dict(state)
        before = counts.read()["rq_encode"]
        ids = SemanticIdTokenizer(rq2, device=dev).precompute_corpus_ids(x)
        check(counts.read()["rq_encode"] == before + 1, "hub_export: the index build did not launch kernel 1")
        same = bool(torch.equal(ids, cached))
        check(same, f"hub_export: {int((ids != cached).any(1).sum())} items differ from the trainer's RQ-VAE")
        emit({"phase": "hub_export", "printed": hub_lines[0], "files": files, "items": int(x.shape[0]),
              "index_ids_equal": same, "precision": "bf16"})
        del model, det, rq2
    torch.cuda.empty_cache()
    return got


# ---- serving as it is deployed: checkpoints, saved index, bucket graphs, growth, queue ----

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures", "jax_synthetic")
FIXTURE_LOGP_TOL = 1e-4  # card (kernels, f32) against the JAX XLA path's stored log-probas
GROWTH = 4096  # items admitted after capture at the Amazon width
QUEUE = dict(requests=1024, rates=(250.0, 1000.0), overload_requests=4096, overload_depth=256,
             overload_deadline_ms=50.0)


def rq_encode_packed_phase(rq, x) -> dict:
    """Kernel 1's emit_packed epilogue at the Amazon width, both precisions:
    ids equal to an unpacked launch's, the key column equal to
    pack_sem_id_tuples of them; the epilogue's extra ms."""
    from rqvae_tpu_torch.ops.cuda.rq_encode import fused_encode_quantize
    from rqvae_tpu_torch.ops.dedup import pack_sem_id_tuples

    w, cb = rq.encoder.kernels(), rq.codebooks.detach()
    out = {}
    with torch.no_grad():
        for precision in ("f32", "bf16"):
            ids = fused_encode_quantize(x, w, cb, 3, precision=precision)
            packed = fused_encode_quantize(x, w, cb, 3, precision=precision, emit_packed=True)
            sync()
            check(torch.equal(packed[:, :3], ids), f"rq_encode_packed {precision}: ids differ from the unpacked launch")
            check(torch.equal(packed[:, 3], pack_sem_id_tuples(ids, cb.shape[1])),
                  f"rq_encode_packed {precision}: key column differs from pack_sem_id_tuples")
            plain_ms = cuda_ms(lambda: fused_encode_quantize(x, w, cb, 3, precision=precision), reps=20)
            packed_ms = cuda_ms(lambda: fused_encode_quantize(x, w, cb, 3, precision=precision, emit_packed=True),
                                reps=20)
            out[precision] = {"ms": packed_ms, "unpacked_ms": plain_ms, "extra_ms": packed_ms - plain_ms}
    emit({"phase": "rq_encode_packed", "items": int(x.shape[0]), "ids_equal": True, "key_equal": True, **out})
    return {f"packed_{p}_extra_ms": v["extra_ms"] for p, v in out.items()}


def our_kernels(names: dict) -> dict:
    """The count of the port's kernels among kernel names."""
    keys = {"rq_encode": "rq_encode", "decoder_stack": "decoder_stack", "encoder_stack": "encoder_rows",
            "attention": "attention"}
    return {k: sum(c for n, c in names.items() if pat in n) for k, pat in keys.items()}


def demangle(name: str) -> str:
    """A C++ symbol as the profiler names its kernel (libstdc++'s
    __cxa_demangle); a name that is not mangled comes back as it is."""
    import ctypes

    fn = ctypes.CDLL("libstdc++.so.6").__cxa_demangle
    fn.restype, fn.argtypes = ctypes.c_void_p, [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
                                                ctypes.POINTER(ctypes.c_int)]
    status = ctypes.c_int()
    ptr = fn(name.encode(), None, None, ctypes.byref(status))
    if status.value or not ptr:
        return name
    out = ctypes.string_at(ptr).decode()
    free = ctypes.CDLL("libc.so.6").free
    free.argtypes = [ctypes.c_void_p]
    free(ptr)
    return out


def graph_nodes(graph, root: str) -> dict:
    """The nodes of one of the engine's bucket graphs (kept at capture), read
    from its debug dump: each kernel by its demangled name and the copy and
    memset nodes under profile_call's one name for them."""
    path = os.path.join(root, "graph.dot")
    graph.debug_dump(path)
    with open(path) as f:
        text = f.read()
    kinds = re.findall(r'label="\{\n?([A-Z_]+)\n', text)
    names = {}
    for name in re.findall(r'label="\{KERNEL\n\| \{ID \| \d+ \(topoId: \d+\) \| ([^}\\]*)', text):
        name = demangle(name)
        names[name] = names.get(name, 0) + 1
    check(sum(names.values()) == kinds.count("KERNEL") > 0, f"graph dump: {len(kinds)} nodes not read")
    check(set(kinds) <= {"KERNEL", "MEMCPY", "MEMSET"}, f"graph dump: node kinds {sorted(set(kinds))}")
    copies = kinds.count("MEMCPY") + kinds.count("MEMSET")
    return {**names, DEVICE_COPY: copies} if copies else names


def kernels_against_plain(fn, counts) -> list:
    """Kernels 2 and 3 at the shapes one call of `fn` gives them: the call
    runs with both wrappers recording their operands, and each recorded
    launch is held against its plain version on the same operands with the
    decoder_stack and encoder_stack phases' gates (the bf16 decoder with the
    encoder phase's bf16 pair, see below). Launches made here do not count. Returns one row per launch: kernel, output shape, route, errors."""
    from rqvae_tpu_torch.models import t5
    from rqvae_tpu_torch.ops.cuda import decoder_stack as D
    from rqvae_tpu_torch.ops.cuda import encoder_stack as E

    plain = {"t5_decoder_stack_infer": D.t5_decoder_stack_plain, "t5_encoder_stack_infer": E.t5_encoder_stack_plain}
    kernel = {name: getattr(t5, name) for name in plain}
    calls = []

    def recording(name):
        def run(*ops, eps):
            y = kernel[name](*ops, eps=eps)
            calls.append((name, ops, eps, y))
            return y
        return run

    before = counts.read()
    for name in plain:
        setattr(t5, name, recording(name))
    try:
        with torch.no_grad():
            fn()
    finally:
        for name, f in kernel.items():
            setattr(t5, name, f)
    rows = []
    with torch.no_grad():
        for name, ops, eps, y in calls:
            y_plain = plain[name](*ops, eps=eps)
            dt = ops[0].dtype
            if name == "t5_decoder_stack_infer":
                B, kT, d, NL, H, dk, dff, Le = D._check_cuda(*ops)
                tol, mean_tol = DECODER_TOL[dt], None
                if dt == torch.bfloat16:
                    # the tokens come from the bf16 index, where one flipped bf16 rounding of the
                    # residual stream crosses the decoder phase's 0.06 by a step (0.0625, PERF.md
                    # section 7): the bf16 pair of the encoder phase, the entries above 0.06 counted
                    tol, mean_tol = ENCODER_TOL[dt]
                route = D.decoder_stack_route(kT, d, dk, H * dk, dff, Le, dt)
            else:
                B, L, d, NL, H, dk, dff = E._check_cuda(*ops)
                tol, mean_tol = ENCODER_TOL[dt]
                route = E.encoder_stack_route(d, dk, H * dk, dff, dt)
            errs = error_distribution(y, y_plain, tol)
            what = f"{name[3:16]} {dtype_name(dt)} at {tuple(y.shape)}"
            check(bool(torch.isfinite(y).all()), f"{what}: non-finite output")
            check(errs["max_abs_err"] <= tol and (mean_tol is None or errs["mean_abs_err"] <= mean_tol),
                  f"{what}: {errs} against tol {tol}, mean tol {mean_tol}")
            if name == "t5_decoder_stack_infer":
                errs["above_decoder_tol"] = int(((y - y_plain).abs() > DECODER_TOL[dt]).sum())
            rows.append({"kernel": name[3:16], "shape": list(y.shape), "route": route, **errs})
    counts.restore(before)
    return rows


def write_jax_checkpoints(root: str, rq, model):
    """The seeded weights as the JAX package's checkpoint files."""
    from rqvae_tpu_torch.utils.checkpoint import save_checkpoint
    from rqvae_tpu_torch.utils.convert import jax_params_from_state_dict

    rq_path = save_checkpoint(os.path.join(root, "rqvae"), 0, jax_params_from_state_dict(rq), config=rq.config,
                              fmt="msgpack")
    dec_path = save_checkpoint(os.path.join(root, "decoder"), 0, jax_params_from_state_dict(model),
                               config=model.config, fmt="msgpack")
    return rq_path, dec_path


def bucket_route(model, items: int) -> dict:
    """Which kernels a bucket's encoder and decoder rows take (models/t5.py
    gates), and each kernel's route (ops/cuda route functions; the decoder
    kernel's per beam level, kT = 1, 2k, 3k)."""
    from rqvae_tpu_torch.ops.cuda.decoder_stack import decoder_stack_route
    from rqvae_tpu_torch.ops.cuda.encoder_stack import encoder_stack_route

    cfg = model.config
    Le = items * (cfg.num_hierarchies + int(cfg.should_add_sep_token))
    widths = (cfg.t5_d_model, cfg.t5_d_kv, cfg.t5_num_heads * cfg.t5_d_kv, cfg.t5_d_ff)
    dtype = getattr(torch, cfg.t5_dtype)
    enc = model.encoder
    if enc.use_fused_encode(Le):
        encoder = f"encoder_stack kernel ({encoder_stack_route(*widths, dtype)})"
    elif enc.block[0].self_attn._use_fused(Le, Le):
        encoder = "attention kernel"
    else:
        encoder = "plain"
    k = cfg.top_k_for_generation
    levels = [1] + [k * (h + 1) for h in range(1, cfg.num_hierarchies)]
    decoder = (f"decoder_stack kernel ({', '.join(decoder_stack_route(kT, *widths, Le, dtype) for kT in levels)})"
               if model.decoder.use_fused_decode(Le) else "plain")
    return {"Le": Le, "encoder": encoder, "decoder": decoder}


def bucket_histories(n_items: int, bb: int, ib: int, seed: int) -> np.ndarray:
    r = np.random.RandomState(seed)
    hist = r.randint(0, n_items, (bb, ib)).astype(np.int32)
    lengths = r.randint(1, ib + 1, bb)
    return np.where(np.arange(ib)[None, :] < lengths[:, None], hist, -1).astype(np.int32)


def replay_ms(eng, g, reps: int = 5) -> float:
    """CUDA-event ms of one bucket graph's replay on the engine's stream."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.cuda.stream(eng.stream):
        g.graph.replay()
        start.record()
        for _ in range(reps):
            g.graph.replay()
        end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int = 5) -> list:
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def serve_phase(phase: str, geo: dict, counts, dev, seed: int):
    """The deployed serving path at one geometry: seeded full-width weights
    written as JAX-format checkpoints; a first from_checkpoints start that
    builds and saves the index (kernel 1 once) and a second that loads it
    (kernel 1 no time); warmup() captures every bucket; per bucket the
    route, replay equal to eager bit for bit, each launch of kernels 2 and 3
    against its plain version on its own operands, the engine's graph equal
    by kernel name to one eager call's launches, eager and replayed ms; then
    retrieve_many over 256 mixed-length histories against the eager engine,
    and the graph pool's memory. The wrapper counts returned are the first
    start's index build and the eager calls made after the warm-up; the
    replays' launches are the graphs' nodes (`our_kernels` per bucket).
    Returns (wrapper launch counts, engine, RQ-VAE, corpus)."""
    from rqvae_tpu_torch.serving.engine import RetrievalEngine
    from rqvae_tpu_torch.serving.retriever import Retriever

    rq, x_cpu, x = make_rqvae(geo, dev)
    model = retrieval_model("bfloat16", dev)
    tmp = tempfile.mkdtemp(prefix=f"{phase}_")
    rq_path, dec_path = write_jax_checkpoints(tmp, rq, model)
    del model
    index_path = os.path.join(tmp, "index.npz")
    feats = x_cpu.numpy()
    counts.zero()
    starts = {}
    for name in ("build", "load"):
        sync()
        t0 = time.perf_counter()
        r = Retriever.from_checkpoints(rq_path, dec_path, feats, index_path=index_path, device=dev)
        sync()
        starts[name] = {"ms": (time.perf_counter() - t0) * 1e3, "rq_encode_launches": counts.read()["rq_encode"]}
        counts.zero()
    check(starts["build"]["rq_encode_launches"] == 1 and starts["load"]["rq_encode_launches"] == 0,
          f"{phase}: index build / load launches {starts}")
    counts.zero()
    eng = RetrievalEngine(r, max_items=geo["history"])
    reset_peak_memory()
    before, reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    sync()
    t0 = time.perf_counter()
    n_graphs = eng.warmup()
    sync()
    warmup_s = time.perf_counter() - t0
    # the graphs' static tensors stay allocated; the pool keeps the segments their captures used
    pool = {"graphs": n_graphs, "warmup_s": warmup_s, "allocated_bytes": torch.cuda.memory_allocated() - before,
            "reserved_bytes": torch.cuda.memory_reserved() - reserved, "peak_bytes": peak_memory() - before}
    counts.zero()  # the warm-up's captures tick the wrappers but launch nothing
    buckets = []
    for i, ((bb, ib), (g,)) in enumerate(sorted(eng.graphs.items())):  # one graph a bucket: no mesh
        hist = bucket_histories(geo["items"], bb, ib, seed + i)
        users = np.zeros(bb, np.int32)
        eager = r.retrieve(hist)
        flight = eng._replay(hist, users)
        flight.event.synchronize()
        same = all(torch.equal(h, e.cpu()) for h, e in zip(flight.host, eager))
        check(same, f"{phase}: bucket ({bb}, {ib}) replay differs from eager")
        # replay and eager run the same kernels: hold kernels 2 and 3 at this bucket's shapes
        # against their plain versions
        held = kernels_against_plain(lambda: r.retrieve(hist), counts)
        # the engine's graph of the bucket (its debug dump) holds, kernel by kernel, what one eager
        # call of the body launches (profiler; a profile can drop events: up to three)
        h_dev = torch.as_tensor(hist, device=dev)
        u_dev = torch.zeros(bb, dtype=torch.int32, device=dev)
        nodes = graph_nodes(g.graph, tmp)
        for attempt in range(1, 4):
            eager_call = profile_call(lambda: r._retrieve_body(h_dev, u_dev), by_name=True)
            if eager_call["names"] == nodes:
                break
        e_names = eager_call["names"]
        differ = {n[:90]: [nodes.get(n, 0), e_names.get(n, 0)] for n in set(nodes) | set(e_names)
                  if nodes.get(n, 0) != e_names.get(n, 0)}
        ours = our_kernels(nodes)
        check(not differ, f"{phase}: bucket ({bb}, {ib}) kernels by name, graph against eager: {differ}")
        replay_prof = profile_call(lambda: eng._replay(hist, users).event.synchronize())
        route = bucket_route(r.model, ib)
        want = {"decoder_stack": 3 * route["decoder"].startswith("decoder_stack"),
                "encoder_stack": int(route["encoder"].startswith("encoder_stack"))}
        got = {k: sum(h["kernel"] == k for h in held) for k in want}
        check(got == want, f"{phase}: bucket ({bb}, {ib}) held {got} launches against the plain versions, "
                           f"its route {route} gives {want}")
        row = {"bucket": [bb, ib], **route,
               "kernels_held": [[h["kernel"], h["shape"], h["route"], h["max_abs_err"], h["mean_abs_err"],
                                 h.get("above_decoder_tol")] for h in held],
               "eager_ms": cuda_ms(lambda: r.retrieve(hist), reps=5, warmup=1),
               "eager_host_ms": host_ms(lambda: r.retrieve(hist)),
               "replay_ms": replay_ms(eng, g),
               "replay_host_ms": host_ms(lambda: eng._replay(hist, users).event.synchronize()),
               "replay_profile": {k: replay_prof[k] for k in ("host_ms", "device_ms", "device_launches",
                                                                "device_idle_share")},
               "eager_profile": {k: eager_call[k] for k in ("host_ms", "device_ms", "device_launches",
                                                            "device_idle_share")},
               "graph_nodes": sum(nodes.values()), "graph_copies": nodes.get(DEVICE_COPY, 0),
               "profiles_to_match": attempt, "our_kernels": ours,
               "valid_beams": float((flight.host.item_ids >= 0).float().mean())}
        # the card's idle share of a replayed call: 1 - the graph's time on the card (CUDA events) over
        # the call's host time (inputs in, replay, results out, wait)
        row["replay_idle_share_events"] = max(0.0, 1.0 - row["replay_ms"] / float(np.median(row["replay_host_ms"])))
        buckets.append(row)
    r_ng = np.random.RandomState(seed + 100)
    reqs = [r_ng.randint(0, geo["items"], r_ng.randint(1, geo["history"] + 6)).astype(np.int32) for _ in range(256)]
    sync()
    t0 = time.perf_counter()
    got = eng.retrieve_many(reqs)
    many_ms = (time.perf_counter() - t0) * 1e3
    eager_eng = RetrievalEngine(r, max_items=geo["history"], cuda_graphs=False)
    t0 = time.perf_counter()
    want = eager_eng.retrieve_many(reqs)
    many_eager_ms = (time.perf_counter() - t0) * 1e3
    for a, b in zip(got, want):
        check(np.array_equal(a, b), f"{phase}: retrieve_many over 256 histories differs from the eager engine")
    launches = counts.read()
    launches["rq_encode"] += starts["build"]["rq_encode_launches"]  # the first start's index build
    emit({"phase": phase, "items": geo["items"], "max_items": geo["history"], "item_buckets": eng.item_buckets,
          "batch_buckets": eng.batch_buckets, "startup": starts, "graph_pool": pool, "buckets": buckets,
          "retrieve_many": {"requests": len(reqs), "shapes": {str(k): v for k, v in eng.shape_counts.items()},
                            "graphs_ms": many_ms, "eager_ms": many_eager_ms},
          "wrapper_launches": launches})
    shutil.rmtree(tmp, ignore_errors=True)
    return launches, eng, rq, x


def corpus_growth_phase(eng, rq, x, counts, dev) -> dict:
    """extend_corpus after capture at the Amazon width: GROWTH new items (some
    equal to old items or to each other, so the dedup column counts across
    both), kernel 1 once; the dedup column equals a full rebuild's, and the
    replays return what an engine over the rebuilt corpus returns, new items
    among them."""
    from rqvae_tpu_torch.serving.engine import RetrievalEngine
    from rqvae_tpu_torch.serving.retriever import Retriever
    from rqvae_tpu_torch.tokenizer.semids import SemanticIdTokenizer

    n = x.shape[0]
    model = eng.retriever.model
    tok = SemanticIdTokenizer(rq, device=dev)
    tok.precompute_corpus_ids(x)
    grown = Retriever(model, tok, device=dev, capacity=n + GROWTH)
    geng = RetrievalEngine(grown, max_items=eng.max_items)
    geng.warmup()
    new = make_corpus(GROWTH, x.shape[1], seed=21).to(dev)
    new[:64] = x[:64]  # equal to old items
    new[100:110] = new[:10]  # equal to earlier new items
    ptrs = [t.data_ptr() for t in grown.corpus_tensors()]
    counts.zero()
    sync()
    t0 = time.perf_counter()
    check(grown.extend_corpus(new) == n + GROWTH, "corpus_growth: size")
    extend_ms = (time.perf_counter() - t0) * 1e3
    launches = counts.read()
    check(launches["rq_encode"] == 1, f"corpus_growth: kernel-1 launches {launches}")
    check([t.data_ptr() for t in grown.corpus_tensors()] == ptrs, "corpus_growth: a corpus tensor moved")
    full = SemanticIdTokenizer(rq, device=dev)
    full.precompute_corpus_ids(torch.cat([x, new]))
    check(torch.equal(grown.tokenizer.cached_ids, full.cached_ids), "corpus_growth: ids or dedup differ from a rebuild")
    dedup_new = grown.tokenizer.cached_ids[n:, 3]
    fresh = RetrievalEngine(Retriever(model, full, device=dev), max_items=eng.max_items, cuda_graphs=False)
    r_ng = np.random.RandomState(22)
    reqs = [r_ng.randint(n, n + GROWTH, r_ng.randint(1, eng.max_items + 1)).astype(np.int32) for _ in range(128)]
    got, want = geng.retrieve_many(reqs), fresh.retrieve_many(reqs)
    for a, b in zip(got, want):
        check(np.array_equal(a, b), "corpus_growth: replays differ from an engine over the rebuilt corpus")
    admitted = int((got.item_ids >= n).sum())
    check(admitted > 0, "corpus_growth: no admitted item was returned")
    emit({"phase": "corpus_growth", "items": n, "admitted": GROWTH, "capacity": grown.capacity,
          "extend_ms": extend_ms, "launches": launches, "new_rows_with_dedup": int((dedup_new > 0).sum()),
          "max_dedup_new": int(dedup_new.max()), "requests": len(reqs), "admitted_items_returned": admitted,
          "valid_beams": float((got.item_ids >= 0).mean())})
    return launches


def queue_phase(eng, n_items: int) -> None:
    """An AsyncRetrievalEngine over the Amazon engine: every future equals
    its flush's retrieve_many row; p50/p99 latency and flush sizes at two
    offered rates; rejects and sheds past saturation. Times printed, not gated."""
    from rqvae_tpu_torch.serving.queue import AsyncRetrievalEngine, DeadlineExceededError, QueueOverloadedError

    flushes = []
    real = eng.retrieve_many_device

    def recording(histories, user_ids=None):
        flushes.append((list(histories), list(user_ids)))
        return real(histories, user_ids)

    eng.retrieve_many_device = recording
    r_ng = np.random.RandomState(31)

    def requests(count):
        return [r_ng.randint(0, n_items, r_ng.randint(1, eng.max_items + 1)).astype(np.int32) for _ in range(count)]

    def offer(q, reqs, rate):
        futs, t0 = [], time.perf_counter()
        for i, h in enumerate(reqs):
            if rate:
                wait = t0 + i / rate - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
            futs.append((h, i, q.submit(h, i)))
        return futs, time.perf_counter() - t0

    rows = []
    try:
        for rate in QUEUE["rates"]:
            flushes.clear()
            reqs = requests(QUEUE["requests"])
            with AsyncRetrievalEngine(eng, max_delay_ms=2.0) as q:
                futs, offer_s = offer(q, reqs, rate)
                results = {id(h): f.result(timeout=120) for h, _, f in futs}
            stats = q.stats()
            for hists, uids in flushes:  # each future equals its flush's rows, recomputed
                want = eng.finalize_many(len(hists), real(hists, uids))
                for j, h in enumerate(hists):
                    got = results[id(h)]
                    check(all(np.array_equal(a, w[j]) for a, w in zip(got, want)),
                          "queue: a future differs from its retrieve_many row")
            sizes = [len(h) for h, _ in flushes]
            rows.append({"offered_per_s": rate, "requests": len(reqs), "offer_s": offer_s,
                         "submitted_per_s": len(reqs) / max(offer_s, 1e-9),
                         "latency_p50_ms": stats["latency_p50_s"] * 1e3,
                         "latency_p99_ms": stats["latency_p99_s"] * 1e3, "flushes": len(flushes),
                         "flush_size_mean": float(np.mean(sizes)), "flush_size_max": int(max(sizes))})
        reqs = requests(QUEUE["overload_requests"])
        with AsyncRetrievalEngine(eng, max_delay_ms=2.0, max_queue_depth=QUEUE["overload_depth"],
                                  deadline_ms=QUEUE["overload_deadline_ms"]) as q:
            futs, offer_s = offer(q, reqs, None)
            outcome = {"served": 0, "rejected": 0, "shed": 0}
            for _, _, f in futs:
                try:
                    f.result(timeout=120)
                    outcome["served"] += 1
                except QueueOverloadedError:
                    outcome["rejected"] += 1
                except DeadlineExceededError:
                    outcome["shed"] += 1
        stats = q.stats()
        check(outcome["rejected"] == stats["rejected"] and outcome["shed"] == stats["shed"],
              f"queue overload: futures {outcome} against stats {stats}")
    finally:
        eng.retrieve_many_device = real
    emit({"phase": "queue", "max_delay_ms": 2.0, "rates": rows,
          "overload": {"requests": len(reqs), "max_queue_depth": QUEUE["overload_depth"],
                       "deadline_ms": QUEUE["overload_deadline_ms"], "offer_s": offer_s, **outcome,
                       "latency_p50_ms": stats.get("latency_p50_s", float("nan")) * 1e3,
                       "latency_p99_ms": stats.get("latency_p99_s", float("nan")) * 1e3}})


# ---- scale-out: data-parallel ranks (one process each) and sharded serving ----

LAUNCH_MARKERS = ("RQVAE_TPU_NUM_PROCESSES", "RQVAE_TPU_PROCESS_ID", "JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
                  "RQVAE_TPU_DISTRIBUTED", "WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                  "MASTER_PORT")


def graph_dump(graph, root: str) -> dict:
    """A step graph's node kinds and kernels by demangled name, read from its
    debug dump without graph_nodes' checks (a graph that holds collectives
    may carry other node kinds)."""
    path = os.path.join(root, "step_graph.dot")
    graph.debug_dump(path)
    with open(path) as f:
        text = f.read()
    kinds, names = {}, {}
    for kind in re.findall(r'label="\{\n?([A-Z_]+)\n', text):
        kinds[kind] = kinds.get(kind, 0) + 1
    for name in re.findall(r'label="\{KERNEL\n\| \{ID \| \d+ \(topoId: \d+\) \| ([^}\\]*)', text):
        name = demangle(name)
        names[name] = names.get(name, 0) + 1
    return {"kinds": kinds, "kernels": names}


def plant_fault(fault) -> None:
    """A data-parallel fault planted in this rank, for a gate's control run:
    "rank1_dropout_from_0", rank 1's dropout sites (hash dropout and kernels
    4 and 5) count from global row 0, as rank 0's do; "rank1_grads_left_out",
    rank 1 adds zeros to the gradients' all-reduce, so the mean holds rank
    0's alone. Either way the ranks stay bit-equal and the run completes."""
    from rqvae_tpu_torch.parallel import dist
    from rqvae_tpu_torch.train import decoder_steps

    if fault is None:
        return
    if fault == "rank1_dropout_from_0":
        rank_seeds = decoder_steps._rank_seeds

        def from_zero(seeds, replicas, rows):
            out = rank_seeds(seeds, replicas, rows)
            return out._replace(b0=0) if replicas is not None and replicas.rank == 1 and out is not None else out

        decoder_steps._rank_seeds = from_zero
    elif fault == "rank1_grads_left_out":
        average = dist.Replicas.average_step_

        def left_out(self, params, metrics, exact=()):
            if self.rank == 1:
                for p in params:
                    if p.grad is not None:
                        p.grad.zero_()
            return average(self, params, metrics, exact)

        dist.Replicas.average_step_ = left_out
    else:
        raise ValueError(f"no planted fault {fault!r}")


def rank_worker(spec_path: str) -> int:
    """One process of a data-parallel phase (started by launch_ranks): a
    trainer's CLI, `main(argv)`, under the launch markers it was given. It
    writes what the parent checks: the trainer's summary, the wrapper
    counters (a step graph's capture uncounted, its replays as nodes x
    replays), the b0 values kernels 4 and 5 were launched with, and, for a
    step graph, its nodes and a replayed step's time."""
    with open(spec_path) as f:
        spec = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from rqvae_tpu_torch.ops.cuda import attention as A
    from rqvae_tpu_torch.parallel import dist
    from rqvae_tpu_torch.train import train_decoder, train_rqvae

    module, factory = ((train_decoder, "make_decoder_graph_train_step") if spec["stage"] == 2
                       else (train_rqvae, "make_rqvae_graph_train_step"))
    b0s = {"forward": set(), "backward": set()}
    fwd, bwd = A._forward_cuda, A._backward_cuda

    def fwd_b0(*a, b0=0, **kw):
        b0s["forward"].add(int(b0))
        return fwd(*a, b0=b0, **kw)

    def bwd_b0(*a, b0=0, **kw):
        b0s["backward"].add(int(b0))
        return bwd(*a, b0=b0, **kw)

    A._forward_cuda, A._backward_cuda = fwd_b0, bwd_b0
    plant_fault(spec.get("fault"))
    summaries = []
    run = module.train

    @functools.wraps(run)
    def train(*a, **kw):
        summaries.append(run(*a, **kw))
        return summaries[-1]

    module.train = train
    counts = LaunchCounts()
    counts.zero()
    steps = []
    with tempfile.TemporaryDirectory() as tmp, recorded_steps(module, factory, counts, steps):
        module.main(spec["argv"])
        sync()
        eager = counts.read()
        dumps = [(s.chunks.replays, graph_dump(s.chunks.graph, tmp)) for s in steps if s.chunks.graph is not None]
        replayed = [{k: v * n for k, v in graph_launches(d["kernels"]).items()} for n, d in dumps]
        out = {"rank": dist.process_index(), "world": dist.process_count(),
               "backend": None if dist.replicas() is None else dist.replicas().backend,
               "summary": {k: v for k, v in summaries[-1].items() if isinstance(v, (int, float, str))},
               "eager_launches": eager, "launches": add_launches(eager, *replayed),
               "b0": {k: sorted(v) for k, v in b0s.items()}, "graph": None}
        chunks = steps[-1].chunks
        if chunks.graph is not None:
            out["graph"] = {**dumps[-1][1], "replays": chunks.replays, **replay_timing(chunks, chunks.n_steps)}
    with open(f"{spec['out']}.rank{out['rank']}.json", "w") as f:
        json.dump(out, f)
    if dist.replicas() is not None:
        torch.distributed.destroy_process_group()
    return 0


def launch_ranks(phase: str, root: str, spec: dict, world: int, markers: bool = True):
    """`world` processes of rank_worker on `spec` (no launch markers: one
    process alone), gathered before anything is judged; a rank that fails
    or outlives RANK_TIMEOUT_S has its peers killed, and no process is left
    behind. Returns (each rank's results, each rank's stdout)."""
    import socket

    spec = dict(spec, out=os.path.join(root, phase))
    path = os.path.join(root, f"{phase}.spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    sock = socket.socket()
    sock.bind(("localhost", 0))
    port = sock.getsockname()[1]
    sock.close()
    procs = []
    for rank in range(world):
        env = {k: v for k, v in os.environ.items() if k not in LAUNCH_MARKERS}
        if markers:
            env.update(RQVAE_TPU_NUM_PROCESSES=str(world), RQVAE_TPU_PROCESS_ID=str(rank),
                       JAX_COORDINATOR_ADDRESS=f"localhost:{port}")
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank-worker", path],
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
                                      cwd=REPO_DIR))
    deadline = time.monotonic() + RANK_TIMEOUT_S
    results = []
    try:
        for p in procs:
            try:
                out, err = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                out, err = p.communicate()
                err = f"[timed out after {RANK_TIMEOUT_S} s]\n{err}"
            results.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    check(all(rc == 0 for rc, _, _ in results),
          f"{phase}: " + " ".join(f"rank {i} rc={rc}: {err[-1500:]}" for i, (rc, _, err) in enumerate(results)))
    got = []
    for rank in range(world):
        with open(f"{spec['out']}.rank{rank}.json") as f:
            got.append(json.load(f))
    return got, [out for _, out, _ in results]


def decoder_cli_argv(folder: str, rq_ckpt: str, save: str, **over) -> list:
    """The stage-2 CLI at configs/decoder_amazon.gin over the synthetic
    dataset file and the frozen RQ-VAE written by write_training_inputs
    (iterations and cadences cut by `over`)."""
    kw = dict(dataset="%data.registry.RecDataset.SYNTHETIC", dataset_folder=f'"{folder}"',
              pretrained_rqvae_path=f'"{rq_ckpt}"', save_dir_root=f'"{save}"', partial_eval_every=1000,
              full_eval_every=1000, full_eval_max_batches=1, save_model_every=1000, seed=0, **over)
    return ["configs/decoder_amazon.gin", *(f"{k}={v}" for k, v in kw.items())]


def logged_losses(save: str) -> dict:
    return {r["step"]: r["total_loss"] for r in read_log(os.path.join(save, "logs")) if "total_loss" in r}


def params_equal(path_a: str, path_b: str) -> bool:
    from rqvae_tpu_torch.utils.checkpoint import load_checkpoint

    a, b = load_checkpoint(path_a), load_checkpoint(path_b)
    return set(a["params"]) == set(b["params"]) and all(torch.equal(a["params"][k], b["params"][k])
                                                        for k in a["params"])


def dp_world_of_one_phase(rq, x_cpu) -> dict:
    """Stage 2 at the Amazon width (batch 640) through the trainer's CLI in
    a process launched with the manual markers for a world of one: NCCL, the
    step graphs on (2 steps a chunk; the cadences, 1000, must fall on chunk
    ends). Against the same run in a process
    alone (no group): the logged losses and the final parameters bit-equal
    (a sum over one rank divided by 1); the graph holds the collectives
    (its nodes against the run alone's); the replayed step's time of
    both."""
    geo = TRAIN_AMAZON
    with tempfile.TemporaryDirectory() as root:
        folder, rq_ckpt, _ = write_training_inputs(root, geo, rq, x_cpu, seed=12)
        runs, stdout = {}, {}
        for name, markers in (("nccl_world_of_one", True), ("alone", False)):
            save = os.path.join(root, name)
            spec = {"stage": 2, "argv": decoder_cli_argv(folder, rq_ckpt, save, iterations=6, steps_per_loop=2,
                                                         log_every=2)}
            (runs[name],), (stdout[name],) = launch_ranks(f"dp1_{name}", root, spec, 1, markers=markers)
            runs[name]["losses"] = logged_losses(save)
        a, b = runs["nccl_world_of_one"], runs["alone"]
        check(a["backend"] == "nccl" and b["backend"] is None, f"dp1: backends {a['backend']}, {b['backend']}")
        check("[dist] backend nccl" in stdout["nccl_world_of_one"], "dp1: the backend line is missing")
        check(a["losses"] == b["losses"] and len(a["losses"]) >= 2, f"dp1: losses {a['losses']} != {b['losses']}")
        same = params_equal(a["summary"]["checkpoint_path"], b["summary"]["checkpoint_path"])
    check(same, "dp1: the world of one's parameters differ from the run without a group")
    check(a["graph"] is not None and b["graph"] is not None, "dp1: a run took no step graph")
    extra = {n: c - b["graph"]["kernels"].get(n, 0) for n, c in a["graph"]["kernels"].items()
             if c != b["graph"]["kernels"].get(n, 0)}
    kinds = {k: c - b["graph"]["kinds"].get(k, 0) for k, c in a["graph"]["kinds"].items()
             if c != b["graph"]["kinds"].get(k, 0)}
    check(bool(extra) or bool(kinds), "dp1: the NCCL step graph holds no node that the graph alone lacks")
    check(a["launches"]["attention"] == b["launches"]["attention"] == 4 * 6,
          f"dp1: kernel 4 launches {a['launches']['attention']}, {b['launches']['attention']}")
    row = {"phase": "dp_world_of_one", "batch": geo["batch"], "iterations": 6, "steps_per_loop": 2,
           "losses": a["losses"], "params_bit_equal": same, "launches": a["launches"],
           "graph_nodes_added_by_the_group": {"kernels": extra, "kinds": kinds},
           "nccl_kernels": {n: c for n, c in a["graph"]["kernels"].items() if "nccl" in n.lower()},
           "replayed_step": {name: {k: r["graph"][k] for k in ("replayed_host_ms", "graph_card_ms", "replay_profile")}
                             for name, r in runs.items()}}
    emit(row)
    return a["launches"]


def dp_two_ranks_phase(rq, x_cpu) -> dict:
    """Stage 2 at the Amazon width on two ranks that share the one card
    (gloo on CUDA tensors), 2 x 320 rows, through the trainer's CLI, 4
    steps in chunks of 2 that run eagerly (the trainer says so); the ranks
    end bit-equal (the trainer checks its parameters and moments across the
    ranks). Against one process at the same settings (its chunks one graph
    replay a step): each logged loss within rtol DP_BF16_RTOL (bf16 kernels,
    the batch split in two and summed in another order), and a control run
    with rank 1's dropout counted from row 0 (plant_fault) outside it. Kernels 4 and 5
    launch 4 a micro-batch on each rank, with b0 = 0 and 320. The two ranks
    share the card's memory and SMs: their step time says nothing of
    scaling."""
    geo = TRAIN_AMAZON
    with tempfile.TemporaryDirectory() as root:
        folder, rq_ckpt, _ = write_training_inputs(root, geo, rq, x_cpu, seed=12)
        argv = lambda save: decoder_cli_argv(folder, rq_ckpt, save, iterations=4, steps_per_loop=2, log_every=2)
        t0 = time.perf_counter()
        ranks, stdout = launch_ranks("dp2", root, {"stage": 2, "argv": argv(os.path.join(root, "two"))}, 2)
        two_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        (one,), _ = launch_ranks("dp2_one", root, {"stage": 2, "argv": argv(os.path.join(root, "one"))}, 1,
                                 markers=False)
        one_s = time.perf_counter() - t0
        two_losses, one_losses = logged_losses(os.path.join(root, "two")), logged_losses(os.path.join(root, "one"))
        launch_ranks("dp2_fault", root, {"stage": 2, "argv": argv(os.path.join(root, "fault")),
                                         "fault": "rank1_dropout_from_0"}, 2)
        fault_losses = logged_losses(os.path.join(root, "fault"))
    check([r["backend"] for r in ranks] == ["gloo", "gloo"], f"dp2: backends {[r['backend'] for r in ranks]}")
    check("[dist] backend gloo" in stdout[0] and "runs eagerly" in stdout[0], "dp2: rank 0's first lines")
    check(all(r["graph"] is None for r in ranks) and one["graph"] is not None, "dp2: graphs")
    check(all(ranks[0]["summary"][k] == ranks[1]["summary"].get(k) for k in ranks[0]["summary"]
              if k != "iterations_per_sec" and not k.endswith("_ms")), "dp2: the ranks' summaries differ")
    check(sorted(two_losses) == sorted(one_losses), f"dp2: logged steps {sorted(two_losses)}, {sorted(one_losses)}")
    rel = max(abs(two_losses[s] - one_losses[s]) / abs(one_losses[s]) for s in one_losses)
    check(rel <= DP_BF16_RTOL, f"dp2: two ranks' losses {two_losses} against one process's {one_losses}")
    check(sorted(fault_losses) == sorted(one_losses), f"dp2: the control's logged steps {sorted(fault_losses)}")
    fault_rel = max(abs(fault_losses[s] - one_losses[s]) / abs(one_losses[s]) for s in one_losses)
    check(fault_rel > DP_BF16_RTOL, f"dp2: the gate passes rank 1's dropout counted from row 0 ({fault_rel})")
    half = geo["batch"] // 2
    for r in ranks:
        got = r["launches"]
        check(got["attention"] == got["attention_bwd"] == 4 * 4, f"dp2: rank {r['rank']} kernel 4/5 launches {got}")
        check(r["b0"] == {"forward": [half * r["rank"]], "backward": [half * r["rank"]]},
              f"dp2: rank {r['rank']} b0 {r['b0']}")
    emit({"phase": "dp_two_ranks_one_card", "batch": geo["batch"], "rows_per_rank": half, "iterations": 4,
          "losses_two_ranks": two_losses, "losses_one_process": one_losses, "max_rel_loss_diff": rel,
          "rtol": DP_BF16_RTOL, "control_rank1_dropout_from_0": {"losses": fault_losses, "max_rel_loss_diff": fault_rel},
          "b0": [r["b0"] for r in ranks], "launches": [r["launches"] for r in ranks],
          "wall_s_two_ranks": two_s, "wall_s_one_process": one_s,
          "iterations_per_sec_two_ranks": [r["summary"]["iterations_per_sec"] for r in ranks],
          "iterations_per_sec_one_process": one["summary"]["iterations_per_sec"],
          "note": "two ranks share one card: no scaling claim"})
    return add_launches(*(r["launches"] for r in ranks))


def dp_stage1_phase(corpus_cpu: torch.Tensor) -> dict:
    """Stage 1 at configs/rqvae_amazon.gin's widths on two ranks sharing the
    card (gloo), 2 x 320 rows, through the trainer's CLI (20 steps in chunks
    of 2, evaluations at 10 and 20), against one process (its step graphs):
    each logged loss within rtol DP_F32_RTOL (f32, the batch split in two
    and summed in another order), and a control run with rank 1's gradients
    left out of the mean (plant_fault) outside it; each rank evaluates, so kernel 1 runs
    once an evaluation on each."""
    with tempfile.TemporaryDirectory() as root:
        folder = write_item_dataset(os.path.join(root, "data"), corpus_cpu, seed=13)

        def argv(save):
            kw = dict(dataset="%data.registry.RecDataset.SYNTHETIC", dataset_folder=f'"{folder}"',
                      save_dir_root=f'"{save}"', iterations=20, eval_every=10, save_model_every=1000, log_every=2,
                      steps_per_loop=2)
            return ["configs/rqvae_amazon.gin", *(f"{k}={v}" for k, v in kw.items())]

        ranks, stdout = launch_ranks("dps1", root, {"stage": 1, "argv": argv(os.path.join(root, "two"))}, 2)
        (one,), _ = launch_ranks("dps1_one", root, {"stage": 1, "argv": argv(os.path.join(root, "one"))}, 1,
                                 markers=False)
        launch_ranks("dps1_fault", root, {"stage": 1, "argv": argv(os.path.join(root, "fault")),
                                          "fault": "rank1_grads_left_out"}, 2)
        two_losses, one_losses = logged_losses(os.path.join(root, "two")), logged_losses(os.path.join(root, "one"))
        fault_losses = logged_losses(os.path.join(root, "fault"))
    check([r["backend"] for r in ranks] == ["gloo", "gloo"] and "runs eagerly" in stdout[0], "dps1: backends")
    check(sorted(two_losses) == sorted(one_losses), f"dps1: logged steps {sorted(two_losses)}, {sorted(one_losses)}")
    rel = max(abs(two_losses[s] - one_losses[s]) / abs(one_losses[s]) for s in one_losses)
    check(rel <= DP_F32_RTOL, f"dps1: two ranks' losses {two_losses} against one process's {one_losses}")
    check(sorted(fault_losses) == sorted(one_losses), f"dps1: the control's logged steps {sorted(fault_losses)}")
    fault_rel = max(abs(fault_losses[s] - one_losses[s]) / abs(one_losses[s]) for s in one_losses)
    check(fault_rel > DP_F32_RTOL, f"dps1: the gate passes rank 1's gradients left out of the mean ({fault_rel})")
    for r in ranks:
        check(r["launches"]["rq_encode"] == 2, f"dps1: rank {r['rank']} launches {r['launches']}")
    div = ("p_unique_ids", "rqvae_entropy", "codebook_usage_0")
    emit({"phase": "dp_stage1_two_ranks", "batch": 640, "iterations": 20, "losses_two_ranks": two_losses,
          "losses_one_process": one_losses, "max_rel_loss_diff": rel, "rtol": DP_F32_RTOL,
          "control_rank1_grads_left_out": {"losses": fault_losses, "max_rel_loss_diff": fault_rel},
          "diversity_two_ranks": {k: ranks[0]["summary"].get(k) for k in div},
          "diversity_one_process": {k: one["summary"].get(k) for k in div},
          "launches": [r["launches"] for r in ranks]})
    return add_launches(*(r["launches"] for r in ranks))


def rows_alone(model, cached_ids, hist: np.ndarray, dev) -> dict:
    """Whether a serving stage's rows move with the batch size: rows 0 ..
    B/2 - 1 computed in a batch of B against the same rows alone, each stage
    on the same inputs, bit for bit. The encoder output from the same tokens
    (kernel 3 where the bucket takes it, else plain PyTorch, whose products
    are cuBLAS's); one product alone, the first encoder layer's query
    projection of the encoder output (cuBLAS at M = B x Le against B/2 x
    Le); the cross K/V from the same encoder output; the decoder's states at
    each beam level from the same operands (kernel 2 where the bucket takes
    it); level 0's head product. A kernel gives each batch row blocks of its
    own, so its rows must not move: a kernel stage that does is a fault."""
    from rqvae_tpu_torch.models.retrieval import strip_dedup_col
    from rqvae_tpu_torch.models.t5 import dense
    from rqvae_tpu_torch.tokenizer.semids import _tokenize_from_cache

    cfg = model.config
    L, K, k = cfg.num_hierarchies, cfg.codebook_size, cfg.top_k_for_generation
    h = torch.from_numpy(hist).to(dev)
    B = h.shape[0]
    half = B // 2
    zeros = torch.zeros(B, dtype=torch.int32, device=dev)
    tok = _tokenize_from_cache(cached_ids, zeros, h, zeros, h >= 0)
    ids = strip_dedup_col(tok.sem_ids, L + 1, L)
    mask = strip_dedup_col(tok.seq_mask.to(torch.int32), L + 1, L)
    route = bucket_route(model, hist.shape[1])
    out = {}

    def record(name, whole, alone, kernel):
        whole, alone = whole.reshape(B, -1)[:half], alone.reshape(half, -1)
        out[name] = {"bit_equal": bool(torch.equal(whole, alone)), "kernel": kernel,
                     "max_abs_diff": float((whole.float() - alone.float()).abs().max())}

    with torch.no_grad():
        enc, enc_mask = model.encoder_forward(ids, mask, tok.user_ids)
        enc_half, _ = model.encoder_forward(ids[:half], mask[:half], tok.user_ids[:half])
        record("encoder", enc, enc_half, route["encoder"].startswith("encoder_stack"))
        wq, cdt = model.encoder.block[0].self_attn.q.weight, model.encoder.cfg.compute_dtype
        record("cublas_q_projection", dense(enc, wq, cdt), dense(enc[:half], wq, cdt), False)
        dec = model.decoder
        kv = dec.cross_kv(enc)
        kv_half = dec.cross_kv(enc[:half])
        record("cross_k", kv[0].transpose(0, 1), kv_half[0].transpose(0, 1), False)
        record("cross_v", kv[1].transpose(0, 1), kv_half[1].transpose(0, 1), False)
        kv_rows = tuple(t[:, :half].contiguous() for t in kv)
        fused = dec.use_fused_decode(enc.shape[1])
        w = dec.decode_weights() if fused else None
        g = torch.Generator().manual_seed(5)
        for beams, T in ((1, 1), (k, 2), (k, 3)):
            prefix = torch.randint(0, K, (B * beams, T - 1), generator=g).to(dev)
            if fused:
                embs = model._decoder_embs(prefix, B * beams).reshape(B, beams * T, -1)
                y = dec.fused_decode(embs, kv, enc_mask, beams, w)
                y_half = dec.fused_decode(embs[:half].contiguous(), kv_rows, enc_mask[:half], beams, w)
            else:
                y = model.decoder_forward(prefix, enc, enc_mask, beams, kv)
                y_half = model.decoder_forward(prefix[:half * beams], enc[:half], enc_mask[:half], beams, kv_rows)
            record(f"decoder_kT{beams * T}", y, y_half, fused)
            if T == 1:
                last = y.reshape(B, -1)[:, -cfg.t5_d_model:]
                record("head_level0", last @ model.heads[0], last[:half] @ model.heads[0], False)
    return out


def sharded_serving_phase(phase: str, geo: dict, counts, dev, seed: int) -> dict:
    """Serving over a mesh of [cuda:0, cuda:0] (two 'data' shards on the one
    card) at a published width: the sharded index build equals the card's
    unsharded one exactly (kernel 1 once per shard); 3 retrieve() calls of
    64 histories, kernels 2 or 3 launched per shard per call, equal bit for
    bit (ids, beams, log-probas) the unsharded Retriever on the same index
    called on each shard's 32 rows; in f32 also every beam of the unsharded
    call on all 64 rows. In bf16 the unsharded path itself moves with the
    batch size (a bf16 rounding flipped by a sum taken in another order), so
    the share of queries whose beams equal the 64-row call is reported,
    with the unsharded 32-row call's share beside it, and rows_alone says
    which stage moves: a kernel stage (2 or 3) that moves fails the phase. An engine bucket (one
    graph per shard) replays the direct sharded call bit for bit."""
    from rqvae_tpu_torch.parallel.mesh import make_mesh
    from rqvae_tpu_torch.serving.engine import RetrievalEngine
    from rqvae_tpu_torch.serving.retriever import Retriever
    from rqvae_tpu_torch.tokenizer.semids import SemanticIdTokenizer

    rq, _, x = make_rqvae(geo, dev)
    model = retrieval_model("bfloat16", dev)
    mesh = make_mesh(devices=[dev, dev])
    plain_tok = SemanticIdTokenizer(rq, device=dev)
    plain_ids = plain_tok.precompute_corpus_ids(x)
    counts.zero()
    tok = SemanticIdTokenizer(rq, mesh=mesh)
    ids = tok.precompute_corpus_ids(x)
    sync()
    build = counts.read()
    check(torch.equal(ids, plain_ids), f"{phase}: the sharded index differs from the unsharded one")
    check(build["rq_encode"] == 2, f"{phase}: index build launches {build}")
    plain, sharded = Retriever(model, plain_tok, device=dev), Retriever(model, tok, mesh=mesh)
    hist = histories(geo["items"], geo["history"], seed=seed)
    counts.zero()
    got = [sharded.retrieve(hist) for _ in range(CALLS)]
    sync()
    calls = counts.read()
    route = bucket_route(model, geo["history"])
    want_calls = {"decoder_stack": 3 * 2 * CALLS * route["decoder"].startswith("decoder_stack"),
                  "encoder_stack": 2 * CALLS * route["encoder"].startswith("encoder_stack")}
    check({k: calls[k] for k in want_calls} == want_calls, f"{phase}: launches {calls}, want {want_calls}")
    rows = BATCH // 2
    halves = [plain.retrieve(hist[i * rows:(i + 1) * rows]) for i in range(2)]
    at_shard_rows = all(torch.equal(t, torch.cat([h[f] for h in halves])) for g in got for f, t in enumerate(g))
    check(at_shard_rows, f"{phase}: the sharded calls differ from the unsharded Retriever at the shards' rows")
    want = plain.retrieve(hist)
    same_beams = lambda a, b: float((a.sem_ids == b.sem_ids).all(-1).all(-1).float().mean())
    agree = {"sharded_vs_unsharded_64": same_beams(got[0], want),
             "unsharded_32_vs_unsharded_64": same_beams(halves[0], type(want)(*(t[:rows] for t in want))),
             "log_proba_max_abs_diff_64": float((got[0].log_probas - want.log_probas).abs().max().item())}
    model32 = retrieval_model("float32", dev)
    f32_sharded = Retriever(model32, tok, mesh=mesh).retrieve(hist)
    f32_plain = Retriever(model32, plain_tok, device=dev).retrieve(hist)
    f32_exact = torch.equal(f32_sharded.item_ids, f32_plain.item_ids) and torch.equal(f32_sharded.sem_ids,
                                                                                        f32_plain.sem_ids)
    check(f32_exact, f"{phase}: in f32 the sharded beams differ from the unsharded 64-row call's")
    agree["f32_log_proba_max_abs_diff_64"] = float((f32_sharded.log_probas - f32_plain.log_probas).abs().max())
    del model32, f32_sharded, f32_plain
    stages = rows_alone(model, plain_ids, hist, dev)
    moved = [n for n, r in stages.items() if r["kernel"] and not r["bit_equal"]]
    check(not moved, f"{phase}: kernel stages whose rows move with the batch size: {moved} ({stages})")
    eng = RetrievalEngine(sharded, max_items=geo["history"], item_buckets=(geo["history"],), batch_buckets=(BATCH,))
    check(eng.warmup() == 1 and len(eng.graphs[(BATCH, geo["history"])]) == 2, f"{phase}: engine graphs")
    flight = eng._replay(hist, np.zeros(BATCH, np.int32))
    flight.event.synchronize()
    replay_same = all(torch.equal(h, d.cpu()) for h, d in zip(flight.host, got[0]))
    check(replay_same, f"{phase}: the engine's replay differs from the direct sharded call")
    row = {"phase": phase, "mesh": [str(d) for d in mesh.data_devices], "items": geo["items"], "batch": BATCH,
           "index_bit_equal": True, "index_launches": build, "call_launches": calls,
           "bit_equal_at_shard_rows": at_shard_rows, "f32_beams_equal_at_64_rows": f32_exact,
           "bf16_beam_agreement": agree, "rows_alone_at_32_of_64": stages,
           "engine_replay_bit_equal": replay_same, **route,
           "retrieve_ms_sharded": cuda_ms(lambda: sharded.retrieve(hist), reps=3, warmup=1),
           "retrieve_ms_unsharded": cuda_ms(lambda: plain.retrieve(hist), reps=3, warmup=1),
           "engine_replay_host_ms": host_ms(lambda: eng._replay(hist, np.zeros(BATCH, np.int32)).event.synchronize())}
    emit(row)
    del eng, sharded, plain, tok, plain_tok, model, rq, x
    torch.cuda.empty_cache()
    return add_launches(build, calls)


def fixture_inputs() -> dict:
    with np.load(os.path.join(FIXTURE, "inputs_and_results.npz")) as z:
        return {k: z[k] for k in z.files}


def checkpoint_interop_phase(dev) -> None:
    """The committed JAX-written checkpoints (flax's bytes), served on the
    card in f32 through from_checkpoints, against what the JAX package
    served for them (stored beside them)."""
    from rqvae_tpu_torch.serving.retriever import Retriever

    fx = fixture_inputs()
    r = Retriever.from_checkpoints(os.path.join(FIXTURE, "rqvae", "checkpoint_299.msgpack"),
                                   os.path.join(FIXTURE, "decoder", "checkpoint_400.msgpack"),
                                   fx["item_features"], device=dev, precision="f32")
    out = r.retrieve(fx["histories"])
    ids_equal = bool(np.array_equal(out.item_ids.cpu().numpy(), fx["item_ids"]))
    sem_equal = bool(np.array_equal(out.sem_ids.cpu().numpy(), fx["sem_ids"]))
    err = float(np.abs(out.log_probas.cpu().numpy() - fx["log_probas"]).max())
    check(ids_equal and sem_equal, "checkpoint_interop: item ids differ from the JAX package's")
    check(err <= FIXTURE_LOGP_TOL, f"checkpoint_interop: log_probas differ by {err}")
    emit({"phase": "checkpoint_interop", "queries": int(fx["histories"].shape[0]), "items": int(fx["item_ids"].size),
          "item_ids_equal": ids_equal, "sem_ids_equal": sem_equal, "log_probas_max_abs_diff": err,
          "tol": FIXTURE_LOGP_TOL, "config": {"t5_d_model": r.model.config.t5_d_model,
                                              "n_candidates": r.model.config.n_candidates}})


def sampled_candidates_phase(dev) -> None:
    """Sampled candidates, card against CPU in f32 over the fixture's
    weights, each fed the same Gumbel noise."""
    import dataclasses

    from rqvae_tpu_torch.models.retrieval import EncoderDecoderRetrievalModel
    from rqvae_tpu_torch.serving.retriever import Retriever

    fx = fixture_inputs()
    paths = (os.path.join(FIXTURE, "rqvae", "checkpoint_299.msgpack"),
             os.path.join(FIXTURE, "decoder", "checkpoint_400.msgpack"))
    out = {}
    noise = None
    for name, device in (("card", dev), ("cpu", "cpu")):
        base = Retriever.from_checkpoints(*paths, fx["item_features"], device=device, precision="f32")
        cfg = dataclasses.replace(base.model.config, sample_candidates=True, n_candidates=16)
        model = EncoderDecoderRetrievalModel(cfg, device=device)
        model.load_state_dict(base.model.state_dict())
        r = Retriever(model, base.tokenizer, device=device, seed=41)
        noise = r.draw_noise(fx["histories"].shape[0]) if noise is None else noise
        out[name] = r.retrieve(fx["histories"], noise=noise)
    card, host = out["card"], out["cpu"]
    same = beams_same(card, host)
    err = float((card.log_probas.cpu() - host.log_probas).abs().max().item())
    check(same >= BEAMS_SAME_MIN, f"sampled_candidates: all beams identical on {same:.3f} of queries")
    valid = card.log_probas.cpu() > -1e8
    check(bool(valid.any()) and bool((card.item_ids.cpu()[valid] >= 0).all()),
          "sampled_candidates: no valid beam, or a valid beam that maps to no item")
    emit({"phase": "sampled_candidates", "queries": int(fx["histories"].shape[0]), "n_candidates": 16,
          "queries_all_beams_same": same, "log_probas_max_abs_diff": err})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from rqvae_tpu_torch.ops.cuda import _build
    from rqvae_tpu_torch.serving.retriever import Retriever

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]

    # ---- 1. card + build ----
    t0 = time.perf_counter()
    logs = _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {name: ptxas_summary(log) for name, log in logs.items()}
    PTXAS.update(ptxas)
    for name in ("encoder_stack", "decoder_stack", "rq_encode"):  # the tensor-core kernels spill nothing
        tc = [row for row in ptxas[name] if "tc_kernel" in row[0]]
        check(bool(tc) and all(row[2] == 0 and row[3] == 0 for row in tc),
              f"{name}: tensor-core kernel ptxas {tc}")
    emit({"phase": "card", "name": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s, "ptxas": ptxas,
          "allow_tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                         "cudnn": torch.backends.cudnn.allow_tf32}})
    counts = LaunchCounts()
    kernels, launches = {}, {}

    # ---- 2-5. the Amazon width ----
    rq, x_cpu, x = make_rqvae(AMAZON, dev)
    models = {dt: retrieval_model(dtype_name(dt), dev) for dt in (torch.bfloat16, torch.float32)}
    rq_amazon_row, near = rq_encode_phase("rq_encode", rq, x)
    rq_amazon_bf16 = rq_encode_bf16_phase("rq_encode_bf16", rq, x, dev)
    rq_packed = rq_encode_packed_phase(rq, x)
    hist = histories(AMAZON["items"], AMAZON["history"], seed=3)
    kernels["decoder_stack"] = decoder_stack_phase(models, rq, x, hist, dev)

    counts.zero()
    tok, cached, index_ms = build_index(rq, x, dev)
    retriever = Retriever(models[torch.bfloat16], tok, device=dev)
    call_ms, results = retrieve_calls(retriever, hist)
    launches["amazon"] = counts.read()
    check(launches["amazon"]["rq_encode"] >= 1, f"rq_encode launches {launches['amazon']}")
    check(launches["amazon"]["decoder_stack"] == 3 * CALLS, f"decoder_stack launches {launches['amazon']}")
    cached_np = cached.cpu().numpy()
    check_results(results, cached_np, BATCH)
    emit({"phase": "main_path", "items": AMAZON["items"], "distinct_tuples": int((cached_np[:, 3] == 0).sum()),
          "max_dedup": int(cached_np[:, 3].max()), "index_build_ms": index_ms, "batch": BATCH,
          "retrieve_ms": call_ms, "valid_beams": float((results[-1].item_ids >= 0).float().mean()),
          "launches": launches["amazon"]})
    emit({"phase": "retrieve_profile", **profile_call(lambda: retriever.retrieve(hist))})
    card_vs_cpu("card_vs_cpu_f32", rq, x_cpu, x, near, models[torch.float32], hist, dev)
    del rq, x, x_cpu, tok, cached, retriever, results, models
    torch.cuda.empty_cache()

    # ---- 6-8. the ML-32M width: kernels against their plain versions ----
    rq, x_cpu, x = make_rqvae(ML32M, dev)
    kernels["rq_encode"], near = rq_encode_phase("rq_encode_ml32m", rq, x)
    kernels["rq_encode"]["amazon_ms"] = rq_amazon_row["ms"]
    kernels["rq_encode"].update(rq_encode_bf16_phase("rq_encode_bf16_ml32m", rq, x, dev))
    kernels["rq_encode"].update({f"amazon_{k}": v for k, v in rq_amazon_bf16.items()})
    kernels["rq_encode"]["kernel_routes"] = {"bf16": "tensor_cores", "f32": "cuda_cores"}
    kernels["rq_encode"].update(rq_packed)
    rq1m, _, x1m = make_rqvae(ML1M, dev)  # ML-1M's 786 inputs: the width the wrapper used to refuse
    kernels["rq_encode"]["ml1m_ms"] = rq_encode_phase("rq_encode_ml1m", rq1m, x1m)[0]["ms"]
    kernels["rq_encode"]["ml1m_bf16_ms"] = rq_encode_bf16_phase("rq_encode_bf16_ml1m", rq1m, x1m, dev)["bf16_ms"]
    del rq1m, x1m
    kernels["attention"] = attention_phase(dev)
    models = {dt: retrieval_model(dtype_name(dt), dev) for dt in (torch.bfloat16, torch.float32)}
    kernels["encoder_stack"] = encoder_stack_phase(models, dev)

    # ---- 9. the ML-32M main path, both routes, counts zeroed before each ----
    hist = histories(ML32M["items"], ML32M["history"], seed=7)
    check(not models[torch.bfloat16].decoder.use_fused_decode(ML32M["history"] * 4), "decoder gate open at Le = 800")
    counts.zero()
    tok, cached, index_ms = build_index(rq, x, dev)
    retriever = Retriever(models[torch.bfloat16], tok, device=dev)
    call_ms, results = retrieve_calls(retriever, hist)
    launches["ml32m"] = got = counts.read()
    check(got["rq_encode"] >= 1 and got["encoder_stack"] == CALLS and got["decoder_stack"] == 0
          and got["attention"] == 0, f"ML-32M default route launches {got}")
    cached_np = cached.cpu().numpy()
    check_results(results, cached_np, BATCH)

    counts.zero()
    retriever_off = Retriever(retrieval_model("bfloat16", dev, t5_fused_encode="off"), tok, device=dev)
    call_ms_off, results_off = retrieve_calls(retriever_off, hist)
    launches["ml32m_fused_encode_off"] = got = counts.read()
    check(got["attention"] == 4 * CALLS and got["encoder_stack"] == 0 and got["decoder_stack"] == 0,
          f"ML-32M fused_encode=off route launches {got}")
    check_results(results_off, cached_np, BATCH)
    # how far the routes agree: in f32 they must (the same function, summed in
    # another order); in bf16 the share is reported beside the share of two
    # routes that differ only inside attention (kernel against plain torch)
    def route(dtype, **over):
        return Retriever(retrieval_model(dtype, dev, **over), tok, device=dev).retrieve(hist)

    agree = {
        "bf16_default_vs_off": route_agreement(results[-1], results_off[-1]),
        "bf16_off_vs_plain": route_agreement(
            results_off[-1], route("bfloat16", t5_fused_encode="off", t5_fused_attention="off")),
    }
    f32_default = Retriever(models[torch.float32], tok, device=dev).retrieve(hist)
    agree["f32_default_vs_off"] = route_agreement(f32_default, route("float32", t5_fused_encode="off"))
    same = agree["f32_default_vs_off"]["all_beams_same"]
    check(same >= BEAMS_SAME_MIN, f"ML-32M routes in f32: all beams identical on {same:.3f} of queries")
    bf16 = agree["bf16_default_vs_off"]
    check(bf16["top1_same"] >= BF16_TOP1_MIN and bf16["beam_overlap"] >= BF16_OVERLAP_MIN,
          f"ML-32M routes in bf16: {bf16}")
    emit({"phase": "main_path_ml32m", "items": ML32M["items"], "Le": ML32M["history"] * 4,
          "distinct_tuples": int((cached_np[:, 3] == 0).sum()), "max_dedup": int(cached_np[:, 3].max()),
          "index_build_ms": index_ms, "batch": BATCH, "retrieve_ms": call_ms,
          "retrieve_ms_fused_encode_off": call_ms_off,
          "valid_beams": float((results[-1].item_ids >= 0).float().mean()),
          "launches": launches["ml32m"], "launches_fused_encode_off": launches["ml32m_fused_encode_off"],
          "routes": agree})
    emit({"phase": "retrieve_profile_ml32m", **profile_call(lambda: retriever.retrieve(hist))})

    # ---- 10. the ML-32M path in f32, card against CPU ----
    card_vs_cpu("card_vs_cpu_f32_ml32m", rq, x_cpu, x, near, models[torch.float32],
                hist[:CPU_QUERIES_ML32M], dev)

    del retriever, retriever_off, results, results_off, models, tok, cached, f32_default
    torch.cuda.empty_cache()

    # ---- 11. the attention backward kernel at both training shapes ----
    kernels["attention_bwd"], fwd_amazon_ms = attention_bwd_phase(dev)
    kernels["attention"]["amazon_train_shape_ms"] = fwd_amazon_ms

    # ---- 12. training at the ML-32M width ----
    launches["train_ml32m"] = train_ml32m_phase(rq, x_cpu, x, counts, dev)
    del rq, x, x_cpu
    torch.cuda.empty_cache()

    # ---- 13-15. training at the Amazon width ----
    rq, x_cpu, x = make_rqvae(AMAZON, dev)
    launches["train_amazon"], (model, opt, step, tables, data) = train_amazon_phase(rq, x_cpu, x, counts, dev)
    train_card_vs_cpu_phase(data, rq, x, dev)
    train_profile_phase(step, tables, dev)
    del rq, x, model, opt, step, tables, data
    torch.cuda.empty_cache()

    # ---- 16-18. stage-1 (RQ-VAE) training at both widths ----
    del x_cpu
    corpora = {"amazon": ("configs/rqvae_amazon.gin", item_corpus(AMAZON["items"], AMAZON["input_dim"], 0, seed=15)),
               "ml32m": ("configs/rqvae_ml32m.gin", item_corpus(ML32M["items"], ML32M["input_dim"], 20, seed=14))}
    for name, (gin, corpus) in corpora.items():
        launches[f"train_rqvae_{name}"] = train_rqvae_phase(f"train_rqvae_{name}", gin, corpus, counts, dev)
    train_rqvae_card_vs_cpu_phase(corpora, dev)

    # ---- 25-30. training as the JAX trainers run it: step graphs, remat, step time and MFU ----
    from rqvae_tpu_torch.models.quantize import QuantizeForwardMode

    train_rqvae_graph_phase("train_rqvae_graph_amazon", *corpora["amazon"], dev)
    train_rqvae_graph_phase("train_rqvae_graph_ml32m", *corpora["ml32m"], dev)
    train_rqvae_graph_phase("train_rqvae_graph_amazon_gumbel", *corpora["amazon"], dev,
                            mode=QuantizeForwardMode.GUMBEL_SOFTMAX, anneal=True)
    train_perf_phase(corpora["amazon"][1], dev)

    # ---- 31-34. the trainers as rqvae_tpu's are configured and resumed ----
    rq, x_cpu, x = make_rqvae(AMAZON, dev)
    launches["train_amp"] = train_amp_phase(rq, x, corpora["amazon"][1], counts, dev)
    resume_jax_layout_phase(rq, x_cpu, corpora["amazon"][1], dev)
    launches["sampled_eval"] = sampled_eval_and_hub_phases(rq, x_cpu, x, counts, dev)
    del rq, x_cpu, x
    del corpora
    gc.collect()  # the trainers' and perf.py's step runners close over themselves: free their graphs
    torch.cuda.empty_cache()
    for name, geo, vae in (("amazon", TRAIN_AMAZON, AMAZON), ("ml32m", TRAIN_ML32M, ML32M)):
        rq, x_cpu, x = make_rqvae(vae, dev)
        launches[f"train_graph_{name}"] = train_graph_phase(f"train_graph_{name}", geo, rq, x, dev, counts,
                                                            **TRAIN_GRAPH[name])
        if name == "ml32m":
            launches["remat"] = remat_phase(rq, x, dev, counts)
        del rq, x_cpu, x
        torch.cuda.empty_cache()

    # ---- 19-24. serving as it is deployed ----
    checkpoint_interop_phase(dev)
    sampled_candidates_phase(dev)
    launches["serve_amazon"], eng, rq, x = serve_phase("serve_amazon", AMAZON, counts, dev, seed=50)
    launches["corpus_growth"] = corpus_growth_phase(eng, rq, x, counts, dev)
    queue_phase(eng, AMAZON["items"])
    del eng, rq, x
    torch.cuda.empty_cache()
    launches["serve_ml32m"], eng, rq, x = serve_phase("serve_ml32m", ML32M, counts, dev, seed=60)
    del eng, rq, x
    torch.cuda.empty_cache()

    # ---- 35-40. scale-out: kernels 4 and 5 from b0, data-parallel ranks, sharded serving ----
    b0_times = attention_b0_phase(dev)
    kernels["attention"]["b0_timing"] = {k: {n: v for n, v in t.items() if n.startswith("forward")}
                                         for k, t in b0_times.items()}
    kernels["attention_bwd"]["b0_timing"] = {k: {n: v for n, v in t.items() if n.startswith("backward")}
                                             for k, t in b0_times.items()}
    rq, x_cpu, _ = make_rqvae(AMAZON, dev)
    launches["dp_world_of_one"] = dp_world_of_one_phase(rq, x_cpu)
    launches["dp_two_ranks"] = dp_two_ranks_phase(rq, x_cpu)
    del rq, x_cpu
    torch.cuda.empty_cache()
    launches["dp_stage1"] = dp_stage1_phase(item_corpus(AMAZON["items"], AMAZON["input_dim"], 0, seed=15))
    launches["serve_sharded_amazon"] = sharded_serving_phase("serve_sharded_amazon", AMAZON, counts, dev, seed=70)
    launches["serve_sharded_ml32m"] = sharded_serving_phase("serve_sharded_ml32m", ML32M, counts, dev, seed=71)

    # ---- kernels, card, result ----
    for name, row in kernels.items():
        row["launches_by_path"] = {path: got.get(name, 0) for path, got in launches.items()}
        row["launches"] = sum(row["launches_by_path"].values())
        check(row["launches"] >= 1, f"{name} was launched no time on a main path")
    emit({"kernels": [{k: row[k] for k in (*KERNEL_KEYS, *sorted(set(row) - set(KERNEL_KEYS)))}
                      for row in kernels.values()]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--rank-worker":  # one rank of a data-parallel phase
        sys.exit(rank_worker(sys.argv[2]))
    sys.exit(main())
