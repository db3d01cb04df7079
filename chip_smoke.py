"""Drive the PyTorch/CUDA port's serving paths on one NVIDIA card and check them.

    python3 chip_smoke.py

Two published serving geometries, weights made from seeds. Amazon Beauty:
RQ-VAE 768 -> [512, 256, 128] -> 32, 20-item histories (encoder rows
Le = 80), 65,536 synthetic items. MovieLens-32M: RQ-VAE 788 -> [512, 256,
128] -> 64, 200-item histories (Le = 800), 87,585 synthetic items (the
dataset's movie count, no multiple of the 32 rows of an rq_encode block). Both:
3 x 256 codebooks; T5 d_model 384, 6 heads, d_kv 64, d_ff 1024, 4+4 layers,
bf16, top-k 10, batches of 64 histories.

   1. card: name, count, power limit, torch/CUDA versions; builds the four
      CUDA kernels from rqvae_tpu_torch/csrc (one nvcc per source, in
      parallel) and prints each one's ptxas register and spill lines;
   2. rq_encode kernel against its plain version on the card (Amazon width):
      identical ids except rows at an argmin near-tie: a level whose top-2
      distance gap, in float64, is below 1e-5 of ||res||^2 + max ||c||^2,
      the size of the terms the f32 distances are summed from;
   3. decoder_stack kernel against its plain version on the card (B = 64,
      Le = 80, kT = 1, 20, 30): max abs error <= 1e-3 in f32 and <= 6e-2 in
      bf16 (bf16 rounding of the residual stream over 4 layers: a summation
      order that differs in the last f32 bit can flip a bf16 rounding, and the
      flip carries through the later layers);
   4. the Amazon main path with the launch counts zeroed first: index build
      (rq_encode), Retriever, 3 retrieve() calls; requires 1 rq_encode launch
      and 3 levels x 3 calls decoder_stack launches, corpus-valid beams and
      sorted finite log-probs; then one more retrieve() under torch.profiler;
   5. that path in f32, card (kernels) against CPU (plain versions), each
      building its own index: ids identical except near-tie rows, all 10
      beams identical on >= 95% of the queries;
   6. rq_encode at the ML-32M width, 87,585 x 788, as in 2;
   7. attention kernel against its plain version at q, k, v [64, 6, 800, 64]
      with ragged key masks and one row with every key masked, f32 and bf16,
      dropout rate 0 and 0.1 (same seed on both sides), and a causal case at
      L = 512: max abs error <= 2e-5 in f32 and <= 3.2e-2 in bf16 (one bf16
      step, 2^-5, of an output between 4 and 8 whose f32 sum lands across a
      rounding boundary; the two sides sum in another order);
   8. encoder_stack kernel against its plain version at x [64, 800, 384] with
      ragged history lengths: max abs error <= 1e-3 in f32; in bf16 <= 0.15 at
      the worst element and <= 4e-3 in the mean (flipped bf16 roundings of
      the residual stream carry through 4 layers);
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
      versions): all 10 beams identical on >= 95% of the queries.

Each phase prints one JSON line. Then the `kernels` line, the card's
`nvidia-smi` name and power limit, and last `{"ok": true, "device": ...}`.
Any failed check raises: the script exits non-zero and prints no last line.
Without a CUDA device it exits with code 1 before printing anything.
"""

from __future__ import annotations

import json
import subprocess
import sys
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
CPU_QUERIES_ML32M = 8
ID_NEAR_TIE = 1e-5  # top-2 gap relative to ||res||^2 + max ||c||^2
DECODER_TOL = {torch.float32: 1e-3, torch.bfloat16: 6e-2}
ATTENTION_TOL = {torch.float32: 2e-5, torch.bfloat16: 3.2e-2}
ENCODER_TOL = {torch.float32: (1e-3, 1e-5), torch.bfloat16: (1.5e-1, 4e-3)}  # (max, mean) abs error
BEAMS_SAME_MIN = 0.95
BF16_TOP1_MIN, BF16_OVERLAP_MIN = 0.8, 0.9  # two bf16 routes: first beam equal; beams in common
DEVICE = "cuda"  # the card; a CPU rehearsal of the control flow may set "cpu"
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


def bound_ms(flops: float, peak: float, nbytes: float):
    t_ops, t_bytes = flops / peak * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def peak_flops(dtype: torch.dtype) -> float:
    return H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS


def nbytes_of(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).split(".")[-1]


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


def profile_retrieve(retriever, hist, top: int = 8) -> dict:
    """Device time of one retrieve() call by kernel (torch.profiler, CUPTI):
    the call's host time, the summed device time and launch count, the
    device's idle share of the call, and the `top` kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    retriever.retrieve(hist)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        retriever.retrieve(hist)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    device_ms = sum(e.self_device_time_total for e in rows) / 1e3
    return {
        "host_ms": host_ms, "device_ms": device_ms, "device_launches": sum(e.count for e in rows),
        "device_idle_share": max(0.0, 1.0 - device_ms / host_ms) if host_ms else None,
        "kernels": [{"name": e.key[:60], "count": e.count, "ms": e.self_device_time_total / 1e3}
                    for e in rows[:top]],
    }


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


def rq_encode_phase(phase: str, rq, x: torch.Tensor):
    """rq_encode kernel against its plain version over the corpus `x`; returns
    the kernel's row of the `kernels` line and the near-tie rows."""
    from rqvae_tpu_torch.ops.cuda.rq_encode import fused_encode_quantize, fused_encode_quantize_plain

    n = x.shape[0]
    with torch.no_grad():
        weights, cbs = rq.encoder.kernels(), rq.codebooks.detach()
        got = fused_encode_quantize(x, weights, cbs, 3)
        sync()
        want = fused_encode_quantize_plain(x, weights, cbs, 3)
        near = f64_near_tie_rows(x, weights, cbs)
        differ = (got != want).any(1)
        outside = differ & ~near
        check(int(outside.sum()) == 0, f"{phase}: {int(outside.sum())} rows differ away from near-ties")
        enc_ms = cuda_ms(lambda: fused_encode_quantize(x, weights, cbs, 3), reps=20)
        enc_plain_ms = cuda_ms(lambda: fused_encode_quantize_plain(x, weights, cbs, 3), reps=20)
    K, D = cbs.shape[1], cbs.shape[2]
    macs = sum(w.shape[0] * w.shape[1] for w in weights) + 3 * K * D
    b_ms, b_by = bound_ms(2 * n * macs, H100_F32_FLOPS, nbytes_of(x, *weights, cbs, got))
    row = {
        "name": "rq_encode", "route": "cuda", "source": "rqvae_tpu_torch/csrc/rq_encode.cu",
        "replaces": "rqvae_tpu/ops/pallas/rq_encode.py:137",
        "max_abs_err": float((got - want)[~near].abs().max().item()) if (~near).any() else 0.0,
        "ms": enc_ms, "plain_ms": enc_plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }
    emit({"phase": phase, "items": n, "widths": [x.shape[1], *(w.shape[1] for w in weights)],
          "rows_differ": int(differ.sum()), "near_tie_rows": int(near.sum()),
          "differ_outside_near_ties": int(outside.sum()),
          "kernel_ms": enc_ms, "plain_ms": enc_plain_ms, "bound_ms": b_ms, "bound_by": b_by})
    return row, near


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
    """attention kernel against its plain version at the long-row shape;
    returns the kernel's row of the `kernels` line (bf16, no dropout: what
    the fused_encode="off" route launches)."""
    from rqvae_tpu_torch.ops.cuda.attention import t5_attention, t5_attention_plain

    H, L, dk, seed = 6, ML32M["history"] * 4, 64, 77
    rows, kernel_row = [], None
    cases = [(dt, BATCH, L, False, rate) for dt in (torch.float32, torch.bfloat16) for rate in (0.0, 0.1)]
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
                   "max_abs_err": err, "tol": ATTENTION_TOL[dt], "kernel_ms": k_ms, "plain_ms": p_ms,
                   "bound_ms": b_ms, "bound_by": b_by}
            if not causal and rate == 0.0:
                # the yardstick: one library call of the same function (timed here, used nowhere in the port)
                add = (bias[None] + torch.where(mask != 0, 0.0, -1e9)[:, None, None, :]).to(dt)
                lib = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=add, scale=1.0)
                # row 0 (every key masked) left out: the call adds bias + mask before the scores
                lib_err = float((lib()[1:].float() - want[1:].float()).abs().max().item())
                row.update(library_ms=cuda_ms(lib, reps=5, warmup=1), library_max_abs_err=lib_err)
                del add
                if dt == torch.bfloat16:
                    kernel_row = {
                        "name": "attention", "route": "cuda", "source": "rqvae_tpu_torch/csrc/attention.cu",
                        "replaces": "rqvae_tpu/ops/pallas/attention.py:184", "max_abs_err": err,
                        "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": row["library_ms"],
                    }
            rows.append(row)
            del q, k, v, bias, mask, got, want
    emit({"phase": "attention", "H": H, "dk": dk, "rows": rows})
    return kernel_row


def encoder_stack_phase(models: dict, dev) -> dict:
    """encoder_stack kernel against its plain version at the ML-32M rows, with
    each model's own encoder weights; returns the bf16 row of the `kernels` line."""
    from rqvae_tpu_torch.ops.cuda.encoder_stack import t5_encoder_stack_infer, t5_encoder_stack_plain

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
            ops = enc.encode_operands(x, mask)
            y = t5_encoder_stack_infer(*ops, eps=eps)
            sync()
            y_plain = t5_encoder_stack_plain(*ops, eps=eps)
            diff = (y - y_plain).abs()
            err, mean_err = float(diff.max().item()), float(diff.mean().item())
            tol, mean_tol = ENCODER_TOL[dt]
            check(bool(torch.isfinite(y).all()), f"encoder_stack {dtype_name(dt)}: non-finite output")
            check(err <= tol and mean_err <= mean_tol,
                  f"encoder_stack {dtype_name(dt)}: max abs err {err}, mean {mean_err}")
            k_ms = cuda_ms(lambda: t5_encoder_stack_infer(*ops, eps=eps), reps=3, warmup=1)
            p_ms = cuda_ms(lambda: t5_encoder_stack_plain(*ops, eps=eps), reps=2, warmup=1)
            NL, H, dk, d, dff = cfg.num_layers, cfg.num_heads, cfg.d_kv, cfg.d_model, cfg.d_ff
            flops = 2 * BATCH * L * d * NL * (4 * H * dk + 2 * dff) + 2 * BATCH * NL * H * L * L * 2 * dk
            b_ms, b_by = bound_ms(flops, peak_flops(dt), nbytes_of(*ops, y))
            rows.append({"dtype": dtype_name(dt), "max_abs_err": err, "mean_abs_err": mean_err, "tol": tol,
                         "mean_tol": mean_tol, "kernel_ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                         "bound_by": b_by, "flops": flops})
            if dt == torch.bfloat16:
                kernel_row = {
                    "name": "encoder_stack", "route": "cuda", "source": "rqvae_tpu_torch/csrc/encoder_stack.cu",
                    "replaces": "rqvae_tpu/ops/pallas/encoder_stack.py:179", "max_abs_err": err,
                    "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                }
            del ops, y, y_plain, diff
    emit({"phase": "encoder_stack", "B": BATCH, "L": L, "rows": rows})
    return kernel_row


def decoder_stack_phase(models: dict, rq, x, hist, dev) -> dict:
    """decoder_stack kernel against its plain version at the Amazon path's
    three levels; returns the kernel's row of the `kernels` line."""
    from rqvae_tpu_torch.models.retrieval import strip_dedup_col
    from rqvae_tpu_torch.ops.cuda.decoder_stack import t5_decoder_stack_infer, t5_decoder_stack_plain
    from rqvae_tpu_torch.tokenizer.semids import SemanticIdTokenizer, _tokenize_from_cache

    tok_probe = SemanticIdTokenizer(rq, device=dev)
    tok_probe.precompute_corpus_ids(x)
    decoder_rows, kernel_row = [], None
    g = torch.Generator().manual_seed(4)
    for dt, model in models.items():
        with torch.no_grad():
            h = torch.from_numpy(hist).to(dev)
            tok = _tokenize_from_cache(tok_probe.cached_ids, torch.zeros(BATCH, dtype=torch.int32, device=dev),
                                       h, torch.zeros(BATCH, dtype=torch.int32, device=dev), h >= 0)
            ids = strip_dedup_col(tok.sem_ids, 4, 3)
            mask = strip_dedup_col(tok.seq_mask.to(torch.int32), 4, 3)
            enc, enc_mask = model.encoder_forward(ids, mask)
            dec = model.decoder
            kv, w = dec.cross_kv(enc), dec.decode_weights()
            for beams, T in ((1, 1), (10, 2), (10, 3)):
                prefix = torch.randint(0, 256, (BATCH * beams, T - 1), generator=g).to(dev)
                embs = model._decoder_embs(prefix, BATCH * beams).reshape(BATCH, beams * T, -1)
                ops = dec.decode_operands(embs, kv, enc_mask, beams, w)
                eps = dec.cfg.layer_norm_eps
                y = t5_decoder_stack_infer(*ops, eps=eps)
                sync()
                y_plain = t5_decoder_stack_plain(*ops, eps=eps)
                err = float((y - y_plain).abs().max().item())
                check(bool(torch.isfinite(y).all()), f"decoder_stack {dt} kT={beams * T}: non-finite output")
                check(err <= DECODER_TOL[dt], f"decoder_stack {dt} kT={beams * T}: max abs err {err}")
                k_ms = cuda_ms(lambda: t5_decoder_stack_infer(*ops, eps=eps), reps=10)
                p_ms = cuda_ms(lambda: t5_decoder_stack_plain(*ops, eps=eps), reps=10)
                kt, cfg = beams * T, dec.cfg
                NL, H, dk, d, dff, Le = cfg.num_layers, cfg.num_heads, cfg.d_kv, cfg.d_model, cfg.d_ff, enc.shape[1]
                flops = 2 * BATCH * kt * NL * (6 * d * H * dk + 2 * d * dff) + 4 * BATCH * NL * H * kt * (kt + Le) * dk
                b_ms, b_by = bound_ms(flops, peak_flops(dt), nbytes_of(*ops, y))
                decoder_rows.append({"dtype": dtype_name(dt), "kT": kt, "max_abs_err": err, "tol": DECODER_TOL[dt],
                                     "kernel_ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by})
                if dt == torch.bfloat16 and kt == 30:  # the main path's largest level
                    kernel_row = {
                        "name": "decoder_stack", "route": "cuda",
                        "source": "rqvae_tpu_torch/csrc/decoder_stack.cu",
                        "replaces": "rqvae_tpu/ops/pallas/decoder_stack.py:231",
                        "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                        "bound_by": b_by, "library_ms": None,
                    }
    emit({"phase": "decoder_stack", "B": BATCH, "Le": int(enc.shape[1]), "rows": decoder_rows})
    return kernel_row


class LaunchCounts:
    """The four wrappers' launch counters: zeroed before a path, read after."""

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

    def read(self) -> dict:
        return {name: fn.launches for name, fn in self.wrappers.items()}


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


def build_index(rq, x, dev):
    """SemanticIdTokenizer over the corpus; the build's host-clock ms."""
    from rqvae_tpu_torch.tokenizer.semids import SemanticIdTokenizer

    sync()
    t0 = time.perf_counter()
    tok = SemanticIdTokenizer(rq, device=dev)
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


def card_vs_cpu(phase: str, rq, x_cpu, tok, cached_np, near, model_card, hist, dev, **over) -> None:
    """The path in f32: card (kernels) against CPU (plain versions), each with
    its own index."""
    from rqvae_tpu_torch.models.rqvae import RqVae
    from rqvae_tpu_torch.serving.retriever import Retriever
    from rqvae_tpu_torch.tokenizer.semids import SemanticIdTokenizer

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
    ptxas = {name: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
             for name, log in logs.items()}
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
    emit({"phase": "retrieve_profile", **profile_retrieve(retriever, hist)})
    card_vs_cpu("card_vs_cpu_f32", rq, x_cpu, tok, cached_np, near, models[torch.float32], hist, dev)
    del rq, x, x_cpu, tok, cached, retriever, results, models
    torch.cuda.empty_cache()

    # ---- 6-8. the ML-32M width: kernels against their plain versions ----
    rq, x_cpu, x = make_rqvae(ML32M, dev)
    kernels["rq_encode"], near = rq_encode_phase("rq_encode_ml32m", rq, x)
    kernels["rq_encode"]["amazon_ms"] = rq_amazon_row["ms"]
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
    emit({"phase": "retrieve_profile_ml32m", **profile_retrieve(retriever, hist)})

    # ---- 10. the ML-32M path in f32, card against CPU ----
    card_vs_cpu("card_vs_cpu_f32_ml32m", rq, x_cpu, tok, cached_np, near, models[torch.float32],
                hist[:CPU_QUERIES_ML32M], dev)

    # ---- kernels, card, result ----
    for name, row in kernels.items():
        row["launches_by_path"] = {path: got[name] for path, got in launches.items()}
        row["launches"] = sum(row["launches_by_path"].values())
        check(row["launches"] >= 1, f"{name} was launched no time on a main path")
    emit({"kernels": [{k: row[k] for k in (*KERNEL_KEYS, *sorted(set(row) - set(KERNEL_KEYS)))}
                      for row in kernels.values()]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
