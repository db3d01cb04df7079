"""Drive the PyTorch/CUDA port's serving path on one NVIDIA card and check it.

    python3 chip_smoke.py

At the Amazon Beauty width (RQ-VAE 768 -> [512, 256, 128] -> 32 with 3 x 256
codebooks; T5 d_model 384, 6 heads, d_kv 64, d_ff 1024, 4+4 layers, bf16,
top-k 10, 20-item histories), with weights made from seeds:

  1. card: name, count, power limit, torch/CUDA versions; builds the CUDA
     kernels from rqvae_tpu_torch/csrc (one nvcc per source, in parallel);
  2. rq_encode kernel against its plain version on the card (65,536 items):
     identical ids except rows at an argmin near-tie: a level whose top-2
     distance gap, in float64, is below 1e-5 of ||res||^2 + max ||c||^2,
     the size of the terms the f32 distances are summed from;
  3. decoder_stack kernel against its plain version on the card (B = 64,
     Le = 80, kT = 1, 20, 30): max abs error <= 1e-3 in f32 and <= 6e-2 in
     bf16 (bf16 rounding of the residual stream over 4 layers: a summation
     order that differs in the last f32 bit can flip a bf16 rounding, and the
     flip carries through the later layers);
  4. the main path with the launch counts zeroed first: index build over the
     corpus (rq_encode), Retriever, 3 retrieve() calls of 64 histories;
     requires 1 rq_encode launch and 3 levels x 3 calls decoder_stack
     launches, corpus-valid beams and sorted finite log-probs; then one
     more retrieve() under torch.profiler: device time by kernel and the
     device's idle share of the call;
  5. the whole path in f32, card (kernels) against CPU (plain versions),
     each building its own index: index ids identical except near-tie rows,
     and all 10 beams identical on >= 95% of the queries.

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

H100_F32_FLOPS = 67e12  # float32 on CUDA cores (H100 SXM data sheet)
H100_BF16_FLOPS = 989e12  # bf16 tensor cores, dense
H100_BYTES_PER_S = 3.35e12  # HBM3

N_ITEMS = 65536
BATCH = 64
HISTORY = 20
CALLS = 3
ID_NEAR_TIE = 1e-5  # top-2 gap relative to ||res||^2 + max ||c||^2
DECODER_TOL = {torch.float32: 1e-3, torch.bfloat16: 6e-2}
BEAMS_SAME_MIN = 0.95
DEVICE = "cuda"  # the card; a CPU rehearsal of the control flow may set "cpu"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


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


def histories(n_items: int, seed: int) -> np.ndarray:
    """BATCH histories of HISTORY item ids, each 1..HISTORY long, -1 padded."""
    r = np.random.RandomState(seed)
    ids = r.randint(0, n_items, (BATCH, HISTORY))
    lengths = r.randint(1, HISTORY + 1, BATCH)
    return np.where(np.arange(HISTORY)[None, :] < lengths[:, None], ids, -1).astype(np.int32)


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from rqvae_tpu_torch.models.quantize import QuantizeForwardMode
    from rqvae_tpu_torch.models.retrieval import EncoderDecoderRetrievalModel, RetrievalConfig, strip_dedup_col
    from rqvae_tpu_torch.models.rqvae import RqVae, RqVaeConfig
    from rqvae_tpu_torch.ops.cuda import _build
    from rqvae_tpu_torch.ops.cuda.decoder_stack import t5_decoder_stack_infer, t5_decoder_stack_plain
    from rqvae_tpu_torch.ops.cuda.rq_encode import fused_encode_quantize, fused_encode_quantize_plain
    from rqvae_tpu_torch.serving.retriever import Retriever
    from rqvae_tpu_torch.tokenizer.semids import SemanticIdTokenizer, _tokenize_from_cache

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
    ptxas = {name: [ln.strip() for ln in log.splitlines() if "registers" in ln] for name, log in logs.items()}
    emit({"phase": "card", "name": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s, "ptxas": ptxas,
          "allow_tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                         "cudnn": torch.backends.cudnn.allow_tf32}})

    # ---- models at the Amazon width, weights from seeds ----
    vcfg = RqVaeConfig(input_dim=768, embed_dim=32, hidden_dims=(512, 256, 128), codebook_size=256,
                       n_layers=3, codebook_mode=QuantizeForwardMode.STE)
    x_cpu = make_corpus(N_ITEMS, vcfg.input_dim, seed=0)
    x = x_cpu.to(dev)
    rq = RqVae(vcfg, device=dev, seed=0)
    init_codebooks_from_data(rq, x, seed=1)
    rfields = dict(num_hierarchies=3, codebook_size=256, t5_d_model=384, t5_d_kv=64, t5_num_heads=6,
                   t5_d_ff=1024, t5_num_layers=4, top_k_for_generation=10, should_add_sep_token=True)
    models = {dt: EncoderDecoderRetrievalModel(RetrievalConfig(**rfields, t5_dtype=name), device=dev, seed=2)
              for dt, name in ((torch.bfloat16, "bfloat16"), (torch.float32, "float32"))}
    kernels = {}

    # ---- 2. rq_encode: kernel vs plain ----
    with torch.no_grad():
        weights, cbs = rq.encoder.kernels(), rq.codebooks.detach()
        got = fused_encode_quantize(x, weights, cbs, 3)
        torch.cuda.synchronize()
        want = fused_encode_quantize_plain(x, weights, cbs, 3)
        near = f64_near_tie_rows(x, weights, cbs)
        differ = (got != want).any(1)
        outside = differ & ~near
        check(int(outside.sum()) == 0, f"rq_encode: {int(outside.sum())} rows differ away from near-ties")
        enc_ms = cuda_ms(lambda: fused_encode_quantize(x, weights, cbs, 3), reps=20)
        enc_plain_ms = cuda_ms(lambda: fused_encode_quantize_plain(x, weights, cbs, 3), reps=20)
    macs = sum(w.shape[0] * w.shape[1] for w in weights) + 3 * 256 * 32
    nbytes = x.numel() * 4 + sum(w.numel() * 4 for w in weights) + cbs.numel() * 4 + got.numel() * 4
    b_ms, b_by = bound_ms(2 * N_ITEMS * macs, H100_F32_FLOPS, nbytes)
    kernels["rq_encode"] = {
        "name": "rq_encode", "route": "cuda", "source": "rqvae_tpu_torch/csrc/rq_encode.cu",
        "replaces": "rqvae_tpu/ops/pallas/rq_encode.py:137",
        "max_abs_err": float((got - want)[~near].abs().max().item()) if (~near).any() else 0.0,
        "ms": enc_ms, "plain_ms": enc_plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }
    emit({"phase": "rq_encode", "items": N_ITEMS, "rows_differ": int(differ.sum()),
          "near_tie_rows": int(near.sum()), "differ_outside_near_ties": int(outside.sum()),
          "kernel_ms": enc_ms, "plain_ms": enc_plain_ms, "bound_ms": b_ms, "bound_by": b_by})

    # ---- 3. decoder_stack: kernel vs plain, at the main path's shapes ----
    hist = histories(N_ITEMS, seed=3)
    tok_probe = SemanticIdTokenizer(rq, device=dev)
    tok_probe.precompute_corpus_ids(x)
    decoder_rows = []
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
                torch.cuda.synchronize()
                y_plain = t5_decoder_stack_plain(*ops, eps=eps)
                err = float((y - y_plain).abs().max().item())
                check(bool(torch.isfinite(y).all()), f"decoder_stack {dt} kT={beams * T}: non-finite output")
                check(err <= DECODER_TOL[dt], f"decoder_stack {dt} kT={beams * T}: max abs err {err}")
                k_ms = cuda_ms(lambda: t5_decoder_stack_infer(*ops, eps=eps), reps=10)
                p_ms = cuda_ms(lambda: t5_decoder_stack_plain(*ops, eps=eps), reps=10)
                kt, cfg = beams * T, dec.cfg
                NL, H, dk, d, dff, Le = cfg.num_layers, cfg.num_heads, cfg.d_kv, cfg.d_model, cfg.d_ff, enc.shape[1]
                flops = 2 * BATCH * kt * NL * (6 * d * H * dk + 2 * d * dff) + 4 * BATCH * NL * H * kt * (kt + Le) * dk
                nbytes = sum(t.numel() * t.element_size() for t in ops) + y.numel() * 4
                peak = H100_BF16_FLOPS if dt == torch.bfloat16 else H100_F32_FLOPS
                b_ms, b_by = bound_ms(flops, peak, nbytes)
                row = {"dtype": str(dt).split(".")[-1], "kT": kt, "max_abs_err": err, "tol": DECODER_TOL[dt],
                       "kernel_ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by}
                decoder_rows.append(row)
                if dt == torch.bfloat16 and kt == 30:  # the main path's largest level
                    kernels["decoder_stack"] = {
                        "name": "decoder_stack", "route": "cuda",
                        "source": "rqvae_tpu_torch/csrc/decoder_stack.cu",
                        "replaces": "rqvae_tpu/ops/pallas/decoder_stack.py:231",
                        "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                        "bound_by": b_by, "library_ms": None,
                    }
    emit({"phase": "decoder_stack", "B": BATCH, "Le": int(enc.shape[1]), "rows": decoder_rows})

    # ---- 4. the main path, launch counts zeroed just before ----
    fused_encode_quantize.launches = 0
    t5_decoder_stack_infer.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tok = SemanticIdTokenizer(rq, device=dev)
    cached = tok.precompute_corpus_ids(x)
    torch.cuda.synchronize()
    index_ms = (time.perf_counter() - t0) * 1e3
    retriever = Retriever(models[torch.bfloat16], tok, device=dev)
    call_ms, results = [], []
    for _ in range(CALLS):
        t0 = time.perf_counter()
        out = retriever.retrieve(hist)
        torch.cuda.synchronize()
        call_ms.append((time.perf_counter() - t0) * 1e3)
        results.append(out)
    launches = {"rq_encode": fused_encode_quantize.launches,
                "decoder_stack": t5_decoder_stack_infer.launches}
    check(launches["rq_encode"] >= 1, f"rq_encode launches {launches['rq_encode']}")
    check(launches["decoder_stack"] == 3 * CALLS, f"decoder_stack launches {launches['decoder_stack']}")
    kernels["rq_encode"]["launches"] = launches["rq_encode"]
    kernels["decoder_stack"]["launches"] = launches["decoder_stack"]
    cached_np = cached.cpu().numpy()
    for out in results:
        items, sem, logp = out.item_ids.cpu().numpy(), out.sem_ids.cpu().numpy(), out.log_probas.cpu().numpy()
        check(items.shape == (BATCH, 10) and sem.shape == (BATCH, 10, 3), f"shapes {items.shape} {sem.shape}")
        check(bool(np.isfinite(logp).all()), "non-finite log_probas")
        check(bool((np.diff(logp, axis=1) <= 0).all()), "log_probas not sorted")
        valid = items >= 0
        check(bool(valid.any()), "no beam resolved to a corpus item")
        check(bool((cached_np[items[valid], :3] == sem[valid]).all()), "item_ids do not map to their sem_ids")
        check(bool(((logp > -1e8) == valid).all()), "a valid beam has no item, or an item has an invalid beam")
        check(bool((np.asarray(results[0].sem_ids.cpu()) == sem).all()), "repeated calls differ")
    emit({"phase": "main_path", "items": N_ITEMS, "distinct_tuples": int((cached_np[:, 3] == 0).sum()),
          "max_dedup": int(cached_np[:, 3].max()), "index_build_ms": index_ms, "batch": BATCH,
          "retrieve_ms": call_ms, "valid_beams": float((results[-1].item_ids >= 0).float().mean()),
          "launches": launches})
    emit({"phase": "retrieve_profile", **profile_retrieve(retriever, hist)})

    # ---- 5. whole path in f32: card (kernels) against CPU (plain versions) ----
    rq_cpu = RqVae(vcfg, device="cpu")
    rq_cpu.load_state_dict({k: v.cpu() for k, v in rq.state_dict().items()})
    tok_cpu = SemanticIdTokenizer(rq_cpu, device="cpu")
    cached_cpu = tok_cpu.precompute_corpus_ids(x_cpu).numpy()
    near_np = near.cpu().numpy()
    id_differ = (cached_cpu[:, :3] != cached_np[:, :3]).any(1)
    check(not (id_differ & ~near_np).any(), "card and CPU index ids differ away from near-ties")
    model_cpu = EncoderDecoderRetrievalModel(RetrievalConfig(**rfields, t5_dtype="float32"), device="cpu", seed=2)
    card = Retriever(models[torch.float32], tok, device=dev).retrieve(hist)
    host = Retriever(model_cpu, tok_cpu, device="cpu").retrieve(hist)
    same = (card.sem_ids.cpu() == host.sem_ids).all(2).all(1).float().mean().item()
    logp_err = float((card.log_probas.cpu() - host.log_probas).abs().max().item())
    check(same >= BEAMS_SAME_MIN, f"card vs CPU: all beams identical on {same:.3f} of queries")
    emit({"phase": "card_vs_cpu_f32", "index_rows_differ": int(id_differ.sum()),
          "index_rows_near_tie": int(near_np.sum()), "queries_all_beams_same": same,
          "log_probas_max_abs_diff": logp_err})

    # ---- 6. kernels, card, result ----
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
             "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{k: kern[k] for k in order} for kern in kernels.values()]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
