"""Kernel 5 (rqvae_tpu_torch/csrc/attention_bwd.cu) on the card: one backward
call's device time, each of its kernels' share, and autograd through
PyTorch's SDPA as the yardstick, at the training cells' attention shapes.

    python benchmarks/torch_attention_bwd.py [--shapes 64x6x800,64x32x800] [--hold-gb 40]
        [--roots <checkout> ...] [--out <file.jsonl>]

Each shape runs bf16 at dk = 64 with dropout 0.1 and the forward's keep bits,
as training calls it. `--hold-gb` fills that much of the card before the
32-head shape (the MoE cell holds about 40 GB). With `--roots`, each root is
a checkout whose port is timed in its own process, in the order given (two
versions compared in one call: a, b, b, a). Prints one JSON line per (root,
shape); needs a CUDA card.
"""

import argparse
import json
import os
import subprocess
import sys

LEAST_MS_PER_GFLOP = 1e3 / 989e3  # bf16 tensor-core peak of an H100 SXM


def _shape(text):
    B, H, L = (int(x) for x in text.split("x"))
    return B, H, L


def measure(B, H, L, hold_gb, reps=20):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rqvae_tpu_torch.ops.cuda import attention as A

    assert torch.cuda.is_available(), "needs a CUDA card"
    dev = torch.device("cuda")
    filler = torch.empty(int(hold_gb * 2**30), dtype=torch.uint8, device=dev) if H > 6 and hold_gb > 0 else None
    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    q, k, v, do = (torch.randn(B, H, L, 64, device=dev, generator=g).to(bf) for _ in range(4))
    bias = torch.randn(H, L, L, device=dev, generator=g)
    lengths = torch.randint(L // 4, L + 1, (B,), device=dev, generator=g)
    mask = (torch.arange(L, device=dev)[None, :] < lengths[:, None]).to(torch.int32)
    seed = torch.tensor([77], dtype=torch.int32, device=dev)
    _, m, l, bits = A._forward_cuda(q, k, v, bias, mask, seed, False, 0.1, True)

    def call():
        return A._backward_cuda(q, k, v, bias, mask, seed, do, m, l, False, 0.1, keep_bits=bits)

    for _ in range(3):
        call()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        call()
    t1.record()
    torch.cuda.synchronize()
    ms = t0.elapsed_time(t1) / reps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            call()
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.key_averages():
        dt = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
        if dt > 0:
            kernels[e.key[:60]] = round(dt / 5 / 1e3, 4)  # ms a call
    del filler

    # the yardstick: SDPA's backward at the same shape, no dropout, the
    # additive bias and key mask as a bf16 attention mask
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
    am = (bias[None] + torch.where(mask[:, None, None, :] != 0, 0.0, -1e9)).to(bf)
    out = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, attn_mask=am, scale=1.0)
    for _ in range(2):
        torch.autograd.grad(out, (qs, ks, vs), do, retain_graph=True)
    torch.cuda.synchronize()
    t0.record()
    for _ in range(5):
        torch.autograd.grad(out, (qs, ks, vs), do, retain_graph=True)
    t1.record()
    torch.cuda.synchronize()
    sdpa_ms = t0.elapsed_time(t1) / 5
    gflop = 8.0 * B * H * L * L * 64 / 1e9
    bound = gflop * LEAST_MS_PER_GFLOP
    return {"shape": [B, H, L, 64], "ms": round(ms, 4), "bound_ms": round(bound, 4),
            "roofline_pct": round(100.0 * bound / ms, 2), "kernels_ms": kernels, "sdpa_bwd_ms": round(sdpa_ms, 4),
            "card": torch.cuda.get_device_name(0)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--shapes", default="64x6x800,64x32x800")
    ap.add_argument("--hold-gb", type=float, default=40.0)
    ap.add_argument("--roots", nargs="*", default=None)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    if a.roots:
        for root in a.roots:
            env = dict(os.environ, PYTHONPATH=os.path.abspath(root))
            cmd = [sys.executable, os.path.abspath(__file__), "--shapes", a.shapes, "--hold-gb", str(a.hold_gb)]
            for line in subprocess.run(cmd, env=env, cwd=root, check=True, capture_output=True,
                                       text=True).stdout.splitlines():
                row = json.dumps({"root": root, **json.loads(line)})
                print(row, flush=True)
                if a.out:
                    with open(a.out, "a") as f:
                        f.write(row + "\n")
        return
    for text in a.shapes.split(","):
        row = measure(*_shape(text), a.hold_gb)
        print(json.dumps(row), flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(json.dumps(row) + "\n")


if __name__ == "__main__":
    main()
