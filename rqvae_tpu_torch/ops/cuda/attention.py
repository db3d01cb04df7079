"""Fused T5 attention forward: CUDA kernel wrapper and plain version.

Port of rqvae_tpu/ops/pallas/attention.py (forward). `t5_attention` launches
csrc/attention.cu for CUDA tensors and runs `t5_attention_plain` (the
arithmetic of the reference's `attention_reference`, keep bits from
ops/hash_dropout.py) for CPU tensors. No 1/sqrt(dk) scale; scores, bias,
masks (-1e9, never -inf) and softmax in float32; dropped probabilities are
zeroed and the rest scaled by 1/(1-rate) in float32, then rounded to the
compute dtype before the PV product. Forward only: the backward kernel and
the autograd.Function around both belong to the training slice, so inputs
that require grad are refused.

Shapes (cdt = compute dtype, float32 or bfloat16):
  q       [B, H, Lq, dk]  cdt
  k, v    [B, H, Lk, dk]  cdt
  bias    [H, Lq, Lk]     f32 (zeros when there is no position bias)
  mask    [B, Lk]         int/bool, nonzero = attend
  seed    int or 1-element int32 tensor (read only when dropout_rate > 0)
  out     [B, H, Lq, dk]  cdt
"""

from __future__ import annotations

import ctypes

import torch

from rqvae_tpu_torch.ops.cuda._build import check_launch, load_library
from rqvae_tpu_torch.ops.hash_dropout import attention_keep_mask, keep_threshold

NEG_INF = -1e9
MAX_DK = 128  # the kernel's widest head (csrc/attention_core.cuh)
_C = ctypes.c_void_p
_FUNCTIONS = {
    "attention_forward": [ctypes.c_int, ctypes.POINTER(_C), ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                          ctypes.c_uint, ctypes.c_float, ctypes.c_int, _C],
}
_PLAIN_CHUNK_ELEMS = 1 << 26  # score elements held at once by the plain version


def _check(q, k, v, bias, mask, causal, dropout_rate):
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 or q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"q [B, H, Lq, dk] and k, v [B, H, Lk, dk]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Lq, dk = q.shape
    Lk = k.shape[2]
    if tuple(bias.shape) != (H, Lq, Lk) or bias.dtype != torch.float32:
        raise ValueError(f"bias: want {(H, Lq, Lk)} float32, got {tuple(bias.shape)} {bias.dtype}")
    if tuple(mask.shape) != (B, Lk) or mask.dtype.is_floating_point:
        raise ValueError(f"mask: want {(B, Lk)} int or bool, got {tuple(mask.shape)} {mask.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share a dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if causal and Lq != Lk:
        raise ValueError("causal attention assumes Lq == Lk")
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate {dropout_rate} outside [0, 1)")
    if any(t.requires_grad for t in (q, k, v, bias)):
        raise NotImplementedError("t5_attention is forward only; the backward kernel is not ported yet")
    return B, H, Lq, Lk, dk


def _seed_value(seed) -> int:
    return int(seed.reshape(-1)[0].item()) if isinstance(seed, torch.Tensor) else int(seed)


def t5_attention_plain(q, k, v, bias, mask, seed=0, *, causal: bool = False,
                       dropout_rate: float = 0.0) -> torch.Tensor:
    """The kernel's arithmetic in torch, a few batch rows at a time so the
    [B, H, Lq, Lk] float32 scores are never held whole."""
    B, H, Lq, Lk, _ = _check(q, k, v, bias, mask, causal, dropout_rate)
    cdt, dev = q.dtype, q.device
    out = torch.empty_like(q)
    madd = torch.where(mask != 0, 0.0, NEG_INF).to(torch.float32)
    if causal:
        cadd = torch.where(torch.ones(Lq, Lk, dtype=torch.bool, device=dev).tril(), 0.0, NEG_INF)
    step = max(1, _PLAIN_CHUNK_ELEMS // max(1, H * Lq * Lk))
    for b0 in range(0, B, step):
        b1 = min(B, b0 + step)
        s = q[b0:b1].float() @ k[b0:b1].float().transpose(-1, -2)
        s = s + bias[None]
        s = s + madd[b0:b1, None, None, :]
        if causal:
            s = s + cadd
        p = torch.softmax(s, dim=-1)
        if dropout_rate > 0.0:
            keep = attention_keep_mask(_seed_value(seed), b1 - b0, H, Lq, Lk, dropout_rate, dev, b0)
            p = torch.where(keep, p, 0.0) * (1.0 / (1.0 - dropout_rate))
        out[b0:b1] = (p.to(cdt).float() @ v[b0:b1].float()).to(cdt)
    return out


def t5_attention(q, k, v, bias, mask, seed=0, *, causal: bool = False,
                 dropout_rate: float = 0.0) -> torch.Tensor:
    """softmax(q k^T + bias + mask [+ causal]) [dropout] @ v, [B, H, Lq, dk]
    at q's dtype. Launches the CUDA kernel for CUDA tensors (counted in
    `t5_attention.launches`); CPU tensors take the plain version."""
    dropout_rate = float(dropout_rate)
    if q.device.type == "cpu":
        return t5_attention_plain(q, k, v, bias, mask, seed, causal=causal, dropout_rate=dropout_rate)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, H, Lq, Lk, dk = _check(q, k, v, bias, mask, causal, dropout_rate)
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"attention computes in float32 or bfloat16, got {q.dtype}")
    if dk % 4 or not 4 <= dk <= MAX_DK:
        raise ValueError(f"attention needs dk a multiple of 4 in 4..{MAX_DK}, got {dk}")
    mask = mask.to(torch.int32).contiguous()
    if Lk == 0:
        raise ValueError("attention over no keys")
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if out.numel() == 0:
        return out
    tensors = (q, k, v, bias, mask, out)
    for t in tensors:
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("attention takes contiguous, 16-byte aligned tensors on one CUDA device")
    lib = load_library("attention", _FUNCTIONS)
    ptrs = (_C * 6)(*[t.data_ptr() for t in tensors])
    dims = (ctypes.c_int * 6)(B, H, Lq, Lk, dk, int(bool(causal)))
    if dropout_rate > 0.0:
        seed32 = ((_seed_value(seed) + 2**31) % 2**32) - 2**31  # the int32 the reference casts to
        thresh, scale = keep_threshold(dropout_rate), 1.0 / (1.0 - dropout_rate)
    else:
        seed32, thresh, scale = 0, 0, 1.0
    rc = lib.attention_forward(
        int(q.dtype == torch.bfloat16), ptrs, dims, seed32, thresh, scale, int(dropout_rate > 0.0),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    t5_attention.launches += 1
    check_launch(lib, rc, "attention")
    return out


t5_attention.launches = 0
