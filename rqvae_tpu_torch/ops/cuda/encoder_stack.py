"""Fused T5 encoder-stack forward for long-row serving: CUDA kernel wrapper
and plain version.

Port of rqvae_tpu/ops/pallas/encoder_stack.py. One call of
`t5_encoder_stack_infer` runs every encoder layer and the final RMSNorm
through csrc/encoder_stack.cu: a fixed sequence of 1 + 2 * NL kernel
launches on one stream (row-tile kernels and the attention core of
csrc/attention_core.cuh), with the scores, probabilities and FFN hidden
never written to device memory. CUDA tensors launch it; CPU tensors run
`t5_encoder_stack_plain` (the same arithmetic and rounding points in torch).
The row-tile kernel has two routes (`encoder_stack_route`; the C library's
`encoder_stack_route` makes the same choice): "tensor_cores" (bf16 at
dk = 64, d, H*dk and dff multiples of 64, d and H*dk up to 384: every
product on mma.sync) and "cuda_cores" (float32, and bf16 at other widths).
The C library's `encoder_stack_smem_bytes` gives the shared memory a rows
block of either route asks for.

Shapes (cdt = compute dtype, float32 or bfloat16):
  x         [B, L, d]       cdt  encoder input embeddings (any L, no padding)
  wq/wk/wv  [NL, H, d, dk]  cdt  per-head projections
  wo        [NL, H, dk, d]  cdt
  wi        [NL, d, dff]    cdt  FFN
  wo2       [NL, dff, d]    cdt
  ln_s/f    [NL, d]         f32  RMSNorm scales (self / ffn)
  ln_final  [d]             f32
  bias      [H, L, L]       f32  bidirectional rel-pos bias, shared by all layers
  mask      [B, L]          f32  additive key mask (0 / -1e9)
  out       [B, L, d]       f32  ln_final-normalized states
"""

from __future__ import annotations

import ctypes

import torch

from rqvae_tpu_torch.ops.cuda._build import check_launch, launch_operand, load_library
from rqvae_tpu_torch.ops.cuda.attention import MAX_DK
from rqvae_tpu_torch.ops.cuda.decoder_stack import MAX_SMEM_BYTES, _rmsnorm
from rqvae_tpu_torch.ops.cuda.rows_core import tensor_core_widths

_C = ctypes.c_void_p
_FUNCTIONS = {
    "encoder_stack_forward": [ctypes.c_int, ctypes.POINTER(_C), ctypes.POINTER(ctypes.c_int),
                              ctypes.c_float, _C],
    "encoder_stack_route": [ctypes.c_int] * 5,
    "encoder_stack_smem_bytes": [ctypes.c_int] * 5,
}


def encoder_stack_route(d: int, dk: int, inner: int, dff: int, dtype: torch.dtype) -> str:
    """The rows kernel's route for CUDA tensors of these widths:
    "tensor_cores" (bf16 at dk = 64, d and inner = H*dk multiples of 64 up
    to 384, dff a multiple of 64) or "cuda_cores". The attention between the
    rows kernels takes its own route (attention_route)."""
    if dtype == torch.bfloat16 and dk == 64 and tensor_core_widths(64, d, inner, dff):
        return "tensor_cores"
    return "cuda_cores"


def t5_encoder_stack_plain(
    x, wq, wk, wv, wo, wi, wo2, ln_s, ln_f, ln_final, bias, mask, *, eps: float,
) -> torch.Tensor:
    """The kernel's arithmetic in torch: every product in float32 on values
    held at the compute dtype, rounded where the kernel rounds. One head's
    [B, L, L] scores at a time."""
    cdt = x.dtype
    NL, H = wq.shape[0], wq.shape[1]

    def rnd(t):
        return t.to(cdt).float()

    xs = x.float()
    madd = mask[:, None, :]
    for l in range(NL):
        xn = rnd(_rmsnorm(xs, ln_s[l], eps, cdt))
        attn = torch.zeros_like(xs)
        for h in range(H):
            q = rnd(xn @ wq[l, h].float())
            k = rnd(xn @ wk[l, h].float())
            v = rnd(xn @ wv[l, h].float())
            p = rnd(torch.softmax(q @ k.transpose(-1, -2) + bias[h] + madd, dim=-1))
            attn = attn + rnd(p @ v) @ wo[l, h].float()
        xs = rnd(xs + rnd(attn))

        xn = rnd(_rmsnorm(xs, ln_f[l], eps, cdt))
        hf = torch.relu(rnd(xn @ wi[l].float()))
        xs = rnd(xs + rnd(hf @ wo2[l].float()))
    return _rmsnorm(xs, ln_final, eps, cdt)


def _check(x, wq, wk, wv, wo, wi, wo2, ln_s, ln_f, ln_final, bias, mask):
    if x.dim() != 3 or wq.dim() != 4:
        raise ValueError(f"x must be [B, L, d] and wq [NL, H, d, dk]; got {tuple(x.shape)}, {tuple(wq.shape)}")
    B, L, d = x.shape
    NL, H, _, dk = wq.shape
    dff = wi.shape[-1]
    want = {
        "wq": (wq, (NL, H, d, dk)), "wk": (wk, (NL, H, d, dk)), "wv": (wv, (NL, H, d, dk)),
        "wo": (wo, (NL, H, dk, d)), "wi": (wi, (NL, d, dff)), "wo2": (wo2, (NL, dff, d)),
    }
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape or t.dtype != x.dtype:
            raise ValueError(f"{name}: want {shape} {x.dtype}, got {tuple(t.shape)} {t.dtype}")
    f32 = {
        "ln_s": (ln_s, (NL, d)), "ln_f": (ln_f, (NL, d)), "ln_final": (ln_final, (d,)),
        "bias": (bias, (H, L, L)), "mask": (mask, (B, L)),
    }
    for name, (t, shape) in f32.items():
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name}: want {shape} float32, got {tuple(t.shape)} {t.dtype}")
    return B, L, d, NL, H, dk, dff


def _check_cuda(*args):
    """What the kernels take, checked before the library is loaded: shapes,
    dtype, one device, widths the kernels read 4 at a time. Any layout and
    offset are taken (`_build.py::launch_operand`). The shared memory of the rows
    kernel's route is checked against the library before launch."""
    x = args[0]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"encoder_stack computes in float32 or bfloat16, got {x.dtype}")
    B, L, d, NL, H, dk, dff = _check(*args)
    if d % 4 or dff % 4 or dk % 4 or not 4 <= dk <= MAX_DK:
        raise ValueError(f"encoder_stack needs d, dff multiples of 4 and dk a multiple of 4 in "
                         f"4..{MAX_DK}, got {d}, {dff}, {dk}")
    if any(t.device != x.device for t in args):
        raise ValueError("encoder_stack takes tensors on one device")
    return B, L, d, NL, H, dk, dff


def t5_encoder_stack_infer(
    x, wq, wk, wv, wo, wi, wo2, ln_s, ln_f, ln_final, bias, mask, *, eps: float,
) -> torch.Tensor:
    """[B, L, d] float32 encoder states. Launches the CUDA kernels for CUDA
    tensors (one count in `t5_encoder_stack_infer.launches` per call); CPU
    tensors take the plain version."""
    args = (x, wq, wk, wv, wo, wi, wo2, ln_s, ln_f, ln_final, bias, mask)
    if x.device.type == "cpu":
        _check(*args)
        return t5_encoder_stack_plain(*args, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    B, L, d, NL, H, dk, dff = _check_cuda(*args)
    out = torch.empty((B, L, d), dtype=torch.float32, device=x.device)
    if B == 0 or L == 0:
        return out
    if NL == 0:
        raise ValueError("encoder_stack needs at least one layer")
    lib = load_library("encoder_stack", _FUNCTIONS)
    bf16 = int(x.dtype == torch.bfloat16)
    smem = lib.encoder_stack_smem_bytes(bf16, d, dk, H * dk, dff)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"encoder_stack needs {smem} B of shared memory at d={d}, H*dk={H * dk} on the "
                         f"{encoder_stack_route(d, dk, H * dk, dff, x.dtype)} route, over the "
                         f"{MAX_SMEM_BYTES} B a block may use")
    # scratch between the kernels of the sequence: the residual stream, q, k, v
    # and the per-head attention output, at the compute dtype
    xs = torch.empty((B, L, d), dtype=x.dtype, device=x.device)
    q, k, v, oh = (torch.empty((B, H, L, dk), dtype=x.dtype, device=x.device) for _ in range(4))
    tensors = (*(launch_operand(t) for t in args), out, xs, q, k, v, oh)  # held until the launches are queued
    ptrs = (_C * 18)(*[t.data_ptr() for t in tensors])
    dims = (ctypes.c_int * 7)(B, L, d, NL, H, dk, dff)
    with torch.cuda.device(x.device):  # the kernels launch on the current device
        rc = lib.encoder_stack_forward(
            bf16, ptrs, dims, float(eps),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    t5_encoder_stack_infer.launches += 1
    check_launch(lib, rc, "encoder_stack")
    return out


t5_encoder_stack_infer.launches = 0
