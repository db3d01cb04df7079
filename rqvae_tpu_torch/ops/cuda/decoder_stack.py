"""Fused T5 decoder-stack forward for beam-search serving: CUDA kernel wrapper
and plain version.

Port of rqvae_tpu/ops/pallas/decoder_stack.py. One launch of
csrc/decoder_stack.cu runs every decoder layer for one decode level.
`t5_decoder_stack_infer` launches it for CUDA tensors and runs
`t5_decoder_stack_plain` (the same arithmetic and rounding points in torch)
for CPU tensors. The kernel has two routes (`decoder_stack_route`, the C
library's `decoder_stack_route` makes the same choice): "tensor_cores"
(bf16 at dk = 64, kT <= 32, Le <= 128 and widths that are multiples of 128,
the published configurations: every product on mma.sync, on a cluster of
two blocks per batch row) and "cuda_cores" (float32, and bf16 at other
widths). The C library's `decoder_stack_smem_bytes` gives the shared memory
a block of either route asks for.

Shapes (cdt = compute dtype, float32 or bfloat16):
  x         [B, kT, d]         cdt  beam-folded input embeddings (kT = beams*T)
  wq/wk/wv  [NL, H, d, dk]     cdt  self-attention projections, per head
  wo        [NL, H, dk, d]     cdt
  cq        [NL, H, d, dk]     cdt  cross-attention query projection
  co        [NL, H, dk, d]     cdt
  wi        [NL, d, dff]       cdt  FFN
  wo2       [NL, dff, d]       cdt
  ln_s/c/f  [NL, d]            f32  RMSNorm scales (self / cross / ffn)
  ln_final  [d]                f32
  bias_fold [H, kT, kT]        f32  rel-pos bias + causal + cross-beam -1e9
  kc, vc    [NL, B, H, Le, dk] cdt  cross K/V cache (T5Stack.cross_kv)
  mask      [B, Le]            f32  additive cross-attention mask (0 / -1e9)
  out       [B, kT, d]         f32  ln_final-normalized states
"""

from __future__ import annotations

import ctypes

import torch

from rqvae_tpu_torch.ops.cuda._build import check_launch, launch_operand, load_library
from rqvae_tpu_torch.ops.cuda.rows_core import tensor_core_widths

_C = ctypes.c_void_p
_FUNCTIONS = {
    "decoder_stack_forward": [ctypes.c_int, ctypes.POINTER(_C), ctypes.POINTER(ctypes.c_int),
                              ctypes.c_float, _C],
    "decoder_stack_route": [ctypes.c_int] * 7,
    "decoder_stack_smem_bytes": [ctypes.c_int] * 7,
}
MAX_SMEM_BYTES = 232448  # 227 KB: the most one block may opt in to on Hopper
TC_DK, TC_MAX_KT, TC_MAX_LE = 64, 32, 128  # the tensor-core route's head width, rows and keys


def decoder_stack_route(kT: int, d: int, dk: int, inner: int, dff: int, Le: int, dtype: torch.dtype) -> str:
    """The kernel route CUDA tensors of these widths launch: "tensor_cores"
    (bf16 at dk = 64, 1 <= kT <= 32, 1 <= Le <= 128, d and inner = H*dk
    multiples of 128 up to 384, dff a multiple of 128: every product halves
    into 64-column blocks, one for each block of a batch row's pair) or
    "cuda_cores"."""
    if (dtype == torch.bfloat16 and dk == TC_DK and 1 <= kT <= TC_MAX_KT and 1 <= Le <= TC_MAX_LE
            and tensor_core_widths(128, d, inner, dff)):
        return "tensor_cores"
    return "cuda_cores"


def _rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float, cdt: torch.dtype) -> torch.Tensor:
    """f32 math, rounded to the compute dtype, then scaled in f32 (the
    reference's RMSNorm cast point). 1/sqrt, both correctly rounded, as
    the kernel computes it (CUDA's rsqrt is approximate)."""
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * (1.0 / torch.sqrt(var + eps))).to(cdt).float() * w


def t5_decoder_stack_plain(
    x, wq, wk, wv, wo, cq, co, wi, wo2, ln_s, ln_c, ln_f, ln_final,
    bias_fold, kc, vc, mask, *, eps: float,
) -> torch.Tensor:
    """The kernel's arithmetic in torch: every product in float32 on values
    held at the compute dtype, rounded where the kernel rounds."""
    cdt = x.dtype
    NL, H = wq.shape[0], wq.shape[1]

    def rnd(t):
        return t.to(cdt).float()

    xs = x.float()
    for l in range(NL):
        xn = rnd(_rmsnorm(xs, ln_s[l], eps, cdt))
        attn = torch.zeros_like(xs)
        for h in range(H):
            q = rnd(xn @ wq[l, h].float())
            k = rnd(xn @ wk[l, h].float())
            v = rnd(xn @ wv[l, h].float())
            p = rnd(torch.softmax(q @ k.transpose(-1, -2) + bias_fold[h], dim=-1))
            attn = attn + rnd(p @ v) @ wo[l, h].float()
        xs = rnd(xs + rnd(attn))

        xn = rnd(_rmsnorm(xs, ln_c[l], eps, cdt))
        catt = torch.zeros_like(xs)
        for h in range(H):
            q = rnd(xn @ cq[l, h].float())
            s = q @ kc[l, :, h].float().transpose(-1, -2) + mask[:, None, :]
            p = rnd(torch.softmax(s, dim=-1))
            catt = catt + rnd(p @ vc[l, :, h].float()) @ co[l, h].float()
        xs = rnd(xs + rnd(catt))

        xn = rnd(_rmsnorm(xs, ln_f[l], eps, cdt))
        hf = torch.relu(rnd(xn @ wi[l].float()))
        xs = rnd(xs + rnd(hf @ wo2[l].float()))
    return _rmsnorm(xs, ln_final, eps, cdt)


def _check(x, wq, wk, wv, wo, cq, co, wi, wo2, ln_s, ln_c, ln_f, ln_final,
           bias_fold, kc, vc, mask):
    B, kT, d = x.shape
    NL, H, _, dk = wq.shape
    dff = wi.shape[-1]
    Le = kc.shape[3]
    want = {
        "wq": (wq, (NL, H, d, dk)), "wk": (wk, (NL, H, d, dk)), "wv": (wv, (NL, H, d, dk)),
        "wo": (wo, (NL, H, dk, d)), "cq": (cq, (NL, H, d, dk)), "co": (co, (NL, H, dk, d)),
        "wi": (wi, (NL, d, dff)), "wo2": (wo2, (NL, dff, d)), "kc": (kc, (NL, B, H, Le, dk)),
        "vc": (vc, (NL, B, H, Le, dk)),
    }
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape or t.dtype != x.dtype:
            raise ValueError(f"{name}: want {shape} {x.dtype}, got {tuple(t.shape)} {t.dtype}")
    f32 = {
        "ln_s": (ln_s, (NL, d)), "ln_c": (ln_c, (NL, d)), "ln_f": (ln_f, (NL, d)),
        "ln_final": (ln_final, (d,)), "bias_fold": (bias_fold, (H, kT, kT)), "mask": (mask, (B, Le)),
    }
    for name, (t, shape) in f32.items():
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name}: want {shape} float32, got {tuple(t.shape)} {t.dtype}")
    return B, kT, d, NL, H, dk, dff, Le


def _check_cuda(*args):
    """What the kernel takes, checked before the library is loaded: shapes,
    dtype, one device, widths the kernels read 4 at a time. Any layout and
    offset are taken (`_build.py::launch_operand`). The shared memory of the
    shape's route is checked against the library before launch."""
    x = args[0]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"decoder_stack computes in float32 or bfloat16, got {x.dtype}")
    B, kT, d, NL, H, dk, dff, Le = _check(*args)
    if any(t.device != x.device for t in args):
        raise ValueError("decoder_stack takes tensors on one device")
    if d % 4 or dk % 4 or dff % 4:
        raise ValueError(f"decoder_stack needs d, dk, dff multiples of 4, got {d}, {dk}, {dff}")
    return B, kT, d, NL, H, dk, dff, Le


def t5_decoder_stack_infer(
    x, wq, wk, wv, wo, cq, co, wi, wo2, ln_s, ln_c, ln_f, ln_final,
    bias_fold, kc, vc, mask, *, eps: float,
) -> torch.Tensor:
    """[B, kT, d] float32 decoder states. Launches the CUDA kernel for CUDA
    tensors (counted in `t5_decoder_stack_infer.launches`); CPU tensors take
    the plain version."""
    args = (x, wq, wk, wv, wo, cq, co, wi, wo2, ln_s, ln_c, ln_f, ln_final, bias_fold, kc, vc, mask)
    if x.device.type == "cpu":
        _check(*args)
        return t5_decoder_stack_plain(*args, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    B, kT, d, NL, H, dk, dff, Le = _check_cuda(*args)
    out = torch.empty((B, kT, d), dtype=torch.float32, device=x.device)
    if B == 0 or kT == 0:
        return out
    lib = load_library("decoder_stack", _FUNCTIONS)
    bf16 = int(x.dtype == torch.bfloat16)
    smem = lib.decoder_stack_smem_bytes(bf16, kT, d, dk, H * dk, dff, Le)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"decoder_stack needs {smem} B of shared memory at kT={kT}, d={d}, Le={Le} on the "
                         f"{decoder_stack_route(kT, d, dk, H * dk, dff, Le, x.dtype)} route, over the "
                         f"{MAX_SMEM_BYTES} B a block may use")
    args = tuple(launch_operand(t) for t in args)  # held until the launch is queued on the stream
    ptrs = (_C * 18)(*[t.data_ptr() for t in args], out.data_ptr())
    dims = (ctypes.c_int * 8)(B, kT, d, NL, H, dk, dff, Le)
    with torch.cuda.device(x.device):  # the kernel launches on the current device
        rc = lib.decoder_stack_forward(
            bf16, ptrs, dims, float(eps),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    t5_decoder_stack_infer.launches += 1
    check_launch(lib, rc, "decoder_stack")
    return out


t5_decoder_stack_infer.launches = 0
