"""Fused MLP encode + residual quantization: CUDA kernel wrapper and plain version.

Port of rqvae_tpu/ops/pallas/rq_encode.py. The kernel is
csrc/rq_encode.cu; `fused_encode_quantize` launches it for CUDA tensors and
runs `fused_encode_quantize_plain` (the same arithmetic in torch) for CPU
tensors. Two precisions, as the reference's:

- "f32": every value and sum in float32, exact against the JAX package's
  f32 semantics up to argmin near-ties from summation order;
- "bf16": values rounded to bfloat16 where the reference casts to its
  compute dtype (x; each weight once per call; each layer's output after the
  ReLU, and the last layer's, which gives the residual; the codebooks used in
  the products and subtractions; the residual after each level), with every
  sum in float32 and the squared codebook norms from the unrounded float32
  codebooks. A product of two bf16 values is exact in float32, so the kernel
  and the plain version compute the reference's function up to the order of
  their float32 sums.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from rqvae_tpu_torch.ops.cuda._build import check_launch, launch_operand, load_library

_C = ctypes.c_void_p
_FUNCTIONS = {
    "rq_encode_forward": [
        _C, ctypes.c_int, ctypes.POINTER(_C), ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        _C, _C, ctypes.c_int, ctypes.c_int, ctypes.c_int, _C, ctypes.c_int, _C,
    ],
    "rq_encode_smem_bytes": [ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int, ctypes.c_int],
}
MAX_SMEM_BYTES = 232448  # 227 KB: the most one block may opt in to on Hopper
MAX_WEIGHTS = 8
PRECISIONS = ("f32", "bf16")


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to the nearest bfloat16 (ties to even), kept in float32."""
    return t.float().to(torch.bfloat16).float()


def _check(x, weights, codebooks, n_levels, precision) -> Tuple[int, ...]:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    if x.dim() != 2 or codebooks.dim() != 3:
        raise ValueError(f"x must be [N, D_in] and codebooks [L, K, D]; got {x.shape}, {codebooks.shape}")
    if not 1 <= n_levels <= codebooks.shape[0]:
        raise ValueError(f"n_levels={n_levels} outside 1..{codebooks.shape[0]}")
    if not 1 <= len(weights) <= MAX_WEIGHTS:
        raise ValueError(f"between 1 and {MAX_WEIGHTS} weights, got {len(weights)}")
    dims = [x.shape[1]]
    for w in weights:
        if w.dim() != 2 or w.shape[0] != dims[-1]:
            raise ValueError(f"weight chain mismatch at {tuple(w.shape)} after width {dims[-1]}")
        dims.append(w.shape[1])
    if dims[-1] != codebooks.shape[2]:
        raise ValueError(f"encoder width {dims[-1]} != codebook width {codebooks.shape[2]}")
    return tuple(dims)


def fused_encode_quantize_plain(
    x: torch.Tensor,
    weights: Sequence[torch.Tensor],
    codebooks: torch.Tensor,
    n_levels: int,
    precision: str = "f32",
) -> torch.Tensor:
    """The kernel's arithmetic in torch: matmul chain with ReLU between, then
    per level argmin(||cb||^2 - 2 res.cb) (first index on ties) and
    res -= cb[id]. In bf16 the values are rounded at the kernel's points and
    the products are float32 matmuls of the rounded values (a bf16 matmul
    would round its sums too). Returns [N, n_levels] int32."""
    _check(x, weights, codebooks, n_levels, precision)
    rnd = round_bf16 if precision == "bf16" else torch.Tensor.float
    h = rnd(x)
    for i, w in enumerate(weights):
        h = h @ rnd(w)
        if i != len(weights) - 1:
            h = torch.relu(h)
        h = rnd(h)
    res = h
    cb32 = codebooks.float()
    cb2 = torch.sum(cb32 * cb32, dim=-1)  # from the unrounded codebooks in both precisions
    cb = rnd(cb32)
    ids = []
    for level in range(n_levels):
        dist = cb2[level][None, :] - 2.0 * (res @ cb[level].T)
        idx = torch.argmin(dist, dim=-1)
        res = rnd(res - cb[level][idx])
        ids.append(idx.to(torch.int32))
    return torch.stack(ids, dim=1)


def fused_encode_quantize(
    x: torch.Tensor,  # [N, input_dim]
    weights: Sequence[torch.Tensor],  # encoder MLP weights [in, out], in order
    codebooks: torch.Tensor,  # [L, K, D]
    n_levels: int,
    precision: str = "f32",  # "f32" or "bf16", as the reference's
) -> torch.Tensor:
    """[N, n_levels] int32 semantic ids. Launches the CUDA kernel for CUDA
    tensors (and counts the launch in `fused_encode_quantize.launches`);
    CPU tensors take the plain version. Operands of any float dtype, layout
    and offset are taken, as the reference casts every operand: the kernel
    reads float32 copies, contiguous and on a 16-byte boundary, where they
    are not so already."""
    if x.device.type == "cpu":
        return fused_encode_quantize_plain(x, weights, codebooks, n_levels, precision)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    dims = _check(x, weights, codebooks, n_levels, precision)
    if any(t.device != x.device for t in (*weights, codebooks)):
        raise ValueError("rq_encode takes tensors on one CUDA device")
    if any(dim % 4 for dim in dims):
        raise ValueError(f"rq_encode needs every width to be a multiple of 4, got {dims}")
    K, D = codebooks.shape[1], codebooks.shape[2]
    lib = load_library("rq_encode", _FUNCTIONS)
    c_dims = (ctypes.c_int * len(dims))(*dims)
    smem = lib.rq_encode_smem_bytes(c_dims, len(weights), K, D)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"rq_encode needs {smem} B of shared memory for widths {dims}, "
                         f"over the {MAX_SMEM_BYTES} B a block may use")
    n = x.shape[0]
    out = torch.empty((n, n_levels), dtype=torch.int32, device=x.device)
    if n == 0:
        return out
    bf16 = precision == "bf16"
    rnd = round_bf16 if bf16 else torch.Tensor.float  # the weights and codebooks once per call
    x = launch_operand(x.float())  # rounded to bf16 by the kernel as it loads a tile
    weights = [launch_operand(rnd(w)) for w in weights]
    cb32 = codebooks.float()
    cb2 = launch_operand(torch.sum(cb32 * cb32, dim=-1))  # from the unrounded codebooks
    cbs = launch_operand(rnd(cb32))
    w_ptrs = (_C * len(weights))(*[w.data_ptr() for w in weights])
    with torch.cuda.device(x.device):  # the kernel launches on the current device
        rc = lib.rq_encode_forward(
            x.data_ptr(), n, w_ptrs, c_dims, len(weights), cbs.data_ptr(), cb2.data_ptr(),
            n_levels, K, D, out.data_ptr(), int(bf16), torch.cuda.current_stream(x.device).cuda_stream,
        )
    fused_encode_quantize.launches += 1
    check_launch(lib, rc, "rq_encode")
    return out


fused_encode_quantize.launches = 0


def pallas_supported(config) -> bool:
    """The kernel path needs no SimVQ out-projection and no encoder
    normalization (the JAX package's gate, kept as its routing rule)."""
    return not config.sim_vq and not config.codebook_normalize
