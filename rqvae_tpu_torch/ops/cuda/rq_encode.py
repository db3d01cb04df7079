"""Fused MLP encode + residual quantization: CUDA kernel wrapper and plain version.

Port of rqvae_tpu/ops/pallas/rq_encode.py. The kernel is
csrc/rq_encode.cu; `fused_encode_quantize` launches it for CUDA tensors and
runs `fused_encode_quantize_plain` (the same arithmetic in torch) for CPU
tensors. Both compute in float32, which makes them exact against the JAX
package's f32 semantics up to argmin near-ties from summation order.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from rqvae_tpu_torch.ops.cuda._build import check_launch, load_library

_C = ctypes.c_void_p
_FUNCTIONS = {
    "rq_encode_forward": [
        _C, ctypes.c_int, ctypes.POINTER(_C), ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        _C, _C, ctypes.c_int, ctypes.c_int, ctypes.c_int, _C, _C,
    ],
    "rq_encode_smem_bytes": [ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int, ctypes.c_int],
}
MAX_SMEM_BYTES = 232448  # 227 KB: the most one block may opt in to on Hopper
MAX_WEIGHTS = 8


def _check(x, weights, codebooks, n_levels) -> Tuple[int, ...]:
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
) -> torch.Tensor:
    """The kernel's arithmetic in torch: f32 matmul chain with ReLU between,
    then per level argmin(||cb||^2 - 2 res.cb) (first index on ties) and
    res -= cb[id]. Returns [N, n_levels] int32."""
    _check(x, weights, codebooks, n_levels)
    h = x.float()
    for i, w in enumerate(weights):
        h = h @ w.float()
        if i != len(weights) - 1:
            h = torch.relu(h)
    res = h
    cb = codebooks.float()
    cb2 = torch.sum(cb * cb, dim=-1)
    ids = []
    for level in range(n_levels):
        dist = cb2[level][None, :] - 2.0 * (res @ cb[level].T)
        idx = torch.argmin(dist, dim=-1)
        res = res - cb[level][idx]
        ids.append(idx.to(torch.int32))
    return torch.stack(ids, dim=1)


def fused_encode_quantize(
    x: torch.Tensor,  # [N, input_dim] f32
    weights: Sequence[torch.Tensor],  # encoder MLP weights [in, out], in order
    codebooks: torch.Tensor,  # [L, K, D]
    n_levels: int,
    precision: str = "f32",
) -> torch.Tensor:
    """[N, n_levels] int32 semantic ids. Launches the CUDA kernel for CUDA
    tensors (and counts the launch in `fused_encode_quantize.launches`);
    CPU tensors take the plain version."""
    if precision != "f32":
        raise NotImplementedError("rq_encode runs in float32 only; bf16 is not ported yet")
    if x.device.type == "cpu":
        return fused_encode_quantize_plain(x, weights, codebooks, n_levels)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    dims = _check(x, weights, codebooks, n_levels)
    tensors = [x, *weights, codebooks]
    for t in tensors:
        if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("rq_encode takes contiguous float32 tensors on one CUDA device")
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
    cb2 = torch.sum(codebooks * codebooks, dim=-1).contiguous()
    w_ptrs = (_C * len(weights))(*[w.data_ptr() for w in weights])
    with torch.cuda.device(x.device):  # the kernel launches on the current device
        rc = lib.rq_encode_forward(
            x.data_ptr(), n, w_ptrs, c_dims, len(weights), codebooks.data_ptr(), cb2.data_ptr(),
            n_levels, K, D, out.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream,
        )
    fused_encode_quantize.launches += 1
    check_launch(lib, rc, "rq_encode")
    return out


fused_encode_quantize.launches = 0


def pallas_supported(config) -> bool:
    """The kernel path needs no SimVQ out-projection and no encoder
    normalization (the JAX package's gate, kept as its routing rule)."""
    return not config.sim_vq and not config.codebook_normalize
