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

The kernel has two routes (`rq_encode_route`), chosen here and passed to
the library, which launches that route or refuses the shape:
"tensor_cores" (bf16 at hidden and embedding widths in TC_WIDTHS and
codebook sizes in TC_CODEBOOK_SIZES, every shipped configuration: every
product on mma.sync, activations in bf16) and "cuda_cores" (float32, which
must not drop to TF32, and bf16 at other widths: float32 FMAs). Any input
width is taken: `pad_operands` pads x's columns and the first weight's rows
to a multiple of 4, and the later widths to multiples of 16, with zeros,
which add nothing to any sum.

`emit_packed=True` appends the reference's epilogue column, each row's
lexicographic packed key (ops/dedup.py::pack_sem_id_tuples of its ids), in
the kernel and in the plain version alike. No path of either package reads it.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from rqvae_tpu_torch.ops.cuda._build import check_launch, launch_operand, load_library

_C = ctypes.c_void_p
_FUNCTIONS = {
    "rq_encode_forward": [
        _C, ctypes.c_int, ctypes.POINTER(_C), ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        _C, _C, _C, ctypes.c_int, ctypes.c_int, ctypes.c_int, _C, ctypes.c_int, ctypes.c_int, ctypes.c_int, _C,
    ],
    "rq_encode_smem_bytes": [ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int, ctypes.c_int],
    "rq_encode_rows_per_block": [],
}
MAX_SMEM_BYTES = 232448  # 227 KB: the most one block may opt in to on Hopper
MAX_WEIGHTS = 8
MAX_LEVELS = 16
MAX_WIDTH = 512  # the widest layer, and the largest codebook, either route takes
PRECISIONS = ("f32", "bf16")
ROUTES = ("cuda_cores", "tensor_cores")  # the library's route codes 0 and 1
TC_WIDTHS = (16, 32, 64, 128, 256, 512)  # hidden and embedding widths of the tensor-core route
TC_CODEBOOK_SIZES = (64, 128, 256)
ROWS_PER_BLOCK = 64  # corpus rows a block of either route takes (csrc/rq_encode.cu ROWS)
# csrc/rq_encode.cu's tiles: the tensor-core route's ring depth, ring slot
# (bf16), column warps and widest pass; the CUDA-core route's K-tile rows,
# ring depth and x chunk row stride
_TC_STAGES, _TC_SLOT_CAP, _TC_WARPS_N, _TC_MAX_PASS_N = 3, 64 * 136, 8, 256
_CC_BK, _CC_STAGES, _CC_XLD = 16, 2, 20


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to the nearest bfloat16 (ties to even), kept in float32."""
    return t.float().to(torch.bfloat16).float()


def _ceil(v: int, m: int) -> int:
    return -(-v // m) * m


def prepared_widths(dims: Sequence[int], K: int) -> Tuple[Tuple[int, ...], int]:
    """The widths the kernel reads, after `pad_operands`: the input width a
    multiple of 4 (16-byte float32 rows), every later width a multiple of
    16; and the codebook size a multiple of 16."""
    return (_ceil(dims[0], 4), *(_ceil(d, 16) for d in dims[1:])), _ceil(K, 16)


def _tc_tile_k(k: int, n: int) -> int:
    """Rows of a tensor-core K-tile of a product k deep and n wide (tc::tile_k)."""
    bk = 16
    while k % (2 * bk) == 0 and 2 * bk * (n + 8) <= _TC_SLOT_CAP:
        bk *= 2
    return bk


def rq_encode_smem_bytes(dims: Sequence[int], K: int, route: str) -> int:
    """Shared memory one block of `route` needs at these prepared widths
    (`prepared_widths`): csrc/rq_encode.cu's tc::layout and cc::layout, which
    the library's `rq_encode_smem_bytes` computes on the card."""
    n = len(dims) - 1
    if route == "tensor_cores":
        depth = [_ceil(dims[0], 16), *dims[1:]]  # x padded to the MMA depth
        widest = [max(depth[i] + 8 for i in range(n + 1) if i % 2 == par) if par <= n else 0 for par in (0, 1)]
        passes = [(dims[-1], K), *((k, min(m, _TC_MAX_PASS_N)) for k, m in zip(depth[:-1], dims[1:]))]
        slot = max(_tc_tile_k(k, m) * (m + 8) for k, m in passes)
        return 64 * (widest[0] + widest[1]) * 2 + _TC_STAGES * slot * 2 + 64 * _TC_WARPS_N * 8 + 64 * 4
    if route == "cuda_cores":
        odd = max((dims[i] + 4 for i in range(1, n + 1) if i % 2), default=0)
        even = max((dims[i] + 4 for i in range(2, n + 1) if i % 2 == 0), default=0)
        later = max(K, *dims[2:]) if n >= 2 else K
        ring0 = _CC_STAGES * (64 * _CC_XLD + _CC_BK * dims[1]) * 4
        rest = 64 * even * 4 + _CC_STAGES * _CC_BK * later * 4
        return 64 * odd * 4 + max(ring0, rest) + 64 * 4
    raise ValueError(f"route must be one of {ROUTES}, got {route!r}")


def rq_encode_route(dims: Sequence[int], K: int, D: int, precision: str) -> str:
    """The route CUDA tensors of these widths take: `dims` the MLP chain
    [input, hidden..., embedding], K the codebook size, D the codebook width
    (the embedding width). "tensor_cores" for bf16 when every hidden and
    embedding width is in TC_WIDTHS, K in TC_CODEBOOK_SIZES and the block
    fits in shared memory (any input width: x is padded to the MMA depth in
    the kernel); else "cuda_cores"."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    if (precision == "bf16" and D == dims[-1] and all(w in TC_WIDTHS for w in dims[1:])
            and K in TC_CODEBOOK_SIZES):
        widths, kp = prepared_widths(dims, K)
        if rq_encode_smem_bytes(widths, kp, "tensor_cores") <= MAX_SMEM_BYTES:
            return "tensor_cores"
    return "cuda_cores"


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


def pad_operands(x: torch.Tensor, weights: Sequence[torch.Tensor], codebooks: torch.Tensor):
    """x, weights and codebooks zero-padded to `prepared_widths`, each only
    where it is not so already (a tensor that needs no padding is returned
    as it is). A zero column of x meets a zero row of the first weight, a
    zero column of a layer (ReLU(0) = 0, and 0 rounds to 0) a zero row of the
    next weight, and a zero column of the codebooks a zero column of the
    residual: every product, distance, norm and residual of the real widths
    is unchanged, so the ids are those of the unpadded operands."""
    dims = [x.shape[1], *(w.shape[1] for w in weights)]
    widths, _ = prepared_widths(dims, codebooks.shape[1])

    def pad(t, rows, cols):  # t [r, c] -> [rows, cols], zeros appended
        return t if tuple(t.shape[-2:]) == (rows, cols) else F.pad(t, (0, cols - t.shape[-1], 0, rows - t.shape[-2]))

    x = x if x.shape[1] == widths[0] else F.pad(x, (0, widths[0] - x.shape[1]))
    weights = [pad(w, widths[i], widths[i + 1]) for i, w in enumerate(weights)]
    return x, weights, pad(codebooks, codebooks.shape[1], widths[-1])


def pack_bits_for(codebook_size: int, n_levels: int) -> int:
    """Bits per level of the emit_packed key column (ops/dedup.py::id_bits),
    refused past 31 bits of key."""
    bits = max(1, (int(codebook_size) - 1).bit_length())
    if n_levels * bits > 31:
        raise ValueError(f"emit_packed needs n_levels * id_bits <= 31, got {n_levels} x {bits}")
    return bits


def fused_encode_quantize_plain(
    x: torch.Tensor,
    weights: Sequence[torch.Tensor],
    codebooks: torch.Tensor,
    n_levels: int,
    precision: str = "f32",
    emit_packed: bool = False,
) -> torch.Tensor:
    """The kernel's arithmetic in torch: matmul chain with ReLU between, then
    per level argmin(||cb||^2 - 2 res.cb) (first index on ties) and
    res -= cb[id]. In bf16 the values are rounded at the kernel's points and
    the products are float32 matmuls of the rounded values (a bf16 matmul
    would round its sums too). Returns [N, n_levels] int32; with
    emit_packed, [N, n_levels + 1], the last column the lexicographic packed
    key of the row's ids (the reference's epilogue)."""
    _check(x, weights, codebooks, n_levels, precision)
    bits = pack_bits_for(codebooks.shape[1], n_levels) if emit_packed else 0
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
    if emit_packed:
        packed = ids[0]
        for col in ids[1:]:
            packed = (packed << bits) | col
        ids.append(packed)
    return torch.stack(ids, dim=1)


def kernel_operands(x, weights, codebooks, n_levels: int, precision: str, route: str):
    """The operands the library reads, from float32 x and the caller's
    weights and codebooks: x, weights and codebooks padded (`pad_operands`);
    weights and codebooks rounded to bf16 in bf16 mode, once per call, and
    stored as bf16 on the tensor-core route, float32 on the CUDA-core route;
    the first n_levels codebooks [L, K, D] (the gather) and transposed
    [L, D, K] (the distance product's right operand); cb2 [L, K], the
    squared norms of the unrounded float32 codebooks. Codes past the
    codebook size, to a multiple of 16, are zeros with cb2 = +inf: they never
    win an argmin. Returns (x, weights, codebooks, codebooks_t, cb2), each
    contiguous and on a 16-byte boundary."""
    if route == "tensor_cores":  # bf16 storage: the cast is the rounding
        prep = lambda t: t.to(torch.bfloat16)  # noqa: E731
    else:
        prep = round_bf16 if precision == "bf16" else torch.Tensor.float
    x, weights, codebooks = pad_operands(x, weights, codebooks)
    weights = [launch_operand(prep(w)) for w in weights]
    cb32 = codebooks[:n_levels].float()
    cb2 = torch.sum(cb32 * cb32, dim=-1)
    cb = prep(cb32)
    K = cb.shape[1]
    kp = _ceil(K, 16)
    if kp != K:
        cb = F.pad(cb, (0, 0, 0, kp - K))
        cb2 = F.pad(cb2, (0, kp - K), value=float("inf"))
    return launch_operand(x), weights, launch_operand(cb), launch_operand(cb.transpose(1, 2)), launch_operand(cb2)


def _library():
    return load_library("rq_encode", _FUNCTIONS)


def fused_encode_quantize(
    x: torch.Tensor,  # [N, input_dim]
    weights: Sequence[torch.Tensor],  # encoder MLP weights [in, out], in order
    codebooks: torch.Tensor,  # [L, K, D]
    n_levels: int,
    precision: str = "f32",  # "f32" or "bf16", as the reference's
    emit_packed: bool = False,  # append the packed key column (n_levels * id_bits <= 31)
) -> torch.Tensor:
    """[N, n_levels] int32 semantic ids ([N, n_levels + 1] with emit_packed,
    the last column each row's lexicographic packed key, written by the
    kernel's epilogue). Launches the CUDA kernel for CUDA
    tensors on the route `rq_encode_route` gives (and counts the launch in
    `fused_encode_quantize.launches`); CPU tensors take the plain version.
    Operands of any float dtype, layout, offset and width are taken, as the
    reference casts every operand: the kernel reads prepared copies
    (`kernel_operands`). Widths past MAX_WIDTH, more than MAX_LEVELS levels
    and shapes whose block does not fit in shared memory raise ValueError."""
    if x.device.type == "cpu":
        return fused_encode_quantize_plain(x, weights, codebooks, n_levels, precision, emit_packed)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    dims = _check(x, weights, codebooks, n_levels, precision)
    if any(t.device != x.device for t in (*weights, codebooks)):
        raise ValueError("rq_encode takes tensors on one CUDA device")
    if n_levels > MAX_LEVELS:
        raise ValueError(f"rq_encode takes at most {MAX_LEVELS} levels, got {n_levels}")
    K, D = codebooks.shape[1], codebooks.shape[2]
    bits = pack_bits_for(K, n_levels) if emit_packed else 0
    route = rq_encode_route(dims, K, D, precision)
    widths, kp = prepared_widths(dims, K)
    if max(*widths[1:], kp) > MAX_WIDTH:
        raise ValueError(f"rq_encode takes widths and codebook sizes up to {MAX_WIDTH}, got {dims}, K={K}")
    lib = _library()
    c_dims = (ctypes.c_int * len(widths))(*widths)
    smem = lib.rq_encode_smem_bytes(c_dims, len(weights), kp, ROUTES.index(route))
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"rq_encode ({route}) needs {smem} B of shared memory for widths {dims}, "
                         f"over the {MAX_SMEM_BYTES} B a block may use")
    n = x.shape[0]
    out = torch.empty((n, n_levels + int(emit_packed)), dtype=torch.int32, device=x.device)
    if n == 0:
        return out
    # x stays float32 (rounded to bf16 by the kernel as it loads a tile)
    xk, wk, cb, cb_t, cb2 = kernel_operands(x.float(), weights, codebooks, n_levels, precision, route)
    w_ptrs = (_C * len(wk))(*[w.data_ptr() for w in wk])
    with torch.cuda.device(x.device):  # the kernel launches on the current device
        rc = lib.rq_encode_forward(
            xk.data_ptr(), n, w_ptrs, c_dims, len(wk), cb.data_ptr(), cb_t.data_ptr(), cb2.data_ptr(),
            n_levels, kp, widths[-1], out.data_ptr(), int(precision == "bf16"), ROUTES.index(route), bits,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    fused_encode_quantize.launches += 1
    check_launch(lib, rc, f"rq_encode ({route})")
    return out


fused_encode_quantize.launches = 0


def pallas_supported(config) -> bool:
    """The kernel path needs no SimVQ out-projection and no encoder
    normalization (the JAX package's gate, kept as its routing rule)."""
    return not config.sim_vq and not config.codebook_normalize
