"""Fused T5 attention, forward and backward: CUDA kernel wrappers, their plain
versions and the autograd function around them.

Port of rqvae_tpu/ops/pallas/attention.py. `t5_attention` is differentiable in
q, k, v and bias. For CUDA tensors the forward launches csrc/attention.cu and
the backward csrc/attention_bwd.cu (or raises: there is no fallback); which
routine they run is `attention_route`'s (bf16 at dk = 64 on the tensor cores,
whole rows up to 128 keys, key tiles beyond, for the backward up to 1,280;
float32 on the CUDA cores). CPU tensors take `t5_attention_plain` and
`t5_attention_backward_plain`, the same arithmetic in torch with the keep bits
of ops/hash_dropout.py.

Forward: no 1/sqrt(dk) scale; scores, bias, masks (-1e9, never -inf) and
softmax in float32; dropped probabilities are zeroed and the rest scaled by
1/(1-rate) in float32, then rounded to the compute dtype before the PV
product. Backward: p rebuilt from the same scores (on the card from the
forward's own row maximum and sum), the same keep bits applied to p and to
dp, pd and ds rounded to the compute dtype before their products, the softmax
VJP over the whole row in float32, dq, dk, dv summed in float32 and rounded
once, dbias summed over the batch from the unrounded float32 ds. Every sum is
taken in a fixed order: two backward passes on the same inputs give the same
bits.

Shapes (cdt = compute dtype, float32 or bfloat16):
  q       [B, H, Lq, dk]  cdt
  k, v    [B, H, Lk, dk]  cdt
  bias    [H, Lq, Lk]     f32 (zeros when there is no position bias)
  mask    [B, Lk]         int/bool, nonzero = attend
  seed    a 1-element int32 tensor on q's device, or a host int (read only
          when dropout_rate > 0). The kernels take its address and each block
          reads it, as the Pallas kernels read seed_ref[0]: nothing waits for
          the host, and a captured launch reads the seed its buffer holds at
          replay. A host int is copied to the device first.
  b0      the global index of batch row 0 in the dropout counter (a host
          int, 0 by default): a data-parallel rank holding rows b0 .. b0 + B - 1
          of the global batch draws that batch's masks, as the Pallas kernel's
          counter is the logical (batch, head, q, k) position. The kernels take
          it as a launch argument, so a captured launch keeps it.
  h0, heads_total
          the global index of head 0 and the global head count in the dropout
          counter (0 and H by default): a tensor-parallel rank that runs heads
          h0 .. h0 + H - 1 of heads_total draws those heads' masks. Launch
          arguments too. The counter is ((b0 + b) * heads_total + h0 + h) * Lq
          + q) * Lk + k.
  out     [B, H, Lq, dk]  cdt
"""

from __future__ import annotations

import ctypes

import torch

from rqvae_tpu_torch.ops.cuda._build import check_launch, launch_operand, load_library
from rqvae_tpu_torch.ops.hash_dropout import attention_keep_mask, keep_threshold, seed_tensor

NEG_INF = -1e9
MAX_DK = 128  # the kernels' widest head (csrc/attention_core.cuh, csrc/attention_bwd.cu)
TENSOR_CORE_DK = 64  # the bf16 tensor-core routes' head width
WHOLE_ROW_MAX = 128  # the whole-row routes' longest rows (csrc/attention_core.cuh WR_MAX_KEYS)
# the tiled backward's longest rows: a cluster of at most 8 blocks of 160 keys
# holds a score row (csrc/attention_bwd.cu TILED_MAX_KEYS)
TILED_BACKWARD_MAX_KEYS = 1280
QUERY_TILE = 64  # query rows per block of the CUDA-core backward's batch-grouped dq/dbias pass
# blocks the backward's batch-grouped pass aims at on an H100's 132 SMs: two
# whole-row blocks (about 100 KB of shared memory each at 80 x 80) fit an SM;
# the CUDA-core route aims at four. The tiled route has no batch groups: its
# first kernel sums dbias over the whole batch in registers, in batch order.
GROUP_TARGET_BLOCKS = {"whole_row": 264, "cuda_cores": 528}
_C = ctypes.c_void_p
_ARGTYPES = [ctypes.c_int, ctypes.POINTER(_C), ctypes.POINTER(ctypes.c_int), _C,
             ctypes.c_uint, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _C]
_FUNCTIONS = {"attention_forward": _ARGTYPES, "attention_route": [ctypes.c_int] * 3}
_BWD_FUNCTIONS = {"attention_backward": _ARGTYPES, "attention_backward_route": [ctypes.c_int] * 4}
_PLAIN_CHUNK_ELEMS = 1 << 26  # score elements held at once by the plain versions


def _check(q, k, v, bias, mask, causal, dropout_rate, b0=0, h0=0, heads_total=None):
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
    if not 0 <= b0 < 2**31 - B:
        raise ValueError(f"b0 {b0}: the global batch index of row 0 must be in [0, 2^31 - B)")
    if h0 < 0 or h0 + H > (H if heads_total is None else heads_total):
        raise ValueError(f"heads {h0} .. {h0 + H - 1} of {heads_total}: the rank's heads must lie in the global ones")
    return B, H, Lq, Lk, dk


def _chunks(B, H, Lq, Lk):
    """Batch-row ranges whose [rows, H, Lq, Lk] float32 scores fit the plain
    versions' budget."""
    step = max(1, _PLAIN_CHUNK_ELEMS // max(1, H * Lq * Lk))
    return [(b0, min(B, b0 + step)) for b0 in range(0, B, step)]


def _plain_probs(q, k, bias, madd, cadd, b0, b1):
    s = q[b0:b1].float() @ k[b0:b1].float().transpose(-1, -2)
    s = s + bias[None]
    s = s + madd[b0:b1, None, None, :]
    if cadd is not None:
        s = s + cadd
    return torch.softmax(s, dim=-1)


def _additive_masks(mask, causal, Lq, Lk, dev):
    madd = torch.where(mask != 0, 0.0, NEG_INF).to(torch.float32)
    cadd = None
    if causal:
        cadd = torch.where(torch.ones(Lq, Lk, dtype=torch.bool, device=dev).tril(), 0.0, NEG_INF)
    return madd, cadd


def t5_attention_plain(q, k, v, bias, mask, seed=0, *, causal: bool = False,
                       dropout_rate: float = 0.0, b0: int = 0, h0: int = 0, heads_total=None) -> torch.Tensor:
    """The forward kernel's arithmetic in torch, a few batch rows at a time so
    the [B, H, Lq, Lk] float32 scores are never held whole."""
    B, H, Lq, Lk, _ = _check(q, k, v, bias, mask, causal, dropout_rate, b0, h0, heads_total)
    cdt, dev = q.dtype, q.device
    out = torch.empty_like(q)
    madd, cadd = _additive_masks(mask, causal, Lq, Lk, dev)
    for r0, r1 in _chunks(B, H, Lq, Lk):
        p = _plain_probs(q, k, bias, madd, cadd, r0, r1)
        if dropout_rate > 0.0:
            keep = attention_keep_mask(seed, r1 - r0, H, Lq, Lk, dropout_rate, dev, b0 + r0, h0, heads_total)
            p = torch.where(keep, p, 0.0) * (1.0 / (1.0 - dropout_rate))
        out[r0:r1] = (p.to(cdt).float() @ v[r0:r1].float()).to(cdt)
    return out


def t5_attention_backward_plain(q, k, v, bias, mask, seed, do, *, causal: bool = False,
                                dropout_rate: float = 0.0, b0: int = 0, h0: int = 0, heads_total=None):
    """(dq, dk, dv, dbias): the backward kernel's arithmetic in torch, with
    the reference's rounding points, a few batch rows at a time."""
    B, H, Lq, Lk, _ = _check(q, k, v, bias, mask, causal, dropout_rate, b0, h0, heads_total)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"do: want {tuple(q.shape)} {q.dtype}, got {tuple(do.shape)} {do.dtype}")
    cdt, dev = q.dtype, q.device
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dbias = torch.zeros(H, Lq, Lk, dtype=torch.float32, device=dev)
    madd, cadd = _additive_masks(mask, causal, Lq, Lk, dev)
    scale = 1.0 / (1.0 - dropout_rate)
    for r0, r1 in _chunks(B, H, Lq, Lk):
        p = _plain_probs(q, k, bias, madd, cadd, r0, r1)
        dof = do[r0:r1].float()
        dpd = dof @ v[r0:r1].float().transpose(-1, -2)
        if dropout_rate > 0.0:
            keep = attention_keep_mask(seed, r1 - r0, H, Lq, Lk, dropout_rate, dev, b0 + r0, h0, heads_total)
            pd = torch.where(keep, p, 0.0) * scale
            dp = torch.where(keep, dpd, 0.0) * scale
        else:
            pd, dp = p, dpd
        dv[r0:r1] = (pd.to(cdt).float().transpose(-1, -2) @ dof).to(cdt)
        ds = p * (dp - torch.sum(dp * p, dim=-1, keepdim=True))
        ds_c = ds.to(cdt).float()
        dq[r0:r1] = (ds_c @ k[r0:r1].float()).to(cdt)
        dk[r0:r1] = (ds_c.transpose(-1, -2) @ q[r0:r1].float()).to(cdt)
        dbias += ds.sum(0)
    return dq, dk, dv, dbias


def attention_route(Lq: int, Lk: int, dk: int, dtype: torch.dtype, backward: bool = False) -> str:
    """The kernel routine that CUDA tensors of these shapes launch (the C
    libraries' `attention_route` / `attention_backward_route` make the same
    choice): "whole_row" (bf16 at dk = 64, Lk <= 128, and for the backward
    Lq <= 128 too: whole score rows in registers), "tiled" (bf16 at dk = 64,
    longer rows: key tiles, pipelined; for the backward at most 1,280 keys,
    a score row on one cluster of blocks) or "cuda_cores" (float32, bf16 at
    another head width, and the backward of longer bf16 rows)."""
    if dtype != torch.bfloat16 or dk != TENSOR_CORE_DK or (backward and Lk > TILED_BACKWARD_MAX_KEYS):
        return "cuda_cores"
    if Lk <= WHOLE_ROW_MAX and (not backward or Lq <= WHOLE_ROW_MAX):
        return "whole_row"
    return "tiled"


def _check_cuda(q, dk, tensors):
    """dtype and head width the kernels take; every tensor on q's device,
    contiguous and on a 16-byte boundary (`t5_attention` prepares its
    operands so)."""
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"attention computes in float32 or bfloat16, got {q.dtype}")
    if dk % 4 or not 4 <= dk <= MAX_DK:
        raise ValueError(f"attention needs dk a multiple of 4 in 4..{MAX_DK}, got {dk}")
    for t in tensors:
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("attention takes contiguous, 16-byte aligned tensors on one CUDA device")


def _dropout_args(seed, dropout_rate, dev):
    """(seed tensor or None, seed address, keep threshold, scale, on): with
    dropout the kernels read the int32 seed at that device address."""
    if dropout_rate > 0.0:
        seed = seed_tensor(seed, dev)
        return seed, seed.data_ptr(), keep_threshold(dropout_rate), 1.0 / (1.0 - dropout_rate), 1
    return None, None, 0, 1.0, 0


def _forward_cuda(q, k, v, bias, mask, seed, causal, dropout_rate, with_stats, b0=0, h0=0, heads_total=None):
    """Launch the forward kernel. Returns (out, row_max, row_sum, keep_bits):
    the two statistics [B, H, Lq] f32 are None unless `with_stats`; keep_bits
    (the tiled route's dropout keep bits, [B, H, Lq, ceil(Lk / 64), 2] int32,
    one 64-bit word per row and 64-key tile, for the backward) only with
    `with_stats`, dropout and the tiled route, else None. `mask` is int32."""
    B, H, Lq, Lk, dk = _check(q, k, v, bias, mask, causal, dropout_rate, b0, h0, heads_total)
    if Lk == 0:
        raise ValueError("attention over no keys")
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    stats = [torch.empty(B, H, Lq, dtype=torch.float32, device=q.device) for _ in range(2)] if with_stats else []
    if with_stats and dropout_rate > 0.0 and attention_route(Lq, Lk, dk, q.dtype) == "tiled":
        stats.append(torch.empty(B, H, Lq, -(-Lk // 64), 2, dtype=torch.int32, device=q.device))
    results = (out, *stats, *([None] * (3 - len(stats))))
    if out.numel() == 0:
        return results
    tensors = (q, k, v, bias, mask, out, *stats)
    _check_cuda(q, dk, tensors)
    lib = load_library("attention", _FUNCTIONS)
    ptrs = (_C * 9)(*[t.data_ptr() for t in tensors], *([None] * (9 - len(tensors))))
    dims = (ctypes.c_int * 6)(B, H, Lq, Lk, dk, int(bool(causal)))
    seed, seed_ptr, thresh, scale, on = _dropout_args(seed, dropout_rate, q.device)
    with torch.cuda.device(q.device):  # the kernel launches on the current device
        rc = lib.attention_forward(int(q.dtype == torch.bfloat16), ptrs, dims, seed_ptr, thresh, scale, on,
                                   int(b0), int(h0), H if heads_total is None else int(heads_total),
                                   torch.cuda.current_stream(q.device).cuda_stream)
    t5_attention.launches += 1
    check_launch(lib, rc, "attention")
    return results


def backward_groups(B: int, H: int, Lq: int, Lk: int | None = None, dk: int = TENSOR_CORE_DK,
                    dtype: torch.dtype = torch.bfloat16) -> int:
    """Batch groups of the backward's batch-grouped pass (Lk defaults to Lq):
    the whole-row route's (head, group) blocks or the CUDA-core route's
    (query tile, head, group) blocks, enough of them to fill the card; one on
    the tiled route, whose clusters walk the whole batch. At most B / 4
    groups, none of them empty. Group i holds batch rows i*r .. i*r + r - 1
    with r = ceil(B / groups)."""
    Lk = Lq if Lk is None else Lk
    route = attention_route(Lq, Lk, dk, dtype, backward=True)
    if route == "tiled":
        return 1
    want = GROUP_TARGET_BLOCKS[route] // (H if route == "whole_row" else H * -(-Lq // QUERY_TILE))
    want = max(1, min(max(1, B // 4), want))
    rows = -(-B // want)
    return -(-B // rows)


def _backward_cuda(q, k, v, bias, mask, seed, do, row_max, row_sum, causal, dropout_rate, groups=None,
                   keep_bits=None, b0=0, h0=0, heads_total=None):
    """Launch the backward kernel. `mask` is int32; row_max / row_sum (and,
    when the forward wrote them, keep_bits) are the forward's; without
    keep_bits the kernels hash the keep bits anew (the same bits); `groups`
    (default `backward_groups`) only changes the order in which dbias is
    summed, and on the tiled route nothing (it has one group)."""
    B, H, Lq, Lk, dk = _check(q, k, v, bias, mask, causal, dropout_rate, b0, h0, heads_total)
    do = launch_operand(do)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"do: want {tuple(q.shape)} {q.dtype}, got {tuple(do.shape)} {do.dtype}")
    dev = q.device
    dq, dk_, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dbias = torch.empty(H, Lq, Lk, dtype=torch.float32, device=dev)
    if q.numel() == 0:
        return dq, dk_, dv, dbias.zero_()
    groups = backward_groups(B, H, Lq, Lk, dk, q.dtype) if groups is None else groups
    if not 1 <= groups <= B or (groups - 1) * -(-B // groups) >= B:
        raise ValueError(f"{groups} batch groups of {B} rows leave a group empty")
    if attention_route(Lq, Lk, dk, q.dtype, backward=True) == "tiled":
        groups = 1
    delta = torch.empty(2, B, H, Lq, dtype=torch.float32, device=dev)  # the row term, then 1 / l (scratch)
    part = torch.empty(groups, H, Lq, Lk, dtype=torch.float32, device=dev) if groups > 1 else dbias
    if keep_bits is not None and (
            tuple(keep_bits.shape) != (B, H, Lq, -(-Lk // 64), 2) or keep_bits.dtype != torch.int32
            or attention_route(Lq, Lk, dk, q.dtype) != "tiled" or dropout_rate == 0.0):
        raise ValueError("keep_bits are the tiled forward's, written with dropout")
    tensors = (q, k, v, bias, mask, do, row_max, row_sum, delta, dq, dk_, dv, dbias, part,
               *([] if keep_bits is None else [keep_bits]))
    _check_cuda(q, dk, tensors)
    lib = load_library("attention_bwd", _BWD_FUNCTIONS)
    ptrs = (_C * 15)(*[t.data_ptr() for t in tensors], *([None] * (15 - len(tensors))))
    dims = (ctypes.c_int * 7)(B, H, Lq, Lk, dk, int(bool(causal)), groups)
    seed, seed_ptr, thresh, scale, on = _dropout_args(seed, dropout_rate, dev)
    with torch.cuda.device(dev):  # the kernels launch on the current device
        rc = lib.attention_backward(int(q.dtype == torch.bfloat16), ptrs, dims, seed_ptr, thresh, scale, on,
                                    int(b0), int(h0), H if heads_total is None else int(heads_total),
                                    torch.cuda.current_stream(dev).cuda_stream)
    t5_attention.backward_launches += 1
    check_launch(lib, rc, "attention backward")
    return dq, dk_, dv, dbias


class _T5Attention(torch.autograd.Function):
    """Kernel 4 forward, kernel 5 backward (plain versions for CPU tensors).
    Saves q, k, v, bias, mask, the seed tensor and, on the card, the forward's row
    statistics (and on the tiled route with dropout its keep bits, 1 bit a
    score); never the [B, H, Lq, Lk] probabilities."""

    @staticmethod
    def forward(ctx, q, k, v, bias, mask, seed, causal, dropout_rate, b0, h0, heads_total):
        ctx.causal, ctx.dropout_rate, ctx.b0, ctx.h0, ctx.heads_total = causal, dropout_rate, b0, h0, heads_total
        kw = dict(b0=b0, h0=h0, heads_total=heads_total)
        if q.device.type == "cpu":
            ctx.save_for_backward(q, k, v, bias, mask, seed)
            return t5_attention_plain(q, k, v, bias, mask, seed, causal=causal, dropout_rate=dropout_rate, **kw)
        out, *stats = _forward_cuda(q, k, v, bias, mask, seed, causal, dropout_rate, with_stats=True, **kw)
        ctx.save_for_backward(q, k, v, bias, mask, seed, *(t for t in stats if t is not None))
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, mask, seed, *stats = ctx.saved_tensors
        kw = dict(causal=ctx.causal, dropout_rate=ctx.dropout_rate, b0=ctx.b0, h0=ctx.h0, heads_total=ctx.heads_total)
        if q.device.type == "cpu":
            grads = t5_attention_backward_plain(q, k, v, bias, mask, seed, do, **kw)
        else:
            row_max, row_sum, *bits = stats
            grads = _backward_cuda(q, k, v, bias, mask, seed, do, row_max, row_sum,
                                   keep_bits=bits[0] if bits else None, **kw)
        return (*grads, None, None, None, None, None, None, None)


def t5_attention(q, k, v, bias, mask, seed=0, *, causal: bool = False,
                 dropout_rate: float = 0.0, b0: int = 0, h0: int = 0, heads_total=None) -> torch.Tensor:
    """softmax(q k^T + bias + mask [+ causal]) [dropout] @ v, [B, H, Lq, dk]
    at q's dtype, differentiable in q, k, v and bias; the dropout counter
    counts batch rows from `b0` and heads from `h0` of `heads_total`. CUDA tensors launch the
    kernels (forwards counted in `t5_attention.launches`, backwards in
    `t5_attention.backward_launches`) on operands of any layout and offset;
    CPU tensors take the plain versions."""
    dropout_rate = float(dropout_rate)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    if q.device.type == "cuda":
        # the kernels read contiguous operands 16 bytes at a time: a strided or
        # offset view is launched from a copy (differentiable, so gradients
        # still reach the caller's tensors)
        q, k, v, bias = (launch_operand(t) for t in (q, k, v, bias))
        mask = launch_operand(mask.to(torch.int32))
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, bias)):
        seed = seed_tensor(seed, q.device) if dropout_rate > 0.0 else None  # saved for the backward
        return _T5Attention.apply(q, k, v, bias, mask, seed, bool(causal), dropout_rate, int(b0), int(h0),
                                  None if heads_total is None else int(heads_total))
    kw = dict(b0=b0, h0=h0, heads_total=heads_total)
    if q.device.type == "cpu":
        return t5_attention_plain(q, k, v, bias, mask, seed, causal=causal, dropout_rate=dropout_rate, **kw)
    return _forward_cuda(q, k, v, bias, mask, seed, causal, dropout_rate, with_stats=False, **kw)[0]


t5_attention.launches = 0
t5_attention.backward_launches = 0
