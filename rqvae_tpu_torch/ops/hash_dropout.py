"""Counter-based dropout keep bits (port of rqvae_tpu/ops/hash_dropout.py).

The keep decision for an element is a murmur3-finalizer hash of its uint32
counter XOR seed * 0x9E3779B9. torch has no uint32 arithmetic, so the plain
versions compute it in wrapping int32 arithmetic (below): the bits equal the
JAX package's exactly, wrap-around included. The CUDA kernels compute the
same hash in registers (csrc/hash_core.cuh).

The seed is a 1-element int32 tensor on the data's device, as the Pallas
kernels read theirs from an SMEM operand: seed * 0x9E3779B9 is formed on the
device, so nothing waits for the host and a CUDA graph that captures a site
reads whatever seed its buffer holds at replay. A host int is taken too (it is
copied to the device first). An int32 seed holds the uint32 seed's bits, so
seeds of 2^31 and more are negative int32 values.

`hash_dropout` is dropout whose keep mask is that hash of the element's linear
index: an autograd function that saves nothing but the seed and applies the
same mask to the gradient in the backward pass. On the card both passes are one
launch of csrc/hash_dropout.cu (ops/cuda/hash_dropout.py), which hashes the
keep bit in registers: one read of the input and one write of the output. CPU
tensors take `hash_dropout_plain`, which builds the mask in wrapping int32
arithmetic: int32 products wrap as uint32 products do, a logical right shift
is an arithmetic one with the sign-extended bits masked off, and the unsigned
compare is a signed compare after flipping both sign bits. The bits are the
same.

Data parallelism: the JAX package's masks are a hash of the GLOBAL element
position (its keep_mask iota runs over the global shape that GSPMD sees). A
rank that holds a contiguous slice of the global batch passes `offset`, the
linear index of its first element in the global array, and `total`, the
global element count: its mask is then that slice of the global mask, and the
2^32 overflow check is made on the global count, as the JAX check is.

Tensor parallelism: a rank that holds a column window of each row of the
global array (its heads of the attention weights, its d_ff columns of the FFN's
inner activation) passes `row=(w, W)`: its elements are rows of w that lie
W apart in the global array, the first at `offset`. Element (r, c) then
counts as offset + r * W + c, so every rank draws its window of the global
mask, whatever the layout.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence, Union

import torch

from rqvae_tpu_torch.ops.cuda.hash_dropout import hash_dropout_cuda

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9

Seed = Union[int, torch.Tensor]


def keep_threshold(rate: float) -> int:
    """Keep iff hash bits >= this: round(rate * 2^32), capped at 2^32 - 1."""
    return min(int(round(rate * 2**32)), 2**32 - 1)


def _signed32(value: int) -> int:
    """The int32 that holds the uint32 `value`'s bits."""
    value &= _M32
    return value - 2**32 if value >= 2**31 else value


def seed_tensor(seed: Seed, device=None) -> torch.Tensor:
    """`seed` as a 1-element int32 tensor on `device` (a tensor seed on
    another device is copied there)."""
    if isinstance(seed, torch.Tensor):
        if seed.numel() != 1 or seed.dtype.is_floating_point:
            raise ValueError(f"a seed is one integer, got {seed.dtype} {tuple(seed.shape)}")
        return seed.reshape(1).to(device=device, dtype=torch.int32)
    return torch.tensor([_signed32(int(seed))], dtype=torch.int32, device=device)


def _seed_mix64(seed: Seed, device) -> torch.Tensor:
    """(seed * 0x9E3779B9) mod 2^32 as a [1] int64 tensor, formed on the device."""
    return ((seed_tensor(seed, device).long() & _M32) * _GOLDEN) & _M32


def hash_keep_bits(counter: torch.Tensor, seed: Seed, rate: float) -> torch.Tensor:
    """Bool keep decision for int64 `counter`s holding uint32 values
    (callers reduce theirs with `& 0xFFFFFFFF`); `seed` is an int32 value."""
    return _keep_bits_i32(_as_i32(counter), seed, rate)


def _check_span(shape: Sequence[int], offset: int, total, row=None) -> int:
    """The element count of `shape`, after checking that its elements (rows
    of w, W apart, with `row=(w, W)`) lie from `offset` in a global array of
    `total` (default: just past the last one) elements whose linear index
    fits the uint32 counter."""
    n = math.prod(shape)
    if row is None:
        end = offset + n
    else:
        w, W = int(row[0]), int(row[1])
        if w < 1 or w > W or n % w:
            raise ValueError(f"rows of {w} in a global row of {W} cannot hold {tuple(shape)}")
        end = offset + (n // w - 1) * W + w if n else offset
    total = end if total is None else int(total)
    if offset < 0 or end > total:
        raise ValueError(f"elements {offset} .. {end - 1} lie outside a global array of {total}")
    if total >= 2**32:
        raise ValueError(
            f"keep_mask over {tuple(shape)} in a global array of {total} elements overflows the uint32 "
            "linear counter (masks would silently repeat)"
        )
    return n


def keep_mask(seed: Seed, shape: Sequence[int], rate: float, device=None, offset: int = 0,
              total=None, row=None) -> torch.Tensor:
    """[shape] bool keep mask: hash_keep_bits of the linear element index,
    counted from `offset` (the first element's index in a global array of
    `total` elements; by default the array is this one). With `row=(w, W)`
    the elements are rows of w, each W after the last in the global array."""
    n = _check_span(shape, offset, total, row)
    if row is None:
        if offset + n < 2**31:  # the counters fit int32 as they are
            counter = torch.arange(offset, offset + n, dtype=torch.int32, device=device)
        else:
            counter = _as_i32(torch.arange(offset, offset + n, dtype=torch.int64, device=device))
    else:
        w, W = int(row[0]), int(row[1])
        starts = torch.arange(n // w, dtype=torch.int64, device=device) * W + offset
        counter = _as_i32((starts[:, None] + torch.arange(w, dtype=torch.int64, device=device)).reshape(-1))
    return _keep_bits_i32(counter, seed, rate).reshape(tuple(shape))


def _as_i32(counter: torch.Tensor) -> torch.Tensor:
    """int64 counters holding uint32 values -> the int32 with the same bits."""
    return torch.where(counter >= 2**31, counter - 2**32, counter).to(torch.int32)


def _keep_bits_i32(x: torch.Tensor, seed: Seed, rate: float) -> torch.Tensor:
    """hash_keep_bits on int32 counters that hold uint32 bits (consumed in place)."""
    x.bitwise_xor_(_as_i32(_seed_mix64(seed, x.device)))
    x.bitwise_xor_((x >> 16).bitwise_and_(0xFFFF))
    x.mul_(_signed32(0x85EBCA6B))
    x.bitwise_xor_((x >> 13).bitwise_and_(0x7FFFF))
    x.mul_(_signed32(0xC2B2AE35))
    x.bitwise_xor_((x >> 16).bitwise_and_(0xFFFF))
    return x.bitwise_xor_(-(2**31)) >= _signed32(keep_threshold(rate) ^ 0x80000000)


@functools.lru_cache(maxsize=None)
def keep_scale(rate: float, dtype: torch.dtype) -> float:
    """1 / (1 - rate) rounded to `dtype`, as a host float (computed once per
    pair, so a step's body makes no tensor for it)."""
    return float(torch.tensor(1.0 / (1.0 - rate), dtype=dtype))


def hash_dropout_plain(x: torch.Tensor, seed: Seed, rate: float, offset: int = 0, total=None,
                       row=None) -> torch.Tensor:
    """The masked multiply in torch, for any device: where(keep_mask, x, 0)
    * keep_scale(rate, x.dtype). It is what CPU tensors run, and what the
    kernel is held to."""
    keep = keep_mask(seed, x.shape, rate, x.device, offset, total, row)
    return torch.where(keep, x, 0) * keep_scale(rate, x.dtype)


class _HashDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seed, rate, offset, total, row):
        ctx.save_for_backward(seed)
        ctx.rate, ctx.offset, ctx.total, ctx.row = rate, offset, total, row
        return _drop(x, seed, rate, offset, total, row)

    @staticmethod
    def backward(ctx, g):
        (seed,) = ctx.saved_tensors
        return _drop(g, seed, ctx.rate, ctx.offset, ctx.total, ctx.row), None, None, None, None, None


def _drop(x: torch.Tensor, seed: torch.Tensor, rate: float, offset: int, total, row) -> torch.Tensor:
    """The masked multiply of both passes: the kernel for a CUDA tensor (it
    raises on what it does not take), the plain version for a CPU one."""
    if x.device.type == "cuda":
        _check_span(x.shape, offset, total, row)
        return hash_dropout_cuda(x, seed, keep_threshold(rate), keep_scale(rate, x.dtype), offset, row)
    return hash_dropout_plain(x, seed, rate, offset, total, row)


def hash_dropout(x: torch.Tensor, seed: Seed, rate: float, offset: int = 0, total=None, row=None) -> torch.Tensor:
    """Dropout(x) with keep probability 1 - rate, kept values scaled by
    1/(1-rate) at x's dtype. `seed`: a 1-element int32 tensor on x's device
    (or a host int). The mask counts from `offset` in a global array of
    `total` elements, in rows of w that lie W apart with `row=(w, W)`
    (keep_mask). The backward pass applies the same mask to the gradient,
    rebuilt from the seed: no mask is saved."""
    row = None if row is None else (int(row[0]), int(row[1]))
    return _HashDropout.apply(x, seed_tensor(seed, x.device), float(rate), int(offset), total, row)


def attention_keep_mask(seed: Seed, batch: int, heads: int, lq: int, lk: int, rate: float,
                        device=None, b0: int = 0, h0: int = 0, heads_total=None) -> torch.Tensor:
    """[batch, heads, lq, lk] bool keep mask of the attention kernel: the
    counter is ((b * H + h) * lq + q) * lk + k in wrapping uint32 for batch
    rows b0 .. b0 + batch - 1 and heads h0 .. h0 + heads - 1 of H =
    `heads_total` (default `heads`) global heads. Built in wrapping int32
    arithmetic, which has the same bits."""
    H = heads if heads_total is None else int(heads_total)
    if h0 < 0 or h0 + heads > H:
        raise ValueError(f"heads {h0} .. {h0 + heads - 1} of {H}")

    def ar(n, start=0):
        return _as_i32(torch.arange(start, start + n, dtype=torch.int64, device=device) & _M32)

    x = (ar(batch, b0)[:, None] * _signed32(H) + ar(heads, h0)[None, :])[:, :, None]
    x = x * _signed32(lq) + ar(lq)[None, None, :]
    x = (x * _signed32(lk))[..., None] + ar(lk)
    return _keep_bits_i32(x.contiguous(), seed, rate)
