"""Counter-based dropout keep bits (port of rqvae_tpu/ops/hash_dropout.py).

The keep decision for an element is a murmur3-finalizer hash of its uint32
counter XOR seed * 0x9E3779B9. torch has no uint32 arithmetic, so the
counters live in int64 and every product is reduced with `& 0xFFFFFFFF`:
the bits equal the JAX package's exactly, wrap-around included. The attention
kernel (csrc/attention_core.cuh) computes the same hash in registers.

The seed is a 1-element int32 tensor on the data's device, as the Pallas
kernels read theirs from an SMEM operand: seed * 0x9E3779B9 is formed on the
device, so nothing waits for the host and a CUDA graph that captures a site
reads whatever seed its buffer holds at replay. A host int is taken too (it is
copied to the device first). An int32 seed holds the uint32 seed's bits, so
seeds of 2^31 and more are negative int32 values.

`hash_dropout` is dropout whose keep mask is that hash of the element's linear
index: an autograd function that saves nothing but the seed and rebuilds the
mask in the backward pass. Its masks are built in wrapping int32 arithmetic
(4 bytes an element where the int64 emulation takes 8): int32 products wrap as
uint32 products do, a logical right shift is an arithmetic one with the
sign-extended bits masked off, and the unsigned compare is a signed compare
after flipping both sign bits. The bits are the same.

Data parallelism: the JAX package's masks are a hash of the GLOBAL element
position (its keep_mask iota runs over the global shape that GSPMD sees). A
rank that holds a contiguous slice of the global batch passes `offset`, the
linear index of its first element in the global array, and `total`, the
global element count: its mask is then that slice of the global mask, and the
2^32 overflow check is made on the global count, as the JAX check is.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence, Union

import torch

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
    x = counter ^ _seed_mix64(seed, counter.device)
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & _M32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & _M32
    x = x ^ (x >> 16)
    return x >= keep_threshold(rate)


def _check_span(shape: Sequence[int], offset: int, total) -> int:
    """The element count of `shape`, after checking that elements offset ..
    offset + n - 1 lie in a global array of `total` (default offset + n)
    elements whose linear index fits the uint32 counter."""
    n = math.prod(shape)
    total = offset + n if total is None else int(total)
    if offset < 0 or offset + n > total:
        raise ValueError(f"elements {offset} .. {offset + n - 1} lie outside a global array of {total}")
    if total >= 2**32:
        raise ValueError(
            f"keep_mask over {tuple(shape)} in a global array of {total} elements overflows the uint32 "
            "linear counter (masks would silently repeat)"
        )
    return n


def keep_mask(seed: Seed, shape: Sequence[int], rate: float, device=None, offset: int = 0,
              total=None) -> torch.Tensor:
    """[shape] bool keep mask: hash_keep_bits of the linear element index,
    counted from `offset` (the first element's index in a global array of
    `total` elements; by default the array is this one)."""
    n = _check_span(shape, offset, total)
    if offset + n < 2**31:  # the counters fit int32 as they are
        counter = torch.arange(offset, offset + n, dtype=torch.int32, device=device)
    else:
        counter = _as_i32(torch.arange(offset, offset + n, dtype=torch.int64, device=device))
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


class _HashDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seed, rate, offset, total):
        ctx.save_for_backward(seed)
        ctx.rate, ctx.offset, ctx.total = rate, offset, total
        return _drop(x, seed, rate, offset, total)

    @staticmethod
    def backward(ctx, g):
        (seed,) = ctx.saved_tensors
        return _drop(g, seed, ctx.rate, ctx.offset, ctx.total), None, None, None, None


def _drop(x: torch.Tensor, seed: torch.Tensor, rate: float, offset: int, total) -> torch.Tensor:
    keep = keep_mask(seed, x.shape, rate, x.device, offset, total)
    return torch.where(keep, x, 0) * keep_scale(rate, x.dtype)


def hash_dropout(x: torch.Tensor, seed: Seed, rate: float, offset: int = 0, total=None) -> torch.Tensor:
    """Dropout(x) with keep probability 1 - rate, kept values scaled by
    1/(1-rate) at x's dtype. `seed`: a 1-element int32 tensor on x's device
    (or a host int). The mask counts from `offset` in a global array of
    `total` elements (keep_mask). The backward pass applies the same mask to
    the gradient, rebuilt from the seed: no mask is saved."""
    return _HashDropout.apply(x, seed_tensor(seed, x.device), float(rate), int(offset), total)


def attention_keep_mask(seed: Seed, batch: int, heads: int, lq: int, lk: int, rate: float,
                        device=None, b0: int = 0) -> torch.Tensor:
    """[batch, heads, lq, lk] bool keep mask of the attention kernel: the
    counter is ((b * heads + h) * lq + q) * lk + k in wrapping uint32, for
    batch rows b0 .. b0 + batch - 1."""
    def ar(n, start=0):
        return torch.arange(start, start + n, dtype=torch.int64, device=device)

    x = ((ar(batch, b0)[:, None] * heads + ar(heads)[None, :]) & _M32)[:, :, None]
    x = ((x * lq) & _M32) + ar(lq)[None, None, :]
    x = (((x & _M32) * lk) & _M32)[..., None] + ar(lk)
    return hash_keep_bits(x & _M32, seed, rate)
