"""Counter-based dropout keep bits (port of rqvae_tpu/ops/hash_dropout.py).

The keep decision for an element is a murmur3-finalizer hash of its uint32
counter XOR seed * 0x9E3779B9. torch has no uint32 arithmetic, so the
counters live in int64 and every product is reduced with `& 0xFFFFFFFF`:
the bits equal the JAX package's exactly, wrap-around included. The attention
kernel (csrc/attention_core.cuh) computes the same hash in registers.

`hash_dropout` is dropout whose keep mask is that hash of the element's linear
index: an autograd function that saves nothing but the seed and rebuilds the
mask in the backward pass. Its masks are built in wrapping int32 arithmetic
(4 bytes an element where the int64 emulation takes 8): int32 products wrap as
uint32 products do, a logical right shift is an arithmetic one with the
sign-extended bits masked off, and the unsigned compare is a signed compare
after flipping both sign bits. The bits are the same.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

_M32 = 0xFFFFFFFF


def keep_threshold(rate: float) -> int:
    """Keep iff hash bits >= this: round(rate * 2^32), capped at 2^32 - 1."""
    return min(int(round(rate * 2**32)), 2**32 - 1)


def hash_keep_bits(counter: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    """Bool keep decision for int64 `counter`s holding uint32 values
    (callers reduce theirs with `& 0xFFFFFFFF`); `seed` is an int32 value."""
    x = counter ^ (((int(seed) & _M32) * 0x9E3779B9) & _M32)
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & _M32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & _M32
    x = x ^ (x >> 16)
    return x >= keep_threshold(rate)


def keep_mask(seed: int, shape: Sequence[int], rate: float, device=None) -> torch.Tensor:
    """[shape] bool keep mask: hash_keep_bits of the linear element index."""
    n = math.prod(shape)
    if n >= 2**32:
        raise ValueError(
            f"keep_mask over {tuple(shape)}: {n} elements overflows the uint32 linear counter "
            "(masks would silently repeat)"
        )
    if n < 2**31:  # the counters fit int32 as they are
        counter = torch.arange(n, dtype=torch.int32, device=device)
    else:
        counter = _as_i32(torch.arange(n, dtype=torch.int64, device=device))
    return _keep_bits_i32(counter, seed, rate).reshape(tuple(shape))


def _signed32(value: int) -> int:
    """The int32 that holds the uint32 `value`'s bits."""
    value &= _M32
    return value - 2**32 if value >= 2**31 else value


def _as_i32(counter: torch.Tensor) -> torch.Tensor:
    """int64 counters holding uint32 values -> the int32 with the same bits."""
    return torch.where(counter >= 2**31, counter - 2**32, counter).to(torch.int32)


def _keep_bits_i32(x: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    """hash_keep_bits on int32 counters that hold uint32 bits (consumed in place)."""
    x.bitwise_xor_(_signed32((int(seed) & _M32) * 0x9E3779B9))
    x.bitwise_xor_((x >> 16).bitwise_and_(0xFFFF))
    x.mul_(_signed32(0x85EBCA6B))
    x.bitwise_xor_((x >> 13).bitwise_and_(0x7FFFF))
    x.mul_(_signed32(0xC2B2AE35))
    x.bitwise_xor_((x >> 16).bitwise_and_(0xFFFF))
    return x.bitwise_xor_(-(2**31)) >= _signed32(keep_threshold(rate) ^ 0x80000000)


class _HashDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seed, rate):
        ctx.seed, ctx.rate = seed, rate
        return _drop(x, seed, rate)

    @staticmethod
    def backward(ctx, g):
        return _drop(g, ctx.seed, ctx.rate), None, None


def _drop(x: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    keep = keep_mask(seed, x.shape, rate, x.device)
    scale = float(torch.tensor(1.0 / (1.0 - rate), dtype=x.dtype))  # rounded to x's dtype first, on the host
    return torch.where(keep, x, 0) * scale


def hash_dropout(x: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    """Dropout(x) with keep probability 1 - rate, kept values scaled by
    1/(1-rate) at x's dtype. `seed` is a host int (an int32 value). The
    backward pass applies the same mask to the gradient, rebuilt from the
    seed: no mask is saved."""
    return _HashDropout.apply(x, int(seed), float(rate))


def attention_keep_mask(seed: int, batch: int, heads: int, lq: int, lk: int, rate: float,
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
