"""Counter-hash dropout keep bits, frozen here so that the yardstick cannot move.

An element is kept iff the murmur3 finaliser of (counter XOR seed *
0x9E3779B9), all in uint32 arithmetic, is at least round(rate * 2^32). The
counter of an element of a plain dropout site is its linear index in the
array; that of an attention weight is ((b * H + h) * Lq + q) * Lk + k, which
is the linear index of the [B, H, Lq, Lk] weights. int64 tensors hold the
uint32 values, every product reduced mod 2^32.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9


def threshold(rate: float) -> int:
    return min(int(round(rate * 2**32)), 2**32 - 1)


def keep_bits(counter: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    """Bool keep decision of int64 counters (uint32 values) under `seed`."""
    mix = ((int(seed) & M32) * GOLDEN) & M32
    x = (counter & M32) ^ mix
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & M32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & M32
    x = x ^ (x >> 16)
    return x >= threshold(rate)


def keep_mask(shape, seed: int, rate: float, device) -> torch.Tensor:
    """The keep mask of an array of `shape`, counted by linear index."""
    n = 1
    for s in shape:
        n *= int(s)
    if n >= 2**32:
        raise ValueError(f"{tuple(shape)} overflows the uint32 counter")
    return keep_bits(torch.arange(n, dtype=torch.int64, device=device), seed, rate).reshape(tuple(shape))


def dropout(x: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    """Inverted dropout of x by its keep mask, in float32."""
    if rate == 0.0:
        return x
    keep = keep_mask(x.shape, seed, rate, x.device)
    return torch.where(keep, x, torch.zeros((), dtype=x.dtype, device=x.device)) * (1.0 / (1.0 - rate))
