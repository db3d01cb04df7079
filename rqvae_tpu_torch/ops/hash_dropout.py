"""Counter-based dropout keep bits (port of rqvae_tpu/ops/hash_dropout.py).

The keep decision for an element is a murmur3-finalizer hash of its uint32
counter XOR seed * 0x9E3779B9. torch has no uint32 arithmetic, so the
counters live in int64 and every product is reduced with `& 0xFFFFFFFF`:
the bits equal the JAX package's exactly, wrap-around included. The attention
kernel (csrc/attention_core.cuh) computes the same hash in registers.

`hash_dropout` itself and its gradient belong to the training slice.
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
    counter = torch.arange(n, dtype=torch.int64, device=device).reshape(tuple(shape))
    return hash_keep_bits(counter, seed, rate)


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
