"""Traffic made from the seed, read from a traffic file's parameters.

- History lengths: `base` plus a lognormal of mean `extra_mean` (shape
  `sigma`), rounded and clipped at `max`: a heavy right tail over a floor,
  as interaction counts per user are (the k-core floor, then a long tail).
- Histories: items drawn uniformly from the catalog, -1 padded.
- Open-loop arrivals: a Poisson process at `rate` per second, as independent
  users arrive; every seed gets the same number of arrivals over the same
  time, in another order of gaps.

The pattern is that of the JAX package's SLO benchmark (Poisson arrivals over
lognormal history lengths), written here anew in NumPy and torch.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.harness.weights import generator


def lognormal_lengths(n: int, base: int, extra_mean: float, sigma: float, max_len: int,
                      g: torch.Generator, device) -> torch.Tensor:
    """[n] int64 lengths on the device."""
    mu = math.log(extra_mean) - sigma * sigma / 2.0
    extra = torch.exp(mu + sigma * torch.randn(n, generator=g, device=device))
    return torch.clamp(base + torch.round(extra), max=max_len).long()


def histories(traffic: dict, n_items: int, seed: int, device):
    """(items [R, max] int64 -1 padded, lengths [R] int64) of the traffic's
    `rows` users."""
    g = generator(seed, 10, device)
    R, width = traffic["rows"], traffic["length_max"]
    lengths = lognormal_lengths(R, traffic["length_base"], traffic["length_extra_mean"], traffic["length_sigma"],
                                width, g, device)
    items = torch.randint(0, n_items, (R, width), generator=g, device=device)
    items = torch.where(torch.arange(width, device=device)[None, :] < lengths[:, None], items, -1)
    return items, lengths


def poisson_due_times(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Due times (s from the window's start) of a Poisson process at `rate`:
    exactly round(rate * seconds) arrivals, their gaps exponential and
    rescaled to end at `seconds`, so that every seed offers the same load."""
    n = max(1, int(round(rate * seconds)))
    gaps = np.random.default_rng([int(seed) & (2**64 - 1), 11]).exponential(1.0, n + 1)
    due = np.cumsum(gaps)[:-1]
    return due * (seconds / np.sum(gaps))
