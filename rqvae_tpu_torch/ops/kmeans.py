"""Lloyd's k-means for codebook initialization (port of rqvae_tpu/ops/kmeans.py).

k-means++ seeding (or a random choice of distinct points), then Lloyd
iterations: assignment by the matmul expansion of the squared L2 distance,
the cluster means as a one-hot matmul (a fixed summation order, so a run
repeats bit for bit on the card, where a scatter-add would not), and an empty
cluster reseeded with a random data point. It stops when no centroid moved by
`stop_threshold` or after `max_iters` iterations, and returns, as the
reference does, the assignment the last update was computed from.

The random draws come from an explicit CPU `torch.Generator`, made up front
and copied to the data's device: the k-means++ uniforms (each next centroid
by inverse-CDF sampling of D^2, on the device) and the reseed indices of
every iteration. The stop test reads one device scalar per iteration.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class KmeansOutput(NamedTuple):
    centroids: torch.Tensor  # [k, D]
    assignment: torch.Tensor  # [B] int64
    iterations: int  # Lloyd iterations run


def pairwise_sq_dists(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """[B, k] squared L2 distances via the matmul expansion."""
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    c2 = torch.sum(c * c, dim=-1)
    return x2 + c2[None, :] - 2.0 * (x @ c.T)


def kmeanspp_init(x: torch.Tensor, k: int, generator: torch.Generator) -> torch.Tensor:
    """k-means++ seeding: each next centroid is a data point drawn with
    probability proportional to max(d^2, 1e-30), d its distance to the
    closest centroid so far."""
    B = x.shape[0]
    u = torch.rand(k, generator=generator, dtype=torch.float64).to(x.device)
    centroids = torch.empty((k, x.shape[1]), dtype=x.dtype, device=x.device)
    idx = torch.clamp((u[:1] * B).long(), max=B - 1)
    centroids[0] = x[idx][0]
    mind = torch.sum((x - centroids[0]) ** 2, dim=-1)
    for i in range(1, k):
        cdf = torch.cumsum(torch.clamp(mind, min=1e-30).double(), dim=0)
        idx = torch.clamp(torch.searchsorted(cdf, u[i:i + 1] * cdf[-1], right=True), max=B - 1)
        c = x[idx][0]
        centroids[i] = c
        mind = torch.minimum(mind, torch.sum((x - c) ** 2, dim=-1))
    return centroids


def lloyd_update(x: torch.Tensor, c: torch.Tensor, reseed_idx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Lloyd iteration from centroids `c`: (new centroids, the assignment
    to `c`). A cluster with no point takes x[reseed_idx[j]]."""
    k = c.shape[0]
    a = torch.argmin(pairwise_sq_dists(x, c), dim=-1)
    onehot = torch.nn.functional.one_hot(a, k).to(x.dtype)  # [B, k]
    counts = torch.sum(onehot, dim=0)
    means = (onehot.T @ x) / torch.clamp(counts, min=1.0)[:, None]
    return torch.where((counts > 0)[:, None], means, x[reseed_idx]), a


def kmeans(x: torch.Tensor, k: int, generator: torch.Generator, max_iters: int = 100,
           stop_threshold: float = 1e-10, init: str = "kmeans++") -> KmeansOutput:
    """Lloyd's algorithm on `x` [B, D] (computed in float32) with `k` clusters.
    init="kmeans++" (default) or "random" (k distinct points)."""
    x = x.float()
    B = x.shape[0]
    if init == "kmeans++":
        c = kmeanspp_init(x, k, generator)
    elif init == "random":
        c = x[torch.randperm(B, generator=generator)[:k].to(x.device)]
    else:
        raise ValueError(f"unknown init {init!r}")
    reseed = torch.randint(0, B, (max_iters, k), generator=generator).to(x.device)
    a = torch.argmin(pairwise_sq_dists(x, c), dim=-1)
    it = 0
    while it < max_iters:
        new_c, a = lloyd_update(x, c, reseed[it])
        moved = torch.max(torch.linalg.vector_norm(new_c - c, dim=-1))
        c, it = new_c, it + 1
        if float(moved) < stop_threshold:
            break
    return KmeansOutput(centroids=c, assignment=a, iterations=it)
