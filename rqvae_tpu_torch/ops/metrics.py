"""Retrieval evaluation metrics: hits@k and NDCG over generated beams
(port of rqvae_tpu/ops/metrics.py).

A hit is an exact match of the target L-tuple with one of the top-k generated
tuples; the rank is the first matching beam; the NDCG term is
1 / log2(rank + 2).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Sequence

import torch


def topk_hit_metrics(actual: torch.Tensor, top_k: torch.Tensor, ks: Sequence[int] = (1, 5, 10)) -> Dict[str, torch.Tensor]:
    """Summed hit / NDCG statistics of a batch, as scalar tensors.

    actual [B, L] target tuples; top_k [B, K, L] generated tuples, best
    first. Returns {"ndcg", "h@k"..., "total" = B}."""
    match = (actual[:, None, :] == top_k).all(-1)  # [B, K]
    found = match.any(-1)
    rank = match.to(torch.int32).argmax(-1)  # first matching beam (0 if none; masked by found)
    ndcg = torch.where(found, 1.0 / torch.log2(rank.to(torch.float32) + 2.0), 0.0)
    out = {"ndcg": ndcg.sum()}
    for k in ks:
        out[f"h@{k}"] = (found & (rank < k)).to(torch.float32).sum()
    out["total"] = torch.tensor(float(actual.shape[0]))
    return out


class TopKAccumulator:
    """Host-side sums of topk_hit_metrics over batches."""

    def __init__(self, ks: Sequence[int] = (1, 5, 10)):
        self.ks = tuple(ks)
        self.reset()

    def reset(self) -> None:
        self.total = 0.0
        self.metrics: Dict[str, float] = defaultdict(float)

    def accumulate(self, actual, top_k) -> None:
        stats = topk_hit_metrics(torch.as_tensor(actual), torch.as_tensor(top_k), self.ks)
        for k, v in stats.items():
            if k == "total":
                self.total += float(v)
            else:
                self.metrics[k] += float(v)

    def reduce(self) -> Dict[str, float]:
        return {k: v / max(self.total, 1.0) for k, v in self.metrics.items()}
