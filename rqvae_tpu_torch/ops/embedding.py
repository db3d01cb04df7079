"""Embedding lookup, forward only (port of rqvae_tpu/ops/embedding.py).

The JAX version's one-hot matmul backward belongs to the training path.
"""

from __future__ import annotations

import torch


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table [V, D], ids int[...] -> [..., D]."""
    return table[ids.long()]
