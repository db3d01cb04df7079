"""Batch schemas as NamedTuples of tensors (port of rqvae_tpu/data/schemas.py).

-1 marks padding everywhere.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class SeqBatch(NamedTuple):
    user_ids: torch.Tensor  # [B]
    ids: torch.Tensor  # [B, N] item ids, -1 padded
    ids_fut: torch.Tensor  # [B] or [B, 1] future (target) item id
    x: torch.Tensor  # [B, N, D] item features (-1 rows at padding)
    x_fut: torch.Tensor  # [B, D]
    seq_mask: torch.Tensor  # [B, N] bool


class TokenizedSeqBatch(NamedTuple):
    user_ids: torch.Tensor  # [B]
    sem_ids: torch.Tensor  # [B, N * sem_ids_dim] flattened semantic ids, -1 padded
    sem_ids_fut: torch.Tensor  # [B, sem_ids_dim]
    seq_mask: torch.Tensor  # [B, N * sem_ids_dim] bool
    token_type_ids: torch.Tensor  # [B, N * sem_ids_dim] position-within-tuple ids
    token_type_ids_fut: torch.Tensor  # [B, sem_ids_dim]
