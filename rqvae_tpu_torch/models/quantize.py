"""One residual-quantization level, eval mode (port of rqvae_tpu/models/quantize.py).

Distances and the hard codebook lookup. The training estimators (Gumbel
softmax, STE, rotation trick) belong to the training path.
"""

from __future__ import annotations

import enum
from typing import NamedTuple

import torch


class QuantizeForwardMode(enum.Enum):
    GUMBEL_SOFTMAX = 1
    STE = 2
    ROTATION_TRICK = 3


class QuantizeDistance(enum.Enum):
    L2 = 1
    COSINE = 2


class QuantizeOutput(NamedTuple):
    embeddings: torch.Tensor  # [B, D] chosen codewords
    ids: torch.Tensor  # [B] int32 codeword indices
    loss: torch.Tensor  # [B] VQ loss


def codebook_distances(
    x: torch.Tensor, codebook: torch.Tensor, distance: QuantizeDistance
) -> torch.Tensor:
    """[B, K] distance matrix between queries [B, D] and codewords [K, D]."""
    if distance == QuantizeDistance.L2:
        x2 = torch.sum(x * x, dim=-1, keepdim=True)
        c2 = torch.sum(codebook * codebook, dim=-1)
        return x2 + c2[None, :] - 2.0 * (x @ codebook.T)
    if distance == QuantizeDistance.COSINE:
        xn = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        cn = codebook.T / torch.linalg.vector_norm(codebook.T, dim=0, keepdim=True)
        return -(xn @ cn)
    raise ValueError(f"Unsupported distance: {distance}")


def quantize_eval(
    x: torch.Tensor,
    codebook: torch.Tensor,
    distance: QuantizeDistance = QuantizeDistance.L2,
    commitment_weight: float = 0.25,
) -> QuantizeOutput:
    """Hard lookup of the nearest codeword; argmin keeps the first index on
    exact ties, as jnp.argmin does. The loss is the VQ loss
    ||q - v||^2 (1 + commitment_weight), whose two terms are equal in value."""
    dist = codebook_distances(x, codebook, distance)
    ids = torch.argmin(dist, dim=-1).to(torch.int32)
    emb = codebook[ids.long()]
    loss = (1.0 + commitment_weight) * torch.sum((x - emb) ** 2, dim=-1)
    return QuantizeOutput(embeddings=emb, ids=ids, loss=loss)
